"""Bucketed two-stage sampling (the JAX package's staged path).

  stage 1 (phoneme bucket L): encode + PVA Euler loop -> integer
      durations and the target length;
  the host reads the target length and picks the tightest frame bucket F;
  stage 2 (L, F, prompt bucket P): length regulation -> per-quantizer
      decoders -> denoiser Euler loop -> latents -> codec synthesis.

Inputs are padded to the same buckets as in the JAX package, so for the
same noise the outputs are the same.  Noise is drawn from ``generator``
unless given in ``noise`` ({"dur", "sil": (B, L), "latents": (B, F, 256)},
standard normal, at the bucket shapes).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from flamed_tts_tpu_torch.models.prior.sampling import pva_sample
from flamed_tts_tpu_torch.models.prob.prob_generator import prob_sample
from flamed_tts_tpu_torch.ops.length_regulator import length_regulate
from flamed_tts_tpu_torch.ops.masking import mask_from_lengths
from flamed_tts_tpu_torch.runtime.buckets import pick_bucket


def _noise(noise: Optional[Dict], key: str, shape, device, generator) -> torch.Tensor:
    given = (noise or {}).get(key)
    if given is None:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    given = torch.as_tensor(np.array(given, dtype=np.float32), device=device)
    if tuple(given.shape) != tuple(shape):
        raise ValueError(f"noise[{key!r}] has shape {tuple(given.shape)}, expected {tuple(shape)}")
    return given


class BucketedSampler:
    def __init__(self, prior, prob, phoneme_buckets: Sequence[int],
                 frame_buckets: Sequence[int], prompt_buckets: Sequence[int]):
        self.prior = prior
        self.prob = prob
        self.phoneme_buckets = list(phoneme_buckets)
        self.frame_buckets = list(frame_buckets)
        self.prompt_buckets = list(prompt_buckets)

    @torch.no_grad()
    def sample(self, phonemes: np.ndarray, src_lens: np.ndarray, prompts: np.ndarray,
               prompt_lens: np.ndarray, timbres: np.ndarray, device: torch.device,
               nsteps_durgen: int = 64, nsteps_denoiser: int = 64,
               temp_durgen: float = 0.3, temp_denoiser: float = 0.3, vocab_pad: int = 1024,
               codec=None, noise: Optional[Dict] = None,
               generator: Optional[torch.Generator] = None) -> Dict:
        b, l_in = phonemes.shape
        l_bucket = pick_bucket(l_in, self.phoneme_buckets)
        if l_in > l_bucket:
            warnings.warn(f"phoneme length {l_in} exceeds the largest bucket {l_bucket}; "
                          "input truncated", stacklevel=2)
        phonemes_b = np.zeros((b, l_bucket), dtype=np.int64)
        phonemes_b[:, : min(l_in, l_bucket)] = phonemes[:, :l_bucket]
        src_lens = np.minimum(np.asarray(src_lens, dtype=np.int64), l_bucket)

        p_in = prompts.shape[-1]
        p_bucket = pick_bucket(p_in, self.prompt_buckets)
        if p_in > p_bucket:
            warnings.warn(f"prompt length {p_in} frames exceeds the largest bucket "
                          f"{p_bucket}; prompt truncated", stacklevel=2)
        prompts_b = np.full((b, prompts.shape[1], p_bucket), vocab_pad, dtype=np.int64)
        prompts_b[:, :, : min(p_in, p_bucket)] = prompts[:, :, :p_bucket]
        prompt_lens = np.minimum(np.asarray(prompt_lens, dtype=np.int64), p_bucket)

        def dev(a):
            return torch.as_tensor(a, device=device)

        phonemes_t, src_lens_t = dev(phonemes_b), dev(src_lens)

        # stage 1
        src_mask = mask_from_lengths(src_lens_t, l_bucket)
        enc_out = self.prior.encode(phonemes_t, src_mask)
        phone_dur, sil_dur = pva_sample(
            self.prior, enc_out, src_mask,
            _noise(noise, "dur", (b, l_bucket), device, generator),
            _noise(noise, "sil", (b, l_bucket), device, generator),
            nsteps_durgen, temp_durgen)
        valid = (~src_mask).float()
        tgt_est = ((torch.clamp(phone_dur, min=1.0) * valid).sum(1)
                   + (sil_dur * valid).sum(1)).to(torch.int64)
        max_needed = int(tgt_est.max().item())  # the one host read between stages
        if max_needed > self.frame_buckets[-1]:
            warnings.warn(f"sampled target length {max_needed} frames exceeds the largest "
                          f"frame bucket {self.frame_buckets[-1]}; output clipped", stacklevel=2)
        f_bucket = pick_bucket(max_needed, self.frame_buckets)

        # stage 2
        lr_out, tgt_len = length_regulate(enc_out, phone_dur, sil_dur, src_lens_t, f_bucket)
        tgt_mask = mask_from_lengths(tgt_len, f_bucket)
        hiddens, _ = self.prior.decode(lr_out, tgt_mask, dev(prompts_b), dev(prompt_lens))
        timbres_t = dev(np.asarray(timbres, dtype=np.float32))
        latents = prob_sample(
            self.prob, hiddens, timbres_t, tgt_mask,
            _noise(noise, "latents", (b, f_bucket, self.prob.target_dim), device, generator),
            nsteps_denoiser, temp_denoiser)
        out = {"latents": latents, "tgt_len": tgt_len.cpu().numpy(), "frame_bucket": f_bucket}
        if codec is not None:
            out["wav"] = codec.decode(latents, timbres_t)
        return out
