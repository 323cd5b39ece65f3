"""Flamed: the prior and prob generators on one device, and zero-shot
sampling from phonemes and a prompt wav.

``Flamed(cfg, params, device).sample(text=... | phonemes=...,
prompt_raw=wav | prompt_processed=codes + timbre=..., codec=FaCodec)`` runs
the text frontend, the bucketed sampler (the fused path by default, with
the prompt analysed on the device in the same queue; ``fused=False`` for
the staged path after ``FaCodec.encode_prompt``) and synthesizes the wav;
``sample_batch`` is the same for a batch of phoneme rows.  ``params`` is
``{"prior": state_dict, "prob": state_dict}`` (``convert.params_from_jax``
makes them from JAX trees); without it ``init_params`` draws random
weights.  ``from_pretrained`` reads a converted ``.npz`` or the reference's
PyTorch checkpoint.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from flamed_tts_tpu_torch.convert import params_from_jax
from flamed_tts_tpu_torch.convert_ckpt import convert_flamed_checkpoint
from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.models.prior.prior_generator import PriorGenerator
from flamed_tts_tpu_torch.models.prob.prob_generator import ProbGenerator
from flamed_tts_tpu_torch.runtime.buckets import (
    DEFAULT_FRAME_BUCKETS,
    DEFAULT_PHONEME_BUCKETS,
    DEFAULT_PROMPT_BUCKETS,
    bucket_list,
)
from flamed_tts_tpu_torch.runtime.pytree_io import load_pytree_npz
from flamed_tts_tpu_torch.runtime.sampler import BucketedSampler
from flamed_tts_tpu_torch.text.frontend import EnglishFrontend
from flamed_tts_tpu_torch.utils.audio import load_wav
from flamed_tts_tpu_torch.utils.profiling import sample_span


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by the inverse CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = lo + (1.0 - 2.0 * lo) * torch.rand(shape, generator=generator, dtype=torch.float64)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    # truncated at 2 std, rescaled so the kept part has std 1/sqrt(fan_in)
    std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
    with torch.no_grad():
        w.copy_(truncated_normal(w.shape, generator) * std)


def _init_module(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights with the JAX package's default initializers: lecun
    normal for Dense/Conv kernels, zero biases, N(0, 1/features) embeddings,
    unit norms, U[0, 1) segment embeddings."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            _lecun_normal_(m.weight, fan_in, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               / math.sqrt(m.embedding_dim))
        elif hasattr(m, "weight") and hasattr(m, "bias") and m.weight is not None and m.weight.dim() == 1:
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
    for name, p in module.named_parameters(recurse=False):
        with torch.no_grad():
            p.copy_(torch.rand(p.shape, generator=generator))


class Flamed:
    def __init__(self, cfg: Dict, params: Optional[Dict] = None,
                 device: Union[str, torch.device, None] = None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.prior = PriorGenerator(cfg["prior_generator"])
        self.prob = ProbGenerator(cfg["prob_generator"])
        self.vocab_size = cfg["prior_generator"]["codec"]["vocab_size"]
        if params is None:
            params = self.init_params(generator or torch.Generator().manual_seed(0))
        self.prior.load_state_dict(params["prior"])
        self.prob.load_state_dict(params["prob"])
        self.prior.to(self.device).eval()
        self.prob.to(self.device).eval()
        data = cfg.get("dataset_cfg") or {}
        self.sampler = BucketedSampler(
            self.prior, self.prob,
            phoneme_buckets=bucket_list(data.get("phoneme_buckets"), DEFAULT_PHONEME_BUCKETS),
            frame_buckets=bucket_list(data.get("frame_buckets"), DEFAULT_FRAME_BUCKETS),
            prompt_buckets=bucket_list(data.get("prompt_buckets"), DEFAULT_PROMPT_BUCKETS),
        )
        self.frontend: Optional[EnglishFrontend] = None

    def init_params(self, generator: torch.Generator) -> Dict:
        """Random {"prior", "prob"} state dicts (CPU generator)."""
        out = {}
        for name, module in (("prior", self.prior), ("prob", self.prob)):
            _init_module(module, generator)
            out[name] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        return out

    def num_params(self) -> int:
        return sum(p.numel() for m in (self.prior, self.prob) for p in m.parameters())

    def cast_inference_params(self, dtype: torch.dtype = torch.bfloat16) -> None:
        """Store the prior's and the denoiser's float parameters in ``dtype``.

        At batch 1 the 64-step denoiser loop streams its weights every
        Euler step; bfloat16 storage halves that traffic and the memory.
        The activations stay float32: at the ``"default"`` matmul precision
        (``precision.py``) a matmul on the card takes the weight as a
        bfloat16 operand as stored, and everywhere else (the CPU,
        ``"highest"``, the norms and the depthwise conv) the parameter is
        widened to float32 where it is used, as the JAX package promotes a
        bfloat16 parameter against a float32 input."""
        for module in (self.prior, self.prob):
            for p in module.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dtype)

    @classmethod
    def from_pretrained(cls, cfg: Dict, ckpt_path: str, weights_only: bool = True,
                        **kwargs) -> "Flamed":
        """Load a converted .npz checkpoint ({"prior", "prob"} flax trees,
        the JAX package's format), or the reference's PyTorch
        .ckpt/.pt/.bin (a Lightning checkpoint or a bare weight dict),
        converted on the fly by ``convert_ckpt``; ``weights_only`` is
        ``torch.load``'s."""
        if ckpt_path.endswith(".npz"):
            tree = load_pytree_npz(ckpt_path)
        else:
            sd = torch.load(ckpt_path, map_location="cpu", weights_only=weights_only)
            tree = convert_flamed_checkpoint(sd)
        return cls(cfg, params={k: params_from_jax(tree[k]) for k in ("prior", "prob")}, **kwargs)

    def _get_frontend(self, lexicon_path=None, cleaners=("english_cleaners",)):
        if self.frontend is None:
            self.frontend = EnglishFrontend(lexicon_path=lexicon_path, cleaners=cleaners)
        return self.frontend

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(np.random.randint(0, 2 ** 31 - 1)) if seed is None else seed)
        return generator

    def sample(self, text: Optional[str] = None, phonemes=None,
               prompt_raw: Union[str, np.ndarray, None] = None,
               prompt_processed: Optional[np.ndarray] = None,
               timbre: Optional[np.ndarray] = None, sr: int = 16000, codec=None,
               temp_durgen: float = 0.3, temp_denoiser: float = 0.3,
               nsteps_durgen: int = 64, nsteps_denoiser: int = 64,
               lexicon_path: Optional[str] = None,
               cleaners: Sequence[str] = ("english_cleaners",),
               noise: Optional[Dict] = None, seed: Optional[int] = None,
               fused: bool = True) -> Dict:
        """Single-utterance zero-shot synthesis.  Exactly one of (``text``,
        ``phonemes``) and one of (``prompt_raw``: a wav path or a 16 kHz
        float array, ``prompt_processed`` (n_q, P) codes + ``timbre``) must
        be given.

        With ``fused`` (the default, as in the JAX package) the utterance
        goes through the sampler's fused path, a raw prompt being analysed
        on the device in the same queue; ``fused=False`` takes the staged
        path after ``codec.encode_prompt``.

        Returns {"time"; "latents" (1, F, 256); "tgt_len" (1,);
        "frame_bucket"} and with a codec "wav" (n,) float32 numpy,
        n = tgt_len * hop.  Noise not given in ``noise`` is drawn from a
        generator seeded with ``seed``.
        """
        if (text is None) == (phonemes is None):
            raise ValueError("`text` and `phonemes` are mutually exclusive: only one should "
                             "be provided, and the other must be None!")
        if (prompt_raw is None) == (prompt_processed is None):
            raise ValueError("`prompt_raw` and `prompt_processed` are mutually exclusive: "
                             "only one should be provided, and the other must be None!")
        if prompt_processed is not None and timbre is None:
            raise ValueError("`timbre` must be provided along with `prompt_processed`!")
        if prompt_raw is not None and codec is None:
            raise ValueError("`codec` must be provided with `prompt_raw`")
        start_time = time.time()

        if text is not None:
            with sample_span("frontend"):
                ids, _, _ = self._get_frontend(lexicon_path, cleaners)(text)
        else:
            ids = np.asarray(phonemes, dtype=np.int64)
            if ids.ndim == 1:
                ids = ids[None, :]

        prompt_wav = prompt_frames = prompts = timbres = None
        if prompt_raw is not None:
            if isinstance(prompt_raw, str):
                prompt_raw = load_wav(prompt_raw, sr=sr)
            prompt_raw = np.asarray(prompt_raw, dtype=np.float32)
            if fused:
                with sample_span("prompt_prep"):
                    padded, n_frames = codec.pad_prompt_wav(prompt_raw)
                    prompt_wav = padded[None, :]
                    prompt_frames = np.asarray([n_frames], dtype=np.int64)
            else:
                codes, timbre = codec.encode_prompt(prompt_raw)
                prompt_processed = codes
        if prompt_wav is None:
            prompts = np.asarray(prompt_processed, dtype=np.int64)
            if prompts.ndim == 2:
                prompts = prompts[None, :, :]
            timbres = np.asarray(timbre, dtype=np.float32)
            if timbres.ndim == 1:
                timbres = timbres[None, :]

        outputs = self.sample_batch(
            phonemes=ids, src_lens=np.full((ids.shape[0],), ids.shape[-1], dtype=np.int64),
            prompts=prompts, timbres=timbres, prompt_wav=prompt_wav, prompt_frames=prompt_frames,
            codec=codec, temp_durgen=temp_durgen, temp_denoiser=temp_denoiser,
            nsteps_durgen=nsteps_durgen, nsteps_denoiser=nsteps_denoiser,
            noise=noise, seed=seed, fused=fused)

        result = {"time": time.time() - start_time}
        if "wav" in outputs:
            n = int(outputs["tgt_len"][0]) * codec.hop
            result["wav"] = outputs["wav"][0, :n, 0]
        result.update({k: outputs[k] for k in ("latents", "tgt_len", "frame_bucket")})
        return result

    def sample_batch(self, phonemes: np.ndarray, src_lens: np.ndarray,
                     prompts: Optional[np.ndarray] = None, timbres: Optional[np.ndarray] = None,
                     prompt_lens: Optional[np.ndarray] = None,
                     prompt_wav: Optional[np.ndarray] = None,
                     prompt_frames: Optional[np.ndarray] = None, codec=None,
                     temp_durgen: float = 0.3, temp_denoiser: float = 0.3,
                     nsteps_durgen: int = 64, nsteps_denoiser: int = 64,
                     noise: Optional[Dict] = None, seed: Optional[int] = None,
                     fused: bool = True, mesh=None) -> Dict:
        """Batched sampling: phonemes (B, L) + src_lens, and either prompts
        (B, n_q, P) + timbres (B, 256) (+ prompt_lens) or prompt_wav (B, T)
        + prompt_frames.  Arrays are channel-last: ``latents`` (B, F, 256),
        ``prior_logits`` (B, n_q, F, V + 1).  With a codec the wav is
        synthesized in the same call: (B, F * hop, 1) float32 numpy.

        ``mesh`` (a ``parallel.mesh.make_mesh`` mesh; every rank calls with
        the whole batch and the same seed) splits the batch over its data
        axis, throughput mode: the result is the whole batch's on every
        rank (``runtime/sampler.py``)."""
        start_time = time.time()
        if prompt_wav is None and prompts is None:
            raise ValueError("provide either prompts(+timbres) or prompt_wav")
        if prompt_wav is None and prompt_lens is None:
            prompt_lens = np.full((prompts.shape[0],), prompts.shape[-1], dtype=np.int64)
        out = self.sampler.sample(
            np.asarray(phonemes), np.asarray(src_lens),
            None if prompts is None else np.asarray(prompts),
            None if prompt_lens is None else np.asarray(prompt_lens),
            None if timbres is None else np.asarray(timbres, dtype=np.float32),
            self.device, nsteps_durgen=nsteps_durgen, nsteps_denoiser=nsteps_denoiser,
            temp_durgen=temp_durgen, temp_denoiser=temp_denoiser, vocab_pad=self.vocab_size,
            codec=codec, noise=noise, generator=self._generator(seed), fused=fused,
            prompt_wav=prompt_wav, prompt_frames=prompt_frames, mesh=mesh)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out["time"] = time.time() - start_time
        return out
