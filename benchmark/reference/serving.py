"""Zero-shot synthesis as served, in plain PyTorch: the buckets, the
speculative frame bucket, the noise draws and the int16 wav.

What the served call decides for itself is worked out again here from the
inputs alone:

* the phoneme bucket (smallest of the configured buckets that holds the
  text) and the frame bucket: on the served path it is speculative, the
  phoneme count times a frames-per-phoneme budget learnt from the calls
  before (95th percentile of the last 64 observed ratios times 1.2, at
  least 7, 9 before any call), with one more pass at the bucket the
  target length needs where it overflowed;
* the noise: standard normal draws from a generator on the device seeded
  with the request's seed, in the served order (durations (B, L bucket),
  silences (B, L bucket), latents (B, F bucket, 256), and the latents
  again at the retry's bucket);
* the prompt: the wav zero-padded to a seconds bucket (1, 2, 3, 4, 5, 8,
  11, 17 s), as int16 PCM where the served call uploads it so, analysed
  by the codec.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.codec import HOP, PlainCodec
from benchmark.reference.flamed import PlainFlamed, mask_from_length

PCM_SCALE = 32767.0
SR = 16000
WAV_SECOND_BUCKETS = (1, 2, 3, 4, 5, 8, 11, 17)
FIRST_BUDGET = 9.0
MIN_BUDGET = 7.0
BUDGET_MARGIN = 1.2
BUDGET_WINDOW = 64
HISTORY = 256


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    return int(max(buckets))


class FrameBudget:
    """The served path's speculative frame bucket, replayed call by call."""

    def __init__(self, frame_buckets: Sequence[int]):
        self.buckets = sorted(int(b) for b in frame_buckets)
        self.ratios: List[float] = []

    def guess(self, max_src_len: int) -> int:
        if self.ratios:
            budget = max(float(np.percentile(self.ratios[-BUDGET_WINDOW:], 95) * BUDGET_MARGIN),
                         MIN_BUDGET)
        else:
            budget = FIRST_BUDGET
        return pick_bucket(int(max_src_len * budget), self.buckets)

    def observe(self, tgt_raw: Sequence[int], src_lens: Sequence[int]) -> None:
        ratios = np.asarray(tgt_raw, np.int64) / np.maximum(np.asarray(src_lens, np.float32), 1.0)
        self.ratios.extend(float(r) for r in ratios)
        del self.ratios[:-HISTORY]

    def bucket_after(self, guess: int, max_tgt_raw: int) -> int:
        """The bucket the call ends at: the guess, or the retry's."""
        if max_tgt_raw > guess and guess < self.buckets[-1]:
            return pick_bucket(max_tgt_raw, self.buckets)
        return guess


def noise_draws(seed: int, shapes: Sequence[Tuple[int, ...]], device) -> List[torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return [torch.randn(s, generator=gen, device=device, dtype=torch.float32) for s in shapes]


def pcm(wav: torch.Tensor) -> torch.Tensor:
    """Float -> int16 PCM -> float, as the served wav comes back."""
    return torch.round(torch.clamp(wav, -1.0, 1.0) * PCM_SCALE) / PCM_SCALE


def pad_to_seconds(wav: np.ndarray) -> Tuple[np.ndarray, int]:
    n = wav.shape[-1]
    seconds = pick_bucket(max(1, int(np.ceil(n / SR))), WAV_SECOND_BUCKETS)
    out = np.zeros(seconds * SR, dtype=np.float32)
    out[:min(n, out.size)] = wav[:out.size]
    return out, n // HOP


class PlainServing:
    def __init__(self, model: PlainFlamed, codec: PlainCodec, buckets: Dict[str, Sequence[int]],
                 device):
        self.model, self.codec, self.device = model, codec, device
        self.buckets = {k: sorted(int(b) for b in v) for k, v in buckets.items()}

    def prompt(self, wav: np.ndarray, as_pcm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """A prompt wav -> (codes (6, frames), timbre (256,))."""
        padded, n_frames = pad_to_seconds(np.asarray(wav, np.float32))
        x = torch.as_tensor(padded, device=self.device)
        if as_pcm:
            x = pcm(x)
        latents = self.codec.encode(x[None, :, None])
        n_frames = min(n_frames, latents.shape[1])
        codes, timbre = self.codec.analyze(latents, n_frames)
        return codes[:, :n_frames], timbre

    def durations(self, ids: Sequence[int], dur_noise: torch.Tensor, sil_noise: torch.Tensor,
                  nfe: int, temperature: float):
        """Stage 1 of one row: (encoder out, phone frames, silence frames,
        target length)."""
        l = len(ids)
        enc = self.model.encode(torch.as_tensor([list(ids)], device=self.device))
        pd, sd = self.model.pva_durations(enc, dur_noise[None, :l], sil_noise[None, :l], nfe, temperature)
        return enc, pd, sd, self.model.target_length(pd, sd)

    def target_lengths(self, ids: Sequence[Sequence[int]], dur_noise: torch.Tensor,
                       sil_noise: torch.Tensor, nfe: int, temperature: float) -> List[int]:
        """Stage 1's target lengths of rows of one phoneme count, batched."""
        enc = self.model.encode(torch.as_tensor([list(x) for x in ids], device=self.device))
        pd, sd = self.model.pva_durations(enc, dur_noise, sil_noise, nfe, temperature)
        return [int(v) for v in (torch.clamp(pd, min=1.0).sum(1) + sd.sum(1)).tolist()]

    def synthesize(self, first, prompt_codes: torch.Tensor, timbre: torch.Tensor, f_bucket: int,
                   latent_noise: torch.Tensor, nfe: int, temperature: float):
        """Stage 2 of one row at frame bucket ``f_bucket``: (latents (F, 256),
        wav (tgt_len * hop,) float, tgt_len)."""
        enc, pd, sd, tgt_raw = first
        tgt_len = min(tgt_raw, f_bucket)
        lr = self.model.regulate(enc, pd, sd)[:, :tgt_len]
        p_len = min(prompt_codes.shape[1], max(self.buckets["prompt"]))
        hiddens, _ = self.model.decode(lr, prompt_codes[:, :p_len].long())
        n_q, d = hiddens.shape[1], hiddens.shape[-1]
        full = torch.zeros(1, n_q, f_bucket, d, device=self.device)
        full[:, :, :tgt_len] = hiddens
        pad = mask_from_length(tgt_len, f_bucket, self.device)
        latents = self.model.prob_sample(full, timbre[None], pad, latent_noise[None], nfe, temperature)
        wav = pcm(self.codec.decode(latents, timbre))[0, :tgt_len * HOP]
        return latents[0], wav, tgt_len
