"""Flamed: the prior and prob generators on one device, and zero-shot
sampling from phonemes and a prompt wav.

``Flamed(cfg, params, device).sample(phonemes=..., prompt_raw=wav,
codec=FaCodec)`` encodes the prompt (``FaCodec.encode_prompt``), runs the
staged bucketed sampler and synthesizes the wav.  ``params`` is
``{"prior": state_dict, "prob": state_dict}`` (``convert.params_from_jax``
makes them from JAX trees); without it ``init_params`` draws random
weights.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from flamed_tts_tpu_torch.device import resolve_device
from flamed_tts_tpu_torch.models.prior.prior_generator import PriorGenerator
from flamed_tts_tpu_torch.models.prob.prob_generator import ProbGenerator
from flamed_tts_tpu_torch.runtime.buckets import (
    DEFAULT_FRAME_BUCKETS,
    DEFAULT_PHONEME_BUCKETS,
    DEFAULT_PROMPT_BUCKETS,
    bucket_list,
)
from flamed_tts_tpu_torch.runtime.sampler import BucketedSampler


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

    def init_params(self, generator: torch.Generator) -> Dict:
        """Random {"prior", "prob"} state dicts (CPU generator)."""
        out = {}
        for name, module in (("prior", self.prior), ("prob", self.prob)):
            _init_module(module, generator)
            out[name] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        return out

    def num_params(self) -> int:
        return sum(p.numel() for m in (self.prior, self.prob) for p in m.parameters())

    @torch.no_grad()
    def sample(self, phonemes, prompt_raw: np.ndarray, codec,
               temp_durgen: float = 0.3, temp_denoiser: float = 0.3,
               nsteps_durgen: int = 64, nsteps_denoiser: int = 64,
               noise: Optional[Dict] = None, seed: Optional[int] = None) -> Dict:
        """Single-utterance zero-shot synthesis from phoneme ids and a prompt
        wav (``prompt_raw``, 16 kHz float), analysed by ``codec``.

        Returns {"wav" (n,) float32 numpy, n = tgt_len * hop; "latents"
        (1, F, 256); "tgt_len" (1,); "frame_bucket"}.  Noise not
        given in ``noise`` is drawn from a generator seeded with ``seed``.
        """
        ids = np.asarray(phonemes, dtype=np.int64).reshape(1, -1)
        codes, timbre = codec.encode_prompt(np.asarray(prompt_raw, dtype=np.float32))
        prompts = np.asarray(codes, dtype=np.int64)[None]
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(np.random.randint(0, 2 ** 31 - 1)) if seed is None else seed)
        out = self.sampler.sample(
            ids, np.array([ids.shape[1]]), prompts, np.array([prompts.shape[-1]]),
            np.asarray(timbre, dtype=np.float32).reshape(1, -1), self.device,
            nsteps_durgen=nsteps_durgen, nsteps_denoiser=nsteps_denoiser,
            temp_durgen=temp_durgen, temp_denoiser=temp_denoiser, vocab_pad=self.vocab_size,
            codec=codec, noise=noise, generator=generator,
        )
        n = int(out["tgt_len"][0]) * codec.hop
        return {
            "wav": out["wav"][0, :n, 0].float().cpu().numpy(),
            "latents": out["latents"],
            "tgt_len": out["tgt_len"],
            "frame_bucket": out["frame_bucket"],
        }
