"""Prior sampling: the PVA Euler loop and integer durations.

The noise is an argument: ``pva_sample`` takes the standard-normal draws
for the duration and silence flows, so a caller (or a test holding the
JAX draws) decides them.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def durations_from_flow(x: Tensor) -> Tensor:
    """log-space flow state -> integer frame counts (as float)."""
    return torch.clamp(torch.round(torch.exp(x) - 1.0), min=0)


@torch.no_grad()
def pva_sample(prior, enc_out: Tensor, src_mask: Tensor, dur_noise: Tensor,
               sil_noise: Tensor, nfe: int, temperature: float) -> Tuple[Tensor, Tensor]:
    """Euler-integrate the duration / silence flows from
    ``noise * temperature``; returns (phone_dur, sil_dur), each (B, L)."""
    dur = dur_noise.float() * temperature
    sil = sil_noise.float() * temperature
    ts = torch.linspace(0.0, 1.0, nfe + 1, dtype=torch.float32, device=enc_out.device)[:-1]
    delta_t = 1.0 / nfe
    for i in range(nfe):
        v_dur, v_sil = prior.pva_fields(dur, sil, enc_out, ts[i], src_mask)
        dur = dur + delta_t * v_dur
        sil = sil + delta_t * v_sil
    return durations_from_flow(dur), durations_from_flow(sil)
