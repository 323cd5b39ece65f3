"""Prior sampling (the PVA Euler loop and integer durations) and the
PVA's training loss.

The noise is an argument: ``pva_sample`` takes the standard-normal draws
for the duration and silence flows, and ``pva_loss`` takes its time and
noises or draws them from a passed generator, so a caller (or a test
holding the JAX draws) decides them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from flamed_tts_tpu_torch.ops.dropout import BatchRows, denominator, draw


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


def pva_loss(prior, enc_out: Tensor, src_mask: Tensor, phone_dur: Tensor, sil_dur: Tensor,
             sigma_min: float, generator: Optional[torch.Generator] = None,
             t: Optional[Tensor] = None, noise: Optional[Tuple[Tensor, Tensor]] = None,
             loss_norm: str = "masked", rows: Optional[BatchRows] = None) -> Dict[str, Tensor]:
    """OT-CFM losses of the duration and silence flows over log(dur + 1).
    ``t`` (B, 1) uniform and ``noise`` (duration, silence), each (B, L)
    standard normal, are drawn from ``generator`` (t first) where not given.

    ``loss_norm="masked"`` takes the MSE over valid positions;
    ``"reference"`` over the whole padded (B, L) buffer.  With ``rows``
    (this rank's rows of a batch split over a data group) the draws are
    the whole batch's, sliced, and the denominators the whole batch's: a
    loss is this rank's share, and the group's sum is the loss."""
    b, l = phone_dur.shape
    dev = enc_out.device
    if t is None:
        t = draw(torch.rand, (b, 1), generator, dev, rows)
    if noise is None:
        noise = tuple(draw(torch.randn, (b, l), generator, dev, rows) for _ in range(2))
    valid = (~src_mask).float()
    count = torch.tensor(float(b * l), device=dev) if loss_norm == "reference" else valid.sum()
    denom = denominator(count, rows)

    def interpolate(target, x0):
        x1 = torch.log(target.float() + 1.0)
        xt = t * x1 + (1.0 - (1.0 - sigma_min) * t) * x0
        return xt, (x1 - (1.0 - sigma_min) * x0) * valid

    dur_xt, dur_u = interpolate(phone_dur, noise[0])
    sil_xt, sil_u = interpolate(sil_dur, noise[1])
    v_dur, v_sil = prior.pva_fields(dur_xt, sil_xt, enc_out, t[:, 0], src_mask)
    return {"dur_loss": (((v_dur - dur_u) ** 2) * valid).sum() / denom,
            "sil_loss": (((v_sil - sil_u) ** 2) * valid).sum() / denom}
