"""Prob generator: condition downsampler + attention-free ConvNeXt/adaLN
flow-matching denoiser.

Sampling starts at ``noise * temperature + cond`` (a prior-centred
source) and takes ``nfe`` Euler steps at scalar times; every step's adaLN
modulations are computed once before the loop (``compute_mods``).  The
mask enters every time-mixing op, so a padded run equals an exact-length
one on the valid frames.

Training (``prob_loss``) draws a time per frame, so there the modulations
are per position, (B, L, 6C) a block (``SimpleMLPAdaLN.mods_at``); serving
never builds them.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from flamed_tts_tpu_torch import precision
from flamed_tts_tpu_torch.ops.convnext import AdaLNResBlock, FinalLayer, TimestepEmbedder
from flamed_tts_tpu_torch.ops.dropout import BatchRows, denominator, draw
from flamed_tts_tpu_torch.ops.norms import MaskedGroupNorm


class ResnetBlock1D(nn.Module):
    """Masked 1x1 conv + GroupNorm(8) + Mish, residual."""

    def __init__(self, dim: int, groups: int = 8):
        super().__init__()
        self.conv = precision.Linear(dim, dim)
        self.norm = MaskedGroupNorm(groups, dim)

    def forward(self, x: Tensor, pad_mask: Optional[Tensor]) -> Tensor:
        h = x if pad_mask is None else x.masked_fill(pad_mask[:, :, None], 0.0)
        h = F.mish(self.norm(self.conv(h), pad_mask))
        if pad_mask is not None:
            h = h.masked_fill(pad_mask[:, :, None], 0.0)
        return x + h


class ConditionDownSampler(nn.Module):
    def __init__(self, in_channel: int, out_channel: int, n_stages: int = 1, n_groups: int = 8):
        super().__init__()
        self.n_stages = n_stages
        c = in_channel
        for i in range(n_stages):
            self.add_module(f"resblock_{i}", ResnetBlock1D(c))
            self.add_module(f"down_conv_{i}", precision.Linear(c, c // 2))
            self.add_module(f"down_norm_{i}", MaskedGroupNorm(n_groups, c // 2))
            c //= 2
        self.proj_out = precision.Linear(c, out_channel)

    def forward(self, x: Tensor, pad_mask: Optional[Tensor]) -> Tensor:
        for i in range(self.n_stages):
            x = getattr(self, f"resblock_{i}")(x, pad_mask)
            x = getattr(self, f"down_conv_{i}")(x)
            x = F.relu(getattr(self, f"down_norm_{i}")(x, pad_mask))
        return F.relu(self.proj_out(x))


class SimpleMLPAdaLN(nn.Module):
    def __init__(self, in_channels: int, model_channels: int, out_channels: int, spk_dim: int,
                 num_res_blocks: int, kernel: int = 31, padding: int = 15, expand: int = 1,
                 groups: Optional[int] = None):
        super().__init__()
        self.num_res_blocks = num_res_blocks
        self.time_embed = TimestepEmbedder(model_channels)
        self.cond_embed = precision.Linear(spk_dim, model_channels)
        self.proj_in = precision.Linear(in_channels, model_channels)
        for i in range(num_res_blocks):
            self.add_module(f"res_block_{i}",
                            AdaLNResBlock(model_channels, kernel, padding, expand, groups))
        self.final_layer = FinalLayer(model_channels, out_channels, kernel, padding, expand, groups)
        # set by parallel.sharding.shard_params where the parameters are split
        # over a mesh's model axis: the forward is then the tensor-parallel one
        self.tp = None

    def blocks(self) -> List[nn.Module]:
        return [getattr(self, f"res_block_{i}") for i in range(self.num_res_blocks)]

    def _embed(self, t: Tensor, spk: Tensor):
        if self.tp is not None:
            from flamed_tts_tpu_torch.parallel import tensor_parallel
            return tensor_parallel.time_embed(self, t), tensor_parallel.cond_embed(self, spk)
        return self.time_embed(t), self.cond_embed(spk)

    def _mods(self, y: Tensor) -> List[Tensor]:
        if self.tp is not None:
            from flamed_tts_tpu_torch.parallel import tensor_parallel
            return tensor_parallel.mods(self, y)
        return [blk.mods(y) for blk in self.blocks()] + [self.final_layer.mods(y)]

    def compute_mods(self, t_grid: Tensor, spk: Tensor) -> List[Tensor]:
        """Every step's adaLN modulations at once: t_grid (S,), spk (B, spk_dim)
        -> per block (S, B, 1, 6C), final layer (S, B, 1, 5C)."""
        t_emb, c_emb = self._embed(t_grid.float()[:, None], spk)  # (S, 1, C), (B, C)
        return self._mods(t_emb[:, None, :, :] + c_emb[None, :, None, :])

    def mods_at(self, t: Tensor, spk: Tensor) -> List[Tensor]:
        """Modulations at times ``t`` broadcastable to (B, L) (a scalar, (B,)
        or (B, L)): per block (B, L or 1, 6C), final layer (B, L or 1, 5C)."""
        t = t.float()
        while t.dim() < 2:
            t = t[None] if t.dim() == 0 else t[:, None]
        t_emb, c_emb = self._embed(t, spk)
        return self._mods(t_emb + c_emb[:, None, :])

    def forward(self, x: Tensor, mods: List[Tensor], pad_mask: Optional[Tensor] = None) -> Tensor:
        """One denoiser call with one step's modulations (each (B, 1, kC))."""
        if self.tp is not None:
            from flamed_tts_tpu_torch.parallel import tensor_parallel
            return tensor_parallel.forward(self, x, mods, pad_mask)
        x = self.proj_in(x)
        for blk, m in zip(self.blocks(), mods):
            x = blk(x, m, pad_mask)
        return self.final_layer(x, mods[-1], pad_mask)


class ProbGenerator(nn.Module):
    def __init__(self, config: Dict):
        super().__init__()
        self.n_quantizers = config["n_quantizers"]
        self.cond_dim = config["cond_dim"]
        self.target_dim = config["target_dim"]
        self.quantizer_emb = precision.Embedding(self.n_quantizers, self.cond_dim)
        self.cond_downsampling = ConditionDownSampler(
            self.n_quantizers * self.cond_dim, self.target_dim, config["downsampling_stages"])
        cx = config["convnext"]
        self.denoiser = SimpleMLPAdaLN(
            self.target_dim, config["hidden_dim"], self.target_dim, config["spk_dim"],
            config["n_layers"], cx["kernel_size"], cx["padding"], cx["expand"], cx["groups"])

    def encode_condition(self, prior_hiddens: Tensor, pad_mask: Optional[Tensor]) -> Tensor:
        """(B, n_q, L, cond_dim) -> (B, L, target_dim)."""
        x = prior_hiddens + self.quantizer_emb.weight[None, :, None, :]
        b, q, l, d = x.shape
        return self.cond_downsampling(x.permute(0, 2, 1, 3).reshape(b, l, q * d), pad_mask)

    def denoise(self, xt: Tensor, t: Tensor, spk: Tensor, pad_mask: Optional[Tensor] = None) -> Tensor:
        """One denoiser call at times ``t`` broadcastable to (B, L)."""
        return self.denoiser(xt, self.denoiser.mods_at(t, spk), pad_mask)


@torch.no_grad()
def prob_sample(prob: ProbGenerator, prior_hiddens: Tensor, spk: Tensor, pad_mask: Tensor,
                noise: Tensor, nfe: int, temperature: float) -> Tensor:
    """Euler sampling -> latents (B, L, target_dim); ``noise`` is the
    standard-normal draw of that shape."""
    cond = prob.encode_condition(prior_hiddens, pad_mask)
    xt = noise.float() * temperature + cond
    ts = torch.linspace(0.0, 1.0, nfe + 1, dtype=torch.float32, device=cond.device)[:-1]
    mods = prob.denoiser.compute_mods(ts, spk)
    delta_t = 1.0 / nfe
    for i in range(nfe):
        xt = xt + delta_t * prob.denoiser(xt, [m[i] for m in mods], pad_mask)
    return xt


def prob_loss(prob: ProbGenerator, x1: Tensor, prior_hiddens: Tensor, spk: Tensor,
              pad_mask: Tensor, sigma_min: float, generator: Optional[torch.Generator] = None,
              t: Optional[Tensor] = None, noise: Optional[Tensor] = None,
              loss_norm: str = "masked", rows: Optional[BatchRows] = None) -> Dict[str, Tensor]:
    """fm_loss + anchor_loss of the flow from ``noise + cond`` to the latents
    ``x1`` (B, L, target_dim), at a time per frame.  ``t`` (B, L, 1) uniform
    and ``noise`` (B, L, target_dim) standard normal are drawn from
    ``generator`` (t first) where not given.

    ``loss_norm="masked"`` takes means over the valid positions;
    ``"reference"`` over the whole padded (B, L, C) buffer, and the anchor
    then compares against the raw ``x1`` buffer (zero-padded by the
    collator).  ``rows``: as in ``pva_loss``."""
    cond = prob.encode_condition(prior_hiddens, pad_mask)
    b, l, c = cond.shape
    if t is None:
        t = draw(torch.rand, (b, l, 1), generator, cond.device, rows)
    if noise is None:
        noise = draw(torch.randn, cond.shape, generator, cond.device, rows)
    x0 = noise + cond
    xt = t * x1 + (1.0 - (1.0 - sigma_min) * t) * x0
    valid = (~pad_mask)[:, :, None].float()
    if loss_norm == "reference":
        denom = denominator(torch.tensor(float(b * l * c), device=cond.device), rows)
    else:
        denom = denominator(valid.sum() * c, rows)
    dx = (x1 - (1.0 - sigma_min) * x0) * valid
    vt = prob.denoise(xt, t[..., 0], spk, pad_mask) * valid
    fm_loss = ((vt - dx) ** 2).sum() / denom
    x1_est = (xt + (1.0 - (1.0 - sigma_min) * t) * vt) * valid
    x1_ref = x1 if loss_norm == "reference" else x1 * valid
    anchor_loss = ((x1_est - x1_ref) ** 2).sum() / denom
    return {"fm_loss": fm_loss, "anchor_loss": anchor_loss}
