"""Flamed-TTS's prior and prob generators in plain PyTorch, over a state
dict (the parameter names of the published model's modules).

* ``encode``: phoneme embedding + sinusoid positions -> FFT blocks (post-LN
  self-attention, conv feed-forward).
* ``pva_durations``: the duration and silence flows (flow matching over
  log(duration + 1)) Euler-integrated from ``noise * temperature``, rounded
  to integer frames.
* ``decode``: length regulation (silence frames copy the first encoded
  frame), the shared decoder, then per quantizer a decoder over [prompt
  codes ‖ target], each taking the previous one's target states.
* ``prob_sample``: condition downsampler, then the ConvNeXt / adaLN
  denoiser Euler-integrated from ``noise * temperature + condition``.

The phoneme encoder, the flows and the decoders run at each row's exact
length, unmasked.  The condition path and the denoiser run at a frame
bucket with the padding mask, because the codec decodes the whole bucket
and the frames past the target length reach the last samples of the wav
through its convolutions.  Weights are as the program stores them (the
caller rounds them); every product goes through ``Numerics``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from benchmark.reference.numerics import Numerics


def position_table(n: int, d: int, device) -> Tensor:
    """The FastSpeech2 sinusoid table, built in float64."""
    pos = np.arange(n, dtype=np.float64)[:, None]
    dims = np.arange(d, dtype=np.float64)[None, :]
    ang = pos / np.power(10000.0, 2.0 * (dims // 2) / d)
    table = np.where(np.arange(d)[None, :] % 2 == 0, np.sin(ang), np.cos(ang))
    return torch.as_tensor(table, dtype=torch.float32, device=device)


def flow_time_embedding(t: Tensor, dim: int) -> Tensor:
    """[sin | cos] at scale 1000: (1, dim) for a scalar time."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-np.log(10000.0) / (half - 1)))
    args = 1000.0 * t.reshape(-1, 1).float() * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def dit_timestep_embedding(t: Tensor, dim: int) -> Tensor:
    """[cos | sin], max period 10000."""
    half = dim // 2
    freqs = torch.exp(-np.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def masked_group_norm(x: Tensor, groups: int, weight: Tensor, bias: Tensor,
                      pad: Tensor, eps: float = 1e-5) -> Tensor:
    """GroupNorm over (group channels x valid frames); pads come out 0."""
    b, l, c = x.shape
    xg = x.reshape(b, l, groups, c // groups)
    valid = (~pad)[:, :, None, None].float()
    n = torch.clamp(valid.sum(dim=1, keepdim=True) * (c // groups), min=1.0)
    mean = (xg * valid).sum(dim=(1, 3), keepdim=True) / n
    var = (((xg - mean) ** 2) * valid).sum(dim=(1, 3), keepdim=True) / n
    out = ((xg - mean) / torch.sqrt(var + eps)).reshape(b, l, c) * weight + bias
    return out.masked_fill(pad[:, :, None], 0.0)


def plain_layer_norm(x: Tensor, eps: float = 1e-6) -> Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


class PlainFlamed:
    def __init__(self, cfg: Dict, prior: Dict[str, Tensor], prob: Dict[str, Tensor],
                 numerics: Optional[Numerics] = None):
        """``cfg``: the configuration's ``prior_generator`` and
        ``prob_generator`` sections; ``prior`` / ``prob``: float32 state
        dicts holding the values the program computes with."""
        self.cfg = cfg
        self.num = numerics or Numerics()
        self.p = {"prior." + k: v.float() for k, v in prior.items()}
        self.p.update({"prob." + k: v.float() for k, v in prob.items()})
        self._op_weights: Dict[str, Tensor] = {}
        tcfg = cfg["prior_generator"]["transformer"]
        self.enc_heads, self.dec_heads = tcfg["encoder_head"], tcfg["decoder_head"]
        self.n_q = cfg["prior_generator"]["codec"]["n_quantizers"]

    # --- layers -------------------------------------------------------------

    def w(self, name: str) -> Tensor:
        """A product's weight operand."""
        if name not in self._op_weights:
            self._op_weights[name] = self.num.operand(self.p[name])
        return self._op_weights[name]

    def lin(self, x: Tensor, name: str) -> Tensor:
        return F.linear(self.num.operand(x), self.w(name + ".weight"), self.p[name + ".bias"])

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return self.num.operand(a) @ self.num.operand(b)

    def conv(self, x: Tensor, name: str, padding: Optional[int] = None) -> Tensor:
        """Conv over channel-last x; 'same' padding unless given."""
        w = self.w(name + ".weight")
        pad = (w.shape[-1] - 1) // 2 if padding is None else padding
        y = F.conv1d(self.num.operand(x.transpose(1, 2)), w, self.p[name + ".bias"], padding=pad)
        return y.transpose(1, 2)

    def ln(self, x: Tensor, name: str, eps: float) -> Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.p[name + ".weight"], self.p[name + ".bias"], eps)

    def n_layers(self, prefix: str) -> int:
        n = 0
        while f"{prefix}.layer_{n}.slf_attn.w_qs.weight" in self.p:
            n += 1
        return n

    def fft_block(self, x: Tensor, pre: str, n_head: int) -> Tensor:
        """Post-LN self-attention and conv feed-forward at exact length."""
        b, l, d = x.shape
        dk = d // n_head

        def heads(name):
            return self.lin(x, f"{pre}.slf_attn.{name}").view(b, l, n_head, dk).transpose(1, 2)

        q, k, v = heads("w_qs"), heads("w_ks"), heads("w_vs")
        att = torch.softmax(self.mm(q, k.transpose(-1, -2)) / np.sqrt(dk), dim=-1)
        a = self.mm(att, v).transpose(1, 2).reshape(b, l, d)
        x = self.ln(self.lin(a, f"{pre}.slf_attn.fc") + x, f"{pre}.slf_attn.layer_norm", 1e-5)
        h = self.conv(F.relu(self.conv(x, f"{pre}.pos_ffn.w_1")), f"{pre}.pos_ffn.w_2")
        return self.ln(h + x, f"{pre}.pos_ffn.layer_norm", 1e-5)

    def stack(self, x: Tensor, prefix: str, n_head: int) -> Tensor:
        for i in range(self.n_layers(prefix)):
            x = self.fft_block(x, f"{prefix}.layer_{i}", n_head)
        return x

    # --- stage 1 --------------------------------------------------------------

    def encode(self, ids: Tensor) -> Tensor:
        """ids (1, L) -> (1, L, H)."""
        emb = self.p["prior.src_word_emb.weight"][ids]
        return self.stack(emb + position_table(ids.shape[1], emb.shape[-1], ids.device)[None],
                          "prior.encoder", self.enc_heads)

    def pva_field(self, name: str, xt: Tensor, enc: Tensor, t: Tensor) -> Tensor:
        pre = f"prior.{name}"
        out = self.lin(torch.cat([xt[..., None], enc], dim=-1), pre + ".proj")
        temb = flow_time_embedding(t, enc.shape[-1])
        temb = self.lin(F.silu(self.lin(temb, pre + ".time_emb.mlp_1")), pre + ".time_emb.mlp_3")
        out = out + temb[:, None, :]
        out = self.ln(F.relu(self.conv(out, pre + ".conv1d_1")), pre + ".layer_norm_1", 1e-5)
        out = self.ln(F.relu(self.conv(out, pre + ".conv1d_2", padding=1)), pre + ".layer_norm_2", 1e-5)
        return self.lin(out, pre + ".linear_layer")[..., 0]

    def pva_durations(self, enc: Tensor, dur_noise: Tensor, sil_noise: Tensor, nfe: int,
                      temperature: float) -> Tuple[Tensor, Tensor]:
        """(phone frames, silence frames), each (1, L) float."""
        dur, sil = dur_noise.float() * temperature, sil_noise.float() * temperature
        ts = torch.linspace(0.0, 1.0, nfe + 1, dtype=torch.float32, device=enc.device)[:-1]
        for i in range(nfe):
            v_dur = self.pva_field("duration_generator", dur, enc, ts[i])
            v_sil = self.pva_field("sil_generator", sil, enc, ts[i])
            dur, sil = dur + (1.0 / nfe) * v_dur, sil + (1.0 / nfe) * v_sil

        def frames(x):
            return torch.clamp(torch.round(torch.exp(x) - 1.0), min=0)

        return frames(dur), frames(sil)

    @staticmethod
    def target_length(phone_dur: Tensor, sil_dur: Tensor) -> int:
        """Frames of an utterance: every phone at least one."""
        return int((torch.clamp(phone_dur, min=1.0).sum() + sil_dur.sum()).item())

    # --- stage 2 ----------------------------------------------------------------

    @staticmethod
    def regulate(enc: Tensor, phone_dur: Tensor, sil_dur: Tensor) -> Tensor:
        """(1, L, H) -> (1, T, H): phone i for its frames, then its silence
        frames as copies of the first encoded frame."""
        src = []
        for i in range(enc.shape[1]):
            src += [i] * max(int(phone_dur[0, i]), 1) + [0] * int(sil_dur[0, i])
        return enc[:, torch.as_tensor(src, device=enc.device)]

    def decode(self, lr: Tensor, prompt: Tensor) -> Tuple[Tensor, Tensor]:
        """lr (1, T, H), prompt codes (n_q, P) -> (hiddens (1, n_q, T, D),
        logits (1, n_q, T, V + 1)); target frame i at position P + i."""
        t, p = lr.shape[1], prompt.shape[1]
        d = self.p["prior.bridge.weight"].shape[0]
        pos = position_table(p + t, d, lr.device)
        out = self.stack(self.lin(lr, "prior.bridge") + pos[None, :t], "prior.shared_decoder",
                         self.dec_heads)
        seg = torch.cat([self.p["prior.prompt_seg_emb"].expand(1, p, d),
                         self.p["prior.target_seg_emb"].expand(1, t, d)], dim=1)
        hiddens = []
        for q in range(self.n_q):
            prompt_emb = self.p["prior.code_embedding.weight"][prompt[q]][None]
            x = torch.cat([prompt_emb, out], dim=1) + seg + self.p["prior.quantizer_emb.weight"][q] + pos[None]
            out = self.stack(x, f"prior.prior_decoder_{q}", self.dec_heads)[:, p:]
            hiddens.append(out)
        hiddens = torch.stack(hiddens, dim=1)
        return hiddens, self.lin(hiddens, "prior.head")

    def condition(self, hiddens: Tensor, pad: Tensor) -> Tensor:
        """(B, n_q, F, D) -> (B, F, target_dim), at the frame bucket."""
        x = hiddens + self.p["prob.quantizer_emb.weight"][None, :, None, :]
        b, q, f, d = x.shape
        x = x.permute(0, 2, 1, 3).reshape(b, f, q * d)
        pre = "prob.cond_downsampling"
        i = 0
        while f"{pre}.resblock_{i}.conv.weight" in self.p:
            r = f"{pre}.resblock_{i}"
            h = self.lin(x.masked_fill(pad[:, :, None], 0.0), r + ".conv")
            h = F.mish(masked_group_norm(h, 8, self.p[r + ".norm.weight"], self.p[r + ".norm.bias"], pad))
            x = x + h.masked_fill(pad[:, :, None], 0.0)
            x = self.lin(x, f"{pre}.down_conv_{i}")
            x = F.relu(masked_group_norm(x, 8, self.p[f"{pre}.down_norm_{i}.weight"],
                                         self.p[f"{pre}.down_norm_{i}.bias"], pad))
            i += 1
        return F.relu(self.lin(x, pre + ".proj_out"))

    def convnext(self, x: Tensor, pre: str, pad: Tensor) -> Tensor:
        """Depthwise conv (float32, a sum of shifted products) -> per-channel
        norm over valid frames -> pointwise MLP, residual."""
        w = self.p[pre + ".conv_1.weight"]
        h = F.conv1d(x.masked_fill(pad[:, :, None], 0.0).transpose(1, 2), w,
                     self.p[pre + ".conv_1.bias"], padding=(w.shape[-1] - 1) // 2,
                     groups=w.shape[0]).transpose(1, 2)
        h = masked_group_norm(h, h.shape[-1], self.p[pre + ".ln_1.weight"], self.p[pre + ".ln_1.bias"], pad)
        return x + self.lin(F.gelu(self.lin(h, pre + ".conv_2")), pre + ".conv_3")

    def n_blocks(self) -> int:
        n = 0
        while f"prob.denoiser.res_block_{n}.mlp_0.weight" in self.p:
            n += 1
        return n

    def modulations(self, nfe: int, spk: Tensor) -> List[Tensor]:
        """Every Euler step's adaLN modulations: per block (S, B, 1, 6C),
        the final layer's (S, B, 1, 5C)."""
        pre = "prob.denoiser"
        ts = torch.linspace(0.0, 1.0, nfe + 1, dtype=torch.float32, device=spk.device)[:-1]
        freq = self.p[pre + ".time_embed.mlp_0.weight"].shape[1]
        t_emb = self.lin(F.silu(self.lin(dit_timestep_embedding(ts[:, None], freq),
                                         pre + ".time_embed.mlp_0")), pre + ".time_embed.mlp_2")
        y = F.silu(t_emb[:, None, :, :] + self.lin(spk, pre + ".cond_embed")[None, :, None, :])
        names = [f"{pre}.res_block_{i}" for i in range(self.n_blocks())] + [pre + ".final_layer"]
        return [self.lin(y, n + ".adaLN_modulation") for n in names]

    def denoiser(self, x: Tensor, mods: List[Tensor], pad: Tensor) -> Tensor:
        pre = "prob.denoiser"
        x = self.lin(x, pre + ".proj_in")
        for i, m in enumerate(mods[:-1]):
            r = f"{pre}.res_block_{i}"
            shift_c, scale_c, gate_c, shift_m, scale_m, gate_m = m.chunk(6, dim=-1)
            h = self.ln(x, r + ".ln_conv", 1e-6) * (1.0 + scale_c) + shift_c
            x = x + gate_c * self.convnext(h, r + ".conv_in", pad)
            h = self.ln(x, r + ".ln_mlp", 1e-6) * (1.0 + scale_m) + shift_m
            x = x + gate_m * self.lin(F.silu(self.lin(h, r + ".mlp_0")), r + ".mlp_2")
        fl = pre + ".final_layer"
        shift_c, scale_c, gate_c, shift_m, scale_m = mods[-1].chunk(5, dim=-1)
        h = self.convnext(plain_layer_norm(x) * (1.0 + scale_c) + shift_c, fl + ".conv_in", pad)
        x = plain_layer_norm(x + gate_c * h) * (1.0 + scale_m) + shift_m
        return self.conv(x.masked_fill(pad[:, :, None], 0.0), fl + ".conv_out")

    def prob_sample(self, hiddens: Tensor, spk: Tensor, pad: Tensor, noise: Tensor, nfe: int,
                    temperature: float) -> Tensor:
        """Latents (B, F, target_dim) from the noise (B, F, target_dim)."""
        xt = noise.float() * temperature + self.condition(hiddens, pad)
        mods = self.modulations(nfe, spk)
        for i in range(nfe):
            xt = xt + (1.0 / nfe) * self.denoiser(xt, [m[i] for m in mods], pad)
        return xt


def stored(state: Dict[str, Tensor], dtype: Optional[torch.dtype]) -> Dict[str, Tensor]:
    """The values a program holding ``state`` in ``dtype`` computes with."""
    if dtype is None:
        return {k: v.float() for k, v in state.items()}
    return {k: v.to(dtype).float() for k, v in state.items()}


def mask_from_length(n: int, bucket: int, device) -> Tensor:
    """(1, bucket) bool, True past the first ``n``."""
    return torch.arange(bucket, device=device)[None, :] >= n
