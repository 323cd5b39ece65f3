"""The NaturalSpeech 3 FaCodec in plain PyTorch, over its parameter tree
as the ``.npz`` checkpoint flattens it ('/'-joined paths, torch conv
layouts).

* ``encode``: conv stem -> 4 blocks (3 dilated residual units, alias-free
  Snake, strided conv) -> Snake -> output conv: wav (1, N, 1) -> latents
  (1, N / 200, 256).
* ``analyze``: the prosody, content and residual vector quantizers (8-d
  codebooks, nearest by cosine) -> codes (6, T); the timbre encoder (4
  pre-LN transformer layers, masked mean) -> (256,).
* ``embed``: codes -> the sum of their quantized embeddings.
* ``decode``: timbre-conditioned LayerNorm -> conv stem -> 4 blocks (Snake,
  strided transposed conv, 3 residual units) -> Snake -> output conv ->
  tanh.

The alias-free Snake (2x kaiser-sinc upsample, SnakeBeta, 2x decimate) is
written as shifted multiply-adds of its 12 fixed taps: a filter, not a
product, in every precision.  Every other conv and matmul goes through
``Numerics``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from benchmark.reference.numerics import Numerics

HOP = 200
DILATIONS = (1, 3, 9)
GROUP_SIZES = (1, 2, 3)  # prosody, content, residual quantizers
TIMBRE_HEADS = 4


def kaiser_sinc_taps(cutoff: float = 0.25, half_width: float = 0.3, size: int = 12) -> np.ndarray:
    """The normalized kaiser-windowed sinc low-pass of the codec's Snake."""
    half = size // 2
    a = 2.285 * (half - 1) * math.pi * 4.0 * half_width + 7.95
    beta = 0.1102 * (a - 8.7) if a > 50.0 else (0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
                                                 if a >= 21.0 else 0.0)
    k = np.arange(size, dtype=np.float64)
    window = np.i0(beta * np.sqrt(1.0 - ((k - (size - 1) / 2.0) / ((size - 1) / 2.0)) ** 2)) / np.i0(beta)
    time = np.arange(-half, half, dtype=np.float64) + 0.5
    filt = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    return (filt / filt.sum()).astype(np.float32)


TAPS = kaiser_sinc_taps()


def edge_pad(x: Tensor, lo: int, hi: int) -> Tensor:
    idx = torch.arange(-lo, x.shape[1] + hi, device=x.device).clamp(0, x.shape[1] - 1)
    return x[:, idx]


def snake(x: Tensor, log_alpha: Tensor, log_beta: Tensor) -> Tensor:
    """Alias-free SnakeBeta over channel-last (B, T, C)."""
    b, t, c = x.shape
    xp = edge_pad(x, 5, 5)
    up = torch.zeros(b, 2 * xp.shape[1] + 10, c, dtype=x.dtype, device=x.device)
    for k, tap in enumerate(TAPS):  # transposed conv, stride 2
        up[:, k:k + 2 * xp.shape[1]:2] += xp * (2.0 * float(tap))
    up = up[:, 15:-15]
    y = up + (1.0 / (torch.exp(log_beta) + 1e-9)) * torch.sin(up * torch.exp(log_alpha)) ** 2
    yp = edge_pad(y, 5, 6)
    out = torch.zeros_like(x)
    for k, tap in enumerate(TAPS):  # conv, stride 2
        out = out + yp[:, k:k + 2 * t:2] * float(tap)
    return out


class PlainCodec:
    def __init__(self, enc: Dict[str, Tensor], dec: Dict[str, Tensor],
                 numerics: Optional[Numerics] = None,
                 up_enc=(2, 4, 5, 5), up_dec=(5, 5, 4, 2)):
        """``enc`` / ``dec``: flat parameter dicts ('/'-paths) holding the
        values the program computes with."""
        self.e = {k: v.float() for k, v in enc.items()}
        self.d = {k: v.float() for k, v in dec.items()}
        self.num = numerics or Numerics()
        self.up_enc, self.up_dec = tuple(up_enc), tuple(up_dec)
        self._ops: Dict[Tuple[int, str], Tensor] = {}

    def w(self, tree: Dict[str, Tensor], name: str) -> Tensor:
        key = (id(tree), name)
        if key not in self._ops:
            self._ops[key] = self.num.operand(tree[name])
        return self._ops[key]

    def conv(self, x: Tensor, tree, name: str, padding: int = 0, stride: int = 1,
             dilation: int = 1) -> Tensor:
        y = F.conv1d(self.num.operand(x.transpose(1, 2)), self.w(tree, name + "/w"), tree[name + "/b"],
                     stride=stride, padding=padding, dilation=dilation)
        return y.transpose(1, 2)

    def linear(self, x: Tensor, tree, name: str, bias: str = "") -> Tensor:
        """x @ w.T + b with w (out, in) at ``name``/w (or ``name``, ``bias``)."""
        wname, bname = (name + "/w", name + "/b") if not bias else (name, bias)
        return F.linear(self.num.operand(x), self.w(tree, wname), tree[bname])

    def act(self, x: Tensor, tree, name: str) -> Tensor:
        return snake(x, tree[name + "/alpha"], tree[name + "/beta"])

    def unit(self, x: Tensor, tree, pre: str, dilation: int) -> Tensor:
        h = self.conv(self.act(x, tree, pre + "/act1"), tree, pre + "/conv1", 3 * dilation,
                      dilation=dilation)
        return x + self.conv(self.act(h, tree, pre + "/act2"), tree, pre + "/conv2")

    def units(self, x: Tensor, tree, pre: str) -> Tensor:
        for i, d in enumerate(DILATIONS):
            x = self.unit(x, tree, f"{pre}/res/{i}", d)
        return x

    # --- analysis ---------------------------------------------------------------

    def encode(self, wav: Tensor) -> Tensor:
        x = self.conv(wav, self.e, "stem", 3)
        for i, s in enumerate(self.up_enc):
            x = self.act(self.units(x, self.e, f"blocks/{i}"), self.e, f"blocks/{i}/act")
            x = self.conv(x, self.e, f"blocks/{i}/down", s // 2 + s % 2, stride=s)
        return self.conv(self.act(x, self.e, "final_act"), self.e, "out", 1)

    def quantize(self, x: Tensor, pre: str) -> Tuple[Tensor, Tensor]:
        """One factorized VQ layer: codes (B, T) and the quantized (B, T, D)."""
        z = self.linear(x, self.d, pre + "/in_proj")
        z = z / torch.clamp(z.norm(dim=-1, keepdim=True), min=1e-12)
        book = self.d[pre + "/codebook"]
        book_n = book / torch.clamp(book.norm(dim=-1, keepdim=True), min=1e-12)
        codes = torch.argmax(self.num.operand(z) @ self.num.operand(book_n).t(), dim=-1)
        return codes, self.linear(book[codes], self.d, pre + "/out_proj")

    def analyze(self, latents: Tensor, n_frames: int) -> Tuple[Tensor, Tensor]:
        """latents (1, T, 256) with ``n_frames`` valid -> (codes (6, T), timbre (256,))."""
        pad = torch.arange(latents.shape[1], device=latents.device)[None, :] >= n_frames
        x = latents.masked_fill(pad[:, :, None], 0.0)
        codes, sums = [], []
        for g, n in enumerate(GROUP_SIZES):
            residual = x if g < 2 else x - (sums[0] + sums[1])
            total = torch.zeros_like(x)
            for j in range(n):
                c, q = self.quantize(residual, f"quantizers/{g}/{j}")
                residual, total = residual - q, total + q
                codes.append(c[0])
            sums.append(total)
        return torch.stack(codes), self.timbre(latents, pad)[0]

    def timbre(self, x: Tensor, pad: Tensor) -> Tensor:
        """(1, T, 256) -> (1, 256).  Row b of a batch gets row b of the
        sinusoid buffer added to every frame (the trained encoder's
        positional encoding is indexed by the batch): row 0 here."""
        d = x.shape[-1]
        x = x + torch.as_tensor(np.tile([0.0, 1.0], d // 2), dtype=torch.float32, device=x.device)
        tree = self.d
        i = 0
        while f"timbre_encoder/layers/{i}/ln1/g" in tree:
            pre = f"timbre_encoder/layers/{i}"
            x = x + self.attention(self.layer_norm(x, pre + "/ln1"), pre + "/attn", pad)
            h = self.layer_norm(x, pre + "/ln2").masked_fill(pad[:, :, None], 0.0)
            k = tree[pre + "/ffn1/w"].shape[-1]
            h = F.relu(self.conv(h, tree, pre + "/ffn1", k // 2))
            x = x + self.linear(h, tree, pre + "/ffn2")
            i += 1
        x = self.layer_norm(x, "timbre_encoder/last_ln")
        valid = (~pad)[:, :, None].float()
        return (x * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)

    def layer_norm(self, x: Tensor, pre: str) -> Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.d[pre + "/g"], self.d[pre + "/b"], 1e-5)

    def attention(self, x: Tensor, pre: str, pad: Tensor) -> Tensor:
        b, l, d = x.shape
        hd = d // TIMBRE_HEADS
        qkv = self.linear(x, self.d, pre + "/in_proj_w", pre + "/in_proj_b")
        q, k, v = (t.reshape(b, l, TIMBRE_HEADS, hd).transpose(1, 2) for t in qkv.split(d, dim=-1))
        s = self.num.operand(q) @ self.num.operand(k).transpose(-1, -2) / np.sqrt(hd)
        att = torch.softmax(s.masked_fill(pad[:, None, None, :], -1e9), dim=-1)
        out = (self.num.operand(att) @ self.num.operand(v)).transpose(1, 2).reshape(b, l, d)
        return self.linear(out, self.d, pre + "/out_proj_w", pre + "/out_proj_b")

    # --- synthesis --------------------------------------------------------------

    def embed(self, codes: Tensor) -> Tensor:
        """codes (6, T) -> (1, T, 256)."""
        out, q = 0.0, 0
        for g, n in enumerate(GROUP_SIZES):
            for j in range(n):
                pre = f"quantizers/{g}/{j}"
                out = out + self.linear(self.d[pre + "/codebook"][codes[q]], self.d, pre + "/out_proj")
                q += 1
        return out[None]

    def decode(self, latents: Tensor, timbre: Tensor) -> Tensor:
        """latents (1, T, 256), timbre (256,) -> wav (1, 200 T)."""
        style = self.linear(timbre[None], self.d, "timbre_linear")
        gamma, beta = style[:, None, :].chunk(2, dim=-1)
        mean = latents.mean(-1, keepdim=True)
        var = ((latents - mean) ** 2).mean(-1, keepdim=True)
        x = (latents - mean) / torch.sqrt(var + 1e-5) * gamma + beta
        x = self.conv(x, self.d, "stem", 3)
        for i, s in enumerate(self.up_dec):
            x = self.act(x, self.d, f"blocks/{i}/act")
            y = F.conv_transpose1d(self.num.operand(x.transpose(1, 2)), self.w(self.d, f"blocks/{i}/up/w"),
                                   self.d[f"blocks/{i}/up/b"], stride=s, padding=s // 2 + s % 2,
                                   output_padding=s % 2)
            x = self.units(y.transpose(1, 2), self.d, f"blocks/{i}")
        x = self.conv(self.act(x, self.d, "final_act"), self.d, "out", 3)
        return torch.tanh(x)[..., 0]


def load_tree(path: str) -> Dict[str, np.ndarray]:
    """A flattened ``.npz`` checkpoint."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def stored(tree: Dict[str, np.ndarray], dtype: Optional[torch.dtype], device) -> Dict[str, Tensor]:
    """The values a program holding ``tree`` in ``dtype`` computes with."""
    out = {}
    for k, v in tree.items():
        t = torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)
        out[k] = t if dtype is None else t.to(dtype).float()
    return out
