"""The three sinusoid conventions the trained weights depend on:

* ``sinusoid_position_table``: FastSpeech2 position table
* ``flow_time_embedding``: PVA time embedding, [sin | cos], scale 1000
* ``dit_timestep_embedding``: DiT timestep embedding, [cos | sin]

The position table is built in float64 with numpy, as the JAX package
builds it, once per (shape, device): later calls return the same tensor,
so a serving call copies nothing up from the host for it (and a CUDA
graph can hold the call).  Callers must not write into it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import Tensor


def position_table_np(n_position: int, d_hid: int) -> np.ndarray:
    """The FastSpeech2 sinusoid table in float64."""
    positions = np.arange(n_position, dtype=np.float64)[:, None]
    dims = np.arange(d_hid, dtype=np.float64)[None, :]
    angles = positions / np.power(10000.0, 2.0 * (dims // 2) / d_hid)
    table = np.empty((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angles[:, 0::2])
    table[:, 1::2] = np.cos(angles[:, 1::2])
    return table


@functools.lru_cache(maxsize=None)
def _position_table(n_position: int, d_hid: int, device: torch.device) -> Tensor:
    return torch.as_tensor(position_table_np(n_position, d_hid), dtype=torch.float32, device=device)


def sinusoid_position_table(n_position: int, d_hid: int, device=None) -> Tensor:
    """(n_position, d_hid) float32, made once per (shape, device)."""
    return _position_table(n_position, d_hid, torch.device("cpu" if device is None else device))


def flow_time_embedding(t: Tensor, dim: int, scale: float = 1000.0) -> Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-np.log(10000.0) / (half - 1)))
    args = scale * torch.atleast_1d(t).float()[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def dit_timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0) -> Tensor:
    half = dim // 2
    freqs = torch.exp(-np.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb
