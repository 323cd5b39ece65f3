"""Work counts of the port: the hand kernels' analytic (flops, bytes), the
card's peak rates, and a counter of both over any stretch of code.

* ``kernel_cost``: one K1 / K2 / K3 call's floating-point operations and
  the bytes it must move (each input read once, each output written once,
  the parameters read once), from its shapes alone.  ``chip_smoke.py``'s
  bound and ``bench_components`` count with this one formula.
* ``PEAKS`` / ``device_peaks``: published dense peak rates by card name;
  an unknown card raises instead of taking another card's numbers.
* ``CostCounter``: a context manager that counts the aten ops' FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode`` (matmul, convolution,
  attention) and their bytes (every tensor input and output of an op that
  is not a view: unfused, so an upper bound on what a fusing compiler
  moves).  The hand kernels are launched through ``ctypes`` and neither
  mode sees them, so their dispatch functions (``ops/snake.py::
  snake_filtered``, ``ops/resunit.py::residual_unit`` / ``residual_stack``,
  ``ops/denoiser.py``'s three) hand their calls to ``hand_kernels`` (by
  ``kernel_cost``) or ``counted`` (their own count) while a counter is
  active: it adds the count and runs the call with the modes off, so the
  plain version's aten ops on the CPU are not counted as well.  A stage's count
  is then the same on the card and on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# K1 per element and channel: 12 upsample FMAs + 2 snakes (mul, sin, square,
# FMA) + 12 decimation FMAs, an FMA counted as 2
SNAKE_FLOP_PER_ELEM = 58
KERNEL_UNITS = {"snake_filtered": 0, "residual_unit": 1, "residual_stack": 3}


@dataclass(frozen=True)
class Peaks:
    """Dense peak rates of one card: FLOP/s by io type, bytes/s of HBM."""
    bf16_flop_per_s: float
    fp32_flop_per_s: float
    bytes_per_s: float

    def flop_per_s(self, dtype: torch.dtype) -> float:
        """bfloat16: the tensor cores; float32: outside them (TF32 off)."""
        return self.bf16_flop_per_s if dtype == torch.bfloat16 else self.fp32_flop_per_s


# NVIDIA's data sheet, H100 SXM (dense, at its 700 W limit): 989 TFLOP/s
# bf16, 67 TFLOP/s float32 without TF32, 3.35 TB/s HBM3
PEAKS: Dict[str, Peaks] = {"NVIDIA H100 80GB HBM3": Peaks(989e12, 67e12, 3.35e12)}


def device_peaks(device=None) -> Peaks:
    """The peaks of the card ``device`` (default: the current one), by
    ``torch.cuda.get_device_name``; raises for a card not in ``PEAKS``."""
    name = torch.cuda.get_device_name(device)
    if name not in PEAKS:
        raise KeyError(f"no peak rates for {name!r}: add the card's data-sheet rates to "
                       "ops/costs.py::PEAKS")
    return PEAKS[name]


def kernel_cost(name: str, rows: int, c: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(flops, bytes) of one ``name`` call on ``rows`` = B * T rows of ``c``
    channels in io type ``dtype``: x read once and the output written once,
    each unit's parameters (two convs' weights and biases in the io type,
    two snakes' float32 log alpha / beta) read once; the convs' products
    (16 T C^2 a unit: k7 and k1, an FMA counted as 2), two snakes a unit
    and the residual add."""
    n, item = rows * c, (2 if dtype == torch.bfloat16 else 4)
    units = KERNEL_UNITS[name]
    if units == 0:
        return SNAKE_FLOP_PER_ELEM * n, 2 * item * n + 8 * c
    nbytes = 2 * item * n + units * (item * (8 * c * c + 2 * c) + 16 * c)
    flops = units * (16 * rows * c * c + 2 * SNAKE_FLOP_PER_ELEM * n + 2 * n)
    return flops, nbytes


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype, peaks: Peaks) -> Tuple[float, str]:
    """(least ms for the work, 'bytes' | 'operations'): the larger of the
    bytes over the HBM rate and the operations over the io type's peak."""
    tb, to = nbytes / peaks.bytes_per_s, flops / peaks.flop_per_s(dtype)
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def _addmm_flop(self_shape, a_shape, b_shape, *rest, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def _bmm_flop(a_shape, b_shape, *rest, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1] * a_shape[2] * b_shape[2]


# FlopCounterMode's formulas for addmm and bmm take a fourth positional
# argument as the output's shape; the overloads with a result type
# (``out_dtype``, the bfloat16-operand products of ``precision.py``) pass the
# type there.  These count every overload.
FLOP_FORMULAS = {torch.ops.aten.addmm: _addmm_flop, torch.ops.aten.bmm: _bmm_flop}


class _ByteMode(TorchDispatchMode):
    """Sums the bytes of every tensor input and output of each aten op that
    is not a view (a view moves nothing)."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


_active: List["CostCounter"] = []


class CostCounter:
    """``with CostCounter() as cc: ...``, then ``cc.flops`` and ``cc.bytes``
    (aten ops and hand kernels together) and ``cc.kernels`` ({kernel name:
    calls}).  Counters nest: a hand kernel adds to every active one."""

    def __init__(self) -> None:
        self.kernel_flops = 0
        self.kernel_bytes = 0
        self.kernels: Dict[str, int] = {}
        self._flop_mode = FlopCounterMode(display=False, custom_mapping=FLOP_FORMULAS)
        self._byte_mode = _ByteMode()

    def __enter__(self) -> "CostCounter":
        self._flop_mode.__enter__()
        self._byte_mode.__enter__()
        _active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _active.remove(self)
        self._byte_mode.__exit__(*exc)
        self._flop_mode.__exit__(*exc)

    @property
    def flops(self) -> int:
        return self._flop_mode.get_total_flops() + self.kernel_flops

    @property
    def bytes(self) -> int:
        return self._byte_mode.bytes + self.kernel_bytes


def counting() -> bool:
    """Whether a ``CostCounter`` is active (the dispatch functions' test)."""
    return bool(_active)


def hand_kernels(calls: Sequence[Tuple[str, int, int]], dtype: torch.dtype, run: Callable):
    """Count ``calls`` ((kernel name, rows, channels) each) on every active
    counter by ``kernel_cost``, then return ``run()`` as ``counted`` does."""
    return counted([(name, *kernel_cost(name, rows, c, dtype)) for name, rows, c in calls], run)


def counted(calls: Sequence[Tuple[str, int, int]], run: Callable):
    """Count ``calls`` ((kernel name, flops, bytes) each) on every active
    counter, then return ``run()`` with the counters and their modes off:
    neither the plain version's aten ops nor the wrapper's own are counted,
    whichever runs."""
    counters = list(_active)
    for name, flops, nbytes in calls:
        for cc in counters:
            cc.kernel_flops += flops
            cc.kernel_bytes += nbytes
            cc.kernels[name] = cc.kernels.get(name, 0) + 1
    _active.clear()
    try:
        with _disable_current_modes():
            return run()
    finally:
        _active.extend(counters)
