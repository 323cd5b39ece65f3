"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``.  The
build happens at first use into ``build/kernels/`` at the repository root
(one library per source, named by a hash of its sources and flags, so an
unchanged library is reused); ``build()`` compiles all sources at once,
one ``nvcc`` process each.

``launches`` counts, per kernel, the launches its wrapper has made (the
codec's libraries hold one kernel each, named as the library; the
denoiser's holds three, ``COUNTERS``); a run
sets them to 0 with ``reset_launches()`` and reads them afterwards to show
which kernels a path went through.

Under grad each wrapper goes through a ``torch.autograd.Function`` whose
forward is the kernel and whose backward is ``plain_vjp``: the plain
chain's VJP, recomputed.  There are no backward kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "kernels"
)
SOURCES = {
    "snake_filtered": ("snake_filtered.cu", "snake.cuh"),
    "residual_unit": ("residual_unit.cu", "resunit.cuh", "snake.cuh"),
    "residual_stack": ("residual_stack.cu", "resunit.cuh", "snake.cuh"),
    "denoiser": ("denoiser.cu",),
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "snake_filtered": {"snake_filtered_launch": [_P] * 4 + [_I] * 4 + [_P]},
    "residual_unit": {
        "residual_unit_launch": [_P] * 3 + [_I] * 6 + [_P],
        "residual_unit_smem_bytes": [_I] * 4,
    },
    "residual_stack": {
        "residual_stack_launch": [_P] * 3 + [_I] * 8 + [_P],
        "residual_stack_smem_bytes": [_I] * 6,
    },
    "denoiser": {
        "norm_modulate_launch": [_P] * 5 + [_I] * 2 + [_P] * 2 + [_I] * 2 + [_P] * 5 + [_I] * 3
                                + [_F, _I, _I, _P],
        "conv_norm_launch": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
        "conv_norm_smem_bytes": [_I] * 2,
        "act_launch": [_P] * 3 + [ctypes.c_longlong] + [_I] * 3 + [_P],
    },
}
IO_DTYPES = (torch.float32, torch.bfloat16)  # the kernels' io types

# launch counters: one a library, named as it, but the denoiser's three kernels
COUNTERS = {"denoiser": ("norm_modulate", "conv_norm", "act")}
launches: Dict[str, int] = {k: 0 for name in SOURCES for k in COUNTERS.get(name, (name,))}
build_log: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _taps_header() -> str:
    """Path of a header defining SNAKE_TAPS, written if missing.  (nvcc
    splits -D values at commas, so the 12 taps go through a file.)"""
    from flamed_tts_tpu_torch.ops.resample import snake_taps

    # repr of the float32 value as a double is exact, so the literal rounds
    # back to the same float32.
    text = "#define SNAKE_TAPS " + ", ".join(f"{float(v)!r}f" for v in snake_taps()) + "\n"
    path = os.path.join(BUILD_DIR, f"snake_taps-{hashlib.sha256(text.encode()).hexdigest()[:16]}.h")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(f"{path}.{os.getpid()}.tmp", "w") as f:
            f.write(text)
        os.replace(f"{path}.{os.getpid()}.tmp", path)
    return path


def _flags() -> list:
    return [
        "-gencode=arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-Xptxas",
        "-v",
        "-include",
        _taps_header(),
    ]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str, flags: list) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in SOURCES[name]:
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    all ``nvcc`` processes at once; load them.  Returns seconds per
    kernel built (0.0 where the library already existed).  Raises on any
    failed build."""
    names = list(SOURCES if names is None else names)
    flags = _flags()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name, flags)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    for name in names:
        library(name)
    return seconds


def library_path(name: str) -> str:
    """Where kernel ``name``'s shared library is, or will be, built."""
    return _lib_path(name, _flags())


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def check(err: int, name: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def pointers(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers, for a launch function
    that takes ``const void* const*``."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def needs_grad(*tensors) -> bool:
    """Whether autograd records through a kernel call on ``tensors``:
    grad is enabled and one of them requires grad.  A bfloat16 one then
    raises: the kernels' backward is float32 (the codec trains in float32)."""
    if not torch.is_grad_enabled() or not any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        return False
    if any(isinstance(t, torch.Tensor) and t.dtype != torch.float32 for t in tensors):
        raise RuntimeError("the kernels carry gradients in float32 only: a bfloat16 input or "
                           "parameter that requires grad is refused under grad")
    return True


def plain_vjp(plain, inputs, grad_out, needs) -> tuple:
    """The backward of a kernel's ``torch.autograd.Function``: its plain
    version ``plain(*inputs)`` recomputed under grad on the saved input and
    the live parameters, and ``torch.autograd.grad`` of it for each of
    ``inputs`` whose ``needs`` entry is true (None for the others).  It is
    the plain chain's VJP at the kernel's input; nothing of the forward is
    kept between the two.  ``inputs`` may hold None (an absent optional
    tensor); a ``plain`` with several outputs takes a tuple of them in
    ``grad_out``."""
    with torch.enable_grad():
        leaves = [t if t is None else t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        outs = plain(*leaves)
        if not isinstance(outs, tuple):
            outs, grad_out = (outs,), (grad_out,)
        pairs = [(o, g) for o, g in zip(outs, grad_out) if o.requires_grad]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs]))
    return tuple(next(grads) if n else None for n in needs)


def require(t: torch.Tensor, what: str, shape=None, dtype=None, aligned: bool = False) -> None:
    """The wrappers' input check: CUDA, float32 or bfloat16 (exactly
    ``dtype`` where one is given), contiguous, shape; with ``aligned``
    also a first element on a 16-byte boundary, for a kernel that loads
    and stores several values at once."""
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor")
    if t.dtype not in IO_DTYPES:
        raise ValueError(f"{what} must be float32 or bfloat16, got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{what} must be aligned to 16 bytes")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
