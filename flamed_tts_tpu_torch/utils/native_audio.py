"""ctypes bindings for the port's native WAV codec (``csrc/wavio.cpp``).

The shared object is built with ``g++`` at first use into ``build/native/``
at the repository root (named by a hash of the source, so an unchanged
library is reused) and loaded with ``ctypes``.  As in the JAX package
(``flamed_tts_tpu/utils/native_audio.py``), every function returns None
where the library cannot be built or loaded, or the input is not a WAV it
decodes, and ``utils/audio.py`` then takes the scipy path: this is host I/O,
not a device kernel, so the contract is the JAX one.  ``library()`` says
whether it is there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc", "wavio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "build", "native")
FLAGS = ("-O3", "-fPIC", "-shared", "-Wall")
COMPILER = "g++"

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
build_error: Optional[str] = None  # why the last build or load failed


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libwavio-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = shutil.which(COMPILER) or COMPILER
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run([cxx, *FLAGS, SOURCE, "-o", tmp], check=True, capture_output=True,
                   text=True, timeout=120)
    os.replace(tmp, path)


def library() -> Optional[ctypes.CDLL]:
    """The loaded codec, built first if needed; None where that fails."""
    global _lib, _load_failed, build_error
    if _lib is not None or _load_failed:
        return _lib
    try:
        path = library_path()
        if not os.path.isfile(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.wavio_decode.restype = ctypes.c_long
        lib.wavio_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.wavio_encode.restype = ctypes.c_long
        lib.wavio_encode.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
                                     ctypes.c_char_p, ctypes.c_long]
        _lib = lib
    except (OSError, subprocess.SubprocessError) as exc:
        detail = getattr(exc, "stderr", None)
        build_error = f"{exc}" + (f"\n{detail}" if detail else "")
        _load_failed = True
    return _lib


def decode_wav(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """WAV bytes -> (mono float32, sample rate); None if unavailable or
    not a WAV the codec decodes."""
    lib = library()
    if lib is None:
        return None
    capacity = max(len(data) // 2, 16)
    out = np.empty(capacity, dtype=np.float32)
    sr = ctypes.c_int(0)
    n = lib.wavio_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         capacity, ctypes.byref(sr))
    if n < 0:
        return None
    return out[:n].copy(), int(sr.value)


def encode_wav(samples: np.ndarray, sample_rate: int) -> Optional[bytes]:
    """Mono float32 -> 16-bit PCM WAV bytes; None if unavailable."""
    lib = library()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    capacity = 44 + 2 * samples.size
    out = ctypes.create_string_buffer(capacity)
    n = lib.wavio_encode(samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), samples.size,
                         sample_rate, out, capacity)
    if n < 0:
        return None
    return out.raw[:n]
