"""Host C++ serving primitives: ``pcm16_encode``, ``pcm16_decode`` and
``crossfade``, the per-frame host work of the websocket path (the JAX
package's ``native/``).

``audio_kernels.cpp`` builds with ``g++ -O3`` at first use into
``build/native/`` at the root of the checkout (listed in ``.gitignore``),
named after the source's content hash, and is bound with ``ctypes``.  Where
no compiler is found each function runs its numpy version (the ``*_np``
functions, which the tests hold the library against), as in the JAX
package: the library is an accelerator of the host path, not a dependency.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "audio_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_F32P = ctypes.POINTER(ctypes.c_float)
_I16P = ctypes.POINTER(ctypes.c_int16)
_state = {"lib": None, "tried": False}
_lock = threading.Lock()


def _target() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libaudio_kernels-{digest[:16]}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The built library, building it on the first call; None where it
    cannot be built or loaded."""
    with _lock:
        if _state["tried"]:
            return _state["lib"]
        _state["tried"] = True
        out = _target()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:       # built elsewhere (a copied checkout): rebuild
            if not _build(out):
                return None
            try:
                lib = ctypes.CDLL(str(out))
            except OSError:
                return None
        i64 = ctypes.c_int64
        lib.pcm16_from_float.argtypes = [_F32P, i64, _I16P]
        lib.pcm16_from_float.restype = None
        lib.float_from_pcm16.argtypes = [_I16P, i64, _F32P]
        lib.float_from_pcm16.restype = None
        lib.crossfade.argtypes = [_F32P, _F32P, _F32P, _F32P, i64]
        lib.crossfade.restype = None
        _state["lib"] = lib
        return lib


def available() -> bool:
    """Whether the C++ library is built and loaded (builds it)."""
    return _load() is not None


def pcm16_encode_np(x: np.ndarray) -> bytes:
    x = np.asarray(x, np.float32).reshape(-1)
    return (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()


def pcm16_decode_np(data: bytes) -> np.ndarray:
    return np.frombuffer(data, "<i2").astype(np.float32) / 32768.0


def crossfade_np(head, tail, win_in, win_out) -> np.ndarray:
    f = [np.asarray(a, np.float32).reshape(-1)
         for a in (head, tail, win_in, win_out)]
    return f[0] * f[2] + f[1] * f[3]


def pcm16_encode(x: np.ndarray) -> bytes:
    """float32 samples -> little-endian int16 bytes, clipped to [-1, 1]."""
    lib = _load()
    if lib is None:
        return pcm16_encode_np(x)
    x = np.ascontiguousarray(x, np.float32).reshape(-1)
    out = np.empty(x.shape[0], "<i2")
    lib.pcm16_from_float(x.ctypes.data_as(_F32P), x.shape[0],
                         out.ctypes.data_as(_I16P))
    return out.tobytes()


def pcm16_decode(data: bytes) -> np.ndarray:
    """Little-endian int16 bytes -> float32 samples (/ 32768)."""
    lib = _load()
    if lib is None:
        return pcm16_decode_np(data)
    src = np.ascontiguousarray(np.frombuffer(data, "<i2"))
    out = np.empty(src.shape[0], np.float32)
    lib.float_from_pcm16(src.ctypes.data_as(_I16P), src.shape[0],
                         out.ctypes.data_as(_F32P))
    return out


def crossfade(head: np.ndarray, tail: np.ndarray, win_in: np.ndarray,
              win_out: np.ndarray) -> np.ndarray:
    """head * win_in + tail * win_out over the overlap, into a copy of
    head."""
    lib = _load()
    if lib is None:
        return crossfade_np(head, tail, win_in, win_out)
    n = np.asarray(head).reshape(-1).shape[0]
    arrs = [np.ascontiguousarray(a, np.float32).reshape(-1)
            for a in (tail, win_in, win_out)]
    if any(a.shape[0] != n for a in arrs):
        raise ValueError("crossfade: head, tail and windows differ in "
                         "length")
    out = np.array(head, np.float32).reshape(-1)
    lib.crossfade(out.ctypes.data_as(_F32P),
                  *(a.ctypes.data_as(_F32P) for a in arrs), n)
    return out
