"""ctypes binding for the native mesh-query backend (`meshquery.cpp`).

A copy of `etch_tpu/native/__init__.py` with its own copy of the C++
source.  The library is built with g++ at first use into
`build/etch_tpu_torch/native/<hash>/libmeshquery.so` at the repository root
(listed in `.gitignore`), keyed by a hash of the source and flags, and
nothing is written beside the source.  Callers fall back to the numpy
implementation in `etch_tpu_torch.data.proximity` when the toolchain is
unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "meshquery.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "etch_tpu_torch" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_build_failed = False


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libmeshquery.so"


def _build() -> Optional[str]:
    out = library_path()
    if out.exists():
        return str(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return str(out)
    except Exception:
        return None


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _build()
        if path is None:
            _build_failed = True
            return None
        lib = ctypes.CDLL(path)
        dptr = ctypes.POINTER(ctypes.c_double)
        iptr = ctypes.POINTER(ctypes.c_int32)
        lib.mq_build.restype = ctypes.c_void_p
        lib.mq_build.argtypes = [dptr, ctypes.c_int64, iptr, ctypes.c_int64]
        lib.mq_free.argtypes = [ctypes.c_void_p]
        lib.mq_closest_point.argtypes = [
            ctypes.c_void_p, dptr, ctypes.c_int64, dptr, dptr, iptr,
        ]
        lib.mq_raycast.argtypes = [
            ctypes.c_void_p, dptr, dptr, ctypes.c_int64, ctypes.c_double,
            dptr, iptr,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class NativeBVH:
    """BVH over one mesh; closest-point + first-hit ray queries."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native meshquery backend unavailable")
        self._lib = lib
        self._verts = np.ascontiguousarray(vertices, np.float64)
        self._faces = np.ascontiguousarray(faces, np.int32)
        self._handle = lib.mq_build(
            _dp(self._verts), len(self._verts),
            _ip(self._faces), len(self._faces),
        )

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.mq_free(self._handle)
                self._handle = None
        except Exception:
            pass

    def closest_point(
        self, queries: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        q = np.ascontiguousarray(queries, np.float64)
        n = len(q)
        pts = np.empty((n, 3), np.float64)
        dists = np.empty(n, np.float64)
        faces = np.empty(n, np.int32)
        self._lib.mq_closest_point(
            self._handle, _dp(q), n, _dp(pts), _dp(dists), _ip(faces)
        )
        return pts, dists, faces

    def raycast(
        self, origins: np.ndarray, directions: np.ndarray, max_dist: float
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        o = np.ascontiguousarray(origins, np.float64)
        d = np.ascontiguousarray(directions, np.float64)
        n = len(o)
        t = np.empty(n, np.float64)
        faces = np.empty(n, np.int32)
        self._lib.mq_raycast(
            self._handle, _dp(o), _dp(d), n, float(max_dist), _dp(t), _ip(faces)
        )
        return t, faces, np.isfinite(t)
