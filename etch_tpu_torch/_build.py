"""Build and bind the port's CUDA kernels.

The sources under `etch_tpu_torch/csrc/` are compiled by `nvcc` for Hopper
(`sm_90a`), one process per source, all started together, and linked into
one shared library with a plain C interface, at first use, and loaded with
`ctypes`.  The library lands in `build/etch_tpu_torch/<hash>/` at the
repository root (listed in `.gitignore`), keyed by a hash of the sources and
flags, so an unchanged checkout builds once.

Nothing here runs at import time: the CPU-only test environment imports every
module, and it has neither `nvcc` nor a card.

Every wrapper that launches a kernel goes through `launch`, which adds one to
`launches[<kernel>]` and to `shape_launches[<kernel>][<shape>]` (the entry
point and its scalar arguments: the sizes and constants it was launched
with) and raises if the entry point returns a CUDA error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "etch_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
# entry point -> argument types (pointers and the stream as c_void_p: a bare
# Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    "etch_fps": (_P, _P, _P, _I, _I, _I, _P),
    "etch_knn": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "etch_ball_query": (_P, _P, _P, _I, _I, _I, _F, _I, _P),
    "etch_interconv_t": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                         _P),
    "etch_interconv_t_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _F, _P),
    "etch_interconv_ones": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "etch_interconv_ones_proj": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _F, _P),
    "etch_dircore": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "etch_dircore_wide": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "etch_dircore_big": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "etch_vector_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                              _I, _I, _I, _P),
    "etch_vector_attention_wide": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                   _I, _I, _I, _P),
    "etch_grouped_head": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "etch_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "etch_interconv_t_c1": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "etch_interconv_t_c1_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                                 _P),
    "etch_instance_norm": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _D, _P),
    "etch_instance_norm_residual": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _D, _P),
}

# Launches per kernel since the last reset_launch_counts().
launches = {"fps": 0, "knn": 0, "ball_query": 0, "interconv_ones": 0,
            "interconv_t": 0, "interconv_ones_proj": 0, "interconv_t_bf16": 0,
            "interconv_t_c1": 0, "dircore": 0, "attention": 0, "vector_attention": 0,
            "grouped_head": 0, "instance_norm": 0}
# Launches per kernel and shape since the last reset_launch_counts(), and
# the shape of each kernel's latest launch.
shape_launches = {name: {} for name in launches}
last_shape = {}


def shape_key(entry: str, args) -> tuple:
    """A launch's shape: its entry point and scalar arguments, the sizes and
    such constants as sigma or a radius (pointers are ctypes objects)."""
    return (entry,) + tuple(a for a in args if type(a) in (int, float))


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0
        shape_launches[name].clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA "
            "kernels are built from etch_tpu_torch/csrc at first use")
    return path


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    files = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libetch_kernels.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tag = os.getpid()
        nvcc = _nvcc()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = out.parent / f"{src.stem}.{tag}.o"
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = [(src, proc.communicate()[0], proc.returncode) for src, _, proc in jobs]
        failed = [f"{src.name} ({rc}):\n{text}" for src, text, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_name(f"{out.name}.{tag}.tmp")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        (out.parent / "nvcc.log").write_text("".join(text for _, text, _ in logs))
        for _, obj, _ in jobs:
            obj.unlink()
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.etch_error_string.argtypes = (_I,)
    lib.etch_error_string.restype = ctypes.c_char_p
    return lib


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point `entry` on `device`'s current stream; count it."""
    lib = library()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{entry}: CUDA error {err}: {lib.etch_error_string(err).decode()}")
    launches[kernel] += 1
    key = shape_key(entry, args)
    shape_launches[kernel][key] = shape_launches[kernel].get(key, 0) + 1
    last_shape[kernel] = key


def check_cuda(name: str, *tensors_and_dtypes) -> torch.device:
    """Validate (tensor, dtype) pairs for a kernel: one CUDA device, the
    expected dtype, contiguous, and no autograd graph to drop (a launch
    writes a fresh tensor with no `grad_fn`: a tensor that needs a gradient
    goes through an autograd Function, as the inter-conv's do, or not to a
    kernel).  Returns the device."""
    device = tensors_and_dtypes[0][0].device
    for t, dtype in tensors_and_dtypes:
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{name}: an input needs a gradient, and the kernel has no "
                             f"backward here (run it under torch.no_grad())")
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {t.device} and {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return device


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
