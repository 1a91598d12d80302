"""ETCH in PyTorch + CUDA: the scan-to-SMPL serving step on an NVIDIA H100.

A port of `etch_tpu` (JAX/Flax with Pallas TPU kernels), which stays in the
repository as the reference.  This package imports torch and numpy only;
every Pallas kernel on its path has a hand-written CUDA counterpart under
`csrc/` (built with nvcc at first use, see `_build.py`) next to a plain
PyTorch version of the same function.

f32 contract: the JAX package forces f32 matmul precision
(`etch_tpu/__init__.py:18-23`); here TF32 is switched off for matmuls and
convolutions alike.  The bf16 path computes its bf16 products on the
card's bf16 tensor cores with f32 output, and on the CPU and under autograd
as f32 products of bf16-rounded operands (`nn/bf16.py`), which relies on the
same switch.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from etch_tpu_torch.utils.config import EtchConfig  # noqa: E402,F401
