"""The bf16 numerics policy of the serving path (`EtchConfig.use_bfloat16`).

The JAX package's bf16 path streams bf16 operands with f32 accumulation and
rounds to bf16 at fixed points: where a flax module built with
`dtype=bfloat16` returns (Dense, BatchNorm), and where each TPU kernel rounds
before a matrix-unit product.  The port rounds at the same points and
nowhere else:

  - a bf16 x bf16 product with f32 accumulation is the f32 product of the
    operands rounded to bf16 (`mm`), with TF32 off (`etch_tpu_torch/__init__`).
    A product of two bf16 values is exact in f32, so this equals the card's
    bf16 MMA up to summation order, and it avoids torch's bf16 matmul, which
    returns bf16 (and is slow on the CPU);
  - a value flax returns as bf16 is held as a torch.bfloat16 tensor, so
    torch's type promotion (bf16 with f32 gives f32) follows JAX's.

`rnd(x, on)` rounds to bf16 and back to f32 when `on`, and is the identity
otherwise: one plain function then serves the f32 path (no rounding) and
the bf16 path (the TPU kernel's rounding points).
"""

from __future__ import annotations

import torch

BF16 = torch.bfloat16


def rnd(x: torch.Tensor, on: bool = True) -> torch.Tensor:
    """x rounded to bf16, as f32; x itself (as f32) when not `on`."""
    return x.to(BF16).float() if on else x.float()


def mm(a: torch.Tensor, b: torch.Tensor, on: bool = True) -> torch.Tensor:
    """a @ b with bf16 operands and f32 accumulation (f32 when not `on`)."""
    return rnd(a, on) @ rnd(b, on)
