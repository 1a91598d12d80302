"""The bf16 numerics policy of the serving path (`EtchConfig.use_bfloat16`).

The JAX package's bf16 path streams bf16 operands with f32 accumulation and
rounds to bf16 at fixed points: where a flax module built with
`dtype=bfloat16` returns (Dense, BatchNorm), and where each TPU kernel rounds
before a matrix-unit product.  The port rounds at the same points and
nowhere else:

  - a bf16 x bf16 product with f32 accumulation (`mm`) takes one of two
    forms, chosen from what the inputs show.  On a CUDA tensor, where
    autograd records nothing, it is the card's bf16 tensor-core product with
    f32 output (`torch.mm(..., out_dtype=torch.float32)`, what XLA runs for
    the JAX package's `dot_general(preferred_element_type=f32)`): the
    operands are read as bf16, with no f32 copy, and the sum stays f32 up to
    the bias, added in place (never torch's bf16-output matmul, which rounds
    it to bf16).  cuBLAS reduces split-K partial sums in the output type
    only where that type is narrower than its f32 compute type (what
    `torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`
    allows); with an f32 output the reduction is f32 at every shape.
    Elsewhere (the CPU, and products autograd records: the bf16 training
    step) it is `wide_mm`, the f32 product of the operands rounded to bf16,
    with TF32 off (`etch_tpu_torch/__init__`).  A product of two bf16 values
    is exact in f32, so the two forms agree up to summation order.  The
    plain twins of the bf16 kernels call `wide_mm` on every device: they
    are the references the kernels are held to on the card;
  - a value flax returns as bf16 is held as a torch.bfloat16 tensor, so
    torch's type promotion (bf16 with f32 gives f32) follows JAX's.

`rnd(x, on)` rounds to bf16 and back to f32 when `on`, and is the identity
otherwise: one plain function then serves the f32 path (no rounding) and
the bf16 path (the TPU kernel's rounding points).
"""

from __future__ import annotations

import torch

from etch_tpu_torch.utils import trace

BF16 = torch.bfloat16


def rnd(x: torch.Tensor, on: bool = True) -> torch.Tensor:
    """x rounded to bf16, as f32; x itself (as f32) when not `on`."""
    return x.to(BF16).float() if on else x.float()


def mm(a: torch.Tensor, b: torch.Tensor, on: bool = True, bias=None) -> torch.Tensor:
    """a @ b (+ bias) with bf16 operands and f32 accumulation (f32 when not
    `on`); a is (..., k), b (k, n), bias (n,) f32.  On the card, outside
    autograd, one tensor-core product (counted in `bf16.tc_products`); a
    product autograd records stays widened, as `mm.dtype` has no derivative
    (torch 2.11: "derivative for aten::mm is not implemented")."""
    recorded = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (a, b, bias))
    if on and a.is_cuda and not recorded:
        trace.count("bf16.tc_products")
        out = torch.mm(a.reshape(-1, a.shape[-1]).to(BF16), b.to(BF16),
                       out_dtype=torch.float32)
        if bias is not None:
            out += bias
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return wide_mm(a, b, on, bias)


def wide_mm(a: torch.Tensor, b: torch.Tensor, on: bool = True, bias=None) -> torch.Tensor:
    """`mm` as the f32 product of the operands rounded to bf16, on every
    device."""
    out = rnd(a, on) @ rnd(b, on)
    return out if bias is None else out + bias
