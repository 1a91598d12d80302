"""Point-Transformer vector attention: plain PyTorch and the CUDA kernel.

Port of `etch_tpu/nn/pallas_vector_attention.py` (`vector_attention_ref`,
`vector_attention_pallas`).  Unlike the JAX contract, which takes the
gathered (R, ns, c) key and value blocks, the functions here take the
(B, N, c) key and value projections and the (B, N, ns) neighbour indices and
gather themselves, so the CUDA kernel (`csrc/vector_attention.cu`) fuses the
gathers:

    w_j  = relu((xk[idx_j] - xq + pe_j) * a0[0] + a0[1])
    z_j  = relu((w_j @ w0) * a1[0] + a1[1])
    s    = softmax over j of (z_j @ w1 + b1)
    out  = sum_j (xv[idx_j] + pe_j) * s_j      (lane l weighs channels l, l+cs, ...)

  - f32 operands (the f32 serving path): all f32, as the JAX reference path;
    the plain version is the only one.
  - bf16 operands (the bf16 serving path): the TPU kernel's rounding points,
    w and z rounded to bf16, w0 and w1 rounded to bf16, every sum and the
    softmax in f32; `vector_attention_cuda` runs it on the card.
`b1` is added in both versions, as the JAX reference adds it (the TPU kernel
drops it; it is the same constant on every logit of a softmax group, so
the result is the same).
"""

from __future__ import annotations

import torch

from etch_tpu_torch import _build
from etch_tpu_torch.nn.bf16 import BF16, mm, rnd
from etch_tpu_torch.ops.grouping import group_points

_BLOCK_ELEMS = 4096   # T * ns * c per block of csrc/vector_attention.cu


def vector_attention_torch(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1):
    """xq (R, c); xk, xv (B, N, c); idx (B, N, ns) int; pe (R, ns, c); a0 (2, c)
    eval-BN scale/bias rows; w0 (c, cs); a1 (2, cs) with the Dense-0 bias
    folded in; w1 (cs, cs); b1 (cs,).  R = B * N.  Returns (R, c) f32."""
    B, N, ns = idx.shape
    R, c = xq.shape
    cs = w0.shape[1]
    bf16 = xq.dtype == BF16
    gk = group_points(xk, idx).reshape(R, ns, c).float()
    gv = group_points(xv, idx).reshape(R, ns, c).float()
    pe = pe.float()
    w = rnd(torch.relu((gk - xq.float()[:, None, :] + pe) * a0[0] + a0[1]), bf16)
    z = rnd(torch.relu(mm(w, w0, bf16) * a1[0] + a1[1]), bf16)
    s = torch.softmax(mm(z, w1, bf16) + b1, dim=1)               # over ns
    v = (gv + pe).reshape(R, ns, c // cs, cs)
    return (v * s[:, :, None, :]).sum(1).reshape(R, c)


def vector_attention_cuda(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1):
    """The kernel: bf16 xq, xk, xv, pe on the card (same contract)."""
    device = _build.check_cuda("vector_attention", (xq, BF16), (xk, BF16), (xv, BF16),
                               (idx, torch.int32), (pe, BF16), (a0, torch.float32),
                               (a1, torch.float32), (b1, torch.float32))
    B, N, ns = idx.shape
    R, c = xq.shape
    cs = w0.shape[1]
    if (xk.shape != (B, N, c) or xv.shape != (B, N, c) or pe.shape != (R, ns, c)
            or R != B * N or c % cs or w0.shape != (c, cs) or w1.shape != (cs, cs)
            or a0.shape != (2, c) or a1.shape != (2, cs) or b1.shape != (cs,)):
        raise ValueError(f"vector_attention: bad shapes xq {tuple(xq.shape)}, xk "
                         f"{tuple(xk.shape)}, idx {tuple(idx.shape)}, pe {tuple(pe.shape)}, "
                         f"w0 {tuple(w0.shape)}, w1 {tuple(w1.shape)}")
    T = max(1, _BLOCK_ELEMS // (ns * c))
    w0b = w0.to(BF16).contiguous()
    w1b = w1.to(BF16).contiguous()
    out = torch.empty((R, c), dtype=torch.float32, device=device)
    _build.launch("vector_attention", "etch_vector_attention", device, _build.ptr(xq),
                  _build.ptr(xk), _build.ptr(xv), _build.ptr(idx), _build.ptr(pe),
                  _build.ptr(a0), _build.ptr(w0b), _build.ptr(a1), _build.ptr(w1b),
                  _build.ptr(b1), _build.ptr(out), R, N, ns, c, cs, T)
    return out


def vector_attention(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1):
    """(R, c) f32: the kernel for bf16 operands on the card, the plain
    version for f32 operands or CPU tensors."""
    if xq.is_cuda and xq.dtype == BF16:
        return vector_attention_cuda(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1)
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vector_attention: unsupported device {xq.device}")
    return vector_attention_torch(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1)
