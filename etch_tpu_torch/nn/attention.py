"""Per-point multi-head attention over the anchor tokens: plain PyTorch and
the CUDA kernel.

Port of `etch_tpu/nn/pallas_attention.py` (`attention_pallas`, `_kernel`).
For each point (row of the batch), its L tokens attend to each other, head by
head; q is pre-scaled by 1/sqrt(head_size):

    z[q, h, k] = sum_d q[q, h*hs + d] k[k, h*hs + d]            (f32)
    m[q, h]    = max_k z[q, h, k]                    (per query AND head)
    a[q, h, k] = exp(z - m) * (1 / sum_k exp(z - m))
    out[q, h*hs + d] = sum_k a[q, h, k] v[k, h*hs + d]          (f32)

  - bf16 q, k, v (the chunked bf16 direction head): the TPU kernel's rounding
    points, the attention weights a rounded to bf16, logits, softmax and
    sums in f32, an f32 output.  `attention_cuda` runs this on the card
    (`csrc/attention.cu`).
  - f32 q, k, v (the f32 direction head): all f32, no rounding; the plain
    version is the only one, as in the JAX package.

The max is taken per (query, head), never over all heads of a row: with
trained weights one head's logits can lie hundreds of nats below another's,
and a shared max underflows their exponentials to 0 / 0
(`etch_tpu/nn/pallas_attention.py:108-127`).
"""

from __future__ import annotations

import torch

from etch_tpu_torch import _build
from etch_tpu_torch.nn.bf16 import BF16, rnd

_MAX_L = 64     # tokens a point: one 64-row tile of queries and keys


def attention_torch(q, k, v, num_heads: int):
    """(Bc, L, E) q (pre-scaled), k, v -> (Bc, L, E) f32."""
    Bc, L, E = q.shape
    hs = E // num_heads
    bf16 = q.dtype == BF16

    def split(t):
        return t.float().reshape(Bc, L, num_heads, hs).transpose(1, 2)

    z = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k))
    # one fused pass over the (Bc, H, L, L) logits; its max is per row, that
    # is per (query, head)
    a = rnd(torch.softmax(z, dim=-1), bf16)
    out = torch.einsum("bhqk,bhkd->bhqd", a, split(v))
    return out.transpose(1, 2).reshape(Bc, L, E)


def attention_cuda(q, k, v, num_heads: int):
    """The kernel: bf16 q, k, v (Bc, L, E) on the card -> (Bc, L, E) f32.

    One 64-row tile of queries and keys a point (4 warps, 16 query rows
    each; keys L..63 masked), so L <= 64 (the direction head's 60 anchors);
    a longer L raises.  Any head count that divides E: the heads run in
    groups of at most 128 columns, or one head a group above that, and a
    head above 256 columns in 256-column slices."""
    device = _build.check_cuda("attention", (q, BF16), (k, BF16), (v, BF16))
    Bc, L, E = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must have one shape")
    if num_heads < 1 or E % num_heads:
        raise ValueError(f"attention: needs a head count that divides E; got E={E}, "
                         f"{num_heads} heads")
    if not 1 <= L <= _MAX_L:
        raise ValueError(f"attention: needs 1 <= L <= {_MAX_L} tokens, got {L}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention: q, k and v must start on a 16-byte boundary")
    out = torch.empty((Bc, L, E), dtype=torch.float32, device=device)
    if Bc:
        _build.launch("attention", "etch_attention", device, _build.ptr(q), _build.ptr(k),
                      _build.ptr(v), _build.ptr(out), Bc, L, E, num_heads)
    return out


def attention(q, k, v, num_heads: int):
    """(Bc, L, E) f32: the kernel for bf16 operands on the card, the plain
    version on the CPU."""
    if q.is_cuda:
        return attention_cuda(q, k, v, num_heads)
    if q.device.type != "cpu":
        raise ValueError(f"attention: unsupported device {q.device}")
    return attention_torch(q, k, v, num_heads)
