"""Point-Transformer vector attention after the gather, plain PyTorch.

Port of `etch_tpu/nn/pallas_vector_attention.py:vector_attention_ref`, which
is what the JAX package runs on the f32 path (its Pallas kernel is bf16
only; the kernel comes with the bf16 slice).  `b1` is added exactly as the
JAX reference path adds it (it cancels in the softmax over ns).
"""

from __future__ import annotations

import torch


def vector_attention_ref(xq, gk, gv, pe, a0, w0, a1, w1, b1):
    """xq (R, c); gk/gv/pe (R, ns, c); a0 (2, c) eval-BN scale/bias rows;
    w0 (c, cs); a1 (2, cs) with the Dense-0 bias folded in; w1 (cs, cs);
    b1 (1, cs).  Returns (R, c)."""
    R, ns, c = gk.shape
    cs = w0.shape[1]
    w = torch.relu((gk - xq[:, None, :] + pe) * a0[0] + a0[1])
    w = torch.relu((w @ w0) * a1[0] + a1[1])
    w = torch.softmax(w @ w1 + b1[0], dim=1)                 # over ns
    v = (gv + pe).reshape(R, ns, c // cs, cs)
    return (v * w[:, :, None, :]).sum(1).reshape(R, c)
