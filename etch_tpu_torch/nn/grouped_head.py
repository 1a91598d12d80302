"""Per-part confidence branch, plain PyTorch.

Port of `etch_tpu/nn/pallas_grouped_head.py:grouped_head_ref`, which is what
the JAX package runs on the f32 path (its Pallas kernel is bf16 only; the
kernel comes with the bf16 slice):

    per_part[r, kk] = sum_c relu(h @ w0 + b0)[r, kk*c0 + c] * wg[kk, c] + bg[kk]

Rows go through in blocks so the (rows, k*c0) intermediate stays bounded
(1.76 GB in one piece at B=8, N=5000, c0=128, k=86).
"""

from __future__ import annotations

import torch

_ROWS = 8192


def grouped_head_ref(h, w0, b0, wg, bg):
    """h (R, c0); w0 (c0, k*c0); b0 (k*c0,); wg (k, c0); bg (k,) -> (R, k)."""
    k, c0 = wg.shape
    outs = []
    for s in range(0, h.shape[0], _ROWS):
        z = torch.relu(h[s:s + _ROWS] @ w0 + b0).reshape(-1, k, c0)
        outs.append(torch.einsum("rkc,kc->rk", z, wg) + bg)
    return torch.cat(outs)
