"""Per-part confidence branch: plain PyTorch and the CUDA kernel.

Port of `etch_tpu/nn/pallas_grouped_head.py` (`grouped_head_ref`,
`grouped_head_pallas`):

    per_part[r, kk] = sum_c relu(h @ w0 + b0)[r, kk*c0 + c] * wg[kk, c] + bg[kk]

  - f32 h (the f32 serving path): all f32, as the JAX reference path; the
    plain version is the only one.
  - bf16 h (the bf16 serving path): the TPU kernel's rounding points, h, w0
    and wg in bf16, f32 sums, the ReLU output rounded to bf16 before the wg
    product; `grouped_head_cuda` runs it on the card
    (`csrc/grouped_head.cu`) without ever storing the (R, k*c0) intermediate.

The plain version goes through the rows in blocks so that intermediate stays
bounded (1.76 GB in one piece at B=8, N=5000, c0=128, k=86).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from etch_tpu_torch import _build
from etch_tpu_torch.nn.bf16 import BF16, mm, rnd

_ROWS = 8192
_TILE = 128    # csrc/grouped_head.cu runs groups and depths in 128-column tiles


def grouped_head_torch(h, w0, b0, wg, bg):
    """h (R, c0); w0 (c0, k*c0); b0 (k*c0,); wg (k, c0); bg (k,) -> (R, k) f32."""
    k, c0 = wg.shape
    bf16 = h.dtype == BF16
    wgr = rnd(wg, bf16)
    outs = []
    for s in range(0, h.shape[0], _ROWS):
        z = rnd(torch.relu(mm(h[s:s + _ROWS], w0, bf16) + b0), bf16).reshape(-1, k, c0)
        outs.append(torch.einsum("rkc,kc->rk", z, wgr) + bg)
    return torch.cat(outs)


def grouped_head_cuda(h, w0, b0, wg, bg):
    """The kernel: bf16 h on the card (same contract).  Any c0: the kernel
    runs groups and depths in 128-column tiles, so c0 is zero-padded to a
    multiple of 128 (exact: a padded column gives relu(0) * 0).  W0 goes to
    the kernel transposed, (k*c0, c0) bf16, formed here on every call."""
    device = _build.check_cuda("grouped_head", (h, BF16), (w0, torch.float32),
                               (b0, torch.float32), (wg, torch.float32),
                               (bg, torch.float32))
    R, c0 = h.shape
    k = wg.shape[0]
    if w0.shape != (c0, k * c0) or b0.shape != (k * c0,) or wg.shape != (k, c0) \
            or bg.shape != (k,):
        raise ValueError(f"grouped_head: bad shapes h {tuple(h.shape)}, w0 "
                         f"{tuple(w0.shape)}, wg {tuple(wg.shape)}")
    cp = -(-c0 // _TILE) * _TILE
    if cp != c0:   # zero-pad each group and the depth to the tile width
        p = cp - c0
        h = F.pad(h, (0, p))
        w0 = F.pad(w0.reshape(c0, k, c0), (0, p, 0, 0, 0, p)).reshape(cp, k * cp)
        b0 = F.pad(b0.reshape(k, c0), (0, p)).reshape(-1)
        wg = F.pad(wg, (0, p))
    hb = h.contiguous()
    w0t = w0.t().to(BF16).contiguous()
    wgb = wg.to(BF16).contiguous()
    b0 = b0.contiguous()
    out = torch.empty((R, k), dtype=torch.float32, device=device)
    _build.launch("grouped_head", "etch_grouped_head", device, _build.ptr(hb),
                  _build.ptr(w0t), _build.ptr(b0), _build.ptr(wgb), _build.ptr(bg),
                  _build.ptr(out), R, k, cp)
    return out


def grouped_head(h, w0, b0, wg, bg):
    """(R, k) f32: the kernel for bf16 h on the card, the plain version for
    f32 h or CPU tensors."""
    if h.is_cuda and h.dtype == BF16:
        return grouped_head_cuda(h, w0, b0, wg, bg)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grouped_head: unsupported device {h.device}")
    return grouped_head_torch(h, w0, b0, wg, bg)
