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

The kernel takes any c the reference takes: c not a multiple of 8 runs on
rows padded with zero channels, and cs above 64 (c above 512) runs the wide
kernel, whose W0 and W1 the wrapper packs into fragment order
(`pack_fragments`).
"""

from __future__ import annotations

import torch

from etch_tpu_torch import _build
from etch_tpu_torch.nn.bf16 import BF16, mm, rnd
from etch_tpu_torch.ops.grouping import group_points


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


_SMEM_BYTES = 227 * 1024


def va_rows(ns: int) -> int:
    """Rows a warp's unit holds: ns rounded up to a power of two up to 16,
    or to a multiple of 16, and at least one m16 tile."""
    rp = 1
    while rp < ns and rp < 16:
        rp *= 2
    if ns > 16:
        rp = -(-ns // 16) * 16
    return max(rp, 16)


def wide_warp_bytes(ns: int, cs: int) -> int:
    """Shared memory a warp of the wide kernel (cs above 64,
    `csrc/vector_attention.cu:vector_attention_wide_kernel`) takes: the
    unit's indices, a (16, cs) bf16 z tile and a (rows, cs) f32 s tile.  A
    block holds as many warps, up to 4, as fit."""
    rows, nta = va_rows(ns), -(-cs // 8)
    ldz, lds = 16 * (-(-nta // 2)) + 8, -(-8 * nta // 32) * 32 + 8
    return rows * 4 + 16 * ldz * 2 + rows * lds * 4


def va_geometry(ns: int, c: int, cs: int):
    """How the kernel runs (R, ns, c) rows with cs attention lanes: the
    padded width c8 (c rounded up to 8: zero channels) and whether the wide
    kernel takes it (cs above 64 or c8 above 512).  Raises where one warp's
    tiles of the wide kernel do not fit shared memory (cs above 2,400 at 16
    neighbours, 1,024 at 48)."""
    if cs < 1 or c % cs:
        raise ValueError(f"vector_attention: c={c} is not a multiple of cs={cs}")
    c8 = -(-c // 8) * 8
    wide = cs > 64 or c8 > 512
    if wide and wide_warp_bytes(ns, cs) > _SMEM_BYTES:
        raise ValueError(f"vector_attention: ns={ns}, cs={cs} do not fit shared memory")
    return c8, wide


def pack_fragments(w0, w1):
    """W0 (c, cs) and W1 (cs, cs) as the wide kernel reads them: bf16 B
    fragments of mma m16n8k16, zero-padded, in the order the first kernel's
    prologue puts them in shared memory (W0's k rows permuted as the w
    fragments' channels are).  Returns two flat bf16 tensors."""
    c, cs = w0.shape
    nta, cpad = -(-cs // 8), -(-c // 32) * 32
    k1 = -(-nta // 2)
    dev = w0.device
    r, col = torch.arange(c, device=dev)[:, None], torch.arange(cs, device=dev)[None, :]
    pos = ((((2 * (r >> 5) + ((r >> 2) & 1)) * nta + (col >> 3)) * 32 + 4 * (col & 7)
            + ((r >> 3) & 3)) << 2) + (r & 3)
    f0 = torch.zeros(cpad // 16 * nta * 128, dtype=BF16, device=dev)
    f0[pos.flatten()] = w0.to(BF16).flatten()
    r = torch.arange(cs, device=dev)[:, None]
    pos = ((((r >> 4) * nta + (col >> 3)) * 32 + 4 * (col & 7) + ((r >> 1) & 3)) << 2) + \
        2 * ((r >> 3) & 1) + (r & 1)
    f1 = torch.zeros(k1 * nta * 128, dtype=BF16, device=dev)
    f1[pos.flatten()] = w1.to(BF16).flatten()
    return f0, f1


def pad_rows(x, c8: int):
    """The last axis zero-padded to c8 (a copy); x itself where it is c8."""
    c = x.shape[-1]
    return x if c == c8 else torch.nn.functional.pad(x, (0, c8 - c)).contiguous()


def vector_attention_cuda(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1):
    """The kernel: bf16 xq, xk, xv, pe on the card (same contract).  Any c
    the reference takes: c off the multiples of 8 on rows padded with zero
    channels (a copy of xq, xk, xv and pe, at widths no timed request runs;
    the padded channels' a0 and W0 rows are 0, so their w is 0), cs above
    64 on the wide kernel."""
    device = _build.check_cuda("vector_attention", (xq, BF16), (xk, BF16), (xv, BF16),
                               (idx, torch.int32), (pe, BF16), (a0, torch.float32),
                               (a1, torch.float32), (b1, torch.float32))
    B, N, ns = idx.shape
    R, c = xq.shape
    cs = w0.shape[1]
    if (xk.shape != (B, N, c) or xv.shape != (B, N, c) or pe.shape != (R, ns, c)
            or R != B * N or w0.shape != (c, cs) or w1.shape != (cs, cs)
            or a0.shape != (2, c) or a1.shape != (2, cs) or b1.shape != (cs,)):
        raise ValueError(f"vector_attention: bad shapes xq {tuple(xq.shape)}, xk "
                         f"{tuple(xk.shape)}, idx {tuple(idx.shape)}, pe {tuple(pe.shape)}, "
                         f"w0 {tuple(w0.shape)}, w1 {tuple(w1.shape)}")
    c8, wide = va_geometry(ns, c, cs)
    xq, xk, xv, pe, a0 = (pad_rows(t, c8) for t in (xq, xk, xv, pe, a0))
    w0 = pad_rows(w0.float().t(), c8).t().contiguous()
    if wide:
        w0, w1 = pack_fragments(w0, w1.float())
    else:
        w1 = w1.float().contiguous()
    if any(t.data_ptr() % 16 for t in (xq, xk, xv, pe, a0, w0, w1)):
        raise ValueError("vector_attention: xq, xk, xv, pe, a0, w0 and w1 must start on a "
                         "16-byte boundary")
    out = torch.empty((R, c8), dtype=torch.float32, device=device)
    _build.launch("vector_attention", "etch_vector_attention_wide" if wide else
                  "etch_vector_attention", device, _build.ptr(xq),
                  _build.ptr(xk), _build.ptr(xv), _build.ptr(idx), _build.ptr(pe),
                  _build.ptr(a0), _build.ptr(w0), _build.ptr(a1), _build.ptr(w1),
                  _build.ptr(b1), _build.ptr(out), R, N, ns, c8, cs)
    return out if c8 == c else out[:, :c].contiguous()


def vector_attention(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1):
    """(R, c) f32: the kernel for bf16 operands on the card, the plain
    version for f32 operands or CPU tensors."""
    if xq.is_cuda and xq.dtype == BF16:
        return vector_attention_cuda(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1)
    if xq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vector_attention: unsupported device {xq.device}")
    return vector_attention_torch(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1)
