"""Direction-head core: plain PyTorch and the CUDA kernel.

Port of `etch_tpu/nn/pallas_dircore.py` (`direction_core_ref`,
`direction_core_pallas`) and `etch_tpu/nn/pallas_attention.py:attention_ref`.
Per point, on its (A, E) anchor tokens: stacked multi-head self-attention
(residual on all but the last layer) -> BatchMLP -> Dense(1), giving (A,)
anchor weights.

  - f32 tokens (the f32 serving path): full f32, as the JAX package's f32
    path runs it; the plain version is the only one (the JAX package has no
    f32 kernel either).
  - bf16 tokens (the bf16 serving path): the rounding points of the TPU
    kernel (`_kernel`): weights, q (scaled by 1/sqrt(hs)), k, v, the
    attention weights, the attention output, each layer's output and the
    MLP hidden layer are rounded to bf16; logits, softmax, sums and the
    final Dense(1) stay f32.  `direction_core_cuda` runs this on the card
    (`csrc/dircore.cu`), for two layers.

Attention is written out per head (einsum + softmax), not through a fused
library operator; its softmax max is per head, as the kernel's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from etch_tpu_torch import _build
from etch_tpu_torch.nn.bf16 import BF16, mm, rnd

# csrc/dircore.cu compiles these widths in; narrower heads are zero-padded
_ROWS, _E, _V = 64, 64, 128
_HEAD_SIZES = (1, 2, 4, 8, 16)


def attention_torch(q, k, v, num_heads: int):
    """Per-head attention, (Bc, L, E) -> (Bc, L, E) f32; q pre-scaled by
    1/sqrt(head_size).  bf16 inputs: f32 logits and softmax, attention
    weights rounded to bf16."""
    Bc, L, E = q.shape
    hs = E // num_heads
    bf16 = q.dtype == BF16

    def split(t):
        return t.float().reshape(Bc, L, num_heads, hs).transpose(1, 2)

    logits = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k))
    attn = rnd(torch.softmax(logits, dim=-1), bf16)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, split(v))
    return out.transpose(1, 2).reshape(Bc, L, E)


def direction_core_torch(tokens, params, num_heads: int):
    """tokens (Bc, A, E) f32 or bf16; params: dict of the explicit head
    weights (wq{l}, wk{l}, wv{l}, wc{l}, bc{l}, wm0, bm0, wm1, bm1, wr, br) in
    the JAX layout (in, out), f32.  Returns (Bc, A) f32 anchor weights."""
    bf16 = tokens.dtype == BF16
    h = tokens.float()
    scale = 1.0 / math.sqrt(h.shape[-1] // num_heads)
    n_layers = len([k for k in params if k.startswith("wq")])
    for l in range(n_layers):
        q = rnd(mm(h, params[f"wq{l}"], bf16) * scale, bf16)
        k = rnd(mm(h, params[f"wk{l}"], bf16), bf16)
        v = rnd(mm(h, params[f"wv{l}"], bf16), bf16)
        att = attention_torch(q.to(tokens.dtype), k.to(tokens.dtype),
                              v.to(tokens.dtype), num_heads)
        y = mm(att, params[f"wc{l}"], bf16) + params[f"bc{l}"]
        h = rnd(y if l == n_layers - 1 else h + y, bf16)
    h = rnd(torch.relu(mm(h, params["wm0"], bf16) + params["bm0"]), bf16)
    h = mm(h, params["wm1"], bf16) + params["bm1"]
    return (h @ params["wr"])[..., 0] + params["br"]


def _pad(t, *shape):
    """Zero-pad t (2-D or 1-D) at the end of each axis to `shape`."""
    pads = []
    for n, m in zip(reversed(t.shape), reversed(shape)):
        pads += [0, m - n]
    return F.pad(t, pads)


def direction_core_cuda(tokens, params, num_heads: int):
    """The kernel: tokens (M, A, E) bf16 on the card, two layers ->
    (M, A) f32 anchor weights (br added here, as the TPU kernel's caller
    does)."""
    device = _build.check_cuda("dircore", (tokens, BF16))
    M, A, E = tokens.shape
    V = params["wm0"].shape[0]
    hs = E // num_heads
    n_layers = len([k for k in params if k.startswith("wq")])
    if n_layers != 2:
        raise ValueError(f"dircore: the kernel runs 2 layers, got {n_layers}")
    if A > _ROWS or E > _E or V > _V or hs not in _HEAD_SIZES or hs * num_heads != E:
        raise ValueError(f"dircore: needs A <= {_ROWS}, E <= {_E}, V <= {_V} and a "
                         f"head size in {_HEAD_SIZES}; got A={A}, E={E}, V={V}, "
                         f"{num_heads} heads")
    p = {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}
    sq = [_pad(p[n], _E, _E) for n in ("wq0", "wk0", "wv0", "wc0", "wq1", "wk1", "wv1")]
    w = torch.cat([t.reshape(-1) for t in sq + [
        _pad(p["wc1"], _E, _V), _pad(p["wm0"], _V, _V), _pad(p["wm1"], _V, _V)]])
    f = torch.cat([_pad(p["bc0"], _E), _pad(p["bc1"], _V), _pad(p["bm0"], _V),
                   _pad(p["bm1"], _V), _pad(p["wr"][:, 0], _V)])
    w = w.to(BF16).contiguous()
    x = tokens if E == _E else _pad(tokens, M, A, _E).contiguous()
    out = torch.empty((M, A), dtype=torch.float32, device=device)
    _build.launch("dircore", "etch_dircore", device, _build.ptr(x), _build.ptr(w),
                  _build.ptr(f), _build.ptr(out), M, A, num_heads, hs,
                  1.0 / math.sqrt(hs))
    return out + p["br"]


def direction_core(tokens, params, num_heads: int, chunk: int):
    """(M, A, E) tokens -> (M, A) anchor weights.  The kernel for bf16
    tokens on the card with two layers, in one call over all points, as the
    JAX package dispatches (`models/etch_net.py:96-102`); otherwise the plain
    version over chunks of `chunk` points, which bound its (chunk, H, A, A)
    logits."""
    n_layers = len([k for k in params if k.startswith("wq")])
    if tokens.is_cuda and tokens.dtype == BF16 and n_layers == 2:
        return direction_core_cuda(tokens, params, num_heads)
    if tokens.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dircore: unsupported device {tokens.device}")
    return torch.cat([direction_core_torch(tokens[s:s + chunk], params, num_heads)
                      for s in range(0, tokens.shape[0], chunk)])
