"""Direction-head core: the two routes of the JAX package, plain and on the
card.

Port of `etch_tpu/nn/pallas_dircore.py`.  Per point, on its (A, E) anchor
tokens: stacked multi-head self-attention (residual on all but the last
layer) -> BatchMLP -> Dense(1), giving (A,) anchor weights.  The JAX package
runs it by one of two routes (`models/etch_net.py:96-130`), which round in
different places; the port keeps both, each with its own rounding:

  - the fused core (`direction_core_pallas`, `_kernel`): bf16 tokens, two
    layers.  Its rounding points: the weights, q (scaled by 1/sqrt(hs)),
    k, v, the attention weights, the attention output, each layer's output
    and the MLP hidden layer are rounded to bf16; logits, softmax, sums and
    the final Dense(1) stay f32.  `direction_core_cuda` runs it on the card
    (`csrc/dircore.cu`); `direction_core_torch` is its plain twin, which
    `direction_core` takes for CPU tensors.
  - the chunked core (`direction_core_ref`), every other case: chunks of
    `chunk` points, f32 weights times bf16-valued activations with f32
    products (JAX promotes bf16 @ f32 to f32, at the f32 matmul precision
    the package forces); rounded to bf16 are only q (after the scale), k, v,
    the attention output, each layer's output and the MLP hidden layer.  The
    attention is a function argument: `nn/attention.py::attention` (the
    kernel on the card) for bf16 tokens, `attention_torch` for f32 tokens.
    With f32 tokens no value is rounded: this is the f32 serving path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from etch_tpu_torch import _build
from etch_tpu_torch.nn.attention import attention_torch
from etch_tpu_torch.nn.bf16 import BF16, mm, rnd

# csrc/dircore.cu compiles these widths in; narrower heads are zero-padded
_ROWS, _E, _V = 64, 64, 128
_HEAD_SIZES = (1, 2, 4, 8, 16)
_ROW_PAD = 8   # the kernel's shared-memory rows hold 8 more bf16 than the matrix
# packed weight matrices, in the kernel's order: name -> (rows, columns)
_W_LAYOUT = {**{n: (_E, _E) for n in ("wq0", "wk0", "wv0", "wc0", "wq1", "wk1", "wv1")},
             "wc1": (_E, _V), "wm0": (_V, _V), "wm1": (_V, _V)}
_F_LAYOUT = {"bc0": _E, "bc1": _V, "bm0": _V, "bm1": _V, "wr": _V}


def _num_layers(params) -> int:
    return len([k for k in params if k.startswith("wq")])


def direction_core_torch(tokens, params, num_heads: int):
    """The fused core's plain twin.  tokens (Bc, A, E) f32 or bf16; params:
    dict of the explicit head weights (wq{l}, wk{l}, wv{l}, wc{l}, bc{l},
    wm0, bm0, wm1, bm1, wr, br) in the JAX layout (in, out), f32.  Returns
    (Bc, A) f32 anchor weights."""
    bf16 = tokens.dtype == BF16
    h = tokens.float()
    scale = 1.0 / math.sqrt(h.shape[-1] // num_heads)
    n_layers = _num_layers(params)
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


def _chunk_core(tokens, params, num_heads: int, attn):
    """`direction_core_ref` on one chunk: (Bc, A, E) -> (Bc, A) f32."""
    bf16 = tokens.dtype == BF16
    h = tokens.float()
    scale = 1.0 / math.sqrt(h.shape[-1] // num_heads)
    n_layers = _num_layers(params)
    for l in range(n_layers):
        q = rnd((h @ params[f"wq{l}"]) * scale, bf16).to(tokens.dtype)
        k = rnd(h @ params[f"wk{l}"], bf16).to(tokens.dtype)
        v = rnd(h @ params[f"wv{l}"], bf16).to(tokens.dtype)
        att = rnd(attn(q, k, v, num_heads), bf16)
        y = att @ params[f"wc{l}"] + params[f"bc{l}"]
        h = rnd(y if l == n_layers - 1 else h + y, bf16)
    h = rnd(torch.relu(h @ params["wm0"] + params["bm0"]), bf16)
    h = h @ params["wm1"] + params["bm1"]
    return (h @ params["wr"])[..., 0] + params["br"]


def direction_core_chunked(tokens, params, num_heads: int, chunk: int, attn):
    """The chunked core: (M, A, E) tokens -> (M, A) f32 anchor weights, over
    chunks of `chunk` points, which bound the (chunk, H, A, A) logits of a
    plain attention.  `attn(q, k, v, num_heads)` -> (Bc, A, E) f32."""
    return torch.cat([_chunk_core(tokens[s:s + chunk], params, num_heads, attn)
                      for s in range(0, tokens.shape[0], chunk)])


def _pad(t, *shape):
    """Zero-pad t (2-D or 1-D) at the end of each axis to `shape`."""
    pads = []
    for n, m in zip(reversed(t.shape), reversed(shape)):
        pads += [0, m - n]
    return F.pad(t, pads)


def pack_weights(params, device):
    """The kernel's weight image: w, the bf16 matrices of `_W_LAYOUT` in
    order, each zero-padded to the compiled widths and each row to width +
    `_ROW_PAD` (the padded rows `csrc/dircore.cu` copies into shared memory
    as they are), flattened; f, the f32 vectors of `_F_LAYOUT` (wr's one
    column), zero-padded."""
    p = {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}
    w = torch.cat([_pad(p[n], r, c + _ROW_PAD).reshape(-1) for n, (r, c) in _W_LAYOUT.items()])
    f = torch.cat([_pad(p[n] if n != "wr" else p[n][:, 0], m) for n, m in _F_LAYOUT.items()])
    return w.to(BF16).contiguous(), f.contiguous()


def direction_core_cuda(tokens, params, num_heads: int):
    """The kernel: tokens (M, A, E) bf16 on the card, two layers ->
    (M, A) f32 anchor weights (br added here, as the TPU kernel's caller
    does)."""
    device = _build.check_cuda("dircore", (tokens, BF16))
    M, A, E = tokens.shape
    V = params["wm0"].shape[0]
    hs = E // num_heads
    n_layers = _num_layers(params)
    if n_layers != 2:
        raise ValueError(f"dircore: the kernel runs 2 layers, got {n_layers}")
    if A > _ROWS or E > _E or V > _V or hs not in _HEAD_SIZES or hs * num_heads != E:
        raise ValueError(f"dircore: needs A <= {_ROWS}, E <= {_E}, V <= {_V} and a "
                         f"head size in {_HEAD_SIZES}; got A={A}, E={E}, V={V}, "
                         f"{num_heads} heads")
    w, f = pack_weights(params, device)
    x = tokens if E == _E else _pad(tokens, M, A, _E).contiguous()
    out = torch.empty((M, A), dtype=torch.float32, device=device)
    _build.launch("dircore", "etch_dircore", device, _build.ptr(x), _build.ptr(w),
                  _build.ptr(f), _build.ptr(out), M, A, num_heads, hs,
                  1.0 / math.sqrt(hs))
    return out + params["br"].to(device=device, dtype=torch.float32)


def direction_core(tokens, params, num_heads: int, chunk: int):
    """The fused core: (M, A, E) bf16 tokens, two layers -> (M, A) anchor
    weights.  On the card the kernel, in one call over all points; on the
    CPU its plain twin over chunks of `chunk` points."""
    if tokens.is_cuda:
        return direction_core_cuda(tokens, params, num_heads)
    if tokens.device.type != "cpu":
        raise ValueError(f"dircore: unsupported device {tokens.device}")
    return torch.cat([direction_core_torch(tokens[s:s + chunk], params, num_heads)
                      for s in range(0, tokens.shape[0], chunk)])
