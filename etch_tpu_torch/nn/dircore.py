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
from torch.utils.checkpoint import checkpoint

from etch_tpu_torch import _build
from etch_tpu_torch.nn.attention import attention_torch
from etch_tpu_torch.nn.bf16 import BF16, rnd, wide_mm
from etch_tpu_torch.utils import trace

# csrc/dircore.cu compiles these widths in (weights in shared memory);
# narrower ones are zero-padded
_ROWS, _E, _V = 64, 64, 128
_HEAD_SIZES = (1, 2, 4, 8, 16)
# csrc/dircore_wide.cu (weights from device memory) takes the rest: E and V
# zero-padded to 128, 256 or 512, head sizes 1, 2, 4, 8 and multiples of 16
# up to 256
_WIDE = (128, 256, 512)
_WIDE_MAX_HS = 256
# csrc/dircore_big.cu takes every other width: products batched over a chunk
# of points (128-column tiles: E, the head layout and V zero-padded to
# multiples of 128), activations in a device-memory scratch of about this
# many bytes
_BIG_TILE = 128
_BIG_SCRATCH = 1 << 30
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
        q = rnd(wide_mm(h, params[f"wq{l}"], bf16) * scale, bf16)
        k = rnd(wide_mm(h, params[f"wk{l}"], bf16), bf16)
        v = rnd(wide_mm(h, params[f"wv{l}"], bf16), bf16)
        att = attention_torch(q.to(tokens.dtype), k.to(tokens.dtype),
                              v.to(tokens.dtype), num_heads)
        y = wide_mm(att, params[f"wc{l}"], bf16) + params[f"bc{l}"]
        h = rnd(y if l == n_layers - 1 else h + y, bf16)
    h = rnd(torch.relu(wide_mm(h, params["wm0"], bf16) + params["bm0"]), bf16)
    h = wide_mm(h, params["wm1"], bf16) + params["bm1"]
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


def direction_core_chunked(tokens, params, num_heads: int, chunk: int, attn,
                           remat: bool = False):
    """The chunked core: (M, A, E) tokens -> (M, A) f32 anchor weights, over
    chunks of `chunk` points, which bound the (chunk, H, A, A) logits of a
    plain attention.  `attn(q, k, v, num_heads)` -> (Bc, A, E) f32.  With
    `remat` (training) each chunk is recomputed in the backward pass
    (`torch.utils.checkpoint`, the JAX package's `jax.checkpoint`), so its
    logits are never kept."""
    def core(t):
        if remat:
            return checkpoint(_chunk_core, t, params, num_heads, attn,
                              use_reentrant=False, preserve_rng_state=False)
        return _chunk_core(t, params, num_heads, attn)

    return torch.cat([core(tokens[s:s + chunk]) for s in range(0, tokens.shape[0], chunk)])


def _pad(t, *shape):
    """Zero-pad t (2-D or 1-D) at the end of each axis to `shape`."""
    pads = []
    for n, m in zip(reversed(t.shape), reversed(shape)):
        pads += [0, m - n]
    return F.pad(t, pads)


def padded_head_size(hs: int) -> int:
    """The head size the kernels run a head of hs columns at: the next power
    of two up to 16, above that the next multiple of 16."""
    return 1 << (hs - 1).bit_length() if hs <= 16 else -(-hs // 16) * 16


def head_layout(params, num_heads: int, hs: int, hp: int):
    """The weights with q, k and v in the kernels' head layout: head h's
    columns of wq, wk and wv, and its rows of wc, at h*hp .. h*hp + hs - 1,
    zero up to h*hp + hp - 1.  Exact: a padded column of q and k adds 0 to
    every logit, and a padded column of v gives a zero column of the
    attention output, which meets a zero row of wc.  The caller keeps the
    scale 1/sqrt(hs)."""
    if hp == hs:
        return params
    cols = (torch.arange(num_heads)[:, None] * hp + torch.arange(hs)).reshape(-1)
    out = dict(params)
    for l in range(_num_layers(params)):
        for nm in ("wq", "wk", "wv"):
            w = params[f"{nm}{l}"]
            out[f"{nm}{l}"] = w.new_zeros(w.shape[0], num_heads * hp).index_copy(
                1, cols.to(w.device), w)
        w = params[f"wc{l}"]
        out[f"wc{l}"] = w.new_zeros(num_heads * hp, w.shape[1]).index_copy(
            0, cols.to(w.device), w)
    return out


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


def pack_fragments(w, rows: int, cols: int):
    """A weight matrix (in, out) as the bf16 B fragments of mma.sync
    m16n8k16, zero-padded to (rows, cols): for k16 step kt, 16-column tile n
    and lane 4g + t, four 32-bit registers, register 2 nh + kh holding
    w[16 kt + 8 kh + 2t + e, 16 n + 8 nh + g] for e = 0, 1 (the fragments
    `csrc/dircore_wide.cu` loads 16 bytes a lane)."""
    p = _pad(w.float(), rows, cols).to(BF16)
    p = p.reshape(rows // 16, 2, 4, 2, cols // 16, 2, 8)   # kt kh t e | n nh g
    return p.permute(0, 4, 6, 2, 5, 1, 3).reshape(-1)


def pack_weights_wide(params, device, Ep: int, Vp: int):
    """The wide kernel's weights: w, the matrices wq0, wk0, wv0, wc0, wq1,
    wk1, wv1 (Ep x Ep), wc1 (Ep x Vp) and wm0 (Vp x Vp) in fragment order
    (`pack_fragments`); f, the f32 vectors bc0 (Ep), bc1, bm0 (Vp), then
    u = bf16(wm1) wr (Vp) and bm1 . wr (padded to 4): the kernel forms
    out = h2 u + bm1 . wr, which is (h2 wm1 + bm1) wr summed in another
    order."""
    p = {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}
    sq = [pack_fragments(p[n], Ep, Ep) for n in ("wq0", "wk0", "wv0", "wc0", "wq1", "wk1", "wv1")]
    w = torch.cat(sq + [pack_fragments(p["wc1"], Ep, Vp), pack_fragments(p["wm0"], Vp, Vp)])
    wr = p["wr"][:, 0]
    u = rnd(p["wm1"]) @ wr
    f = torch.cat([_pad(p["bc0"], Ep), _pad(p["bc1"], Vp), _pad(p["bm0"], Vp), _pad(u, Vp),
                   _pad((p["bm1"] @ wr)[None], 4)])
    return w.contiguous(), f.contiguous()


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_weights_big(params, device, Ep: int, Ehp: int, Vp: int):
    """The weights of `csrc/dircore_big.cu`: w, the bf16 matrices wq0, wk0,
    wv0 (Ep x Ehp), wc0 (Ehp x Ep), wq1, wk1, wv1, wc1 (Ehp x Vp) and wm0
    (Vp x Vp), row-major and zero-padded, flattened (params already in the
    head layout); f, the f32 vectors bc0 (Ep), bc1, bm0, u = bf16(wm1) wr
    (Vp) and bm1 . wr (padded to 4), as for `pack_weights_wide`."""
    p = {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}
    mats = []
    for l in (0, 1):
        mats += [_pad(p[f"{n}{l}"], Ep, Ehp) for n in ("wq", "wk", "wv")]
        mats.append(_pad(p["wc0"], Ehp, Ep) if l == 0 else _pad(p["wc1"], Ehp, Vp))
    mats.append(_pad(p["wm0"], Vp, Vp))
    w = torch.cat([m.reshape(-1) for m in mats]).to(BF16)
    wr = p["wr"][:, 0]
    u = rnd(p["wm1"]) @ wr
    f = torch.cat([_pad(p["bc0"], Ep), _pad(p["bc1"], Vp), _pad(p["bm0"], Vp), _pad(u, Vp),
                   _pad((p["bm1"] @ wr)[None], 4)])
    return w.contiguous(), f.contiguous()


def big_dims(E: int, V: int, num_heads: int, hp: int):
    """(Ep, Eh, Ehp, Vp) of `csrc/dircore_big.cu`: tokens padded to Ep, the
    head layout Eh = num_heads * hp padded to Ehp, V padded to Vp."""
    Eh = num_heads * hp
    return _round_up(E, _BIG_TILE), Eh, _round_up(Eh, _BIG_TILE), _round_up(V, _BIG_TILE)


def big_chunk(M: int, A: int, Ep: int, Ehp: int, Vp: int) -> int:
    """Points a chunk of `csrc/dircore_big.cu`: what `_BIG_SCRATCH` bytes of
    scratch hold (bf16 x, q, k, v, o and h1, f32 partial sums), at least one."""
    row = 2 * (Ep + 4 * Ehp + Vp) + 4 * (Vp // 32)
    return max(1, min(M, _BIG_SCRATCH // (A * row)))


def _direction_core_big(tokens, params, num_heads: int, hp: int, scale: float, device):
    """`csrc/dircore_big.cu` on tokens (M, A, E); params in the head layout."""
    M, A, E = tokens.shape
    V = params["wm0"].shape[0]
    Ep, Eh, Ehp, Vp = big_dims(E, V, num_heads, hp)
    w, f = pack_weights_big(params, device, Ep, Ehp, Vp)
    chunk = big_chunk(M, A, Ep, Ehp, Vp)
    # zeros: the attention writes o only up to Eh, and wc's zero rows beyond
    # must meet zeros (not whatever the memory held)
    scratch = torch.zeros(chunk * A * (Ep + 4 * Ehp + Vp), dtype=BF16, device=device)
    part = torch.empty((Vp // 32) * chunk * A, dtype=torch.float32, device=device)
    out = torch.empty((M, A), dtype=torch.float32, device=device)
    _build.launch("dircore", "etch_dircore_big", device, _build.ptr(tokens), _build.ptr(w),
                  _build.ptr(f), _build.ptr(out), _build.ptr(scratch), _build.ptr(part), M, A,
                  E, Ep, Eh, Ehp, Vp, num_heads, scale, chunk)
    return out


def direction_core_cuda(tokens, params, num_heads: int):
    """The kernel: tokens (M, A, E) bf16 on the card, two layers ->
    (M, A) f32 anchor weights (br added here, as the TPU kernel's caller
    does).  Any width and any head count that divides E: each head runs at
    `padded_head_size` in the head layout of `head_layout`, whose width is
    num_heads times that.  Where E and that width are at most 64, V at most
    128 and the padded head at most 16, `csrc/dircore.cu` runs it (weights
    in shared memory); for E, the head layout and V up to 512 and heads up
    to 256 columns `csrc/dircore_wide.cu`; above that `csrc/dircore_big.cu`
    (products batched over chunks of points, activations in a scratch)."""
    device = _build.check_cuda("dircore", (tokens, BF16))
    M, A, E = tokens.shape
    V = params["wm0"].shape[0]
    hs = E // num_heads
    n_layers = _num_layers(params)
    if n_layers != 2:
        raise ValueError(f"dircore: the kernel runs 2 layers, got {n_layers}")
    if num_heads < 1 or hs * num_heads != E or A > _ROWS:
        raise ValueError(f"dircore: needs A <= {_ROWS} and a head count that divides E; "
                         f"got A={A}, E={E}, {num_heads} heads")
    hp = padded_head_size(hs)
    Eh = num_heads * hp
    scale = 1.0 / math.sqrt(hs)
    params = head_layout(params, num_heads, hs, hp)
    if max(E, Eh) > _E or V > _V or hp not in _HEAD_SIZES:
        Vp = next((w for w in _WIDE if V <= w), 0)
        # the kernel's hidden layer runs at most max(Ep, 256) wide: E is
        # zero-padded to 512 for V above 256
        Ep = next((w for w in _WIDE if max(E, Eh) <= w and Vp <= max(w, 256)), None)
        if Ep is None or not Vp or hp > _WIDE_MAX_HS:
            return _direction_core_big(tokens, params, num_heads, hp, scale, device) + \
                params["br"].to(device=device, dtype=torch.float32)
        w, f = pack_weights_wide(params, device, Ep, Vp)
        x = tokens if E == Ep else _pad(tokens, M, A, Ep).contiguous()
        out = torch.empty((M, A), dtype=torch.float32, device=device)
        _build.launch("dircore", "etch_dircore_wide", device, _build.ptr(x), _build.ptr(w),
                      _build.ptr(f), _build.ptr(out), M, A, Ep, Vp, num_heads, hp, scale)
        trace.count("dircore.wide_points", M)
        return out + params["br"].to(device=device, dtype=torch.float32)
    w, f = pack_weights(params, device)
    x = tokens if E == _E else _pad(tokens, M, A, _E).contiguous()
    out = torch.empty((M, A), dtype=torch.float32, device=device)
    _build.launch("dircore", "etch_dircore", device, _build.ptr(x), _build.ptr(w),
                  _build.ptr(f), _build.ptr(out), M, A, num_heads, hp, scale)
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
