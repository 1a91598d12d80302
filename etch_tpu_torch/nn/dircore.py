"""Direction-head core, plain PyTorch (f32 serving path).

Port of `etch_tpu/nn/pallas_dircore.py:direction_core_ref` and
`etch_tpu/nn/pallas_attention.py:attention_ref`.  On the f32 path the JAX
package never reaches its fused Pallas core (that kernel is bf16 only), so
this slice carries the plain version alone; the kernel comes with the bf16
slice.  Attention is written out per head (einsum + softmax), not through a
fused library operator.
"""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, num_heads: int):
    """Per-head attention, (Bc, L, E) -> (Bc, L, E); q pre-scaled by
    1/sqrt(head_size)."""
    Bc, L, E = q.shape
    hs = E // num_heads

    def split(t):
        return t.reshape(Bc, L, num_heads, hs).transpose(1, 2)

    logits = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k))
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, split(v))
    return out.transpose(1, 2).reshape(Bc, L, E)


def direction_core_ref(tokens, params, num_heads: int):
    """tokens (Bc, A, E); params: dict of the explicit head weights (wq{l},
    wk{l}, wv{l}, wc{l}, bc{l}, wm0, bm0, wm1, bm1, wr, br) in the JAX layout
    (in, out).  Stacked MHSA (residual on all but the last layer) ->
    BatchMLP -> Dense(1).  Returns (Bc, A) anchor weights."""
    h = tokens
    scale = 1.0 / math.sqrt(h.shape[-1] // num_heads)
    n_layers = len([k for k in params if k.startswith("wq")])
    for l in range(n_layers):
        q = (h @ params[f"wq{l}"]) * scale
        k = h @ params[f"wk{l}"]
        v = h @ params[f"wv{l}"]
        y = attention_ref(q, k, v, num_heads) @ params[f"wc{l}"] + params[f"bc{l}"]
        h = y if l == n_layers - 1 else h + y
    h = torch.relu(h @ params["wm0"] + params["bm0"])
    h = h @ params["wm1"] + params["bm1"]
    return (h @ params["wr"])[..., 0] + params["br"]
