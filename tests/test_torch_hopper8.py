"""The last width refusals repaired, and the Hopper designs of the grouped
confidence head and the f32 occupancy conv, on the port's CPU side.

The kernels run only on the card (tests/test_torch_kernels_cuda.py); here
each design is emulated in torch or numpy and held to the plain version, and
the plain versions at the repaired widths are held to the JAX package's
Pallas kernels (interpret mode):

  - the direction core above 512 columns and with heads above 256
    (`csrc/dircore_big.cu`): its weight image and scratch layout, and its
    batched products with their rounding points, against
    `direction_core_torch`; the plain twin at E = 640 with one head and
    E = 1024 with two against `direction_core_pallas`;
  - the anchor attention with heads above 256 columns (logits added over
    256-column slices) against `attention_torch` and `attention_pallas`;
  - the grouped head (`csrc/grouped_head.cu`): at c0 = 256 against
    `grouped_head_pallas`, and its order of sums (per-lane column partials,
    quad sums, 128-column n-tiles, 64- or 128-deep k slices) against
    `grouped_head_torch`;
  - the f32 occupancy conv's expanded-form weights in float32 against the
    direct form in float64.

Tolerances: the card's bf16 gate (max |diff| <= 1e-2 max|plain|, median
|diff| / (|plain| + 1e-2) <= 1e-3) where the same rounding points meet
another summation order; test_torch_bf16.py's `_close_kernel` against the
Pallas kernels (their bf16 rounding points differ from the CPU's); the f32
gate (1e-5 max|t|) for the occupancy conv.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.nn.pallas_attention import attention_pallas
from etch_tpu.nn.pallas_dircore import direction_core_pallas
from etch_tpu.nn.pallas_grouped_head import grouped_head_pallas
from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.nn import attention, dircore, grouped_head
from etch_tpu_torch.nn.bf16 import BF16, rnd
from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
from torch_parity import _bf16_gate, _close_kernel, _core_params

F32 = np.float32


# --- the direction core above 512 columns ------------------------------------------

@pytest.mark.parametrize("E,H", [(640, 1), (1024, 2)])
def test_dircore_widths_above_512_match_pallas(E, H):
    """The fused core's plain twin (what the card's batched route is held to)
    at E = 640 with one head of 640 and E = 1024 with two heads of 512,
    against the JAX package's Pallas core, three points."""
    params = _core_params(E, 64, E + H)
    tok = np.random.RandomState(E).randn(3, 60, E).astype(F32)
    ref = direction_core_pallas(jnp.asarray(tok),
                                {k: jnp.asarray(v.numpy()) for k, v in params.items()}, H,
                                tile=3, interpret=True)
    out = dircore.direction_core_torch(torch.from_numpy(tok).to(BF16), params, H)
    _close_kernel(out.numpy(), np.asarray(ref, F32))


def _big_layout(E, V, H):
    """The batched route's padded widths and its weight image, unpacked at
    the offsets `csrc/dircore_big.cu` reads them from."""
    hs = E // H
    hp = dircore.padded_head_size(hs)
    Ep, Eh, Ehp, Vp = dircore.big_dims(E, V, H, hp)
    params = _core_params(E, V, E + V + H)
    laid = dircore.head_layout(params, H, hs, hp)
    w, f = dircore.pack_weights_big(laid, "cpu", Ep, Ehp, Vp)
    sq, layer = Ep * Ehp, 3 * Ep * Ehp + Ehp * Ep
    mats, off = {}, 0
    for l in (0, 1):
        off = l * layer
        for i, nm in enumerate(("wq", "wk", "wv")):
            mats[f"{nm}{l}"] = w[off + i * sq:off + (i + 1) * sq].reshape(Ep, Ehp)
    mats["wc0"] = w[3 * sq:3 * sq + Ehp * Ep].reshape(Ehp, Ep)
    wc1 = layer + 3 * sq
    mats["wc1"] = w[wc1:wc1 + Ehp * Vp].reshape(Ehp, Vp)
    mats["wm0"] = w[wc1 + Ehp * Vp:wc1 + Ehp * Vp + Vp * Vp].reshape(Vp, Vp)
    assert w.numel() == wc1 + Ehp * Vp + Vp * Vp
    vec = {"bc0": f[:Ep], "bc1": f[Ep:Ep + Vp], "bm0": f[Ep + Vp:Ep + 2 * Vp],
           "u": f[Ep + 2 * Vp:Ep + 3 * Vp], "c": f[Ep + 3 * Vp]}
    return params, laid, mats, vec, (Ep, Eh, Ehp, Vp, hs, hp)


@pytest.mark.parametrize("E,V,H", [(40, 24, 5), (30, 40, 5), (24, 16, 1), (200, 136, 1)])
def test_dircore_big_weight_image_is_exact(E, V, H):
    """Every matrix and vector of the batched route's weight image is the
    head-layout weight rounded to bf16 (f32 for the vectors), zero-padded to
    multiples of 128, at the offsets the kernel reads; the scratch of a
    chunk holds x, q, k, v, o, h1 and the partial sums within the bound."""
    params, laid, mats, vec, (Ep, Eh, Ehp, Vp, hs, hp) = _big_layout(E, V, H)
    assert Ep % 128 == Ehp % 128 == Vp % 128 == 0 and Eh == H * hp <= Ehp
    shapes = {n: (Ep, Ehp) for n in ("wq0", "wk0", "wv0", "wq1", "wk1", "wv1")}
    shapes.update(wc0=(Ehp, Ep), wc1=(Ehp, Vp), wm0=(Vp, Vp))
    for n, (r, c) in shapes.items():
        want = torch.zeros(r, c)
        src = laid[n]
        want[:src.shape[0], :src.shape[1]] = rnd(src)
        assert torch.equal(mats[n].float(), want), n
    for n, m in (("bc0", Ep), ("bc1", Vp), ("bm0", Vp)):
        assert torch.equal(vec[n][:params[n].numel()], params[n])
        assert not vec[n][params[n].numel():m].any()
    wr = params["wr"][:, 0]
    torch.testing.assert_close(vec["u"][:V], rnd(params["wm1"]) @ wr, rtol=0, atol=0)
    torch.testing.assert_close(vec["c"], params["bm1"] @ wr, rtol=0, atol=0)
    chunk = dircore.big_chunk(10 ** 6, 60, Ep, Ehp, Vp)
    used = chunk * 60 * (2 * (Ep + 4 * Ehp + Vp) + 4 * (Vp // 32))
    assert used <= dircore._BIG_SCRATCH < used + 60 * (2 * (Ep + 4 * Ehp + Vp) + 4 * (Vp // 32))


def _emulate_big(tokens, mats, vec, dims, H, scale):
    """`csrc/dircore_big.cu` in torch: f32 products of the bf16 image over
    the padded widths, each product's epilogue rounding to bf16 where the
    kernel's does, the attention through attention_torch (the card's
    kernel's plain twin) with its output rounded to bf16, and the last
    product folded into partial sums of 32 columns."""
    Ep, Eh, Ehp, Vp, hs, hp = dims
    M, A, E = tokens.shape
    x = torch.zeros(M * A, Ep)
    x[:, :E] = tokens.float().reshape(M * A, E)
    m = {k: v.float() for k, v in mats.items()}
    for l in (0, 1):
        q = rnd(x @ m[f"wq{l}"] * scale)
        k = rnd(x @ m[f"wk{l}"])
        v = rnd(x @ m[f"wv{l}"])
        att = attention.attention_torch(*(t[:, :Eh].reshape(M, A, Eh).to(BF16) for t in (q, k, v)),
                                        H)
        o = torch.zeros(M * A, Ehp)
        o[:, :Eh] = rnd(att.reshape(M * A, Eh))
        if l == 0:
            x = rnd(x + (o @ m["wc0"] + vec["bc0"]))
    h1 = rnd(o @ m["wc1"] + vec["bc1"])
    z = rnd(torch.relu(h1 @ m["wm0"] + vec["bm0"])) * vec["u"]
    parts = z.reshape(M * A, Vp // 32, 32).sum(-1)
    return (parts.sum(-1) + vec["c"]).reshape(M, A)


@pytest.mark.parametrize("E,V,H", [(40, 24, 5), (30, 40, 5), (24, 16, 1), (200, 136, 1)])
def test_dircore_big_route_matches_plain(E, V, H):
    """The batched route emulated on its own weight image and padded widths
    (heads of 8, 6 padded to 8, 24 and 200 padded to 208) against the
    fused core's plain twin on bf16 tokens, by the card's bf16 gate."""
    params, laid, mats, vec, dims = _big_layout(E, V, H)
    tok = torch.from_numpy(np.random.RandomState(E + V).randn(8, 60, E).astype(F32)).to(BF16)
    out = _emulate_big(tok, mats, vec, dims, H, 1.0 / np.sqrt(E // H)) + params["br"]
    _bf16_gate(out, dircore.direction_core_torch(tok, params, H))


# --- the anchor attention with heads above 256 columns ------------------------------

@pytest.mark.parametrize("E,H", [(512, 1), (1024, 2), (384, 1)])
def test_attention_heads_above_256_match_pallas(E, H):
    """Heads of 512 and 384 columns: the logits added over 256-column
    slices of q and k, then the softmax and o slice by slice, against
    attention_torch by the bf16 gate; attention_torch against the JAX
    Pallas kernel."""
    hs = E // H
    g = np.random.RandomState(E + H)
    q, k, v = (g.randn(3, 60, E).astype(F32) * (hs ** -0.5 if i == 0 else 1.0) for i in range(3))
    qb, kb, vb = (torch.from_numpy(t).to(BF16) for t in (q, k, v))
    ref = attention.attention_torch(qb, kb, vb, H)
    split = lambda t: t.float().reshape(3, 60, H, hs)
    qs, ks, vs = split(qb), split(kb), split(vb)
    s = sum(torch.einsum("bqhd,bkhd->bhqk", qs[..., c:c + 256], ks[..., c:c + 256])
            for c in range(0, hs, 256))
    a = rnd(torch.softmax(s, dim=-1))
    o = torch.cat([torch.einsum("bhqk,bkhd->bqhd", a, vs[..., c:c + 256])
                   for c in range(0, hs, 256)], dim=-1).reshape(3, 60, E)
    _bf16_gate(o, ref)
    pal = attention_pallas(*(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                             for t in (qb, kb, vb)), H, tile=3, interpret=True)
    _close_kernel(ref.numpy(), np.asarray(pal, F32))


# --- the grouped confidence head ------------------------------------------------

def _grouped(R, c0, k, seed):
    g = np.random.RandomState(seed)
    return (g.randn(R, c0).astype(F32), (g.randn(c0, c0 * k) / np.sqrt(c0)).astype(F32),
            (0.1 * g.randn(c0 * k)).astype(F32), (g.randn(k, c0) / np.sqrt(c0)).astype(F32),
            (0.1 * g.randn(k)).astype(F32))


def test_grouped_head_c0_256_matches_pallas():
    """c0 = 256 (unet_planes_confidence[0] = 256), which the card refused
    before: the port's grouped head on the CPU against the Pallas kernel."""
    h, w0, b0, wg, bg = _grouped(70, 256, 5, 2)
    ref = grouped_head_pallas(*(jnp.asarray(a) for a in (h, w0, b0, wg, bg)), interpret=True)
    out = grouped_head.grouped_head(torch.from_numpy(h).to(BF16),
                                    *(torch.from_numpy(a) for a in (w0, b0, wg, bg)))
    _close_kernel(out.numpy(), np.asarray(ref, F32))


def _emulate_grouped(h, w0, b0, wg, bg):
    """`csrc/grouped_head.cu`'s order of sums in torch f32: c0 zero-padded to
    a multiple of 128; per group, 128-column n-tiles, each the sum of its
    k slices (64 deep where c0 > 128, else one 128-deep slice); a lane's
    partial over its 32 columns (8 j + 2 t + e of n8 tile j, t = lane % 4),
    added over the n-tiles; the quad's four partials summed as the two
    shuffles do, (p0 + p1) + (p2 + p3); then bg."""
    R, c0 = h.shape
    k = wg.shape[0]
    cp = -(-c0 // 128) * 128
    p = cp - c0
    hp = torch.nn.functional.pad(rnd(h), (0, p))
    w0p = torch.nn.functional.pad(w0.reshape(c0, k, c0), (0, p, 0, 0, 0, p)).reshape(cp, k * cp)
    b0p = torch.nn.functional.pad(b0.reshape(k, c0), (0, p)).reshape(-1)
    wgp = rnd(torch.nn.functional.pad(wg, (0, p)))
    w0t = rnd(w0p).t()                                             # (k cp, cp), K-major
    depth = 64 if cp > 128 else 128
    cols = torch.arange(128).reshape(16, 4, 2).permute(1, 0, 2).reshape(4, 32)   # lane t's columns
    out = torch.empty(R, k)
    for g in range(k):
        part = torch.zeros(R, 4)
        for nt in range(cp // 128):
            c = g * cp + nt * 128
            acc = sum(hp[:, d:d + depth] @ w0t[c:c + 128, d:d + depth].t()
                      for d in range(0, cp, depth))
            z = rnd(torch.relu(acc + b0p[c:c + 128])) * wgp[g, nt * 128:(nt + 1) * 128]
            for i in range(32):
                part = part + z[:, cols[:, i]]
        out[:, g] = (part[:, 0] + part[:, 1]) + (part[:, 2] + part[:, 3]) + bg[g]
    return out


@pytest.mark.parametrize("k", [1, 86])
@pytest.mark.parametrize("c0", [8, 128, 256, 512])
def test_grouped_head_tiling_matches_plain(c0, k):
    """The kernel's order of sums at groups narrower than its tile (8,
    zero-padded), at it (128) and wider (256, 512: n-tiles and 64-deep
    slices), one and 86 groups, a ragged 130 rows (a full 128-row tile and
    two rows of the next): within the bf16 gate of grouped_head_torch."""
    args = [torch.from_numpy(a) for a in _grouped(130, c0, k, c0 + k)]
    args[0] = args[0].to(BF16)
    _bf16_gate(_emulate_grouped(*args), grouped_head.grouped_head_torch(*args))


# --- the f32 occupancy conv's weights ---------------------------------------------

def _occupancy_f32(x, rk, sigma):
    """t = sum_n w over the offsets x (P, nn, 3) in float32, the TPU
    kernel's expanded form as the card evaluates it: per column a = 2 r s,
    c = 1 - |r|^2 s; per neighbour xx = |x|^2 s; u = fma(x, a_x, fma(y,
    a_y, fma(z, a_z, c))) (each fma rounded once, through float64).
    Returns the ReLU-per-weight sum and the rewrite sum max(u, xx) - sum xx."""
    s = F32(1) / F32(sigma)
    r = rk.astype(F32)
    a = (F32(2) * r * s).astype(F32)
    c = (F32(1) - (r * r).sum(-1, dtype=F32) * s).astype(F32)
    xx = ((x * x).sum(-1, dtype=F32) * s).astype(F32)
    per = np.zeros((x.shape[0], len(r)), F32)
    mx = np.zeros_like(per)
    sxx = np.zeros((x.shape[0], 1), F32)
    for n in range(x.shape[1]):
        u = c[None]
        for i in (2, 1, 0):
            u = (x[:, n, i:i + 1].astype(np.float64) * a[:, i] + u).astype(F32)
        per = (per + np.maximum(u - xx[:, n:n + 1], F32(0))).astype(F32)
        mx = (mx + np.maximum(u, xx[:, n:n + 1])).astype(F32)
        sxx = (sxx + xx[:, n:n + 1]).astype(F32)
    return per, mx - sxx


@pytest.mark.parametrize("reach", [0.08, 0.2, 0.4])
def test_occupancy_weights_float32_within_the_f32_gate(reach):
    """conv0's kernel points, radius and sigma, 64 neighbours a center at
    offsets up to `reach` (0.08 is conv0's ball; farther offsets make u and
    xx larger): the ReLU-per-weight expanded form in float32 is within
    1e-5 max|t| of the direct form in float64, with room to spare (a tenth
    of the gate).  The rewrite sum max(u, xx) - sum xx, whose two sums
    cancel, is measurably less accurate: the kernel keeps the ReLU per
    weight."""
    spec = backbone_plan(EtchConfig(num_point=5000, batch_size=8))[0][0]
    radius, sigma = spec["radius"], spec["sigma"]
    rk = np.einsum("aij,kj->aki", get_anchors(60),
                   get_kernel_points(radius, spec["kernel_size"])).reshape(-1, 3)
    g = np.random.RandomState(int(reach * 100))
    d = g.randn(150, 64, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    x = (d * reach * g.uniform(0, 1, (150, 64, 1)) ** (1 / 3)).astype(F32)
    exact = np.maximum(1 - ((x.astype(np.float64)[:, :, None] - rk[None, None]) ** 2).sum(-1)
                       / sigma, 0).sum(1)
    per, rewrite = _occupancy_f32(x, rk, sigma)
    scale = np.abs(exact).max()
    assert scale > 0
    err_per = np.abs(per - exact).max()
    assert err_per <= 1e-6 * scale
    assert np.abs(rewrite - exact).max() > err_per
