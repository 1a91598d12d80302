"""What the port's Python side hands its redesigned kernels, on the CPU.

The tensor-core contraction (`csrc/interconv.cu`, bf16 rows) pads the kernel
points to 32 rows and the neighbours to a multiple of 16; on f32 rows it
splits both operands into tf32 halves and sums three tf32 products
(3xTF32).  The direction core (`csrc/dircore.cu`) copies a packed,
row-padded weight image into shared memory and runs head sizes below 8 as
masked 8-column tiles; the anchor attention (`csrc/attention.cu`) pads each
head with zero columns and the keys to 64 rows at -inf.  These tests hold
each of those choices to the plain versions' arithmetic (emulated in numpy),
and hold the pipeline's entry point to the card by default.  No card is
needed.
"""

import inspect

import numpy as np
import pytest
import torch

from etch_tpu_torch import _build
from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.nn import attention, dircore, interconv
from etch_tpu_torch.nn.bf16 import rnd
from etch_tpu_torch.ops.ball_query import ball_query_torch
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.utils.config import EtchConfig, backbone_plan


def test_build_pipeline_defaults_to_the_card():
    assert inspect.signature(build_pipeline).parameters["device"].default == "cuda"


def test_build_pipeline_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_pipeline(EtchConfig.tiny(num_point=64, batch_size=1), {"M0": 0},
                       allow_synthetic_body=True)


@pytest.mark.parametrize("E,V", [(64, 128), (8, 16)])
def test_dircore_packed_weights_unpack_to_the_params(E, V):
    """The packed image is the kernel's layout (75,776 bf16 values: seven
    64 x 72 matrices, then 64 x 136 and two 128 x 136) and holds every
    matrix, bf16-rounded, at its offset, with zeros in the padding."""
    g = np.random.RandomState(0)
    shapes = {**{n: (E, E) for n in ("wq0", "wk0", "wv0", "wc0", "wq1", "wk1", "wv1")},
              "wc1": (E, V), "wm0": (V, V), "wm1": (V, V), "bc0": (E,), "bc1": (V,),
              "bm0": (V,), "bm1": (V,), "wr": (V, 1), "br": (1,)}
    params = {n: torch.tensor(g.randn(*s), dtype=torch.float32) for n, s in shapes.items()}
    w, f = dircore.pack_weights(params, "cpu")
    assert w.dtype == torch.bfloat16 and w.numel() == 7 * 64 * 72 + 64 * 136 + 2 * 128 * 136
    assert f.dtype == torch.float32 and f.numel() == 576
    layout = [(n, 64, 64) for n in ("wq0", "wk0", "wv0", "wc0", "wq1", "wk1", "wv1")] + \
        [("wc1", 64, 128), ("wm0", 128, 128), ("wm1", 128, 128)]
    i = 0
    for n, rows, cols in layout:
        m = w[i:i + rows * (cols + 8)].reshape(rows, cols + 8).float()
        i += m.numel()
        r, c = shapes[n]
        torch.testing.assert_close(m[:r, :c], rnd(params[n]), rtol=0, atol=0)
        assert m[r:].abs().sum() == 0 and m[:, c:].abs().sum() == 0
    i = 0
    for n, width in (("bc0", 64), ("bc1", 128), ("bm0", 128), ("bm1", 128), ("wr", 128)):
        v = params[n].reshape(-1)
        torch.testing.assert_close(f[i:i + v.numel()], v, rtol=0, atol=0)
        assert f[i + v.numel():i + width].abs().sum() == 0
        i += width


@pytest.mark.parametrize("hs", [1, 2, 4])
def test_dircore_masked_head_tiles_are_exact(hs):
    """Head sizes below 8: q masked to one head's columns of an 8-column
    tile, times the whole tile of k, gives that head's logits exactly (the
    other columns add exact zeros), as the kernel's m16n8k8 products do."""
    g = np.random.RandomState(hs)
    q = rnd(torch.tensor(g.randn(16, 8), dtype=torch.float32))
    k = rnd(torch.tensor(g.randn(64, 8), dtype=torch.float32))
    for h in range(8 // hs):
        mask = torch.zeros(8)
        mask[h * hs:(h + 1) * hs] = 1
        cols = slice(h * hs, (h + 1) * hs)
        ref = q[:, cols].double() @ k[:, cols].double().T
        torch.testing.assert_close((q * mask).double() @ k.double().T, ref, rtol=0, atol=0)


def test_interconv_mma_geometry():
    """Shared memory of the tensor-core body at the main path's shapes (64
    neighbours, K=24): 42,240 bytes at C=32 (5 blocks an SM), 75,008 at C=64
    (3 blocks); unsupported widths raise."""
    assert interconv.mma_smem_bytes(64, 24, 32) == 42240
    assert interconv.mma_smem_bytes(64, 24, 64) == 75008
    for C in (8, 16, 32, 64):
        interconv.check_mma_geometry(64, 24, C)
    for nn, K, C in ((64, 24, 4), (64, 24, 12), (64, 24, 72), (64, 33, 32), (400, 24, 64)):
        with pytest.raises(ValueError):
            interconv.check_mma_geometry(nn, K, C)


@pytest.mark.parametrize("nn,C", [(11, 8), (64, 32)])
def test_interconv_mma_padding_is_exact(nn, C):
    """The tensor-core body's per-anchor GEMM on padded operands: K padded
    to 32 rows (any finite values, their rows are dropped), neighbours
    padded to a multiple of 16 with w = 0 and feature rows that hold any
    finite values (zeros at first, a staged output later).  It equals the
    plain contraction up to f32 summation order."""
    rng = np.random.RandomState(nn)
    B, P, c, A = 2, 200, 5, 60
    xyz = torch.tensor(rng.uniform(-0.5, 0.5, (B, P, 3)), dtype=torch.float32)
    ctr = xyz[:, :c].contiguous()
    nbr = ball_query_torch(ctr, xyz, 0.4, nn)
    kp = get_kernel_points(0.4, 1)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3).copy())
    sigma = 0.5 * 0.4 ** 2
    feats = torch.tensor(rng.randn(B, P, A * C), dtype=torch.float32).to(torch.bfloat16)
    K = rk.shape[0] // A
    np_ = -(-nn // 16) * 16
    w = rnd(interconv._weights(xyz, ctr, nbr, rk, sigma)).reshape(B, c, nn, A, K)
    wt = torch.full((B, c, A, 32, np_), 3.0)                  # stale rows >= K
    wt[..., :K, :] = 0.0
    wt[..., :K, :nn] = w.permute(0, 1, 3, 4, 2)               # [k][n] per anchor
    ft = torch.full((B, c, A, np_, C), -2.0)                 # stale padded rows
    gf = torch.stack([feats[b][nbr[b].long()] for b in range(B)]).float()   # (B,c,nn,A*C)
    ft[..., :nn, :] = gf.reshape(B, c, nn, A, C).permute(0, 1, 3, 2, 4)
    t = (wt @ ft)[..., :K, :]
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk, sigma, A).float()
    tb = t.to(torch.bfloat16).float()
    assert (tb - ref).abs().max() <= 1e-2 * ref.abs().max()
    assert (tb == ref).float().mean() >= 0.99


@pytest.mark.parametrize("sigma", [0.0032, 0.0064, 0.0128, 0.045])
def test_markstein_quotient_is_the_ieee_quotient(sigma):
    """The tensor-core body forms d2 / sigma as q1 = d2 * RN(1 / sigma),
    q = fma(fma(-q1, sigma, d2), RN(1 / sigma), q1) (Markstein's correction).
    Emulated here with float64 products, which are exact for two float32
    factors, it gives the IEEE float32 quotient on every sample."""
    rng = np.random.default_rng(0)
    s = np.float32(sigma)
    rs = np.float32(1) / s
    d2 = (rng.random(200_000) * 0.1).astype(np.float32)
    q1 = d2 * rs
    r = (d2.astype(np.float64) - q1.astype(np.float64) * np.float64(s)).astype(np.float32)
    q = (q1.astype(np.float64) + r.astype(np.float64) * np.float64(rs)).astype(np.float32)
    assert np.array_equal(q, d2 / s)


def _tf32(x):
    """cvt.rna.tf32.f32: x rounded to 10 fraction bits, ties away from zero
    (adding half of the lowest kept bit to the magnitude's bits, then
    clearing the 13 low bits)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x):
    """The 3xTF32 split: hi = tf32(x), lo = tf32(x - hi) (x - hi is exact)."""
    hi = _tf32(x)
    return hi, _tf32(np.asarray(x, np.float32) - hi)


def test_tf32_split_reconstructs_f32():
    """Both halves are tf32 values and hi + lo is x to within 2^-21
    relative, over f32 values of every sign and many binades."""
    one = np.float32(1)
    tie = one + np.float32(2.0 ** -11)
    assert _tf32(tie) == one + np.float32(2.0 ** -10)          # ties away from zero
    assert _tf32(-tie) == -(one + np.float32(2.0 ** -10))
    assert _tf32(np.nextafter(tie, one)) == one
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(400_000) * np.exp2(rng.integers(-60, 60, 400_000))).astype(np.float32)
    hi, lo = _split_tf32(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x.astype(np.float64))).all()
    assert (np.abs(x - hi) > 2.0 ** -21 * np.abs(x)).any()     # hi alone is not enough


def test_3xtf32_contraction_is_f32_accurate():
    """The f32 body's products at conv1's geometry (64 neighbours, 24 kernel
    points, C=32, conv1's radius and sigma; 16 centers): w_lo f_hi + w_hi f_lo
    + w_hi f_hi from the split f32 weights and features, added to an f32
    accumulator rounded after every 8-neighbour product as the m16n8k8
    tensor-core steps do, holds within 1e-5 * max|t| of the float64
    contraction; one tf32 pass does not."""
    spec = backbone_plan(EtchConfig(num_point=5000, batch_size=8))[0][1]
    nn, C, A = spec["n_neighbor"], spec["dim_in"], 60
    rng = np.random.RandomState(0)
    z, th = rng.uniform(-0.9, 0.9, 2500), rng.uniform(0, 2 * np.pi, 2500)
    r = 0.15 + 0.03 * np.cos(3 * z)
    xyz = torch.tensor(np.stack([r * np.cos(th), r * np.sin(th), z], -1)[None], dtype=torch.float32)
    ctr = xyz[:, :16].contiguous()
    nbr = ball_query_torch(ctr, xyz, spec["radius"], nn)
    kp = get_kernel_points(spec["radius"], spec["kernel_size"])
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3).copy())
    K = rk.shape[0] // A
    w = interconv._weights(xyz, ctr, nbr, rk, spec["sigma"])[0].reshape(16, nn, A, K).numpy()
    feats = rng.randn(2500, A * C).astype(np.float32)
    f = feats[nbr[0].numpy()].reshape(16, nn, A, C)
    assert (w > 0).mean() > 0.05
    t64 = np.einsum("cnak,cnad->cakd", w.astype(np.float64), f.astype(np.float64))
    scale = np.abs(t64).max()
    (wh, wl), (fh, fl) = _split_tf32(w), _split_tf32(f)
    acc = np.zeros(t64.shape, np.float32)
    one = np.zeros(t64.shape, np.float32)
    def step(acc, a, b, sl):
        part = np.einsum("cnak,cnad->cakd", a[:, sl].astype(np.float64), b[:, sl].astype(np.float64))
        return (acc.astype(np.float64) + part).astype(np.float32)

    for n0 in range(0, nn, 8):
        sl = slice(n0, n0 + 8)
        for a, b in ((wl, fh), (wh, fl), (wh, fh)):
            acc = step(acc, a, b, sl)
        one = step(one, wh, fh, sl)
    assert np.abs(acc - t64).max() <= 1e-5 * scale
    assert np.abs(one - t64).max() > 1e-5 * scale


def test_interconv_tf32_geometry():
    """Shared memory of the f32 body at the main path's shapes (64
    neighbours): 42,240 bytes at C=32 (5 blocks an SM), 75,008 at C=64 (3
    blocks); widths that are not a multiple of 4 up to 64 raise."""
    assert interconv.tf32_smem_bytes(64, 32) == 42240
    assert interconv.tf32_smem_bytes(64, 64) == 75008
    for C in (4, 8, 12, 32, 60, 64):
        interconv.check_tf32_geometry(64, C)
    for nn, C in ((64, 2), (64, 6), (64, 68), (9000, 64)):
        with pytest.raises(ValueError):
            interconv.check_tf32_geometry(nn, C)


def _padded_attention_matches(Bc, L, E, H, seed):
    """The anchor attention's padded layout in float64: each head padded by
    zero columns to 8 or to a multiple of 16, the keys to 64 rows, those at
    L..63 masked to -inf and their k and v rows zero."""
    hs = E // H
    hp = 8 if hs <= 8 else -(-hs // 16) * 16
    g = np.random.RandomState(seed)
    q, k, v = (rnd(torch.tensor(g.randn(Bc, L, E) * (hs ** -0.5 if i == 0 else 1.0),
                                dtype=torch.float32)) for i in range(3))

    def pad(t):
        out = np.zeros((Bc, 64, H, hp))
        out[:, :L, :, :hs] = t.double().numpy().reshape(Bc, L, H, hs)
        return out

    qp, kp, vp = pad(q), pad(k), pad(v)
    s = np.einsum("bqhd,bkhd->bhqk", qp, kp)
    heads = q.double().numpy().reshape(Bc, L, H, hs), k.double().numpy().reshape(Bc, L, H, hs)
    np.testing.assert_array_equal(s[:, :, :L, :L], np.einsum("bqhd,bkhd->bhqk", *heads))
    s[..., L:] = -np.inf
    e = np.exp(s - s.max(-1, keepdims=True))
    a = e / e.sum(-1, keepdims=True)
    assert (a[..., L:] == 0).all()
    ab = rnd(torch.from_numpy(a.astype(np.float32))).double().numpy()
    o = np.einsum("bhqk,bkhd->bqhd", ab, vp)
    assert (o[..., hs:] == 0).all()
    out = torch.from_numpy(o[:, :L, :, :hs].reshape(Bc, L, E)).float()
    ref = attention.attention_torch(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                    v.to(torch.bfloat16), H)
    err = (out - ref).abs()
    assert err.max() <= 1e-2 * ref.abs().max()
    assert (err / (ref.abs() + 1e-2)).median() <= 1e-3


@pytest.mark.parametrize("E,H", [(24, 8), (24, 4), (12, 1), (48, 2), (40, 2)])
def test_attention_padded_tiles_are_exact(E, H):
    """Head sizes that are neither 1, 2, 4 nor a multiple of 8 or 16 (3, 6,
    12, 24, 20 here) sit in the kernel's shared memory with each head padded
    by zero columns to 8 or to a multiple of 16, and every point's keys are
    padded to 64 rows masked to -inf.  In float64 the padded logits are the
    head's own exactly, padded keys get weight exactly 0, the padded columns
    of a v are exactly 0, and the emulated output (weights rounded to bf16)
    matches attention_torch by the card's bf16 criterion."""
    _padded_attention_matches(3, 60, E, H, E + H)


@pytest.mark.parametrize("L", [1, 20, 64])
@pytest.mark.parametrize("E,H", [(64, 8), (24, 4)])
def test_attention_masked_keys_are_exact(L, E, H):
    """The anchor counts the configuration allows besides 60: one key (the
    other 7 of its 8-key tile and every later tile masked), 20 (the mask
    starts inside an 8-key tile) and 64 (no padded key)."""
    _padded_attention_matches(8, L, E, H, L + E + H)


def test_launch_counts_are_keyed_by_shape():
    """A launch's shape key is its entry point and its scalar arguments,
    never a pointer, so that two launches at one shape share a count."""
    args = (_build.ptr(torch.zeros(1)), 8, 5000, 1250, 3, 0.25)
    assert _build.shape_key("etch_knn", args) == ("etch_knn", 8, 5000, 1250, 3, 0.25)
    _build.shape_launches["knn"][_build.shape_key("etch_knn", args)] = 2
    _build.reset_launch_counts()
    assert _build.shape_launches["knn"] == {} and _build.launches["knn"] == 0
