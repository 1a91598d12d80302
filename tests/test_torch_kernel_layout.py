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
from etch_tpu_torch.nn import dircore, interconv
from etch_tpu_torch.nn.bf16 import rnd
from etch_tpu_torch.ops.ball_query import ball_query_torch
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
from torch_parity import _padded_attention_matches, capsule


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
    (3 blocks) and at every wider row, which runs in 64-channel slices
    (C = 72 and the 128- and 256-channel blocks of epn_layer_num 3 and 4);
    widths that are not a multiple of 8 (padded with zero channels), K > 32
    (blocks of 32 kernel points) and balls of 400 (64-neighbour chunks) are
    taken; only more neighbours than their offsets leave room for raise."""
    assert interconv.mma_smem_bytes(64, 24, 32) == 42240
    assert interconv.mma_smem_bytes(64, 24, 64) == 75008
    for C in (8, 16, 32, 64, 72, 128, 256):
        interconv.check_mma_geometry(64, 24, C)
    assert interconv.mma_smem_bytes(64, 24, 256) == 75008
    for nn, K, C in ((64, 24, 4), (64, 24, 12), (64, 33, 32), (400, 24, 64)):
        interconv.check_mma_geometry(nn, K, C)
    assert interconv.mma_smem_bytes(64, 24, 12) == interconv.mma_smem_bytes(64, 24, 16)
    with pytest.raises(ValueError):
        interconv.check_mma_geometry(8000, 24, 64)


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
    xyz = torch.from_numpy(capsule(rng, 1, 2500))
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
    blocks) and at every wider row, which runs in 64-channel slices (C = 68
    and the 128- and 256-channel blocks); widths that are not a multiple of
    4 are taken (padded with zero channels), too many neighbours raise."""
    assert interconv.tf32_smem_bytes(64, 32) == 42240
    assert interconv.tf32_smem_bytes(64, 64) == 75008
    for C in (2, 4, 6, 8, 12, 32, 60, 64, 68, 128, 256):
        interconv.check_tf32_geometry(64, C)
    assert interconv.tf32_smem_bytes(64, 128) == 75008
    assert interconv.tf32_smem_bytes(64, 6) == interconv.tf32_smem_bytes(64, 8)
    with pytest.raises(ValueError):
        interconv.check_tf32_geometry(9000, 64)


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


# --- FPS (csrc/fps.cu): the uint32-bit argmax key and the lowest index ------

def _fps_emulated(xyz, m, threads, ppt):
    """csrc/fps.cu's register instance in numpy: thread `tid` holds points
    tid + threads * i, i < ppt (padded ones at a running minimum of 0); each
    step every thread keeps its first largest key (the running minimum's
    uint32 bits), a warp takes the largest key and the smallest index among
    the lanes that hold it, and the block does the same over the warps'
    slots."""
    B, N, _ = xyz.shape
    slots = threads * ppt
    out = np.zeros((B, m), np.int32)
    for b in range(B):
        p = np.zeros((slots, 3), np.float32)
        p[:N] = xyz[b]
        md = np.where(np.arange(slots) < N, np.float32(np.inf), np.float32(0)).astype(np.float32)
        last = 0
        for s in range(1, m):
            d = p - p[last]
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]   # f32, op by op
            md = np.minimum(md, d2)
            key = md.view(np.uint32).reshape(ppt, threads)
            i = key.argmax(0)                                 # first largest: smallest index
            tkey, tidx = key[i, np.arange(threads)], i * threads + np.arange(threads)
            wkey, widx = tkey.reshape(-1, 32), tidx.reshape(-1, 32)
            wmax = wkey.max(1)
            wmin = np.where(wkey == wmax[:, None], widx, 2 ** 31 - 1).min(1)
            last = int(np.where(wmax == wmax.max(), wmin, 2 ** 31 - 1).min())
            out[b, s] = last
    return out


@pytest.mark.parametrize("cloud", ["lattice", "random"])
def test_fps_bit_key_argmax_matches_fps_torch(cloud):
    """Non-negative f32 values order as their uint32 bits, so the kernel's
    integer max / min reductions pick fps_torch's point at every step: on a
    lattice, where many points tie at every step (the smaller index must
    win), and on a random cloud; in the kernel's layout at 512 threads, and
    in a single warp's, where every point a thread holds is compared."""
    from etch_tpu_torch.ops.fps import fps_torch
    if cloud == "lattice":
        g = np.stack(np.meshgrid(*[np.arange(9, dtype=np.float32) * 0.125] * 3,
                                 indexing="ij"), -1).reshape(1, -1, 3)      # 729 points
        xyz = np.concatenate([g, g[:, ::-1]])
    else:
        xyz = np.random.RandomState(3).uniform(-1, 1, (2, 1500, 3)).astype(np.float32)
    ref = fps_torch(torch.from_numpy(xyz), 120).numpy()
    N = xyz.shape[1]
    ppt = next(p for p in (1, 2, 4, 6, 8, 10, 12, 16) if p * 512 >= N)   # csrc/fps.cu
    threads = -(-(-(-N // ppt)) // 32) * 32
    np.testing.assert_array_equal(_fps_emulated(xyz, 120, threads, ppt), ref)
    np.testing.assert_array_equal(_fps_emulated(xyz, 120, 32, -(-N // 32)), ref)


# --- vector attention (csrc/vector_attention.cu): tiles, fragments, softmax --

_LANE = np.arange(32)
_G, _T = _LANE >> 2, _LANE & 3


def _mma16816(a, b0, b1):
    """One m16n8k16 from per-lane fragments: a (32, 4, 2) (registers a0..a3,
    each a bf16 pair), b0 and b1 (32, 2); returns the (32, 4) accumulators
    (rows g, g, g + 8, g + 8; columns 2t, 2t + 1)."""
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    t2 = 2 * _T
    for i in range(2):
        A[_G, t2 + i], A[_G + 8, t2 + i] = a[:, 0, i], a[:, 1, i]
        A[_G, t2 + 8 + i], A[_G + 8, t2 + 8 + i] = a[:, 2, i], a[:, 3, i]
        Bm[t2 + i, _G], Bm[t2 + 8 + i, _G] = b0[:, i], b1[:, i]
    D = A @ Bm
    return np.stack([D[_G, t2], D[_G, t2 + 1], D[_G + 8, t2], D[_G + 8, t2 + 1]], 1)


def _bf16(x):
    return rnd(torch.from_numpy(np.asarray(x, np.float32))).double().numpy()


def _va_fragments(w0, w1):
    """W0 and W1 as the kernel's prologue writes them into shared memory:
    bf16 B fragments, zero-padded, by its index formulas.  Returns W0's as
    (k16 steps, n8 tiles, lane, 4) and W1's likewise; values 0, 1 of a lane's
    word are its b0, values 2, 3 its b1."""
    c, cs = w0.shape
    nt = -(-cs // 8)
    f0 = np.zeros(-(-c // 32) * 2 * nt * 32 * 4)
    f1 = np.zeros(-(-nt // 2) * nt * 32 * 4)
    for r in range(c):
        for col in range(cs):
            at = ((((2 * (r >> 5) + ((r >> 2) & 1)) * nt + (col >> 3)) * 32 + 4 * (col & 7)
                   + ((r >> 3) & 3)) << 2) + (r & 3)
            f0[at] = w0[r, col]
    for r in range(cs):
        for col in range(cs):
            at = ((((r >> 4) * nt + (col >> 3)) * 32 + 4 * (col & 7) + ((r >> 1) & 3)) << 2) \
                + 2 * ((r >> 3) & 1) + (r & 1)
            f1[at] = w1[r, col]
    return _bf16(f0).reshape(-1, nt, 32, 4), _bf16(f1).reshape(-1, nt, 32, 4)


def _va_emulated(xq, xk, xv, idx, pe, a0, w0, a1, w1, b1):
    """csrc/vector_attention.cu with one warp a tile (c < 256), lane by lane:
    rows padded to rp a point, w formed 8 channels a lane into permuted A
    fragments against W0's fragments (`_va_fragments`), z's accumulators reused as
    A fragments, the softmax by the row-group bits of the lanes, the weighted
    sum over each point's rows."""
    B, N, ns = idx.shape
    R, c = xq.shape
    cs = w0.shape[1]
    nt, cpad = -(-cs // 8), -(-c // 32) * 32
    rp = 1 << (ns - 1).bit_length()
    w0f, w1f = _va_fragments(w0, w1)
    k1 = w1f.shape[0]
    kf, vf, flat = xk.reshape(-1, c), xv.reshape(-1, c), idx.reshape(R, ns)
    a1p = np.zeros((2, 8 * nt)); a1p[:, :cs] = a1
    b1p = np.zeros(8 * nt); b1p[:cs] = b1
    out = np.zeros((R, c))
    ppu = 16 // rp
    for p0 in range(0, R, ppu):
        rows = np.arange(16)
        p, j = p0 + rows // rp, rows % rp
        ok = (j < ns) & (p < R)
        m = np.where(ok, (np.minimum(p, R - 1) // N) * N + flat[np.minimum(p, R - 1),
                                                              np.minimum(j, ns - 1)], -1)
        pet = np.zeros((16, cpad))
        pet[ok, :c] = pe[p[ok], j[ok]]
        acc = np.zeros((nt, 32, 4))
        for c32 in range(0, c, 32):
            a = np.zeros((2, 32, 4, 2))
            for h, rw in enumerate((_G, _G + 8)):
                for e in range(8):
                    ch = c32 + 8 * _T + e
                    inside = ch < c
                    chc = np.minimum(ch, c - 1)
                    w = ((kf[np.maximum(m[rw], 0), chc] - xq[np.minimum(p[rw], R - 1), chc])
                         + pet[rw, chc]) * a0[0, chc] + a0[1, chc]
                    w = np.where(inside, _bf16(np.maximum(w, 0)), 0)
                    s, q = divmod(e, 4)
                    a[s, :, (q // 2) * 2 + h, q % 2] = w
            for s in range(2):
                for jt in range(nt):
                    b = w0f[c32 // 16 + s, jt]
                    acc[jt] += _mma16816(a[s], b[:, :2], b[:, 2:])
        za = np.zeros((k1, 32, 4, 2))
        for jt in range(nt):
            cols = 8 * jt + 2 * _T
            for h in range(2):
                for e in range(2):
                    za[jt // 2, :, 2 * (jt % 2) + h, e] = _bf16(np.maximum(
                        acc[jt, :, 2 * h + e] * a1p[0, cols + e] + a1p[1, cols + e], 0))
        lg = np.zeros((nt, 32, 4))
        for jt in range(nt):
            for kk in range(k1):
                b = w1f[kk, jt]
                lg[jt] += _mma16816(za[kk], b[:, :2], b[:, 2:])
            for e in range(4):
                lg[jt, :, e] += b1p[8 * jt + 2 * _T + e % 2]
                lg[jt, :, e] = np.where(ok[_G + 8 * (e >> 1)], lg[jt, :, e], -np.inf)
        span = 4 * min(rp, 8)
        st = np.zeros((16, 8 * nt))
        for jt in range(nt):
            for c2 in range(2):
                lo, hi = lg[jt, :, c2], lg[jt, :, 2 + c2]
                mlo, mhi = (np.maximum(lo, hi),) * 2 if rp == 16 else (lo, hi)
                off = 4
                while off < span:
                    mlo, mhi = np.maximum(mlo, mlo[_LANE ^ off]), np.maximum(mhi, mhi[_LANE ^ off])
                    off <<= 1
                # a point past R has only -inf rows (its output is never stored)
                mlo, mhi = np.where(np.isinf(mlo), 0, mlo), np.where(np.isinf(mhi), 0, mhi)
                elo, ehi = np.exp(lo - mlo), np.exp(hi - mhi)
                dlo, dhi = (elo + ehi,) * 2 if rp == 16 else (elo, ehi)
                off = 4
                while off < span:
                    dlo, dhi = dlo + dlo[_LANE ^ off], dhi + dhi[_LANE ^ off]
                    off <<= 1
                with np.errstate(invalid="ignore"):   # 0 / 0 on a point past R, never read
                    st[_G, 8 * jt + 2 * _T + c2] = elo / dlo
                    st[_G + 8, 8 * jt + 2 * _T + c2] = ehi / dhi
        for pp in range(ppu):
            if p0 + pp >= R:
                continue
            r = pp * rp + np.arange(ns)
            wsum = (vf[m[r]] + pet[r, :c]) * st[r][:, np.arange(c) % cs]
            out[p0 + pp] = wsum.sum(0)
    return out


@pytest.mark.parametrize("ns,c", [(4, 64), (8, 64), (12, 128), (16, 128), (8, 24)])
def test_vector_attention_tiles_match_the_plain_version(ns, c):
    """The kernel's m16 tiles of (point, neighbour) rows at ns = 4, 8 (4 and
    2 points a tile), 12 (one point, 4 padded rows at -inf) and 16, its
    permuted first-product fragments, the second product on z's
    accumulators and the softmax over the row-group bits of the lanes,
    emulated in numpy: within the card's bf16 criterion of
    vector_attention_torch.  c = 24 (cs = 3) pads the columns of cs."""
    from etch_tpu_torch.nn.vector_attention import vector_attention_torch
    g = np.random.RandomState(ns + c)
    B, N, cs = 2, 21, c // 8            # 42 points: a ragged last tile at ns = 4, 8
    bfn = lambda *s: _bf16(g.randn(*s))
    xq, xk, xv, pe = bfn(B * N, c), bfn(B, N, c), bfn(B, N, c), bfn(B * N, ns, c)
    idx = g.randint(0, N, (B, N, ns))
    a0 = np.stack([g.rand(c) + 0.5, g.randn(c)])
    a1 = np.stack([g.rand(cs) + 0.5, g.randn(cs)])
    w0, w1, b1 = g.randn(c, cs) / np.sqrt(c), g.randn(cs, cs) / np.sqrt(cs), g.randn(cs)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    args = [f32(xq).to(torch.bfloat16), f32(xk).to(torch.bfloat16), f32(xv).to(torch.bfloat16),
            torch.tensor(idx, dtype=torch.int32), f32(pe).to(torch.bfloat16), f32(a0), f32(w0),
            f32(a1), f32(w1), f32(b1)]
    ref = vector_attention_torch(*args).double().numpy()
    out = _va_emulated(xq, xk, xv, idx, pe, a0, f32(w0).numpy(), a1, f32(w1).numpy(), b1)
    err = np.abs(out - ref)
    assert err.max() <= 1e-2 * np.abs(ref).max()
    assert np.median(err / (np.abs(ref) + 1e-2)) <= 1e-3


# --- the contraction's channel slices (csrc/interconv.cu) ------------------

def _channel_slices(C):
    """The first channels and width of a C-channel row's slices, as
    `csrc/interconv.cu:launch_slices` and `slice_start` make them, all in one
    launch: C itself up to 64; above, ceil(C / 64) slices of 64, slice z at
    64 z, the last ending at the row's end."""
    Cs = min(C, 64)
    return [min(Cs * z, C - Cs) for z in range(-(-C // Cs))], Cs


@pytest.mark.parametrize("C", [128, 256, 200])
def test_interconv_channel_slices_reassemble_t(C):
    """Rows wider than 64 channels run as slices of one launch: slice z at
    first channel cz gathers channels cz .. cz + 63 of every anchor's row
    (the row's stride is C) and writes the same channels of t (B, c, A, K,
    C).  The slices cover every channel, those covered twice are written
    twice with the same values, their segments start on 16-byte boundaries
    in bf16 and f32, and the slices' contractions, put back by the kernel's
    addresses, give t exactly."""
    starts, Cs = _channel_slices(C)
    assert sorted({cz + i for cz in starts for i in range(Cs)}) == list(range(C))
    assert all(cz * 2 % 16 == 0 for cz in starts)
    rng = np.random.RandomState(C)
    B, P, c, A, nn = 1, 60, 3, 60, 8
    xyz = torch.tensor(rng.uniform(-0.5, 0.5, (B, P, 3)), dtype=torch.float32)
    ctr = xyz[:, :c].contiguous()
    nbr = ball_query_torch(ctr, xyz, 0.5, nn)
    kp = get_kernel_points(0.4, 1)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3).copy())
    K = kp.shape[0]
    feats = torch.tensor(rng.randn(B, P, A * C), dtype=torch.float32)
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk, 0.08, A)
    flat_in = feats.reshape(-1)
    out = torch.full((B * c * A * K * C,), float("nan"))
    for cz in starts:
        # the gather's addresses: row p, anchor a, channel cz + i
        addr = (torch.arange(P)[:, None, None] * A * C + torch.arange(A)[None, :, None] * C
                + cz + torch.arange(Cs)[None, None, :])
        seg = flat_in[addr].reshape(B, P, A * Cs)
        t = interconv.interconv_t_torch(xyz, ctr, nbr, seg, rk, 0.08, A)   # (B,c,A,K,Cs)
        oaddr = (torch.arange(B * c * A * K)[:, None] * C + cz + torch.arange(Cs)[None, :])
        oaddr = oaddr.reshape(-1)
        prior = out[oaddr]
        written = ~torch.isnan(prior)
        assert torch.equal(prior[written], t.reshape(-1)[written])   # an overlap rewrites equal values
        out[oaddr] = t.reshape(-1)
    assert torch.equal(out.reshape(ref.shape), ref)


# --- the wide direction core's fragment-ordered weights ---------------------

@pytest.mark.parametrize("rows,cols", [(128, 128), (256, 128), (128, 256)])
def test_dircore_wide_fragments_unpack_to_the_matrix(rows, cols):
    """`pack_fragments` puts, for k16 step kt, 16-column tile n and lane
    4g + t, the B fragments b0..b3 of mma.sync m16n8k16 (columns 16n + g and
    16n + 8 + g, rows 16kt + 2t + {0, 1} and + 8) in one 16-byte word: read
    back by those rules, the packed words give the bf16 matrix, zero-padded."""
    g = np.random.RandomState(rows + cols)
    w = torch.tensor(g.randn(rows - 8, cols - 24), dtype=torch.float32)
    packed = dircore.pack_fragments(w, rows, cols).float().reshape(rows // 16, cols // 16, 32, 4, 2)
    back = torch.zeros(rows, cols)
    t2, gg = 2 * torch.tensor(_T), torch.tensor(_G)
    for kt in range(rows // 16):
        for n in range(cols // 16):
            f = packed[kt, n]
            for e in range(2):
                back[16 * kt + t2 + e, 16 * n + gg] = f[:, 0, e]
                back[16 * kt + 8 + t2 + e, 16 * n + gg] = f[:, 1, e]
                back[16 * kt + t2 + e, 16 * n + 8 + gg] = f[:, 2, e]
                back[16 * kt + 8 + t2 + e, 16 * n + 8 + gg] = f[:, 3, e]
    torch.testing.assert_close(back[:rows - 8, :cols - 24], rnd(w), rtol=0, atol=0)
    assert back[rows - 8:].abs().sum() == 0 and back[:, cols - 24:].abs().sum() == 0


def test_dircore_wide_folded_output_matches_the_plain_twin():
    """The wide kernel folds the last two products, out = (h2 wm1 + bm1) wr,
    into h2 u + bm1 . wr with u = bf16(wm1) wr from pack_weights_wide: with
    h2 bf16-valued, the two agree to f32 summation order."""
    g = np.random.RandomState(5)
    V = 256
    p = {"wm1": torch.tensor(g.randn(V, V) / 16, dtype=torch.float32),
         "bm1": torch.tensor(g.randn(V), dtype=torch.float32),
         "wr": torch.tensor(g.randn(V, 1) / 16, dtype=torch.float32)}
    for n, s in (("wq0", 128), ("wk0", 128), ("wv0", 128), ("wc0", 128), ("wq1", 128),
                 ("wk1", 128), ("wv1", 128)):
        p[n] = torch.zeros(s, s)
    p.update(wc1=torch.zeros(128, V), wm0=torch.zeros(V, V), bc0=torch.zeros(128),
             bc1=torch.zeros(V), bm0=torch.zeros(V))
    _, f = dircore.pack_weights_wide(p, "cpu", 128, V)
    u, c = f[128 + 2 * V:128 + 3 * V], f[128 + 3 * V]
    h2 = rnd(torch.tensor(np.abs(g.randn(60, V)), dtype=torch.float32))
    ref = ((h2.double() @ rnd(p["wm1"]).double() + p["bm1"].double()) @ p["wr"].double())[:, 0]
    torch.testing.assert_close((h2 @ u + c).double(), ref, rtol=1e-5, atol=1e-5)
