"""Every width the JAX package takes, on the port's CPU side.

The kernels that take them run only on the card (tests/test_torch_kernels_cuda.py);
here, without a card, each design is emulated in numpy or torch and held to
the plain version, and the port is held to the JAX package at tiny widths:

  - kNN (`csrc/knn.cu`): a query's support scan split over a group of G lanes,
    each with its own sorted list, a queue and the group's bound, merged by
    k rounds of a (d2, index) argmin, in passes of 32 above k = 32; the
    prefilter's proven margin at the tightest threshold.  Indices and
    squared distances must equal `knn_torch`'s, planted exact ties included.
  - the occupancy conv with its projection (`csrc/interconv.cu`): the
    expanded form of the kernel-point weights against the direct form,
    within the card's bf16 gate (1e-2 * max|plain|, median relative 1e-3).
  - the direction core and the anchor attention: heads of any size padded
    by zero columns to a size the kernels take (`nn/dircore.py:head_layout`),
    exact in f32 and against the JAX package's Pallas core (interpret mode).
  - the network at a head size of 6 and a U-Net level with 40 neighbours,
    against JAX `EtchNet` (its XLA paths on the CPU), with
    tests/test_torch_model.py's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.nn.pallas_dircore import direction_core_pallas
from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.nn import dircore, interconv
from etch_tpu_torch.nn.bf16 import BF16, rnd
from etch_tpu_torch.ops.ball_query import ball_query_torch
from etch_tpu_torch.ops.knn import knn_torch
from torch_parity import (_bf16_gate, _close_forward, _core_params,
                          _padded_attention_matches, capsule, jax_apply, paired_nets)

F32 = np.float32
INF = F32(np.inf)
NO_INDEX = 2 ** 31 - 1


# --- kNN: the lane split, its merge and its passes --------------------------

def _fma(a, b, c):
    """fma in f32: the exact product plus c, rounded once through float64
    (a second rounding, to f32, is within the prefilter's slack)."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _round_down(x):
    f = F32(x)
    return np.nextafter(f, F32(-np.inf)) if np.float64(f) > x else f


def _round_up(x):
    f = F32(x)
    return np.nextafter(f, INF) if np.float64(f) < x else f


def _prefilter_w(s):
    """The tile's fourth component: RD(fl(|s|^2) (1 - 2^-19))."""
    ss = _fma(s[0], s[0], _fma(s[1], s[1], F32(s[2] * s[2])))
    return _round_down(np.float64(ss) * (1 - 2.0 ** -19))


def _prefilter_l(q, s, w):
    """L = fma(-2qx, sx, fma(-2qy, sy, fma(-2qz, sz, w)))."""
    return _fma(F32(-2 * q[0]), s[0], _fma(F32(-2 * q[1]), s[1], _fma(F32(-2 * q[2]), s[2], w)))


def _query_qq(q):
    return _fma(q[0], q[0], _fma(q[1], q[1], F32(q[2] * q[2])))


def _bound_adjust(thr, qq):
    """csrc/knn.cu:bound_adjust, with its rounding directions."""
    if thr == INF:
        return INF
    a = _round_up(np.float64(thr) * (1 + 2.0 ** -20))
    b = _round_down(np.float64(qq) * (1 - 2.0 ** -20))
    c = _round_up(np.float64(a) - np.float64(b))
    return _round_up(np.float64(c) + np.float64(np.finfo(F32).tiny))


def _sqdist(q, s):
    """etch_sqdist: (dx*dx + dy*dy) + dz*dz, each step rounded to f32."""
    d = [F32(q[i] - s[i]) for i in range(3)]
    return F32(F32(F32(d[0] * d[0]) + F32(d[1] * d[1])) + F32(d[2] * d[2]))


def _insert(ld, li, d, j):
    """Strict-less insertion into a sorted list of fixed length."""
    r = next((r for r in range(len(ld)) if d < ld[r]), None)
    if r is not None:
        ld.insert(r, d)
        li.insert(r, j)
        ld.pop()
        li.pop()


def _knn_lane_split(q, s, k, G, tile=1024, queue=16, queue_pairs=8, unroll=16):
    """csrc/knn.cu:knn_kernel for one cloud, one query at a time, its G lanes
    in lockstep: (M, 3), (N, 3) f32 -> idx (M, k), d2 (M, k).  A lane queues
    the pairs its prefilter passes, a step of `unroll` pairs with hits one
    entry; emptying the queues (when one is full or holds more than
    `queue_pairs` pairs, and at each tile's end) takes their exact d2 and
    inserts those below the lane's threshold and after the previous pass's
    last pick."""
    kmax = 4 if k <= 4 else 8 if k <= 8 else 16 if k <= 16 else 32
    n = len(s)
    w = [_prefilter_w(p) for p in s]
    idx = np.zeros((len(q), k), np.int64)
    d2 = np.zeros((len(q), k), F32)
    for m, qp in enumerate(q):
        qq = _query_qq(qp)
        dl, il = F32(-1), -1
        for done in range(0, k, kmax):
            kk = min(kmax, k - done)
            mg = -(-kk // G)
            ld = [[INF] * kmax for _ in range(G)]
            li = [[NO_INDEX] * kmax for _ in range(G)]
            qs = [[] for _ in range(G)]
            thr, thr_adj = [INF] * G, [INF] * G

            def flush():
                for g in range(G):
                    for j in qs[g]:
                        d = _sqdist(qp, s[j])
                        if d < thr[g] and (d > dl or (d == dl and j > il)):
                            _insert(ld[g], li[g], d, j)
                    qs[g].clear()
                tg = max(ld[g][mg - 1] for g in range(G))
                tg_up = INF if tg == INF else np.nextafter(tg, INF)
                for g in range(G):
                    thr[g] = min(ld[g][kk - 1], tg_up)
                    thr_adj[g] = _bound_adjust(thr[g], qq)

            for t0 in range(0, n, tile):
                tcnt = min(tile, n - t0)
                steps = -(-tcnt // (G * unroll)) * unroll   # a lane's pairs, padded
                entries = [0] * G
                for st in range(0, steps, unroll):
                    for g in range(G):
                        hits = [t0 + (st + u) * G + g for u in range(unroll)
                                if (st + u) * G + g < tcnt
                                and _prefilter_l(qp, s[t0 + (st + u) * G + g],
                                                 w[t0 + (st + u) * G + g]) < thr_adj[g]]
                        qs[g] += hits
                        entries[g] += bool(hits)
                    assert max(entries) <= queue
                    if any(e == queue for e in entries) or any(len(x) > queue_pairs for x in qs):
                        flush()
                        entries = [0] * G
                flush()
                entries = [0] * G
            for r in range(kk):
                md, mi = min((ld[g][0], li[g][0]) for g in range(G))
                g = next(g for g in range(G) if li[g][0] == mi)
                ld[g] = ld[g][1:] + [INF]
                li[g] = li[g][1:] + [NO_INDEX]
                idx[m, done + r], d2[m, done + r] = mi, md
                dl, il = md, mi
    return idx, d2


def _tied_cloud(seed, n):
    """Supports with planted exact ties: lattice points (equal distances to
    a lattice query), duplicated points, and random points."""
    g = np.random.RandomState(seed)
    lat = np.stack(np.meshgrid(*[np.arange(5, dtype=F32) * F32(0.125)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    rand = g.uniform(-0.1, 0.6, (n - len(lat) - 20, 3)).astype(F32)
    pts = np.concatenate([lat, rand, lat[g.choice(len(lat), 20)]])
    return pts[g.permutation(len(pts))].astype(F32)


@pytest.mark.parametrize("G", [1, 4, 32])
@pytest.mark.parametrize("k", [1, 3, 8, 16, 33, 48])
def test_knn_lane_split_matches_knn_torch(k, G):
    """The kernel's lane split (G lanes a query, strided shares), its queues
    and tiles, the group's bound, the k-round merge and, for k = 33 and 48, its passes
    of 32, give knn_torch's indices and squared distances exactly, with
    planted ties (lattice queries among lattice supports, duplicated
    supports) going to the smaller index."""
    s = _tied_cloud(k + G, 300)
    q = np.concatenate([s[:3], np.array([[0.25, 0.25, 0.25], [0.0625, 0.125, 0.5],
                                         [0.3, -0.05, 0.2]], F32)])
    idx, d2 = _knn_lane_split(q, s, k, G, tile=128)   # three tiles: their ends empty the queues
    ridx, rd2 = knn_torch(torch.from_numpy(q)[None], torch.from_numpy(s)[None], k)
    np.testing.assert_array_equal(idx, ridx[0].numpy())
    np.testing.assert_array_equal(d2, rd2[0].numpy())


@pytest.mark.parametrize("offset", [0.0, 1.0, 100.0, 3000.0])
def test_knn_prefilter_margin_holds_at_the_tightest_threshold(offset):
    """For every pair, with the threshold the next float above its own
    direct-difference d2 (the tightest that admits it), the prefilter's L is
    below bound_adjust(threshold, |q|^2): no pair the exact test takes is
    lost.  Clouds far from the origin (offset) make q.s cancel against
    |q|^2 and |s|^2, the hardest case for the expanded form; supports at a
    range of distances, down to coincident points."""
    g = np.random.RandomState(int(offset) + 1)
    q = (g.uniform(-1, 1, (12, 3)) + offset).astype(F32)
    near = q[:, None, :] + g.randn(12, 40, 3).astype(F32) * np.logspace(-6, 0, 40)[None, :, None]
    s = np.concatenate([near.reshape(-1, 3).astype(F32), q]).astype(F32)
    w = [_prefilter_w(p) for p in s]
    slack = []
    for qp in q:
        qq = _query_qq(qp)
        for p, wp in zip(s, w):
            thr = np.nextafter(_sqdist(qp, p), INF)
            L, adj = _prefilter_l(qp, p, wp), _bound_adjust(thr, qq)
            assert L < adj, (qp, p, L, adj)
            slack.append(float(adj) - float(L))
    # the margin stays a few units of 2^-20 (d2 + |q|^2): it passes few pairs in vain
    assert max(slack) <= 2.0 ** -17 * (3 * (abs(offset) + 2) ** 2 + 1)


# --- the occupancy conv's expanded form ---------------------------------------

def _conv0(seed=5, B=2, P=800, c=64, nn=32):
    """conv0's geometry at a small size: radius 0.08 of a body-sized cloud,
    sigma = 0.5 r^2, 60 anchors x 24 kernel points."""
    g = np.random.RandomState(seed)
    z = g.uniform(-0.9, 0.9, (B, P))
    th = g.uniform(0, 2 * np.pi, (B, P))
    xyz = np.stack([0.15 * np.cos(th), 0.15 * np.sin(th), z], -1).astype(F32)
    centers = xyz[:, :c].copy()
    radius = 0.08
    nbr = ball_query_torch(torch.from_numpy(centers), torch.from_numpy(xyz), radius, nn)
    rk = np.einsum("aij,kj->aki", get_anchors(60), get_kernel_points(radius, 1))
    return (torch.from_numpy(xyz), torch.from_numpy(centers), nbr,
            torch.from_numpy(rk.reshape(-1, 3).astype(F32)), 0.5 * radius ** 2)


def _occupancy_expanded(xyz, centers, nbr, rk, sigma, A):
    """csrc/interconv.cu:interconv_ones_proj_kernel's sums: s = 1 / sigma in
    f32, per neighbour (x, y, z, xx = |x|^2 s), per column (2 r s,
    1 - |r|^2 s), u = fma(x, ax, fma(y, ay, fma(z, az, cc))) with each fma
    rounded once (through float64), t = sum_n max(u, xx) - sum_n xx, both
    sums in f32 over the neighbours in order."""
    B, c, nn = nbr.shape
    s = torch.tensor(1.0 / np.float32(sigma), dtype=torch.float32)
    gx = torch.stack([xyz[b][nbr[b].long()] for b in range(B)]) - centers[:, :, None, :]
    xx = (gx * gx).sum(-1) * s                                          # (B, c, nn)
    ax = (2.0 * rk * s).double()                                        # (AK, 3)
    cc = (1.0 - (rk * rk).sum(-1) * s)                                  # (AK,)

    def fma(a, b, c_):
        return (a.double() * b.double() + c_.double()).float()

    acc = torch.zeros(B, c, rk.shape[0])
    sxx = torch.zeros(B, c, 1)
    for n in range(nn):
        x = gx[:, :, n, :, None]                                        # (B, c, 3, 1)
        u = fma(x[:, :, 2], ax[:, 2], cc.expand(B, c, -1))
        u = fma(x[:, :, 1], ax[:, 1], u)
        u = fma(x[:, :, 0], ax[:, 0], u)
        acc = acc + torch.maximum(u, xx[:, :, n, None])
        sxx = sxx + xx[:, :, n, None]
    return (acc - sxx).reshape(B, c, A, -1)


def test_occupancy_expanded_form_within_the_bf16_gate():
    """The kernel's expanded form of the weights, through the bf16
    projection, against interconv_ones_proj_torch (the direct form): the
    sums differ by f32 rounding of sums a few times the result, far below
    the bf16 rounding of t, so the bf16 outputs meet the gate phase 3 of
    chip_smoke.py holds the kernel to."""
    xyz, ctr, nbr, rk, sigma = _conv0()
    w = torch.from_numpy(np.random.RandomState(3).randn(24, 32).astype(F32) * 0.3)
    t_exp = _occupancy_expanded(xyz, ctr, nbr, rk, sigma, 60)
    t_dir = interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sigma, 60)
    assert (t_exp - t_dir).abs().max() <= 1e-5 * t_dir.abs().max()
    _bf16_gate((rnd(t_exp) @ rnd(w)).to(BF16),
               interconv.interconv_ones_proj_torch(xyz, ctr, nbr, rk, sigma, 60, w))


# --- heads of any size --------------------------------------------------------

@pytest.mark.parametrize("hs,hp", [(1, 1), (3, 4), (5, 8), (6, 8), (8, 8), (9, 16), (16, 16),
                                   (24, 32), (48, 48), (96, 96), (200, 208), (256, 256)])
def test_padded_head_size(hs, hp):
    assert dircore.padded_head_size(hs) == hp


@pytest.mark.parametrize("E,H", [(48, 8), (24, 8), (48, 2), (96, 1), (40, 5)])
def test_head_layout_is_exact(E, H):
    """Heads of 6, 3, 24, 96 and 8 columns in the kernels' head layout
    (each padded by zero columns to padded_head_size, q, k, v num_heads x
    that wide) give the same core: in f32 up to summation order, in bf16
    (the same rounding points) up to a rounding flip now and then."""
    hs = E // H
    params = _core_params(E, 32, E + H)
    padded = dircore.head_layout(params, H, hs, dircore.padded_head_size(hs))
    assert padded["wq0"].shape == (E, H * dircore.padded_head_size(hs))
    tok = torch.from_numpy(np.random.RandomState(E).randn(16, 60, E).astype(F32))
    ref = dircore.direction_core_torch(tok, params, H)
    out = dircore.direction_core_torch(tok, padded, H)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    _bf16_gate(dircore.direction_core_torch(tok.to(BF16), padded, H),
               dircore.direction_core_torch(tok.to(BF16), params, H))


@pytest.mark.parametrize("E,H", [(48, 8), (48, 2)])
def test_head_layout_matches_pallas(E, H):
    """The kernels' padded heads against the JAX package's Pallas core
    (interpret mode) at head sizes 6 and 24, with test_torch_bf16.py's
    tolerance for the fused core."""
    params = _core_params(E, 64, 7)
    tok = np.random.RandomState(1).randn(4, 60, E).astype(F32)
    ref = direction_core_pallas(jnp.asarray(tok),
                                {k: jnp.asarray(v.numpy()) for k, v in params.items()}, H,
                                tile=4, interpret=True)
    hs = E // H
    padded = dircore.head_layout(params, H, hs, dircore.padded_head_size(hs))
    out = dircore.direction_core_torch(torch.from_numpy(tok).to(BF16), padded, H).numpy()
    ref = np.asarray(ref, F32)
    err = np.abs(out - ref)
    assert np.median(err / (np.abs(ref) + 1e-2)) <= 5e-3
    assert err.max() <= 5e-2 * (1 + np.abs(ref).max())


@pytest.mark.parametrize("E,H", [(256, 1), (400, 2)])
def test_attention_heads_above_128_columns_are_exact(E, H):
    """Heads of 256 and 200 columns, the anchor attention's one-head groups:
    padded to 256 and 208 columns and to 64 keys, the float64 emulation
    matches attention_torch by the card's bf16 criterion."""
    _padded_attention_matches(2, 60, E, H, E + H)


# --- the network at those widths, against JAX ----------------------------------

N_WIDE = 256
WIDE_KW = dict(num_point=N_WIDE, batch_size=2, unet_blocks=(1, 2, 1, 1, 3), dir_num_layers=2,
               epn_mlps=((8, 8), (24, 24)), dir_num_heads=4, unet_nsamples=(8, 40, 16, 16, 16))


@torch.no_grad()
def test_etchnet_head_size_6_and_40_neighbours_match_jax():
    """EtchConfig with a 24-wide last EPN block and 4 direction heads (head
    size 6) and 40 neighbours at the second U-Net level (past the kernel's
    old 32): the port's forward on the CPU against JAX EtchNet's XLA paths,
    weights converted, with tests/test_torch_model.py's tolerances."""
    jm, variables, tm = paired_nets(2, 11, **WIDE_KW)
    pts = capsule(6, 2, N_WIDE)
    ref = jax_apply(jm, variables, pts, train=False)
    out = tm(torch.from_numpy(pts))
    _close_forward(out, ref)
