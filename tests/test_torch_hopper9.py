"""The width refusals repaired in the contraction bodies and the vector
attention, and the Hopper designs of ball query and the C == 1 body, on the
port's CPU side.

The kernels run only on the card (tests/test_torch_kernels_cuda.py); here
each design is emulated in numpy and held to the plain version and to the
JAX package, and the wrappers' geometry is held to every width the
reference takes:

  - ball query (`csrc/knn.cu:ball_query_kernel`): a group of G lanes a
    query, G consecutive supports a step, 32 steps a chunk into each lane's
    hit mask, the chunk's steps with hits merged in order (a hit's slot from
    the group's ballot: cnt + the hits of the lanes below), the stop after
    the chunk that reaches nsample, tiles padded with points at infinity,
    then the repeat-fill: indices equal to `ball_query_torch`'s and to the
    JAX package's `_ball_query_xla`.
  - the C == 1 body (`csrc/interconv.cu:interconv_w_kernel`): its expanded
    form of the weights, in float32 on signed 1-channel features at conv1's
    radius and sigma, within the f32 gate (1e-5 max|t|) of the direct form
    in float64, and rounded to bf16 within the card's bf16 gate of the plain
    version on bf16 rows.
  - the geometry of every repaired width: kernel_size 1-3, C in 1..72 and nn
    up to 300 accepted by the contraction wrappers' checks (and the padding
    of rows off the bodies' grain giving the plain result), any nn in the
    C == 1 body, vector attention widths up to 2048 (the wide kernel's
    shared memory, its fragment packing of W0 and W1, the padding of c off
    the multiples of 8).
  - the port against the JAX package at tiny widths with 66 kernel points,
    6- and 12-channel EPN convs, and U-Net planes that are not multiples of
    8, with tests/test_torch_model.py's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.ops.ball_query import _ball_query_xla
from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.nn import interconv, vector_attention
from etch_tpu_torch.nn.bf16 import BF16
from etch_tpu_torch.ops.ball_query import ball_query_torch, radius_sq
from etch_tpu_torch.ops.knn import pairwise_sqdist
from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
from torch_parity import (_bf16_gate, _close_forward,
                          _radius_without_boundary_pairs, capsule, jax_apply, paired_nets)

F32 = np.float32


# --- ball query: the group ballot ----------------------------------------------

def _ball_query_groups(q, s, radius, nsample, G, tile):
    """csrc/knn.cu:ball_query_kernel for clouds q (B, M, 3), s (B, N, 3):
    per query a group of G lanes; a tile of `tile` supports padded with
    points at infinity to whole chunks of 32 steps; in a chunk, lane l's
    32-bit mask marks the steps u whose support u G + l is a hit by the
    direct-difference d2 < r2; then the steps with a hit anywhere in the
    group are merged in order: a hit's slot is cnt plus the hits of the
    lanes below it, slots from nsample on are dropped, cnt grows by the
    step's hits; the group stops after the chunk in which cnt reaches
    nsample; then the row is repeat-filled from its min(cnt, nsample) hits,
    or zeroed for an empty ball."""
    B, M, N = q.shape[0], q.shape[1], s.shape[1]
    span = 32 * G
    assert tile % span == 0
    r2 = F32(radius_sq(radius))
    d2 = pairwise_sqdist(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    out = np.zeros((B, M, nsample), np.int32)
    for b in range(B):
        for m in range(M):
            row = np.full(nsample, -1, np.int64)
            cnt, done = 0, False
            for t0 in range(0, N, tile):
                if done:
                    break
                tcnt = min(tile, N - t0)
                dt = np.full(-(-tcnt // span) * span, np.inf, F32)   # padding: never a hit
                dt[:tcnt] = d2[b, m, t0:t0 + tcnt]
                for c0 in range(0, len(dt), span):
                    if done:
                        break
                    hit = dt[c0:c0 + span].reshape(32, G) < r2       # [step u, lane]
                    masks = [sum(int(hit[u, lane]) << u for u in range(32)) for lane in range(G)]
                    anyh = 0
                    for mk in masks:
                        anyh |= mk
                    while anyh:
                        u = (anyh & -anyh).bit_length() - 1
                        step = [(mk >> u) & 1 for mk in masks]
                        for lane in range(G):
                            if step[lane]:
                                slot = cnt + sum(step[:lane])
                                if slot < nsample:
                                    row[slot] = t0 + c0 + u * G + lane
                        cnt += sum(step)
                        anyh &= anyh - 1
                    done = cnt >= nsample
            cnt = min(cnt, nsample)
            for j in range(cnt, nsample):
                row[j] = 0 if cnt == 0 else row[j % cnt]
            out[b, m] = row
    return out


def _ball_cloud(seed, B, M, N):
    g = np.random.RandomState(seed)
    return (g.uniform(-0.5, 0.5, (B, M, 3)).astype(F32),
            g.uniform(-0.5, 0.5, (B, N, 3)).astype(F32))


# (name, B, M, N, candidate radii, nsample): empty balls, partial ones, full
# ones, nsample above N; N = 301 is no multiple of any G or of a tile
_BALLS = {
    "empty": (2, 20, 301, (0.01, 0.012, 0.015), 8),
    "partial": (2, 30, 301, (0.1, 0.11, 0.12), 64),
    "full": (2, 30, 301, (0.3, 0.31, 0.32), 16),
    "nsample above N": (1, 25, 301, (0.6, 0.62, 0.65), 400),
    "one cloud, nsample 33": (1, 40, 301, (0.2, 0.21, 0.22), 33),
}


@pytest.mark.parametrize("case", list(_BALLS))
@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_ball_query_group_ballot_matches_plain_and_xla(G, case):
    """The group-ballot compaction, its stop at nsample and its fill give
    ball_query_torch's indices and the JAX package's `_ball_query_xla`'s
    (radii without a pair within 2e-6 of their boundary, where the XLA
    path's expanded distances could round the other way)."""
    B, M, N, radii, nsample = _BALLS[case]
    q, s = _ball_cloud(G + M, B, M, N)
    r = _radius_without_boundary_pairs(q, s, radii)
    out = _ball_query_groups(q, s, r, nsample, G, tile=max(64, 32 * G))
    ref = ball_query_torch(torch.from_numpy(q), torch.from_numpy(s), r, nsample).numpy()
    np.testing.assert_array_equal(out, ref)
    xla = np.asarray(_ball_query_xla(jnp.asarray(q), jnp.asarray(s), r, nsample))
    np.testing.assert_array_equal(out, xla)
    if case == "empty":
        assert (out == 0).any()


# --- the C == 1 body's expanded form -------------------------------------------

def _c1_expanded(x, f, rk, sigma):
    """t = sum_n w f over offsets x (P, nn, 3) and 1-channel features f (P,
    nn, A) in float32, as interconv_w_kernel<T, true> evaluates it: per
    column a = 2 r s, c = 1 - |r|^2 s (s = 1 / sigma in f32); per neighbour
    xx = |x|^2 s; u = fma(x, a_x, fma(y, a_y, fma(z, a_z, c))); w = max(u -
    xx, 0); acc = fma(w, f[n, a], acc), each fma rounded once (through
    float64), neighbours in order."""
    A = f.shape[-1]
    K = rk.shape[0] // A
    s = F32(1) / F32(sigma)
    r = rk.astype(F32)
    a = (F32(2) * r * s).astype(F32)
    c = (F32(1) - (r * r).sum(-1, dtype=F32) * s).astype(F32)
    xx = ((x * x).sum(-1, dtype=F32) * s).astype(F32)
    acc = np.zeros((x.shape[0], len(r)), F32)
    for n in range(x.shape[1]):
        u = c[None]
        for i in (2, 1, 0):
            u = (x[:, n, i:i + 1].astype(np.float64) * a[:, i] + u).astype(F32)
        w = np.maximum((u - xx[:, n:n + 1]).astype(F32), F32(0))
        fe = np.repeat(f[:, n], K, axis=-1)                     # (P, A*K): column a*K + k
        acc = (w.astype(np.float64) * fe + acc).astype(F32)
    return acc


def _conv1_inputs(seed, P=2500, c=100, nn=64):
    """conv1's geometry: the 2500 points of the first block on a body-sized
    capsule, c centers, nn neighbours at conv1's radius, sigma; signed
    1-channel features."""
    spec = backbone_plan(EtchConfig(num_point=5000, batch_size=8))[0][1]
    g = np.random.RandomState(seed)
    xyz = capsule(g, 1, P)
    ctr = xyz[:, :c].copy()
    nbr = ball_query_torch(torch.from_numpy(ctr), torch.from_numpy(xyz), spec["radius"], nn)
    rk = np.einsum("aij,kj->aki", get_anchors(60),
                   get_kernel_points(spec["radius"], spec["kernel_size"])).reshape(-1, 3)
    feats = g.randn(1, P, 60).astype(F32)
    return xyz, ctr, nbr, rk.astype(F32), spec["sigma"], feats


@pytest.mark.parametrize("seed", [0, 1])
def test_c1_expanded_form_within_the_f32_gate(seed):
    """Signed 1-channel features make t cancel; the expanded form in float32
    stays within 1e-5 max|t| of the direct form in float64 (with room: a
    tenth of the gate), so the kernel builds on it."""
    xyz, ctr, nbr, rk, sigma, feats = _conv1_inputs(seed)
    idx = nbr[0].long().numpy()
    x = xyz[0][idx] - ctr[0][:, None, :]                         # (c, nn, 3)
    f = feats[0][idx]                                             # (c, nn, A)
    out = _c1_expanded(x, f, rk, sigma)
    d2 = ((x.astype(np.float64)[:, :, None] - rk[None, None].astype(np.float64)) ** 2).sum(-1)
    w = np.maximum(1 - d2 / sigma, 0)                             # (c, nn, A*K)
    exact = (w * np.repeat(f, 24, axis=-1).astype(np.float64)).sum(1)
    scale = np.abs(exact).max()
    assert scale > 0
    assert np.abs(out - exact).max() <= 1e-6 * scale


def test_c1_expanded_form_within_the_bf16_gate():
    """On bf16 rows the kernel rounds its f32 sums to bf16: within the card's
    bf16 gate of the plain version (exact f32 weights, f32 sums, t rounded
    to bf16)."""
    xyz, ctr, nbr, rk, sigma, feats = _conv1_inputs(2)
    fb = torch.from_numpy(feats).to(BF16)
    idx = nbr[0].long().numpy()
    x = xyz[0][idx] - ctr[0][:, None, :]
    out = torch.from_numpy(_c1_expanded(x, fb.float().numpy()[0][idx], rk, sigma)).to(BF16)
    ref = interconv.interconv_t_c1_torch(torch.from_numpy(xyz), torch.from_numpy(ctr), nbr,
                                         fb, torch.from_numpy(rk), sigma, 60)
    _bf16_gate(out, ref.reshape(out.shape))


# --- the wrappers' geometry at every repaired width --------------------------------

_KERNEL_POINTS = {1: 24, 2: 30, 3: 66}


@pytest.mark.parametrize("kernel_size", [1, 2, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_contraction_geometry_takes_every_width(kernel_size, bf16):
    """kernel_size 1-3, every C in 1..72 and balls up to 300 neighbours:
    the checks accept them, the rows run at C padded to the body's grain
    (a multiple of 8, or of 4 in f32) and the block fits shared memory."""
    K = _KERNEL_POINTS[kernel_size]
    assert get_kernel_points(0.1, kernel_size).shape[0] == K
    for C in range(1, 73):
        Cp = interconv.padded_channels(C, bf16)
        assert Cp >= C and Cp % (8 if bf16 else 4) == 0 and Cp - C < (8 if bf16 else 4)
        for nn in (1, 16, 63, 64, 65, 192, 193, 262, 300):
            if bf16:
                interconv.check_mma_geometry(nn, K, C)
                assert interconv.mma_smem_bytes(nn, K, C) <= 227 * 1024
            else:
                interconv.check_tf32_geometry(nn, C)
                assert interconv.tf32_smem_bytes(nn, C) <= 227 * 1024


def test_bf16_body_shared_memory_at_the_request_widths_is_unchanged():
    """At nn = 64 and K = 24 the ring of 64-neighbour chunks is the whole
    ball, so the bf16 body's block keeps its earlier size (42.2 KB at C =
    32, 75 KB at C = 64), and balls of 262 at C = 64 (which needed 318,784
    bytes) now take 79 KB."""
    assert interconv.mma_smem_bytes(64, 24, 32) == 20 * 64 + 4 * 2 * 64 * 40 * 2
    assert interconv.mma_smem_bytes(64, 24, 64) == 20 * 64 + 4 * 2 * 64 * 72 * 2
    assert interconv.mma_smem_bytes(262, 24, 64) == 20 * 272 + 4 * 2 * 64 * 72 * 2


@pytest.mark.parametrize("nn", [1, 64, 904, 905, 5000])
@pytest.mark.parametrize("kernel_size", [1, 3])
def test_c1_and_occupancy_geometry_takes_any_neighbours(nn, kernel_size):
    """The C == 1 body and the occupancy conv stage 64 neighbours at a time:
    their shared memory stops growing at 64 (the C == 1 body refused nn >
    904 before)."""
    K = _KERNEL_POINTS[kernel_size]
    for feat in (False, True):
        assert interconv.w_smem_bytes(nn, 60, K, feat) == interconv.w_smem_bytes(
            min(nn, 64), 60, K, feat) <= 227 * 1024


@pytest.mark.parametrize("C", [2, 3, 5, 6, 12, 20])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_padded_rows_give_the_plain_contraction(C, dtype):
    """Rows padded with zero channels to the body's grain, contracted and
    sliced back, give the contraction of the rows themselves (the padded
    channels' t is their own, never mixed in)."""
    g = np.random.RandomState(C)
    xyz = torch.from_numpy(g.uniform(-0.5, 0.5, (2, 200, 3)).astype(F32))
    ctr = xyz[:, :30].contiguous()
    nbr = ball_query_torch(ctr, xyz, 0.3, 32)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(60), get_kernel_points(0.3, 1))
                          .reshape(-1, 3).astype(F32))
    feats = torch.from_numpy(g.randn(2, 200, 60 * C).astype(F32)).to(dtype)
    Cp = interconv.padded_channels(C, dtype == BF16)
    rows = interconv.pad_channels(feats, 60, C, Cp)
    assert rows.shape == (2, 200, 60 * Cp)
    assert torch.equal(rows.reshape(2, 200, 60, Cp)[..., :C], feats.reshape(2, 200, 60, C))
    assert not rows.reshape(2, 200, 60, Cp)[..., C:].any()
    out = interconv.interconv_t_torch(xyz, ctr, nbr, rows, rk, 0.045, 60)[..., :C]
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk, 0.045, 60)
    if dtype == BF16:
        assert (out.float() - ref.float()).abs().max() <= 1e-2 * ref.float().abs().max()
    else:
        assert (out - ref).abs().max() <= 1e-6 * ref.abs().max()


def _va_widths():
    """Every vector-attention width up to 2048 the reference takes: cs = c
    // 8 dividing c."""
    return [c for c in range(8, 2049) if c % (c // 8) == 0]


@pytest.mark.parametrize("ns", [3, 8, 16, 48])
def test_vector_attention_geometry_takes_every_width(ns):
    """Every c up to 2048 with cs = c // 8 dividing it, at 3, 8, 16 and 48
    neighbours: accepted, padded to a multiple of 8, and a warp of the wide
    kernel (cs above 64) fits shared memory."""
    widths = _va_widths()
    assert 12 in widths and 1024 in widths and 2048 in widths
    for c in widths:
        cs = c // 8
        c8, wide = vector_attention.va_geometry(ns, c, cs)
        assert c8 % 8 == 0 and 0 <= c8 - c < 8
        assert wide == (cs > 64 or c8 > 512)
        if wide:
            assert vector_attention.wide_warp_bytes(ns, cs) <= 227 * 1024


@pytest.mark.parametrize("c,cs", [(64, 8), (520, 65), (1024, 128), (600, 75), (2048, 256)])
def test_wide_fragment_packing_is_exact(c, cs):
    """pack_fragments: each lane's B fragment of W0 holds the weights of the
    channels its w fragment forms (k16 step 2 (c32 / 32) + s: lane t's
    channels c32 + 8t + 4s + {0, 1} in b0 and + {2, 3} in b1), and W1's the
    standard m16n8k16 layout; every weight lands once, the padding is 0."""
    g = np.random.RandomState(cs)
    w0 = torch.from_numpy(g.randn(c, cs).astype(F32))
    w1 = torch.from_numpy(g.randn(cs, cs).astype(F32))
    f0, f1 = vector_attention.pack_fragments(w0, w1)
    nta, k1 = -(-cs // 8), -(-(-(-cs // 8)) // 2)
    f0 = f0.reshape(-1, nta, 32, 4)
    f1 = f1.reshape(k1, nta, 32, 4)
    r0 = torch.zeros(f0.shape[0] * 16, nta * 8, dtype=BF16)
    r1 = torch.zeros(k1 * 16, nta * 8, dtype=BF16)
    for lane in range(32):
        gg, t = lane >> 2, lane & 3
        for v in range(4):
            for kk in range(f0.shape[0]):
                c32, s = 32 * (kk // 2), kk % 2
                r0[c32 + 8 * t + 4 * s + v, gg::8] = f0[kk, :, lane, v]
            r1[2 * t + (v & 1) + 8 * (v >> 1) + 16 * torch.arange(k1)[:, None],
               torch.arange(nta) * 8 + gg] = f1[:, :, lane, v]
    assert torch.equal(r0[:c, :cs], w0.to(BF16)) and not r0[c:].any() and not r0[:, cs:].any()
    assert torch.equal(r1[:cs, :cs], w1.to(BF16)) and not r1[cs:].any() and not r1[:, cs:].any()


@pytest.mark.parametrize("c", [12, 20, 36])
def test_vector_attention_padded_channels_change_nothing(c):
    """Rows off the multiples of 8 padded with zero channels (a0's scale and
    shift 0 there, W0's rows 0): the plain version on the padded rows, its
    padded outputs dropped, equals it on the rows themselves."""
    g = np.random.RandomState(c)
    B, N, ns, cs = 2, 30, 8, c // 8
    t = lambda *shape: torch.from_numpy(g.randn(*shape).astype(F32))
    args = [t(B * N, c).to(BF16), t(B, N, c).to(BF16), t(B, N, c).to(BF16),
            torch.from_numpy(g.randint(0, N, (B, N, ns)).astype(np.int32)),
            t(B * N, ns, c).to(BF16), torch.stack([t(c).abs() + 0.5, t(c)]), t(c, cs),
            torch.stack([t(cs).abs() + 0.5, t(cs)]), t(cs, cs), t(cs)]
    c8, wide = vector_attention.va_geometry(ns, c, cs)
    assert c8 > c and not wide
    padded = list(args)
    for i in (0, 1, 2, 4, 5):
        padded[i] = vector_attention.pad_rows(args[i], c8)
    padded[6] = vector_attention.pad_rows(args[6].t(), c8).t()
    out = vector_attention.vector_attention_torch(*padded)[:, :c]
    ref = vector_attention.vector_attention_torch(*args)
    assert (out - ref).abs().max() <= 1e-6 * ref.abs().max()


# --- the network at the repaired widths, against JAX -------------------------------

N_TINY = 192
TINY_KW = dict(num_point=N_TINY, batch_size=2, unet_blocks=(1, 2, 1, 1, 1), dir_num_layers=2)
_NETS = {
    "66 kernel points": dict(epn=dict(input_num=128, kernel_size=3)),
    "6- and 12-channel convs": dict(epn_mlps=((6, 12), (12, 12))),
    "U-Net planes off the multiples of 8": dict(unet_planes_magnitude=(12, 20, 20, 36, 36),
                                                unet_planes_confidence=(20, 12, 20, 20, 36)),
}


@torch.no_grad()
@pytest.mark.parametrize("variant", list(_NETS))
def test_etchnet_repaired_widths_match_jax(variant):
    """EtchConfig.tiny with 66 kernel points (EPNConfig(kernel_size=3)), with
    an EPN schedule of 6- and 12-channel convs, and with U-Net planes of
    12, 20 and 36: the port's forward on the CPU against JAX EtchNet's XLA
    paths, weights converted, with tests/test_torch_model.py's
    tolerances."""
    jm, variables, tm = paired_nets(3, 13, **TINY_KW, **_NETS[variant])
    pts = capsule(8, 2, N_TINY)
    ref = jax_apply(jm, variables, pts, train=False)
    out = tm(torch.from_numpy(pts))
    _close_forward(out, ref)
