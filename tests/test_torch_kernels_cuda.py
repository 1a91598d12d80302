"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no jax, so it runs on a machine without it (run there with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py`;
tests/conftest.py imports jax).  Every test takes the `cuda` fixture, which
skips when torch sees no CUDA device (the decision is made at test time, not
at import).  Small shapes; main-path shapes are checked by chip_smoke.py.

Index outputs must be equal (both sides compute direct-difference squared
distances in the same rounding order); the f32 inter-conv outputs agree to
1e-5 * max|t| (f32 sums in another order; the contraction's 3xTF32 products
also with a float64 plain version).  The bf16 kernels round at the
same points as their plain versions and differ in summation order only,
which can move a value across a bf16 rounding boundary now and then:
max |kernel - plain| <= 1e-2 * max|plain| and a median relative error
(|diff| / (|plain| + 1e-2)) <= 1e-3.  The fused instance norm takes its
float64 statistics in another summation order than its plain twin and
rounds once to f32: within one f32 ulp of the twin at every element, and
equal at 99.9% of them."""

import importlib
import math

import numpy as np
import pytest
import torch

from etch_tpu_torch import _build
from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.models.etch_net import DirectionHead, init_params
from etch_tpu_torch.nn import attention, dircore, epn, grouped_head, interconv, vector_attention
from etch_tpu_torch.ops.grouping import gather_points

# the modules themselves: etch_tpu_torch.ops re-exports same-named functions
ball_query = importlib.import_module("etch_tpu_torch.ops.ball_query")
fps = importlib.import_module("etch_tpu_torch.ops.fps")
knn = importlib.import_module("etch_tpu_torch.ops.knn")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are built with nvcc for sm_90a)")
    return torch.device("cuda", 0)


def _cloud(dev, B, N, seed):
    g = np.random.RandomState(seed)
    return torch.from_numpy(g.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)).to(dev)


def test_fps_kernel(cuda):
    xyz = _cloud(cuda, 3, 1500, 0)
    before = _build.launches["fps"]
    out = fps.fps(xyz, 400)
    assert _build.launches["fps"] == before + 1
    assert torch.equal(out, fps.fps_torch(xyz, 400))


@pytest.mark.parametrize("N,m", [(19, 5), (78, 19), (312, 78), (1000, 250), (1250, 312),
                                 (3000, 300), (4000, 300), (5000, 1250), (6000, 300),
                                 (8192, 300), (8193, 300)])
def test_fps_kernel_points_a_thread(cuda, N, m):
    """Every register instance (1, 2, 4, 6, 8, 10, 12 and 16 points a
    thread of up to 512 threads) and the device-memory instance just above
    8192 points."""
    xyz = _cloud(cuda, 2, N, N)
    assert torch.equal(fps.fps_cuda(xyz, m), fps.fps_torch(xyz, m))


def test_fps_kernel_lattice_ties(cuda):
    """A lattice ties at every step: the smaller index must win each tie."""
    g = np.stack(np.meshgrid(*[np.arange(12, dtype=np.float32) * 0.1] * 3, indexing="ij"), -1)
    xyz = torch.from_numpy(g.reshape(1, -1, 3)).to(cuda)
    assert torch.equal(fps.fps_cuda(xyz, 500), fps.fps_torch(xyz, 500))


def test_fps_kernel_any_n(cuda):
    """20,000 points, past the register instance: the cloud and its running
    minimum stream from device memory, and the indices still equal
    fps_torch's."""
    xyz = _cloud(cuda, 2, 20000, 11)
    before = _build.launches["fps"]
    out = fps.fps(xyz, 2000)
    assert _build.launches["fps"] == before + 1
    assert torch.equal(out, fps.fps_torch(xyz, 2000))


@pytest.mark.parametrize("k", [1, 3, 8, 16, 20, 33, 48, 100])
def test_knn_kernel(cuda, k):
    q, s = _cloud(cuda, 2, 700, 1), _cloud(cuda, 2, 1500, 2)
    idx, d2 = knn.knn_cuda(q, s, k)
    ridx, rd2 = knn.knn_torch(q, s, k)
    assert torch.equal(idx, ridx)
    assert torch.equal(d2, rd2)


def test_knn_kernel_ties_go_to_smaller_index(cuda):
    s = torch.zeros((1, 40, 3), device=cuda)          # all supports coincide
    q = torch.zeros((1, 5, 3), device=cuda)
    idx, _ = knn.knn_cuda(q, s, 8)
    assert torch.equal(idx.cpu(), torch.arange(8, dtype=torch.int32).expand(1, 5, 8))


def _capsules(dev, B, N, seed):
    """Body-scan-like clouds, as chip_smoke.py's (points on a vertical capsule)."""
    g = np.random.RandomState(seed)
    z, th = g.uniform(-0.9, 0.9, (B, N)), g.uniform(0, 2 * np.pi, (B, N))
    r = 0.15 + 0.03 * np.cos(3 * z)
    return torch.from_numpy(np.stack([r * np.cos(th), r * np.sin(th), z], -1).astype(np.float32)).to(dev)


# a request's kNN shapes (k, queries, supports), as chip_smoke.py times them:
# each U-Net level's self neighbours, the down neighbours of levels 1-4, the
# up 3-NN of levels 0-3 (5000 x 1250 k = 3 also propagates the EPN's features)
_LV = (5000, 1250, 312, 78, 19)
_KNN_REQUEST = ([(8, 5000, 5000), (16, 1250, 5000), (3, 5000, 1250)]
                + [(16, _LV[l], _LV[l]) for l in range(1, 5)]
                + [(16, _LV[l], _LV[l - 1]) for l in range(2, 5)]
                + [(3, _LV[l], _LV[l + 1]) for l in range(1, 4)])


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("k,M,N", _KNN_REQUEST)
def test_knn_kernel_request_shapes(cuda, B, k, M, N):
    """Every shape a request launches kNN at, at B = 1 (the latency
    request, where the lane groups are widest) and B = 8: indices and
    squared distances equal knn_torch's."""
    q, s = _capsules(cuda, B, M, k + M), _capsules(cuda, B, N, k + N + 1)
    idx, d2 = knn.knn_cuda(q, s, k)
    ridx, rd2 = knn.knn_torch(q, s, k)
    assert torch.equal(idx, ridx)
    assert torch.equal(d2, rd2)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("k,M,N", [(33, 1250, 5000), (48, 1250, 5000), (48, 312, 1250),
                                   (64, 78, 312), (19, 19, 19), (48, 48, 48)])
def test_knn_kernel_many_neighbours(cuda, B, k, M, N):
    """k above one register list (32): passes of 32, each after the last
    (d2, index) of the one before, up to k = N."""
    q, s = _capsules(cuda, B, M, k + 7), _capsules(cuda, B, N, k + 8)
    before = _build.launches["knn"]
    idx, dist = knn.knn(q, s, k)
    assert _build.launches["knn"] == before + 1
    ridx, rd2 = knn.knn_torch(q, s, k)
    assert torch.equal(idx, ridx)
    assert torch.equal(dist, torch.sqrt(rd2))


@pytest.mark.parametrize("k", [8, 33, 48])
def test_knn_kernel_ties_at_any_k(cuda, k):
    """A lattice (every query on a lattice point, many supports at exactly
    equal distances) and duplicated points: ties go to the smaller index
    within and across the lanes of a group and across passes."""
    g = np.stack(np.meshgrid(*[np.arange(8, dtype=np.float32) * 0.125] * 3, indexing="ij"), -1)
    lat = g.reshape(-1, 3)
    s = np.concatenate([lat, lat[::7]])[np.random.RandomState(k).permutation(len(lat) + 74)]
    s = torch.from_numpy(np.ascontiguousarray(s)).to(cuda)[None].repeat(2, 1, 1).contiguous()
    q = s[:, :300].contiguous()
    idx, d2 = knn.knn_cuda(q, s, k)
    ridx, rd2 = knn.knn_torch(q, s, k)
    assert torch.equal(idx, ridx)
    assert torch.equal(d2, rd2)
    zeros = torch.zeros((1, 100, 3), device=cuda)
    idx, _ = knn.knn_cuda(zeros[:, :5].contiguous(), zeros, k)
    assert torch.equal(idx.cpu(), torch.arange(k, dtype=torch.int32).expand(1, 5, k))


@pytest.mark.parametrize("offset", [1.0, 100.0, 3000.0])
def test_knn_kernel_far_from_origin(cuda, offset):
    """Clouds far from the origin, where the prefilter's expanded form
    cancels most: its proven margin (csrc/knn.cu:bound_adjust) loses no
    neighbour."""
    q, s = _capsules(cuda, 2, 1250, 3) + offset, _capsules(cuda, 2, 5000, 4) + offset
    for k in (3, 16, 40):
        idx, d2 = knn.knn_cuda(q, s, k)
        ridx, rd2 = knn.knn_torch(q, s, k)
        assert torch.equal(idx, ridx)
        assert torch.equal(d2, rd2)


@pytest.mark.parametrize("nsample", [4, 64])
def test_ball_query_kernel(cuda, nsample):
    q, s = _cloud(cuda, 2, 300, 3), _cloud(cuda, 2, 2500, 4)
    for r in (0.02, 0.1, 0.3):    # mostly empty, partial and full balls
        out = ball_query.ball_query_cuda(q, s, r, nsample)
        assert torch.equal(out, ball_query.ball_query_torch(q, s, r, nsample))


def _conv_inputs(dev, C, P=600, c=100, nn=32, radius=0.2, seed=5):
    xyz = _cloud(dev, 2, P, seed)
    ctr = xyz[:, :c].contiguous()
    nbr = ball_query.ball_query_cuda(ctr, xyz, radius, nn)
    kp = get_kernel_points(radius, 1)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3).copy())
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((2, P, 60 * C), device=dev, generator=g) if C else None
    return xyz, ctr, nbr, feats, rk.to(dev), 0.5 * radius ** 2


@pytest.mark.parametrize("C", [4, 8, 32, 64, 68, 128, 256])
def test_interconv_t_kernel(cuda, C):
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, C)
    out = interconv.interconv_t_cuda(xyz, ctr, nbr, feats, rk, sigma, 60)
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_interconv_ones_kernel(cuda):
    xyz, ctr, nbr, _, rk, sigma = _conv_inputs(cuda, 0)
    out = interconv.interconv_ones_cuda(xyz, ctr, nbr, rk, sigma, 60)
    ref = interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sigma, 60)
    assert ref.abs().max() > 0
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def _close_bf16(out, ref):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    assert err.max() <= 1e-2 * ref.abs().max(), err.max()
    assert (err / (ref.abs() + 1e-2)).median() <= 1e-3


def _as_accurate_bf16(out, plain, exact):
    """Where bf16 rounding flips are so common that a change of summation
    order alone misses _close_bf16's median criterion (the direction core at
    E = 256), the kernel's bf16 result is held to be as accurate as its plain
    twin's: its error against the unrounded f32 function at most
    chip_smoke.AS_ACCURATE times the twin's, in the median and the max."""
    import chip_smoke
    got, twin, ok = chip_smoke.as_accurate(out.float(), plain.float(), exact.float())
    assert ok, (got, twin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interconv_t_c1_kernel(cuda, dtype):
    """1-channel rows: the dispatcher launches the C == 1 body."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, 1)
    feats = feats.to(dtype)
    before = _build.launches["interconv_t_c1"]
    out = interconv.interconv_t(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert _build.launches["interconv_t_c1"] == before + 1
    ref = interconv.interconv_t_c1_torch(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert out.shape == ref.shape == (2, 100, 60, 24, 1) and out.dtype == dtype
    if dtype == torch.float32:
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("C", [8, 32, 72, 128, 256])
def test_interconv_t_bf16_kernel(cuda, C):
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, C)
    fb = feats.to(torch.bfloat16)
    before = _build.launches["interconv_t_bf16"]
    out = interconv.interconv_t(xyz, ctr, nbr, fb, rk, sigma, 60)
    assert _build.launches["interconv_t_bf16"] == before + 1
    assert out.dtype == torch.bfloat16
    _close_bf16(out, interconv.interconv_t_torch(xyz, ctr, nbr, fb, rk, sigma, 60))


def test_interconv_ones_proj_kernel(cuda):
    xyz, ctr, nbr, _, rk, sigma = _conv_inputs(cuda, 0)
    w = torch.randn((24, 32), device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    out = interconv.interconv_ones_proj_cuda(xyz, ctr, nbr, rk, sigma, 60, w)
    ref = interconv.interconv_ones_proj_torch(xyz, ctr, nbr, rk, sigma, 60, w)
    assert out.shape == ref.shape == (2, 100, 60, 32) and out.dtype == torch.bfloat16
    _close_bf16(out, ref)


@pytest.mark.parametrize("c", [512, 452])
def test_interconv_ones_proj_request_chunks(cuda, c):
    """conv0 of a request: 512-center chunks of the 2500 FPS centers of a
    5000-point cloud and the ragged last one (452), 64 neighbours, Co = 32,
    against the plain version by the bf16 criterion."""
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
    spec = backbone_plan(EtchConfig(num_point=5000, batch_size=2))[0][0]
    xyz = _capsules(cuda, 2, 5000, 9)
    ctr = gather_points(xyz, fps.fps_cuda(xyz, 2500))[:, :c].contiguous()
    nn, radius, sigma = spec["n_neighbor"], spec["radius"], spec["sigma"]
    nbr = ball_query.ball_query_cuda(ctr, xyz, radius, nn)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), get_kernel_points(radius, 1))
                          .reshape(-1, 3).copy()).to(cuda)
    w = torch.randn((24, spec["dim_out"]), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(c)) * 0.3
    before = _build.launches["interconv_ones_proj"]
    out = interconv.interconv_ones_proj(xyz, ctr, nbr, rk, sigma, 60, w)
    assert _build.launches["interconv_ones_proj"] == before + 1
    assert out.shape == (2, c, 60, spec["dim_out"]) and out.dtype == torch.bfloat16
    _close_bf16(out, interconv.interconv_ones_proj_torch(xyz, ctr, nbr, rk, sigma, 60, w))


@pytest.mark.parametrize("Co", [1, 8, 32, 40, 64])
@pytest.mark.parametrize("kernel_size", [1, 2, 3])
def test_interconv_ones_proj_widths(cuda, Co, kernel_size):
    """Projections to 1 (an EPN schedule whose first conv has one channel), 8
    and 40 (no 16-byte rows: element stores) and 64 channels; 30 kernel
    points (kernel_size 2) padded to 32, and 66 (kernel_size 3: 3960
    columns, two rounds of a thread's columns)."""
    xyz, ctr, nbr, _, _, sigma = _conv_inputs(cuda, 0)
    kp = get_kernel_points(0.2, kernel_size)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3).copy()).to(cuda)
    w = torch.randn((kp.shape[0], Co), device=cuda, generator=torch.Generator(cuda).manual_seed(Co))
    out = interconv.interconv_ones_proj_cuda(xyz, ctr, nbr, rk, sigma, 60, w)
    assert out.shape == (2, 100, 60, Co)
    _close_bf16(out, interconv.interconv_ones_proj_torch(xyz, ctr, nbr, rk, sigma, 60, w))


def _dircore_params(dev, E, V, seed=3):
    g = np.random.RandomState(seed)
    p = {}
    for l in (0, 1):
        for nm in ("wq", "wk", "wv"):
            p[f"{nm}{l}"] = g.randn(E, E) / np.sqrt(E)
    p["wc0"], p["bc0"] = g.randn(E, E) / np.sqrt(E), 0.1 * g.randn(E)
    p["wc1"], p["bc1"] = g.randn(E, V) / np.sqrt(E), 0.1 * g.randn(V)
    p["wm0"], p["bm0"] = g.randn(V, V) / np.sqrt(V), 0.1 * g.randn(V)
    p["wm1"], p["bm1"] = g.randn(V, V) / np.sqrt(V), 0.1 * g.randn(V)
    p["wr"], p["br"] = g.randn(V, 1) / np.sqrt(V), 0.1 * g.randn(1)
    return {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in p.items()}


def _check_dircore(out, tok, params, H):
    """The core's bf16 criterion: _close_bf16 against the plain twin up to
    E = 128, _as_accurate_bf16 above (at E = 256 the twin itself, summed in
    float64 instead of f32, moves by a median relative of about 1e-3 on
    such random weights, against 1e-7 at E = 128:
    tools/torch_bf16_card_vs_cpu.py)."""
    plain = dircore.direction_core_torch(tok, params, H)
    if tok.shape[-1] <= 128:
        _close_bf16(out, plain)
    else:
        _as_accurate_bf16(out, plain, dircore.direction_core_torch(tok.float(), params, H))


@pytest.mark.parametrize("E,V,H", [(64, 128, 8), (8, 16, 2), (128, 128, 8), (256, 128, 8),
                                   (64, 256, 8), (256, 256, 2), (64, 128, 2), (96, 128, 6)])
def test_dircore_kernel(cuda, E, V, H):
    params = _dircore_params(cuda, E, V)
    tok = torch.from_numpy(np.random.RandomState(0).randn(37, 60, E).astype(np.float32))
    tok = tok.to(cuda, torch.bfloat16)
    before = _build.launches["dircore"]
    out = dircore.direction_core(tok, params, H, chunk=16)
    assert _build.launches["dircore"] == before + 1
    _check_dircore(out, tok, params, H)


@pytest.mark.parametrize("E,V,H", [(48, 128, 8), (24, 64, 8), (40, 128, 5), (48, 128, 2),
                                   (256, 128, 1), (200, 128, 1), (512, 128, 8),
                                   (512, 512, 8), (320, 256, 5), (128, 512, 8),
                                   (96, 128, 2), (480, 128, 10)])
def test_dircore_kernel_any_heads_and_widths(cuda, E, V, H):
    """Head sizes the kernels do not compile (6, 3, 8 of 40, 24, 200) run
    padded by zero columns in the head layout; heads of 48 and 208 columns,
    which do not tile the padded width, at E = 128, 256 and 512 (the
    instance for multiples of 16 that are no power of two); one head of
    256 (16 k16 steps); E and V up to 512 (the wide core's weights read from the L2,
    tokens beyond its registers spilled; E = 128 with V = 512 runs at the
    512-wide instance)."""
    params = _dircore_params(cuda, E, V)
    tok = torch.from_numpy(np.random.RandomState(E + H).randn(200, 60, E).astype(np.float32))
    tok = tok.to(cuda, torch.bfloat16)
    before = _build.launches["dircore"]
    out = dircore.direction_core(tok, params, H, chunk=64)
    assert _build.launches["dircore"] == before + 1
    assert out.shape == (200, 60) and torch.isfinite(out).all()
    _check_dircore(out, tok, params, H)


def test_dircore_kernel_per_head_softmax(cuda):
    """One head's logits thousands of nats above the others' must not wipe
    them out: a single row max over all heads underflows their exponentials,
    0 / 0 -> NaN.  Head 0's own softmax is then so sharp that bf16 rounding
    legitimately moves it, so the property checked is a finite result."""
    params = _dircore_params(cuda, 64, 128)
    tok = np.random.RandomState(4).randn(8, 60, 64).astype(np.float32)
    params["wq0"][:, :8] *= 40.0
    params["wk0"][:, :8] *= 40.0
    tok = torch.from_numpy(tok).to(cuda, torch.bfloat16)
    assert torch.isfinite(dircore.direction_core_cuda(tok, params, 8)).all()


def _qkv(dev, Bc, L, E, H, seed=0):
    g = np.random.RandomState(seed)
    q = g.randn(Bc, L, E) / np.sqrt(E // H)
    return [torch.tensor(a, dtype=torch.float32, device=dev).to(torch.bfloat16)
            for a in (q, g.randn(Bc, L, E), g.randn(Bc, L, E))]


@pytest.mark.parametrize("E,H", [(64, 8), (8, 2), (24, 4), (32, 1)])
def test_attention_kernel(cuda, E, H):
    q, k, v = _qkv(cuda, 37, 60, E, H)
    before = _build.launches["attention"]
    out = attention.attention(q, k, v, H)
    assert _build.launches["attention"] == before + 1
    assert out.dtype == torch.float32
    _close_bf16(out, attention.attention_torch(q, k, v, H))


def test_attention_kernel_extreme_head_gap(cuda):
    """Head 0's logits ~1e3 above the others' stay finite (per-head max)."""
    q, k, v = _qkv(cuda, 8, 60, 64, 8, seed=4)
    q[..., :8] *= 40
    k[..., :8] *= 40
    out = attention.attention_cuda(q, k, v, 8)
    assert torch.isfinite(out).all()
    _close_bf16(out[..., 8:], attention.attention_torch(q, k, v, 8)[..., 8:])


def test_attention_refuses_bad_inputs(cuda):
    q, k, v = _qkv(cuda, 4, 60, 64, 8)
    with pytest.raises(TypeError):
        attention.attention_cuda(q.float(), k, v, 8)
    with pytest.raises(ValueError):
        attention.attention_cuda(q, k, v, 7)
    q, k, v = _qkv(cuda, 4, 65, 64, 8)     # more tokens than one 64-row tile
    with pytest.raises(ValueError, match="L <= 64"):
        attention.attention_cuda(q, k, v, 8)


@pytest.mark.parametrize("hs,E", [(1, 64), (2, 64), (3, 24), (4, 64), (6, 24), (8, 64),
                                  (16, 64), (32, 64), (64, 64), (128, 128), (2, 256),
                                  (3, 192), (32, 256), (128, 256)])
@pytest.mark.parametrize("M", [1, 133, 2048])
def test_attention_kernel_head_sizes(cuda, M, hs, E):
    """Every head-size route of the kernel (masked 8-column tiles, one head
    a tile, zero-padded heads, k16 steps) at point counts below, near and
    above one group of a block.  M = 1 is 64 launches of one point each,
    checked together: one point's outputs are too few for the median
    criterion, which a single bf16 rounding flip moves."""
    H = E // hs
    n = 64 if M == 1 else M
    q, k, v = _qkv(cuda, n, 60, E, H, seed=hs + M)
    before = _build.launches["attention"]
    out = torch.cat([attention.attention_cuda(q[s:s + M], k[s:s + M], v[s:s + M], H)
                     for s in range(0, n, M)])
    assert _build.launches["attention"] == before + n // M
    assert out.shape == (n, 60, E)
    _close_bf16(out, attention.attention_torch(q, k, v, H))


@pytest.mark.parametrize("E,H", [(256, 1), (400, 2), (512, 2), (200, 1)])
@pytest.mark.parametrize("M", [1, 133, 2048])
def test_attention_kernel_heads_above_128(cuda, M, E, H):
    """Heads of 256, 200 (padded to 208) and 256 columns two a point: one
    head a group, one point a block."""
    n = 64 if M == 1 else M
    q, k, v = _qkv(cuda, n, 60, E, H, seed=E + M)
    before = _build.launches["attention"]
    out = torch.cat([attention.attention_cuda(q[s:s + M], k[s:s + M], v[s:s + M], H)
                     for s in range(0, n, M)])
    assert _build.launches["attention"] == before + n // M
    _close_bf16(out, attention.attention_torch(q, k, v, H))


@pytest.mark.parametrize("L", [1, 20, 60, 64])
@pytest.mark.parametrize("hs,E", [(2, 64), (3, 24), (8, 64), (16, 64)])
def test_attention_kernel_key_counts(cuda, L, hs, E):
    """Every key count the configuration allows (one anchor, 20, 60, and 64
    with no padded key) on each route: masked keys start inside an 8-key
    tile at L = 1 and 20, and the zero rows of k and v end where the masked
    tiles do not."""
    H = E // hs
    q, k, v = _qkv(cuda, 133, L, E, H, seed=L + hs)
    out = attention.attention_cuda(q, k, v, H)
    assert out.shape == (133, L, E)
    _close_bf16(out, attention.attention_torch(q, k, v, H))


@torch.no_grad()
def test_chunked_direction_head_launches_attention(cuda):
    """fused_core=False: two layers of bf16 tokens run the attention kernel
    once per layer and chunk, never the fused core, and agree with the same
    head on the CPU (plain versions)."""
    head = DirectionHead(64, 128, 8, 2, chunk=16, dtype=torch.bfloat16, fused_core=False)
    init_params(head, torch.Generator().manual_seed(0))
    feat = torch.from_numpy(np.random.RandomState(2).randn(40, 60, 64).astype(np.float32))
    ref = head.anchor_weights(feat)
    head = head.to(cuda)
    before = dict(_build.launches)
    out = head.anchor_weights(feat.to(cuda))
    assert _build.launches["attention"] == before["attention"] + 2 * 3
    assert _build.launches["dircore"] == before["dircore"]
    _close_bf16(out.cpu(), ref)


def _va_inputs(dev, B, N, ns, c, s=8, seed=0):
    g = np.random.RandomState(seed)
    cs = c // s
    bf = lambda a: torch.tensor(a, dtype=torch.float32, device=dev).to(torch.bfloat16)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    xq, xk, xv = (bf(g.randn(*shape)) for shape in ((B * N, c), (B, N, c), (B, N, c)))
    idx = torch.tensor(g.randint(0, N, (B, N, ns)), dtype=torch.int32, device=dev)
    pe = bf(g.randn(B * N, ns, c))
    a0 = f32(np.stack([g.rand(c) + 0.5, g.randn(c)]))
    a1 = f32(np.stack([g.rand(cs) + 0.5, g.randn(cs)]))
    w0, w1 = f32(g.randn(c, cs) / np.sqrt(c)), f32(g.randn(cs, cs) / np.sqrt(cs))
    return xq, xk, xv, idx, pe, a0, w0, a1, w1, f32(g.randn(cs))


@pytest.mark.parametrize("B,N,ns,c", [(2, 300, 8, 64), (2, 40, 16, 512), (2, 100, 4, 8),
                                     (2, 300, 8, 128), (2, 150, 16, 128), (2, 90, 16, 256),
                                     (2, 77, 12, 64), (2, 50, 3, 24), (2, 60, 1, 16),
                                     (2, 40, 32, 64), (2, 30, 20, 384), (2, 40, 16, 320),
                                     (1, 5, 16, 512)])
def test_vector_attention_kernel(cuda, B, N, ns, c):
    """The U-Net's shapes (ns 8 and 16, c 64 to 512; 4 warps split a tile's
    channels at c = 256, 384, 512 and 2 at 320), a level with fewer points
    than neighbours (ns 12, 3, 1: padded rows), cs not a multiple of 8 (c =
    24, 16), ns > 16 (one point over several tiles) and a ragged last tile."""
    args = _va_inputs(cuda, B, N, ns, c)
    before = _build.launches["vector_attention"]
    out = vector_attention.vector_attention(*args)
    assert _build.launches["vector_attention"] == before + 1
    _close_bf16(out, vector_attention.vector_attention_torch(*args))


@pytest.mark.parametrize("R,c0", [(1000, 128), (300, 8)])
def test_grouped_head_kernel(cuda, R, c0):
    g = np.random.RandomState(1)
    k = 86
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    h = f32(g.randn(R, c0)).to(torch.bfloat16)
    args = (h, f32(g.randn(c0, c0 * k) / np.sqrt(c0)), f32(0.1 * g.randn(c0 * k)),
            f32(g.randn(k, c0) / np.sqrt(c0)), f32(0.1 * g.randn(k)))
    before = _build.launches["grouped_head"]
    out = grouped_head.grouped_head(*args)
    assert _build.launches["grouped_head"] == before + 1
    _close_bf16(out, grouped_head.grouped_head_torch(*args))


def test_wrappers_refuse_bad_inputs(cuda):
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, 8)
    strided = feats.transpose(0, 1).contiguous().transpose(0, 1)   # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        interconv.interconv_t_cuda(xyz, ctr, nbr, strided, rk, sigma, 60)
    with pytest.raises(TypeError):
        knn.knn_cuda(xyz.double(), xyz.double(), 4)
    with pytest.raises(ValueError):
        interconv.interconv_t_cuda(xyz, ctr, nbr, feats.cpu(), rk, sigma, 60)
    # a bf16 / f32 mix is refused, not converted
    args = list(_va_inputs(cuda, 1, 50, 4, 16))
    args[1] = args[1].float()
    with pytest.raises(TypeError):
        vector_attention.vector_attention_cuda(*args)
    with pytest.raises(TypeError):
        grouped_head.grouped_head_cuda(torch.zeros((4, 8), device=cuda),
                                       *(torch.zeros(s, device=cuda)
                                         for s in ((8, 16), (16,), (2, 8), (2,))))


@pytest.mark.parametrize("C", [8, 32, 64])
@pytest.mark.parametrize("c", [1, 226, 452, 512])
def test_interconv_t_bf16_ragged_chunks(cuda, C, c):
    """The tensor-core body at the widths of the tiny and full networks and
    the chunk sizes InterSO3Conv streams (512 and the ragged tails 452, 226),
    full 64-neighbour balls."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, C, c=c, nn=64, radius=0.3)
    fb = feats.to(torch.bfloat16)
    before = _build.launches["interconv_t_bf16"]
    out = interconv.interconv_t(xyz, ctr, nbr, fb, rk, sigma, 60)
    assert _build.launches["interconv_t_bf16"] == before + 1
    assert out.shape == (2, c, 60, 24, C) and out.dtype == torch.bfloat16
    _close_bf16(out, interconv.interconv_t_torch(xyz, ctr, nbr, fb, rk, sigma, 60))


def test_interconv_t_f32_keeps_the_fp32_body(cuda):
    """f32 rows launch `interconv_t` (3xTF32 on the tensor cores), never
    the bf16 body, within 1e-5 * max|t|."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, 32, nn=64, radius=0.3)
    before = dict(_build.launches)
    out = interconv.interconv_t(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert _build.launches["interconv_t"] == before["interconv_t"] + 1
    assert _build.launches["interconv_t_bf16"] == before["interconv_t_bf16"]
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("C", [4, 12])
def test_interconv_t_bf16_serves_widths_off_the_grid(cuda, C):
    """bf16 rows of 4 and 12 channels (off the body's 8-channel grid, which
    it refused before): the wrapper pads each anchor's row with zero
    channels and slices t back, within the bf16 gate of the plain version."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, C)
    fb = feats.to(torch.bfloat16)
    before = _build.launches["interconv_t_bf16"]
    out = interconv.interconv_t(xyz, ctr, nbr, fb, rk, sigma, 60)
    assert _build.launches["interconv_t_bf16"] == before + 1
    assert out.shape == (2, 100, 60, 24, C) and out.dtype == torch.bfloat16
    _close_bf16(out, interconv.interconv_t_torch(xyz, ctr, nbr, fb, rk, sigma, 60))


@pytest.mark.parametrize("E,hs", [(64, 1), (64, 2), (64, 4), (64, 8), (64, 16), (128, 1),
                                  (128, 8), (128, 16), (128, 32), (256, 2), (256, 8),
                                  (256, 32), (256, 64), (256, 128)])
@pytest.mark.parametrize("M", [1, 133, 2000])
def test_dircore_kernel_head_sizes(cuda, M, E, hs):
    """Every head size the kernel takes, at point counts below, near and
    above one point per resident group of the grid.  M = 1 is 64 launches
    of one point each, checked together: one point's 60 outputs are too few
    for the median criterion, which a single bf16 rounding flip moves."""
    params = _dircore_params(cuda, E, 128)
    n = 64 if M == 1 else M
    tok = torch.from_numpy(np.random.RandomState(M).randn(n, 60, E).astype(np.float32))
    tok = tok.to(cuda, torch.bfloat16)
    before = _build.launches["dircore"]
    out = torch.cat([dircore.direction_core_cuda(tok[s:s + M], params, E // hs)
                     for s in range(0, n, M)])
    assert _build.launches["dircore"] == before + n // M
    assert out.shape == (n, 60)
    _check_dircore(out, tok, params, E // hs)


@pytest.mark.parametrize("C", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("c", [1, 226, 452, 512])
def test_interconv_t_f32_ragged_chunks(cuda, C, c):
    """The 3xTF32 body at the widths of the tiny and full networks (C = 4
    and 8 pad one m16 tile of channels) and the chunk sizes InterSO3Conv
    streams, full 64-neighbour balls (two 32-neighbour chunks an anchor)."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, C, c=c, nn=64, radius=0.3)
    before = _build.launches["interconv_t"]
    out = interconv.interconv_t(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert _build.launches["interconv_t"] == before + 1
    assert out.shape == (2, c, 60, 24, C) and out.dtype == torch.float32
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_interconv_t_f32_against_float64(cuda):
    """conv1's geometry (512 of 2500 centers, 64 neighbours, C=32, its
    radius and sigma): the 3xTF32 products hold within 1e-5 * max|t| of a
    float64 plain version, so they are f32-accurate, not merely close to
    another f32 sum."""
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
    spec = backbone_plan(EtchConfig(num_point=5000, batch_size=8))[0][1]
    xyz = _cloud(cuda, 2, 2500, 7)
    ctr = xyz[:, :512].contiguous()
    nbr = ball_query.ball_query_cuda(ctr, xyz, spec["radius"], spec["n_neighbor"])
    kp = get_kernel_points(spec["radius"], spec["kernel_size"])
    rk = np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3)
    rk = torch.from_numpy(np.ascontiguousarray(rk)).to(cuda)
    feats = torch.randn((2, 2500, 60 * spec["dim_in"]), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(7))
    out = interconv.interconv_t_cuda(xyz, ctr, nbr, feats, rk, spec["sigma"], 60)
    ref = interconv.interconv_t_torch(xyz.double(), ctr.double(), nbr, feats.double(),
                                      rk.double(), spec["sigma"], 60)
    assert (out.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("block", [2, 3])
def test_interconv_t_f32_wide_rows_against_float64(cuda, block):
    """The 128- and 256-channel blocks of epn_layer_num=4 (their second
    convs' geometry, 128 centers): the channel slices keep the 3xTF32 body
    within 1e-5 * max|t| of a float64 plain version."""
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
    spec = backbone_plan(EtchConfig(num_point=5000, batch_size=8, epn_layer_num=4))[block][1]
    assert spec["dim_in"] == 64 * 2 ** (block - 1)
    xyz = _cloud(cuda, 2, spec["n_in"], 9)
    ctr = xyz[:, :128].contiguous()
    nbr = ball_query.ball_query_cuda(ctr, xyz, spec["radius"], spec["n_neighbor"])
    kp = get_kernel_points(spec["radius"], spec["kernel_size"])
    rk = np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3)
    rk = torch.from_numpy(np.ascontiguousarray(rk)).to(cuda)
    feats = torch.randn((2, spec["n_in"], 60 * spec["dim_in"]), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(9))
    out = interconv.interconv_t_cuda(xyz, ctr, nbr, feats, rk, spec["sigma"], 60)
    ref = interconv.interconv_t_torch(xyz.double(), ctr.double(), nbr, feats.double(),
                                      rk.double(), spec["sigma"], 60)
    assert (out.double() - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_interconv_t_f32_kernel_point_blocks(cuda, kernel_size):
    """30 kernel points (blocks of 24 and 6) and 66 (24, 24 and 18)."""
    xyz, ctr, nbr, feats, _, sigma = _conv_inputs(cuda, 8, nn=40, radius=0.3)
    kp = get_kernel_points(0.3, kernel_size)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3).copy())
    out = interconv.interconv_t_cuda(xyz, ctr, nbr, feats, rk.to(cuda), sigma, 60)
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk.to(cuda), sigma, 60)
    assert out.shape == (2, 100, 60, kp.shape[0], 8)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("C", [128, 256])
@pytest.mark.parametrize("c", [1, 128, 313])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interconv_t_wide_rows(cuda, C, c, dtype):
    """The 128- and 256-channel blocks of epn_layer_num 3 and 4 (64 centers
    of 128 at conv8 for N = 1024, 313 at N = 5000): the channel slices cover
    t (f32 within 1e-5 * max|t|, bf16 by the bf16 criterion)."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, C, P=700, c=c, nn=64, radius=0.3)
    feats = feats.to(dtype)
    name = "interconv_t_bf16" if dtype == torch.bfloat16 else "interconv_t"
    before = _build.launches[name]
    out = interconv.interconv_t(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert _build.launches[name] == before + 1
    assert out.shape == (2, c, 60, 24, C) and out.dtype == dtype
    ref = interconv.interconv_t_torch(xyz, ctr, nbr, feats, rk, sigma, 60)
    if dtype == torch.float32:
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("layers", [3, 4])
@pytest.mark.parametrize("route", ["f32", "bf16", "bf16_chunked"])
def test_deeper_epn_serves_on_the_card(cuda, layers, route):
    """EtchConfig(epn_layer_num=3 or 4), the 128- and 256-channel EPN blocks
    the reference CLI exposes (--EPN_layer_num), at num_point=1024, B=2,
    random weights: the forward and fit on the card agree with the CPU port
    (chip_smoke.py's phase-4 tolerances; in bf16, where rounding flips alone
    move the card's plain versions further from the CPU than the tiny steps'
    tolerance, as accurate as the CPU's bf16 step against the f32 one), each
    route launching its own kernels (the contraction's channel slices, the
    wide direction core or the anchor attention at E = 128 / 256) and
    raising nothing."""
    import chip_smoke
    from etch_tpu_torch.utils.config import EtchConfig
    cfg = EtchConfig(num_point=1024, batch_size=2, epn_layer_num=layers,
                     use_bfloat16=route != "f32")
    chip_smoke.small_step(torch, _build, f"epn_layer_num={layers} {route}", cfg, route,
                          fused_core=route != "bf16_chunked", full_width=True)


# the widths the JAX package takes that the card refused before: one
# direction head at epn_layer_num=4 (a head of 256), a 512-wide last EPN block,
# a head size of 6, a U-Net level with 48 neighbours
_REPAIRED = {
    "one head, layers 4, bf16": (dict(epn_layer_num=4, dir_num_heads=1, use_bfloat16=True),
                                 "bf16"),
    "one head, layers 4, bf16 chunked": (dict(epn_layer_num=4, dir_num_heads=1,
                                              use_bfloat16=True), "bf16_chunked"),
    "512-wide last block, bf16": (dict(epn_mlps=((32, 32), (512, 512)), use_bfloat16=True),
                                  "bf16"),
    "512-wide last block, bf16 chunked": (dict(epn_mlps=((32, 32), (512, 512)),
                                               use_bfloat16=True), "bf16_chunked"),
    "head size 6, bf16": (dict(epn_mlps=((32, 32), (48, 48)), use_bfloat16=True), "bf16"),
    "head size 6, bf16 chunked": (dict(epn_mlps=((32, 32), (48, 48)), use_bfloat16=True),
                                  "bf16_chunked"),
    "48 neighbours, f32": (dict(unet_nsamples=(8, 48, 16, 16, 16)), "f32"),
    "48 neighbours, bf16": (dict(unet_nsamples=(8, 48, 16, 16, 16), use_bfloat16=True),
                            "bf16"),
}


@pytest.mark.parametrize("variant", list(_REPAIRED))
def test_repaired_widths_serve_on_the_card(cuda, variant):
    """Each configuration at num_point=1024, B=2, random weights, serves on
    the card without a raise, launching its path's kernels, and is as
    accurate as the CPU: in f32 by chip_smoke.py's phase-4 tolerances, in
    bf16 as accurate as the CPU's bf16 step against the f32 one
    (AS_ACCURATE_STEP, directions included)."""
    import chip_smoke
    from etch_tpu_torch.utils.config import EtchConfig
    overrides, route = _REPAIRED[variant]
    cfg = EtchConfig(num_point=1024, batch_size=2, **overrides)
    chip_smoke.small_step(torch, _build, variant, cfg, route,
                          fused_core=route != "bf16_chunked", full_width=True)


# --- the last width refusals repaired, and the Hopper grouped head and f32
# occupancy conv ---

def _grouped_args(dev, R, c0, k, seed):
    g = np.random.RandomState(seed)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    return (f32(g.randn(R, c0)).to(torch.bfloat16), f32(g.randn(c0, c0 * k) / np.sqrt(c0)),
            f32(0.1 * g.randn(c0 * k)), f32(g.randn(k, c0) / np.sqrt(c0)), f32(0.1 * g.randn(k)))


@pytest.mark.parametrize("k", [1, 3, 86])
@pytest.mark.parametrize("c0", [8, 64, 128, 256, 512])
@pytest.mark.parametrize("R", [1, 127, 1000, 40000])
def test_grouped_head_kernel_widths(cuda, R, c0, k):
    """The wgmma / TMA kernel at ragged and full row counts, groups narrower
    than its 128-column tile (zero-padded), at it, and wider (c0 = 256 and
    512: 128-column depth slices and group n-tiles), one to 86 groups; one
    launch a call.  R = 1 is 64 launches of one row each, checked together
    (one row's k outputs are too few for the median criterion)."""
    n = 64 if R == 1 else R
    args = _grouped_args(cuda, n, c0, k, seed=R + c0 + k)
    before = _build.launches["grouped_head"]
    if R == 1:
        out = torch.cat([grouped_head.grouped_head(args[0][r:r + 1], *args[1:])
                         for r in range(n)])
    else:
        out = grouped_head.grouped_head(*args)
    assert _build.launches["grouped_head"] == before + n // R
    assert out.shape == (n, k) and out.dtype == torch.float32
    _close_bf16(out, grouped_head.grouped_head_torch(*args))


def _occupancy_inputs(dev, c, nn, seed=9):
    """conv0 of a request: the first c of the 2500 FPS centers of a
    5000-point capsule cloud, nn neighbours at conv0's radius and sigma."""
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
    spec = backbone_plan(EtchConfig(num_point=5000, batch_size=2))[0][0]
    xyz = _capsules(dev, 2, 5000, seed)
    ctr = gather_points(xyz, fps.fps_cuda(xyz, 2500))[:, :c].contiguous()
    nbr = ball_query.ball_query_cuda(ctr, xyz, spec["radius"], nn)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(),
                                    get_kernel_points(spec["radius"], 1))
                          .reshape(-1, 3).copy()).to(dev)
    return xyz, ctr, nbr, rk, spec["sigma"]


@pytest.mark.parametrize("nn", [1, 17, 64])
@pytest.mark.parametrize("c", [512, 452, 133])
def test_interconv_ones_kernel_request_chunks(cuda, c, nn):
    """The f32 occupancy conv (expanded-form weights, several centers a
    block) at conv0's full and ragged chunks and a chunk of no request, 1, 17
    and 64 neighbours: within 1e-5 * max|t| of the plain version (f32 sums
    in another order) and of the direct form summed in float64."""
    xyz, ctr, nbr, rk, sigma = _occupancy_inputs(cuda, c, nn)
    before = _build.launches["interconv_ones"]
    out = interconv.interconv_ones(xyz, ctr, nbr, rk, sigma, 60)
    assert _build.launches["interconv_ones"] == before + 1
    ref = interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sigma, 60)
    exact = interconv.interconv_ones_torch(xyz.double(), ctr.double(), nbr, rk.double(),
                                           sigma, 60)
    assert out.shape == ref.shape == (2, c, 60, 24)
    assert ref.abs().max() > 0
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert (out.double() - exact).abs().max() <= 1e-5 * exact.abs().max()


@pytest.mark.parametrize("E,V,H", [(768, 128, 8), (768, 768, 8), (1024, 128, 1),
                                   (1024, 1024, 8), (512, 128, 1), (1024, 128, 2),
                                   (960, 128, 10), (640, 256, 1)])
def test_dircore_kernel_widths_above_512(cuda, E, V, H):
    """E and V of 768 and 1024, one head of 512 at E = 512, two heads of 512
    at E = 1024, ten heads of 96 at E = 960 (no power of two), one head of
    640: the batched route (csrc/dircore_big.cu, products over chunks of
    points, the attention in 256-column slices), one launch, as accurate as
    the plain twin against the unrounded f32 function."""
    params = _dircore_params(cuda, E, V)
    tok = torch.from_numpy(np.random.RandomState(E + V + H).randn(133, 60, E)
                           .astype(np.float32)).to(cuda, torch.bfloat16)
    before = _build.launches["dircore"]
    out = dircore.direction_core(tok, params, H, chunk=64)
    assert _build.launches["dircore"] == before + 1
    assert out.shape == (133, 60) and torch.isfinite(out).all()
    _check_dircore(out, tok, params, H)


def test_dircore_big_chunks(cuda, monkeypatch):
    """The batched route over several chunks of points (its scratch cut to
    a few points' worth) gives what one chunk gives."""
    params = _dircore_params(cuda, 768, 128)
    tok = torch.from_numpy(np.random.RandomState(7).randn(70, 60, 768)
                           .astype(np.float32)).to(cuda, torch.bfloat16)
    whole = dircore.direction_core_cuda(tok, params, 8)
    monkeypatch.setattr(dircore, "_BIG_SCRATCH",
                        9 * 60 * (2 * (768 + 4 * 768 + 128) + 4 * (128 // 32)))
    assert dircore.big_chunk(70, 60, 768, 768, 128) == 9
    assert torch.equal(dircore.direction_core_cuda(tok, params, 8), whole)


@pytest.mark.parametrize("E,H", [(384, 1), (512, 1), (1024, 2), (600, 1)])
@pytest.mark.parametrize("M", [1, 133, 2048])
def test_attention_kernel_heads_above_256(cuda, M, E, H):
    """Heads of 384, 512 and 600 columns (600 padded to 608) and two heads of
    512: 256-column slices of q, k and v, the logits added over them."""
    n = 64 if M == 1 else M
    q, k, v = _qkv(cuda, n, 60, E, H, seed=E + M)
    before = _build.launches["attention"]
    out = torch.cat([attention.attention_cuda(q[s:s + M], k[s:s + M], v[s:s + M], H)
                     for s in range(0, n, M)])
    assert _build.launches["attention"] == before + n // M
    _close_bf16(out, attention.attention_torch(q, k, v, H))


_REPAIRED_8 = {
    "last block 1024, one head, bf16": (dict(epn_mlps=((32, 32), (1024, 1024)),
                                             use_bfloat16=True, dir_num_heads=1), "bf16"),
    "last block 1024, one head, bf16 chunked": (dict(epn_mlps=((32, 32), (1024, 1024)),
                                                     use_bfloat16=True, dir_num_heads=1),
                                                "bf16_chunked"),
    "last block 768, bf16": (dict(epn_mlps=((32, 32), (768, 768)), use_bfloat16=True), "bf16"),
    "confidence planes 256, bf16": (dict(unet_planes_confidence=(256, 256, 256, 256, 512),
                                         use_bfloat16=True), "bf16"),
}


@pytest.mark.parametrize("variant", list(_REPAIRED_8))
def test_widths_above_512_serve_on_the_card(cuda, variant):
    """A last EPN block of 1024 with one direction head (the fused core's
    batched route; the chunked core's attention with a 1024-column head), a
    768-wide last block, and the confidence U-Net at 256 planes (the grouped
    head at c0 = 256), at num_point=1024, B=2, random weights: as accurate
    as the CPU's bf16 step against the f32 one (AS_ACCURATE_STEP,
    directions included)."""
    import chip_smoke
    from etch_tpu_torch.utils.config import EtchConfig
    overrides, route = _REPAIRED_8[variant]
    cfg = EtchConfig(num_point=1024, batch_size=2, **overrides)
    chip_smoke.small_step(torch, _build, variant, cfg, route,
                          fused_core=route != "bf16_chunked", full_width=True)


# --- the width refusals ROADMAP C missed, and the Hopper ball query and C == 1
# body ---

def _request_balls(dev, B, seed=4):
    """The four EPN convs' ball queries of a request at batch B: (queries,
    supports, radius, nsample) of conv0 (2500 FPS centers of 5000 points),
    conv1 (2500 of 2500), conv2 (the first 1250 of 2500) and conv3 (1250 of
    1250)."""
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
    plan = backbone_plan(EtchConfig(num_point=5000, batch_size=B))
    xyz = _capsules(dev, B, 5000, seed)
    c2500 = gather_points(xyz, fps.fps_cuda(xyz, 2500)).contiguous()
    pts = {5000: xyz, 2500: c2500, 1250: c2500[:, :1250].contiguous()}
    return [(pts[sp["n_out"]], pts[sp["n_in"]], sp["radius"], sp["n_neighbor"])
            for sp in (plan[0][0], plan[0][1], plan[1][0], plan[1][1])]


@pytest.mark.parametrize("B", [1, 8])
def test_ball_query_kernel_request_shapes(cuda, B):
    """The request's four shapes at B = 1 (the widest lane groups) and B =
    8: indices equal ball_query_torch's."""
    for i, (q, s, r, ns) in enumerate(_request_balls(cuda, B)):
        before = _build.launches["ball_query"]
        out = ball_query.ball_query(q, s, r, ns)
        assert _build.launches["ball_query"] == before + 1
        assert torch.equal(out, ball_query.ball_query_torch(q, s, r, ns)), i


@pytest.mark.parametrize("nsample", [1, 33, 64, 100, 262, 3000])
@pytest.mark.parametrize("M,N", [(1, 7), (77, 300), (500, 2500)])
def test_ball_query_kernel_any_nsample(cuda, nsample, M, N):
    """nsample above 32 and above N (repeat-filled), partial, full and empty
    balls, N not a multiple of the group or the tile, one query."""
    q, s = _cloud(cuda, 2, M, nsample + M), _cloud(cuda, 2, N, nsample + N + 1)
    for r in (0.01, 0.1, 0.3, 2.0):
        assert torch.equal(ball_query.ball_query_cuda(q, s, r, nsample),
                           ball_query.ball_query_torch(q, s, r, nsample)), r


def test_ball_query_kernel_rows_in_place(cuda):
    """Rows too long for shared memory (15,000 samples) are written in place
    and still equal ball_query_torch's."""
    q, s = _cloud(cuda, 1, 40, 11), _cloud(cuda, 1, 3000, 12)
    for r in (0.05, 0.3):
        assert torch.equal(ball_query.ball_query_cuda(q, s, r, 15000),
                           ball_query.ball_query_torch(q, s, r, 15000))


def test_ball_query_kernel_ties_on_the_radius(cuda):
    """Supports at exactly the radius (a lattice, d2 == r2 in f32) are not in
    the ball; strictly inside are, in index order."""
    g = np.stack(np.meshgrid(*[np.arange(9, dtype=np.float32) * 0.125] * 3, indexing="ij"), -1)
    s = torch.from_numpy(g.reshape(1, -1, 3)).to(cuda)
    q = s[:, ::37].contiguous()
    for r in (0.125, 0.25, float(np.sqrt(np.float32(2)) * np.float32(0.125))):
        for ns in (4, 64):
            assert torch.equal(ball_query.ball_query_cuda(q, s, r, ns),
                               ball_query.ball_query_torch(q, s, r, ns))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nn", [1, 63, 65, 130, 1000])
@pytest.mark.parametrize("c", [1, 226, 512])
def test_interconv_t_c1_kernel_any_neighbours(cuda, dtype, nn, c):
    """The C == 1 body (neighbours staged 64 at a time) at chunk boundaries,
    above the old limit of 904 and at ragged chunks of centers: within the
    f32 gate (and of the direct form in float64) or the bf16 gate."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, 1, P=1200, c=c, nn=nn, radius=0.3)
    feats = feats.to(dtype)
    out = interconv.interconv_t_c1_cuda(xyz, ctr, nbr, feats, rk, sigma, 60)
    ref = interconv.interconv_t_c1_torch(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert out.shape == (2, c, 60, 24, 1) and out.dtype == dtype
    if dtype == torch.float32:
        from etch_tpu_torch.ops.grouping import group_points
        w = interconv._weights(xyz.double(), ctr.double(), nbr, rk.double(), sigma)
        exact = torch.einsum("bcnak,bcna->bcak", w.reshape(2, c, nn, 60, 24),
                             group_points(feats.double(), nbr))[..., None]
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
        assert (out.double() - exact).abs().max() <= 1e-5 * exact.abs().max()
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("kernel_size", [2, 3])
def test_interconv_t_c1_kernel_point_counts(cuda, kernel_size):
    """30 and 66 kernel points: 6-point column groups, two rounds at 66."""
    xyz, ctr, nbr, feats, _, sigma = _conv_inputs(cuda, 1, nn=64, radius=0.3)
    kp = get_kernel_points(0.3, kernel_size)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3).copy()).to(cuda)
    out = interconv.interconv_t_c1_cuda(xyz, ctr, nbr, feats, rk, sigma, 60)
    ref = interconv.interconv_t_c1_torch(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert out.shape == (2, 100, 60, kp.shape[0], 1)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("nn", [17, 64, 130])
def test_interconv_ones_kernel_streams_neighbours(cuda, nn):
    """The occupancy conv, now the C == 1 template without features, across
    one, two and three neighbour chunks."""
    xyz, ctr, nbr, rk, sigma = _occupancy_inputs(cuda, 226, nn)
    out = interconv.interconv_ones_cuda(xyz, ctr, nbr, rk, sigma, 60)
    ref = interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sigma, 60)
    assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def _rk(dev, radius, kernel_size):
    kp = get_kernel_points(radius, kernel_size)
    return torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3)
                            .copy()).to(dev)


@pytest.mark.parametrize("C", [8, 12, 32, 64, 128])
@pytest.mark.parametrize("nn", [32, 64, 262])
def test_interconv_t_bf16_kernel_point_blocks(cuda, C, nn):
    """66 kernel points (kernel_size 3: three blocks of 32 on the grid) at
    several widths and neighbour counts, within the bf16 gate."""
    xyz, ctr, nbr, feats, _, sigma = _conv_inputs(cuda, C, nn=nn, radius=0.3)
    rk = _rk(cuda, 0.3, 3)
    fb = feats.to(torch.bfloat16)
    out = interconv.interconv_t_cuda(xyz, ctr, nbr, fb, rk, sigma, 60)
    assert out.shape == (2, 100, 60, 66, C)
    _close_bf16(out, interconv.interconv_t_torch(xyz, ctr, nbr, fb, rk, sigma, 60))


@pytest.mark.parametrize("C", [32, 64, 128])
@pytest.mark.parametrize("nn", [65, 200, 262, 1000])
def test_interconv_t_bf16_many_neighbours(cuda, C, nn):
    """Balls of more than 192 neighbours at 64 channels (262: sampling_ratio
    3.2), which no longer fit whole: 64-neighbour chunks through the ring."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, C, P=1200, nn=nn, radius=0.4)
    fb = feats.to(torch.bfloat16)
    out = interconv.interconv_t_cuda(xyz, ctr, nbr, fb, rk, sigma, 60)
    _close_bf16(out, interconv.interconv_t_torch(xyz, ctr, nbr, fb, rk, sigma, 60))


@pytest.mark.parametrize("C", [1, 2, 3, 5, 6, 7, 10, 12, 20, 36, 68, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_interconv_t_any_channels(cuda, C, dtype):
    """Any channel count: rows off the body's grain run padded with zero
    channels and t is sliced back (C == 1 takes its own body)."""
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, C, nn=64, radius=0.3)
    feats = feats.to(dtype)
    out = interconv.interconv_t(xyz, ctr, nbr, feats, rk, sigma, 60)
    assert out.shape == (2, 100, 60, 24, C) and out.dtype == dtype
    ref = (interconv.interconv_t_c1_torch if C == 1 else interconv.interconv_t_torch)(
        xyz, ctr, nbr, feats, rk, sigma, 60)
    if dtype == torch.float32:
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    else:
        _close_bf16(out, ref)


@pytest.mark.parametrize("B,N,ns,c", [(2, 40, 16, 1024), (2, 30, 8, 1024), (2, 20, 48, 1024),
                                     (2, 50, 16, 12), (2, 60, 8, 20), (2, 40, 16, 528),
                                     (2, 40, 16, 520), (1, 5, 16, 1024), (2, 30, 16, 2048),
                                     (2, 20, 3, 600), (2, 40, 16, 36)])
def test_vector_attention_kernel_any_width(cuda, B, N, ns, c):
    """A U-Net level of 1024 planes (cs = 128: the wide kernel), 2048, 600,
    528 and 520 (cs 256, 75, 66, 65), and rows off the multiples of 8 (c =
    12, 20, 36: padded with zero channels)."""
    args = _va_inputs(cuda, B, N, ns, c)
    before = _build.launches["vector_attention"]
    out = vector_attention.vector_attention(*args)
    assert _build.launches["vector_attention"] == before + 1
    assert out.shape == (B * N, c)
    _close_bf16(out, vector_attention.vector_attention_torch(*args))


# the widths the JAX package takes that the card refused before this round
# (EPN options are given as EPNConfig fields, chip_smoke.deep_config)
_REPAIRED_9 = {
    "kernel_size 3, bf16": (dict(epn=dict(kernel_size=3), use_bfloat16=True), "bf16"),
    "sampling_ratio 3.2, bf16": (dict(epn=dict(sampling_ratio=3.2), use_bfloat16=True), "bf16"),
    "6- and 12-channel convs, f32": (dict(epn_mlps=((6, 12), (64, 64))), "f32"),
    "6- and 12-channel convs, bf16": (dict(epn_mlps=((6, 12), (64, 64)), use_bfloat16=True),
                                      "bf16"),
    "1024 U-Net planes, bf16": (dict(unet_planes_magnitude=(64, 128, 256, 512, 1024),
                                     use_bfloat16=True), "bf16"),
    "phase 4 variant, bf16": (None, "bf16"),
}


@pytest.mark.parametrize("variant", list(_REPAIRED_9))
def test_repaired_widths_9_serve_on_the_card(cuda, variant):
    """EPNConfig(kernel_size=3) (66 kernel points), EPNConfig(sampling_ratio=
    3.2) (262 neighbours at every conv), 6- and 12-channel EPN convs (rows
    padded to the bodies' grain) and a 1024-plane last U-Net level (the
    wide vector attention), and chip_smoke.py's phase 4 variant with all of
    them, at num_point=1024, B=2, random weights: in f32 as close to the CPU
    as the phase-4 tolerances ask; in bf16 as accurate against the CPU's f32
    step as the CPU's bf16 step (AS_ACCURATE_STEP), directions included,
    over the input seeds chip_smoke.REPAIRED_SEEDS pooled; launching the
    path's kernels and no other."""
    import chip_smoke
    overrides, route = _REPAIRED_9[variant]
    cfg = chip_smoke.deep_config(chip_smoke.REPAIRED_9 if overrides is None else overrides)
    chip_smoke.small_step(torch, _build, variant, cfg, route, full_width=True,
                          seeds=chip_smoke.REPAIRED_SEEDS)


# the EPN's conv outputs (P points, C channels) at its four published blocks,
# and a ragged one
NORM_SHAPES = [(2500, 32), (1250, 64), (625, 128), (313, 256), (313, 12)]


def _norm_inputs(dev, B, P, C, seed, offset=0):
    """x (B, P, 60, C) f32 with channel 1 constant (where C > 1), as the
    first block's skip branch is, and a residual of the same shape; x
    starts `offset` floats into its storage."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = B * P * 60 * C
    x = (torch.randn(n + offset, device=dev, generator=g) * 3 + 0.5)[offset:].view(B, P, 60, C)
    if C > 1:
        x[..., 1] = 0.37
    r = torch.randn((B, P, 60, C), device=dev, generator=g)
    return x, r


def _check_norm(x, r, residual):
    """The kernel against its plain twin: its normalised value within one
    f32 ulp of the twin's at every element (the activation, monotone, lies
    between the twin's activations of the twin's two f32 neighbours), and
    the output equal at 99.9% of the elements; with the residual, bit for
    bit the kernel's own activation plus the residual; the constant channel
    exactly 0 before the residual; two launches the same bits; one launch a
    call."""
    before = _build.launches["instance_norm"]
    act = epn.norm_act_cuda(x, 0.01)
    out = epn.norm_act_cuda(x, 0.01, r) if residual else act
    assert _build.launches["instance_norm"] == before + 1 + residual
    h = epn.instance_norm_pa(x)
    lo, hi = (torch.nn.functional.leaky_relu(torch.nextafter(h, torch.full_like(h, v)), 0.01)
              for v in (-math.inf, math.inf))
    assert ((lo <= act) & (act <= hi)).all()
    want = epn.norm_act_torch(x, 0.01, r) if residual else epn.norm_act_torch(x, 0.01)
    same = (out == want).float().mean().item()
    assert same >= 0.999, same
    if residual:
        assert torch.equal(out, r + act)
    if x.shape[-1] > 1:
        assert (act[..., 1] == 0).all()
    again = epn.norm_act_cuda(x, 0.01, r if residual else None)
    assert torch.equal(out, again)


@pytest.mark.parametrize("residual", [False, True], ids=["act", "act_residual"])
@pytest.mark.parametrize("P,C", NORM_SHAPES)
def test_instance_norm_kernel(cuda, P, C, residual):
    x, r = _norm_inputs(cuda, 2, P, C, seed=P + C)
    _check_norm(x, r, residual)


@pytest.mark.parametrize("residual", [False, True], ids=["act", "act_residual"])
@pytest.mark.parametrize("P,C,offset", [(40, 1, 0), (40, 5, 0), (40, 1027, 0), (40, 32, 1)],
                         ids=["C1", "C5", "C1027", "C32_unaligned"])
def test_instance_norm_kernel_scalar_and_wide_rows(cuda, P, C, offset, residual):
    """Channel counts off the 16-byte grain (one channel a thread), above
    256 groups a row (channel tiles), and x off 16-byte alignment."""
    x, r = _norm_inputs(cuda, 3, P, C, seed=C, offset=offset)
    _check_norm(x, r, residual)


def test_instance_norm_under_autograd_launches_nothing(cuda):
    """An input autograd records runs the plain twin: no launch, no count,
    and a gradient."""
    from etch_tpu_torch.utils import trace
    x, r = _norm_inputs(cuda, 2, 40, 32, seed=3)
    x.requires_grad_(True)
    before = _build.launches["instance_norm"]
    trace.drain()
    trace.enable()
    try:
        out = epn.norm_act(x, 0.01, r)
    finally:
        trace.disable()
    assert _build.launches["instance_norm"] == before
    assert "epn.norm_fused" not in trace.drain()[1]
    assert torch.equal(out, epn.norm_act_torch(x, 0.01, r))
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    with torch.no_grad():
        trace.enable()
        try:
            epn.norm_act(x, 0.01, r)
        finally:
            trace.disable()
    assert _build.launches["instance_norm"] == before + 1
    assert trace.drain()[1] == {"epn.norm_fused": 1}


def test_instance_norm_refuses_bad_inputs(cuda):
    x, r = _norm_inputs(cuda, 2, 8, 16, seed=4)
    with pytest.raises(TypeError):
        epn.norm_act_cuda(x.double(), 0.01)
    with pytest.raises(ValueError, match="contiguous"):
        epn.norm_act_cuda(x.transpose(1, 2), 0.01)
    with pytest.raises(ValueError):
        epn.norm_act_cuda(x, 0.01, r.cpu())
    with pytest.raises(ValueError, match="residual"):
        epn.norm_act_cuda(x, 0.01, r[:1].contiguous())
    with pytest.raises(ValueError):
        epn.norm_act_cuda(x.reshape(2, 8 * 60, 16), 0.01)
