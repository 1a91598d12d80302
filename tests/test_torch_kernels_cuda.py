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
(|diff| / (|plain| + 1e-2)) <= 1e-3."""

import importlib

import numpy as np
import pytest
import torch

from etch_tpu_torch import _build
from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.models.etch_net import DirectionHead, init_params
from etch_tpu_torch.nn import attention, dircore, grouped_head, interconv, vector_attention

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


@pytest.mark.parametrize("k", [1, 3, 8, 16, 20])
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


def test_interconv_t_bf16_refuses_unsupported_widths(cuda):
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, 4)
    with pytest.raises(ValueError, match="C in"):
        interconv.interconv_t_cuda(xyz, ctr, nbr, feats.to(torch.bfloat16), rk, sigma, 60)


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
