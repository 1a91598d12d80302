"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no jax, so it runs on a machine without it (run there with
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py`;
tests/conftest.py imports jax).  Every test takes the `cuda` fixture, which
skips when torch sees no CUDA device (the decision is made at test time, not
at import).  Small shapes; main-path shapes are checked by chip_smoke.py.

Index outputs must be equal (both sides compute direct-difference squared
distances in the same rounding order); the inter-conv outputs agree to
1e-5 * max|t| (f32 sums in another order)."""

import importlib

import numpy as np
import pytest
import torch

from etch_tpu_torch import _build
from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.kernel_points import get_kernel_points
from etch_tpu_torch.nn import interconv

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


@pytest.mark.parametrize("C", [4, 8, 32, 64])
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


def test_wrappers_refuse_bad_inputs(cuda):
    xyz, ctr, nbr, feats, rk, sigma = _conv_inputs(cuda, 8)
    strided = feats.transpose(0, 1).contiguous().transpose(0, 1)   # same shape, not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        interconv.interconv_t_cuda(xyz, ctr, nbr, strided, rk, sigma, 60)
    with pytest.raises(TypeError):
        knn.knn_cuda(xyz.double(), xyz.double(), 4)
    with pytest.raises(ValueError):
        interconv.interconv_t_cuda(xyz, ctr, nbr, feats.cpu(), rk, sigma, 60)
