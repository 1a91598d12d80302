"""PyTorch port vs JAX package: point ops and the inter-conv contraction.

Integer outputs (FPS, kNN and ball-query indices) must be equal.  The JAX
CPU paths rank by the matmul form qq + ss - 2 q.s while the port (like the
TPU kernels) uses the direct difference, so the inputs are checked, in
float64, to be free of near-ties (gap > 2e-6 between the squared distances
that decide the order, and no pair within 2e-6 of the radius; the matmul
form's f32 error is below 5e-7 for coordinates in [-0.5, 0.5]).  Float
outputs allow f32 rounding of a reordered sum: 1e-5 relative to the largest
magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.geometry import get_anchors, get_kernel_points
from etch_tpu.nn.pallas_interconv import interconv_t_xla
from etch_tpu.ops import gather_points as jax_gather
from etch_tpu.ops import group_points as jax_group
from etch_tpu.ops import knn_interpolate as jax_interp
from etch_tpu.ops.ball_query import _ball_query_xla
from etch_tpu.ops.fps import _fps_xla
from etch_tpu.ops.knn import _knn_xla
from etch_tpu_torch import ops
from etch_tpu_torch.nn import interconv
from etch_tpu_torch.ops.ball_query import ball_query_torch
from etch_tpu_torch.ops.fps import fps_torch
from etch_tpu_torch.ops.knn import knn_torch

GAP = 2e-6


def _d2(q, s):
    return ((q[:, :, None, :].astype(np.float64) - s[:, None, :, :]) ** 2).sum(-1)


def _cloud(seed, B, N):
    return np.random.RandomState(seed).uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)


def _tie_free_knn_inputs(B, M, N, k):
    """First seed whose (query, support) pair has no near-tie among the
    k + 1 nearest squared distances of any query."""
    for seed in range(100):
        q, s = _cloud(seed, B, M), _cloud(seed + 1000, B, N)
        d = np.sort(_d2(q, s), axis=-1)[..., :k + 1]
        if np.diff(d, axis=-1).min() > GAP:
            return q, s
    raise AssertionError("no tie-free cloud found")


def _radius_without_boundary_pairs(q, s, candidates):
    d = _d2(q, s)
    for r in candidates:
        r2 = float(np.float32(r) * np.float32(r))
        if np.abs(d - r2).min() > GAP:
            return r
    raise AssertionError("every candidate radius has a pair on its boundary")


@pytest.fixture(scope="module")
def cloud():
    return _cloud(0, 2, 300)


def test_fps_matches_xla(cloud):
    ref = np.asarray(_fps_xla(jnp.asarray(cloud), m=100))
    out = fps_torch(torch.from_numpy(cloud), 100)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    # the public wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(ops.fps(torch.from_numpy(cloud), 100).numpy(), ref)
    np.testing.assert_array_equal(ops.fps(torch.from_numpy(cloud), 7, lazy=True).numpy(),
                                  np.broadcast_to(np.arange(7), (2, 7)))


@pytest.mark.parametrize("k", [3, 8, 16])
def test_knn_matches_xla(k):
    q, s = _tie_free_knn_inputs(2, 96, 200, k)
    ref_idx, ref_dist = _knn_xla(jnp.asarray(q), jnp.asarray(s), k)
    idx, d2 = knn_torch(torch.from_numpy(q), torch.from_numpy(s), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(np.sqrt(d2.numpy()), np.asarray(ref_dist), rtol=1e-5, atol=1e-7)
    idx2, dist2 = ops.knn(torch.from_numpy(q), torch.from_numpy(s), k)
    np.testing.assert_array_equal(idx2.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(dist2.numpy(), np.asarray(ref_dist), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("nsample", [8, 64])
def test_ball_query_matches_xla(cloud, nsample):
    q = cloud[:, :80]
    r = _radius_without_boundary_pairs(q, cloud, [0.1, 0.12, 0.15, 0.2, 0.25])
    ref = np.asarray(_ball_query_xla(jnp.asarray(q), jnp.asarray(cloud), r, nsample))
    out = ball_query_torch(torch.from_numpy(q), torch.from_numpy(cloud), r, nsample)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    # an empty ball maps to index 0; a partial ball repeat-fills
    far = np.full((1, 2, 3), 10.0, np.float32)
    np.testing.assert_array_equal(
        ops.ball_query(torch.from_numpy(far), torch.from_numpy(cloud[:1]), r, 4).numpy(), 0)


def test_gather_group_and_interpolate_match_jax(cloud):
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 300, 5).astype(np.float32)
    idx = rng.randint(0, 300, (2, 40)).astype(np.int32)
    gidx = rng.randint(0, 300, (2, 40, 6)).astype(np.int32)
    t = torch.from_numpy
    np.testing.assert_array_equal(ops.gather_points(t(feats), t(idx)).numpy(),
                                  np.asarray(jax_gather(jnp.asarray(feats), jnp.asarray(idx))))
    np.testing.assert_array_equal(ops.group_points(t(feats), t(gidx)).numpy(),
                                  np.asarray(jax_group(jnp.asarray(feats), jnp.asarray(gidx))))
    dst, src = _tie_free_knn_inputs(2, 120, 40, 3)
    src_feat = rng.randn(2, 40, 7).astype(np.float32)
    for use_sqrt in (True, False):
        ref = np.asarray(jax_interp(jnp.asarray(src), jnp.asarray(dst),
                                    jnp.asarray(src_feat), k=3, use_sqrt=use_sqrt))
        out = ops.knn_interpolate(t(src), t(dst), t(src_feat), k=3, use_sqrt=use_sqrt)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _interconv_inputs(C, seed=5):
    """A conv0-like plan at small size: 2 clouds of 200 points, 24 centers,
    12 neighbours each from the port's ball query, 60 anchors x 24 kernel
    points, radius 0.2."""
    rng = np.random.RandomState(seed)
    xyz = _cloud(seed, 2, 200)
    centers = xyz[:, :24].copy()
    radius, sigma = 0.2, 0.5 * 0.2 ** 2
    nbr = ball_query_torch(torch.from_numpy(centers), torch.from_numpy(xyz), radius, 12).numpy()
    rk = np.einsum("aij,kj->aki", get_anchors(), get_kernel_points(radius, 1)).reshape(-1, 3)
    feats = rng.randn(2, 200, 60 * C).astype(np.float32) if C else None
    return xyz, centers, nbr, feats, rk.astype(np.float32), sigma


def _jax_interconv(xyz, centers, nbr, feats, rk, sigma):
    gx = jax_group(jnp.asarray(xyz), jnp.asarray(nbr)) - jnp.asarray(centers)[:, :, None, :]
    gf2 = None if feats is None else jax_group(jnp.asarray(feats), jnp.asarray(nbr))
    return np.asarray(interconv_t_xla(gx, gf2, jnp.asarray(rk), sigma, 60))


@pytest.mark.parametrize("C", [8, 16])
def test_interconv_t_matches_xla(C):
    xyz, centers, nbr, feats, rk, sigma = _interconv_inputs(C)
    ref = _jax_interconv(xyz, centers, nbr, feats, rk, sigma)            # (B,c,A,K,C)
    t = torch.from_numpy
    for fn in (interconv.interconv_t_torch, interconv.interconv_t):
        out = fn(t(xyz), t(centers), t(nbr), t(feats), t(rk), sigma, 60).numpy()
        assert out.shape == ref.shape == (2, 24, 60, 24, C)
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_interconv_ones_matches_xla():
    xyz, centers, nbr, _, rk, sigma = _interconv_inputs(0)
    ref = _jax_interconv(xyz, centers, nbr, None, rk, sigma)[..., 0]      # (B,c,A,K)
    assert np.abs(ref).max() > 0
    t = torch.from_numpy
    for fn in (interconv.interconv_ones_torch, interconv.interconv_ones):
        out = fn(t(xyz), t(centers), t(nbr), t(rk), sigma, 60).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
