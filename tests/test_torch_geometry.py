"""PyTorch port vs JAX package: geometry constants, SO(3) maps and the
synthetic body model.

The numpy copies (anchors, intra adjacency, kernel points, synthetic body)
must be bit-equal.  The torch SO(3) maps run the same f32 algorithm in the
same operation order; tolerances allow f32 rounding only (1e-5 absolute on
unit-scale rotation entries, 1e-6 for the closed-form maps, 5e-5 for the
projection of ill-conditioned inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.body.smpl import synthetic_body_model as jax_body
from etch_tpu.geometry import get_anchors, get_intra_idx, get_kernel_points
from etch_tpu.geometry.so3 import project_to_so3 as jax_project
from etch_tpu.geometry.so3 import quaternion_to_matrix as jax_quat
from etch_tpu.geometry.so3 import rodrigues as jax_rodrigues
from etch_tpu_torch.body.smpl import synthetic_body_model as torch_body
from etch_tpu_torch.geometry import icosahedral, kernel_points, so3


def test_anchors_and_intra_idx_bit_equal():
    for k in (1, 20, 60):
        np.testing.assert_array_equal(icosahedral.get_anchors(k), get_anchors(k))
    np.testing.assert_array_equal(icosahedral.get_intra_idx(), get_intra_idx())


@pytest.mark.parametrize("kernel_size", [1, 2, 3])
def test_kernel_points_bit_equal(kernel_size):
    for radius in (0.08, 0.11313708498984763, 0.16):
        np.testing.assert_array_equal(
            kernel_points.get_kernel_points(radius, kernel_size),
            get_kernel_points(radius, kernel_size, layout="reference"))


def test_synthetic_body_bit_equal():
    ref, port = jax_body(n_verts=300), torch_body(n_verts=300)
    for name in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    assert port.parents == tuple(int(p) for p in np.asarray(ref.parents))
    np.testing.assert_array_equal(port.faces, ref.faces)
    np.testing.assert_array_equal(port.landmark_ids, ref.landmark_ids)


def test_project_to_so3_matches_jax():
    rng = np.random.RandomState(0)
    # chordal means of anchor sets (the direction head's inputs) and noise
    w = rng.rand(64, 60).astype(np.float32)
    C = np.concatenate([
        (w @ get_anchors().reshape(60, 9)).reshape(64, 3, 3),
        rng.randn(64, 3, 3).astype(np.float32),
    ])
    ref = np.asarray(jax_project(jnp.asarray(C)))
    out = so3.project_to_so3(torch.from_numpy(C)).numpy()
    # 5e-5: random weights over the whole group nearly cancel (the group's
    # matrices sum to zero) and noise can put K's top two eigenvalues close
    # together; there the adjugate column amplifies f32 rounding
    np.testing.assert_allclose(out, ref, atol=5e-5)
    np.testing.assert_allclose(out @ out.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), out.shape), atol=1e-5)


def test_rodrigues_and_quaternion_match_jax():
    rng = np.random.RandomState(1)
    aa = np.concatenate([rng.randn(50, 3), 1e-9 * rng.randn(5, 3),
                         np.zeros((3, 3))]).astype(np.float32)
    np.testing.assert_allclose(so3.rodrigues(torch.from_numpy(aa)).numpy(),
                               np.asarray(jax_rodrigues(jnp.asarray(aa))), atol=1e-6)
    q = rng.randn(40, 4).astype(np.float32)
    np.testing.assert_allclose(so3.quaternion_to_matrix(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_quat(jnp.asarray(q))), atol=1e-6)


def _rand_rots(n, seed=0):
    from scipy.spatial.transform import Rotation

    return Rotation.random(n, random_state=seed).as_matrix().astype(np.float32)


def test_so3_conversions_match_jax():
    """The rest of `geometry/so3.py` against the JAX package on the same
    inputs: the SVD projection (det < 0 cases included), the weighted
    chordal mean, and the axis-angle, quaternion and 6D conversions;
    within 1e-5 (f32 rounding on unit-scale entries), quaternions up to
    their canonical sign."""
    from etch_tpu.geometry import so3 as jso3

    rng = np.random.RandomState(7)
    C = rng.randn(64, 3, 3).astype(np.float32)
    C[:8, :, 2] *= -1.0
    R = _rand_rots(16)
    aa = (rng.randn(16, 3) * 0.8).astype(np.float32)
    aa[0] = 0.0                                      # the small-angle branch
    Rs = _rand_rots(10, seed=3)[None].repeat(2, 0)
    w = rng.rand(2, 10).astype(np.float32)
    d6 = rng.randn(8, 6).astype(np.float32)
    cases = [
        ("project_to_so3_svd", (C,), 2e-5),
        ("so3_mean", (Rs,), 1e-5),
        ("so3_mean", (Rs, w), 1e-5),
        ("rotation_matrix_to_axis_angle", (np.array(jso3.rodrigues(aa)),), 1e-5),
        ("matrix_to_quaternion", (R,), 1e-5),
        ("rotation_6d_to_matrix", (d6,), 1e-5),
    ]
    for name, args, atol in cases:
        got = getattr(so3, name)(*(torch.from_numpy(a) for a in args)).numpy()
        want = np.asarray(getattr(jso3, name)(*(jnp.asarray(a) for a in args)))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=atol, err_msg=name)


def test_so3_statements_of_the_jax_tests():
    """tests/test_so3.py's statements, on the port: the Davenport and SVD
    projections agree, round trips return their inputs, and a one-hot
    weighted mean selects its rotation."""
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(7)
    C = torch.from_numpy(rng.randn(64, 3, 3).astype(np.float32))
    C[:8, :, 2] *= -1.0
    np.testing.assert_allclose(so3.project_to_so3(C).numpy(),
                               so3.project_to_so3_svd(C).numpy(), atol=2e-4)
    aa = torch.from_numpy((np.random.RandomState(1).randn(16, 3) * 0.8).astype(np.float32))
    np.testing.assert_allclose(so3.rotation_matrix_to_axis_angle(so3.rodrigues(aa)).numpy(),
                               aa.numpy(), atol=1e-4)
    R = torch.from_numpy(_rand_rots(16))
    np.testing.assert_allclose(so3.quaternion_to_matrix(so3.matrix_to_quaternion(R)).numpy(),
                               R.numpy(), atol=1e-5)
    assert (so3.matrix_to_quaternion(R)[:, 0] >= 0).all()
    np.testing.assert_allclose(
        so3.rotation_6d_to_matrix(torch.cat([R[:, 0], R[:, 1]], -1)).numpy(), R.numpy(),
        atol=1e-5)
    Rs = torch.from_numpy(_rand_rots(5)[None])
    w = torch.tensor([[0.0, 0, 10.0, 0, 0]])
    np.testing.assert_allclose(so3.so3_mean(Rs, w)[0].numpy(), Rs[0, 2].numpy(), atol=1e-4)
    base = _rand_rots(1)[0]
    perturb = Rotation.from_rotvec(np.random.RandomState(3).randn(10, 3) * 0.05).as_matrix()
    Rs = torch.from_numpy(np.einsum("nij,jk->nik", perturb, base)[None].astype(np.float32))
    np.testing.assert_allclose(so3.so3_mean(Rs)[0].numpy(), base, atol=0.05)
