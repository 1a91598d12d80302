"""PyTorch port vs JAX package: the scan animation on the CPU.

The statements of tests/test_animate.py on the port (mesh cleaning, the
identity and SMPL reposes, the weight transfer onto itself, the harmonic
inpainting, the stretched-face filter), then each step against the JAX
package on the same inputs: the host steps (numpy and scipy, the same code)
equal to 1e-12, the torch steps (blend transforms, reposing) within 1e-5 on
unit-scale coordinates (f32 rounding of the 4x4 solves), and the whole
`animate_scan` of the synthetic body's mesh within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import torch

from etch_tpu import animate as janimate
from etch_tpu.body.smpl import synthetic_body_model as jax_body
from etch_tpu.data.mesh import TriMesh as JTriMesh
from etch_tpu_torch import animate
from etch_tpu_torch.body.smpl import smpl_forward, synthetic_body_model
from etch_tpu_torch.data.mesh import TriMesh


def test_clean_mesh_removes_degenerates():
    v = np.random.RandomState(0).randn(6, 3)
    f = np.array([[0, 1, 2], [1, 1, 2], [0, 1, 2], [3, 4, 5]])
    out = animate.clean_mesh(TriMesh(v, f))
    assert len(out.faces) == 2 and len(out.vertices) == 6


def test_repose_identity_and_smpl():
    body = synthetic_body_model()
    zero_b, zero_p, zero_o = torch.zeros((1, 10)), torch.zeros((1, 69)), torch.zeros((1, 3))
    A = animate.blend_transforms(body, zero_b, zero_p, zero_o)[0]
    rng = np.random.RandomState(1)
    verts = torch.from_numpy(rng.randn(50, 3).astype(np.float32))
    w = rng.rand(50, 24).astype(np.float32)
    w = torch.from_numpy(w / w.sum(1, keepdims=True))
    np.testing.assert_allclose(animate.repose_vertices(verts, w, A, A).numpy(), verts.numpy(),
                               atol=1e-5)
    pose_new = torch.from_numpy(np.random.RandomState(2).randn(1, 69).astype(np.float32) * 0.1)
    A_new = animate.blend_transforms(body, zero_b, pose_new, zero_o)[0]
    rest, _ = smpl_forward(body, zero_b, zero_p, zero_o, zero_o)
    posed, _ = smpl_forward(body, zero_b, pose_new, zero_o, zero_o)
    # pure LBS cannot reproduce the pose correctives (synthetic posedirs ~1e-4)
    out = animate.repose_vertices(rest[0], body.lbs_weights, A, A_new)
    np.testing.assert_allclose(out.numpy(), posed[0].numpy(), atol=1e-3)


def test_weights_inpaint_and_filter():
    body = synthetic_body_model()
    mesh = TriMesh(body.v_template.numpy().astype(np.float64), body.faces)
    w = body.lbs_weights.numpy()
    out = animate.weights_transfer(mesh, mesh, w)
    np.testing.assert_allclose(out.sum(1), 1.0, atol=1e-6)
    assert (out * w).sum() / np.sqrt((out ** 2).sum() * (w ** 2).sum()) > 0.99
    v = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [0, 1, 0], [1, 1, 0], [2, 1, 0]], float)
    strip = TriMesh(v, np.array([[0, 1, 4], [0, 4, 3], [1, 2, 5], [1, 5, 4]]))
    wi = np.array([[1, 0], [0.0, 0], [0, 1], [1, 0], [0.5, 0.5], [0, 1]], float)
    matched = np.array([True, False, True, True, True, True])
    filled = animate.inpaint_weights(strip, wi, matched)
    assert np.isfinite(filled).all() and 0 < filled[1, 0] < 1 and 0 < filled[1, 1] < 1
    np.testing.assert_array_equal(
        filled, janimate.inpaint_weights(JTriMesh(v, strip.faces), wi, matched))
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [2, 2, 0]], float)
    f = np.array([[0, 1, 2], [1, 2, 3]])
    v2 = v.copy()
    v2[3] = [20, 20, 0]
    assert len(animate.filter_mesh(TriMesh(v2, f), TriMesh(v, f)).faces) == 1


def test_animate_matches_jax():
    """Each step and the whole animation of the synthetic body's mesh (a
    posed mesh reposed to another pose) against the JAX package."""
    jbody, body = jax_body(), synthetic_body_model()
    rng = np.random.RandomState(3)
    raw = {"betas": (rng.randn(1, 10) * 0.3).astype(np.float32),
           "body_pose": (rng.randn(1, 69) * 0.1).astype(np.float32),
           "global_orient": np.float32([[0.1, -0.2, 0.05]]),
           "transl": np.float32([[0.05, 0.0, -0.1]])}
    new_pose = (rng.randn(1, 69) * 0.1).astype(np.float32)
    posed, _ = smpl_forward(body, *(torch.from_numpy(raw[k]) for k in
                                    ("betas", "body_pose", "global_orient", "transl")))
    scan = TriMesh(posed[0].numpy().astype(np.float64) + rng.randn(300, 3) * 1e-3, body.faces)
    jscan = JTriMesh(scan.vertices, scan.faces)

    W = animate.weights_transfer(scan, scan, body.lbs_weights.numpy())
    np.testing.assert_allclose(W, janimate.weights_transfer(jscan, jscan,
                                                            np.asarray(jbody.lbs_weights)),
                               atol=1e-12)
    args = [raw["betas"], raw["body_pose"], raw["global_orient"]]
    A = animate.blend_transforms(body, *map(torch.from_numpy, args))
    jA = janimate.blend_transforms(jbody, *map(jnp.asarray, args))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), atol=1e-5)
    A_new = animate.blend_transforms(body, torch.from_numpy(raw["betas"]),
                                     torch.from_numpy(new_pose),
                                     torch.from_numpy(raw["global_orient"]))
    verts = scan.vertices.astype(np.float32)
    got = animate.repose_vertices(torch.from_numpy(verts), torch.from_numpy(W.astype(np.float32)),
                                  A[0], A_new[0])
    want = janimate.repose_vertices(jnp.asarray(verts), jnp.asarray(W, jnp.float32), jA[0],
                                    jnp.asarray(A_new[0].numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    out = animate.animate_scan(body, scan, raw, new_pose)
    ref = janimate.animate_scan(jbody, jscan, raw, jnp.asarray(new_pose))
    np.testing.assert_array_equal(out.faces, ref.faces)
    np.testing.assert_allclose(out.vertices, np.asarray(ref.vertices), atol=1e-4)
    assert 0 < len(out.faces) <= len(scan.faces)
