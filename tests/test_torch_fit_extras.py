"""PyTorch port vs JAX package: the fit's extras on the CPU.

  - `levenberg_marquardt_with_history` reproduces the Theseus oracle's
    residual-norm trace (tests/fixtures/lm_trace.npz), by the statements of
    tests/test_lm_trace.py, and `levenberg_marquardt` ends where it does.
  - `fit_smpl` (markers from inner points, the two-stage LM, the full SMPL
    forward) on a well-posed problem: 86 markers of the synthetic body,
    each the top-3 of four labelled inner points; vertices and joints within
    1e-3 of JAX's (tests/test_torch_pipeline.py's fit tolerance).
  - `GMMPrior` / `synthetic_gmm` / `load_gmm_prior`: the NLL equal to JAX's
    within 1e-5 relative, and tests/test_train.py::test_gmm_prior.
  - `fit_smpl_adam` (40 + 80 steps) and `chamfer_refine` (15 iterations,
    one-way and both ways, with the prior) against JAX from the same
    inputs: parameters within 2e-5 and the final loss within 1e-5 relative
    (f32 sums in another order over a short Adam run: measured at most
    2.5e-6 on the parameters).  The scan points lie off the body's
    vertices, where sqrt's gradient is finite.  Both ways, between 15 and
    20 iterations one scan point's nearest vertex flips between JAX's
    ranking (qq + ss - 2 q.s) and the port's direct difference (ROADMAP C,
    near-ties), after which the two Adam paths part by 1e-3.
  - `point_mesh_distance`: tests/test_ops_extra.py's statements, and the
    distances and their gradients to the points and the vertices on the
    synthetic body at k=8 against JAX within 1e-5.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.body import smpl as jsmpl
from etch_tpu_torch.body import smpl as tsmpl

TRACE = os.path.join(os.path.dirname(__file__), "fixtures", "lm_trace.npz")
NUM_POSE, N_BETAS = 69, 10


@pytest.fixture(scope="module")
def bodies():
    return jsmpl.synthetic_body_model(n_verts=300), tsmpl.synthetic_body_model(n_verts=300)


def _true_params(seed=3, B=1):
    rng = np.random.RandomState(seed)
    return {"betas": (rng.randn(B, 10) * 0.5).astype(np.float32),
            "pose": (rng.randn(B, 69) * 0.05).astype(np.float32),
            "orient": np.tile(np.float32([[0.1, -0.2, 0.15]]), (B, 1)),
            "transl": np.tile(np.float32([[0.05, 0.1, -0.08]]), (B, 1))}


def test_lm_history_matches_theseus_trace(bodies):
    from etch_tpu_torch.fit.lm import levenberg_marquardt, levenberg_marquardt_with_history

    data = np.load(TRACE)
    target = torch.from_numpy(data["target"].astype(np.float32))[None]
    mask = torch.from_numpy(data["valid"].astype(np.float32)[:, None])[None]
    sub = tsmpl.marker_submodel(bodies[1], np.linspace(0, 299, 86).astype(np.int32))

    def residual(n_free):
        def fn(x, tgt, m):
            betas = torch.cat([x[NUM_POSE:NUM_POSE + n_free], x.new_zeros(N_BETAS - n_free)])
            fwd = tsmpl.marker_forward(sub, betas[None], x[None, :NUM_POSE],
                                       x[None, NUM_POSE + n_free:NUM_POSE + n_free + 3],
                                       x[None, NUM_POSE + n_free + 3:])[0]
            return ((tgt - fwd) * m).reshape(-1)
        return fn

    with torch.no_grad():
        x0 = torch.zeros((1, NUM_POSE + 2 + 6))
        x_s0, norms0 = levenberg_marquardt_with_history(residual(2), x0, (target, mask), 30,
                                                        0.5, 0.01)
        x1 = torch.cat([x_s0[:, :NUM_POSE + 2], torch.zeros((1, N_BETAS - 2)),
                        x_s0[:, NUM_POSE + 2:]], 1)
        x_s1, norms1 = levenberg_marquardt_with_history(residual(N_BETAS), x1, (target, mask),
                                                        50, 0.2, 1e-3)
        plain = levenberg_marquardt(residual(N_BETAS), x1, (target, mask), 50, 0.2, 1e-3)
    assert norms0.shape == (1, 31) and norms1.shape == (1, 51)
    np.testing.assert_allclose(norms0[0].numpy(), data["norms_stage0"], rtol=1e-4, atol=2e-5,
                               err_msg="stage-0 residual trace diverges from the Theseus oracle")
    np.testing.assert_allclose(norms1[0].numpy(), data["norms_stage1"], rtol=1e-4, atol=2e-5,
                               err_msg="stage-1 residual trace diverges from the Theseus oracle")
    np.testing.assert_allclose(x_s1[0].numpy(), data["x_final_stage1"], atol=5e-3)
    assert torch.equal(plain, x_s1)


def test_fit_smpl_matches_jax(bodies):
    from etch_tpu.fit.smpl_fit import fit_smpl as jax_fit_smpl
    from etch_tpu_torch.fit.smpl_fit import fit_smpl

    jbody, tbody = bodies
    vids = np.linspace(0, 299, 86).astype(np.int32)
    p = _true_params()
    markers = np.asarray(jsmpl.marker_forward(jsmpl.marker_submodel(jbody, vids), p["betas"],
                                              p["pose"], p["orient"], p["transl"]))[0]
    rng = np.random.RandomState(4)
    inner = (np.repeat(markers, 4, 0) + rng.randn(86 * 4, 3) * 2e-3).astype(np.float32)[None]
    labels = np.repeat(np.arange(86), 4)[None].astype(np.int32)
    conf = rng.rand(1, 86 * 4, 1).astype(np.float32)
    want = jax_fit_smpl(jbody, vids, jnp.asarray(inner), jnp.asarray(labels), jnp.asarray(conf))
    with torch.no_grad():
        got = fit_smpl(tbody, vids, torch.from_numpy(inner), torch.from_numpy(labels),
                       torch.from_numpy(conf))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)   # markers
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))            # valid
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-3)    # vertices
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]), atol=1e-3)    # joints
    assert set(got[1]) == set(want[1])


def test_gmm_prior_matches_jax(tmp_path):
    from etch_tpu.fit import prior as jprior
    from etch_tpu_torch.fit import prior as tprior

    pose = np.random.RandomState(0).randn(4, 69).astype(np.float32) * 0.3
    got = tprior.synthetic_gmm()(torch.from_numpy(pose)).numpy()
    np.testing.assert_allclose(got, np.asarray(jprior.synthetic_gmm()(jnp.asarray(pose))),
                               rtol=1e-5)
    # tests/test_train.py::test_gmm_prior: far poses are less likely
    g = tprior.synthetic_gmm()
    assert (g(torch.ones((2, 69)) * 3.0) > g(torch.zeros((2, 69)))).all()
    # a gmm_08.pkl-shaped file, read by both
    rng = np.random.RandomState(1)
    a = rng.randn(3, 69, 69) * 0.1
    data = {"means": rng.randn(3, 69) * 0.1, "weights": np.array([0.5, 0.3, 0.2]),
            "covars": np.einsum("cij,ckj->cik", a, a) + np.eye(69)[None] * 0.5}
    path = tmp_path / "gmm.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    got = tprior.load_gmm_prior(str(path))(torch.from_numpy(pose)).numpy()
    np.testing.assert_allclose(got, np.asarray(jprior.load_gmm_prior(str(path))(pose)),
                               rtol=1e-5)


def test_fit_smpl_adam_matches_jax(bodies):
    from etch_tpu.fit.adam import fit_smpl_adam as jax_adam
    from etch_tpu_torch.fit.adam import fit_smpl_adam

    jbody, tbody = bodies
    vids = np.linspace(0, 299, 86).astype(np.int32)
    p = _true_params(B=2)
    p["pose"][1] *= -1.0
    markers = np.asarray(jsmpl.marker_forward(jsmpl.marker_submodel(jbody, vids), p["betas"],
                                              p["pose"], p["orient"], p["transl"]))
    valid = np.ones((2, 86), bool)
    valid[1, :5] = False
    want = jax_adam(jsmpl.marker_submodel(jbody, vids), jnp.asarray(markers),
                    jnp.asarray(valid), steps_stage0=40, steps_stage1=80, use_mean_shape=True)
    got = fit_smpl_adam(tsmpl.marker_submodel(tbody, vids), torch.from_numpy(markers.copy()),
                        torch.from_numpy(valid), steps_stage0=40, steps_stage1=80,
                        use_mean_shape=True)
    assert set(got) == set(want)
    for k in ("pose", "betas", "global_orient", "transl"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-5, err_msg=k)
    np.testing.assert_allclose(float(got["final_loss"]), float(want["final_loss"]), rtol=1e-5)


@pytest.mark.parametrize("bidirectional", [False, True], ids=["one_way", "both_ways"])
def test_chamfer_refine_matches_jax(bodies, bidirectional):
    from etch_tpu.fit.chamfer_refine import chamfer_refine as jax_refine
    from etch_tpu.fit.prior import synthetic_gmm as jax_gmm
    from etch_tpu_torch.fit.chamfer_refine import chamfer_refine
    from etch_tpu_torch.fit.prior import synthetic_gmm

    jbody, tbody = bodies
    p = _true_params()
    verts, _ = jsmpl.smpl_forward(jbody, p["betas"], p["pose"], p["orient"], p["transl"])
    rng = np.random.RandomState(5)
    scan = (np.asarray(verts[0])[rng.choice(300, 200, replace=False)]
            + rng.randn(200, 3) * 5e-3).astype(np.float32)     # off the vertices
    init = [np.zeros((1, n), np.float32) for n in (69, 10, 3, 3)]
    # unjitted: jit traces the body model's `parents`, which its forward
    # needs concrete (the JAX package calls it with no model argument)
    want = jax_refine.__wrapped__(jbody, jnp.asarray(scan), *map(jnp.asarray, init),
                                  prior=jax_gmm(), iterations=15, bidirectional=bidirectional)
    got = chamfer_refine(tbody, torch.from_numpy(scan), *map(torch.from_numpy, init),
                         prior=synthetic_gmm(), iterations=15, bidirectional=bidirectional)
    assert set(got) == set(want)
    for k in ("pose", "betas", "orient", "transl"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-5, err_msg=k)
    np.testing.assert_allclose(float(got["final_loss"]), float(want["final_loss"]), rtol=1e-5)
    assert float(got["final_loss"]) < 0.5 * float(np.linalg.norm(scan, axis=1).mean())


def test_point_mesh_distance_statements_and_jax(bodies):
    from etch_tpu.ops.point_mesh import point_mesh_distance as jax_pmd
    from etch_tpu_torch.ops.point_mesh import point_mesh_distance

    # tests/test_ops_extra.py: a unit right triangle, and points on faces
    verts = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]])
    pts = torch.tensor([[[0.25, 0.25, 0.5], [2.0, 0.0, 0.0], [-1.0, -1.0, 0.0]]])
    d = point_mesh_distance(pts, verts, np.array([[0, 1, 2]]), k=1)
    np.testing.assert_allclose(d[0].numpy(), [0.5, 1.0, np.sqrt(2)], atol=1e-5)
    rng = np.random.RandomState(2)
    v = rng.randn(1, 10, 3).astype(np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    on = np.einsum("fk,fkc->fc", rng.dirichlet([1, 1, 1], size=3).astype(np.float32),
                   v[0][faces])[None]
    d = point_mesh_distance(torch.from_numpy(on), torch.from_numpy(v), faces, k=3)
    np.testing.assert_allclose(d[0].numpy(), 0.0, atol=1e-5)

    # the synthetic body at k=8, distances and gradients against JAX
    jbody, tbody = bodies
    body_v = np.asarray(jbody.v_template)[None].repeat(2, 0)
    body_v[1] *= 1.1
    q = (body_v[:, rng.choice(300, 64)] + rng.randn(2, 64, 3) * 0.02).astype(np.float32)
    faces = np.asarray(jbody.faces)
    jfn = lambda a, b: jax_pmd(a, b, jnp.asarray(faces), k=8)
    want = np.asarray(jfn(q, body_v))
    jgq, jgv = jax.grad(lambda a, b: jfn(a, b).sum(), argnums=(0, 1))(q, jnp.asarray(body_v))
    tq = torch.from_numpy(q).requires_grad_(True)
    tv = torch.from_numpy(body_v.copy()).requires_grad_(True)
    got = point_mesh_distance(tq, tv, faces, k=8)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jgq), atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv), atol=1e-5)
