"""PyTorch port vs JAX package: the serving step `run_batch` end to end
(B=2, N=256, tiny widths, synthetic body), the LM fit from identical
markers, and the port's independence from JAX.

The JAX pipeline's random weights are converted into the port.  As in
tests/test_torch_model.py, the first block's occupancy skip conv is zeroed
in both: its instance norm of a constant is rounding noise x 316 that
neither framework can reproduce.  Tolerances:
  - network outputs: 1e-4 * (1 + max |jax|) (f32 sums in another order);
  - part labels: equal (argmax of those logits);
  - markers: 1e-4 absolute (an f32 weighted mean of inner points);
  - fit from identical markers: verts and joints to 1e-3, since 80 LM steps
    of f32 Cholesky solves amplify rounding.
The random tiny network labels every point with one or two markers, so
run_batch's own LM problem is underdetermined (80 parameters, at most 6
residuals) and damping-dominated: its solution moves by up to ~1 under f32
rounding in either framework.  run_batch's fitted body is therefore checked
for shape and finiteness only; the fit is held against JAX on a well-posed
86-marker problem in test_fit_from_identical_markers."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.body.smpl import marker_submodel as jax_marker_submodel
from etch_tpu.body.smpl import smpl_forward as jax_smpl_forward
from etch_tpu.body.smpl import synthetic_body_model as jax_body
from etch_tpu.fit.smpl_fit import fit_smpl_params as jax_fit
from etch_tpu.pipeline import InferencePipeline as JaxPipeline
from etch_tpu.pipeline import build_pipeline as jax_build
from etch_tpu.utils.config import EtchConfig as JaxConfig
from etch_tpu_torch.body.smpl import marker_submodel, smpl_forward, synthetic_body_model
from etch_tpu_torch.convert import flax_to_state_dict
from etch_tpu_torch.fit.smpl_fit import fit_smpl_params
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.utils.config import EtchConfig

N, B = 256, 2
CFG_KW = dict(num_point=N, batch_size=B)
REPO = os.path.join(os.path.dirname(__file__), "..")


def _markerset():
    return {f"M{i}": int(v) for i, v in enumerate(np.linspace(0, 6889, 86).astype(int))}


def _points(seed):
    rng = np.random.RandomState(seed)
    z = rng.uniform(-0.9, 0.9, (B, N))
    th = rng.uniform(0, 2 * np.pi, (B, N))
    r = 0.15 + 0.03 * np.cos(3 * z)
    return np.stack([r * np.cos(th), r * np.sin(th), z], -1).astype(np.float32)


@pytest.fixture(scope="module")
def pipes():
    ref = jax_build(JaxConfig.tiny(**CFG_KW), _markerset(), allow_synthetic_body=True)
    params = jax.tree_util.tree_map(np.array, ref.params)
    stats = jax.tree_util.tree_map(np.array, ref.batch_stats)
    skip = params["encoder"]["block0_conv0"]["skip_conv"]
    skip["kernel"], skip["bias"] = np.zeros_like(skip["kernel"]), np.zeros_like(skip["bias"])
    ref = JaxPipeline(ref.cfg, params, stats, ref.body_model, ref.marker_vids)
    port = build_pipeline(EtchConfig.tiny(**CFG_KW), _markerset(),
                          state_dict=flax_to_state_dict(params, stats, EtchConfig.tiny(**CFG_KW)),
                          allow_synthetic_body=True, device="cpu")
    return ref, port


def _close(out, ref, atol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= atol, f"max abs err {err} > {atol}"


def test_run_batch_matches_jax(pipes):
    ref_pipe, port = pipes
    pts = _points(0)
    ref = jax.tree_util.tree_map(np.asarray, ref_pipe.run_batch(pts))
    out = port.run_batch(pts)
    assert set(out) == set(ref)
    for key in ("vectors", "inner_points", "confidences"):
        _close(out[key].numpy(), ref[key], 1e-4 * (1 + np.abs(ref[key]).max()))
    np.testing.assert_array_equal(out["part_labels"].numpy(), ref["part_labels"])
    np.testing.assert_array_equal(out["markers_valid"].numpy(), ref["markers_valid"])
    _close(out["markers"].numpy(), ref["markers"], 1e-4)
    for key in ref["fit_params"]:
        assert out["fit_params"][key].shape == ref["fit_params"][key].shape
    assert out["verts"].shape == ref["verts"].shape == (B, 6890, 3)
    assert out["joints"].shape == ref["joints"].shape == (B, 45, 3)
    assert np.isfinite(out["verts"].numpy()).all()
    assert np.isfinite(out["joints"].numpy()).all()


def test_fit_from_identical_markers():
    """The LM fit alone, both frameworks fed the same markers."""
    rng = np.random.RandomState(1)
    vids = np.linspace(0, 299, 86).astype(np.int32)
    markers = (synthetic_body_model(300).v_template.numpy()[vids]
               + 0.01 * rng.randn(B, 86, 3)).astype(np.float32)
    valid = rng.rand(B, 86) > 0.1
    jbody = jax_body(300)
    ref_p = jax_fit(jax_marker_submodel(jbody, vids), jnp.asarray(markers), jnp.asarray(valid))
    ref_v, ref_j = jax_smpl_forward(jbody, ref_p["betas"], ref_p["pose"],
                                    ref_p["global_orient"], ref_p["transl"])
    body = synthetic_body_model(300)
    p = fit_smpl_params(marker_submodel(body, vids), torch.from_numpy(markers),
                        torch.from_numpy(valid))
    v, j = smpl_forward(body, p["betas"], p["pose"], p["global_orient"], p["transl"])
    _close(v.numpy(), ref_v, 1e-3)
    _close(j.numpy(), ref_j, 1e-3)


def test_port_imports_no_jax():
    code = ("import sys, etch_tpu_torch.pipeline, etch_tpu_torch.convert, "
            "etch_tpu_torch.cli.infer, etch_tpu_torch.nn.attention, "
            "etch_tpu_torch.train.state, etch_tpu_torch.train.checkpoint, "
            "etch_tpu_torch.data.dataset, etch_tpu_torch.cli.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'etch_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
