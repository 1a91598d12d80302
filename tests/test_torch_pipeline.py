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
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etch_tpu.body.smpl import marker_submodel as jax_marker_submodel
from etch_tpu.body.smpl import smpl_forward as jax_smpl_forward
from etch_tpu.body.smpl import synthetic_body_model as jax_body
from etch_tpu.fit.smpl_fit import fit_smpl_params as jax_fit
from etch_tpu_torch.body.smpl import marker_submodel, smpl_forward, synthetic_body_model
from etch_tpu_torch.fit.smpl_fit import fit_smpl_params
from torch_parity import REPO, _close, capsule, markerset, paired_pipelines

N, B = 256, 2
CFG_KW = dict(num_point=N, batch_size=B)


@pytest.fixture(scope="module")
def pipes():
    return paired_pipelines(markerset(), **CFG_KW)


def test_run_batch_matches_jax(pipes):
    _run_batch_matches(*pipes, capsule(0, B, N))


def test_four_block_run_batch_matches_jax():
    """run_batch with EPN's four blocks (--EPN_layer_num 4, tiny widths 8, 8,
    16, 16): the network's outputs, labels and markers as at two blocks."""
    ref_pipe, port = paired_pipelines(markerset(), **CFG_KW, epn_layer_num=4,
                                      epn_mlps=((8, 8), (8, 8), (16, 16), (16, 16)))
    assert len(port.model.encoder.names) == 8
    _run_batch_matches(ref_pipe, port, capsule(1, B, N))


def _run_batch_matches(ref_pipe, port, pts):
    ref = jax.tree_util.tree_map(np.asarray, ref_pipe.run_batch(pts))
    out = port.run_batch(pts)
    assert set(out) == set(ref)
    for key in ("vectors", "inner_points", "confidences"):
        _close(out[key].numpy(), ref[key])
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


TOOLING = [
    "etch_tpu_torch.cli.evaluate", "etch_tpu_torch.cli.compute_mpjpe",
    "etch_tpu_torch.cli.make_splits", "etch_tpu_torch.cli.correspondence",
    "etch_tpu_torch.cli.generate_infopoints", "etch_tpu_torch.geometry.augment",
    "etch_tpu_torch.data.amass", "etch_tpu_torch.utils.colormap",
    "tools.torch_overfit_harness", "tools.torch_overfit_evidence",
    "tools.torch_realdata_closed_loop", "etch_tpu_torch.parallel.mesh",
    "etch_tpu_torch.cli.train_mixed", "etch_tpu_torch.fit.adam", "etch_tpu_torch.fit.prior",
    "etch_tpu_torch.fit.chamfer_refine", "etch_tpu_torch.ops.point_mesh",
    "etch_tpu_torch.animate", "tools.torch_generalization_harness",
    "tools.torch_generalization_evidence", "tools.torch_parallel_check"]


def _import_alone(module):
    code = (f"import sys, {module}; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'flax', 'etch_tpu', 'matplotlib')]; "
            "assert not bad, bad")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)


@pytest.fixture(scope="module")
def tooling_imports():
    """Each of TOOLING imported in a fresh interpreter, four at a time: one
    after another they took 46-78 s of tier-1's wall time in one worker."""
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(TOOLING, pool.map(_import_alone, TOOLING)))


@pytest.mark.parametrize("module", TOOLING)
def test_evaluation_and_tooling_import_no_jax_or_matplotlib(tooling_imports, module):
    done = tooling_imports[module]
    assert done.returncode == 0, done.stderr


def test_port_sources_import_no_jax_or_matplotlib():
    """No import statement anywhere in the port's sources, `chip_smoke.py` or
    the port's tools names these packages, at module level or inside a
    function (a lazy import escapes the subprocess checks above)."""
    import ast
    import glob

    files = (glob.glob(os.path.join(REPO, "etch_tpu_torch", "**", "*.py"), recursive=True)
             + glob.glob(os.path.join(REPO, "tools", "torch_*.py"))
             + [os.path.join(REPO, "chip_smoke.py")])
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "etch_tpu",
                                           "matplotlib")]
    assert len(files) > 50 and not bad, bad


def test_port_tests_import_no_other_test_module():
    """The port's test modules share their helpers through
    `tests/torch_parity.py` and never import one another (or the JAX
    package's test modules), so that each stands alone."""
    import ast
    import glob

    tests = os.path.join(REPO, "tests")
    modules = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(tests, "test_*.py"))}
    files = sorted(glob.glob(os.path.join(tests, "test_torch_*.py")))
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [a.name for a in node.names]
            else:
                continue
            hit = {part for n in names for part in n.split(".")} & modules
            if hit:
                bad.append(f"{os.path.basename(path)}:{node.lineno} {sorted(hit)}")
    assert len(files) >= 30 and not bad, bad
