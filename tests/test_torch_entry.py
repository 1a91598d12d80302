"""PyTorch port vs JAX package: the single-scan entry point (`run_scan`,
`predict`, `fit`, `export`, `cli/infer`) on the repository's 4D-DRESS scan.

  - The numpy copies (`data/mesh.py`, `data/sampling.py`) are bit-equal to
    the originals: the same vertices, faces, areas, bytes written and, from
    one seed, the same samples.
  - `run_scan` at tiny widths (B=1, N=256), JAX weights converted into the
    port with the first skip conv zeroed as in tests/test_torch_pipeline.py:
    the same sampled points and center (bit-equal), the `predict` outputs
    within that file's tolerances (1e-4 * (1 + max |jax|), equal part
    labels).  The tiny random network labels few points per marker, so its
    LM problem is underdetermined and the fitted body is checked for shape
    and finiteness only; `fit` is held against JAX on a well-posed
    86-marker problem (three points at each marker vertex of the synthetic
    body), verts and joints to 1e-3 as test_fit_from_identical_markers, and
    against the float64 Theseus oracle trace of tests/test_lm_trace.py with
    that test's tolerances (residual norms rtol 1e-4 / atol 2e-5 at every
    iteration, parameters to 5e-3 at each stage's end).
  - `export` writes the JAX package's file names, npz keys and shapes.
  - `cli/infer --device cpu` runs end to end at full width on 256 points.
"""

import os

import jax
import numpy as np
import pytest
import torch

from etch_tpu.data.mesh import load_obj as jax_load_obj
from etch_tpu.data.mesh import save_obj as jax_save_obj
from etch_tpu.data.sampling import sample_barycentric as jax_sample_barycentric
from etch_tpu.data.sampling import sample_surface as jax_sample_surface
from etch_tpu.pipeline import InferencePipeline as JaxPipeline
from etch_tpu.pipeline import build_pipeline as jax_build
from etch_tpu.utils.config import EtchConfig as JaxConfig
from etch_tpu_torch import pipeline as port_pipeline
from etch_tpu_torch.body.smpl import marker_forward, marker_submodel, synthetic_body_model
from etch_tpu_torch.cli import infer
from etch_tpu_torch.convert import flax_to_state_dict
from etch_tpu_torch.data import mesh, sampling
from etch_tpu_torch.fit.lm import levenberg_marquardt
from etch_tpu_torch.fit.smpl_fit import NUM_POSE, fit_smpl_params
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.utils.config import EtchConfig

REPO = os.path.join(os.path.dirname(__file__), "..")
SCAN = os.path.join(REPO, "datafolder", "4D-DRESS", "data_processed", "model",
                    "00122_Inner_Take2_00011", "00122_Inner_Take2_00011.obj")
MARKERSET = os.path.join(REPO, "datafolder", "useful_data_4d-dress", "superset_smpl.json")
N = 256
CFG_KW = dict(num_point=N, batch_size=1)


@pytest.fixture(scope="module")
def scan():
    return jax_load_obj(SCAN), mesh.load_obj(SCAN)


def test_mesh_copy_bit_equal(scan, tmp_path):
    ref, port = scan
    np.testing.assert_array_equal(port.vertices, ref.vertices)
    np.testing.assert_array_equal(port.faces, ref.faces)
    np.testing.assert_array_equal(port.face_areas, ref.face_areas)
    for a, b in zip(port.bounds(), ref.bounds()):
        np.testing.assert_array_equal(a, b)
    jax_save_obj(str(tmp_path / "ref.obj"), ref)
    mesh.save_obj(str(tmp_path / "port.obj"), port)
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "ref.obj").read_bytes()


def test_sampling_copy_bit_equal(scan):
    ref, port = scan
    for seed in (0, 7):
        for a, b in zip(sampling.sample_surface(port, 500, seed=seed),
                        jax_sample_surface(ref, 500, seed=seed)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(sampling.sample_barycentric(port, 300, seed=seed),
                        jax_sample_barycentric(ref, 300, seed=seed)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def pipes():
    markerset = port_pipeline.load_markerset(MARKERSET)
    ref = jax_build(JaxConfig.tiny(**CFG_KW), markerset, allow_synthetic_body=True)
    params = jax.tree_util.tree_map(np.array, ref.params)
    stats = jax.tree_util.tree_map(np.array, ref.batch_stats)
    skip = params["encoder"]["block0_conv0"]["skip_conv"]
    skip["kernel"], skip["bias"] = np.zeros_like(skip["kernel"]), np.zeros_like(skip["bias"])
    ref = JaxPipeline(ref.cfg, params, stats, ref.body_model, ref.marker_vids)
    cfg = EtchConfig.tiny(**CFG_KW)
    port = build_pipeline(cfg, markerset, state_dict=flax_to_state_dict(params, stats, cfg),
                          allow_synthetic_body=True, device="cpu")
    np.testing.assert_array_equal(port.marker_vids, ref.marker_vids)
    return ref, port


@pytest.fixture(scope="module")
def scan_results(pipes):
    ref, port = pipes
    return ref.run_scan(SCAN, seed=0), port.run_scan(SCAN, seed=0)


def _close(out, ref, atol):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= atol, f"max abs err {err} > {atol}"


def test_run_scan_matches_jax(scan_results):
    ref, out = scan_results
    assert set(out) == set(ref) and set(out["pred"]) == set(ref["pred"])
    assert set(out["smpl_params"]) == set(ref["smpl_params"])
    np.testing.assert_array_equal(out["points"], ref["points"])
    np.testing.assert_array_equal(out["center"], ref["center"])
    np.testing.assert_array_equal(out["faces"], ref["faces"])
    for key in ("vectors", "inner_points", "confidences", "magnitude", "part_logits"):
        r = ref["pred"][key]
        _close(out["pred"][key], r, 1e-4 * (1 + np.abs(r).max()))
    np.testing.assert_array_equal(out["pred"]["part_labels"], ref["pred"]["part_labels"])
    np.testing.assert_array_equal(out["valid_mask"], ref["valid_mask"])
    _close(out["markers"], ref["markers"], 1e-4)
    for key in ("vertices", "joints"):
        assert out[key].shape == ref[key].shape and np.isfinite(out[key]).all(), key
    for key, v in ref["smpl_params"].items():
        assert out["smpl_params"][key].shape == v.shape, key


def test_fit_well_posed_matches_jax(pipes):
    """86 valid markers, each the mean of three points at its vertex."""
    ref, port = pipes
    rng = np.random.RandomState(3)
    template = port.body_model.v_template.numpy()[port.marker_vids]        # (86, 3)
    inner = (np.repeat(template, 3, axis=0) + 0.01 * rng.randn(86 * 3, 3))[None]
    labels = np.repeat(np.arange(86), 3)[None].astype(np.int32)
    conf = rng.uniform(0.5, 1.0, (1, 86 * 3, 1))
    inner, conf = inner.astype(np.float32), conf.astype(np.float32)
    r_verts, _, _, r_valid, r_joints = ref.fit(inner, labels, conf)
    verts, _, _, valid, joints = port.fit(inner, labels, conf)
    assert bool(valid.all()) and np.asarray(r_valid).all()
    _close(verts.numpy(), r_verts, 1e-3)
    _close(joints.numpy(), r_joints, 1e-3)


@pytest.mark.parametrize("stage", [0, 1])
@torch.no_grad()
def test_fit_matches_theseus_oracle_trace(stage):
    """The port's two-stage fit on the oracle's problem (synthetic body of
    300 vertices, 86 markers): its residual norm at the start of every LM
    iteration (one-step calls carrying x, the same arithmetic as one call),
    and `fit_smpl_params`'s parameters at the stage's end."""
    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "lm_trace.npz"))
    target = torch.from_numpy(data["target"].astype(np.float32))[None]
    valid = torch.from_numpy(data["valid"])[None]
    sub = marker_submodel(synthetic_body_model(n_verts=300),
                          np.linspace(0, 299, 86).astype(np.int32))
    mask = valid.float()[..., None]

    def residual(n_free):
        def fn(x, tgt, m):
            betas = torch.cat([x[NUM_POSE:NUM_POSE + n_free], x.new_zeros(10 - n_free)])
            fwd = marker_forward(sub, betas[None], x[None, :NUM_POSE],
                                 x[None, NUM_POSE + n_free:NUM_POSE + n_free + 3],
                                 x[None, NUM_POSE + n_free + 3:])[0]
            return ((tgt - fwd) * m).reshape(-1)
        return fn

    x = torch.zeros((1, NUM_POSE + 2 + 6))
    for s, (n_free, steps, lr, damping) in enumerate(((2, 30, 0.5, 0.01), (10, 50, 0.2, 1e-3))):
        if s == 1:
            x = torch.cat([x[:, :NUM_POSE + 2], x.new_zeros((1, 8)), x[:, NUM_POSE + 2:]], -1)
        norms = []
        for _ in range(steps):
            norms.append(residual(n_free)(x[0], target[0], mask[0]).norm().item())
            x = levenberg_marquardt(residual(n_free), x, (target, mask), 1, lr, damping)
        norms.append(residual(n_free)(x[0], target[0], mask[0]).norm().item())
        if s == stage:
            break
    np.testing.assert_allclose(norms, data[f"norms_stage{stage}"], rtol=1e-4, atol=2e-5)

    fit = fit_smpl_params(sub, target, valid, steps_stage1=50 * stage)
    n_free = 10 if stage else 2
    x_fit = torch.cat([fit["pose"], fit["betas"][:, :n_free], fit["global_orient"],
                       fit["transl"]], -1)[0].numpy()
    np.testing.assert_allclose(x_fit, data[f"x_final_stage{stage}"], atol=5e-3)
    np.testing.assert_allclose(x_fit, x[0].numpy(), atol=1e-5)


def test_export_matches_jax_schema(pipes, scan_results, tmp_path):
    ref_pipe, port = pipes
    ref, out = scan_results
    r_obj, r_npz = ref_pipe.export(ref, SCAN, str(tmp_path / "jax"))
    o_obj, o_npz = port.export(out, SCAN, str(tmp_path / "port"))
    assert os.path.basename(o_obj) == os.path.basename(r_obj) == \
        "00122_Inner_Take2_00011_pred_smpl.obj"
    assert os.path.basename(o_npz) == os.path.basename(r_npz) == \
        "00122_Inner_Take2_00011_output_smpl_info.npz"
    r, o = np.load(r_npz), np.load(o_npz)
    assert sorted(o.files) == sorted(r.files) == sorted(
        ["body_pose", "hand_pose", "betas", "global_orient", "transl", "joints"])
    for key in r.files:
        assert o[key].shape == r[key].shape, key
    r_lines, o_lines = open(r_obj).read().splitlines(), open(o_obj).read().splitlines()
    assert len(o_lines) == len(r_lines)
    assert [x for x in o_lines if x.startswith("f ")] == [x for x in r_lines if x.startswith("f ")]


def test_cli_infer_cpu(tmp_path):
    obj, npz = infer.main(["--scan_path", SCAN, "--markerset_path", MARKERSET,
                           "--allow_synthetic_body", "--device", "cpu", "--num_point", "256",
                           "--output_folder", str(tmp_path)])
    assert os.path.isfile(obj) and os.path.isfile(npz)
    assert np.load(npz)["joints"].shape == (45, 3)
    verts = mesh.load_obj(obj).vertices
    assert verts.shape == (6890, 3) and np.isfinite(verts).all()


def test_cli_infer_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--scan_path", SCAN, "--allow_synthetic_body",
                    "--output_folder", str(tmp_path)])


def test_unported_inputs_raise():
    """Checkpoints and SMPL pkls are read since the training slice
    (tests/test_torch_checkpoint.py); missing files raise."""
    cfg = EtchConfig.tiny(**CFG_KW)
    with pytest.raises(FileNotFoundError):
        build_pipeline(cfg, {"M0": 0}, checkpoint_path="ckpt", allow_synthetic_body=True,
                       device="cpu")
    with pytest.raises(FileNotFoundError, match="SMPL"):
        port_pipeline.load_body_model("female", root=REPO)
