"""PyTorch port vs JAX package: the evaluation path on the CPU.

  - The PLY half of `data/mesh.py` is a copy: on tests/test_data.py's PLY
    cases (a seeded round trip, the bundled binary PLY) and the debug
    writers, the same bytes written and the same arrays read back.
  - `utils/colormap.py::viridis` equals matplotlib's viridis (RGB) at every
    part label's colour, `shuffle_label(l) / 85`, and around the table's
    edges; the evaluation path never imports matplotlib.
  - `cli/evaluate.py` against JAX's `evaluate.main` on the bundled 4D-Dress
    sample at the tiny widths of tests/test_torch_entry.py (N=256, B=1,
    each CLI's `config_from_args` monkeypatched to `EtchConfig.tiny`), the
    same weights: JAX's random ones with the first skip conv zeroed (as in
    tests/test_torch_pipeline.py), saved by the JAX package's `save_params`
    and converted by `tools/orbax_to_torch.py` into the port's format, each
    CLI reading its own through `--model_path`.  The same files, npz keys
    and shapes; `hitpts` and the ground-truth arrays bit-equal; the
    predicted vectors, inner points and confidences within
    `1e-4 * (1 + max |jax|)`; equal part labels, so the same label PLYs
    byte for byte and the same `v2v_score.txt` lines up to the numbers.
    The tiny network labels few points per marker, so its LM problem is
    underdetermined and the fitted body is held for shape and finiteness
    only (ROADMAP C; `fit` itself is held against JAX in
    tests/test_torch_entry.py).  The port's V2V equals the float64 one
    recomputed from its exported OBJ, within the OBJ's rounding.
  - `cli/compute_mpjpe` prints the same lines as JAX's on the same
    directories.
  - `cli/evaluate --device cpu` at full width on 256 points; `--device
    cuda` refuses without a card.
"""

import contextlib
import io
import os
import re

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

from etch_tpu.cli import compute_mpjpe as jax_mpjpe
from etch_tpu.cli import evaluate as jax_evaluate
from etch_tpu.data import mesh as jax_mesh
from etch_tpu.models.etch_net import EtchNet as JaxEtchNet
from etch_tpu.train.checkpoint import save_params as jax_save_params
from etch_tpu.utils.config import EtchConfig as JaxConfig
from etch_tpu_torch.cli import compute_mpjpe, evaluate
from etch_tpu_torch.data import mesh
from etch_tpu_torch.utils.colormap import VIRIDIS, viridis
from etch_tpu_torch.utils.config import EtchConfig
from torch_parity import (DATA, INFO_DIR, MARKERSET, SAMPLE, SCAN_DIR, SMPL_DIR, _orbax_tool,
                          zero_first_skip)

N = 256
CFG_KW = dict(num_point=N, batch_size=1)


def test_ply_copies_bit_equal(tmp_path):
    pts = np.random.RandomState(0).randn(50, 3)
    for tool, tag in ((mesh, "port"), (jax_mesh, "jax")):
        tool.save_ply(str(tmp_path / f"p_{tag}.ply"), pts)
        tool.save_ply(str(tmp_path / f"pcn_{tag}.ply"), pts, colors=(pts * 80 % 256).astype(int),
                      normals=pts[::-1])
        tool.save_points_with_vector(pts, 0.5 * pts, str(tmp_path / f"v_{tag}.ply"))
        tool.save_points_with_color(pts, np.abs(np.sin(pts)), str(tmp_path / f"c_{tag}.ply"))
        tool.save_points_with_color(pts, (pts * 40 % 256).astype(np.uint8),
                                    str(tmp_path / f"u_{tag}.ply"))
    for name in ("p", "pcn", "v", "c", "u"):
        port, ref = tmp_path / f"{name}_port.ply", tmp_path / f"{name}_jax.ply"
        assert port.read_bytes() == ref.read_bytes(), name
        loaded = mesh.load_ply(str(port))
        np.testing.assert_array_equal(loaded, jax_mesh.load_ply(str(ref)))
        np.testing.assert_allclose(loaded, pts, atol=1e-5)
    binary = os.path.join(DATA, "gt_4D-Dress_data", "ply", f"{SAMPLE}.ply")
    ours, ref = mesh.load_ply(binary), jax_mesh.load_ply(binary)
    assert ours.dtype == ref.dtype and ours.shape[1] == 3 and len(ours) > 100
    np.testing.assert_array_equal(ours, ref)


def test_viridis_matches_matplotlib():
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap("viridis")
    np.testing.assert_array_equal(VIRIDIS, np.asarray(cmap.colors))
    labels = np.arange(86)
    for x in (evaluate.shuffle_label(labels) / 85, jax_evaluate.shuffle_label(labels) / 85,
              np.linspace(-0.2, 1.2, 3001), np.array([0.0, 1 / 256, 255 / 256, 1.0, np.nan]),
              np.linspace(0, 1, 997).astype(np.float32)):
        np.testing.assert_array_equal(viridis(x), cmap(x)[:, :3])
    for lab in labels:   # one label at a time, as each point is coloured
        x = evaluate.shuffle_label(np.array([lab])) / 85
        np.testing.assert_array_equal(viridis(x), jax_evaluate._viridis(x))


def _argv(model_path, device=None, num_point=N):
    argv = ["--num_point", str(num_point), "--batch_size", "1", "--num_workers", "0",
            "--i", "parity", "--markerset_path", MARKERSET, "--activated_ids_path", "",
            "--scan_dir", SCAN_DIR, "--smpl_dir", SMPL_DIR, "--infopoints_dir", INFO_DIR,
            "--allow_synthetic_body", "--save_debug"]
    argv += ["--model_path", model_path] if model_path else []
    return argv + (["--device", device] if device else [])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs on the bundled sample with the same weights; returns the
    two sample directories and the two output folders."""
    tmp = tmp_path_factory.mktemp("eval")
    jcfg = JaxConfig.tiny(**CFG_KW)
    jm = JaxEtchNet(cfg=jcfg)
    v = jax.jit(lambda r, x: jm.init(r, x, train=False))(jax.random.PRNGKey(0),
                                                         jnp.zeros((1, N, 3)))
    params = jax.tree_util.tree_map(np.array, v["params"])
    stats = jax.tree_util.tree_map(np.array, v["batch_stats"])
    zero_first_skip(params)
    jax_save_params(str(tmp / "orbax"), params, stats)
    cfg_json = tmp / "config.json"
    cfg_json.write_text(EtchConfig.tiny(**CFG_KW).to_json())
    _orbax_tool().main([str(tmp / "orbax"), str(tmp / "port_ckpt"), "--config_json",
                        str(cfg_json)])

    mp = pytest.MonkeyPatch()
    cwd = os.getcwd()
    try:
        mp.setattr(jax_evaluate, "config_from_args",
                   lambda args: JaxConfig.tiny(**CFG_KW, seed=args.seed))
        mp.setattr(evaluate, "config_from_args",
                   lambda args: EtchConfig.tiny(**CFG_KW, seed=args.seed))
        (tmp / "jax").mkdir()
        os.chdir(tmp / "jax")
        jax_evaluate.main(_argv(str(tmp / "orbax")))
        (tmp / "port").mkdir()
        os.chdir(tmp / "port")
        res = evaluate.main(_argv(str(tmp / "port_ckpt"), device="cpu"))
    finally:
        os.chdir(cwd)
        mp.undo()
    out = {t: tmp / t / "all_experiments" / "experiments" / "eval_outputs_parity"
           for t in ("jax", "port")}
    assert str(out["port"]).endswith(res["output_folder"])
    return out, res


def _ply_rows(path):
    text = path.read_text()
    return text[:text.index("end_header")], np.array(
        [[float(x) for x in r.split()] for r in text.split("end_header\n")[1].splitlines()])


def test_evaluate_matches_jax(runs):
    out, _ = runs
    d = {t: out[t] / SAMPLE for t in out}
    assert sorted(os.listdir(d["port"])) == sorted(os.listdir(d["jax"]))
    assert len(os.listdir(d["port"])) == 8
    ours, ref = (np.load(d[t] / f"tightness_vectors_info_{SAMPLE}.npz") for t in ("port", "jax"))
    assert sorted(ours.files) == sorted(ref.files)
    for k in ref.files:
        assert ours[k].shape == ref[k].shape, k
    for k in ("hitpts", "gt_vectors", "gt_labels", "gt_confidences"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    for k in ("pred_vectors", "pred_confidences"):
        err = np.abs(ours[k] - ref[k]).max()
        assert err <= 1e-4 * (1 + np.abs(ref[k]).max()), (k, err)
    np.testing.assert_array_equal(ours["pred_part_labels"], ref["pred_part_labels"])
    for name in ("hitpts_gt_vectors", "hitpts_gt_part_labels", "hitpts_pred_part_labels"):
        f = f"{name}_{SAMPLE}.ply"
        assert (d["port"] / f).read_bytes() == (d["jax"] / f).read_bytes(), name
    for name in ("hitpts_pred_vectors", "pred_inner_points_pred_part_labels"):
        f = f"{name}_{SAMPLE}.ply"
        (h_port, rows_port), (h_jax, rows_jax) = _ply_rows(d["port"] / f), _ply_rows(d["jax"] / f)
        assert h_port == h_jax and rows_port.shape == rows_jax.shape == (N, 6)
        err = np.abs(rows_port - rows_jax).max()
        assert err <= 1e-4 * (1 + np.abs(rows_jax).max()) + 1e-6, (name, err)   # 6 decimals

    ours, ref = (np.load(d[t] / f"output_smpl_info_{SAMPLE}.npz") for t in ("port", "jax"))
    assert sorted(ours.files) == sorted(ref.files)
    for k in ref.files:
        assert ours[k].shape == ref[k].shape and np.isfinite(ours[k]).all(), k
    f = f"forwarded_smpl_mesh_on_pred_{SAMPLE}.obj"
    obj_port, obj_jax = ((d[t] / f).read_text().splitlines() for t in ("port", "jax"))
    assert len(obj_port) == len(obj_jax)
    assert [x for x in obj_port if x.startswith("f ")] == [x for x in obj_jax if x.startswith("f ")]
    verts = mesh.load_obj(str(d["port"] / f)).vertices
    assert verts.shape == (6890, 3) and np.isfinite(verts).all()

    number = re.compile(r"\d+\.\d+(e-?\d+)?")
    lines = {t: (out[t] / "v2v_score.txt").read_text().splitlines() for t in out}
    assert [number.sub("X", x) for x in lines["port"]] == \
        [number.sub("X", x) for x in lines["jax"]]
    assert len(lines["port"]) == 5 and lines["port"][1] == "=========="


def test_evaluate_v2v_is_the_exported_mesh(runs):
    out, res = runs
    lines = (out["port"] / "v2v_score.txt").read_text().splitlines()
    v2v = float(lines[0].split(": ")[1].split()[0])
    assert res["average_v2v"] == v2v and lines[2] == f"average v2v: {v2v}"
    verts = mesh.load_obj(str(out["port"] / SAMPLE /
                              f"forwarded_smpl_mesh_on_pred_{SAMPLE}.obj")).vertices
    gt = mesh.load_obj(os.path.join(SMPL_DIR, SAMPLE, f"mesh_smpl_{SAMPLE}.obj")).vertices
    # the OBJ's 8 decimals move each vertex by at most sqrt(3) * 5e-9
    assert abs(float(np.mean(np.linalg.norm(gt - verts, axis=1))) - v2v) <= 1e-8
    assert set(res["seconds"]) == {"load", "build", "forward", "fit", "export"}


def _printed(fn, argv):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        fn(argv)
    return text.getvalue()


def test_compute_mpjpe_matches_jax(runs):
    out, _ = runs
    for t in out:
        argv = ["--pred_dir", str(out[t]), "--gt_dir", SMPL_DIR]
        ours, ref = _printed(compute_mpjpe.main, argv), _printed(jax_mpjpe.main, argv)
        assert ours == ref and "mean MPJPE:" in ours and "count:  1" in ours


def test_cli_evaluate_cpu_full_width(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = evaluate.main(_argv(None, device="cpu"))
    d = tmp_path / res["output_folder"] / SAMPLE
    info = np.load(d / f"output_smpl_info_{SAMPLE}.npz")
    assert info["joints"].shape == (45, 3) and np.isfinite(info["joints"]).all()
    assert np.isfinite(res["average_v2v"])
    for f in sorted(os.listdir(d)):
        if f.endswith(".ply"):
            assert mesh.load_ply(str(d / f)).shape == (N, 3), f


def test_cli_evaluate_refuses_a_missing_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(_argv(None))
