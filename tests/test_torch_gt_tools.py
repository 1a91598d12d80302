"""PyTorch port vs JAX package: the ground-truth tooling copies.

  - `geometry/augment.py`, `data/amass.py`, `cli/make_splits.py`, the
    merge-segmentation and seginfo commands of `cli/correspondence.py` and
    `cli/generate_infopoints.py` are numpy copies: the same seeds give the
    same arrays bit for bit, and the files they write are the same bytes.
    `generate_for_pair` is held on tests/test_infopoints.py's inputs: its
    rejection-branch boxes and the bundled 4D-Dress pair (exact and with
    the embree f32 emulation), and `_process_id` on that pair writes the
    same npz and debug PLY.
  - `export_standard_mesh` runs the port's `load_smpl` / `smpl_forward`
    (on the CPU here): the canonical meshes of a pkl made from
    `synthetic_body_model` within 1e-5 of JAX's, the same faces; it refuses
    `device="cuda"` without a card.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from etch_tpu.body.smpl import synthetic_body_model
from etch_tpu.cli import correspondence as jax_corr
from etch_tpu.cli import generate_infopoints as jax_gen
from etch_tpu.cli import make_splits as jax_splits
from etch_tpu.data import amass as jax_amass
from etch_tpu.data.mesh import load_obj as jax_load_obj
from etch_tpu.geometry import augment as jax_augment
from etch_tpu_torch.cli import correspondence, generate_infopoints, make_splits
from etch_tpu_torch.data import amass, mesh
from etch_tpu_torch.geometry import augment
from torch_parity import (BODY, SAMPLE, SCAN_DIR, SMPL_DIR, box_mesh, merge, scan_with_top,
                          top_face_samples)


def test_augment_bit_equal():
    a, b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(5):
        np.testing.assert_array_equal(augment.rand_rotation_matrix(a),
                                      jax_augment.rand_rotation_matrix(b))
    pts = np.random.RandomState(1).randn(40, 3)
    c = np.array([0.1, -0.2, 0.3])
    R = augment.y_rotation_matrix(0.7)
    np.testing.assert_array_equal(R, jax_augment.y_rotation_matrix(0.7))
    np.testing.assert_array_equal(augment.rotate_cloud(pts, R), jax_augment.rotate_cloud(pts, R))
    np.testing.assert_array_equal(augment.rotate_cloud(pts, R, c),
                                  jax_augment.rotate_cloud(pts, R, c))
    np.testing.assert_array_equal(augment.jitter_cloud(pts, 0.01, np.random.default_rng(3)),
                                  jax_augment.jitter_cloud(pts, 0.01, np.random.default_rng(3)))


def test_amass_bit_equal(tmp_path):
    rng = np.random.RandomState(0)
    for sub, name in (("a", "s1.npz"), ("b/c", "s2.npz"), ("b/c", "notes.txt")):
        d = tmp_path / sub
        d.mkdir(parents=True, exist_ok=True)
        if name.endswith(".npz"):
            np.savez(d / name, poses=rng.randn(9, 72), trans=rng.randn(9, 3),
                     betas=rng.randn(10), markers=rng.randn(9, 86, 3),
                     gender=np.array("female"), mocap_framerate=np.array(120.0))
        else:
            (d / name).write_text("not a sequence")
    for kw in ({}, {"step": 2, "max_frames": 3}):
        ours, ref = amass.AmassSequenceDataset(str(tmp_path), **kw), \
            jax_amass.AmassSequenceDataset(str(tmp_path), **kw)
        assert ours.files == ref.files and len(ours) == len(ref) == 2
        for i in range(len(ref)):
            a, b = ours[i], ref[i]
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            for fa, fb in zip(ours.frames(i), ref.frames(i), strict=True):
                for k in fb:
                    np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _split_dirs(root, ids):
    for sub in ("scan", "smpl"):
        for i in ids:
            (root / sub / i).mkdir(parents=True)
    (root / "scan" / "loose_file.obj").write_text("")
    return str(root / "scan"), str(root / "smpl")


@pytest.mark.parametrize("dataset", ["cape", "custom"])
def test_make_splits_bit_equal(tmp_path, dataset):
    ids = [f"{s}_take{t}_{f:05d}" for s in ("00032", "00096", "00122", "00215")
           for t in range(2) for f in range(0, 30, 7)]
    scan, smpl = _split_dirs(tmp_path, ids)
    extra = [] if dataset == "cape" else [
        "--train_subjects", "00032", "00122", "--val_subjects", "00096", "00215"]
    for tool, out in ((make_splits, "port"), (jax_splits, "jax")):
        tool.main(["--scan_dir", scan, "--smpl_dir", smpl, "--save_dir", str(tmp_path / out),
                   "--dataset", dataset, "--val_sample_ratio", "3", *extra])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "train_ids.pkl", "val_ids.pkl", "val_ids_sampled_ratio3.pkl"]
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    with pytest.raises(ValueError, match="not in train or val"):
        make_splits.make_subject_split(scan, smpl, {"00032"}, {"00096"})


def _segmentation(num_vertices=6890, seed=0):
    """A per-bone segmentation json: every source bone of MERGE_RULES, each
    vertex in one bone, and overlaps at each conflict pair's border."""
    rng = np.random.RandomState(seed)
    bones = sorted({b for srcs in correspondence.MERGE_RULES.values() for b in srcs})
    owner = rng.randint(0, len(bones), num_vertices)
    seg = {b: [int(v) for v in np.flatnonzero(owner == i)] for i, b in enumerate(bones)}
    part_of = {b: p for p, srcs in correspondence.MERGE_RULES.items() for b in srcs}
    for winner, loser in correspondence.CONFLICT_PRIORITY:
        wb = next(b for b in bones if part_of[b] == winner)
        lb = next(b for b in bones if part_of[b] == loser)
        seg[lb] += seg[wb][:5]   # the loser's bone also claims five of the winner's
    return seg


def test_correspondence_numpy_commands_bit_equal(tmp_path):
    seg = _segmentation()
    merged = correspondence.merge_segments(seg, 6890)
    assert merged == jax_corr.merge_segments(seg, 6890)
    assert correspondence.build_seginfo(merged) == jax_corr.build_seginfo(merged)
    with pytest.raises(AssertionError, match="disjoint cover"):
        correspondence.merge_segments(seg, 6891)
    seg_json = tmp_path / "seg.json"
    seg_json.write_text(json.dumps(seg))
    for tool, tag in ((correspondence, "port"), (jax_corr, "jax")):
        tool.main(["merge-segmentation", "--input_json", str(seg_json),
                   "--output_pkl", str(tmp_path / f"parts_{tag}.pkl")])
        tool.main(["seginfo", "--parts_pkl", str(tmp_path / f"parts_{tag}.pkl"),
                   "--output_pkl", str(tmp_path / f"info_{tag}.pkl")])
    for name in ("parts", "info"):
        assert (tmp_path / f"{name}_port.pkl").read_bytes() == \
            (tmp_path / f"{name}_jax.pkl").read_bytes(), name


def _synthetic_pkl(path, n_verts=6890):
    """`synthetic_body_model`'s arrays in the SMPL release layout (at
    SMPL's vertex count: `load_smpl` gathers the SMPL landmark vertices)."""
    body = synthetic_body_model(n_verts)
    V = n_verts
    data = {"v_template": np.asarray(body.v_template, np.float64),
            "shapedirs": np.asarray(body.shapedirs, np.float64),
            "posedirs": np.asarray(body.posedirs, np.float64).T.reshape(V, 3, 207),
            "J_regressor": np.asarray(body.J_regressor, np.float64),
            "weights": np.asarray(body.lbs_weights, np.float64),
            "kintree_table": np.stack([np.asarray(body.parents), np.arange(24)]),
            "f": np.asarray(body.faces, np.uint32)}
    with open(path, "wb") as fh:
        pickle.dump(data, fh, protocol=2)


@pytest.mark.parametrize("normalize", [True, False])
def test_export_standard_mesh_matches_jax(tmp_path, normalize):
    pkl = tmp_path / "body.pkl"
    _synthetic_pkl(str(pkl))
    jax_corr.export_standard_mesh(str(pkl), str(tmp_path / "jax"), 1.6, 0.1, normalize)
    correspondence.main(["export-standard-mesh", "--body_model_path", str(pkl),
                         "--save_dir", str(tmp_path / "port"), "--tgt_height", "1.6",
                         "--tgt_center", "0.1", "--device", "cpu"]
                        + ([] if normalize else ["--no_normalize"]))
    for name in ("smpl_mesh_original.obj", "smpl_mesh_canonical.obj"):
        ref, ours = jax_load_obj(str(tmp_path / "jax" / name)), \
            mesh.load_obj(str(tmp_path / "port" / name))
        np.testing.assert_array_equal(ours.faces, ref.faces)
        assert ours.vertices.shape == ref.vertices.shape == (6890, 3)
        np.testing.assert_allclose(ours.vertices, ref.vertices, rtol=0, atol=1e-5, err_msg=name)


def test_export_standard_mesh_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pkl = tmp_path / "body.pkl"
    _synthetic_pkl(str(pkl))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        correspondence.export_standard_mesh(str(pkl), str(tmp_path / "out"))


def _rejection_cases():
    thin = box_mesh(-0.5, 0.5, -0.5, 0.5, -0.02, 0.0)
    sheet = mesh.TriMesh(np.array([[-2, -2, -0.01], [2, -2, -0.01], [2, 2, -0.01],
                                   [-2, 2, -0.01]], np.float64),
                         np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    occluder = box_mesh(0.05, 0.5, -0.5, 0.5, 0.04, 0.06)
    return [(BODY, scan_with_top(0.10)), (BODY, scan_with_top(0.20)),
            (BODY, merge(scan_with_top(0.10), sheet)), (thin, scan_with_top(0.10)),
            (merge(BODY, occluder), scan_with_top(0.10))]


def test_generate_for_pair_rejection_branches_bit_equal():
    for body, scan in _rejection_cases():
        for a, b in zip(generate_infopoints.generate_for_pair(body, scan,
                                                               samples=top_face_samples()),
                        jax_gen.generate_for_pair(body, scan, samples=top_face_samples()),
                        strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("emulate", [False, True])
def test_generate_for_pair_bundled_pair_bit_equal(emulate):
    scan = mesh.load_obj(os.path.join(SCAN_DIR, SAMPLE, f"{SAMPLE}.obj"))
    smpl = mesh.load_obj(os.path.join(SMPL_DIR, SAMPLE, f"mesh_smpl_{SAMPLE}.obj"))
    ip, iv = generate_infopoints.generate_for_pair(smpl, scan, seed=0, emulate_embree_f32=emulate)
    rip, riv = jax_gen.generate_for_pair(jax_load_obj(os.path.join(SMPL_DIR, SAMPLE,
                                                                   f"mesh_smpl_{SAMPLE}.obj")),
                                         jax_load_obj(os.path.join(SCAN_DIR, SAMPLE,
                                                                   f"{SAMPLE}.obj")),
                                         seed=0, emulate_embree_f32=emulate)
    np.testing.assert_array_equal(ip, rip)
    np.testing.assert_array_equal(iv, riv)
    assert len(ip) == (12122 if emulate else 24066)


def test_process_id_writes_the_same_files(tmp_path):
    for tool, tag in ((generate_infopoints, "port"), (jax_gen, "jax")):
        id_, n = tool._process_id((SAMPLE, SCAN_DIR, SMPL_DIR, str(tmp_path / tag / "npz"),
                                   str(tmp_path / tag / "ply"), 0))
        assert id_ == SAMPLE and n == 24066
    ours, ref = (np.load(tmp_path / t / "npz" / f"{SAMPLE}.npz") for t in ("port", "jax"))
    assert ours.files == ref.files
    for k in ref.files:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert (tmp_path / "port" / "ply" / f"{SAMPLE}.ply").read_bytes() == \
        (tmp_path / "jax" / "ply" / f"{SAMPLE}.ply").read_bytes()
    assert generate_infopoints._process_id(("missing", SCAN_DIR, SMPL_DIR, str(tmp_path),
                                            None, 0)) == ("missing", 0)
