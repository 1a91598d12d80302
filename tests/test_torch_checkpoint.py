"""Checkpoints, the SMPL loader and the orbax bridge of the port.

  - a train-state round trip through `save_train_state` /
    `restore_train_state` (model, BatchNorm buffers, Adam state, step),
    `max_to_keep`, and a tree-signature mismatch that raises;
  - `load_smpl` on a synthetic pkl in the SMPL release layout (a
    scipy-sparse `J_regressor`, one chumpy-pickled entry, more than 10
    shape directions), read bit-equal by the JAX package's loader and the
    port's, then served by `load_body_model`;
  - the JAX package's `save_params` (orbax) into a temporary directory,
    `tools/orbax_to_torch.py`, then `build_pipeline(checkpoint_path=...,
    device="cpu")`: the port's forward against the JAX network on the same
    weights, with tests/test_torch_model.py's tolerances (the first block's
    occupancy skip conv zeroed, as there).
"""

import importlib.util
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from etch_tpu.body.smpl import load_smpl as jax_load_smpl
from etch_tpu.models.etch_net import EtchNet as JaxEtchNet
from etch_tpu.train.checkpoint import save_params as jax_save_params
from etch_tpu.utils.config import EtchConfig as JaxConfig
from etch_tpu_torch.body.smpl import load_smpl
from etch_tpu_torch.pipeline import GENDER_MODEL_PATHS, build_pipeline, load_body_model
from etch_tpu_torch.train import checkpoint
from etch_tpu_torch.train.losses import compute_losses
from etch_tpu_torch.train.state import _guarded_update, create_train_state, make_train_step
from etch_tpu_torch.train.synthetic import make_batch
from etch_tpu_torch.utils.config import EtchConfig

REPO = os.path.join(os.path.dirname(__file__), "..")
N, B = 128, 2
CFG_KW = dict(num_point=N, batch_size=B, unet_blocks=(1, 2, 1, 1, 2), dir_num_layers=2)


def _markerset():
    return {f"M{i}": int(v) for i, v in enumerate(np.linspace(0, 6889, 86).astype(int))}


def _points(seed):
    rng = np.random.RandomState(seed)
    z = rng.uniform(-0.9, 0.9, (B, N))
    th = rng.uniform(0, 2 * np.pi, (B, N))
    r = 0.15 + 0.03 * np.cos(3 * z)
    return np.stack([r * np.cos(th), r * np.sin(th), z], -1).astype(np.float32)


def _trained_state(cfg, steps=2):
    model, state, opt = create_train_state(cfg, seed=3, device="cpu")
    step = make_train_step(model, opt, cfg)
    for i in range(steps):
        state, _ = step(state, make_batch(np.random.RandomState(i), B, N))
    return model, state, opt


def test_train_state_round_trip(tmp_path):
    cfg = EtchConfig.tiny(**CFG_KW)
    model, state, opt = _trained_state(cfg)
    d = str(tmp_path / "checkpoints")
    for epoch in range(7):
        checkpoint.save_train_state(d, epoch, state, config_json=cfg.to_json())
    assert sorted(os.listdir(d)) == [f"{e}.pt" for e in range(2, 7)]   # max_to_keep=5
    _, fresh, _ = create_train_state(cfg, seed=11, device="cpu")
    restored, step = checkpoint.restore_train_state(d, fresh)
    assert step == 6 and int(restored.step) == 6
    want = model.state_dict()
    got = restored.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for p, q in zip(model.parameters(), restored.model.parameters()):
        a, b = opt.state[p], restored.optimizer.state[q]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a[key], b[key]), key
    # restored training continues as the original does: the same loss, and
    # fed the same gradients (the CPU backward sums in a nondeterministic
    # order) the same Adam step, bit for bit
    batch = make_batch(np.random.RandomState(9), B, N)
    _, la = make_train_step(model, opt, cfg)(state, batch)
    lb = compute_losses(cfg, restored.model(torch.from_numpy(batch["hitpts"]), train=True),
                        *(torch.from_numpy(batch[k]) for k in ("vectors", "confidences", "labels")))
    assert torch.equal(la["all_loss"], lb["all_loss"].detach())
    _, state2, _ = create_train_state(cfg, seed=5, device="cpu")
    restored2, _ = checkpoint.restore_train_state(d, state2)
    for p, q in zip(model.parameters(), restored2.model.parameters()):
        q.grad = p.grad.clone()
    _guarded_update(restored2, torch.tensor(1.0))
    # the original took its step in make_train_step from the same gradients
    for p, q in zip(model.parameters(), restored2.model.parameters()):
        assert torch.equal(p, q)
    # weights-only export of the same model, and a training directory, both
    # serve through restore_params
    path = checkpoint.save_params(str(tmp_path / "export"), model.state_dict(), cfg.to_json())
    sig = checkpoint.tree_signature(model.state_dict())
    for src in (path, str(tmp_path / "export"), d):
        sd = checkpoint.restore_params(src, expected_signature=sig)
        assert set(sd) == set(want)


def test_signature_mismatch_raises(tmp_path):
    cfg = EtchConfig.tiny(**CFG_KW)
    _, state, _ = create_train_state(cfg, device="cpu")
    d = str(tmp_path / "ck")
    checkpoint.save_train_state(d, 0, state, config_json=cfg.to_json())
    other = EtchConfig.tiny(**dict(CFG_KW, dir_num_layers=1))
    _, fresh, _ = create_train_state(other, device="cpu")
    with pytest.raises(ValueError, match="signature mismatch"):
        checkpoint.restore_train_state(d, fresh)
    with pytest.raises(ValueError, match="signature mismatch"):
        build_pipeline(other, _markerset(), checkpoint_path=d, allow_synthetic_body=True,
                       device="cpu")
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(str(tmp_path / "empty"), fresh)


def _write_smpl_pkl(path, V=300, F=400):
    """A pkl in the SMPL release layout: numpy arrays, a scipy-sparse
    J_regressor, 12 shape directions, and `posedirs` pickled as a chumpy
    object (a class of a `chumpy` module that is gone when it is read)."""
    rng = np.random.RandomState(0)
    chumpy, ch = types.ModuleType("chumpy"), types.ModuleType("chumpy.ch")

    class Ch:
        pass

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    ch.Ch = Ch
    chumpy.ch = ch
    posedirs = Ch()
    posedirs.x = rng.randn(V, 3, 207) * 1e-3
    kintree = np.stack([np.concatenate([[4294967295], np.arange(23)]), np.arange(24)])
    jr = rng.rand(24, V) * (rng.rand(24, V) < 0.05)
    data = {"v_template": rng.randn(V, 3), "shapedirs": rng.randn(V, 3, 12) * 0.01,
            "posedirs": posedirs, "J_regressor": sp.csc_matrix(jr),
            "weights": rng.dirichlet(np.ones(24), V), "kintree_table": kintree,
            "f": rng.randint(0, V, (F, 3)).astype(np.uint32)}
    sys.modules["chumpy"], sys.modules["chumpy.ch"] = chumpy, ch
    try:
        with open(path, "wb") as fh:
            pickle.dump(data, fh, protocol=2)
    finally:
        del sys.modules["chumpy"], sys.modules["chumpy.ch"]
    return data


def test_load_smpl_bit_equal(tmp_path):
    path = tmp_path / GENDER_MODEL_PATHS["neutral"]
    path.parent.mkdir(parents=True)
    data = _write_smpl_pkl(str(path))
    ours, ref = load_smpl(str(path)), jax_load_smpl(str(path))
    for key in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights"):
        a, b = getattr(ours, key).numpy(), np.asarray(getattr(ref, key))
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert ours.shapedirs.shape[-1] == 10
    np.testing.assert_array_equal(ours.posedirs.numpy().T.reshape(-1, 3, 207),
                                  data["posedirs"].x.astype(np.float32))
    assert list(ours.parents) == np.asarray(ref.parents).tolist()
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_array_equal(ours.landmark_ids, ref.landmark_ids)
    body = load_body_model("neutral", root=str(tmp_path))
    assert body.num_verts == 300 and torch.equal(body.v_template, ours.v_template)
    with pytest.raises(FileNotFoundError):
        load_body_model("male", root=str(tmp_path))


def _orbax_tool():
    spec = importlib.util.spec_from_file_location(
        "orbax_to_torch", os.path.join(REPO, "tools", "orbax_to_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_orbax_checkpoint_serves_through_build_pipeline(tmp_path):
    jcfg = JaxConfig.tiny(**CFG_KW)
    jm = JaxEtchNet(cfg=jcfg)
    v = jax.jit(lambda r, x: jm.init(r, x, train=False))(jax.random.PRNGKey(1), jnp.zeros((1, N, 3)))
    params = jax.tree_util.tree_map(np.array, v["params"])
    stats = jax.tree_util.tree_map(np.array, v["batch_stats"])
    rng = np.random.RandomState(2)   # BN statistics off their init, as tests/test_torch_model.py
    stats = jax.tree_util.tree_map(lambda a: (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
                                   stats)
    skip = params["encoder"]["block0_conv0"]["skip_conv"]
    skip["kernel"][:] = 0.0
    skip["bias"][:] = 0.0
    jax_save_params(str(tmp_path / "orbax"), params, stats)
    cfg = EtchConfig.tiny(**CFG_KW)
    cfg_json = tmp_path / "config.json"
    cfg_json.write_text(cfg.to_json())
    path = _orbax_tool().main([str(tmp_path / "orbax"), str(tmp_path / "port"),
                               "--config_json", str(cfg_json)])
    assert os.path.basename(path) == "weights.pt"
    pipe = build_pipeline(cfg, _markerset(), checkpoint_path=str(tmp_path / "port"),
                          allow_synthetic_body=True, device="cpu")
    pts = _points(4)
    ref = jax.tree_util.tree_map(np.asarray, jm.apply({"params": params, "batch_stats": stats},
                                                      jnp.asarray(pts), train=False))
    with torch.no_grad():
        out = pipe.model(torch.from_numpy(pts))
    for key in ("part_labels", "confidences", "magnitude"):
        err = np.abs(out[key].numpy() - ref[key]).max()
        assert err <= 1e-4 * (1 + np.abs(ref[key]).max()), (key, err)
    # the chordal mean is ill-conditioned at random weights
    err = np.abs(out["direction"].numpy() - ref["direction"])
    assert np.quantile(err, 0.99) <= 2e-4 and err.max() <= 1e-2, err.max()


def test_train_cli_then_serve_the_checkpoint(tmp_path):
    """`cli.train` on the bundled 4D-Dress sample at full width, N=128, two
    epochs on the CPU: the experiment folder's files, then the last epoch's
    checkpoint served through `build_pipeline` and `run_scan`."""
    from etch_tpu_torch.cli import train

    data = os.path.join(REPO, "datafolder")
    args = ["--num_point", "128", "--epochs", "2", "--batch_size", "1", "--num_workers", "0",
            "--device", "cpu", "--output_folder", str(tmp_path / "exp"),
            "--markerset_path", f"{data}/useful_data_4d-dress/superset_smpl.json",
            "--activated_ids_path", f"{data}/useful_data_4d-dress/train_ids.pkl",
            "--infopoints_dir", f"{data}/gt_4D-Dress_data/npz",
            "--scan_dir", f"{data}/4D-DRESS/data_processed/model",
            "--smpl_dir", f"{data}/4D-DRESS/data_processed/smplh"]
    out, state = train.main(args)
    assert sorted(os.listdir(out)) == ["checkpoints", "log_all", "training_args.json"]
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["0.pt", "1.pt"]
    with open(os.path.join(out, "log_all", "metrics.jsonl")) as fh:
        rows = [__import__("json").loads(line) for line in fh]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["all_loss"]) for r in rows)
    cfg = EtchConfig(num_point=128, epochs=2)
    pipe = build_pipeline(cfg, _markerset(), checkpoint_path=os.path.join(out, "checkpoints"),
                          allow_synthetic_body=True, device="cpu")
    saved = torch.load(os.path.join(out, "checkpoints", "1.pt"), weights_only=True)
    assert saved["step"] == 1 and EtchConfig.from_json(saved["config_json"]) == cfg
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
        assert torch.equal(v, state.model.state_dict()[k]), k
    scan = f"{data}/4D-DRESS/data_processed/model/00122_Inner_Take2_00011/00122_Inner_Take2_00011.obj"
    result = pipe.run_scan(scan, seed=0)
    obj, npz = pipe.export(result, scan, str(tmp_path / "served"))
    assert os.path.isfile(obj) and np.isfinite(np.load(npz)["joints"]).all()
