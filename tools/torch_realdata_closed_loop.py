"""Real-data closed loop of the PyTorch port: overfit the full model on the
bundled 4D-Dress sample through the port's ground-truth pipeline, then show
that the quality metrics and the evaluation CLI's V2V move far off their
random-weights values.

The port's counterpart of tools/realdata_closed_loop.py (whose docstring
explains each quantity), with the same settings: B=4 samplings (seeds 0-3)
of `00122_Inner_Take2_00011` through `data/dataset.py::load_item` at
N=5000, f32 `EtchConfig()`, 300 Adam steps at lr 1e-3 with a cosine decay
to lr/20 (`train/state.py::cosine_decay_schedule`, the port's counterpart
of `optax.adam(optax.cosine_decay_schedule(LR, STEPS, alpha=0.05))`), the
weights the port's own initialisation.  Then `metrics` (direction cosine,
magnitude error, label accuracy, marker error, on the trained batch), the
port's `cli/evaluate` with random weights and with the trained checkpoint
(the port's format, `train/checkpoint.py`), the oracle fit (the same
synthetic body fitted by the same two-stage LM to the ground-truth marker
positions), and `direction_cosine_ceiling`.  The gates are those of
tests/test_overfit.py::test_realdata_closed_loop_artifact, which
tests/test_torch_evidence.py applies to this artifact.

    python tools/torch_realdata_closed_loop.py   # writes docs/evidence/realdata_closed_loop_h100.json

The artifact has the JAX one's keys, `backend` the torch device type, plus
`device` (the card's name and power limit from nvidia-smi) and
`trained_markers` / `trained_markers_valid`: the 86 markers (m) and their
valid mask that the evaluation CLI fitted with the trained checkpoint, so
that tests/test_torch_evidence.py can fit the same markers with both
frameworks' LM on the CPU.  The evaluation runs in a temporary directory.
"""

import argparse
import contextlib
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SAMPLE_ID = "00122_Inner_Take2_00011"
DATA = os.path.join(REPO, "datafolder")
MARKERSET = os.path.join(DATA, "useful_data_4d-dress", "superset_smpl.json")
SCAN_DIR = os.path.join(DATA, "4D-DRESS", "data_processed", "model")
SMPL_DIR = os.path.join(DATA, "4D-DRESS", "data_processed", "smplh")
INFO_DIR = os.path.join(DATA, "gt_4D-Dress_data", "npz")

STEPS = 300
NUM_POINT = 5000
BATCH = 4
LR = 1e-3


def build_batch(markerset):
    """B samplings of the one bundled scan through the port's GT pipeline."""
    from etch_tpu_torch.data.dataset import DatasetPaths, load_item

    paths = DatasetPaths(scan_dir=SCAN_DIR, smpl_dir=SMPL_DIR, infopoints_dir=INFO_DIR)
    vids = list(markerset.values())
    items = []
    for s in range(BATCH):
        t0 = time.time()
        items.append(load_item(paths, SAMPLE_ID, NUM_POINT, vids, seed=s))
        print(f"item seed={s} built in {time.time() - t0:.1f}s", flush=True)
    return {k: np.stack([it[k] for it in items])
            for k in ("hitpts", "vectors", "confidences", "labels")}


def direction_ceiling(batch, ks=(3, 10, 20)):
    """Best mean cosine a direction field at the feature resolution can
    score: cosine between each point's GT direction and the normalized mean
    GT direction over its k nearest neighbors."""
    pts, v = batch["hitpts"], batch["vectors"]
    gd = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    out = {}
    for k in ks:
        cs = []
        for b in range(pts.shape[0]):
            d2 = ((pts[b][:, None] - pts[b][None]) ** 2).sum(-1)
            idx = np.argpartition(d2, k, axis=1)[:, :k]
            m = gd[b][idx].mean(1)
            m /= np.maximum(np.linalg.norm(m, axis=-1, keepdims=True), 1e-9)
            cs.append(float((m * gd[b]).sum(-1).mean()))
        out[f"k{k}"] = round(float(np.mean(cs)), 4)
    return out


def oracle_fit(markerset, gt_mk, device):
    """Fit the synthetic body the evaluation CLI uses to the GT marker
    positions with the same two-stage LM: the best mesh the evaluation path
    could produce.  Returns (verts (V,3) float32, vids (86,))."""
    import torch

    from etch_tpu_torch.body.smpl import marker_submodel, smpl_forward
    from etch_tpu_torch.fit.smpl_fit import fit_smpl_params
    from etch_tpu_torch.pipeline import load_body_model

    body = load_body_model("neutral", root=REPO, allow_synthetic=True).to(device)
    vids = np.asarray(list(markerset.values()), np.int32)
    sub = marker_submodel(body, vids)
    markers = torch.as_tensor(gt_mk[None], device=device)
    valid = torch.ones(markers.shape[:2], dtype=torch.bool, device=device)
    with torch.no_grad():
        params = fit_smpl_params(sub, markers, valid)
        verts, _ = smpl_forward(body, params["betas"], params["pose"],
                                params["global_orient"], params["transl"])
    return verts[0].cpu().numpy().astype(np.float32), vids


def fitted_mesh_verts(tag, workdir):
    """Vertices of the mesh the evaluation CLI exported for this run."""
    from etch_tpu_torch.data.mesh import load_obj

    p = os.path.join(workdir, "all_experiments", "experiments",
                     f"eval_outputs_closed_loop_{tag}", SAMPLE_ID,
                     f"forwarded_smpl_mesh_on_pred_{SAMPLE_ID}.obj")
    return load_obj(p).vertices.astype(np.float32)


def gt_markers(markerset):
    from etch_tpu_torch.data.mesh import load_obj

    smpl_mesh = load_obj(os.path.join(SMPL_DIR, SAMPLE_ID, f"mesh_smpl_{SAMPLE_ID}.obj"))
    vids = np.asarray(list(markerset.values()), np.int64)
    return smpl_mesh.vertices[vids].astype(np.float32)  # (86, 3)


def metrics(model, batch, gt_mk, cfg):
    """Quality metrics of the model's current weights on the real batch."""
    import torch

    from etch_tpu_torch.fit.markers import extract_markers

    device = next(model.parameters()).device
    hitpts = torch.as_tensor(batch["hitpts"], device=device)
    with torch.no_grad():
        out = model(hitpts, train=False)
        inner = hitpts - out["direction"] * out["magnitude"] / cfg.scale_magnitude
        mk, valid = extract_markers(inner, torch.argmax(out["part_labels"], -1),
                                    out["confidences"], num_markers=cfg.num_markers)
    dirs = out["direction"].cpu().numpy()          # (B,N,3) unit
    mag = out["magnitude"].cpu().numpy()           # (B,N,1), x10 scale
    gt_v = batch["vectors"]
    gt_norm = np.linalg.norm(gt_v, axis=-1, keepdims=True)
    gt_dir = gt_v / np.maximum(gt_norm, 1e-9)
    cosine = float(np.mean(np.sum(dirs * gt_dir, axis=-1)))
    mag_mae = float(np.mean(np.abs(mag[..., 0] / cfg.scale_magnitude - gt_norm[..., 0])))
    labels = torch.argmax(out["part_labels"], -1).cpu().numpy()
    label_acc = float(np.mean(labels == batch["labels"]))
    mk, valid = mk.cpu().numpy(), valid.cpu().numpy()
    # gt_mk: (86, 3) shared across the batch (one scan, B samplings)
    gt = gt_mk[None] if gt_mk.ndim == 2 else gt_mk
    err = np.linalg.norm(mk - gt, axis=-1)  # (B, 86)
    marker_err_cm = float(np.mean(err[valid]) * 100.0)
    return {
        "direction_cosine": round(cosine, 4),
        "magnitude_mae_m": round(mag_mae, 5),
        "label_acc": round(label_acc, 4),
        "marker_err_cm": round(marker_err_cm, 3),
        "markers_valid_frac": round(float(valid.mean()), 4),
    }


@contextlib.contextmanager
def recorded_fits():
    """Yield a list that receives (markers, valid) as numpy arrays for
    every `InferencePipeline.fit` call inside the block."""
    from etch_tpu_torch.pipeline import InferencePipeline

    seen, fit = [], InferencePipeline.fit

    def recording(self, *args):
        out = fit(self, *args)
        seen.append((out[2].cpu().numpy(), out[3].cpu().numpy()))
        return out

    InferencePipeline.fit = recording
    try:
        yield seen
    finally:
        InferencePipeline.fit = fit


def run_eval_cli(tag, model_path, workdir, device):
    """The port's evaluation CLI (forward -> markers -> two-stage LM fit ->
    V2V) on the bundled sample; returns the mean V2V in cm from
    v2v_score.txt."""
    from etch_tpu_torch.cli import evaluate

    ids_pkl = os.path.join(workdir, f"ids_{tag}.pkl")
    with open(ids_pkl, "wb") as f:
        pickle.dump([SAMPLE_ID], f)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        argv = [
            "--num_point", str(NUM_POINT), "--batch_size", "1", "--num_workers", "0",
            "--i", f"closed_loop_{tag}", "--markerset_path", MARKERSET,
            "--activated_ids_path", ids_pkl, "--scan_dir", SCAN_DIR, "--smpl_dir", SMPL_DIR,
            "--infopoints_dir", INFO_DIR, "--allow_synthetic_body", "--no-save_debug",
            "--device", str(device),
        ]
        if model_path:
            argv += ["--model_path", model_path]
        evaluate.main(argv)
        score = os.path.join(workdir, "all_experiments", "experiments",
                             f"eval_outputs_closed_loop_{tag}", "v2v_score.txt")
        with open(score) as f:
            lines = [l for l in f.read().splitlines() if l.strip()]
        # reference src/eval.py:254-265 format; "average v2v:" is in meters
        mean_m = next(float(l.split()[-1]) for l in lines if l.startswith("average v2v:"))
        return mean_m * 100.0
    finally:
        os.chdir(cwd)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(REPO, "docs", "evidence",
                                                 "realdata_closed_loop_h100.json"))
    args = p.parse_args(argv)

    import torch

    from etch_tpu_torch.train.checkpoint import save_train_state
    from etch_tpu_torch.train.state import (cosine_decay_schedule, create_train_state,
                                            make_train_step)
    from etch_tpu_torch.utils.config import EtchConfig
    from tools.torch_overfit_harness import device_line

    with open(MARKERSET) as f:
        markerset = json.load(f)

    print(f"building {BATCH} real-GT samplings of {SAMPLE_ID} (N={NUM_POINT})...", flush=True)
    batch = build_batch(markerset)
    gt_mk = gt_markers(markerset)

    cfg = EtchConfig(num_point=NUM_POINT, batch_size=BATCH, lr=LR)
    # cosine-decayed Adam: constant lr plateaus ~2x higher on this fixed
    # batch (Adam oscillates near the optimum); decay to lr/20 by the end
    model, state, opt = create_train_state(
        cfg, seed=0, device=args.device, lr=cosine_decay_schedule(LR, STEPS, alpha=0.05))
    device = next(model.parameters()).device
    train_step = make_train_step(model, opt, cfg)

    before = metrics(model, batch, gt_mk, cfg)
    print("before:", json.dumps(before), flush=True)

    with tempfile.TemporaryDirectory() as workdir:
        ckpt_dir = os.path.join(workdir, "ckpt")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.time()
        losses, loss_trace = None, []
        for i in range(STEPS):
            state, losses = train_step(state, batch)
            if i % 25 == 0 or i == STEPS - 1:
                l = float(losses["all_loss"])
                loss_trace.append(round(l, 4))
                comps = " ".join(f"{k.replace('_loss', '')}={float(v):.4f}"
                                 for k, v in sorted(losses.items()) if k != "all_loss")
                print(f"step {i:4d} loss {l:.4f} [{comps}] "
                      f"({(time.time() - t0) / (i + 1):.3f} s/step)", flush=True)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.time() - t0
        save_train_state(ckpt_dir, STEPS, state, cfg.to_json())

        after = metrics(model, batch, gt_mk, cfg)
        print("after:", json.dumps(after), flush=True)
        print("running eval CLI with random weights...", flush=True)
        t0 = time.time()
        v2v_raw_before = run_eval_cli("random", None, workdir, device)
        print("running eval CLI with the trained checkpoint...", flush=True)
        with recorded_fits() as fits:
            v2v_raw_after = run_eval_cli("trained", ckpt_dir, workdir, device)
        (trained_mk,), (trained_valid,) = zip(*fits)     # one batch of one scan
        eval_s = time.time() - t0

        # V2V without the licensed pkls: the CLI-exported fitted meshes
        # against the oracle fit (same topology) and their 86 marker
        # vertices against the real GT marker positions
        print("computing oracle fit...", flush=True)
        oracle_verts, vids = oracle_fit(markerset, gt_mk, device)
        fv = {t: fitted_mesh_verts(t, workdir) for t in ("random", "trained")}
    v2v_oracle = {t: float(np.mean(np.linalg.norm(v - oracle_verts, axis=1))) * 100.0
                  for t, v in fv.items()}
    marker_v2v = {t: float(np.mean(np.linalg.norm(v[vids] - gt_mk, axis=1))) * 100.0
                  for t, v in fv.items()}
    print(f"V2V vs oracle fit: random {v2v_oracle['random']:.3f} cm, "
          f"trained {v2v_oracle['trained']:.3f} cm", flush=True)
    print(f"marker V2V vs real GT: random {marker_v2v['random']:.3f} cm, "
          f"trained {marker_v2v['trained']:.3f} cm", flush=True)

    result = {
        "sample_id": SAMPLE_ID,
        "steps": STEPS,
        "num_point": NUM_POINT,
        "batch": BATCH,
        "lr": LR,
        "backend": device.type,
        "device": device_line(device),
        "train_seconds": round(train_s, 1),
        "eval_cli_seconds": round(eval_s, 1),
        "loss_trace": loss_trace,
        "before": before,
        "after": after,
        "v2v_oracle_cm_random": round(v2v_oracle["random"], 3),
        "v2v_oracle_cm_trained": round(v2v_oracle["trained"], 3),
        "marker_v2v_cm_random": round(marker_v2v["random"], 3),
        "marker_v2v_cm_trained": round(marker_v2v["trained"], 3),
        "v2v_raw_cm_random": round(v2v_raw_before, 3),
        "v2v_raw_cm_trained": round(v2v_raw_after, 3),
        "direction_cosine_ceiling": direction_ceiling(batch),
        "trained_markers": trained_mk[0].tolist(),
        "trained_markers_valid": trained_valid[0].tolist(),
        "note": (
            "synthetic smoke-test body (real SMPL pkls are not "
            "redistributable): v2v_raw_* (vertex-indexed vs the real SMPL "
            "mesh) is dominated by the topology mismatch and recorded only "
            "for honesty; v2v_oracle_* is the same-topology V2V against the "
            "GT-marker oracle fit and marker_v2v_* the cross-topology-valid "
            "error vs real GT markers (tools/realdata_closed_loop.py). "
            "direction_cosine_ceiling: best cosine achievable by a field "
            "at the 512-center feature resolution."
        ),
        "pass_marker": after["marker_err_cm"] < 0.5 * before["marker_err_cm"],
        "pass_cosine": after["direction_cosine"] > 0.8,
        "pass_v2v": v2v_oracle["trained"] < 0.5 * v2v_oracle["random"],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    print("wrote", args.out)
    if not (result["pass_marker"] and result["pass_cosine"] and result["pass_v2v"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
