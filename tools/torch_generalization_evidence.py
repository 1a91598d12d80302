"""Held-out generalization evidence of the PyTorch port.

The port's counterpart of tools/generalization_evidence.py, with the same
recipe: the full f32 `EtchConfig()` EtchNet (the port's own initialisation)
trained on the 12 bodies of TRAIN_SEEDS of the synthetic family
(tools/torch_generalization_harness.py, SAMPLINGS = 2 samplings each,
N=5000) for STEPS = 400 Adam steps of B=4 at lr 1e-3 with a cosine decay
to lr/20, then evaluated on the 8 bodies of EVAL_SEEDS, which it never
saw; and the same from the same initial weights on the first 4 and 8
bodies (CURVE, the learning curve).

Reported per split (train / held-out / random weights): direction cosine,
label accuracy, magnitude error, predicted-marker error, and the V2V to
the oracle: the synthetic body fitted by the two-stage LM to the predicted
markers against the same body fitted to the ground-truth markers (same
topology, exact correspondence).  The gates are those of
tests/test_generalization.py, which tests/test_torch_evidence.py applies
to the artifact.

    python tools/torch_generalization_evidence.py   # writes docs/evidence/generalization_h100.json

The artifact has the JAX one's keys, plus `backend` (the torch device
type) and `device` (the card's name and power limit from nvidia-smi).  The
ground truth is built in a temporary directory.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TRAIN_SEEDS = list(range(12))
EVAL_SEEDS = [100 + i for i in range(8)]
CURVE = (4, 8)          # smaller training sets of the learning curve
SAMPLINGS = 2
STEPS = 400
NUM_POINT = 5000
BATCH = 4
LR = 1e-3
EVAL_ITEMS = 8          # items a split's metrics run at once, bounding the forward's memory


def v2v_oracle_cm(model, batch, gt_mk, cfg):
    """V2V (cm) between the synthetic body fitted to the PREDICTED markers
    and the same body fitted to the GT markers."""
    import torch

    from etch_tpu_torch.body.smpl import marker_submodel, smpl_forward
    from etch_tpu_torch.fit.markers import extract_markers
    from etch_tpu_torch.fit.smpl_fit import fit_smpl_params
    from etch_tpu_torch.pipeline import load_body_model

    device = next(model.parameters()).device
    body = load_body_model("neutral", root=REPO, allow_synthetic=True).to(device)
    nv = int(body.v_template.shape[0])
    sub = marker_submodel(body, np.linspace(0, nv - 1, cfg.num_markers).astype(np.int32))
    hitpts = torch.as_tensor(batch["hitpts"], device=device)
    with torch.no_grad():
        out = model(hitpts, train=False)
        inner = hitpts - out["direction"] * out["magnitude"] / cfg.scale_magnitude
        mk_pred, valid_pred = extract_markers(inner, torch.argmax(out["part_labels"], -1),
                                              out["confidences"], num_markers=cfg.num_markers)

        def fit_verts(markers, valid):
            p = fit_smpl_params(sub, markers, valid)
            verts, _ = smpl_forward(body, p["betas"], p["pose"], p["global_orient"],
                                    p["transl"])
            return verts.cpu().numpy()

        v_pred = fit_verts(mk_pred, valid_pred)
        gt = torch.as_tensor(gt_mk, dtype=torch.float32, device=device)
        v_gt = fit_verts(gt, torch.ones(gt.shape[:2], dtype=torch.bool, device=device))
    return float(np.linalg.norm(v_pred - v_gt, axis=-1).mean() * 100.0)


def split_metrics(model, batch, gt_mk, cfg):
    """`metrics` and the V2V to the oracle on the split's first EVAL_ITEMS items."""
    from tools.torch_realdata_closed_loop import metrics

    n = min(EVAL_ITEMS, batch["hitpts"].shape[0])
    b = {k: v[:n] for k, v in batch.items()}
    m = metrics(model, b, gt_mk[:n], cfg)
    m["v2v_oracle_cm"] = round(v2v_oracle_cm(model, b, gt_mk[:n], cfg), 3)
    return m


def train_and_eval(cfg, init_state, train_batch, train_mk, eval_batch, eval_mk, device,
                   steps=STEPS):
    """Train from `init_state` (a model state_dict) on `train_batch` for
    `steps` and return ({"train": metrics, "heldout": metrics}, loss trace,
    seconds of training)."""
    import torch

    from etch_tpu_torch.train.state import (cosine_decay_schedule, create_train_state,
                                            make_train_step)

    model, state, opt = create_train_state(
        cfg, device=device, state_dict=init_state,
        lr=cosine_decay_schedule(LR, steps, alpha=0.05))
    dev = next(model.parameters()).device
    train_step = make_train_step(model, opt, cfg)
    n_items = train_batch["hitpts"].shape[0]
    rng = np.random.RandomState(0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    loss_trace = []
    for i in range(steps):
        idx = rng.choice(n_items, BATCH, replace=n_items < BATCH)
        state, losses = train_step(state, {k: v[idx] for k, v in train_batch.items()})
        if i % 25 == 0 or i == steps - 1:
            loss = float(losses["all_loss"])
            loss_trace.append(round(loss, 4))
            print(f"step {i:4d} loss {loss:.4f} ({(time.time() - t0) / (i + 1):.3f} s/step)",
                  flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = round(time.time() - t0, 1)
    trained = {}
    for split, (b, mk) in (("train", (train_batch, train_mk)),
                           ("heldout", (eval_batch, eval_mk))):
        trained[split] = split_metrics(model, b, mk, cfg)
        print(f"trained {split}:", json.dumps(trained[split]), flush=True)
    return trained, loss_trace, train_s


def gates(held, rnd):
    """tests/test_generalization.py's gates on the held-out split."""
    return {
        "heldout_cosine_gt_0.9": held["direction_cosine"] > 0.9,
        "heldout_label_acc_gt_0.6": held["label_acc"] > 0.6,
        "heldout_marker_err_lt_0.2_random": held["marker_err_cm"] < 0.2 * rnd["marker_err_cm"],
        "heldout_v2v_oracle_lt_0.35_random": held["v2v_oracle_cm"] < 0.35 * rnd["v2v_oracle_cm"],
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(REPO, "docs", "evidence",
                                                 "generalization_h100.json"))
    args = p.parse_args(argv)

    import torch

    from etch_tpu_torch.models.etch_net import EtchNet, init_params
    from etch_tpu_torch.utils.config import EtchConfig
    from tools.torch_generalization_harness import build_items
    from tools.torch_overfit_harness import device_line
    from tools.torch_realdata_closed_loop import direction_ceiling

    k_full = len(TRAIN_SEEDS)
    with tempfile.TemporaryDirectory() as workdir:
        print(f"building {k_full} train bodies x{SAMPLINGS} + {len(EVAL_SEEDS)} held-out "
              f"bodies (N={NUM_POINT})...", flush=True)
        t0 = time.time()
        train_batch, train_mk = build_items(workdir, TRAIN_SEEDS, NUM_POINT,
                                            samplings=SAMPLINGS)
        eval_batch, eval_mk = build_items(workdir, EVAL_SEEDS, NUM_POINT, samplings=1)
        build_s = time.time() - t0
    print(f"GT built in {build_s:.1f}s ({train_batch['hitpts'].shape[0]} train items, "
          f"{eval_batch['hitpts'].shape[0]} eval items)", flush=True)

    cfg = EtchConfig(num_point=NUM_POINT, batch_size=BATCH, lr=LR)
    model0 = EtchNet(cfg)
    init_params(model0, torch.Generator().manual_seed(0))
    init_state = {k: v.clone() for k, v in model0.state_dict().items()}
    model0 = model0.to(args.device)

    results = {
        "config": {"train_bodies": k_full, "samplings": SAMPLINGS,
                   "eval_bodies": len(EVAL_SEEDS), "steps": STEPS, "num_point": NUM_POINT,
                   "batch": BATCH, "lr": LR, "gt_build_seconds": round(build_s, 1)},
        "backend": torch.device(args.device).type,
        "device": device_line(args.device),
        "direction_ceiling_heldout": direction_ceiling(eval_batch),
        "random": {"heldout": split_metrics(model0, eval_batch, eval_mk, cfg)},
    }
    del model0
    print("random heldout:", json.dumps(results["random"]["heldout"]), flush=True)

    # the learning curve: the same steps, schedule, initial weights and eval
    # set on prefixes of the body list, SAMPLINGS items a body
    curve = []
    for k in CURVE:
        n = k * SAMPLINGS
        print(f"--- learning-curve run: K_TRAIN={k} ---", flush=True)
        trained_k, _, secs_k = train_and_eval(
            cfg, init_state, {key: v[:n] for key, v in train_batch.items()}, train_mk[:n],
            eval_batch, eval_mk, args.device)
        curve.append({"k_train": k, "train": trained_k["train"],
                      "heldout": trained_k["heldout"], "train_seconds": secs_k})
    print(f"--- full run: K_TRAIN={k_full} ---", flush=True)
    trained, loss_trace, train_s = train_and_eval(
        cfg, init_state, train_batch, train_mk, eval_batch, eval_mk, args.device)
    results["train_seconds"] = train_s
    results["loss_trace"] = loss_trace
    results["trained"] = trained
    curve.append({"k_train": k_full, "train": trained["train"],
                  "heldout": trained["heldout"], "train_seconds": train_s})
    results["learning_curve"] = curve
    results["gates"] = gates(trained["heldout"], results["random"]["heldout"])
    print("gates:", json.dumps(results["gates"]), flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", args.out, flush=True)
    if not all(results["gates"].values()):
        sys.exit(1)


if __name__ == "__main__":
    main()
