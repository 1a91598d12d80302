"""Fixed-seed overfit harness of the PyTorch port (model-quality evidence).

The port's counterpart of `tools/overfit_harness.py`, with the same recipe:
the full `EtchConfig()` EtchNet (EPN encoder and all three heads at the
reference widths) trained on 8 fixed synthetic scans with analytic ground
truth (`etch_tpu_torch/train/synthetic.py::make_batch`, the harness's
batch: a bumpy capsule over a smooth one, N=512, seed 42) for 150 Adam
steps at lr 2e-3, through the port's `make_train_step` (the NaN guard
included), then the mean cosine between the predicted and the analytic
directions.  The weights are the port's own initialisation
(`create_train_state(seed=0)`), so the trace is not the JAX one; the gates
are relative to the run's own first loss.

Consumed by:
  * tests/test_torch_evidence.py: a short CPU run of `train` at tiny
    widths whose loss must fall, and the artifact's recipe held to these
    constants;
  * tools/torch_overfit_evidence.py: the full 150-step gate on the card,
    writing docs/evidence/overfit_h100.json.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from etch_tpu_torch.train.state import create_train_state, make_train_step
from etch_tpu_torch.train.synthetic import make_batch
from etch_tpu_torch.utils.config import EtchConfig

BATCH = 8
N_POINT = 512  # smallest N that keeps >=2 points at the U-Net's coarsest level
LR = 2e-3      # overfit-rate Adam; production training uses cfg.lr = 1e-4
SEED = 42
STEPS = 150    # the evidence run's step budget (tools/torch_overfit_evidence.py)


def device_line(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (its first card), or
    "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device="cuda") -> dict:
    """The recipe: the full `EtchConfig()` EtchNet trained on the fixed
    synthetic batch (BATCH scans of N_POINT points, SEED) for STEPS Adam
    steps at LR on `device`.  Returns `train`'s dict."""
    cfg = EtchConfig(num_point=N_POINT, batch_size=BATCH, lr=LR)
    return train(cfg, make_batch(np.random.RandomState(SEED), BATCH, N_POINT), STEPS,
                 device, seed=SEED)


def train(cfg: EtchConfig, batch: dict, steps: int, device, seed: int) -> dict:
    """Train `cfg`'s EtchNet from the port's initialisation on `batch` (from
    `make_batch(RandomState(seed), ...)`) for `steps` Adam steps at cfg.lr.
    Returns {"losses": [per-step], "initial", "final" (mean of the last 5
    losses), "cosine", "steps", "lr", "batch", "n_point", "seed",
    "train_seconds"}; the losses stay on the device until the run ends."""
    model, state, opt = create_train_state(cfg, seed=0, device=device)
    device = next(model.parameters()).device
    step = make_train_step(model, opt, cfg)

    losses = []
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, out = step(state, batch)
        losses.append(out["all_loss"])
    _sync(device)
    train_seconds = time.perf_counter() - t0
    losses_log = torch.stack(losses).tolist()

    # direction head quality: mean cosine between the predicted direction
    # and the analytic one
    with torch.no_grad():
        outputs = model(torch.as_tensor(batch["hitpts"], device=device), train=False)
    pred_dir = outputs["direction"].cpu().numpy()
    gt = batch["vectors"]
    gt_dir = gt / np.maximum(np.linalg.norm(gt, axis=-1, keepdims=True), 1e-8)
    pd = pred_dir / np.maximum(np.linalg.norm(pred_dir, axis=-1, keepdims=True), 1e-8)
    cosine = float(np.mean(np.sum(gt_dir * pd, axis=-1)))

    return {
        "losses": losses_log,
        "initial": losses_log[0],
        "final": float(np.mean(losses_log[-5:])),
        "cosine": cosine,
        "steps": steps,
        "lr": cfg.lr,
        "batch": cfg.batch_size,
        "n_point": cfg.num_point,
        "seed": seed,
        "train_seconds": train_seconds,
    }
