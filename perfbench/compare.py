"""The numbers that decide `correct`, and their limits.

Serving (a batch of scans that the window finished, drawn from the seed):
  - `vectors_rel`, `conf_rel`: the served tightness vectors and confidences
    against the plain f32 reference's on the same points, as the norm of
    the difference over the norm of the reference's (the whole batch);
  - `conf_ratio`: the confidences' distance from the reference's over the
    distance of the reference's own at the configuration's precision (bf16
    operands, f32 sums) from it: the confidences' error in units of their
    own rounding, which a seed's weights scale by ten times and more;
  - `labels_off`: the share of points whose served part label is not the
    reference's;
  - `verts_mm`: the fit, stage by stage: the reference's markers, LM fit
    and SMPL run on the program's own inner points, labels and
    confidences, and the largest distance of a served vertex from the
    reference's, in millimetres.  (The LM fit is ill-conditioned on the
    markers of random weights, so a fit that starts from the reference's
    own markers would judge the network's rounding twice.)
Training (the first three steps, which set-up drives through the window's
call):
  - `loss1_rel`, `loss_rel`: the relative gap of the first step's loss,
    and the largest of the three steps';
  - `grad_gap`: the norm of each leaf's first gradient, as Adam's first
    moment after step 1 gives it (m / (1 - beta1)), against the
    reference's, by the worst leaf: |a - b| / max(b, the median leaf's b);
  - `change_gap`: the same of each parameter's change after three steps,
    leaving out the leaves whose reference gradient is under a thousandth
    of the median leaf's (their Adam step is round-off, signed at random);
  - `bn_gap`: the same of each BatchNorm running statistic's change.

Limits live in `limits/<workload>.json` (name -> {"limit": x, ...}); a
number without a limit there is printed and not held.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parent / "limits"
ZERO_GRADIENT_SHARE = 1e-3


def load_limits(workload: str) -> dict:
    path = LIMITS / f"{workload}.json"
    return {k: float(v["limit"]) for k, v in json.loads(path.read_text()).items()}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp(min=1e-30))


def serve_numbers(served: dict, ref_net: dict, ref_verts: torch.Tensor,
                  own: dict = None) -> dict:
    """served: the program's outputs (vectors, confidences, part_labels,
    verts); ref_net: the reference's network outputs on the same points;
    ref_verts: the reference's fit from the served network outputs; own:
    the reference at the configuration's own precision (bf16 operands),
    which scales `conf_ratio`."""
    dv = torch.linalg.norm(served["verts"].double() - ref_verts.double(), dim=-1)
    out = {}
    if own is not None:
        c = ref_net["confidences"].double()
        out["conf_ratio"] = float(torch.linalg.norm(served["confidences"].double() - c)
                                  / torch.linalg.norm(own["confidences"].double() - c)
                                  .clamp(min=1e-30))
    return out | {
        "vectors_rel": rel(served["vectors"], ref_net["vectors"]),
        "conf_rel": rel(served["confidences"], ref_net["confidences"]),
        "labels_off": float((served["part_labels"].long() != ref_net["part_labels"].long())
                            .double().mean()),
        "verts_mm": float(dv.max()) * 1e3 if torch.isfinite(dv).all() else math.inf,
    }


def leaf_gap(a: dict, b: dict, keep=None) -> float:
    """max over leaves of |a - b| / max(b, median b): a and b map a leaf to
    its norm, the program's and the reference's."""
    names = [k for k in b if keep is None or keep(k)]
    if not names:
        return 0.0
    ref = torch.tensor([b[k] for k in names], dtype=torch.float64)
    got = torch.tensor([a[k] for k in names], dtype=torch.float64)
    floor = torch.maximum(ref, ref.median())
    gap = (got - ref).abs() / floor.clamp(min=1e-30)
    return float(gap.max()) if torch.isfinite(gap).all() else math.inf


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: "losses" (a list of each step's loss), "grad" (leaf ->
    norm of the first gradient), "change" (parameter -> norm of its change
    after the checked steps), "buffers" (BatchNorm statistic -> norm of its
    change)."""
    losses = [abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["losses"], ref["losses"])]
    g = ref["grad"]
    med = float(torch.tensor(list(g.values()), dtype=torch.float64).median())
    moving = lambda k: g[k] >= ZERO_GRADIENT_SHARE * med
    loss_rel = max(losses) if all(math.isfinite(x) for x in losses) else math.inf
    return {
        "loss1_rel": losses[0] if math.isfinite(losses[0]) else math.inf,
        "loss_rel": loss_rel,
        "grad_gap": leaf_gap(prog["grad"], g),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving),
        "bn_gap": leaf_gap(prog["buffers"], ref["buffers"]),
    }


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number with its limit (None where the number
    is not held); correct when every held number is within its limit."""
    checks, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        if lim is not None and not v <= lim:
            ok = False
    return ok, checks
