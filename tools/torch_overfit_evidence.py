"""Run the PyTorch port's full fixed-seed overfit gate on the card and
record the evidence artifact that tests/test_torch_evidence.py holds to the
JAX package's gates (tests/test_overfit.py: loss below 5% of its initial
value within the step budget, mean direction cosine above 0.95).

    python tools/torch_overfit_evidence.py     # writes docs/evidence/overfit_h100.json

The port's counterpart of tools/overfit_evidence.py (harness:
tools/torch_overfit_harness.py): the same keys, `backend` the torch device
type, plus `device` (the card's name and power limit from nvidia-smi) and
`train_seconds` (the steps alone, synchronised).  `--device cpu` runs it on
the CPU (about 35 s a step at full width); `--out` writes elsewhere.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=os.path.join(REPO, "docs", "evidence", "overfit_h100.json"))
    args = p.parse_args(argv)

    import torch

    from tools import torch_overfit_harness

    result = torch_overfit_harness.run(device=args.device)
    result["backend"] = torch.device(args.device).type
    result["device"] = torch_overfit_harness.device_line(args.device)
    result["loss_ratio"] = result["final"] / result["initial"]
    result["pass_loss"] = result["loss_ratio"] < 0.05
    result["pass_cosine"] = result["cosine"] > 0.95
    # thin the per-step trace for the artifact (keep every 5th + last 5)
    n = len(result["losses"])
    result["losses"] = [
        round(l, 5) for i, l in enumerate(result["losses"])
        if i % 5 == 0 or i >= n - 5
    ]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    print("wrote", args.out)
    if not (result["pass_loss"] and result["pass_cosine"]):
        sys.exit(1)


if __name__ == "__main__":
    main()
