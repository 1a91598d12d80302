"""MPJPE over eval outputs (reference
scripts/experiment_scripts/compute_mpjpe_error.py:14-33): mean per-joint
position error over the first 22 joints between predicted output_smpl_info npz
files and GT info npz files.  A copy of `etch_tpu/cli/compute_mpjpe.py`
(numpy only), reading the port's `cli/evaluate` outputs:

    python -m etch_tpu_torch.cli.compute_mpjpe \\
        --pred_dir all_experiments/experiments/eval_outputs_default \\
        --gt_dir datafolder/4D-DRESS/data_processed/smplh
"""

from __future__ import annotations

import argparse
import os

import numpy as np

JOINTS_CONSIDERED = 22


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dir", type=str, required=True)
    p.add_argument("--gt_dir", type=str, required=True)
    args = p.parse_args(argv)

    total, n = 0.0, 0
    for file in sorted(os.listdir(args.pred_dir)):
        d = os.path.join(args.pred_dir, file)
        if not os.path.isdir(d):
            continue
        gt_path = os.path.join(args.gt_dir, file, f"info_{file}.npz")
        pred_path = os.path.join(d, f"output_smpl_info_{file}.npz")
        if not (os.path.isfile(gt_path) and os.path.isfile(pred_path)):
            continue
        gt = np.load(gt_path)["joints"]
        pred = np.load(pred_path)["joints"]
        err = np.linalg.norm(
            pred[:JOINTS_CONSIDERED] - gt[:JOINTS_CONSIDERED], axis=-1
        ).mean()
        print(f"{file}: {err}")
        total += err
        n += 1
    if n:
        print("mean MPJPE: ", total / n)
        print("count: ", n)


if __name__ == "__main__":
    main()
