"""Training CLI (reference src/train.py parity).

Port of `etch_tpu/cli/train.py`: the same flags, defaults and experiment
folder naming, `training_args.json`, the `log_all/` JSONL loss log and a
checkpoint for each epoch (`checkpoints/<epoch>.pt`, the port's format,
`train/checkpoint.py`), plus `--device` (default `cuda`; `--device cpu`
trains with every kernel's plain version).  One device: data parallelism
and `cli/train_mixed.py` are not ported yet.

    python -m etch_tpu_torch.cli.train --scan_dir ... --smpl_dir ... \\
        --infopoints_dir ... --batch_size 1 --epochs 2

The losses of a step stay on the device; they are summed there and read
once an epoch.  `main` returns the experiment folder and the final
`TrainState`.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

from etch_tpu_torch.cli.common import (add_data_args, add_model_args, config_from_args,
                                       load_markerset)
from etch_tpu_torch.data.dataset import DatasetPaths, GTDataset, batch_iterator
from etch_tpu_torch.train.checkpoint import save_train_state
from etch_tpu_torch.train.state import create_train_state, make_train_step
from etch_tpu_torch.utils.logging import MetricLogger


def main(argv=None):
    p = argparse.ArgumentParser()
    add_model_args(p)
    add_data_args(p)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--direction_w", type=float, default=1.0)
    p.add_argument("--magnitude_w", type=float, default=1.0)
    p.add_argument("--part_label_w", type=float, default=1.0)
    p.add_argument("--confidence_w", type=float, default=1.0)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--output_folder", type=str, default=None)
    p.add_argument("--i", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda runs the CUDA kernels, cpu the plain versions")
    args = p.parse_args(argv)

    cfg = config_from_args(args)

    # experiment folder auto-naming (reference train.py:185-195)
    if args.output_folder is None:
        name = (
            f"EPN_layer_{cfg.epn_layer_num}_radius_{cfg.epn_input_radius}"
            f"_num_point_{cfg.num_point}"
        )
        if args.i:
            name += f"_{args.i}"
        args.output_folder = os.path.join("all_experiments/experiments", name)
    os.makedirs(args.output_folder, exist_ok=True)
    with open(os.path.join(args.output_folder, "training_args.json"), "w") as f:
        json.dump(vars(args), f, indent=4, default=str)

    markerset = load_markerset(args.markerset_path)
    marker_vids = list(markerset.values())

    dataset = GTDataset(
        DatasetPaths(
            scan_dir=args.scan_dir,
            smpl_dir=args.smpl_dir,
            infopoints_dir=args.infopoints_dir,
            activated_ids_path=args.activated_ids_path,
        ),
        num_point=cfg.num_point,
        marker_vertex_ids=marker_vids,
        seed=cfg.seed,
    )
    print(f"Num of data: {len(dataset)}")

    model, state, opt = create_train_state(cfg, seed=cfg.seed, device=args.device)
    train_step = make_train_step(model, opt, cfg)

    logger = MetricLogger(os.path.join(args.output_folder, "log_all"))

    for epoch in range(cfg.epochs):
        epoch_losses = defaultdict(float)
        nb = 0
        t0 = time.time()
        for batch in batch_iterator(
            dataset, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
            num_workers=args.num_workers,
        ):
            state, losses = train_step(state, batch)
            nb += 1
            # summed on the device; read once an epoch
            for k, v in losses.items():
                epoch_losses[k] = epoch_losses[k] + v
        epoch_losses = {k: float(v) / max(nb, 1) for k, v in epoch_losses.items()}
        epoch_losses["epoch_time_s"] = time.time() - t0
        logger.log(epoch, epoch_losses)
        print(f"epoch {epoch}: " + ", ".join(
            f"{k}={v:.5f}" for k, v in epoch_losses.items()
        ))
        save_train_state(
            os.path.join(args.output_folder, "checkpoints"), epoch, state,
            config_json=cfg.to_json(),
        )
    return args.output_folder, state


if __name__ == "__main__":
    main()
