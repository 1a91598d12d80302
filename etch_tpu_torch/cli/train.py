"""Training CLI (reference src/train.py parity).

Port of `etch_tpu/cli/train.py`: the same flags, defaults and experiment
folder naming, `training_args.json`, the `log_all/` JSONL loss log and a
checkpoint for each epoch (`checkpoints/<epoch>.pt`, the port's format,
`train/checkpoint.py`), plus `--device` (default `cuda`; `--device cpu`
trains with every kernel's plain version).  Data parallel as the JAX CLI
is (`parallel/mesh.py`): under `torchrun` each rank loads every global
batch of `--batch_size` in the same seeded order and trains on its slice,
one card a rank; rank 0 alone writes the folder, the log and the
checkpoints.

    python -m etch_tpu_torch.cli.train --scan_dir ... --smpl_dir ... \\
        --infopoints_dir ... --batch_size 1 --epochs 2
    torchrun --nproc_per_node 4 -m etch_tpu_torch.cli.train --batch_size 8 ...

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
from etch_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
from etch_tpu_torch.train.checkpoint import save_train_state
from etch_tpu_torch.train.state import BATCH_KEYS, create_train_state, make_train_step
from etch_tpu_torch.utils.logging import MetricLogger


def add_train_args(p: argparse.ArgumentParser):
    """The flags `cli/train.py` and `cli/train_mixed.py` share."""
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
                   help="torch device; cuda runs the CUDA kernels (a card a rank under "
                        "torchrun), cpu the plain versions")


def experiment_folder(args, cfg, prefix: str, write: bool) -> str:
    """The experiment folder (auto-named as reference train.py:185-195),
    with `training_args.json` when `write` (rank 0)."""
    if args.output_folder is None:
        name = (
            f"{prefix}EPN_layer_{cfg.epn_layer_num}_radius_{cfg.epn_input_radius}"
            f"_num_point_{cfg.num_point}"
        )
        if args.i:
            name += f"_{args.i}"
        args.output_folder = os.path.join("all_experiments/experiments", name)
    if write:
        os.makedirs(args.output_folder, exist_ok=True)
        with open(os.path.join(args.output_folder, "training_args.json"), "w") as f:
            json.dump(vars(args), f, indent=4, default=str)
    return args.output_folder


def train_epochs(cfg, dataset, state, train_step, mesh, output_folder, num_workers,
                 keys=BATCH_KEYS):
    """`cfg.epochs` epochs over `dataset` in global batches of
    `cfg.batch_size`, each rank training on its slice of the batch's
    `keys`; rank 0 logs the epoch's mean losses and checkpoints the state."""
    logger = MetricLogger(os.path.join(output_folder, "log_all")) if mesh.rank == 0 else None
    for epoch in range(cfg.epochs):
        epoch_losses = defaultdict(float)
        nb = 0
        t0 = time.time()
        for batch in batch_iterator(
            dataset, cfg.batch_size, shuffle=True, seed=cfg.seed + epoch,
            num_workers=num_workers,
        ):
            state, losses = train_step(state, shard_batch(mesh, {k: batch[k] for k in keys}))
            nb += 1
            # summed on the device; read once an epoch
            for k, v in losses.items():
                epoch_losses[k] = epoch_losses[k] + v
        epoch_losses = {k: float(v) / max(nb, 1) for k, v in epoch_losses.items()}
        epoch_losses["epoch_time_s"] = time.time() - t0
        if logger is None:
            continue
        logger.log(epoch, epoch_losses)
        print(f"epoch {epoch}: " + ", ".join(
            f"{k}={v:.5f}" for k, v in epoch_losses.items()
        ))
        save_train_state(
            os.path.join(output_folder, "checkpoints"), epoch, state,
            config_json=cfg.to_json(),
        )
    return state


def main(argv=None):
    p = argparse.ArgumentParser()
    add_model_args(p)
    add_data_args(p)
    add_train_args(p)
    args = p.parse_args(argv)

    cfg = config_from_args(args)
    mesh = make_mesh(args.device)
    output_folder = experiment_folder(args, cfg, "", write=mesh.rank == 0)

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
    if mesh.rank == 0:
        print(f"Num of data: {len(dataset)}")

    model, state, opt = create_train_state(cfg, seed=cfg.seed, device=mesh.device)
    state = replicate(mesh, state)
    try:
        state = train_epochs(cfg, dataset, state, make_train_step(model, opt, cfg), mesh,
                             output_folder, args.num_workers)
    finally:
        mesh.close()
    return output_folder, state


if __name__ == "__main__":
    main()
