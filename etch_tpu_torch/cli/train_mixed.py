"""All-in-one mixed-dataset training CLI (reference src/train_mixed.py parity).

Port of `etch_tpu/cli/train_mixed.py`: the same flags, defaults and
experiment folder naming (`mixed_EPN_layer_...`).  Concatenates the
datasets of `--dataset_spec` (4D-Dress, Generative, CAPE, ...) with
bbox-centered scans and a random y-axis rotation of each item
(GT_dataloader_mixed.py:176-199; `--no_augment` turns it off), and under
`--use_dynamic_label_confidence` regenerates labels and confidences from
the predicted inner points (train_mixed.py:124-158,493-498).  The epoch
loop, the log and the checkpoints are `cli/train.py`'s, data parallel in
the same way:

    python -m etch_tpu_torch.cli.train_mixed --dataset_spec scan:smpl:npz[:ids.pkl] ...
    torchrun --nproc_per_node 4 -m etch_tpu_torch.cli.train_mixed --batch_size 8 ...

`main` returns the experiment folder and the final `TrainState`.
"""

from __future__ import annotations

import argparse

from etch_tpu_torch.cli.common import add_model_args, config_from_args, load_markerset
from etch_tpu_torch.cli.train import add_train_args, experiment_folder, train_epochs
from etch_tpu_torch.data.dataset import ConcatDataset, DatasetPaths, GTDataset
from etch_tpu_torch.parallel.mesh import make_mesh, replicate
from etch_tpu_torch.train.state import (BATCH_KEYS, create_train_state, make_train_step,
                                        make_train_step_dynamic)


def main(argv=None):
    p = argparse.ArgumentParser()
    add_model_args(p)
    p.add_argument(
        "--dataset_spec", type=str, nargs="+", required=True,
        help="one or more 'scan_dir:smpl_dir:infopoints_dir[:ids_pkl]' specs",
    )
    add_train_args(p)
    p.add_argument("--use_dynamic_label_confidence", action="store_true")
    p.add_argument("--no_augment", action="store_true")
    args = p.parse_args(argv)

    cfg = config_from_args(args)
    mesh = make_mesh(args.device)
    output_folder = experiment_folder(args, cfg, "mixed_", write=mesh.rank == 0)

    marker_vids = list(load_markerset(args.markerset_path).values())
    datasets = []
    for spec in args.dataset_spec:
        parts = spec.split(":")
        scan_dir, smpl_dir, info_dir = parts[:3]
        ids_pkl = parts[3] if len(parts) > 3 else None
        datasets.append(GTDataset(
            DatasetPaths(scan_dir=scan_dir, smpl_dir=smpl_dir, infopoints_dir=info_dir,
                         activated_ids_path=ids_pkl),
            num_point=cfg.num_point,
            marker_vertex_ids=marker_vids,
            seed=cfg.seed,
            center=True,
            augment_rotation=not args.no_augment,
            include_marker_positions=args.use_dynamic_label_confidence,
        ))
    dataset = ConcatDataset(datasets)
    if mesh.rank == 0:
        print(f"Num of data (mixed): {len(dataset)}")

    model, state, opt = create_train_state(cfg, seed=cfg.seed, device=mesh.device)
    state = replicate(mesh, state)
    if args.use_dynamic_label_confidence:
        train_step = make_train_step_dynamic(model, opt, cfg)
        keys = ("hitpts", "vectors", "markers_positions")
    else:
        train_step = make_train_step(model, opt, cfg)
        keys = BATCH_KEYS
    try:
        state = train_epochs(cfg, dataset, state, train_step, mesh, output_folder,
                             args.num_workers, keys)
    finally:
        mesh.close()
    return output_folder, state


if __name__ == "__main__":
    main()
