"""Shared CLI plumbing: flag definitions mirroring the reference entry
points (src/train.py:144-175, src/eval.py:271-289,
src/inference_demo.py:69-81).  A copy of `etch_tpu/cli/common.py`, the flags
and defaults unchanged, building the port's `EtchConfig`."""

from __future__ import annotations

import argparse

from etch_tpu_torch.pipeline import load_markerset  # noqa: F401
from etch_tpu_torch.utils.config import EtchConfig


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--num_point", type=int, default=5000)
    p.add_argument("--EPN_input_radius", type=float, default=0.4)
    p.add_argument("--EPN_layer_num", type=int, default=2)
    p.add_argument("--scale_magnitude", type=int, default=10)
    p.add_argument(
        "--markerset_path",
        type=str,
        default="datafolder/useful_data_4d-dress/superset_smpl.json",
    )
    p.add_argument("--seed", type=int, default=1)
    p.add_argument(
        "--use_bfloat16", action="store_true",
        help="bf16 compute for heads/attention/intra-conv (f32 params and "
             "accumulation); inference defaults to this in bench, training "
             "defaults to f32 like the reference's TF32-off policy",
    )


def add_data_args(p: argparse.ArgumentParser):
    p.add_argument(
        "--activated_ids_path", type=str,
        default="datafolder/useful_data_4d-dress/train_ids.pkl",
    )
    p.add_argument(
        "--infopoints_dir", type=str, default="datafolder/gt_4D-Dress_data/npz"
    )
    p.add_argument(
        "--scan_dir", type=str, default="datafolder/4D-DRESS/data_processed/model"
    )
    p.add_argument(
        "--smpl_dir", type=str, default="datafolder/4D-DRESS/data_processed/smplh"
    )


def config_from_args(args) -> EtchConfig:
    return EtchConfig(
        num_point=args.num_point,
        epn_input_radius=args.EPN_input_radius,
        epn_layer_num=args.EPN_layer_num,
        scale_magnitude=float(args.scale_magnitude),
        batch_size=getattr(args, "batch_size", 1),
        lr=getattr(args, "lr", 1e-4),
        epochs=getattr(args, "epochs", 30),
        seed=args.seed,
        direction_w=getattr(args, "direction_w", 1.0),
        magnitude_w=getattr(args, "magnitude_w", 1.0),
        part_label_w=getattr(args, "part_label_w", 1.0),
        confidence_w=getattr(args, "confidence_w", 1.0),
        use_bfloat16=getattr(args, "use_bfloat16", False),
    )
