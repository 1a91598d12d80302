"""Inference demo CLI: one scan -> fitted SMPL obj + smpl-info npz.

Port of `etch_tpu/cli/infer.py` (reference src/inference_demo.py): the same
flags and output files, plus `--device` (default `cuda`).  The device is
explicit: without a CUDA device `--device cuda` raises instead of running
on the CPU; `--device cpu` runs every kernel's plain version.

    python -m etch_tpu_torch.cli.infer --scan_path <scan.obj> \\
        --allow_synthetic_body --output_folder output

`--model_path` is a checkpoint of the port's format (`train/checkpoint.py`:
a training checkpoint directory or a `save_params` file; without it the
weights are random); the body is the SMPL pkl under
`datafolder/body_models/`, or with `--allow_synthetic_body` a synthetic one
where that pkl is missing.
"""

from __future__ import annotations

import argparse

import torch

from etch_tpu_torch.cli.common import load_markerset
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.utils.config import EtchConfig


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scan_path", type=str, required=True)
    p.add_argument(
        "--gender", type=str, default="neutral",
        choices=["neutral", "male", "female"],
    )
    p.add_argument("--model_path", type=str, default="")
    p.add_argument(
        "--markerset_path",
        default="datafolder/useful_data_4d-dress/superset_smpl.json", type=str,
    )
    p.add_argument("--output_folder", type=str, default="output")
    p.add_argument("--num_point", type=int, default=5000)
    p.add_argument("--scale_magnitude", type=int, default=10)
    p.add_argument("--EPN_input_radius", type=float, default=0.4)
    p.add_argument("--EPN_layer_num", type=int, default=2)
    p.add_argument("--datafolder_root", type=str, default=".")
    p.add_argument(
        "--allow_synthetic_body", action="store_true",
        help="smoke-test without SMPL pkls (random body; results meaningless)",
    )
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda runs the CUDA kernels, cpu the plain versions")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch sees no CUDA device "
                           f"(pass --device cpu to run on the CPU)")
    cfg = EtchConfig(
        num_point=args.num_point,
        epn_input_radius=args.EPN_input_radius,
        epn_layer_num=args.EPN_layer_num,
        scale_magnitude=float(args.scale_magnitude),
    )
    markerset = load_markerset(args.markerset_path)
    pipe = build_pipeline(
        cfg,
        markerset,
        checkpoint_path=args.model_path or None,
        gender=args.gender,
        datafolder_root=args.datafolder_root,
        allow_synthetic_body=args.allow_synthetic_body,
        device=device,
    )
    result = pipe.run_scan(args.scan_path)
    obj_path, npz_path = pipe.export(result, args.scan_path, args.output_folder)
    print(
        f"Predicted SMPL mesh saved to: {obj_path}, smpl info saved to: {npz_path}"
    )
    return obj_path, npz_path


if __name__ == "__main__":
    main()
