"""Evaluation CLI (reference src/eval.py parity): per-sample debug exports,
per-batch SMPL fitting grouped by gender, V2V scoring into v2v_score.txt.

Port of `etch_tpu/cli/evaluate.py`: the same flags, eval split default,
output folder, files and line formats, plus `--device` (default `cuda`;
without a CUDA device it raises instead of running on the CPU, and
`--device cpu` runs every kernel's plain version).

    python -m etch_tpu_torch.cli.evaluate --allow_synthetic_body \\
        --activated_ids_path <ids.pkl> --model_path <checkpoint> --save_debug

`predict` and `fit` leave their tensors on the pipeline's device; each
batch's results come to the host once, where the files are written.  V2V is
taken in float64 between the fitted f32 vertices and the GT SMPL OBJ, as
the JAX package takes it.  Without `--model_path` every per-gender pipeline
draws the same random weights (`build_pipeline(rng_seed=0)`), so one
forward serves the whole batch.  The part-label PLYs are coloured by the
port's viridis table (`utils/colormap.py`).  `main` returns the output
folder, the average V2V (None without a GT mesh) and the seconds spent in
each stage (dataset load, pipeline build, forward, fit, export).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from etch_tpu_torch.cli.common import (add_data_args, add_model_args, config_from_args,
                                       load_markerset)
from etch_tpu_torch.data.dataset import DatasetPaths, GTDataset, batch_iterator
from etch_tpu_torch.data.mesh import (TriMesh, load_obj, save_obj, save_points_with_color,
                                      save_points_with_vector)
from etch_tpu_torch.pipeline import build_pipeline
from etch_tpu_torch.utils.colormap import viridis

# fixed label->color shuffle for visualization parity (reference eval.py:66-69)
_SHUFFLE = [75, 0, 70, 22, 12, 56, 10, 18, 4, 67, 61, 64, 53, 73, 62, 66, 33,
            78, 54, 72, 11, 30, 40, 28, 9, 65, 5, 39, 31, 35, 45, 44, 16, 42,
            34, 7, 49, 82, 19, 83, 25, 47, 13, 24, 3, 17, 38, 8, 68, 6, 55,
            36, 77, 85, 43, 50, 46, 84, 15, 69, 27, 41, 58, 26, 48, 76, 57,
            32, 81, 59, 63, 79, 37, 29, 1, 52, 21, 2, 23, 80, 74, 20, 60, 71,
            14, 51]


def shuffle_label(labels: np.ndarray) -> np.ndarray:
    return np.asarray(_SHUFFLE)[labels]


def _save_debug(d, id_, batch, j, pred, L):
    """The per-sample debug exports (reference eval.py:136-179)."""
    hp = batch["hitpts"][j]
    pv, pl, gl = pred["vectors"][j], pred["part_labels"][j], batch["labels"][j]
    np.savez(
        os.path.join(d, f"tightness_vectors_info_{id_}.npz"),
        hitpts=hp, pred_vectors=pv,
        pred_part_labels=pl,
        pred_confidences=pred["confidences"][j],
        gt_vectors=batch["vectors"][j],
        gt_labels=gl,
        gt_confidences=batch["confidences"][j],
    )
    save_points_with_vector(hp, pv, os.path.join(d, f"hitpts_pred_vectors_{id_}.ply"))
    save_points_with_vector(hp, batch["vectors"][j],
                            os.path.join(d, f"hitpts_gt_vectors_{id_}.ply"))
    save_points_with_color(hp, viridis(shuffle_label(gl) / (L - 1)),
                           os.path.join(d, f"hitpts_gt_part_labels_{id_}.ply"))
    save_points_with_color(hp, viridis(shuffle_label(pl) / (L - 1)),
                           os.path.join(d, f"hitpts_pred_part_labels_{id_}.ply"))
    save_points_with_color(hp - pv, viridis(shuffle_label(pl) / (L - 1)),
                           os.path.join(d, f"pred_inner_points_pred_part_labels_{id_}.ply"))


def main(argv=None):
    p = argparse.ArgumentParser()
    add_model_args(p)
    add_data_args(p)
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=3)
    p.add_argument("--i", type=str, default=None)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--datafolder_root", type=str, default=".")
    p.add_argument("--allow_synthetic_body", action="store_true")
    # reference eval.py exports ~10 debug plys per sample; default OFF here
    # so a plain eval run measures V2V without paying the file IO
    p.add_argument("--save_debug", action=argparse.BooleanOptionalAction,
                   default=False)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; cuda runs the CUDA kernels, cpu the plain versions")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: torch sees no CUDA device "
                           f"(pass --device cpu to run on the CPU)")
    # eval default split (reference eval.py:273)
    if args.activated_ids_path.endswith("train_ids.pkl"):
        args.activated_ids_path = (
            "datafolder/useful_data_4d-dress/val_ids_sampled_ratio10.pkl"
        )

    cfg = config_from_args(args)
    output_folder = os.path.join(
        "all_experiments/experiments", f"eval_outputs_{args.i or 'default'}"
    )
    os.makedirs(output_folder, exist_ok=True)

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

    pipes = {}
    seconds = dict.fromkeys(("load", "build", "forward", "fit", "export"), 0.0)

    def pipe_for(gender):
        if gender not in pipes:
            t0 = time.perf_counter()
            pipes[gender] = build_pipeline(
                cfg, markerset, checkpoint_path=args.model_path,
                gender=gender, datafolder_root=args.datafolder_root,
                allow_synthetic_body=args.allow_synthetic_body, device=device,
            )
            seconds["build"] += time.perf_counter() - t0
        return pipes[gender]

    score_path = os.path.join(output_folder, "v2v_score.txt")
    if os.path.exists(score_path):
        os.remove(score_path)

    total_v2v, n_samples = 0.0, 0
    batches = batch_iterator(dataset, args.batch_size, shuffle=False, drop_last=False,
                             num_workers=args.num_workers)
    while True:
        t0 = time.perf_counter()
        batch = next(batches, None)
        seconds["load"] += time.perf_counter() - t0
        if batch is None:
            break
        B = batch["hitpts"].shape[0]
        # forward with any pipeline (params identical across genders)
        pipe = pipe_for(batch["gender"][0])
        t0 = time.perf_counter()
        pred = pipe.predict(batch["hitpts"])
        host = {k: pred[k].cpu().numpy() for k in ("vectors", "part_labels", "confidences")}
        seconds["forward"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        if args.save_debug:
            for j in range(B):
                id_ = batch["id"][j]
                d = os.path.join(output_folder, id_)
                os.makedirs(d, exist_ok=True)
                _save_debug(d, id_, batch, j, host, len(marker_vids))
        seconds["export"] += time.perf_counter() - t0

        # fit grouped by gender (reference eval.py:185-211): one batched fit
        # per gender present in the batch, not B serial B=1 fits
        by_gender = {}
        for j in range(B):
            by_gender.setdefault(batch["gender"][j], []).append(j)
        fits = {}
        for gender, idxs in by_gender.items():
            gp = pipe_for(gender)
            t0 = time.perf_counter()
            sel = torch.as_tensor(idxs, device=gp.device)
            verts_g, params_g, _, valid_g, joints_g = gp.fit(
                pred["inner_points"][sel],
                pred["part_labels"][sel],
                pred["confidences"][sel],
            )
            verts_g, valid_g, joints_g = (t.cpu().numpy() for t in (verts_g, valid_g, joints_g))
            params_g = {k: v.cpu().numpy() for k, v in params_g.items()}
            for pos, j in enumerate(idxs):
                fits[j] = (gp, verts_g[pos],
                           {k: v[pos] for k, v in params_g.items()},
                           valid_g[pos], joints_g[pos])
            seconds["fit"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        for j in range(B):
            gp, final_verts, params_j, valid_j, joints_j = fits[j]
            id_ = batch["id"][j]
            d = os.path.join(output_folder, id_)
            os.makedirs(d, exist_ok=True)

            save_obj(
                os.path.join(d, f"forwarded_smpl_mesh_on_pred_{id_}.obj"),
                TriMesh(final_verts, gp.body_model.faces),
            )

            gt_path = os.path.join(args.smpl_dir, id_, f"mesh_smpl_{id_}.obj")
            if os.path.exists(gt_path):
                gt_mesh = load_obj(gt_path)
                if len(gt_mesh.vertices) == len(final_verts):
                    v2v = float(
                        np.mean(np.linalg.norm(gt_mesh.vertices - final_verts, axis=1))
                    )
                    total_v2v += v2v
                    n_samples += 1
                    print(f"{id_} v2v: {v2v}")
                    full = int(valid_j.sum()) == valid_j.shape[0]
                    with open(score_path, "a") as f:
                        f.write(
                            f"{id_}: {v2v}"
                            + ("" if full else "  attention, the valid mask is not full")
                            + "\n"
                        )

            pose = params_j["pose"].reshape(23, 3)
            np.savez(
                os.path.join(d, f"output_smpl_info_{id_}.npz"),
                body_pose=pose[:21], hand_pose=pose[21:23],
                betas=params_j["betas"],
                global_orient=params_j["global_orient"],
                transl=params_j["transl"],
                joints=joints_j,
            )
        seconds["export"] += time.perf_counter() - t0

    if n_samples:
        print(f"average v2v: {total_v2v / n_samples}")
        with open(score_path, "a") as f:
            f.write("==========\n")
            f.write(f"average v2v: {total_v2v / n_samples}\n")
            f.write(f"total v2v: {total_v2v}\n")
            f.write(f"sample num: {n_samples}\n")
    return {"output_folder": output_folder,
            "average_v2v": total_v2v / n_samples if n_samples else None,
            "seconds": seconds}


if __name__ == "__main__":
    main()
