"""Correspondence preparation tooling.

Rebuild of reference `scripts/correspondence_scripts/`:
  - merge-segmentation (merge_segmentation.py:12-96): collapse the public
    SMPL per-bone vertex segmentation json into 14 body parts with the same
    merge rules and priority-based conflict resolution, verifying a complete
    disjoint partition of the 6890 vertices.
  - seginfo (get_seginfo.py): build the {part_2_label, vertex_2_part,
    label_2_color} lookup pkl used by visualization / per-part losses.
  - export-standard-mesh (export_standardsmplmesh.py:6-58): export the
    canonical (zero pose/shape) SMPL mesh, optionally normalized to a target
    height / center.

A copy of `etch_tpu/cli/correspondence.py`: the first two are numpy and
bit-equal to the original; the mesh export runs the port's `load_smpl` /
`smpl_forward` on `--device` (default `cuda`, `cpu` on request), as
`tests/test_torch_gt_tools.py` checks.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

# merge rules (merge_segmentation.py:13-28); conflict resolution order below
MERGE_RULES = {
    "head": ["head", "neck"],
    "left_foot": ["leftToeBase", "leftFoot"],
    "left_leg": ["leftLeg"],
    "left_upper_leg": ["leftUpLeg"],
    "left_hand": ["leftHand", "leftHandIndex1"],
    "left_forearm": ["leftForeArm"],
    "left_arm": ["leftArm"],
    "upper_body": [
        "spine1", "spine2", "spine", "leftShoulder", "rightShoulder", "hips",
    ],
    "right_foot": ["rightToeBase", "rightFoot"],
    "right_leg": ["rightLeg"],
    "right_upper_leg": ["rightUpLeg"],
    "right_hand": ["rightHand", "rightHandIndex1"],
    "right_forearm": ["rightForeArm"],
    "right_arm": ["rightArm"],
}

# (winner, loser): overlapping vertices go to `winner`, removed from `loser`
CONFLICT_PRIORITY = [
    ("upper_body", "head"),
    ("left_arm", "upper_body"),
    ("left_arm", "left_forearm"),
    ("left_forearm", "left_hand"),
    ("right_arm", "upper_body"),
    ("right_arm", "right_forearm"),
    ("right_forearm", "right_hand"),
    ("left_foot", "left_leg"),
    ("left_upper_leg", "left_leg"),
    ("upper_body", "left_upper_leg"),
    ("right_foot", "right_leg"),
    ("right_upper_leg", "right_leg"),
    ("upper_body", "right_upper_leg"),
]


def merge_segments(seg_json: dict, num_vertices: int) -> dict:
    merged = {
        part: set(sum((seg_json[s] for s in sources), []))
        for part, sources in MERGE_RULES.items()
    }
    for winner, loser in CONFLICT_PRIORITY:
        overlap = merged[winner] & merged[loser]
        merged[winner] |= overlap
        merged[loser] -= merged[winner]
    all_v = [v for part in merged.values() for v in part]
    assert len(set(all_v)) == len(all_v) == num_vertices, (
        "segmentation must be a disjoint cover of all vertices"
    )
    return {k: sorted(v) for k, v in merged.items()}


def build_seginfo(part_2_vertex: dict, seed: int = 0) -> dict:
    part_2_vertex = dict(part_2_vertex)
    part_2_vertex.setdefault("elsepart", [])
    part_2_label = {p: i for i, p in enumerate(part_2_vertex.keys())}
    vertex_2_part = {}
    for part, verts in part_2_vertex.items():
        for v in verts:
            assert v not in vertex_2_part
            vertex_2_part[v] = part
    rng = np.random.RandomState(seed)
    label_2_color = {
        lbl: rng.randint(0, 256, 3).tolist() for lbl in part_2_label.values()
    }
    return {
        "part_2_vertex": part_2_vertex,
        "part_2_label": part_2_label,
        "vertex_2_part": vertex_2_part,
        "label_2_color": label_2_color,
    }


def export_standard_mesh(
    body_model_path: str,
    save_dir: str,
    tgt_height: float = 1.7,
    tgt_center: float = 0.0,
    normalize: bool = True,
    device="cuda",
):
    import torch

    from etch_tpu_torch.body.smpl import load_smpl, smpl_forward
    from etch_tpu_torch.data.mesh import TriMesh, save_obj

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r}: torch sees no CUDA device "
                           f"(pass --device cpu to run on the CPU)")
    model = load_smpl(body_model_path, device=device)
    zeros = lambda n: torch.zeros((1, n), device=device)
    with torch.no_grad():
        verts, _ = smpl_forward(model, zeros(model.num_betas), zeros(69), zeros(3), zeros(3))
    v = verts[0].cpu().numpy().astype(np.float64)
    os.makedirs(save_dir, exist_ok=True)
    save_obj(os.path.join(save_dir, "smpl_mesh_original.obj"), TriMesh(v, model.faces))
    if normalize:
        span = v.max(0) - v.min(0)
        scale = tgt_height / span.max()
        center = tgt_center - (v.max(0) + v.min(0)) / 2
        v = (v + center) * scale
    save_obj(os.path.join(save_dir, "smpl_mesh_canonical.obj"), TriMesh(v, model.faces))


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("merge-segmentation")
    m.add_argument("--input_json", required=True)
    m.add_argument("--output_pkl", required=True)
    m.add_argument("--num_vertices", type=int, default=6890)

    s = sub.add_parser("seginfo")
    s.add_argument("--parts_pkl", required=True)
    s.add_argument("--output_pkl", required=True)

    e = sub.add_parser("export-standard-mesh")
    e.add_argument("--body_model_path", required=True)
    e.add_argument("--save_dir", required=True)
    e.add_argument("--tgt_height", type=float, default=1.7)
    e.add_argument("--tgt_center", type=float, default=0.0)
    e.add_argument("--no_normalize", action="store_true")
    e.add_argument("--device", type=str, default="cuda",
                   help="torch device of the SMPL forward (cuda or cpu)")

    args = p.parse_args(argv)
    if args.cmd == "merge-segmentation":
        with open(args.input_json) as f:
            seg = json.load(f)
        merged = merge_segments(seg, args.num_vertices)
        with open(args.output_pkl, "wb") as f:
            pickle.dump(merged, f)
        print({k: len(v) for k, v in merged.items()})
    elif args.cmd == "seginfo":
        with open(args.parts_pkl, "rb") as f:
            parts = pickle.load(f, encoding="latin-1")
        info = build_seginfo(parts)
        with open(args.output_pkl, "wb") as f:
            pickle.dump(info, f)
        print(f"labels: {info['part_2_label']}")
    elif args.cmd == "export-standard-mesh":
        export_standard_mesh(
            args.body_model_path, args.save_dir,
            args.tgt_height, args.tgt_center, not args.no_normalize,
            device=args.device,
        )


if __name__ == "__main__":
    main()
