"""End-to-end inference pipeline: scan mesh -> fitted SMPL body.

Port of `etch_tpu/pipeline.py` (reference `src/inference_demo.py:12-131`):
bbox-center the scan, sample `num_point` surface points, network forward ->
tightness vectors and inner points -> marker extraction -> two-stage LM SMPL
fit -> SMPL forward, then un-center the fitted mesh and export an obj and an
smpl-info npz with the reference's schema.  In f32 or, with
`EtchConfig(use_bfloat16=True)`, the bf16 policy of the JAX package.  On a
CUDA device every kernel on the path runs its hand-written version: FPS,
kNN, ball query and the inter-conv contraction, the occupancy conv (with
its fused projection on the bf16 path), and on the bf16 path the direction
core (or the anchor attention on the chunked route), the vector attention
and the grouped confidence head.

`run_batch` is the serving step on a batch of point clouds, `run_scan` the
single-scan entry point (`cli/infer.py`).  With `utils/trace.py` on, each
`run_batch` is a request whose spans mark predict, markers, both LM stages
and the SMPL forward.  The weights come from a
checkpoint of the port's own format (`checkpoint_path`: a file or directory
written by `train/checkpoint.py`'s `save_params` or `save_train_state`, or
converted from an orbax one by `tools/orbax_to_torch.py`), from a state_dict
(`state_dict=`, e.g. `convert.flax_to_state_dict`), or at random.  The body
model is the SMPL pkl under `datafolder/body_models/` (`load_smpl`), or,
where the caller allows it, `synthetic_body_model`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from etch_tpu_torch.body.smpl import (SMPLModel, load_smpl, marker_submodel, smpl_forward,
                                      synthetic_body_model)
from etch_tpu_torch.data.mesh import TriMesh, load_obj, save_obj
from etch_tpu_torch.data.sampling import sample_surface
from etch_tpu_torch.fit.markers import extract_markers
from etch_tpu_torch.fit.smpl_fit import fit_smpl_params
from etch_tpu_torch.models.etch_net import EtchNet, init_params
from etch_tpu_torch.train.checkpoint import restore_params, tree_signature
from etch_tpu_torch.utils import trace
from etch_tpu_torch.utils.config import EtchConfig

GENDER_MODEL_PATHS = {
    # reference fit_SMPL.py:92-99
    "neutral": "datafolder/body_models/smpl/neutral/SMPL_NEUTRAL_10pc_rmchumpy.pkl",
    "female": "datafolder/body_models/smpl/female/SMPL_FEMALE_10pc.pkl",
    "male": "datafolder/body_models/smpl/male/SMPL_MALE_10pc.pkl",
}


def load_markerset(path: str) -> Dict[str, int]:
    with open(path, "r") as f:
        return json.load(f)


def center_scan(mesh: TriMesh) -> Tuple[TriMesh, np.ndarray]:
    """bbox-center (reference inference_demo.py:19-34)."""
    vmin, vmax = mesh.bounds()
    center = (vmin + vmax) / 2.0
    out = mesh.copy()
    out.vertices = mesh.vertices - center
    return out, center


class InferencePipeline:
    """Holds the network and the body model on one device; `run_batch` is
    the serving step, `run_scan` the single-scan entry point."""

    def __init__(self, cfg: EtchConfig, model: EtchNet, body_model: SMPLModel,
                 marker_vids: np.ndarray, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.body_model = body_model.to(self.device)
        self.marker_vids = np.asarray(marker_vids, np.int32)
        self.sub = marker_submodel(self.body_model, self.marker_vids)

    @torch.no_grad()
    def predict(self, points) -> Dict[str, torch.Tensor]:
        """points (B, N, 3) -> the JAX `predict` dict: vectors, inner_points,
        part_labels, part_logits, confidences, direction, magnitude (tensors
        on the pipeline's device)."""
        with trace.span("pipeline.predict"):
            pts = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
            results = self.model(pts)
            vectors = results["direction"] * results["magnitude"] / self.cfg.scale_magnitude
            return {
                "vectors": vectors,
                "inner_points": pts - vectors,
                "part_labels": torch.argmax(results["part_labels"], dim=-1),
                "part_logits": results["part_labels"],
                "confidences": results["confidences"],
                "direction": results["direction"],
                "magnitude": results["magnitude"],
            }

    @torch.no_grad()
    def fit(self, inner_points, part_labels, confidences):
        """Markers -> two-stage LM fit -> SMPL forward.  Returns (verts,
        params, markers, valid, joints), as the JAX `fit`."""
        as_t = lambda x: torch.as_tensor(x, device=self.device)
        with trace.span("fit.markers"):
            markers, valid = extract_markers(as_t(inner_points), as_t(part_labels),
                                             as_t(confidences),
                                             num_markers=len(self.marker_vids))
        params = fit_smpl_params(
            self.sub, markers, valid,
            steps_stage0=self.cfg.fit_steps_stage0,
            steps_stage1=self.cfg.fit_steps_stage1,
            lr_stage0=self.cfg.fit_lr_stage0, lr_stage1=self.cfg.fit_lr_stage1,
            num_betas=int(self.body_model.num_betas))
        with trace.span("fit.smpl"):
            verts, joints = smpl_forward(self.body_model, params["betas"], params["pose"],
                                         params["global_orient"], params["transl"])
        return verts, params, markers, valid, joints

    @torch.no_grad()
    def run_batch(self, points) -> Dict[str, object]:
        """(B, N, 3) scan batch -> the JAX `run_batch` dict: vectors,
        inner_points, part_labels, confidences, markers, markers_valid,
        fit_params, verts, joints (tensors on the pipeline's device)."""
        with trace.request("pipeline.run_batch"):
            pred = self.predict(points)
            verts, fitp, markers, valid, joints = self.fit(
                pred["inner_points"], pred["part_labels"], pred["confidences"])
        return {
            "vectors": pred["vectors"], "inner_points": pred["inner_points"],
            "part_labels": pred["part_labels"], "confidences": pred["confidences"],
            "markers": markers, "markers_valid": valid, "fit_params": fitp,
            "verts": verts, "joints": joints,
        }

    def run_scan(self, scan_path: str, num_point: Optional[int] = None,
                 seed: Optional[int] = None):
        """Full single-scan pipeline; returns the JAX `run_scan` dict (numpy
        arrays)."""
        num_point = num_point or self.cfg.num_point
        mesh = load_obj(scan_path)
        centered, center = center_scan(mesh)
        points, _ = sample_surface(centered, num_point, seed=seed)
        pred = self.predict(points[None].astype(np.float32))
        verts, params, markers, valid, joints = self.fit(
            pred["inner_points"], pred["part_labels"], pred["confidences"])
        first = lambda t: t[0].cpu().numpy()
        return {
            "vertices": first(verts) + center,   # un-center
            "faces": self.body_model.faces,
            "center": center,
            "points": points,
            "pred": {k: first(v) for k, v in pred.items()},
            "markers": first(markers),
            "valid_mask": first(valid),
            "smpl_params": {k: first(v) for k, v in params.items()},
            "joints": first(joints),
        }

    def export(self, result, scan_path: str, output_folder: str):
        """Write obj + npz with the reference's schema
        (inference_demo.py:113-127)."""
        os.makedirs(output_folder, exist_ok=True)
        scan_name = os.path.splitext(os.path.basename(scan_path))[0]
        obj_path = os.path.join(output_folder, f"{scan_name}_pred_smpl.obj")
        save_obj(obj_path, TriMesh(result["vertices"], result["faces"]))
        pose = result["smpl_params"]["pose"].reshape(23, 3)
        npz_path = os.path.join(output_folder, f"{scan_name}_output_smpl_info.npz")
        np.savez(
            npz_path,
            body_pose=pose[:21, :],
            hand_pose=pose[21:23, :],
            betas=result["smpl_params"]["betas"],
            global_orient=result["smpl_params"]["global_orient"],
            transl=result["smpl_params"]["transl"],
            joints=result["joints"],
        )
        return obj_path, npz_path


def load_body_model(gender: str = "neutral", root: str = ".",
                    allow_synthetic: bool = False) -> SMPLModel:
    path = os.path.join(root, GENDER_MODEL_PATHS[gender])
    if os.path.isfile(path):
        return load_smpl(path)
    if allow_synthetic:
        return synthetic_body_model(n_verts=6890)
    raise FileNotFoundError(
        f"SMPL body model not found at {path}; download the SMPL release pkls "
        f"into datafolder/body_models/ (same layout as the reference) or pass "
        f"allow_synthetic=True for smoke testing.")


def build_pipeline(cfg: EtchConfig, markerset: Dict[str, int],
                   checkpoint_path: Optional[str] = None, gender: str = "neutral",
                   datafolder_root: str = ".", allow_synthetic_body: bool = False,
                   rng_seed: int = 0,
                   state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   device="cuda") -> InferencePipeline:
    """Construct the pipeline on `device` (the card unless the caller asks
    for the CPU).  The weights: `checkpoint_path` (a file or directory of
    `train/checkpoint.py`, its tree signature checked against the model's),
    else `state_dict` (e.g. from `convert.flax_to_state_dict`), else drawn
    from a `torch.Generator` seeded with `rng_seed`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"build_pipeline(device={str(device)!r}): torch sees no CUDA "
                           f"device (pass device=\"cpu\" to run on the CPU)")
    model = EtchNet(cfg)
    if checkpoint_path is not None:
        with torch.device("meta"):
            want = tree_signature(EtchNet(cfg).state_dict())
        state_dict = restore_params(checkpoint_path, expected_signature=want)
    if state_dict is None:
        init_params(model, torch.Generator().manual_seed(rng_seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    body = load_body_model(gender, root=datafolder_root,
                           allow_synthetic=allow_synthetic_body)
    vids = np.asarray(list(markerset.values()), np.int32)
    if body.num_verts <= int(vids.max()):
        # synthetic smoke-test body: remap marker ids into range
        vids = (vids % body.num_verts).astype(np.int32)
    return InferencePipeline(cfg, model, body, vids, device)
