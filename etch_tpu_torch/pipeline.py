"""Serving pipeline: a batch of scans -> fitted SMPL bodies.

Port of `etch_tpu/pipeline.py` (`InferencePipeline.run_batch`,
`build_pipeline`): network forward -> tightness vectors and inner points ->
marker extraction -> two-stage LM SMPL fit -> SMPL forward, in f32 or, with
`EtchConfig(use_bfloat16=True)`, the bf16 policy of the JAX package.  On a
CUDA device every kernel on that path runs its hand-written version: FPS,
kNN, ball query and the inter-conv contraction on both paths; the
occupancy conv (with its fused projection on the bf16 path), and on the
bf16 path the direction core, the vector attention and the grouped
confidence head.

Not ported yet: `predict` / `fit` / `run_scan` / `export`, checkpoint
restore and loading an SMPL .pkl (the repository carries neither weights nor
a body model; the slice runs with random weights and
`synthetic_body_model`, as `bench.py` does).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from etch_tpu_torch.body.smpl import SMPLModel, marker_submodel, smpl_forward, synthetic_body_model
from etch_tpu_torch.fit.markers import extract_markers
from etch_tpu_torch.fit.smpl_fit import fit_smpl_params
from etch_tpu_torch.models.etch_net import EtchNet, init_params
from etch_tpu_torch.utils.config import EtchConfig


class InferencePipeline:
    """Holds the network and the body model on one device; `run_batch` is
    the serving step."""

    def __init__(self, cfg: EtchConfig, model: EtchNet, body_model: SMPLModel,
                 marker_vids: np.ndarray, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.body_model = body_model.to(self.device)
        self.marker_vids = np.asarray(marker_vids, np.int32)
        self.sub = marker_submodel(self.body_model, self.marker_vids)

    @torch.no_grad()
    def run_batch(self, points) -> Dict[str, object]:
        """(B, N, 3) scan batch -> the JAX `run_batch` dict: vectors,
        inner_points, part_labels, confidences, markers, markers_valid,
        fit_params, verts, joints (tensors on the pipeline's device)."""
        pts = torch.as_tensor(np.asarray(points, np.float32), device=self.device)
        results = self.model(pts)
        vectors = results["direction"] * results["magnitude"] / self.cfg.scale_magnitude
        labels = torch.argmax(results["part_labels"], dim=-1)
        inner = pts - vectors
        markers, valid = extract_markers(inner, labels, results["confidences"],
                                         num_markers=len(self.marker_vids))
        fitp = fit_smpl_params(
            self.sub, markers, valid,
            steps_stage0=self.cfg.fit_steps_stage0,
            steps_stage1=self.cfg.fit_steps_stage1,
            lr_stage0=self.cfg.fit_lr_stage0, lr_stage1=self.cfg.fit_lr_stage1,
            num_betas=int(self.body_model.num_betas))
        verts, joints = smpl_forward(self.body_model, fitp["betas"], fitp["pose"],
                                     fitp["global_orient"], fitp["transl"])
        return {
            "vectors": vectors, "inner_points": inner, "part_labels": labels,
            "confidences": results["confidences"], "markers": markers,
            "markers_valid": valid, "fit_params": fitp, "verts": verts,
            "joints": joints,
        }


def load_body_model(allow_synthetic: bool = False) -> SMPLModel:
    if allow_synthetic:
        return synthetic_body_model(n_verts=6890)
    raise NotImplementedError(
        "loading an SMPL .pkl is not ported yet; pass allow_synthetic_body=True")


def build_pipeline(cfg: EtchConfig, markerset: Dict[str, int],
                   state_dict: Optional[Dict[str, torch.Tensor]] = None,
                   allow_synthetic_body: bool = False, rng_seed: int = 0,
                   device="cpu") -> InferencePipeline:
    """Construct the pipeline on `device`.  `state_dict` (e.g. from
    `convert.flax_to_state_dict`) supplies the weights; without it they are
    drawn from a `torch.Generator` seeded with `rng_seed`."""
    model = EtchNet(cfg)
    if state_dict is None:
        init_params(model, torch.Generator().manual_seed(rng_seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    body = load_body_model(allow_synthetic_body)
    vids = np.asarray(list(markerset.values()), np.int32)
    if body.num_verts <= int(vids.max()):
        # synthetic smoke-test body: remap marker ids into range
        vids = (vids % body.num_verts).astype(np.int32)
    return InferencePipeline(cfg, model, body, vids, device)
