"""Synthetic training batches with analytic ground truth (numpy only).

A copy of `tools/overfit_harness.py::make_batch`: scan points on a bumpy
capsule, the "body" the smooth capsule underneath, so the tightness vector
is the radial offset (direction inward, magnitude the bump height), the
part label bins the axial coordinate into 86 parts, and the confidence
decays with the magnitude (as conf = exp(-10 d), GT_dataloader.py:57-60).
The same `RandomState` draws in the same order give the tool's arrays.
"""

from __future__ import annotations

import numpy as np


def make_batch(rng: np.random.RandomState, batch: int = 8, n_point: int = 512) -> dict:
    z = rng.uniform(-0.9, 0.9, (batch, n_point))
    th = rng.uniform(0, 2 * np.pi, (batch, n_point))
    bump = 0.02 + 0.015 * np.sin(4 * z) * np.cos(2 * th)   # cloth offset
    r_body = 0.15
    r_scan = r_body + bump
    cos_t, sin_t = np.cos(th), np.sin(th)
    pts = np.stack([r_scan * cos_t, r_scan * sin_t, z], axis=-1)
    # tightness vector: scan point -> body surface (radial, inward)
    vectors = np.stack([bump * cos_t, bump * sin_t, np.zeros_like(z)], axis=-1)
    labels = np.clip(((z + 0.9) / 1.8 * 86).astype(np.int32), 0, 85)
    conf = np.exp(-10.0 * bump)[..., None]
    return {
        "hitpts": pts.astype(np.float32),
        "vectors": vectors.astype(np.float32),
        "confidences": conf.astype(np.float32),
        "labels": labels,
    }
