"""AMASS motion-sequence loader for animation experiments.

Rebuild of reference `src/data_utils/amass_ptc_loader.py:8-59`: iterates npz
motion files, exposing per-frame markers/poses/trans/betas.  A copy of
`etch_tpu/data/amass.py` (numpy only); `tests/test_torch_gt_tools.py` holds
it bit-equal to the original."""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np


class AmassSequenceDataset:
    """Map-style access to AMASS-format npz motion sequences."""

    def __init__(
        self,
        root: str,
        step: int = 1,
        max_frames: Optional[int] = None,
    ):
        self.files: List[str] = []
        for dirpath, _, filenames in os.walk(root):
            for f in sorted(filenames):
                if f.endswith(".npz"):
                    self.files.append(os.path.join(dirpath, f))
        self.step = step
        self.max_frames = max_frames

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        data = np.load(self.files[idx], allow_pickle=True)
        out = {}
        for key in ("poses", "trans", "betas", "markers", "gender", "mocap_framerate"):
            if key in data:
                out[key] = np.asarray(data[key])
        for key in ("poses", "trans", "markers"):
            if key in out:
                arr = out[key][:: self.step]
                if self.max_frames is not None:
                    arr = arr[: self.max_frames]
                out[key] = arr
        out["path"] = self.files[idx]
        return out

    def frames(self, idx: int) -> Iterator[Dict[str, np.ndarray]]:
        seq = self[idx]
        n = len(seq["poses"]) if "poses" in seq else 0
        for t in range(n):
            yield {
                "pose": seq["poses"][t],
                "trans": seq["trans"][t] if "trans" in seq else None,
                "betas": seq.get("betas"),
            }
