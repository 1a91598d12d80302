"""Training metrics: JSONL scalars.

A copy of `etch_tpu/utils/logging.py` without its matplotlib curves (the
port imports no matplotlib): the JSONL log carries the same per-epoch
scalars, for external tooling to tail or plot.  It stands in for the
reference's loss curves (src/train.py:28-58) and TensorBoard scalars
(src/train_mixed.py:202-214).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.history: Dict[str, list] = defaultdict(list)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        for k, v in metrics.items():
            self.history[k].append(float(v))
