"""Training metrics: JSONL scalars + per-loss matplotlib curves.

A copy of `etch_tpu/utils/logging.py`; matplotlib stays optional (`plot`
draws nothing where it is not installed).

Covers the reference's observability surface: matplotlib loss curves
(src/train.py:28-58) and TensorBoard scalars (src/train_mixed.py:202-214)
via a dependency-light JSONL log that external tooling can tail.
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

    def plot(self) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        for name, values in self.history.items():
            plt.figure()
            plt.plot(values, label=f"{name}")
            plt.xlabel("Epoch")
            plt.ylabel(name)
            plt.legend()
            plt.savefig(os.path.join(self.log_dir, f"{name}.png"))
            plt.close()
