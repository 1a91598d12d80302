"""Checkpoints in the port's own format: one `torch.save` file each.

The JAX package checkpoints with orbax (`etch_tpu/train/checkpoint.py`);
the card's machine has no orbax, so the port writes:
  - `save_train_state`: `<directory>/<step>.pt` holding the model
    `state_dict` (parameters and BatchNorm buffers), the optimizer
    `state_dict`, `step`, `config_json` and `tree_signature`; the newest
    five are kept (`max_to_keep=5`, as the JAX package's manager);
  - `save_params`: weights only, `<directory>/weights.pt`, with the
    signature and the config (parity with the reference's .pth files).
`tree_signature` hashes the sorted (key, shape, dtype) rows of a
`state_dict`, as the JAX package hashes its flax tree (`:21-36`); a restore
whose signature differs from the model's raises instead of loading a
migrated tree silently.  `tools/orbax_to_torch.py` converts an orbax
directory of the JAX package into a `save_params` file.
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, Optional, Tuple

import torch

from etch_tpu_torch.train.state import TrainState

MAX_TO_KEEP = 5
_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def tree_signature(state_dict: Dict[str, torch.Tensor]) -> str:
    """Stable hash of the tree's keys, shapes and dtypes."""
    rows = [f"{k}:{tuple(v.shape)}:{v.dtype}" for k, v in state_dict.items()]
    return hashlib.sha256("\n".join(sorted(rows)).encode()).hexdigest()[:16]


def _steps(directory: str):
    names = os.listdir(directory) if os.path.isdir(directory) else []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, names) if m)


def _check(got: Optional[str], want: Optional[str], config_json: str, path: str) -> None:
    if want is not None and got != want:
        raise ValueError(
            f"{path}: checkpoint tree signature mismatch: checkpoint has {got}, the "
            f"current model builds {want}. The model architecture changed since this "
            f"checkpoint was written; load it with the config it was trained under "
            f"(saved alongside: config_json = {config_json[:200]})")


def save_train_state(directory: str, step: int, state: TrainState,
                     config_json: str = "") -> str:
    os.makedirs(directory, exist_ok=True)
    sd = state.model.state_dict()
    path = os.path.join(directory, f"{int(step)}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": sd, "optimizer": state.optimizer.state_dict(),
                "step": int(step), "config_json": config_json,
                "tree_signature": tree_signature(sd)}, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(os.path.join(directory, f"{old}.pt"))
    return path


def restore_train_state(directory: str, template: TrainState,
                        step: Optional[int] = None) -> Tuple[TrainState, int]:
    """Load step `step` (the newest by default) into `template`'s model and
    optimizer; `template.step` becomes the checkpoint's step."""
    steps = _steps(directory)
    step = step if step is not None else (steps[-1] if steps else None)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"{int(step)}.pt")
    device = next(template.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    _check(ckpt.get("tree_signature"), tree_signature(template.model.state_dict()),
           ckpt.get("config_json", ""), path)
    template.model.load_state_dict(ckpt["model"], strict=True)
    template.optimizer.load_state_dict(ckpt["optimizer"])
    template.step = torch.tensor(ckpt["step"], dtype=torch.int64, device=device)
    return template, int(ckpt["step"])


def save_params(directory: str, state_dict: Dict[str, torch.Tensor],
                config_json: str = "") -> str:
    """Weights-only export: `<directory>/weights.pt`."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "weights.pt")
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    torch.save({"model": sd, "config_json": config_json,
                "tree_signature": tree_signature(sd)}, path)
    return path


def restore_params(path: str, expected_signature: Optional[str] = None
                   ) -> Dict[str, torch.Tensor]:
    """The model `state_dict` of a `save_params` file or directory, or of
    the newest `save_train_state` file of a checkpoint directory (so
    inference accepts a training checkpoint directory directly, as the
    reference loads one .pth for train and eval), or of a file of either
    kind.  Raises on a signature other than `expected_signature`."""
    if os.path.isdir(path):
        steps = _steps(path)
        if os.path.isfile(os.path.join(path, "weights.pt")):
            path = os.path.join(path, "weights.pt")
        elif steps:
            path = os.path.join(path, f"{steps[-1]}.pt")
        else:
            raise FileNotFoundError(f"no weights.pt or <step>.pt under {path}")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    _check(ckpt.get("tree_signature"), expected_signature, ckpt.get("config_json", ""), path)
    return ckpt["model"]
