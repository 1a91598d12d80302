"""Weight bridge: the JAX package's flax variables -> this port's state_dict.

`flax_to_state_dict(params, batch_stats, cfg)` takes the `params` and
`batch_stats` trees of `etch_tpu.models.etch_net.EtchNet(cfg).init(...)` as
nested dicts of numpy arrays (the caller converts with
`jax.tree_util.tree_map(np.asarray, ...)`, so this module never sees jax)
and returns the `state_dict` of `etch_tpu_torch.models.etch_net.EtchNet(cfg)`.

Paths map one to one ('/' -> '.'), because the port's modules carry the
flax names.  Leaves map as follows:
  - Dense `kernel` (in, out)        -> Linear `weight`, transposed
  - BatchNorm `scale` / `bias`      -> `weight` / `bias`
  - batch_stats `mean` / `var`      -> `running_mean` / `running_var`
  - every other leaf (EPN `W` in its (K*C_in, C_out) layout, intra `W`
    (12*C, O), the explicit direction-head, vector-attention and confidence
    weights and stats) keeps its name and layout.
The `nn.scan`-stacked `enc{l}_blocks/block/...` leaves are unstacked along
axis 0 into `enc{l}_blocks.{i}....`.  Any flax leaf left unused, torch key
left unset or shape that disagrees raises.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from etch_tpu_torch.models.etch_net import EtchNet
from etch_tpu_torch.utils.config import EtchConfig

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}
_STACKED = re.compile(r"^(.*enc\d+_blocks)\.block\.(.*)$")


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, np.asarray(val)


def _torch_entries(path: str, arr: np.ndarray):
    """One flax leaf -> [(torch key, array)], unstacking scanned blocks."""
    head, _, leaf = path.rpartition(".")
    if leaf == "kernel":
        arr = np.swapaxes(arr, -1, -2)
    key = f"{head}.{_LEAF.get(leaf, leaf)}"
    m = _STACKED.match(key)
    if m is None:
        return [(key, arr)]
    return [(f"{m.group(1)}.{i}.{m.group(2)}", arr[i]) for i in range(arr.shape[0])]


def flax_to_state_dict(params, batch_stats, cfg: EtchConfig):
    with torch.device("meta"):
        expected = EtchNet(cfg).state_dict()
    out = {}
    for path, arr in list(_flatten(params)) + list(_flatten(batch_stats)):
        for key, val in _torch_entries(path, arr):
            if key not in expected:
                raise KeyError(f"flax leaf {path} -> {key}: no such parameter")
            if key in out:
                raise KeyError(f"flax leaf {path} -> {key}: set twice")
            if tuple(val.shape) != tuple(expected[key].shape):
                raise ValueError(f"{key}: flax shape {val.shape} vs torch "
                                 f"{tuple(expected[key].shape)}")
            out[key] = torch.tensor(val, dtype=torch.float32)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"torch keys left unset: {missing}")
    return out
