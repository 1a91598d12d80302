#!/usr/bin/env python3
"""Convert a checkpoint of the JAX package (orbax) into the PyTorch port's
weights file.

    python tools/orbax_to_torch.py <orbax directory> <output directory> \\
        [--config_json FILE | the model flags of etch_tpu_torch.cli.train]

Reads the orbax directory through `etch_tpu.train.checkpoint.restore_params`
(a `save_params` export or a training checkpoint directory, its newest
step), maps the flax variables with `etch_tpu_torch.convert.flax_to_state_dict`
and writes `<output directory>/weights.pt` with
`etch_tpu_torch.train.checkpoint.save_params`, which
`etch_tpu_torch.pipeline.build_pipeline(checkpoint_path=...)` and
`python -m etch_tpu_torch.cli.infer --model_path` read.  The configuration
the weights were built with comes from `--config_json` (an `EtchConfig`
JSON, as `EtchConfig.to_json` writes it) or from the model flags.  This
tool imports the JAX package; the port never does.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _to_numpy(tree):
    """Nested dicts (or FrozenDicts) of arrays -> nested dicts of numpy."""
    import numpy as np
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def main(argv=None) -> str:
    from etch_tpu.train.checkpoint import restore_params
    from etch_tpu_torch.cli.common import add_model_args, config_from_args
    from etch_tpu_torch.convert import flax_to_state_dict
    from etch_tpu_torch.train.checkpoint import save_params
    from etch_tpu_torch.utils.config import EtchConfig

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("orbax_dir")
    p.add_argument("output_dir")
    p.add_argument("--config_json", type=str, default=None,
                   help="EtchConfig JSON the weights were built with")
    add_model_args(p)
    args = p.parse_args(argv)
    if args.config_json:
        with open(args.config_json) as f:
            cfg = EtchConfig.from_json(f.read())
    else:
        cfg = config_from_args(args)
    params, batch_stats = restore_params(args.orbax_dir)
    sd = flax_to_state_dict(_to_numpy(params), _to_numpy(batch_stats), cfg)
    path = save_params(args.output_dir, sd, cfg.to_json())
    print(f"wrote {path} ({len(sd)} tensors)")
    return path


if __name__ == "__main__":
    main()
