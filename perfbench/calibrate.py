"""Readings that the limits of `perfbench/limits/<workload>.json` are set
from, at the cell's own sizes, many seeds in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control 1,2,3] [--out chiprun_out/calibrate.jsonl]

For each seed: the program's timed entry on the cell's first batch (serving:
one `run_batch`; training: the three checked steps) against the plain
reference, as a run checks it.  For the seeds in `--control`: the control
(the reference itself one precision below the configuration, in the
program's place) and, for training, the planted half-batch fault.  Serving
seeds also report `chain_verts_mm`: the served vertices against the
reference's whole chain from the same points (how far the ill-conditioned
fit moves with the network's rounding); it is not a compared number.
One JSON line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import compare, core  # noqa: E402


def serve_seed(cell, seed, control, device):
    from perfbench import serve

    pipe, weights, pool, body, vids, _ = serve.build(cell, seed, device)
    out = serve.to_host(pipe.run_batch(pool[0]))
    del pipe
    core.free(device)
    row = {"program": serve.reference_check(cell, weights, body, vids, pool[0], out, device,
                                            chain=True)}
    if control:
        row["control"] = serve.reference_check(cell, weights, body, vids, pool[0], out, device,
                                               control="low")
    return row


def train_seed(cell, seed, control, device):
    from perfbench import train

    model, state, opt, step, weights, pool = train.build(cell, seed, device)
    names = [k for k, _ in model.named_parameters()]
    prog = train.checked_steps(model, state, opt, step, weights, pool, device)
    del model, state, opt, step
    core.free(device)
    ref = train.reference_steps(cell, weights, names, pool, device)
    row = {"program": compare.train_numbers(prog, ref)}
    if control:
        row.update(train.control_numbers(cell, weights, names, pool, device, ref))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    core.cache_env()
    import torch

    cell = core.load_cell(args.workload)
    device = torch.device("cuda")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    fn = serve_seed if cell.traffic["kind"] == "serve" else train_seed
    for seed in sorted(set(seeds) | control):
        t = time.perf_counter()
        row = {"workload": cell.name, "seed": seed, **fn(cell, seed, seed in control, device),
               "seconds": time.perf_counter() - t}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        core.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
