#!/usr/bin/env python3
"""A serving cell's compared numbers with the plain reference itself, at a
precision below the configuration's, in the program's place: what the
cell's limits in `perfbench/limits/<cell>.json` must refuse.  From the root
of a checkout, on one CUDA card:

    python3 tools/perfbench_control.py --workload etch-f32.serve-b32 --seeds 1,2,3 \
        [--kinds bf16,tf32] [--out control.jsonl]

For each seed and kind: the cell's weights and first batch as
`perfbench/calibrate.py` makes them, the reference network in that
`Numerics` kind (bf16 operands with f32 sums; TF32 library products) with
the reference's LM fit in the kind's scope (f32 for bf16, TF32 for tf32),
held to the f32 reference as `perfbench/serve.py::reference_check` holds a
served batch, and judged by the cell's limits as a run is (`correct`, which
must read false, and each number with its limit).
`perfbench/calibrate.py --control` gives the numbers with the fp8 network
and a TF32 fit.  One JSON line a seed and kind.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_numbers(cell, seed: int, kinds, device):
    """{kind: the compared numbers} for one seed's first batch."""
    import torch

    from perfbench import core, inputs, serve
    from perfbench.reference import fit as ref_fit
    from perfbench.reference import net as ref_net

    pipe, weights, pool, body, vids, _ = serve.build(cell, seed, device)
    del pipe
    core.free(device)
    P = {k: v.to(device) for k, v in weights.items()}
    bt = inputs.body_tensors(body, device)
    pts = torch.as_tensor(pool[0], device=device)
    out = {}
    for kind in kinds:
        num = ref_net.Numerics(kind)
        low = ref_net.predict(P, cell.config, pts, num)
        with num.scope():
            verts = ref_fit.fit(bt, vids, cell.config, low["inner_points"], low["part_labels"],
                                low["confidences"])[0]
        out[kind] = serve.reference_check(cell, weights, body, vids, pool[0],
                                          {**low, "verts": verts}, device)
        core.free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="bf16,tf32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench import compare, core

    core.cache_env()
    import torch

    cell = core.load_cell(args.workload)
    if cell.traffic["kind"] != "serve":
        raise SystemExit(f"{args.workload}: a serving cell is needed")
    device = torch.device("cuda")
    kinds = [k for k in args.kinds.split(",") if k]
    limits = compare.load_limits(cell.name)
    for seed in (int(s) for s in args.seeds.split(",") if s):
        t = time.perf_counter()
        for kind, numbers in control_numbers(cell, seed, kinds, device).items():
            correct, checks = compare.judge(numbers, limits)
            line = json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                               "correct": correct, "checks": checks,
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
