"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It loads, warms up, measures for `--seconds`,
checks the outputs of the timed path against the plain reference, and
prints one JSON line last: `correct`, `attempted`, `failed`, `metrics`
(the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` a `breakdown`, and `checks`, each compared number
beside its limit.  It measures the PyTorch port on the card only: without
CUDA, or with fewer cards than the cell asks for, it exits with 1 and no
result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import core  # noqa: E402

LOOPS = {"serve": "perfbench.serve", "train": "perfbench.train"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer_record(cell, rec: dict):
    """The reduction the per-layer readers read."""
    from types import SimpleNamespace

    from perfbench import flops, peaks

    cfg = cell.config
    fwd = flops.forward_flops(cfg)
    rec["item_flops"] = fwd + flops.fit_flops(cfg) if rec["kind"] == "serve" else 3.0 * fwd
    rec["peak_flops"] = peaks.STEP_PEAK[cfg["precision"]]
    rec["kernels"] = core.kernel_bounds()
    return SimpleNamespace(**rec)


def run(args, device="cuda", cell=None, limits=None) -> int:
    """One run of one cell; returns the exit code.  `cell` and `limits`
    replace the manifest's (the tests drive the harness on the CPU)."""
    import importlib

    import torch

    from perfbench import compare

    cell = cell or core.load_cell(args.workload)
    limits = compare.load_limits(cell.name) if limits is None else limits
    loop = importlib.import_module(LOOPS[cell.traffic["kind"]])
    res = loop.run(cell, args.seed, args.seconds, bool(args.trace), torch.device(device), T0)
    found = core.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark measures the PyTorch "
              f"port alone", file=sys.stderr)
        return 3
    correct, checks = compare.judge(res["numbers"], limits)
    if device == "cuda":
        kind, count = torch.cuda.get_device_name(0), cell.chips
    else:
        kind, count = "cpu", 1
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind, "count": count,
           "memory_peak_bytes": int(res["peak"])}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    if args.trace:
        rec = per_layer_record(cell, res["record"])
        readers = core.metric_readers([m["name"] for m in cell.per_layer])
        metrics = {}
        for m in cell.per_layer:
            v = readers[m["name"]].read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        prof = rec.profile
        dev.update(busy_s=prof.busy_s, window_s=prof.window_s)
        out.update(metrics=metrics, device=dev,
                   breakdown={"device_ops": [[n, s] for n, s in prof.device_ops()],
                              "idle_gaps": [[n, s] for n, s in prof.idle_gaps()]})
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        out.update(metrics={k: {"value": v, "unit": units[k]}
                            for k, v in res["metrics"].items() if k in units},
                   device=dev)
    core.emit(out, checks)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    core.cache_env()
    try:
        import etch_tpu_torch  # noqa: F401  the system under test
        import torch
    except ImportError as e:
        print(f"the PyTorch port is not importable here: {e}", file=sys.stderr)
        return 1
    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    return run(args, "cuda", cell)


if __name__ == "__main__":
    sys.exit(main())
