"""The harness's plumbing: the manifest, a cell's files, the program's
configuration, caches, and the result line.

Everything a cell needs is found by name: `BENCHMARK.json` at the checkout's
root names the cell's configuration (`perfbench/configs/<config>.json`)
and traffic mix (`perfbench/traffic/<traffic>.json`, whose "kind" picks the
loop: `serve.py` or `train.py`); each per-layer metric has its reader,
`perfbench/metrics/<name>.py`; each of the program's kernels its bound,
`perfbench/kernels/<kernel>.py`; each cell its limits,
`perfbench/limits/<workload>.json`.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "etch_tpu")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> SimpleNamespace:
    """The cell's manifest entry, configuration, traffic and metrics."""
    man = load_manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    return SimpleNamespace(
        name=workload, chips=entry["chips"], config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        end_to_end=[m for m in man["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in man["per_layer"] if applies(m, workload)])


def etch_config(cfg: dict):
    """The program's EtchConfig for a configuration file's fields."""
    import dataclasses

    from etch_tpu_torch.utils.config import EPNConfig, EtchConfig

    fields = {f.name for f in dataclasses.fields(EtchConfig)}
    kw = {k: (tuple(tuple(x) if isinstance(x, list) else x for x in v) if isinstance(v, list)
              else v) for k, v in cfg.items() if k in fields and k != "epn"}
    return EtchConfig(epn=EPNConfig(**cfg.get("epn", {})), **kw)


def cache_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout: the
    program builds its library under build/etch_tpu_torch/<hash>/ itself."""
    base = root / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the last)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_plugin_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers(names) -> dict:
    return {n: _load(HERE / "metrics" / f"{n}.py") for n in names}


def kernel_bounds() -> dict:
    return {p.stem: _load(p) for p in sorted((HERE / "kernels").glob("*.py"))
            if p.stem != "__init__"}


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """The device's peak allocation since `reset_peak` (0 off the card)."""
    import torch
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free(device) -> None:
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def log_setup(t0: float, start: float, built: float, warm: float) -> None:
    print(f"setup: {start - t0:.2f} s imports, {built - start:.2f} s inputs, weights and the "
          f"program, {warm - built:.2f} s warm calls", file=sys.stderr)


def log_calls(what: str, ms) -> None:
    ms = sorted(ms)
    if ms:
        print(f"window: {len(ms)} x {what}, ms min {ms[0]:.1f} median {ms[len(ms) // 2]:.1f} "
              f"max {ms[-1]:.1f}", file=sys.stderr)


def number(x: float) -> float:
    """A JSON-safe float (inf and nan as strings are not JSON numbers)."""
    return x if math.isfinite(x) else (1e300 if x > 0 else -1e300)


def emit(result: dict, checks: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, and the result as the last line of standard output, with the
    checks as its last key."""
    for k, c in checks.items():
        lim = "not held" if c["limit"] is None else f"limit {c['limit']!r}"
        print(f"check {k} {c['value']!r} {lim}", file=sys.stderr)
    result = dict(result)
    result["checks"] = {k: {"value": number(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
