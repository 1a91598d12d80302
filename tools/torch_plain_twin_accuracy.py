#!/usr/bin/env python3
"""How accurate a bf16 serving step is on the card, with its kernels, with
its plain twin (every floating-point kernel replaced by its plain version on
the card's tensors) and widened (the kernels, with every `nn/bf16.py::mm`
product an f32 product of bf16-rounded operands in place of the card's bf16
tensor-core product), against the CPU's bf16 step, each against the same
weights served in f32 on the CPU.  Run it from the repository's root on a
machine with one CUDA card:

    python3 tools/torch_plain_twin_accuracy.py [--configs 6-12,combined]
        [--seeds 3,4,5,6] [--swaps] [--replay]

For each configuration (at N=1024, B=2, random weights) and each input seed
(`chip_smoke.capsule_clouds`) it prints the card's errors over the CPU's
(`chip_smoke.bf16_step_accuracy`: vector lengths and confidences, median
relative / max; the directions' median angle; part labels off the f32 ones)
for the kernels, the twin and the widened step, then the same over all seeds
pooled (the steps' outputs concatenated along the batch).  Where the twin
itself reads above AS_ACCURATE_STEP on a seed, the card's plain arithmetic
alone misses the CPU's bf16 step there, whatever the kernels do.

--swaps serves the first seed once more for each kernel replaced alone by its
plain version, and for each module's `mm` products alone widened.  --replay
feeds every module of the listed classes the input the CPU's bf16 step gave
it, on the card with the kernels, with the twin and widened, and on the CPU,
and prints each module's error over the CPU's against the f32 module on the
same input: a module that departs from the CPU, and whether its kernels,
its plain operations or its tensor-core products do, without the flips of
the modules before it."""

import argparse
import contextlib
import importlib
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))   # the repository's root
import chip_smoke  # noqa: E402

CONFIGS = {
    "reference": dict(use_bfloat16=True),
    "kernel_size-3": dict(epn=dict(kernel_size=3), use_bfloat16=True),
    "sampling_ratio-3.2": dict(epn=dict(sampling_ratio=3.2), use_bfloat16=True),
    "6-12": dict(epn_mlps=((6, 12), (64, 64)), use_bfloat16=True),
    "1024-planes": dict(unet_planes_magnitude=(64, 128, 256, 512, 1024), use_bfloat16=True),
    "combined": chip_smoke.REPAIRED_9,
    "last-block-768": dict(epn_mlps=((32, 32), (768, 768)), use_bfloat16=True),
}
# the floating-point kernels' wrappers, by module: the twin replaces each
# `<name>_cuda` by its `<name>_torch`
KERNELS = (("etch_tpu_torch.nn.interconv",
            ("interconv_t", "interconv_t_c1", "interconv_ones", "interconv_ones_proj")),
           ("etch_tpu_torch.nn.dircore", ("direction_core",)),
           ("etch_tpu_torch.nn.attention", ("attention",)),
           ("etch_tpu_torch.nn.vector_attention", ("vector_attention",)),
           ("etch_tpu_torch.nn.grouped_head", ("grouped_head",)))
# the modules whose products go through `nn/bf16.py::mm` on the card
MM_MODULES = ("etch_tpu_torch.nn.epn", "etch_tpu_torch.nn.point_transformer")
# the modules --replay feeds one at a time
LABELS = ("kernels", "twin", "widened")   # the card's three forms of the step
REPLAY = ("InterSO3Conv", "IntraSO3Conv", "SeparableSO3ConvBlock", "EPNBackbone",
          "PointTransformerLayer", "PointTransformerBlock", "TransitionDown", "TransitionUp",
          "Dense", "BatchNorm", "PointTransformerSeg", "DirectionHead")


@contextlib.contextmanager
def plain(names=None):
    """Within the block the kernels' wrappers named (all when None) run their
    plain versions instead, on CUDA tensors too; restored on exit."""
    saved = []
    for mod_name, kernels in KERNELS:
        mod = importlib.import_module(mod_name)
        for name in kernels:
            if names is None or name in names:
                saved.append((mod, f"{name}_cuda", getattr(mod, f"{name}_cuda")))
                setattr(mod, f"{name}_cuda", getattr(mod, f"{name}_torch"))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def widened(names=MM_MODULES):
    """Within the block the modules named take every `mm` product in its
    widened form (`nn/bf16.py::wide_mm`); restored on exit."""
    from etch_tpu_torch.nn.bf16 import wide_mm
    mods = [importlib.import_module(n) for n in names]
    saved = [mod.mm for mod in mods]
    for mod in mods:
        mod.mm = wide_mm
    try:
        yield
    finally:
        for mod, fn in zip(mods, saved):
            mod.mm = fn


def build(cfg, device):
    from etch_tpu_torch.pipeline import build_pipeline
    return build_pipeline(cfg, chip_smoke.MARKERSET, allow_synthetic_body=True, rng_seed=0,
                          device=device)


def serve(cfg, device, pts):
    pipe = build(cfg, device)
    seen = {}
    hook = pipe.model.direction_head.register_forward_hook(
        lambda _m, _i, o: seen.update(direction=o))
    with torch.no_grad():
        out = pipe.predict(pts)   # what the check reads: no fit
    hook.remove()
    keep = ("confidences", "vectors", "part_labels")
    return {**{k: out[k].cpu() for k in keep}, "direction": seen["direction"].cpu()}


def ratios(out, cpu, f32):
    rep, ok = chip_smoke.bf16_step_accuracy(out, cpu, f32)
    vl, cf, di = rep["vector_length"], rep["confidences"], rep["direction"]
    off = rep["part_labels_off_f32"]
    return (f"vector length {vl['card_median_rel'] / vl['cpu_median_rel']:.3f} / "
            f"{vl['card_max_abs'] / vl['cpu_max_abs']:.3f}, confidences "
            f"{cf['card_median_rel'] / cf['cpu_median_rel']:.3f} / "
            f"{cf['card_max_abs'] / cf['cpu_max_abs']:.3f}, directions "
            f"{di['card_median_angle'] / di['cpu_median_angle']:.3f}, labels off "
            f"{off['card']:.4f} (CPU {off['cpu']:.4f}), within {chip_smoke.AS_ACCURATE_STEP}: {ok}")


def pooled(runs):
    return {k: torch.cat([r[k] for r in runs]) for k in runs[0]}


def tensors(x):
    """The floating-point tensors of a module's output, flattened."""
    if torch.is_tensor(x):
        return [x] if x.is_floating_point() else []
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in tensors(v)]
    return []


def moved(x, device, dtype=None):
    if torch.is_tensor(x):
        y = x.to(device)
        return y.to(dtype) if dtype is not None and y.is_floating_point() else y
    if isinstance(x, tuple):
        return tuple(moved(v, device, dtype) for v in x)
    if isinstance(x, list):
        return [moved(v, device, dtype) for v in x]
    if isinstance(x, dict):
        return {k: moved(v, device, dtype) for k, v in x.items()}
    return x


def replay(cfg, pts):
    """Each module's error on the card (kernels, twin, widened) over the
    CPU's, on the input the CPU's bf16 step gave it."""
    cpu, gpu = build(cfg, "cpu"), build(cfg, "cuda")
    f32 = build(cfg.replace(use_bfloat16=False), "cpu")
    mods = {n: m for n, m in cpu.model.named_modules() if type(m).__name__ in REPLAY}
    calls, hooks = [], []
    for name, mod in mods.items():
        hooks.append(mod.register_forward_hook(
            lambda m, a, kw, o, name=name: calls.append(
                (name, moved(a, "cpu"), moved(kw, "cpu"),
                 [t.detach().float() for t in tensors(o)])),
            with_kwargs=True))
    with torch.no_grad():
        cpu.model(torch.as_tensor(pts))
    for h in hooks:
        h.remove()
    gmods, fmods = dict(gpu.model.named_modules()), dict(f32.model.named_modules())
    seen = {}
    with torch.no_grad():
        for name, args, kwargs, outs in calls:
            seen[name] = seen.get(name, 0) + 1
            if seen[name] > 2:   # the first two calls of a module shared by calls
                continue
            ref = [t.float() for t in tensors(fmods[name](*moved(args, "cpu", torch.float32),
                                                           **moved(kwargs, "cpu", torch.float32)))]
            res = {}
            for label, ctx in (("kernels", contextlib.nullcontext()), ("twin", plain()),
                               ("widened", widened())):
                with ctx:
                    got = tensors(gmods[name](*moved(args, "cuda"), **moved(kwargs, "cuda")))
                res[label] = [t.detach().float().cpu() for t in got]
            parts = []
            for i, (c, r) in enumerate(zip(outs, ref)):
                if c.shape != r.shape:
                    continue
                ec = (c - r).abs()
                mc, xc = chip_smoke.median_rel(ec, r), ec.max().item()
                row = []
                for label in LABELS:
                    eg = (res[label][i] - r).abs()
                    mg, xg = chip_smoke.median_rel(eg, r), eg.max().item()
                    row.append(f"{label} {mg / mc if mc else float('nan'):.3f} / "
                               f"{xg / xc if xc else float('nan'):.3f}")
                parts.append(f"[{i}] {tuple(c.shape)} CPU {mc:.3e} / {xc:.3e}: " + ", ".join(row))
            print(f"  replay {name} ({type(mods[name]).__name__}, call {seen[name]}): "
                  + "; ".join(parts), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--seeds", default="3")
    ap.add_argument("--swaps", action="store_true")
    ap.add_argument("--replay", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    seeds = [int(s) for s in args.seeds.split(",")]
    for name in args.configs.split(","):
        cfg = chip_smoke.deep_config(CONFIGS[name])
        runs = {"cpu": [], "f32": [], **{label: [] for label in LABELS}}
        for seed in seeds:
            t0 = time.perf_counter()
            pts = chip_smoke.capsule_clouds(cfg.batch_size, cfg.num_point, seed=seed)
            runs["cpu"].append(serve(cfg, "cpu", pts))
            runs["f32"].append(serve(cfg.replace(use_bfloat16=False), "cpu", pts))
            runs["kernels"].append(serve(cfg, "cuda", pts))
            with plain():
                runs["twin"].append(serve(cfg, "cuda", pts))
            with widened():
                runs["widened"].append(serve(cfg, "cuda", pts))
            for label in LABELS:
                print(f"{name:18s} seed {seed} {label:8s} over the CPU: "
                      f"{ratios(runs[label][-1], runs['cpu'][-1], runs['f32'][-1])}")
            print(f"{name:18s} seed {seed} kernels over the twin: "
                  f"{ratios(runs['kernels'][-1], runs['twin'][-1], runs['f32'][-1])} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if len(seeds) > 1:
            for k in range(2, len(seeds) + 1):
                pool = {lab: pooled(r[:k]) for lab, r in runs.items()}
                for label in LABELS:
                    print(f"{name:18s} seeds {seeds[:k]} pooled, {label:8s} over the CPU: "
                          f"{ratios(pool[label], pool['cpu'], pool['f32'])}", flush=True)
        if args.swaps:
            pts = chip_smoke.capsule_clouds(cfg.batch_size, cfg.num_point, seed=seeds[0])
            for _mod, kernels in KERNELS:
                for kernel in kernels:
                    with plain({kernel}):
                        out = serve(cfg, "cuda", pts)
                    print(f"{name:18s} seed {seeds[0]} plain {kernel} alone, over the CPU: "
                          f"{ratios(out, runs['cpu'][0], runs['f32'][0])}", flush=True)
            for mod_name in MM_MODULES:
                with widened((mod_name,)):
                    out = serve(cfg, "cuda", pts)
                print(f"{name:18s} seed {seeds[0]} {mod_name} widened alone, over the CPU: "
                      f"{ratios(out, runs['cpu'][0], runs['f32'][0])}", flush=True)
        if args.replay:
            replay(cfg, chip_smoke.capsule_clouds(cfg.batch_size, cfg.num_point, seed=seeds[0]))


if __name__ == "__main__":
    main()
