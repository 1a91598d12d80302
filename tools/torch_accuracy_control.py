#!/usr/bin/env python3
"""Planted faults against chip_smoke.py's as-accurate rules (`AS_ACCURATE`,
`AS_ACCURATE_STEP`).

Where bf16 rounding flips break the 1e-3 median criterion (a full-width bf16
serving step, card against CPU; the direction core at E = 256), chip_smoke.py
holds a result to be as accurate as its plain twin against the unrounded f32
function, within AS_ACCURATE times the twin's error.  This script shows what
that rule catches.  It copies the checkout's `etch_tpu_torch` into
`build/accuracy_control/<variant>/` once unchanged ("sound") and once for
each fault in MUTANTS, with one line of one CUDA source replaced, and in
each copy, on the card:

  - serves EtchConfig(epn_layer_num=4, use_bfloat16=True) at N=1024, B=2
    (the 128- and 256-channel contraction slices and the E = 256 wide
    direction core) and judges it by `chip_smoke.bf16_step_accuracy`
    against the CPU's bf16 and f32 steps, served once beforehand:
    confidences, vector lengths and the direction head's output (median
    angle from the f32 step's, `chip_smoke.direction_accuracy`);
  - runs the wide core at E = 256 on 2048 points against its plain twin and
    the unrounded function (`chip_smoke.as_accurate`, as phase 3 does);
  - runs the bf16 contraction at C = 128 against its plain version
    (phase 3's bf16 gate: 1e-2 max, 1e-3 median relative).

Run it from the checkout's root on a machine with one CUDA card:

    python3 tools/torch_accuracy_control.py

It prints the card's name and power limit, one line a variant, then one JSON
object: per variant the error ratios (the card's or the kernel's error over
its twin's: median relative and max) and whether each rule passed.  Exits 1
if the sound copy fails a rule; a fault that passes is reported, not fatal.
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
# chip_smoke.py by its path: putting its directory on sys.path would shadow
# the copy's etch_tpu_torch
_SPEC = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

WORK = ROOT / "build" / "accuracy_control"
STEP = dict(num_point=1024, batch_size=2, epn_layer_num=4, use_bfloat16=True)
# variant -> (source under etch_tpu_torch/csrc, the text, its faulty replacement)
MUTANTS = {
    "slice_drop_neighbour": (   # slice 1 of the bf16 contraction loses its last neighbour
        "interconv.cu",
        "w[m][u] = 8 * m < K ? mma_weight(o, r[m], sigma, rs) : 0.f;",
        "w[m][u] = 8 * m < K && !(blockIdx.z == 1 && n == nn - 1) ? "
        "mma_weight(o, r[m], sigma, rs) : 0.f;"),
    "slice_scale_1pct": (   # slice 1 of the bf16 contraction 1% high
        "interconv.cu",
        "etch_pack_bf16(acc[m][j][2 * h], acc[m][j][2 * h + 1]);",
        "etch_pack_bf16(acc[m][j][2 * h] * (blockIdx.z == 1 ? 1.01f : 1.f), "
        "acc[m][j][2 * h + 1] * (blockIdx.z == 1 ? 1.01f : 1.f));"),
    "core_drop_bc1": (   # the wide core's h1 without its bias
        "dircore_wide.cu",
        "return etch_pack_bf16(acc[j][2 * h] + bc1[16 * n + col],\n"
        "                              acc[j][2 * h + 1] + bc1[16 * n + col + 1]);",
        "return etch_pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);"),
    "core_round_u": (   # an extra bf16 rounding of the folded last layer
        "dircore_wide.cu",
        "part[h] = fmaf(hv.y, u[col + 1], fmaf(hv.x, u[col], part[h]));",
        "part[h] = fmaf(hv.y, __bfloat162float(__float2bfloat16(u[col + 1])), "
        "fmaf(hv.x, __bfloat162float(__float2bfloat16(u[col])), part[h]));"),
    "core_scale_1pct": (   # the wide core's output 1% high
        "dircore_wide.cu",
        "= part[h] + u[d.Vp];",
        "= (part[h] + u[d.Vp]) * 1.01f;"),
    "attention_drop_key": (   # every per-head attention loses its last key
        "common.cuh",
        "if (8 * jt + t2 + (e & 1) >= L) s[jt][e] = -INFINITY;",
        "if (8 * jt + t2 + (e & 1) >= L - 1) s[jt][e] = -INFINITY;"),
}


def serve(cfg, device):
    """run_batch's outputs that the step is judged by, with the direction
    head's unit directions (captured by a forward hook, as chip_smoke does)."""
    from etch_tpu_torch.pipeline import build_pipeline
    pipe = build_pipeline(cfg, chip_smoke.MARKERSET, allow_synthetic_body=True, rng_seed=0,
                          device=device)
    seen = {}
    hook = pipe.model.direction_head.register_forward_hook(
        lambda _m, _i, o: seen.update(direction=o))
    out = pipe.run_batch(chip_smoke.capsule_clouds(cfg.batch_size, cfg.num_point, seed=3))
    hook.remove()
    return {**{k: out[k].cpu() for k in ("confidences", "vectors", "part_labels")},
            "direction": seen["direction"].cpu()}


def make_copy(variant):
    """The checkout's package in build/accuracy_control/<variant>, with the
    variant's fault planted."""
    dst = WORK / variant
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "etch_tpu_torch", dst / "etch_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if variant in MUTANTS:
        src, old, new = MUTANTS[variant]
        path = dst / "etch_tpu_torch" / "csrc" / src
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{variant}: the text to replace is not in {src} exactly once")
        path.write_text(text.replace(old, new))
    return dst


def card(refs):
    """In a copy: the serving step and the two kernels on the card."""
    from etch_tpu_torch.geometry.icosahedral import get_anchors
    from etch_tpu_torch.geometry.kernel_points import get_kernel_points
    from etch_tpu_torch.nn import dircore, interconv
    from etch_tpu_torch.nn.bf16 import BF16
    from etch_tpu_torch.ops import ball_query
    from etch_tpu_torch.utils.config import EtchConfig
    dev = torch.device("cuda", 0)
    result = {}
    ref = torch.load(refs)
    report, ok = chip_smoke.bf16_step_accuracy(serve(EtchConfig(**STEP), "cuda"),
                                               ref["cpu"], ref["f32"])
    angles = report["direction"]
    result["step"] = {"ok": ok, "part_labels_off_f32": report["part_labels_off_f32"],
                      "direction": {"ratio_median_angle": angles["card_median_angle"]
                                    / angles["cpu_median_angle"], **angles}, **{
        key: {"ratio_median": report[key]["card_median_rel"] / report[key]["cpu_median_rel"],
              "ratio_max": report[key]["card_max_abs"] / report[key]["cpu_max_abs"]}
        for key in ("confidences", "vector_length")}}

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    E, V, H = 256, 128, 8
    params = {f"{nm}{l}": randn(E, E, scale=E ** -0.5) for l in (0, 1) for nm in ("wq", "wk", "wv")}
    params.update(wc0=randn(E, E, scale=E ** -0.5), bc0=randn(E, scale=0.1),
                  wc1=randn(E, V, scale=E ** -0.5), bc1=randn(V, scale=0.1),
                  wm0=randn(V, V, scale=V ** -0.5), bm0=randn(V, scale=0.1),
                  wm1=randn(V, V, scale=V ** -0.5), bm1=randn(V, scale=0.1),
                  wr=randn(V, 1, scale=V ** -0.5), br=randn(1, scale=0.1))
    tokens = randn(2048, 60, E).to(BF16)
    got, twin, ok = chip_smoke.as_accurate(
        dircore.direction_core_cuda(tokens, params, H).float(),
        dircore.direction_core_torch(tokens, params, H).float(),
        dircore.direction_core_torch(tokens.float(), params, H).float())
    result["core_E256"] = {"ok": ok, "ratio_median": got[0] / twin[0],
                           "ratio_max": got[1] / twin[1]}

    # the bf16 contraction at C = 128 (two slices): 1024 points, 256 centers
    pts = torch.from_numpy(chip_smoke.capsule_clouds(2, 1024, seed=5)).to(dev)
    ctr = pts[:, :256].contiguous()
    nbr = ball_query(ctr, pts, 0.2, 32)
    kp = get_kernel_points(0.2, 1)
    rk = torch.from_numpy(np.einsum("aij,kj->aki", get_anchors(), kp).reshape(-1, 3)
                          .astype(np.float32)).to(dev)
    feats = randn(2, 1024, 60 * 128).to(BF16)
    out = interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, 0.05, 60).float()
    plain = interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, 0.05, 60).float()
    err = (out - plain).abs()
    worst, scale = err.max().item(), plain.abs().max().item()
    med = chip_smoke.median_rel(err, plain)
    result["interconv_bf16_C128"] = {
        "ok": worst <= chip_smoke.BF16_ATOL * scale and med <= chip_smoke.BF16_MEDIAN_REL,
        "max_over_scale": worst / scale, "median_rel": med}
    print(json.dumps(result))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--card", metavar="REFS", help=argparse.SUPPRESS)   # in a copy
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    if args.card:
        return card(args.card)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sys.path.insert(0, str(ROOT))
    from etch_tpu_torch.utils.config import EtchConfig
    WORK.mkdir(parents=True, exist_ok=True)
    refs = WORK / "refs.pt"
    cfg = EtchConfig(**STEP)
    torch.save({"cpu": serve(cfg, "cpu"), "f32": serve(cfg.replace(use_bfloat16=False), "cpu")},
               refs)
    results = {}
    for variant in ("sound", *MUTANTS):
        dst = make_copy(variant)
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--card", str(refs)],
                             cwd=dst, env={**os.environ, "PYTHONPATH": str(dst)},
                             capture_output=True, text=True)
        if run.returncode:
            raise SystemExit(f"{variant}: exit {run.returncode}\n{run.stderr[-4000:]}")
        results[variant] = json.loads(run.stdout.strip().splitlines()[-1])
        print(variant, json.dumps(results[variant]), flush=True)
    print(json.dumps({"as_accurate": chip_smoke.AS_ACCURATE,
                      "as_accurate_step": chip_smoke.AS_ACCURATE_STEP, **results}))
    return 0 if all(r["ok"] for r in results["sound"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
