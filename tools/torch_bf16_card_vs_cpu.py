#!/usr/bin/env python3
"""How far the PyTorch port's bf16 serving step on a CUDA card is from the
same step on the CPU, and from the same weights served in f32, with the
card's kernels and with their plain versions in their place.  Run it from
the root of a checkout on a machine with a card:

    python3 tools/torch_bf16_card_vs_cpu.py [--layers 2,3,4] [--num-point 1024]

For each `EtchConfig(epn_layer_num=L)` at B=2 (random weights from
`rng_seed=0`, the synthetic body, capsule clouds as `chip_smoke.py`), it
serves five steps: f32 and bf16 on the CPU, bf16 on the card with the
kernels, bf16 on the card with every kernel wrapper's plain version in
place of the kernel, and f32 on the card.  It prints, per pair, the median
relative error (|a - b| / (|b| + 1e-2)) and the largest absolute error of
the confidences and of the vector lengths.  Rounding to bf16 at the same
points in another summation order flips a rounding now and then, and the
flips travel through the network: the pair "card plain vs CPU bf16" shows
how far that alone takes the card from the CPU.

Then, for the fused direction core at E = 64, 128 and 256 (8 heads, V=128,
weights N(0, 1/fan-in), 2000 points of 60 tokens): the plain twin with its
products summed in float64 against the same in f32 (its sensitivity to the
summation order), and the kernel and the plain twin against the unrounded
f32 function.  Prints the card's name and power limit first, then one JSON
line per configuration.
"""

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (capsule clouds and the marker set)

# module -> kernel wrappers whose `<name>_cuda` the plain `<name>_torch` replaces
WRAPPERS = {"etch_tpu_torch.ops.fps": ["fps"], "etch_tpu_torch.ops.knn": ["knn"],
            "etch_tpu_torch.ops.ball_query": ["ball_query"],
            "etch_tpu_torch.nn.interconv": ["interconv_t", "interconv_t_c1", "interconv_ones",
                                            "interconv_ones_proj"],
            "etch_tpu_torch.nn.dircore": ["direction_core"],
            "etch_tpu_torch.nn.attention": ["attention"],
            "etch_tpu_torch.nn.vector_attention": ["vector_attention"],
            "etch_tpu_torch.nn.grouped_head": ["grouped_head"]}


def plain_in_place_of_kernels():
    """Point every `<name>_cuda` at its plain twin; returns the undo."""
    saved = []
    for module, names in WRAPPERS.items():
        mod = importlib.import_module(module)
        for name in names:
            saved.append((mod, f"{name}_cuda", getattr(mod, f"{name}_cuda")))
            plain = getattr(mod, f"{name}_torch")
            setattr(mod, f"{name}_cuda", lambda *a, plain=plain, **k: plain(*a))
    return lambda: [setattr(mod, attr, fn) for mod, attr, fn in saved]


def serve(cfg, device):
    from etch_tpu_torch.pipeline import build_pipeline
    pts = chip_smoke.capsule_clouds(cfg.batch_size, cfg.num_point, seed=3)
    pipe = build_pipeline(cfg, chip_smoke.MARKERSET, allow_synthetic_body=True, rng_seed=0,
                          device=device)
    with torch.no_grad():
        out = pipe.run_batch(pts)
    return {"confidences": out["confidences"].float().cpu().reshape(-1),
            "vector_length": out["vectors"].float().cpu().norm(dim=-1).reshape(-1)}


def errors(a, b):
    res = {}
    for key in a:
        err = (a[key] - b[key]).abs()
        res[key] = {"median_rel": (err / (b[key].abs() + 1e-2)).median().item(),
                    "max_abs": err.max().item()}
    return res


def direction_core_conditioning(E, dev):
    from etch_tpu_torch.nn import dircore
    from etch_tpu_torch.nn.bf16 import rnd
    g = np.random.RandomState(3)
    V, H = 128, 8
    p = {f"{n}{l}": g.randn(E, E) / np.sqrt(E) for l in (0, 1) for n in ("wq", "wk", "wv")}
    p.update(wc0=g.randn(E, E) / np.sqrt(E), bc0=0.1 * g.randn(E),
             wc1=g.randn(E, V) / np.sqrt(E), bc1=0.1 * g.randn(V),
             wm0=g.randn(V, V) / np.sqrt(V), bm0=0.1 * g.randn(V),
             wm1=g.randn(V, V) / np.sqrt(V), bm1=0.1 * g.randn(V),
             wr=g.randn(V, 1) / np.sqrt(V), br=0.1 * g.randn(1))
    params = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in p.items()}
    tok = torch.from_numpy(np.random.RandomState(0).randn(2000, 60, E).astype(np.float32))
    tok = tok.to(dev, torch.bfloat16)
    plain = dircore.direction_core_torch(tok, params, H)
    mm = dircore.mm
    dircore.mm = lambda a, w, on=True: (rnd(a, on).double() @ rnd(w, on).double()).float()
    plain64 = dircore.direction_core_torch(tok, params, H)
    dircore.mm = mm
    exact = dircore.direction_core_torch(tok.float(), params, H)
    kernel = dircore.direction_core_cuda(tok, params, H)
    rel = lambda a, b: ((a - b).abs() / (b.abs() + 1e-2)).median().item()
    return {"E": E, "plain_f64_sums_vs_plain_median_rel": rel(plain64, plain),
            "kernel_vs_plain_median_rel": rel(kernel, plain),
            "kernel_vs_exact": {"median_rel": rel(kernel, exact),
                                "max_abs": (kernel - exact).abs().max().item()},
            "plain_vs_exact": {"median_rel": rel(plain, exact),
                               "max_abs": (plain - exact).abs().max().item()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", default="2,3,4")
    ap.add_argument("--num-point", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    from etch_tpu_torch.utils.config import EtchConfig
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for layers in (int(x) for x in args.layers.split(",")):
        cfg = EtchConfig(num_point=args.num_point, batch_size=2, epn_layer_num=layers)
        bf = cfg.replace(use_bfloat16=True)
        cpu_f32, cpu_bf16 = serve(cfg, "cpu"), serve(bf, "cpu")
        card_kernels, card_f32 = serve(bf, "cuda"), serve(cfg, "cuda")
        undo = plain_in_place_of_kernels()
        try:
            card_plain = serve(bf, "cuda")
        finally:
            undo()
        print(json.dumps({"epn_layer_num": layers, "num_point": args.num_point,
                          "card_kernels_vs_cpu_bf16": errors(card_kernels, cpu_bf16),
                          "card_plain_vs_cpu_bf16": errors(card_plain, cpu_bf16),
                          "card_kernels_vs_card_plain": errors(card_kernels, card_plain),
                          "cpu_bf16_vs_cpu_f32": errors(cpu_bf16, cpu_f32),
                          "card_kernels_vs_cpu_f32": errors(card_kernels, cpu_f32),
                          "card_plain_vs_cpu_f32": errors(card_plain, cpu_f32),
                          "card_f32_vs_cpu_f32": errors(card_f32, cpu_f32)}), flush=True)
    for E in (64, 128, 256):
        print(json.dumps({"direction_core": direction_core_conditioning(E, "cuda")}), flush=True)


if __name__ == "__main__":
    main()
