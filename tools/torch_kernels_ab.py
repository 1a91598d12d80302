#!/usr/bin/env python3
"""Device time of the PyTorch port's direction core, anchor attention, FPS
and vector attention at their main-path shapes (B=8, N=5000), for comparing
two checkouts on one CUDA card.  Run it from the root of each checkout:

    PYTHONPATH=. python3 path/to/torch_kernels_ab.py [--rounds 10] [--reps 20]
        [--kernels dircore,attention,fps,vector_attention]

The shapes: the direction core on 40,000 points of 60 anchor tokens (E=64,
8 heads, V=128); the attention on one 2048-point chunk; FPS at the five
sampling shapes of a request (5000->2500 of the EPN, 5000->1250->312->78->19
of the U-Net geometry); vector attention at the six (R, ns, c) shapes of the
U-Nets' levels.  FPS and vector attention also report their time a request,
each shape's time times its launches a request, summed.

It imports `etch_tpu_torch` from the current directory, so one copy of this
script times any checkout; its timing helpers and clouds are those of the
`chip_smoke.py` beside the script's own `tools/`.  Alternate the checkouts (A, B, B, A), one
after the other on one card.  Prints the card's name and power limit, then one JSON
line: per kernel and shape, the median and quartiles over rounds of the mean
time of `reps` back-to-back launches (CUDA events) and of the same launches
replayed from a CUDA graph (`graph_`: the device's time without the host's
launch overhead, which holds the eager time of a short launch), with the
checkout's directory.
"""

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
from pathlib import Path

import torch

# chip_smoke.py by its path: putting its directory on sys.path would shadow
# the current directory's etch_tpu_torch
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

M, A, E, H, V, CHUNK = 40000, 60, 64, 8, 128, 2048
B, N = 8, 5000
FPS_SHAPES = ((N, 2500), (N, 1250), (1250, 312), (312, 78), (78, 19))   # one launch each
# U-Net level, width, launches a request (two U-Nets: magnitude 64, 128, 256,
# 256, 512 and confidence 128, 128, 256, 256, 512; blocks 2, 3, 4, 6, 3)
VA_SHAPES = ((0, 64, 2), (0, 128, 2), (1, 128, 6), (2, 256, 8), (3, 256, 12), (4, 512, 6))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="dircore,attention,fps,vector_attention")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    from etch_tpu_torch.nn import attention, dircore, vector_attention
    from etch_tpu_torch.nn.point_transformer import unet_geometry
    from etch_tpu_torch.ops import fps as fps_op
    from etch_tpu_torch.ops.grouping import gather_points
    fps_mod = importlib.import_module("etch_tpu_torch.ops.fps")   # the module, not its re-export

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    wanted = args.kernels.split(",")
    kernels, per_request = {}, {}   # name -> fn; name -> (group, launches a request)
    if "dircore" in wanted:
        params = {f"{nm}{l}": randn(E, E, scale=E ** -0.5) for l in (0, 1)
                  for nm in ("wq", "wk", "wv")}
        params.update(wc0=randn(E, E, scale=E ** -0.5), bc0=randn(E, scale=0.1),
                      wc1=randn(E, V, scale=E ** -0.5), bc1=randn(V, scale=0.1),
                      wm0=randn(V, V, scale=V ** -0.5), bm0=randn(V, scale=0.1),
                      wm1=randn(V, V, scale=V ** -0.5), bm1=randn(V, scale=0.1),
                      wr=randn(V, 1, scale=V ** -0.5), br=randn(1, scale=0.1))
        tokens = randn(M, A, E).to(torch.bfloat16)
        kernels["dircore"] = lambda: dircore.direction_core_cuda(tokens, params, H)
    if "attention" in wanted:
        q, k, v = (randn(CHUNK, A, E, scale=(E // H) ** -0.5 if i == 0 else 1.0)
                   .to(torch.bfloat16) for i in range(3))
        kernels["attention"] = lambda: attention.attention_cuda(q, k, v, H)
    xyz = torch.from_numpy(chip_smoke.capsule_clouds(B, N)).to(dev)
    if "fps" in wanted:
        clouds = {N: xyz}
        for n, m in FPS_SHAPES:
            src = clouds[n]
            clouds[m] = gather_points(src, fps_op(src, m)).contiguous()
            kernels[f"fps {n}->{m}"] = (lambda src=src, m=m: fps_mod.fps_cuda(src, m))
            per_request[f"fps {n}->{m}"] = ("fps", 1)
    if "vector_attention" in wanted:
        geom = unet_geometry(xyz, (1, 4, 4, 4, 4), (8, 16, 16, 16, 16))
        for lvl, c, launches in VA_SHAPES:
            idx = geom[lvl]["self"]
            Bl, Nl, ns = idx.shape
            cs = c // 8
            va = (randn(Bl * Nl, c).to(torch.bfloat16), randn(Bl, Nl, c).to(torch.bfloat16),
                  randn(Bl, Nl, c).to(torch.bfloat16), idx,
                  randn(Bl * Nl, ns, c).to(torch.bfloat16),
                  torch.stack([randn(c).abs() + 0.5, randn(c)]), randn(c, cs, scale=c ** -0.5),
                  torch.stack([randn(cs).abs() + 0.5, randn(cs)]),
                  randn(cs, cs, scale=cs ** -0.5), randn(cs))
            name = f"vector_attention R={Bl * Nl} ns={ns} c={c}"
            kernels[name] = (lambda va=va: vector_attention.vector_attention_cuda(*va))
            per_request[name] = ("vector_attention", launches)
    times = {name: [] for name in kernels}
    graph = {name: [] for name in kernels}
    for _ in range(args.rounds):
        for name, fn in kernels.items():
            times[name].append(chip_smoke.cuda_ms(torch, fn, args.reps))
            graph[name].append(chip_smoke.graph_ms(torch, fn, args.reps))
    out = {}
    for name in kernels:
        q1, med, q3 = statistics.quantiles(times[name], n=4)
        gq1, gmed, gq3 = statistics.quantiles(graph[name], n=4)
        out[name] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3, "rounds": times[name],
                     "graph_median_ms": gmed, "graph_q1_ms": gq1, "graph_q3_ms": gq3}
    for group in sorted({g for g, _ in per_request.values()}):
        out[f"{group} a request"] = {}
        for key, ts in (("", times), ("graph_", graph)):
            rounds = [sum(ts[n][r] * per_request[n][1] for n in per_request
                          if per_request[n][0] == group) for r in range(args.rounds)]
            q1, med, q3 = statistics.quantiles(rounds, n=4)
            out[f"{group} a request"].update({f"{key}median_ms": med, f"{key}q1_ms": q1,
                                              f"{key}q3_ms": q3, f"{key}rounds": rounds})
    print(json.dumps({"checkout": os.getcwd(), "reps": args.reps, **out}))


if __name__ == "__main__":
    main()
