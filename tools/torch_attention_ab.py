#!/usr/bin/env python3
"""Device time of the PyTorch port's direction core and anchor attention at
their main-path shapes (B=8, N=5000: 40,000 points of 60 anchor tokens, E=64,
8 heads, V=128; attention on 2048-point chunks), for comparing two checkouts
on one CUDA card.  Run it from the root of each checkout:

    PYTHONPATH=. python3 path/to/torch_attention_ab.py [--rounds 10] [--reps 20]

It imports `etch_tpu_torch` from the current directory, so one copy of this
script times any checkout.  Alternate the checkouts (A, B, B, A), one
after the other on one card.  Prints the card's name and power limit, then one JSON
line: per kernel, the median and quartiles over rounds of the mean time of
`reps` back-to-back launches (CUDA events), with the checkout's directory.
"""

import argparse
import json
import os
import statistics
import subprocess

import torch

M, A, E, H, V, CHUNK = 40000, 60, 64, 8, 128, 2048


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false")
    from etch_tpu_torch.nn import attention, dircore

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    params = {f"{nm}{l}": randn(E, E, scale=E ** -0.5) for l in (0, 1) for nm in ("wq", "wk", "wv")}
    params.update(wc0=randn(E, E, scale=E ** -0.5), bc0=randn(E, scale=0.1),
                  wc1=randn(E, V, scale=E ** -0.5), bc1=randn(V, scale=0.1),
                  wm0=randn(V, V, scale=V ** -0.5), bm0=randn(V, scale=0.1),
                  wm1=randn(V, V, scale=V ** -0.5), bm1=randn(V, scale=0.1),
                  wr=randn(V, 1, scale=V ** -0.5), br=randn(1, scale=0.1))
    tokens = randn(M, A, E).to(torch.bfloat16)
    q, k, v = (randn(CHUNK, A, E, scale=(E // H) ** -0.5 if i == 0 else 1.0).to(torch.bfloat16)
               for i in range(3))
    kernels = {"dircore": lambda: dircore.direction_core_cuda(tokens, params, H),
               "attention": lambda: attention.attention_cuda(q, k, v, H)}
    times = {name: [] for name in kernels}
    for _ in range(args.rounds):
        for name, fn in kernels.items():
            times[name].append(cuda_ms(fn, args.reps))
    out = {}
    for name, ts in times.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        out[name] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3, "rounds": ts}
    print(json.dumps({"checkout": os.getcwd(), "reps": args.reps, **out}))


if __name__ == "__main__":
    main()
