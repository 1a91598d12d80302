#!/usr/bin/env python3
"""Device time of the PyTorch port's direction core, anchor attention, FPS,
vector attention, kNN, occupancy convs and grouped head at their main-path
shapes (B=8, N=5000), for comparing two checkouts on one CUDA card.  Run it
from the root of each checkout:

    PYTHONPATH=. python3 path/to/torch_kernels_ab.py [--rounds 10] [--reps 20]
        [--kernels dircore,dircore_wide,attention,fps,vector_attention,knn,ones_proj,
                   interconv_ones,grouped_head,ball_query,interconv_c1,interconv_t]

The shapes: the direction core on 40,000 points of 60 anchor tokens (E=64,
8 heads, V=128; `dircore_wide`: the same at E=128 and E=256, the wide
core of the 128- and 256-channel EPN blocks); the attention on one 2048-point chunk; FPS at the five
sampling shapes of a request (5000->2500 of the EPN, 5000->1250->312->78->19
of the U-Net geometry); vector attention at the six (R, ns, c) shapes of the
U-Nets' levels; kNN at the thirteen (k, queries, supports) shapes of a
request; the occupancy conv with its projection (`ones_proj`, bf16 path)
and without (`interconv_ones`, f32 path) at conv0's 512-center chunk and
its ragged 452-center one; the grouped confidence head at R=40,000, c0=128,
k=86; ball query at the four EPN convs' shapes of a request (`ball_query`, and each at B = 1);
the C == 1 body on f32 and bf16 rows at conv1's 512- and 452-center chunks
(`interconv_c1`); both contractions at conv1's and conv3's 512-center
chunks (`interconv_t`: f32 and bf16 rows, nn = 64, K = 24).  FPS, vector
attention, kNN, ball query and the occupancy convs also report their time a
request, each shape's time times its launches a request, summed.

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

import numpy as np
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
# (k, queries, supports, launches a request): the U-Net levels' self and down
# neighbours and up 3-NN, and the EPN features' propagation (5000 x 1250, k=3)
LV = (N, 1250, 312, 78, 19)
KNN_SHAPES = ((8, N, N, 1), (16, 1250, N, 1), (3, N, 1250, 2),
              *((16, LV[l], LV[l], 1) for l in range(1, 5)),
              *((16, LV[l], LV[l - 1], 1) for l in range(2, 5)),
              *((3, LV[l], LV[l + 1], 1) for l in range(1, 4)))
# conv0's chunks of its 2500 centers: four of 512, one of 452
OCC_CHUNKS = ((512, 4), (452, 1))


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
    knn_mod = importlib.import_module("etch_tpu_torch.ops.knn")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    wanted = args.kernels.split(",")
    kernels, per_request = {}, {}   # name -> fn; name -> (group, launches a request)
    for e in (E, 128, 256):
        name = "dircore" if e == E else f"dircore E={e}"
        if ("dircore" if e == E else "dircore_wide") not in wanted:
            continue
        params = {f"{nm}{l}": randn(e, e, scale=e ** -0.5) for l in (0, 1)
                  for nm in ("wq", "wk", "wv")}
        params.update(wc0=randn(e, e, scale=e ** -0.5), bc0=randn(e, scale=0.1),
                      wc1=randn(e, V, scale=e ** -0.5), bc1=randn(V, scale=0.1),
                      wm0=randn(V, V, scale=V ** -0.5), bm0=randn(V, scale=0.1),
                      wm1=randn(V, V, scale=V ** -0.5), bm1=randn(V, scale=0.1),
                      wr=randn(V, 1, scale=V ** -0.5), br=randn(1, scale=0.1))
        tokens = randn(M, A, e).to(torch.bfloat16)
        kernels[name] = (lambda t=tokens, p=params: dircore.direction_core_cuda(t, p, H))
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
    if {"knn", "ones_proj", "interconv_ones"} & set(wanted):
        clouds = {N: xyz}
        for n, m in FPS_SHAPES:
            clouds[m] = gather_points(clouds[n], fps_op(clouds[n], m)).contiguous()
    if "knn" in wanted:
        for kn, Q, S, launches in KNN_SHAPES:
            name = f"knn k={kn} {Q}x{S}"
            kernels[name] = (lambda q=clouds[Q], s=clouds[S], kn=kn: knn_mod.knn_cuda(q, s, kn))
            per_request[name] = ("knn", launches)
    if "ones_proj" in wanted or "interconv_ones" in wanted:
        from etch_tpu_torch.geometry.icosahedral import get_anchors
        from etch_tpu_torch.geometry.kernel_points import get_kernel_points
        from etch_tpu_torch.nn import interconv
        from etch_tpu_torch.ops.ball_query import ball_query_cuda
        from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
        spec = backbone_plan(EtchConfig(num_point=N, batch_size=B))[0][0]
        kp = get_kernel_points(spec["radius"], spec["kernel_size"])
        rk = torch.from_numpy(np.ascontiguousarray(
            np.einsum("aij,kj->aki", get_anchors(60), kp).reshape(-1, 3))).to(dev)
        nbr = ball_query_cuda(clouds[2500], xyz, spec["radius"], spec["n_neighbor"])
        w = randn(kp.shape[0], spec["dim_out"], scale=0.3)
        for c, launches in OCC_CHUNKS:
            ctr, nb = clouds[2500][:, :c].contiguous(), nbr[:, :c].contiguous()
            if "ones_proj" in wanted:
                name = f"ones_proj c={c}"
                kernels[name] = (lambda ctr=ctr, nb=nb: interconv.interconv_ones_proj_cuda(
                    xyz, ctr, nb, rk, spec["sigma"], 60, w))
                per_request[name] = ("ones_proj", launches)
            if "interconv_ones" in wanted:
                name = f"interconv_ones c={c}"
                kernels[name] = (lambda ctr=ctr, nb=nb: interconv.interconv_ones_cuda(
                    xyz, ctr, nb, rk, spec["sigma"], 60))
                per_request[name] = ("interconv_ones", launches)
    if {"ball_query", "interconv_c1", "interconv_t"} & set(wanted):
        from etch_tpu_torch.geometry.icosahedral import get_anchors
        from etch_tpu_torch.geometry.kernel_points import get_kernel_points
        from etch_tpu_torch.nn import interconv
        from etch_tpu_torch.ops.ball_query import ball_query_cuda
        from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
        plan = backbone_plan(EtchConfig(num_point=N, batch_size=B))
        specs = (plan[0][0], plan[0][1], plan[1][0], plan[1][1])
        c2500 = gather_points(xyz, fps_op(xyz, 2500)).contiguous()
        pts = {N: xyz, 2500: c2500, 1250: c2500[:, :1250].contiguous()}

        def rk_of(spec):
            kp = get_kernel_points(spec["radius"], spec["kernel_size"])
            return torch.from_numpy(np.ascontiguousarray(
                np.einsum("aij,kj->aki", get_anchors(60), kp).reshape(-1, 3))).to(dev)
    if "ball_query" in wanted:
        for i, sp in enumerate(specs):   # one launch each a request; and at B = 1
            q, s = pts[sp["n_out"]], pts[sp["n_in"]]
            name = f"ball_query conv{i} {q.shape[1]}x{s.shape[1]}"
            kernels[name] = (lambda q=q, s=s, sp=sp: ball_query_cuda(
                q, s, sp["radius"], sp["n_neighbor"]))
            per_request[name] = ("ball_query", 1)
            q1, s1 = q[:1].contiguous(), s[:1].contiguous()
            kernels[f"{name} B=1"] = (lambda q=q1, s=s1, sp=sp: ball_query_cuda(
                q, s, sp["radius"], sp["n_neighbor"]))
    if "interconv_c1" in wanted or "interconv_t" in wanted:
        for i in ((1, 3) if "interconv_t" in wanted else (1,)):
            sp = specs[i]
            src, C = pts[sp["n_in"]], sp["dim_in"]
            nb = ball_query_cuda(pts[sp["n_out"]], src, sp["radius"], sp["n_neighbor"])
            rk = rk_of(sp)
            for dt in (torch.float32, torch.bfloat16):
                tag = "f32" if dt == torch.float32 else "bf16"
                chunks = ((512, 4), (452, 1)) if i == 1 else ((512, 2),)
                for c, launches in chunks:
                    ctr, nbc = src[:, :c].contiguous(), nb[:, :c].contiguous()
                    if "interconv_c1" in wanted and i == 1:
                        f1 = randn(B, src.shape[1], 60).to(dt)
                        name = f"interconv_c1 {tag} c={c}"
                        kernels[name] = (lambda ctr=ctr, nbc=nbc, f1=f1, rk=rk, sp=sp, src=src:
                                         interconv.interconv_t_c1_cuda(src, ctr, nbc, f1, rk,
                                                                       sp["sigma"], 60))
                        per_request[name] = (f"interconv_c1 {tag}", launches)
                    if "interconv_t" in wanted and c == 512:
                        fc = randn(B, src.shape[1], 60 * C).to(dt)
                        name = f"interconv_t {tag} conv{i} c={c} C={C}"
                        kernels[name] = (lambda ctr=ctr, nbc=nbc, fc=fc, rk=rk, sp=sp, src=src:
                                         interconv.interconv_t_cuda(src, ctr, nbc, fc, rk,
                                                                    sp["sigma"], 60))
    if "grouped_head" in wanted:
        from etch_tpu_torch.nn import grouped_head
        c0, kg = 128, 86
        gh = (randn(M, c0).to(torch.bfloat16), randn(c0, kg * c0, scale=c0 ** -0.5),
              randn(kg * c0, scale=0.1), randn(kg, c0, scale=(6 / (kg + c0)) ** 0.5),
              randn(kg, scale=0.1))
        kernels["grouped_head"] = lambda: grouped_head.grouped_head_cuda(*gh)
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
