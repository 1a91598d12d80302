#!/usr/bin/env python3
"""Quickest proof that the PyTorch port's serving step runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (the kernels under etch_tpu_torch/csrc are
built at first use).  Phases, each of which raises on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc the kernels, print the build time and ptxas register use;
  3. kernel vs plain PyTorch version on the card, at every shape a request
     launches it at on the main paths (FPS at the EPN's and the U-Net's five
     sampling shapes, kNN at the U-Net's thirteen, ball query at the four
     EPN convs, both contractions at conv1, conv2 and conv3 in 512-center
     chunks and their ragged last chunk, the occupancy convs likewise, the
     anchor attention at full and ragged 2048-point chunks, vector attention
     at each U-Net level): FPS, kNN and ball-query indices must be equal,
     the f32 inter-conv contraction (3xTF32 on the tensor cores; C >= 4 and
     C == 1 rows) and occupancy conv within
     1e-5 * max|t| (f32 sums in another order); the bf16 kernels (contraction
     on bf16 rows, C >= 8 and C == 1, occupancy conv with its projection,
     direction core, anchor attention, vector attention, grouped head) within
     1e-2 * max|plain| at every element with a median relative error
     |diff| / (|plain| + 1e-2) <= 1e-3 (the same rounding points, another
     summation order); kernel and plain times side by side with each
     kernel's bound (the larger of its bytes over 3.35 TB/s and its
     operations over 989 TFLOP/s of bf16 tensor work, 495 TFLOP/s of TF32
     for the f32 contraction's three passes, or 67 TFLOP/s of FP32, from
     the shapes: `bound`), and for the anchor attention the time of
     `scaled_dot_product_attention` on the same inputs (no other kernel has
     one PyTorch call that computes its function);
  4. small-input reference: the serving step at tiny widths on the card
     (kernels) against the same weights on the CPU (plain versions), in five
     variants (SMALL_STEPS): f32; bf16 with two direction layers (the fused
     direction core); bf16 with the tiny config's one layer (the chunked core
     and the anchor-attention kernel); f32 and bf16 with an EPN schedule
     whose second conv reads 1-channel rows (the C == 1 contraction).  Each
     must launch exactly its own kernel set; tolerances in `small_step`;
  5. main paths: `build_pipeline(EtchConfig(num_point=5000, batch_size=8,
     use_bfloat16=...))` with random weights and the synthetic body,
     `run_batch` on capsule clouds: bf16 (the configuration bench.py times),
     bf16 with `direction_head.fused_core = False` (the chunked core, 40
     anchor-attention launches a request) and f32: one warm request, the
     network's stage times (median of three requests), then timed
     requests; every kernel of the path's own set must have launched
     during them and no other, and at no shape that phase 3 did not time
     (the launch counters count each kernel by the sizes it was launched
     at, `_build.shape_launches`); each timed shape's launches a request
     and gap (launches x (time - bound)) come from those counts; then a B=1
     request's latency (not for the chunked variant);
  6. the single-scan entry point: `python -m etch_tpu_torch.cli.infer` (its
     `main`) on the repository's 4D-DRESS scan, f32, N=5000, synthetic body,
     into a temporary directory: both files written with the export schema;
     then the latency of `run_scan` on a built pipeline.

The line before the last is a JSON object with one entry per kernel (its
launches on a path and per request, its headline shape's times, bound and
library time, its gap summed over its shapes, and every shape's numbers
with its counted launches a request); the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or
without the etch_tpu_torch package beside it, the script exits non-zero
before printing either.
"""

import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

B, N = 8, 5000
TIMED_REQUESTS = 3
MARKERSET = {f"M{i}": int(v) for i, v in enumerate(np.linspace(0, 6889, 86).astype(int))}
INTERCONV_RTOL = 1e-5   # max |kernel - plain| <= 1e-5 * max |plain|
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) for the bounds
PEAK_BYTES_S, PEAK_BF16_TENSOR, PEAK_TF32_TENSOR, PEAK_FP32 = 3.35e12, 989e12, 495e12, 67e12
BF16_ATOL = 1e-2        # bf16 kernels: max |kernel - plain| <= 1e-2 * max |plain|
BF16_MEDIAN_REL = 1e-3  # and median |kernel - plain| / (|plain| + 1e-2) <= 1e-3
# Where bf16 rounding flips are so common that a change of summation order
# alone misses that median criterion (the direction core at E = 256; a serving
# step at full width, card against CPU, plain versions or kernels alike), the
# result is held to be as accurate as its plain twin instead: its error
# against the unrounded f32 function at most AS_ACCURATE (a kernel) or
# AS_ACCURATE_STEP (a serving step) times the twin's, in the median and the
# max.  Each limit sits between the ratios of the sound code and of planted
# faults (tools/torch_accuracy_control.py, on an H100): the E = 256 core reads
# 1.00 sound and 1.9-2.5 when 1% high; the epn_layer_num=4 bf16 step reads up
# to 1.14 sound and 1.36-1.43 when one contraction slice drops a neighbour.
AS_ACCURATE = 1.5
AS_ACCURATE_STEP = 1.3
# the kernels each serving path launches (and no others): f32, bf16 with the
# fused direction core, bf16 with the chunked core (fused_core=False, or one
# direction layer), and each with the 1-channel conv of C1_MLPS
PATH_KERNELS = {
    "f32": ("fps", "knn", "ball_query", "interconv_ones", "interconv_t"),
    "bf16": ("fps", "knn", "ball_query", "interconv_ones_proj", "interconv_t_bf16",
             "dircore", "vector_attention", "grouped_head"),
    "bf16_chunked": ("fps", "knn", "ball_query", "interconv_ones_proj", "interconv_t_bf16",
                     "attention", "vector_attention", "grouped_head"),
}
PATH_KERNELS["f32_c1"] = PATH_KERNELS["f32"] + ("interconv_t_c1",)
PATH_KERNELS["bf16_chunked_c1"] = PATH_KERNELS["bf16_chunked"] + ("interconv_t_c1",)
C1_MLPS = ((1, 8), (8, 8))   # an EPN schedule whose second conv reads 1-channel rows
SCAN = "datafolder/4D-DRESS/data_processed/model/00122_Inner_Take2_00011/00122_Inner_Take2_00011.obj"
MARKERSET_PATH = "datafolder/useful_data_4d-dress/superset_smpl.json"
NPZ_SHAPES = {"body_pose": (21, 3), "hand_pose": (2, 3), "betas": (10,),
              "global_orient": (3,), "transl": (3,), "joints": (45, 3)}
SOURCES = {  # kernel -> (source under etch_tpu_torch/csrc, the TPU kernel it replaces)
    "fps": ("fps.cu", "etch_tpu/ops/pallas_fps.py:71"),
    "knn": ("knn.cu", "etch_tpu/ops/pallas_knn.py:82"),
    "ball_query": ("knn.cu", "etch_tpu/ops/pallas_knn.py:169"),
    "interconv_ones": ("interconv.cu", "etch_tpu/nn/pallas_interconv.py:149"),
    "interconv_t": ("interconv.cu", "etch_tpu/nn/pallas_interconv.py:115"),
    "interconv_ones_proj": ("interconv.cu", "etch_tpu/nn/pallas_interconv.py:160"),
    "interconv_t_bf16": ("interconv.cu", "etch_tpu/nn/pallas_interconv.py:115"),
    "interconv_t_c1": ("interconv.cu", "etch_tpu/nn/pallas_interconv.py:183"),
    "dircore": ("dircore.cu", "etch_tpu/nn/pallas_dircore.py:153"),
    "attention": ("attention.cu", "etch_tpu/nn/pallas_attention.py:152"),
    "vector_attention": ("vector_attention.cu",
                         "etch_tpu/nn/pallas_vector_attention.py:109"),
    "grouped_head": ("grouped_head.cu", "etch_tpu/nn/pallas_grouped_head.py:61"),
}


def capsule_clouds(batch, n, seed=0):
    """Human-scan-like clouds: points on a scaled vertical capsule (bench.py)."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(-0.9, 0.9, (batch, n))
    th = rng.uniform(0, 2 * np.pi, (batch, n))
    r = 0.15 + 0.03 * np.cos(3 * z)
    return np.stack([r * np.cos(th), r * np.sin(th), z], axis=-1).astype(np.float32)


def bound(bytes_, tensor_flop=0.0, fp32_flop=0.0, tensor_peak=PEAK_BF16_TENSOR):
    """Least time (ms) the card could take for a kernel's work, and what sets
    it: `bytes_` moved (each input read once, each output written once) over
    the memory rate, or the operations over their peak (tensor-core products
    at `tensor_peak`, bf16 unless said otherwise, and FP32 arithmetic outside
    the tensor cores; the two units run side by side, so the slower of the
    two)."""
    t = {"bytes": bytes_ / PEAK_BYTES_S,
         "operations": max(tensor_flop / tensor_peak, fp32_flop / PEAK_FP32)}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


# FP32 operations per kernel-point weight relu(1 - |x - r|^2 / sigma)
WEIGHT_FLOP = 11


def interconv_bound(B, P, c, nn, A, K, C, elem):
    """The contraction: xyz, centers, indices, rk and the whole (B, P, A*C)
    row tensor read, t (B, c, A, K, C) written; the weights on FP32 cores,
    the products on the tensor cores: bf16 for bf16 rows (elem 2), and for
    f32 rows (elem 4) three TF32 passes, the least the tensor cores need for
    f32-accurate products whatever the kernel's design."""
    bytes_ = (B * P * 3 + B * c * 3 + A * K * 3) * 4 + B * c * nn * 4 + \
        (B * P * A * C + B * c * A * K * C) * elem
    products = 2.0 * B * c * nn * A * K * C
    weights = float(WEIGHT_FLOP) * B * c * nn * A * K
    if elem == 2:
        return bound(bytes_, products, weights)
    return bound(bytes_, 3.0 * products, weights, PEAK_TF32_TENSOR)


def wide_specs(n):
    """The convs of EtchConfig(epn_layer_num=4) at N = n whose rows are
    wider than 64 channels: 128 (conv5) and 256 (conv7), each block's
    second conv (its centers are its input points)."""
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan
    plan = backbone_plan(EtchConfig(num_point=n, batch_size=B, epn_layer_num=4))
    return [plan[2][1], plan[3][1]]


def wide_points(torch, dev, spec):
    """The spec's input points: a capsule cloud of its size."""
    return torch.from_numpy(capsule_clouds(B, spec["n_in"], seed=spec["dim_in"])).to(dev)


def chunks(n, size=512):
    """The chunk sizes of n centers streamed `size` at a time, as
    InterSO3Conv does: `size`, and the ragged last one where there is one."""
    rest = n % size
    return [size] + ([rest] if rest else []) if n >= size else [n]


def cuda_ms(torch, fn, reps):
    """Mean device time of fn over `reps` back-to-back calls, after a warm-up."""
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


def graph_ms(torch, fn, reps):
    """Mean device time of fn over `reps` calls captured in one CUDA graph and
    replayed: the device's time without the host's launch overhead, which
    holds the eager time of a short launch (the wrappers' Python)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / reps


def median_rel(err, ref):
    """Median of |err| / (|ref| + 1e-2), over a sample of at most 16 M values."""
    rel = (err / (ref.abs() + 1e-2)).flatten()
    return rel[::max(1, rel.numel() >> 24)].median().item()


def as_accurate(out, twin, exact, limit=AS_ACCURATE):
    """`out` (a kernel's or the card's bf16 result) and `twin` (its plain
    twin's) against `exact`, the same function unrounded: out's (median
    relative, max) error, twin's, and whether out's are within `limit`
    times twin's in both."""
    ek, et = (out - exact).abs(), (twin - exact).abs()
    got = (median_rel(ek, exact), ek.max().item())
    ref = (median_rel(et, exact), et.max().item())
    return got, ref, got[0] <= limit * ref[0] and got[1] <= limit * ref[1]


def bf16_step_accuracy(gpu, cpu, f32):
    """A full-width bf16 serving step on the card (`gpu`) and on the CPU
    (`cpu`), each against the same weights served in f32 on the CPU:
    confidences and vector lengths (`as_accurate`, the CPU's step as the
    twin) and the share of part labels off the f32 ones.  Returns the
    report and whether the card's step is as accurate as the CPU's: within
    AS_ACCURATE_STEP times its errors, and part labels off on at most
    max(AS_ACCURATE_STEP times the CPU's share, 2%) of the points.  None of
    these depends on the direction head (directions are unit vectors): its
    core is judged by `as_accurate` in phase 3 and the card tests."""
    report, ok = {}, True
    for key, fn in (("confidences", lambda o: o["confidences"].float().cpu()),
                    ("vector_length", lambda o: o["vectors"].float().cpu().norm(dim=-1))):
        (gm, gx), (cm, cx), good = as_accurate(fn(gpu), fn(cpu), fn(f32), AS_ACCURATE_STEP)
        report[key] = {"card_median_rel": gm, "card_max_abs": gx, "cpu_median_rel": cm,
                       "cpu_max_abs": cx}
        ok = ok and good
    off = [(o["part_labels"].cpu() != f32["part_labels"]).float().mean().item()
           for o in (gpu, cpu)]
    report["part_labels_off_f32"] = {"card": off[0], "cpu": off[1]}
    return report, ok and off[0] <= max(AS_ACCURATE_STEP * off[1], 0.02)


def compare_kernels(torch, dev):
    """Phase 3: every kernel against its plain version at main-path shapes.
    Returns {kernel: {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
    "library_ms", "shapes"}}: the numbers of the first (headline) shape of
    each kernel, the largest error over its shapes, and every shape's numbers
    under "shapes", each with the key its launches are counted under."""
    from etch_tpu_torch import _build
    from etch_tpu_torch.geometry.icosahedral import get_anchors
    from etch_tpu_torch.geometry.kernel_points import get_kernel_points
    from etch_tpu_torch.nn import interconv
    # the modules themselves: etch_tpu_torch.ops re-exports same-named functions
    bq = importlib.import_module("etch_tpu_torch.ops.ball_query")
    fp = importlib.import_module("etch_tpu_torch.ops.fps")
    kn = importlib.import_module("etch_tpu_torch.ops.knn")
    from etch_tpu_torch.ops.grouping import gather_points
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan

    results = {}

    def record(kernel, shape, err, fn, reps, plain_ms, bnd, library_ms=None):
        """One shape's numbers: fn's eager time over `reps` launches and its
        time replayed from a CUDA graph (`graph_ms`), then the rest.  The
        shape's key is that of the kernel's latest launch."""
        ms = cuda_ms(torch, fn, reps)
        key = _build.last_shape[kernel]
        gms = graph_ms(torch, fn, reps)
        bound_ms, by = bnd
        lib = "" if library_ms is None else f"  library {library_ms:.3f} ms"
        print(f"  {kernel:19s} {shape:34s} max_abs_err {err:.3g}  kernel {ms:.3f} ms"
              f" (graph {gms:.4f})  plain {plain_ms:.3f} ms  bound {bound_ms:.4f} ms ({by}, "
              f"{100 * bound_ms / ms:.1f}% of it){lib}")
        entry = {"shape": shape, "key": key, "ms": ms, "graph_ms": gms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                 "max_abs_err": err}
        prev = results.get(kernel)
        if prev is None:
            results[kernel] = {"max_abs_err": err, "ms": ms, "graph_ms": gms, "plain_ms": plain_ms,
                               "bound_ms": bound_ms, "bound_by": by,
                               "library_ms": library_ms, "shapes": [entry]}
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)
            prev["shapes"].append(entry)

    xyz = torch.from_numpy(capsule_clouds(B, N, seed=1)).to(dev)

    # FPS launches of a request: the EPN's 5000->2500 and the U-Net
    # geometry's 5000->1250->312->78->19 (nn/point_transformer.py)
    clouds = {N: xyz}
    for n, m in ((N, 2500), (N, 1250), (1250, 312), (312, 78), (78, 19)):
        src = clouds[n]
        out = fp.fps_cuda(src, m)
        ref = fp.fps_torch(src, m)
        if not torch.equal(out, ref):
            raise AssertionError(f"fps {n}->{m}: kernel and plain indices differ")
        record("fps", f"B={B} {n}->{m}", 0.0,
               lambda: fp.fps_cuda(src, m), 5,
               cuda_ms(torch, lambda: fp.fps_torch(src, m), 1),
               bound(B * n * 12 + B * m * 4, 0.0, 10.0 * B * m * n))
        clouds[m] = gather_points(src, out).contiguous()
    # repaired: a cloud past the register instance (the device-memory one)
    big = torch.from_numpy(capsule_clouds(B, 20000, seed=2)).to(dev)
    out = fp.fps_cuda(big, 2000)
    if not torch.equal(out, fp.fps_torch(big, 2000)):
        raise AssertionError("fps 20000->2000: kernel and plain indices differ")
    record("fps", f"B={B} 20000->2000", 0.0, lambda: fp.fps_cuda(big, 2000), 3,
           cuda_ms(torch, lambda: fp.fps_torch(big, 2000), 1),
           bound(B * 20000 * 12 + B * 2000 * 4, 0.0, 10.0 * B * 2000 * 20000))
    del big

    # kNN shapes of a request (k, queries, supports): each U-Net level's self
    # neighbours, the down neighbours of levels 1-4 and the up 3-NN of
    # levels 0-3 (5000x1250 k=3 also propagates the EPN's features)
    lv = (N, 1250, 312, 78, 19)
    knn_shapes = [(8, N, N), (16, 1250, N), (3, N, 1250)]
    knn_shapes += [(16, lv[l], lv[l]) for l in range(1, 5)]
    knn_shapes += [(16, lv[l], lv[l - 1]) for l in range(2, 5)]
    knn_shapes += [(3, lv[l], lv[l + 1]) for l in range(1, 4)]
    for k, Q, S in knn_shapes:
        q, s = clouds[Q], clouds[S]
        label = f"k={k} {Q}x{S}"
        idx, d2 = kn.knn_cuda(q, s, k)
        ridx, rd2 = kn.knn_torch(q, s, k)
        if not torch.equal(idx, ridx):
            raise AssertionError(f"knn {label}: kernel and plain indices differ")
        err = (d2 - rd2).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"knn {label}: squared distances differ by {err}")
        record("knn", f"B={B} {label}", err,
               lambda: kn.knn_cuda(q, s, k), 5,
               cuda_ms(torch, lambda: kn.knn_torch(q, s, k), 2),
               bound(B * (Q + S) * 12 + B * Q * k * 8, 0.0, 8.0 * B * Q * S))

    # ball query of each EPN conv: its centers among its input points
    # (conv0 samples 2500 by FPS, conv2 the first 1250 lazily)
    plan = backbone_plan(EtchConfig(num_point=N, batch_size=B))
    specs = (plan[0][0], plan[0][1], plan[1][0], plan[1][1])
    q2500 = clouds[2500]
    epn_pts = {N: xyz, 2500: q2500, 1250: q2500[:, :1250].contiguous()}
    nbrs = []
    for i, spec in enumerate(specs):
        q, s = epn_pts[spec["n_out"]], epn_pts[spec["n_in"]]
        r, ns = spec["radius"], spec["n_neighbor"]
        nbr = bq.ball_query_cuda(q, s, r, ns)
        if not torch.equal(nbr, bq.ball_query_torch(q, s, r, ns)):
            raise AssertionError(f"ball_query conv{i}: kernel and plain indices differ")
        Q, S = q.shape[1], s.shape[1]
        record("ball_query", f"B={B} {Q}x{S} r={r:.3f} ns={ns}", 0.0,
               lambda: bq.ball_query_cuda(q, s, r, ns), 5,
               cuda_ms(torch, lambda: bq.ball_query_torch(q, s, r, ns), 2),
               bound(B * (Q + S) * 12 + B * Q * ns * 4, 0.0, 8.0 * B * Q * S))
        nbrs.append(nbr)

    anchors = get_anchors(60)

    def rk_of(spec):
        kp = get_kernel_points(spec["radius"], spec["kernel_size"])
        rk = np.einsum("aij,kj->aki", anchors, kp).reshape(-1, 3)
        return torch.from_numpy(np.ascontiguousarray(rk)).to(dev)

    def check(kernel, label, out, ref, fn, plain_fn, bnd):
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= INTERCONV_RTOL * scale:
            raise AssertionError(f"{kernel} {label}: max abs err {err} > "
                                 f"{INTERCONV_RTOL} * {scale}")
        record(kernel, label, err, fn, 5, cuda_ms(torch, plain_fn, 1), bnd)

    def check_bf16(kernel, label, fn, plain_fn, bnd, library_fn=None, exact_fn=None):
        out, ref = fn().float(), plain_fn().float()
        err = (out - ref).abs()
        worst, scale = err.max().item(), ref.abs().max().item()
        med = median_rel(err, ref)
        if exact_fn is None:
            if not (worst <= BF16_ATOL * scale and med <= BF16_MEDIAN_REL):
                raise AssertionError(f"{kernel} {label}: max abs err {worst} (limit "
                                     f"{BF16_ATOL} * {scale}), median rel err {med}")
        else:   # as accurate as the plain twin, against the unrounded function
            got, twin, ok = as_accurate(out, ref, exact_fn().float())
            print(f"  {kernel} {label}: against the unrounded function median rel / max abs: "
                  f"kernel {got[0]:.3g} / {got[1]:.3g}, plain {twin[0]:.3g} / {twin[1]:.3g}; "
                  f"kernel against plain {med:.3g} / {worst:.3g}")
            if not ok:
                raise AssertionError(f"{kernel} {label}: less accurate than its plain twin")
        del out, ref, err
        library_ms = None if library_fn is None else cuda_ms(torch, library_fn, 5)
        record(kernel, label, worst, fn, 5, cuda_ms(torch, plain_fn, 1), bnd, library_ms)

    # occupancy conv of conv0: the 512-center chunks of the 2500 FPS centers
    # and the ragged last one
    conv0 = specs[0]
    rk, sg, ns = rk_of(conv0), conv0["sigma"], conv0["n_neighbor"]
    for c in chunks(conv0["n_out"]):
        ctr, nbr = q2500[:, :c].contiguous(), nbrs[0][:, :c].contiguous()
        check("interconv_ones", f"B={B} P={N} c={c} nn={ns}",
              interconv.interconv_ones_cuda(xyz, ctr, nbr, rk, sg, 60),
              interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sg, 60),
              lambda: interconv.interconv_ones_cuda(xyz, ctr, nbr, rk, sg, 60),
              lambda: interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sg, 60),
              bound(B * N * 12 + B * c * 12 + B * c * ns * 4 + 1440 * 12 + B * c * 1440 * 4,
                    0.0, (WEIGHT_FLOP + 1.0) * B * c * ns * 1440))

    # contraction on f32 rows: conv1 (C=32, centers of 2500), conv2 (C=32,
    # the first 1250 of 2500: lazy sampling) and conv3 (C=64, 1250), each in
    # 512-center chunks and a ragged last one
    gen = torch.Generator(device=dev).manual_seed(0)
    for spec in specs[1:]:
        C, pts, nn = spec["dim_in"], epn_pts[spec["n_in"]], spec["n_neighbor"]
        P = pts.shape[1]
        feats = torch.randn((B, P, 60 * C), device=dev, generator=gen)
        nbr_all = bq.ball_query_cuda(epn_pts[spec["n_out"]], pts, spec["radius"], nn)
        rk, sg = rk_of(spec), spec["sigma"]
        for c in chunks(spec["n_out"]):
            ctr = pts[:, :c].contiguous()          # lazy sampling: the first points
            nbr = nbr_all[:, :c].contiguous()
            check("interconv_t", f"B={B} P={P} c={c} of {spec['n_out']} nn={nn} C={C}",
                  interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
                  interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
                  lambda: interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
                  lambda: interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
                  interconv_bound(B, P, c, nn, 60, 24, C, 4))
        del feats
    torch.cuda.empty_cache()
    for spec in wide_specs(N):   # repaired: the 128- and 256-channel blocks
        C, nn, c = spec["dim_in"], spec["n_neighbor"], min(512, spec["n_out"])
        pts = wide_points(torch, dev, spec)
        feats = torch.randn((B, spec["n_in"], 60 * C), device=dev, generator=gen)
        nbr = bq.ball_query_cuda(pts[:, :c].contiguous(), pts, spec["radius"], nn)
        ctr, rk, sg = pts[:, :c].contiguous(), rk_of(spec), spec["sigma"]
        check("interconv_t", f"B={B} P={spec['n_in']} c={c} nn={nn} C={C} (layers 4)",
              interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
              interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
              lambda: interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
              lambda: interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
              interconv_bound(B, spec["n_in"], c, nn, 60, 24, C, 4))
        del feats
    torch.cuda.empty_cache()

    def c1_bound(nn, elem):
        """C == 1 body at conv1's geometry: 512 of 2500 centers."""
        bytes_ = (B * 2500 * 3 + B * 512 * 3 + 1440 * 3) * 4 + B * 512 * nn * 4 + \
            (B * 2500 * 60 + B * 512 * 1440) * elem
        return bound(bytes_, 0.0, (WEIGHT_FLOP + 2.0) * B * 512 * nn * 1440)

    # contraction on 1-channel rows (an EPN schedule whose conv1 has C=1), at
    # conv1's geometry
    conv1 = specs[1]
    feats = torch.randn((B, q2500.shape[1], 60), device=dev, generator=gen)
    ctr = q2500[:, :512].contiguous()
    nbr = bq.ball_query_cuda(ctr, q2500, conv1["radius"], conv1["n_neighbor"])
    rk, sg = rk_of(conv1), conv1["sigma"]
    check("interconv_t_c1", f"B={B} P=2500 c=512 nn={conv1['n_neighbor']} C=1 f32",
          interconv.interconv_t_c1_cuda(q2500, ctr, nbr, feats, rk, sg, 60),
          interconv.interconv_t_c1_torch(q2500, ctr, nbr, feats, rk, sg, 60),
          lambda: interconv.interconv_t_c1_cuda(q2500, ctr, nbr, feats, rk, sg, 60),
          lambda: interconv.interconv_t_c1_torch(q2500, ctr, nbr, feats, rk, sg, 60),
          c1_bound(conv1["n_neighbor"], 4))
    del feats
    torch.cuda.empty_cache()
    compare_bf16_kernels(torch, dev, xyz, clouds, epn_pts, specs, nbrs[0], rk_of, check_bf16,
                         c1_bound)
    torch.cuda.empty_cache()
    return results


def compare_bf16_kernels(torch, dev, xyz, clouds, epn_pts, specs, nbr0, rk_of, check,
                         c1_bound):
    """Phase 3, the bf16 path's kernels at its main-path shapes, on random
    weights of the reference widths."""
    from etch_tpu_torch.nn import attention, dircore, grouped_head, interconv, vector_attention
    from etch_tpu_torch.nn.point_transformer import unet_geometry
    from etch_tpu_torch.ops import ball_query

    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    q2500 = clouds[2500]

    def randn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=gen) * scale

    # occupancy conv of conv0 with its (K=24 -> 32) projection
    conv0 = specs[0]
    rk, sg, ns = rk_of(conv0), conv0["sigma"], conv0["n_neighbor"]
    w = randn(24, conv0["dim_out"], scale=(6 / (24 + conv0["dim_out"])) ** 0.5)
    Co = w.shape[1]
    for c in chunks(conv0["n_out"]):
        ctr, nbr = q2500[:, :c].contiguous(), nbr0[:, :c].contiguous()
        check("interconv_ones_proj", f"B={B} P={N} c={c} nn={ns} Co={Co}",
              lambda: interconv.interconv_ones_proj_cuda(xyz, ctr, nbr, rk, sg, 60, w),
              lambda: interconv.interconv_ones_proj_torch(xyz, ctr, nbr, rk, sg, 60, w),
              bound(B * N * 12 + B * c * 12 + B * c * ns * 4 + 1440 * 12 + B * c * 60 * Co * 2,
                    0.0, (WEIGHT_FLOP + 1.0) * B * c * ns * 1440 + 2.0 * B * c * 1440 * Co))

    # contraction on bf16 feature rows: conv1, conv2 and conv3 as for f32 rows
    for spec in specs[1:]:
        C, pts, nn = spec["dim_in"], epn_pts[spec["n_in"]], spec["n_neighbor"]
        P = pts.shape[1]
        feats = randn(B, P, 60 * C).to(bf)
        nbr_all = ball_query(epn_pts[spec["n_out"]], pts, spec["radius"], nn)
        rk, sg = rk_of(spec), spec["sigma"]
        for c in chunks(spec["n_out"]):
            ctr, nbr = pts[:, :c].contiguous(), nbr_all[:, :c].contiguous()
            check("interconv_t_bf16", f"B={B} P={P} c={c} of {spec['n_out']} nn={nn} C={C}",
                  lambda: interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
                  lambda: interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
                  interconv_bound(B, P, c, nn, 60, 24, C, 2))
        del feats
    for spec in wide_specs(N):   # repaired: the 128- and 256-channel blocks
        C, nn, c = spec["dim_in"], spec["n_neighbor"], min(512, spec["n_out"])
        pts = wide_points(torch, dev, spec)
        feats = randn(B, spec["n_in"], 60 * C).to(bf)
        ctr = pts[:, :c].contiguous()
        nbr = ball_query(ctr, pts, spec["radius"], nn)
        rk, sg = rk_of(spec), spec["sigma"]
        check("interconv_t_bf16", f"B={B} P={spec['n_in']} c={c} nn={nn} C={C} (layers 4)",
              lambda: interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
              lambda: interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
              interconv_bound(B, spec["n_in"], c, nn, 60, 24, C, 2))
        del feats
    spec = specs[1]
    feats = randn(B, q2500.shape[1], 60).to(bf)
    ctr = q2500[:, :512].contiguous()
    nbr = ball_query(ctr, q2500, spec["radius"], spec["n_neighbor"])
    rk, sg = rk_of(spec), spec["sigma"]
    check("interconv_t_c1", f"B={B} P=2500 c=512 nn={spec['n_neighbor']} C=1 bf16",
          lambda: interconv.interconv_t_c1_cuda(q2500, ctr, nbr, feats, rk, sg, 60),
          lambda: interconv.interconv_t_c1_torch(q2500, ctr, nbr, feats, rk, sg, 60),
          c1_bound(spec["n_neighbor"], 2))
    del feats

    # direction core: every point's (60, E) tokens, 8 heads, V=128: E = 64
    # (the main path), then the repaired E = 128 and 256 (epn_layer_num 3, 4)
    V, H = 128, 8
    for E in (64, 128, 256):
        params = {}
        for l in (0, 1):
            for nm in ("wq", "wk", "wv"):
                params[f"{nm}{l}"] = randn(E, E, scale=E ** -0.5)
        params.update(wc0=randn(E, E, scale=E ** -0.5), bc0=randn(E, scale=0.1),
                      wc1=randn(E, V, scale=E ** -0.5), bc1=randn(V, scale=0.1),
                      wm0=randn(V, V, scale=V ** -0.5), bm0=randn(V, scale=0.1),
                      wm1=randn(V, V, scale=V ** -0.5), bm1=randn(V, scale=0.1),
                      wr=randn(V, 1, scale=V ** -0.5), br=randn(1, scale=0.1))
        tokens = randn(B * N, 60, E).to(bf)
        M, A = B * N, 60
        flop = (2.0 * M * A * (2 * 3 * E * E + E * E + E * V + 2 * V * V + V)
                + 4.0 * 2 * M * A * A * E)
        plain = (lambda t: torch.cat([dircore.direction_core_torch(t[s:s + 2048], params, H)
                                      for s in range(0, B * N, 2048)]))
        check("dircore", f"M={M} A={A} E={E} H={H} V={V}",
              lambda: dircore.direction_core_cuda(tokens, params, H), lambda: plain(tokens),
              bound(M * A * E * 2 + M * A * 4, flop),
              exact_fn=(lambda: plain(tokens.float())) if E > 128 else None)
        del tokens
    E = 64

    # anchor attention of the chunked core: the 2048-point chunks of a
    # direction layer and its ragged last one, two layers, 8 heads (its
    # library yardstick: scaled_dot_product_attention on the same q, k, v as
    # (Bc * H, 60, hs), q already scaled)
    L, hs = 60, E // H
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for Bc in chunks(B * N, 2048):
        q, k, v = (randn(Bc, L, E, scale=hs ** -0.5 if i == 0 else 1.0).to(bf) for i in range(3))
        qh, kh, vh = (t.reshape(Bc, L, H, hs).transpose(1, 2).reshape(Bc * H, L, hs).contiguous()
                      for t in (q, k, v))
        check("attention", f"Bc={Bc} L={L} E={E} H={H}",
              lambda: attention.attention_cuda(q, k, v, H),
              lambda: attention.attention_torch(q, k, v, H),
              bound(3 * Bc * L * E * 2 + Bc * L * E * 4, 4.0 * Bc * L * L * E),
              library_fn=lambda: sdpa(qh, kh, vh, scale=1.0))
        del q, k, v, qh, kh, vh
    # repaired: the chunked core's attention at E = 256 (two head groups)
    E2, Bc = 256, 2048
    hs2 = E2 // H
    q, k, v = (randn(Bc, L, E2, scale=hs2 ** -0.5 if i == 0 else 1.0).to(bf) for i in range(3))
    qh, kh, vh = (t.reshape(Bc, L, H, hs2).transpose(1, 2).reshape(Bc * H, L, hs2).contiguous()
                  for t in (q, k, v))
    check("attention", f"Bc={Bc} L={L} E={E2} H={H}",
          lambda: attention.attention_cuda(q, k, v, H),
          lambda: attention.attention_torch(q, k, v, H),
          bound(3 * Bc * L * E2 * 2 + Bc * L * E2 * 4, 4.0 * Bc * L * L * E2),
          library_fn=lambda: sdpa(qh, kh, vh, scale=1.0))
    del q, k, v, qh, kh, vh

    # vector attention at each U-Net level's shape and width (magnitude
    # planes 64, 128, 256, 256, 512; confidence 128 at level 0)
    xyz5 = xyz.contiguous()
    geom = unet_geometry(xyz5, (1, 4, 4, 4, 4), (8, 16, 16, 16, 16))
    for lvl, c in ((0, 64), (0, 128), (1, 128), (2, 256), (3, 256), (4, 512)):
        idx = geom[lvl]["self"]
        Bl, Nl, nsl = idx.shape
        cs = c // 8
        args = (randn(Bl * Nl, c).to(bf), randn(Bl, Nl, c).to(bf), randn(Bl, Nl, c).to(bf),
                idx, randn(Bl * Nl, nsl, c).to(bf),
                torch.stack([randn(c).abs() + 0.5, randn(c)]), randn(c, cs, scale=c ** -0.5),
                torch.stack([randn(cs).abs() + 0.5, randn(cs)]),
                randn(cs, cs, scale=cs ** -0.5), randn(cs))
        R = Bl * Nl
        check("vector_attention", f"R={R} ns={nsl} c={c}",
              lambda: vector_attention.vector_attention_cuda(*args),
              lambda: vector_attention.vector_attention_torch(*args),
              bound(R * c * 2 * 3 + R * nsl * (4 + c * 2) + R * c * 4,
                    2.0 * R * nsl * (c * cs + cs * cs), R * nsl * (8.0 * c + 6.0 * cs)))

    # grouped confidence head: c0=128, k=86 parts
    c0, k = 128, 86
    gargs = (randn(B * N, c0).to(bf), randn(c0, k * c0, scale=c0 ** -0.5),
             randn(k * c0, scale=0.1), randn(k, c0, scale=(6 / (k + c0)) ** 0.5),
             randn(k, scale=0.1))
    R = B * N
    check("grouped_head", f"R={R} c0={c0} k={k}",
          lambda: grouped_head.grouped_head_cuda(*gargs),
          lambda: grouped_head.grouped_head_torch(*gargs),
          bound(R * c0 * 2 + c0 * k * c0 * 2 + R * k * 4, 2.0 * R * c0 * k * c0,
                4.0 * R * k * c0))


SMALL_STEPS = (  # phase 4: (label, EtchConfig.tiny overrides, kernel set on the card)
    ("f32", {}, "f32"),
    ("bf16, 2 direction layers", dict(use_bfloat16=True, dir_num_layers=2), "bf16"),
    ("bf16, 1 direction layer", dict(use_bfloat16=True), "bf16_chunked"),
    ("f32, 1-channel conv", dict(epn_mlps=C1_MLPS), "f32_c1"),
    ("bf16, 1-channel conv", dict(use_bfloat16=True, epn_mlps=C1_MLPS), "bf16_chunked_c1"),
)
DEEP_STEPS = (  # phase 4 at full width, EtchConfig(epn_layer_num=4) at N=1024, B=2: the
    # 128- and 256-channel blocks (channel slices) and the E = 256 direction core
    ("f32, epn_layer_num=4", dict(epn_layer_num=4), "f32"),
    ("bf16, epn_layer_num=4", dict(epn_layer_num=4, use_bfloat16=True), "bf16"),
)


def small_step(torch, _build, label, cfg, path, fused_core=True, full_width=False):
    """Phase 4: the serving step of `cfg` (tiny widths at B=2, N=512, or the
    deeper EPN schedules at full width), kernels on the card against the same
    weights on the CPU (plain versions); `fused_core=False` takes the
    chunked direction core.  Returns the card run's launch counts, which
    must be exactly the path's kernel set.

    f32: equal part labels, confidences within 1e-4 * (1 + max), markers
    within 1e-3, vectors and inner points within 1e-4 * (1 + max) for 99% of
    the values and 1e-2 for all (the direction head's chordal mean is
    ill-conditioned at random weights).  bf16: rounding to bf16 at the same
    points in another summation order flips a rounding now and then, and the
    flips travel through the network: part labels equal for 98% of the
    points, confidences and vector lengths (magnitude / 10, as directions
    are ill-conditioned) within a median relative error of 1e-2 and
    2e-2 * (1 + max) for all, finite outputs.  bf16 at `full_width`: there
    the flips alone move the card's plain versions further from the CPU than
    that, so the card's step is held to be as accurate as the CPU's against
    the same weights served in f32 on the CPU: confidences and vector
    lengths within AS_ACCURATE_STEP times the CPU bf16 step's error, median
    relative and max, and part labels off the f32 ones on at most
    max(AS_ACCURATE_STEP times the CPU's share, 2%) of the points."""
    from etch_tpu_torch.pipeline import build_pipeline

    def serve(config, device):
        pipe = build_pipeline(config, MARKERSET, allow_synthetic_body=True, rng_seed=0,
                              device=device)
        pipe.model.direction_head.fused_core = fused_core
        return pipe.run_batch(pts)

    pts = capsule_clouds(cfg.batch_size, cfg.num_point, seed=3)
    _build.reset_launch_counts()
    gpu = serve(cfg, "cuda")
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    ran = {k for k, v in launches.items() if v}
    if ran != set(PATH_KERNELS[path]):
        raise AssertionError(f"small reference {label}: kernels launched {sorted(ran)}, "
                             f"expected {sorted(PATH_KERNELS[path])}")
    cpu = serve(cfg, "cpu")
    for key in ("vectors", "inner_points", "confidences", "markers", "verts", "joints"):
        if not torch.isfinite(gpu[key]).all():
            raise AssertionError(f"small reference {label}: {key} not finite")
    if cfg.use_bfloat16 and full_width:
        report, ok = bf16_step_accuracy(gpu, cpu, serve(cfg.replace(use_bfloat16=False), "cpu"))
        if not ok:
            raise AssertionError(f"small reference {label}: less accurate than the CPU's "
                                 f"bf16 step: {report}")
    elif cfg.use_bfloat16:
        agree = (gpu["part_labels"].cpu() == cpu["part_labels"]).float().mean().item()
        report = {"part_label_agreement": agree}
        for key, a, b in (("confidences", gpu["confidences"].cpu(), cpu["confidences"]),
                          ("vector_length", gpu["vectors"].cpu().norm(dim=-1),
                           cpu["vectors"].norm(dim=-1))):
            err = (a - b).abs()
            med = (err / (b.abs() + 1e-2)).median().item()
            report[key] = {"median_rel": med, "max_abs": err.max().item()}
            if not (med <= 1e-2 and err.max().item() <= 2e-2 * (1 + b.abs().max().item())):
                raise AssertionError(f"small reference {label}: {key} {report[key]}")
        if agree < 0.98:
            raise AssertionError(f"small reference {label}: part labels agree on {agree:.4f}")
    else:
        if not torch.equal(gpu["part_labels"].cpu(), cpu["part_labels"]):
            raise AssertionError(f"small reference {label}: part labels differ")
        report = {}
        for key in ("vectors", "inner_points", "confidences", "markers"):
            err = (gpu[key].cpu() - cpu[key]).abs()
            bound = 1e-4 * (1 + cpu[key].abs().max().item())
            report[key] = err.max().item()
            if key in ("vectors", "inner_points"):
                ok = err.flatten().quantile(0.99).item() <= bound and report[key] <= 1e-2
            else:
                ok = report[key] <= (1e-3 if key == "markers" else bound)
            if not ok:
                raise AssertionError(f"small reference {label}: {key} differs by {report[key]}")
    print(f"small reference {label} (B={cfg.batch_size}, N={cfg.num_point}), card vs CPU"
          f"{' (bf16 steps against the f32 one)' if cfg.use_bfloat16 and full_width else ''}: "
          f"{json.dumps(report)}; launches {json.dumps({k: v for k, v in launches.items() if v})}")
    return launches


def run_requests(torch, pipe, pts, n):
    times = []
    out = None
    for _ in range(n):
        t0 = time.perf_counter()
        out = pipe.run_batch(pts)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def stage_times(torch, pipe, pts, reps=TIMED_REQUESTS):
    """Device time of the network's stages, the median of `reps` run_batch
    calls (CUDA events recorded by forward hooks on each head and the
    encoder; "forward" is the whole network, "rest" the run_batch time
    outside it: markers, LM fit, SMPL forward).  A stage's events also
    count the host's gaps between its launches, so one request alone
    moves with the host."""
    model = pipe.model
    events, hooks, runs = {}, [], []
    for name in ("encoder", "confidence_encoder", "direction_head", "magnitude_encoder", ""):
        mod = model.get_submodule(name) if name else model
        label = name or "forward"

        def pre(_m, _i, label=label):
            events[label] = [torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True)]
            events[label][0].record()

        def post(_m, _i, _o, label=label):
            events[label][1].record()

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    for _ in range(reps):
        t0 = time.perf_counter()
        pipe.run_batch(pts)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
        ms = {k: a.elapsed_time(b) for k, (a, b) in events.items()}
        ms["rest"] = total - ms["forward"]
        runs.append(ms)
    for h in hooks:
        h.remove()
    return {k: round(statistics.median(r[k] for r in runs), 2) for k in runs[0]}


def main_path(torch, _build, path, latency=True):
    """Phase 5 for one serving path ("bf16", "bf16_chunked" or "f32"):
    returns (launch counts of its timed requests, the same per kernel and
    shape, its stage times)."""
    from etch_tpu_torch.pipeline import build_pipeline
    from etch_tpu_torch.utils.config import EtchConfig

    bf16 = path != "f32"
    t0 = time.perf_counter()
    pipe = build_pipeline(EtchConfig(num_point=N, batch_size=B, use_bfloat16=bf16),
                          MARKERSET, allow_synthetic_body=True, rng_seed=0, device="cuda")
    pipe.model.direction_head.fused_core = path != "bf16_chunked"
    # vector-attention layers per request: two U-Nets whose level l runs
    # blocks[l] - 1 encoder blocks and one decoder block (36 at full depth);
    # anchor attentions per request on the chunked route: one per direction
    # layer and chunk of dir_chunk points (2 x 20 at full width)
    va_layers = 2 * sum(pipe.cfg.unet_blocks)
    attn_calls = pipe.cfg.dir_num_layers * -(-B * N // pipe.cfg.dir_chunk)
    pts = capsule_clouds(B, N)
    print(f"build_pipeline {path}: {time.perf_counter() - t0:.1f} s")
    _, warm = run_requests(torch, pipe, pts, 1)
    stages = stage_times(torch, pipe, pts)
    print(f"stage ms B={B} {path}: {json.dumps(stages)}")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out, times = run_requests(torch, pipe, pts, TIMED_REQUESTS)
    launches = dict(_build.launches)
    shapes = {k: dict(v) for k, v in _build.shape_launches.items()}
    print(f"launches during {TIMED_REQUESTS} {path} requests: {json.dumps(launches)}")
    ran = {k for k, v in launches.items() if v}
    if ran != set(PATH_KERNELS[path]):
        raise AssertionError(f"{path} main path: kernels launched {sorted(ran)}, "
                             f"expected {sorted(PATH_KERNELS[path])}")
    if bf16 and launches["vector_attention"] != va_layers * TIMED_REQUESTS:
        raise AssertionError(f"vector_attention launched {launches['vector_attention']} "
                             f"times in {TIMED_REQUESTS} requests")
    if launches["attention"] != (attn_calls * TIMED_REQUESTS if "attention" in ran else 0):
        raise AssertionError(f"attention launched {launches['attention']} times in "
                             f"{TIMED_REQUESTS} requests")
    expected = {"vectors": (B, N, 3), "inner_points": (B, N, 3), "part_labels": (B, N),
                "confidences": (B, N, 1), "markers": (B, 86, 3), "markers_valid": (B, 86),
                "verts": (B, 6890, 3), "joints": (B, 45, 3)}
    for key, shape in expected.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)} != {shape}")
    for key in ("vectors", "confidences", "markers", "verts", "joints"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"{path} {key}: non-finite values")
    med = statistics.median(times)
    print(f"run_batch B={B} N={N} {path}: warm {warm[0]:.1f} ms, timed ms "
          f"{[round(t, 2) for t in times]}, median {med:.2f} ms/batch, "
          f"{B * 1e3 / med:.2f} scans/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del pipe, out
    torch.cuda.empty_cache()

    if latency:
        pipe1 = build_pipeline(EtchConfig(num_point=N, batch_size=1, use_bfloat16=bf16),
                               MARKERSET, allow_synthetic_body=True, rng_seed=0,
                               device="cuda")
        run_requests(torch, pipe1, pts[:1], 1)
        _, times1 = run_requests(torch, pipe1, pts[:1], TIMED_REQUESTS)
        print(f"run_batch B=1 {path} latency: ms {[round(t, 2) for t in times1]}, median "
              f"{statistics.median(times1):.2f} ms")
    return launches, shapes, stages


def per_shape_launches(kernels, counted, counted_on):
    """Each timed shape's launches a request, from `counted` ({kernel: {shape
    key: launches}} of the timed requests of path `counted_on[kernel]`), and
    its gap (launches x (time - bound)); a kernel's gap is the sum over its
    shapes.  Raises where a path launched a kernel at a shape that phase 3
    did not time."""
    for name, k in kernels.items():
        if name not in counted:   # the C == 1 body runs on no full-width path
            k["gap_ms"] = k["graph_gap_ms"] = None
            for e in k["shapes"]:
                e["launches_per_request"] = e["gap_ms"] = e["graph_gap_ms"] = None
            continue
        untimed = set(counted[name]) - {e["key"] for e in k["shapes"]}
        if untimed:
            raise AssertionError(f"{name}: the {counted_on[name]} path launched it at shapes "
                                 f"phase 3 did not time: {sorted(untimed)}")
        for e in k["shapes"]:
            e["launches_per_request"] = counted[name].get(e["key"], 0) / TIMED_REQUESTS
            e["gap_ms"] = e["launches_per_request"] * (e["ms"] - e["bound_ms"])
            e["graph_gap_ms"] = e["launches_per_request"] * (e["graph_ms"] - e["bound_ms"])
            print(f"  {name:19s} {e['shape']:34s} x{e['launches_per_request']:g}/request "
                  f"({counted_on[name]}), gap {e['gap_ms']:.3f} ms (graph {e['graph_gap_ms']:.3f})")
        k["gap_ms"] = sum(e["gap_ms"] for e in k["shapes"])
        k["graph_gap_ms"] = sum(e["graph_gap_ms"] for e in k["shapes"])


def entry_point(torch, _build):
    """Phase 6: the single-scan CLI on the repository's scan (f32, B=1,
    N=5000, random weights, synthetic body) into a temporary directory, then
    the latency of `run_scan` on a built pipeline.  Returns the CLI run's
    launch counts."""
    from etch_tpu_torch.cli import infer
    from etch_tpu_torch.data.mesh import load_obj
    from etch_tpu_torch.pipeline import build_pipeline, load_markerset
    from etch_tpu_torch.utils.config import EtchConfig

    root = os.path.dirname(os.path.abspath(__file__))
    scan, markerset = os.path.join(root, SCAN), os.path.join(root, MARKERSET_PATH)
    with tempfile.TemporaryDirectory() as tmp:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        obj, npz = infer.main(["--scan_path", scan, "--markerset_path", markerset,
                               "--allow_synthetic_body", "--device", "cuda",
                               "--output_folder", tmp])
        cli_s = time.perf_counter() - t0
        launches = dict(_build.launches)
        ran = {k for k, v in launches.items() if v}
        if ran != set(PATH_KERNELS["f32"]):
            raise AssertionError(f"cli/infer: kernels launched {sorted(ran)}")
        stem = os.path.splitext(os.path.basename(SCAN))[0]
        if (os.path.basename(obj), os.path.basename(npz)) != (
                f"{stem}_pred_smpl.obj", f"{stem}_output_smpl_info.npz"):
            raise AssertionError(f"cli/infer wrote {obj}, {npz}")
        info = np.load(npz)
        shapes = {k: info[k].shape for k in info.files}
        if shapes != NPZ_SHAPES or not all(np.isfinite(info[k]).all() for k in info.files):
            raise AssertionError(f"cli/infer npz: {shapes}")
        verts = load_obj(obj).vertices
        if verts.shape != (6890, 3) or not np.isfinite(verts).all():
            raise AssertionError(f"cli/infer obj: vertices {verts.shape}")
    print(f"cli/infer (B=1, N={N}, f32, first call in its process): {cli_s:.2f} s, wrote "
          f"{os.path.basename(obj)} and {os.path.basename(npz)}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}")

    pipe = build_pipeline(EtchConfig(num_point=N), load_markerset(markerset),
                          allow_synthetic_body=True, device="cuda")
    pipe.run_scan(scan, seed=0)
    times, load = [], []
    for _ in range(TIMED_REQUESTS):
        t0 = time.perf_counter()
        load_obj(scan)
        load.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        pipe.run_scan(scan, seed=0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"run_scan B=1 N={N} f32 latency: ms {[round(t, 2) for t in times]}, median "
          f"{statistics.median(times):.2f} ms (of which the OBJ parse alone: median "
          f"{statistics.median(load):.2f} ms)")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from etch_tpu_torch import _build

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")
    log = _build.library_path().parent / "nvcc.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())

    # 3. kernel vs plain at main-path shapes
    print("kernel vs plain PyTorch on the card:")
    kernels = compare_kernels(torch, dev)

    # 4. small-input reference; the 1-channel body runs only here (one
    # request per step)
    from etch_tpu_torch.utils.config import EtchConfig
    launches, per_request = {}, {}
    c1_steps = [s for s in SMALL_STEPS if s[2].endswith("_c1")]
    for label, overrides, path in SMALL_STEPS:
        counts = small_step(torch, _build, label,
                            EtchConfig.tiny(num_point=512, batch_size=2, **overrides), path)
        if path.endswith("_c1"):
            launches["interconv_t_c1"] = launches.get("interconv_t_c1", 0) + counts[
                "interconv_t_c1"]
    per_request["interconv_t_c1"] = (launches["interconv_t_c1"] / len(c1_steps),
                                     "tiny 1-channel steps")
    for label, overrides, path in DEEP_STEPS:
        small_step(torch, _build, label, EtchConfig(num_point=1024, batch_size=2, **overrides),
                   path, full_width=True)

    # 5. main paths at full width: bf16 (what bench.py times), bf16 with the
    # chunked direction core, then f32; each kernel's counts from the first
    # path that runs it
    stages, counted, counted_on = {}, {}, {}
    for path in ("bf16", "bf16_chunked", "f32"):
        counts, shapes, stages[path] = main_path(torch, _build, path,
                                                 latency=path != "bf16_chunked")
        for k in PATH_KERNELS[path]:
            if k not in launches:
                launches[k] = counts[k]
                per_request[k] = (counts[k] / TIMED_REQUESTS, path)
                counted[k], counted_on[k] = shapes[k], path
    print(f"direction head ms B={B}: fused {stages['bf16']['direction_head']}, chunked "
          f"{stages['bf16_chunked']['direction_head']}; forward fused "
          f"{stages['bf16']['forward']}, chunked {stages['bf16_chunked']['forward']}")

    # 6. the single-scan entry point
    entry_point(torch, _build)

    idle = [name for name in SOURCES if not launches.get(name)]
    if idle:
        raise AssertionError(f"kernels never launched on a path: {idle}")
    print("launches a request at each timed shape, counted on the main paths:")
    per_shape_launches(kernels, counted, counted_on)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"etch_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name],
         "launches_per_request": per_request[name][0], "launch_path": per_request[name][1],
         **kernels[name]}
        for name, (src, replaces) in SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
