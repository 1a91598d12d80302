#!/usr/bin/env python3
"""Quickest proof that the PyTorch port's serving step runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and nvcc (the kernels under etch_tpu_torch/csrc are
built at first use).  Phases, each of which raises on failure:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc the kernels, print the build time and ptxas register use;
  3. kernel vs plain PyTorch version on the card, at the shapes of the main
     path: FPS, kNN and ball-query indices must be equal, the inter-conv
     contraction and occupancy conv within 1e-5 * max|t| (f32 sums in
     another order); kernel and plain times side by side;
  4. small-input reference: the serving step at tiny widths on the card
     (kernels) against the same weights on the CPU (plain versions): equal
     part labels, confidences within 1e-4 * (1 + max), markers within 1e-3,
     vectors and inner points within 1e-4 * (1 + max) for 99% of the values
     and 1e-2 for all (the direction head's chordal mean is ill-conditioned
     at random weights);
  5. main path: `build_pipeline(EtchConfig(num_point=5000, batch_size=8))`
     with random weights and the synthetic body, `run_batch` on capsule
     clouds: one warm request, then timed requests; every kernel's launch
     counter must rise during them; then a B=1 request's latency.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the etch_tpu_torch package beside it, the script exits non-zero
before printing either.
"""

import importlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

B, N = 8, 5000
TIMED_REQUESTS = 3
MARKERSET = {f"M{i}": int(v) for i, v in enumerate(np.linspace(0, 6889, 86).astype(int))}
INTERCONV_RTOL = 1e-5   # max |kernel - plain| <= 1e-5 * max |plain|


def capsule_clouds(batch, n, seed=0):
    """Human-scan-like clouds: points on a scaled vertical capsule (bench.py)."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(-0.9, 0.9, (batch, n))
    th = rng.uniform(0, 2 * np.pi, (batch, n))
    r = 0.15 + 0.03 * np.cos(3 * z)
    return np.stack([r * np.cos(th), r * np.sin(th), z], axis=-1).astype(np.float32)


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


def compare_kernels(torch, dev):
    """Phase 3: every kernel against its plain version at main-path shapes.
    Returns {kernel: {"max_abs_err", "ms", "plain_ms"}} for the first
    (headline) shape of each kernel; prints every shape."""
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

    def record(kernel, shape, err, ms, plain_ms):
        print(f"  {kernel:15s} {shape:34s} max_abs_err {err:.3g}  kernel {ms:.3f} ms"
              f"  plain {plain_ms:.3f} ms")
        prev = results.get(kernel)
        if prev is None:
            results[kernel] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)

    xyz = torch.from_numpy(capsule_clouds(B, N, seed=1)).to(dev)

    centers = {}
    for m in (2500, 1250):
        out = fp.fps_cuda(xyz, m)
        ref = fp.fps_torch(xyz, m)
        if not torch.equal(out, ref):
            raise AssertionError(f"fps {N}->{m}: kernel and plain indices differ")
        record("fps", f"B={B} {N}->{m}", 0.0,
               cuda_ms(torch, lambda: fp.fps_cuda(xyz, m), 5),
               cuda_ms(torch, lambda: fp.fps_torch(xyz, m), 1))
        centers[m] = gather_points(xyz, out).contiguous()

    for k, q, s, label in ((8, xyz, xyz, f"k=8 {N}x{N}"),
                           (16, centers[1250], xyz, f"k=16 1250x{N}"),
                           (3, xyz, centers[1250], f"k=3 {N}x1250")):
        idx, d2 = kn.knn_cuda(q, s, k)
        ridx, rd2 = kn.knn_torch(q, s, k)
        if not torch.equal(idx, ridx):
            raise AssertionError(f"knn {label}: kernel and plain indices differ")
        err = (d2 - rd2).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"knn {label}: squared distances differ by {err}")
        record("knn", f"B={B} {label}", err,
               cuda_ms(torch, lambda: kn.knn_cuda(q, s, k), 5),
               cuda_ms(torch, lambda: kn.knn_torch(q, s, k), 2))

    plan = backbone_plan(EtchConfig(num_point=N, batch_size=B))
    conv0, conv1, conv3 = plan[0][0], plan[0][1], plan[1][1]
    q2500 = centers[2500]
    r0, ns = conv0["radius"], conv0["n_neighbor"]
    nbr0 = bq.ball_query_cuda(q2500, xyz, r0, ns)
    if not torch.equal(nbr0, bq.ball_query_torch(q2500, xyz, r0, ns)):
        raise AssertionError("ball_query: kernel and plain indices differ")
    record("ball_query", f"B={B} 2500x{N} r={r0:.3f} ns={ns}", 0.0,
           cuda_ms(torch, lambda: bq.ball_query_cuda(q2500, xyz, r0, ns), 5),
           cuda_ms(torch, lambda: bq.ball_query_torch(q2500, xyz, r0, ns), 2))

    anchors = get_anchors(60)

    def rk_of(spec):
        kp = get_kernel_points(spec["radius"], spec["kernel_size"])
        rk = np.einsum("aij,kj->aki", anchors, kp).reshape(-1, 3)
        return torch.from_numpy(np.ascontiguousarray(rk)).to(dev)

    def check(kernel, label, out, ref, fn, plain_fn):
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= INTERCONV_RTOL * scale:
            raise AssertionError(f"{kernel} {label}: max abs err {err} > "
                                 f"{INTERCONV_RTOL} * {scale}")
        record(kernel, label, err, cuda_ms(torch, fn, 5), cuda_ms(torch, plain_fn, 1))

    # occupancy conv of conv0: one 512-center chunk of the 2500 FPS centers
    ctr, nbr = q2500[:, :512].contiguous(), nbr0[:, :512].contiguous()
    rk, sg = rk_of(conv0), conv0["sigma"]
    check("interconv_ones", f"B={B} P={N} c=512 nn={ns}",
          interconv.interconv_ones_cuda(xyz, ctr, nbr, rk, sg, 60),
          interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sg, 60),
          lambda: interconv.interconv_ones_cuda(xyz, ctr, nbr, rk, sg, 60),
          lambda: interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sg, 60))

    gen = torch.Generator(device=dev).manual_seed(0)
    for spec, pts in ((conv1, q2500), (conv3, centers[1250])):
        C = spec["dim_in"]
        feats = torch.randn((B, pts.shape[1], 60 * C), device=dev, generator=gen)
        ctr = pts[:, :512].contiguous()          # lazy sampling: the first points
        nbr = bq.ball_query_cuda(ctr, pts, spec["radius"], spec["n_neighbor"])
        rk, sg = rk_of(spec), spec["sigma"]
        check("interconv_t", f"B={B} P={pts.shape[1]} c=512 nn={spec['n_neighbor']} C={C}",
              interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
              interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
              lambda: interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
              lambda: interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60))
        del feats
    torch.cuda.empty_cache()
    return results


def check_small_reference(torch):
    """Phase 4: tiny-width serving step, kernels on the card vs plain
    versions on the CPU, same weights and inputs."""
    from etch_tpu_torch.pipeline import build_pipeline
    from etch_tpu_torch.utils.config import EtchConfig

    cfg = EtchConfig.tiny(num_point=512, batch_size=2)
    pts = capsule_clouds(2, 512, seed=3)
    outs = [build_pipeline(cfg, MARKERSET, allow_synthetic_body=True, rng_seed=0,
                           device=d).run_batch(pts) for d in ("cuda", "cpu")]
    gpu, cpu = [{k: v for k, v in o.items() if k != "fit_params"} for o in outs]
    if not torch.equal(gpu["part_labels"].cpu(), cpu["part_labels"]):
        raise AssertionError("small reference: part labels differ")
    worst = {}
    for key in ("vectors", "inner_points", "confidences", "markers"):
        err = (gpu[key].cpu() - cpu[key]).abs()
        bound = 1e-4 * (1 + cpu[key].abs().max().item())
        worst[key] = err.max().item()
        if key in ("vectors", "inner_points"):
            # at random weights the chordal mean of the direction head nearly
            # cancels for some points, and its projection amplifies rounding
            ok = err.flatten().quantile(0.99).item() <= bound and worst[key] <= 1e-2
        else:
            ok = worst[key] <= (1e-3 if key == "markers" else bound)
        if not ok:
            raise AssertionError(f"small reference: {key} differs by {worst[key]}")
    print("small reference (B=2, N=512, tiny widths), card vs CPU max abs err:",
          json.dumps(worst))


def run_requests(torch, pipe, pts, n):
    times = []
    out = None
    for _ in range(n):
        t0 = time.perf_counter()
        out = pipe.run_batch(pts)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from etch_tpu_torch import _build
    from etch_tpu_torch.pipeline import build_pipeline
    from etch_tpu_torch.utils.config import EtchConfig

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

    # 4. small-input reference
    check_small_reference(torch)

    # 5. main path at full width
    t0 = time.perf_counter()
    pipe = build_pipeline(EtchConfig(num_point=N, batch_size=B), MARKERSET,
                          allow_synthetic_body=True, rng_seed=0, device="cuda")
    pts = capsule_clouds(B, N)
    print(f"build_pipeline: {time.perf_counter() - t0:.1f} s")
    _, warm = run_requests(torch, pipe, pts, 1)
    _build.reset_launch_counts()
    out, times = run_requests(torch, pipe, pts, TIMED_REQUESTS)
    launches = dict(_build.launches)
    print(f"launches during {TIMED_REQUESTS} requests: {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    shapes = {"vectors": (B, N, 3), "inner_points": (B, N, 3), "part_labels": (B, N),
              "confidences": (B, N, 1), "markers": (B, 86, 3), "markers_valid": (B, 86),
              "verts": (B, 6890, 3), "joints": (B, 45, 3)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key}: shape {tuple(out[key].shape)} != {shape}")
    for key in ("vectors", "confidences", "markers", "verts", "joints"):
        if not torch.isfinite(out[key]).all():
            raise AssertionError(f"{key}: non-finite values")
    med = statistics.median(times)
    print(f"run_batch B={B} N={N} f32: warm {warm[0]:.1f} ms, timed ms "
          f"{[round(t, 2) for t in times]}, median {med:.2f} ms/batch, "
          f"{B * 1e3 / med:.2f} scans/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    pipe1 = build_pipeline(EtchConfig(num_point=N, batch_size=1), MARKERSET,
                           allow_synthetic_body=True, rng_seed=0, device="cuda")
    run_requests(torch, pipe1, pts[:1], 1)
    _, times1 = run_requests(torch, pipe1, pts[:1], TIMED_REQUESTS)
    print(f"run_batch B=1 latency: ms {[round(t, 2) for t in times1]}, median "
          f"{statistics.median(times1):.2f} ms")

    sources = {"fps": ("fps.cu", "etch_tpu/ops/pallas_fps.py:71"),
               "knn": ("knn.cu", "etch_tpu/ops/pallas_knn.py:82"),
               "ball_query": ("knn.cu", "etch_tpu/ops/pallas_knn.py:169"),
               "interconv_ones": ("interconv.cu", "etch_tpu/nn/pallas_interconv.py:149"),
               "interconv_t": ("interconv.cu", "etch_tpu/nn/pallas_interconv.py:115")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"etch_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name], **kernels[name]}
        for name, (src, replaces) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
