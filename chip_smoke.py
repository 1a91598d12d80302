#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

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
     at each U-Net level; and, launched by no timed request, the widths
     repaired since: kNN at k = 48, the direction core at a head of 256, at
     E = 512 and at E = 1024 with one head, the attention at heads of 256
     and 512, the grouped head at c0 = 256, wider contraction rows, the bf16
     contraction at 66 kernel points, at 12 channels and at 262 neighbours,
     the vector attention at c = 1024; the fused instance norm of the EPN's
     conv outputs (with and without the skip sum) at B=8, at B=32 for the
     four published blocks (the benchmark's serving cells) and at B=1; then
     the f32 path's FPS, kNN, ball
     query, occupancy conv and contraction shapes again at B=1, where
     `cli/infer` and `cli/evaluate` launch them, and kNN at the fit's
     shapes of phase 10 (k=1 between the 6,890 body vertices and the
     5,000-point scan both ways, k=8 from the scan to the 6,888 face
     centroids); ball query's bound counts the pairs
     its index-order scan must visit for these inputs, `bound_mn_ms` all
     M x N; the C == 1 body's counts its expanded-form weights,
     `bound_direct_ms` the direct form's):
     FPS, kNN and ball-query indices must be equal,
     the f32 inter-conv contraction (3xTF32 on the tensor cores; C >= 4 and
     C == 1 rows) and occupancy conv within
     1e-5 * max|t| (f32 sums in another order); the bf16 kernels (contraction
     on bf16 rows, C >= 8 and C == 1, occupancy conv with its projection,
     direction core, anchor attention, vector attention, grouped head) within
     1e-2 * max|plain| at every element with a median relative error
     |diff| / (|plain| + 1e-2) <= 1e-3 (the same rounding points, another
     summation order); the fused instance norm's normalised value within
     one f32 ulp of its plain twin's at every element and its output equal
     at 99.9% of them (float64 statistics summed in another order), a
     constant channel exactly 0; kernel and plain times side by side with each
     kernel's bound (the larger of its bytes over 3.35 TB/s and its
     operations over 989 TFLOP/s of bf16 tensor work, 495 TFLOP/s of TF32
     for the f32 contraction's three passes, or 67 TFLOP/s of FP32, from
     the shapes: `bound`), and for the anchor attention the time of
     `scaled_dot_product_attention` on the same inputs (no other kernel has
     one PyTorch call that computes its function); beside the grouped head,
     the time of the bf16 product h @ W0 alone (`torch.matmul`, a yardstick
     the port never calls);
  4. small-input reference: the serving step at tiny widths on the card
     (kernels) against the same weights on the CPU (plain versions), in five
     variants (SMALL_STEPS): f32; bf16 with two direction layers (the fused
     direction core); bf16 with the tiny config's one layer (the chunked core
     and the anchor-attention kernel); f32 and bf16 with an EPN schedule
     whose second conv reads 1-channel rows (the C == 1 contraction); then
     the deeper EPN, a last EPN block of 1024 with one direction head, and
     66 kernel points with 262 neighbours, a 12-channel conv and 1024 U-Net
     planes at full width (DEEP_STEPS; the last over three input seeds,
     REPAIRED_SEEDS).  Each must launch exactly its own kernel set;
     tolerances in `small_step`, the bf16 steps' directions included;
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
     then the latency of `run_scan` on a built pipeline;
  7. training (`train_phase`): (a) each inter-conv autograd Function on the
     card at a main-path chunk (the contraction on f32 and bf16 rows and on
     1-channel rows, the occupancy conv, the occupancy conv with its
     projection): the kernel forward against the plain version at phase 3's
     tolerances, its gradients against the plain twin's autograd, and the
     time of its backward (the plain twin recomputed); (b) one f32 train
     step of `EtchConfig()` at N=1024, B=2 on the card against the CPU: the
     loss and each gradient leaf's error relative to its largest value,
     within TRAIN_LOSS_RTOL and TRAIN_GRAD_LIMIT (median over the leaves),
     and the same step with a contraction forward that drops a neighbour
     must exceed that limit; (c) the full-width f32 train step
     (`make_train_step`, B=8, N=5000, capsule clouds with analytic ground
     truth): a warm step, then TRAIN_TIMED_STEPS timed ones: ms a step, the
     forward / backward / optimizer split, peak memory, each kernel's
     launches a step, only the f32 training kernel set (the f32 serving set
     less the fused instance norm, which autograd bypasses), at shapes
     phase 3 timed;
     and one bf16 train step at N=1024, B=2: finite, only the bf16
     inter-conv kernels and the index kernels; (d) the NaN guard on the card; (e) `python -m etch_tpu_torch.cli.train`
     (its `main`) on the repository's 4D-DRESS sample, two epochs at B=1,
     then its last checkpoint through `build_pipeline(checkpoint_path=...)`:
     the same forward as the trained model, and `run_scan` writes its files;
     the proximity backend of the ground truth is printed;
  8. evaluation (`evaluate_phase`): `python -m etch_tpu_torch.cli.evaluate`
     (its `main`) on the 4D-DRESS sample, `EtchConfig()`, N=5000, B=1, f32,
     with phase 7 (e)'s checkpoint, the synthetic body and `--save_debug`,
     in a temporary working directory: exactly the f32 kernel set launched,
     each at a shape phase 3 timed (its B=1 pass); `v2v_score.txt` holds the
     sample's line and the average block, and its V2V equals the float64 one
     recomputed from the exported OBJ and the GT mesh (within the OBJ's
     rounding, 1e-8 m); the npz schemas; each debug PLY reads back with N
     points; `cli.compute_mpjpe` on the outputs prints a finite MPJPE; the
     seconds of the scan (dataset load, pipeline build, forward, fit,
     export) are printed;
  9. data parallel (`data_parallel_phase`, `parallel/mesh.py` through
     tools/torch_parallel_check.py): one f32 train step of EtchConfig() on
     one B=8, N=5000 capsule batch in two gloo ranks on the one card (B=4
     each; NCCL refuses two ranks on one device) against one rank: the
     loss, the gradients' global relative difference and the BatchNorm
     statistics within DP_LOSS_RTOL, DP_GRAD_LIMIT and DP_BUFFER_LIMIT, the
     ranks' parameters equal; the ranks' ms a step and peak memory; the
     same step with the gradients summed and with per-rank BatchNorm must
     exceed DP_GRAD_LIMIT (a line says so where gloo stages its reductions
     through host copies); then `cli.train_mixed` at world size 1, one
     epoch over the bundled 4D-DRESS item given twice (a two-part
     ConcatDataset), with and without `--use_dynamic_label_confidence`:
     its files and the f32 training kernel set at shapes phase 3 timed;
 10. the fit's extras (`fit_extras_phase`) on the synthetic body at 6,890
     vertices and a 5,000-point scan off its surface: `fit_smpl` against
     the CPU; `point_mesh_distance` (k=8) and `chamfer_refine`
     (CHAMFER_ITERATIONS, both ways, the GMM prior) against the same calls
     with the plain kNN on the card, each launching kNN only, at shapes
     phase 3 timed, as often as predicted; `fit_smpl_adam` (40 + 80 steps)
     against the CPU; the seconds of each call.

The line before the last is a JSON object with one entry per kernel (its
launches on a path and per request, its headline shape's times, bound and
library time, its gap summed over its shapes, every shape's numbers with
its counted launches a request, its launches a full-width train step and,
for the inter-conv kernels, its Function's backward time); the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or
without the etch_tpu_torch package beside it, the script exits non-zero
before printing either.
"""

import importlib
import json
import math
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
# Phase 7 (b): an f32 train step at full width, card against CPU.  The
# loss within TRAIN_LOSS_RTOL; each gradient leaf's max |card - CPU| over
# its max |CPU|, leaves whose exact gradient is zero left out
# (`train/state.py::ZERO_GRADIENT`), with a median within TRAIN_GRAD_LIMIT;
# the same step with a contraction forward that drops a neighbour must read
# above either (checked in every run).  Both limits sit between the sound
# step (loss 7.0e-5, median 0.22) and the dropped neighbour (3.6e-4, 1.53)
# on an H100 (PERF.md section 6).  The median is that high without a fault:
# flax's BatchNorm variance E[x^2] - E[x]^2 in f32, over the deep U-Net
# levels' few values (4 points a cloud at the coarsest), amplifies f32
# rounding into the gradients, in JAX as in the port; the card's step with
# the inter-conv plain versions in place of the kernels is printed beside
# it as that floor.
TRAIN_LOSS_RTOL = 2e-4
TRAIN_GRAD_LIMIT = 0.6
TRAIN_TIMED_STEPS = 3
SAMPLE = ("datafolder/4D-DRESS/data_processed/model", "datafolder/4D-DRESS/data_processed/smplh",
          "datafolder/gt_4D-Dress_data/npz", "datafolder/useful_data_4d-dress/train_ids.pkl")
# the kernels each serving path launches (and no others): f32, bf16 with the
# fused direction core, bf16 with the chunked core (fused_core=False, or one
# direction layer), and each with the 1-channel conv of C1_MLPS
PATH_KERNELS = {
    "f32": ("fps", "knn", "ball_query", "interconv_ones", "interconv_t", "instance_norm"),
    "bf16": ("fps", "knn", "ball_query", "interconv_ones_proj", "interconv_t_bf16",
             "dircore", "vector_attention", "grouped_head", "instance_norm"),
    "bf16_chunked": ("fps", "knn", "ball_query", "interconv_ones_proj", "interconv_t_bf16",
                     "attention", "vector_attention", "grouped_head", "instance_norm"),
}
PATH_KERNELS["f32_c1"] = PATH_KERNELS["f32"] + ("interconv_t_c1",)
# a train step launches the inter-conv kernels only (and the index kernels),
# never the fused instance norm, which autograd bypasses: the f32 contraction
# and occupancy conv, or with use_bfloat16 the bf16 contraction and the
# occupancy conv with its projection
PATH_KERNELS["train_f32"] = ("fps", "knn", "ball_query", "interconv_ones", "interconv_t")
PATH_KERNELS["train_bf16"] = ("fps", "knn", "ball_query", "interconv_ones_proj",
                              "interconv_t_bf16")
PATH_KERNELS["bf16_chunked_c1"] = PATH_KERNELS["bf16_chunked"] + ("interconv_t_c1",)
C1_MLPS = ((1, 8), (8, 8))   # an EPN schedule whose second conv reads 1-channel rows
# Phase 9: two gloo ranks on the card, B=4 each, against one rank at B=8:
# the first step's loss (relative), its gradients' global norm-relative
# difference, and its BatchNorm running statistics (max leaf error over the
# leaf's largest value) within these; summed gradients and a per-rank
# BatchNorm must exceed the gradient limit.  The port's own floor, 1 rank
# against 1 rank with the batch's halves swapped, and the planted faults
# are printed beside them.  On an H100: the ranks 0.0163 from one rank,
# the floor 0.0166 (flax's variance rule amplifies reordered sums at full
# width), summed gradients 1.0, a per-rank BatchNorm 1.26; loss 1.1e-6,
# BatchNorm 7.8e-6 (PERF.md, section 6).
DP_LOSS_RTOL = 1e-4
DP_GRAD_LIMIT = 0.05
DP_BUFFER_LIMIT = 1e-2
DP_TIMED_STEPS = 2
# Phase 10: the synthetic body at SMPL's vertex count and a scan of FIT_SCAN
# points; card against CPU (the fits without a kNN) and the kNN kernel
# against its plain version (point-to-mesh distance, Chamfer refinement):
# vertices within FIT_TOL metres, losses within FIT_LOSS_RTOL.
FIT_VERTS, FIT_SCAN = 6890, 5000
FIT_TOL = 1e-3
FIT_LOSS_RTOL = 1e-4
CHAMFER_ITERATIONS = 50
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
    # no TPU kernel: the JAX package leaves its norm (f32 statistics) to XLA
    "instance_norm": ("instance_norm.cu", "none (XLA: etch_tpu/nn/epn.py:94-100)"),
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
# the same weight summed over a center's neighbours in the TPU kernel's
# expanded form, max(x . (2 r / sigma) + 1 - |r|^2 / sigma, xx) - xx: 3 FFMA,
# a max and the sum's add; and per neighbour its offset from the center
# (3), xx = |x|^2 / sigma (an FMUL, 2 FFMA and the scale: 6) and the sum of
# the xx (1): the least work for the occupancy conv's weights, the bound of
# both occupancy kernels (the projection's (A, K) x (K, Co) products on the
# tensor cores)
EXPANDED_WEIGHT_FLOP, NEIGHBOUR_FLOP = 8, 10
# the C == 1 body's weight in the same form, its sum's add an FMA with the
# neighbour's feature (2 operations in place of 1)
C1_WEIGHT_FLOP = EXPANDED_WEIGHT_FLOP + 1


def ball_query_pairs(torch, kn, q, s, r, nsample, ref):
    """The pairs an index-order ball query must visit for these inputs: for
    each query the position of its nsample-th hit plus 1 where its ball
    holds that many, else all N supports (read from `ref`, the plain
    version's indices, and the hit counts)."""
    from etch_tpu_torch.ops.ball_query import radius_sq
    N = s.shape[1]
    total = 0
    for b in range(q.shape[0]):
        hits = (kn.pairwise_sqdist(q[b:b + 1], s[b:b + 1]) < radius_sq(r)).sum(-1)[0]
        last = ref[b, :, nsample - 1].long() + 1
        total += torch.where(hits >= nsample, last, torch.full_like(last, N)).sum().item()
    return float(total)


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


def median_angle(d, ref):
    """Median angle (radians) between two fields of unit directions (..., 3)."""
    cos = (d.float().cpu() * ref.float().cpu()).sum(-1).clamp(-1.0, 1.0)
    return cos.acos().median().item()


def direction_accuracy(gpu, cpu, f32):
    """The direction head of a bf16 step on the card (`gpu`) and on the CPU
    (`cpu`) against the same weights served in f32 on the CPU: their median
    angles from the f32 directions, and whether the card's is within
    AS_ACCURATE_STEP times the CPU's (the head is ill-conditioned at random
    weights, so bf16 rounding alone moves directions by degrees; phase 3 and
    the card tests judge its core and attention alone)."""
    angles = [median_angle(o["direction"], f32["direction"]) for o in (gpu, cpu)]
    return ({"card_median_angle": angles[0], "cpu_median_angle": angles[1]},
            angles[0] <= AS_ACCURATE_STEP * angles[1])


def bf16_step_accuracy(gpu, cpu, f32):
    """A full-width bf16 serving step on the card (`gpu`) and on the CPU
    (`cpu`), each against the same weights served in f32 on the CPU:
    confidences and vector lengths (`as_accurate`, the CPU's step as the
    twin), directions (`direction_accuracy`) and the share of part labels
    off the f32 ones.  Returns the report and whether the card's step is as
    accurate as the CPU's: within AS_ACCURATE_STEP times its errors, and
    part labels off on at most max(AS_ACCURATE_STEP times the CPU's share,
    2%) of the points."""
    report, ok = {}, True
    report["direction"], ok = direction_accuracy(gpu, cpu, f32)
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

    def record(kernel, shape, err, fn, reps, plain_ms, bnd, library_ms=None, extra=None):
        """One shape's numbers: fn's eager time over `reps` launches and its
        time replayed from a CUDA graph (`graph_ms`), then the rest, and
        `extra` (an earlier count of the bound beside the one used).  The
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
                 "max_abs_err": err, **(extra or {})}
        if extra:
            print(f"  {kernel:19s} {shape:34s} " + ", ".join(
                f"{k} {v:.4f}" for k, v in extra.items()))
        prev = results.get(kernel)
        if prev is None:
            results[kernel] = {"max_abs_err": err, "ms": ms, "graph_ms": gms, "plain_ms": plain_ms,
                               "bound_ms": bound_ms, "bound_by": by,
                               "library_ms": library_ms, **(extra or {}), "shapes": [entry]}
        else:
            prev["max_abs_err"] = max(prev["max_abs_err"], err)
            prev["shapes"].append(entry)

    anchors = get_anchors(60)

    def rk_of(spec):
        kp = get_kernel_points(spec["radius"], spec["kernel_size"])
        rk = np.einsum("aij,kj->aki", anchors, kp).reshape(-1, 3)
        return torch.from_numpy(np.ascontiguousarray(rk)).to(dev)

    def check(kernel, label, out, ref, fn, plain_fn, bnd, extra=None):
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= INTERCONV_RTOL * scale:
            raise AssertionError(f"{kernel} {label}: max abs err {err} > "
                                 f"{INTERCONV_RTOL} * {scale}")
        record(kernel, label, err, fn, 5, cuda_ms(torch, plain_fn, 1), bnd, extra=extra)

    def check_bf16(kernel, label, fn, plain_fn, bnd, library_fn=None, exact_fn=None,
                   extra=None):
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
        record(kernel, label, worst, fn, 5, cuda_ms(torch, plain_fn, 1), bnd, library_ms, extra)

    gen = torch.Generator(device=dev).manual_seed(0)

    def knn_row(label, q, s, k):
        """kNN at one shape: indices and squared distances equal to the
        plain version's, then its row."""
        b, Q, S = q.shape[0], q.shape[1], s.shape[1]
        idx, d2 = kn.knn_cuda(q, s, k)
        ridx, rd2 = kn.knn_torch(q, s, k)
        if not torch.equal(idx, ridx):
            raise AssertionError(f"knn {label}: kernel and plain indices differ")
        err = (d2 - rd2).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"knn {label}: squared distances differ by {err}")
        record("knn", f"B={b} {label}", err,
               lambda: kn.knn_cuda(q, s, k), 5,
               cuda_ms(torch, lambda: kn.knn_torch(q, s, k), 2),
               bound(b * (Q + S) * 12 + b * Q * k * 8, 0.0, 8.0 * b * Q * S))

    def f32_path_shapes(b, xyz):
        """The f32 path's launches of a request of b clouds of N points:
        FPS, kNN, ball query, the occupancy conv and the contraction.
        Returns (clouds by size, the EPN's points, its conv specs, ball
        query's indices of each conv)."""
        # FPS launches of a request: the EPN's 5000->2500 and the U-Net
        # geometry's 5000->1250->312->78->19 (nn/point_transformer.py)
        clouds = {N: xyz}
        for n, m in ((N, 2500), (N, 1250), (1250, 312), (312, 78), (78, 19)):
            src = clouds[n]
            out = fp.fps_cuda(src, m)
            ref = fp.fps_torch(src, m)
            if not torch.equal(out, ref):
                raise AssertionError(f"fps {n}->{m}: kernel and plain indices differ")
            record("fps", f"B={b} {n}->{m}", 0.0,
                   lambda: fp.fps_cuda(src, m), 5,
                   cuda_ms(torch, lambda: fp.fps_torch(src, m), 1),
                   bound(b * n * 12 + b * m * 4, 0.0, 10.0 * b * m * n))
            clouds[m] = gather_points(src, out).contiguous()

        # kNN shapes of a request (k, queries, supports): each U-Net level's
        # self neighbours, the down neighbours of levels 1-4 and the up 3-NN
        # of levels 0-3 (5000x1250 k=3 also propagates the EPN's features)
        lv = (N, 1250, 312, 78, 19)
        knn_shapes = [(8, N, N), (16, 1250, N), (3, N, 1250)]
        knn_shapes += [(16, lv[l], lv[l]) for l in range(1, 5)]
        knn_shapes += [(16, lv[l], lv[l - 1]) for l in range(2, 5)]
        knn_shapes += [(3, lv[l], lv[l + 1]) for l in range(1, 4)]
        if b == B:
            knn_shapes.append((48, 1250, N))   # repaired: k above 32 (passes of 32)
        for k, Q, S in knn_shapes:
            knn_row(f"k={k} {Q}x{S}", clouds[Q], clouds[S], k)

        # ball query of each EPN conv: its centers among its input points
        # (conv0 samples 2500 by FPS, conv2 the first 1250 lazily)
        plan = backbone_plan(EtchConfig(num_point=N, batch_size=b))
        specs = (plan[0][0], plan[0][1], plan[1][0], plan[1][1])
        q2500 = clouds[2500]
        epn_pts = {N: xyz, 2500: q2500, 1250: q2500[:, :1250].contiguous()}
        nbrs = []
        for i, spec in enumerate(specs):
            q, s = epn_pts[spec["n_out"]], epn_pts[spec["n_in"]]
            r, ns = spec["radius"], spec["n_neighbor"]
            nbr = bq.ball_query_cuda(q, s, r, ns)
            ref = bq.ball_query_torch(q, s, r, ns)
            if not torch.equal(nbr, ref):
                raise AssertionError(f"ball_query conv{i}: kernel and plain indices differ")
            Q, S = q.shape[1], s.shape[1]
            pairs = ball_query_pairs(torch, kn, q, s, r, ns, ref)
            record("ball_query", f"B={b} {Q}x{S} r={r:.3f} ns={ns}", 0.0,
                   lambda: bq.ball_query_cuda(q, s, r, ns), 5,
                   cuda_ms(torch, lambda: bq.ball_query_torch(q, s, r, ns), 2),
                   bound(b * (Q + S) * 12 + b * Q * ns * 4, 0.0, 8.0 * pairs),
                   extra={"bound_mn_ms": bound(0.0, 0.0, 8.0 * b * Q * S)[0],
                          "pairs_visited_share": pairs / (b * Q * S)})
            nbrs.append(nbr)

        # occupancy conv of conv0: the 512-center chunks of the 2500 FPS
        # centers and the ragged last one
        conv0 = specs[0]
        rk, sg, ns = rk_of(conv0), conv0["sigma"], conv0["n_neighbor"]
        for c in chunks(conv0["n_out"]):
            ctr, nbr = q2500[:, :c].contiguous(), nbrs[0][:, :c].contiguous()
            check("interconv_ones", f"B={b} P={N} c={c} nn={ns}",
                  interconv.interconv_ones_cuda(xyz, ctr, nbr, rk, sg, 60),
                  interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sg, 60),
                  lambda: interconv.interconv_ones_cuda(xyz, ctr, nbr, rk, sg, 60),
                  lambda: interconv.interconv_ones_torch(xyz, ctr, nbr, rk, sg, 60),
                  bound(b * N * 12 + b * c * 12 + b * c * ns * 4 + 1440 * 12 + b * c * 1440 * 4,
                        0.0, (EXPANDED_WEIGHT_FLOP * 1440 + NEIGHBOUR_FLOP) * b * c * ns))

        # contraction on f32 rows: conv1 (C=32, centers of 2500), conv2
        # (C=32, the first 1250 of 2500: lazy sampling) and conv3 (C=64,
        # 1250), each in 512-center chunks and a ragged last one
        for spec in specs[1:]:
            C, pts, nn = spec["dim_in"], epn_pts[spec["n_in"]], spec["n_neighbor"]
            P = pts.shape[1]
            feats = torch.randn((b, P, 60 * C), device=dev, generator=gen)
            nbr_all = bq.ball_query_cuda(epn_pts[spec["n_out"]], pts, spec["radius"], nn)
            rk, sg = rk_of(spec), spec["sigma"]
            for c in chunks(spec["n_out"]):
                ctr = pts[:, :c].contiguous()          # lazy sampling: the first points
                nbr = nbr_all[:, :c].contiguous()
                check("interconv_t", f"B={b} P={P} c={c} of {spec['n_out']} nn={nn} C={C}",
                      interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
                      interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
                      lambda: interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
                      lambda: interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
                      interconv_bound(b, P, c, nn, 60, 24, C, 4))
            del feats
        torch.cuda.empty_cache()
        return clouds, epn_pts, specs, nbrs

    def norm_rows(b, shapes):
        """The fused instance norm at b batch elements of each (points,
        channels) conv output in `shapes`, without and with the residual:
        its normalised value within one f32 ulp of the plain twin's at every
        element, its output equal to the twin's at 99.9% of them; bound:
        x and the residual read once and the output written once, and the
        design's own floor (x read twice from device memory) beside it."""
        from etch_tpu_torch.nn import epn
        for P, C in shapes:
            x = torch.randn((b, P, 60, C), device=dev, generator=gen) * 2 + 0.3
            x[..., 1] = 0.37   # a constant channel, as the first block's skip branch
            for res in (None, torch.randn((b, P, 60, C), device=dev, generator=gen)):
                out = epn.norm_act_cuda(x, 0.01, res)
                ref = epn.norm_act_torch(x, 0.01, res)
                h = epn.instance_norm_pa(x)
                lo, hi = (torch.nn.functional.leaky_relu(
                    torch.nextafter(h, torch.full_like(h, v)), 0.01) for v in (-math.inf, math.inf))
                act = epn.norm_act_cuda(x, 0.01) if res is not None else out
                same = (out == ref).float().mean().item()
                if not (((lo <= act) & (act <= hi)).all() and same >= 0.999
                        and (act[..., 1] == 0).all()):
                    raise AssertionError(f"instance_norm B={b} P={P} C={C}: {same:.6f} equal, "
                                         f"or off by more than one ulp")
                err = (out - ref).abs().max().item()
                del h, lo, hi, act, ref
                n = x.numel()
                per = 12 if res is not None else 8
                record("instance_norm", f"B={b} P={P} C={C}{' +residual' if res is not None else ''}",
                       err, lambda: epn.norm_act_cuda(x, 0.01, res), 5,
                       cuda_ms(torch, lambda: epn.norm_act_torch(x, 0.01, res), 1),
                       bound(n * per), extra={"bound_two_reads_ms": bound(n * (per + 4))[0],
                                              "equal_share": same})
                del out
            del x, res
            torch.cuda.empty_cache()

    # the EPN's conv outputs: two blocks at B=8 (phase 5's requests) and B=1
    # (cli/infer, cli/evaluate), the four published blocks at B=32 (the
    # benchmark's serving cells)
    epn2 = [(2500, 32), (1250, 64)]
    norm_rows(B, epn2)
    norm_rows(32, epn2 + [(625, 128), (313, 256)])
    norm_rows(1, epn2)

    xyz = torch.from_numpy(capsule_clouds(B, N, seed=1)).to(dev)
    clouds, epn_pts, specs, nbrs = f32_path_shapes(B, xyz)
    q2500 = clouds[2500]
    # repaired: a cloud past the register instance (the device-memory one)
    big = torch.from_numpy(capsule_clouds(B, 20000, seed=2)).to(dev)
    out = fp.fps_cuda(big, 2000)
    if not torch.equal(out, fp.fps_torch(big, 2000)):
        raise AssertionError("fps 20000->2000: kernel and plain indices differ")
    record("fps", f"B={B} 20000->2000", 0.0, lambda: fp.fps_cuda(big, 2000), 3,
           cuda_ms(torch, lambda: fp.fps_torch(big, 2000), 1),
           bound(B * 20000 * 12 + B * 2000 * 4, 0.0, 10.0 * B * 2000 * 20000))
    del big
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
        """C == 1 body at conv1's geometry: 512 of 2500 centers; its weights
        counted at the expanded form the kernel computes (C1_WEIGHT_FLOP a
        weight, NEIGHBOUR_FLOP a neighbour), the direct form's count beside
        it (`bound_direct_ms`)."""
        bytes_ = (B * 2500 * 3 + B * 512 * 3 + 1440 * 3) * 4 + B * 512 * nn * 4 + \
            (B * 2500 * 60 + B * 512 * 1440) * elem
        return (bound(bytes_, 0.0, (C1_WEIGHT_FLOP * 1440 + NEIGHBOUR_FLOP) * B * 512 * nn),
                {"bound_direct_ms": bound(bytes_, 0.0,
                                          (WEIGHT_FLOP + 2.0) * B * 512 * nn * 1440)[0]})

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
          c1_bound(conv1["n_neighbor"], 4)[0], extra=c1_bound(conv1["n_neighbor"], 4)[1])
    del feats
    torch.cuda.empty_cache()
    compare_bf16_kernels(torch, dev, xyz, clouds, epn_pts, specs, nbrs[0], rk_of, check_bf16,
                         c1_bound)
    torch.cuda.empty_cache()
    # the f32 path's shapes at B=1: the requests of cli/infer and cli/evaluate
    f32_path_shapes(1, xyz[:1].contiguous())
    # the fit's extras (phase 10): the Chamfer term's nearest neighbours both
    # ways, and the point-to-mesh distance's candidate faces
    fit = fit_problem(torch, dev)
    knn_row(f"k=1 {FIT_VERTS}x{FIT_SCAN} (Chamfer)", fit["verts"], fit["scan"], 1)
    knn_row(f"k=1 {FIT_SCAN}x{FIT_VERTS} (Chamfer)", fit["scan"], fit["verts"], 1)
    knn_row(f"k=8 {FIT_SCAN}x{fit['centroids'].shape[1]} (face centroids)", fit["scan"],
            fit["centroids"], 8)
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
                    2.0 * B * c * 1440 * Co,
                    (EXPANDED_WEIGHT_FLOP * 1440 + NEIGHBOUR_FLOP) * B * c * ns))

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
    # repaired (x0 rows): conv1's geometry at 66 kernel points (kernel_size
    # 3: three 32-point blocks) and at 12 channels (rows padded to 16), and
    # conv3's at sampling_ratio 3.2 (262 neighbours, 64-neighbour chunks);
    # 256-center chunks, which keep the plain version's (c, nn, A*K) weights
    # inside the card's memory
    spec, c = specs[1], 256
    ctr = q2500[:, :c].contiguous()
    for C, K in ((32, 66), (12, 24)):
        rk = rk_of(dict(spec, kernel_size=3 if K == 66 else 1))
        feats = randn(B, 2500, 60 * C).to(bf)
        nbr = ball_query(ctr, q2500, spec["radius"], spec["n_neighbor"])
        check("interconv_t_bf16", f"B={B} P=2500 c={c} nn={spec['n_neighbor']} C={C} K={K}",
              lambda: interconv.interconv_t_cuda(q2500, ctr, nbr, feats, rk, spec["sigma"], 60),
              lambda: interconv.interconv_t_torch(q2500, ctr, nbr, feats, rk, spec["sigma"], 60),
              interconv_bound(B, 2500, c, spec["n_neighbor"], 60, K, C, 2))
        del feats
        torch.cuda.empty_cache()
    from etch_tpu_torch.utils.config import EPNConfig, EtchConfig, backbone_plan
    spec = backbone_plan(EtchConfig(num_point=N, batch_size=B,
                                    epn=EPNConfig(sampling_ratio=3.2)))[1][1]
    pts, nn = epn_pts[spec["n_in"]], spec["n_neighbor"]
    feats = randn(B, pts.shape[1], 60 * 64).to(bf)
    ctr = pts[:, :c].contiguous()
    nbr = ball_query(ctr, pts, spec["radius"], nn)
    rk, sg = rk_of(spec), spec["sigma"]
    check("interconv_t_bf16", f"B={B} P={pts.shape[1]} c={c} nn={nn} C=64",
          lambda: interconv.interconv_t_cuda(pts, ctr, nbr, feats, rk, sg, 60),
          lambda: interconv.interconv_t_torch(pts, ctr, nbr, feats, rk, sg, 60),
          interconv_bound(B, pts.shape[1], c, nn, 60, 24, 64, 2))
    del feats
    torch.cuda.empty_cache()

    spec = specs[1]
    feats = randn(B, q2500.shape[1], 60).to(bf)
    ctr = q2500[:, :512].contiguous()
    nbr = ball_query(ctr, q2500, spec["radius"], spec["n_neighbor"])
    rk, sg = rk_of(spec), spec["sigma"]
    check("interconv_t_c1", f"B={B} P=2500 c=512 nn={spec['n_neighbor']} C=1 bf16",
          lambda: interconv.interconv_t_c1_cuda(q2500, ctr, nbr, feats, rk, sg, 60),
          lambda: interconv.interconv_t_c1_torch(q2500, ctr, nbr, feats, rk, sg, 60),
          c1_bound(spec["n_neighbor"], 2)[0], extra=c1_bound(spec["n_neighbor"], 2)[1])
    del feats

    # direction core: every point's (60, E) tokens, V=128: E = 64 with 8 heads
    # (the main path), then the repaired E = 128 and 256 (epn_layer_num 3, 4),
    # one head of 256 columns, a 512-wide last EPN block, and a 1024-wide one
    # with one direction head (csrc/dircore_big.cu, on fewer points)
    V = 128
    for E, H, M in ((64, 8, B * N), (128, 8, B * N), (256, 8, B * N), (256, 1, B * N),
                    (512, 8, B * N), (1024, 1, 4096)):
        params = {}
        for l in (0, 1):
            for nm in ("wq", "wk", "wv"):
                params[f"{nm}{l}"] = randn(E, E, scale=E ** -0.5)
        params.update(wc0=randn(E, E, scale=E ** -0.5), bc0=randn(E, scale=0.1),
                      wc1=randn(E, V, scale=E ** -0.5), bc1=randn(V, scale=0.1),
                      wm0=randn(V, V, scale=V ** -0.5), bm0=randn(V, scale=0.1),
                      wm1=randn(V, V, scale=V ** -0.5), bm1=randn(V, scale=0.1),
                      wr=randn(V, 1, scale=V ** -0.5), br=randn(1, scale=0.1))
        tokens = randn(M, 60, E).to(bf)
        A = 60
        flop = (2.0 * M * A * (2 * 3 * E * E + E * E + E * V + 2 * V * V + V)
                + 4.0 * 2 * M * A * A * E)
        plain = (lambda t: torch.cat([dircore.direction_core_torch(t[s:s + 2048], params, H)
                                      for s in range(0, t.shape[0], 2048)]))
        check("dircore", f"M={M} A={A} E={E} H={H} V={V}",
              lambda: dircore.direction_core_cuda(tokens, params, H), lambda: plain(tokens),
              bound(M * A * E * 2 + M * A * 4, flop),
              exact_fn=(lambda: plain(tokens.float())) if E > 128 else None)
        del tokens
    E, H = 64, 8

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
    # repaired: the chunked core's attention at E = 256, 8 heads (two head
    # groups), one head of 256 columns (one point a block) and one of 512
    # (256-column slices)
    Bc = 2048
    for E2, H2 in ((256, 8), (256, 1), (512, 1)):
        hs2 = E2 // H2
        q, k, v = (randn(Bc, L, E2, scale=hs2 ** -0.5 if i == 0 else 1.0).to(bf)
                   for i in range(3))
        qh, kh, vh = (t.reshape(Bc, L, H2, hs2).transpose(1, 2).reshape(Bc * H2, L, hs2)
                      .contiguous() for t in (q, k, v))
        check("attention", f"Bc={Bc} L={L} E={E2} H={H2}",
              lambda: attention.attention_cuda(q, k, v, H2),
              lambda: attention.attention_torch(q, k, v, H2),
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

    # repaired (x0): the last level at 1024 planes (cs = 128, the wide kernel)
    idx = geom[4]["self"]
    Bl, Nl, nsl = idx.shape
    c, cs, R = 1024, 128, Bl * Nl
    args = (randn(R, c).to(bf), randn(Bl, Nl, c).to(bf), randn(Bl, Nl, c).to(bf), idx,
            randn(R, nsl, c).to(bf), torch.stack([randn(c).abs() + 0.5, randn(c)]),
            randn(c, cs, scale=c ** -0.5), torch.stack([randn(cs).abs() + 0.5, randn(cs)]),
            randn(cs, cs, scale=cs ** -0.5), randn(cs))
    check("vector_attention", f"R={R} ns={nsl} c={c}",
          lambda: vector_attention.vector_attention_cuda(*args),
          lambda: vector_attention.vector_attention_torch(*args),
          bound(R * c * 2 * 3 + R * nsl * (4 + c * 2) + R * c * 4,
                2.0 * R * nsl * (c * cs + cs * cs), R * nsl * (8.0 * c + 6.0 * cs)))
    del args

    # grouped confidence head: c0=128, k=86 parts (the main path), then the
    # repaired c0 = 256 (unet_planes_confidence[0] = 256); beside the first,
    # the bf16 product h @ W0 alone, a yardstick the port never calls
    R, k = B * N, 86
    for c0 in (128, 256):
        gargs = (randn(R, c0).to(bf), randn(c0, k * c0, scale=c0 ** -0.5),
                 randn(k * c0, scale=0.1), randn(k, c0, scale=(6 / (k + c0)) ** 0.5),
                 randn(k, scale=0.1))
        check("grouped_head", f"R={R} c0={c0} k={k}",
              lambda: grouped_head.grouped_head_cuda(*gargs),
              lambda: grouped_head.grouped_head_torch(*gargs),
              bound(R * c0 * 2 + c0 * k * c0 * 2 + R * k * 4, 2.0 * R * c0 * k * c0,
                    4.0 * R * k * c0))
        if c0 == 128:
            h, w0 = gargs[0], gargs[1].to(bf)
            mm_ms = cuda_ms(torch, lambda: torch.matmul(h, w0), 5)
            print(f"  {'grouped_head':19s} yardstick h @ W0 (torch.matmul, bf16, ({R} x {c0}) x "
                  f"({c0} x {k * c0})): {mm_ms:.3f} ms (graph "
                  f"{graph_ms(torch, lambda: torch.matmul(h, w0), 5):.4f})")
            del h, w0
        del gargs
        torch.cuda.empty_cache()


# the widths repaired in this round's last slice, in one network: 66 kernel
# points (EPNConfig.kernel_size 3), 262 neighbours at every conv (sampling_ratio
# 3.2), a 12-channel conv (rows padded to 16) and a 1024-plane last U-Net level
# (the wide vector attention); EPN fields as a dict (deep_config)
REPAIRED_9 = dict(epn=dict(kernel_size=3, sampling_ratio=3.2), epn_mlps=((12, 32), (64, 64)),
                  unet_planes_magnitude=(64, 128, 256, 512, 1024), use_bfloat16=True)
# Input seeds a full-width bf16 step at the repaired widths is judged over,
# pooled.  On one seed the card's plain versions themselves miss
# AS_ACCURATE_STEP of the CPU there (REPAIRED_9: vector lengths' median 1.360
# at seed 3, confidences' max 1.451 at seed 5, all within at seed 4), as do
# the kernels (6- and 12-channel convs: confidences' max 1.539 at seed 3,
# 0.881-1.106 at seeds 4-6), while every module fed the CPU step's own input
# reads 0.90-1.26 of the CPU's error, kernels and plain versions alike
# (tools/torch_plain_twin_accuracy.py --replay, on an H100): one pair of
# clouds is too few there; over seeds 3-5 both read 0.80-1.22.
REPAIRED_SEEDS = (3, 4, 5)


def deep_config(overrides, num_point=1024, batch_size=2):
    """EtchConfig at N=1024, B=2 with `overrides`, whose "epn" entry (if any)
    holds EPNConfig fields."""
    from etch_tpu_torch.utils.config import EPNConfig, EtchConfig
    kw = dict(overrides)
    if "epn" in kw:
        kw["epn"] = EPNConfig(**kw["epn"])
    return EtchConfig(num_point=num_point, batch_size=batch_size, **kw)


SMALL_STEPS = (  # phase 4: (label, EtchConfig.tiny overrides, kernel set on the card)
    ("f32", {}, "f32"),
    ("bf16, 2 direction layers", dict(use_bfloat16=True, dir_num_layers=2), "bf16"),
    ("bf16, 1 direction layer", dict(use_bfloat16=True), "bf16_chunked"),
    ("f32, 1-channel conv", dict(epn_mlps=C1_MLPS), "f32_c1"),
    ("bf16, 1-channel conv", dict(use_bfloat16=True, epn_mlps=C1_MLPS), "bf16_chunked_c1"),
)
DEEP_STEPS = (  # phase 4 at full width at N=1024, B=2: EtchConfig(epn_layer_num=4), the
    # 128- and 256-channel blocks (channel slices) and the E = 256 direction core,
    # with 8 heads and with one head of 256 columns; a last EPN block of 1024
    # channels with one direction head (the fused core of csrc/dircore_big.cu);
    # the widths repaired last.  (label, overrides, kernel set, input seeds)
    ("f32, epn_layer_num=4", dict(epn_layer_num=4), "f32", (3,)),
    ("bf16, epn_layer_num=4", dict(epn_layer_num=4, use_bfloat16=True), "bf16", (3,)),
    ("bf16, epn_layer_num=4, one direction head",
     dict(epn_layer_num=4, use_bfloat16=True, dir_num_heads=1), "bf16", (3,)),
    ("bf16, last EPN block of 1024, one direction head",
     dict(epn_mlps=((32, 32), (1024, 1024)), use_bfloat16=True, dir_num_heads=1), "bf16", (3,)),
    ("bf16, kernel_size 3, sampling_ratio 3.2, a 12-channel conv, 1024 U-Net planes",
     REPAIRED_9, "bf16", REPAIRED_SEEDS),
)
# what a full-width bf16 step's accuracy reads (bf16_step_accuracy)
STEP_OUTPUTS = ("confidences", "vectors", "part_labels", "direction")


def small_step(torch, _build, label, cfg, path, fused_core=True, full_width=False, seeds=(3,)):
    """Phase 4: the serving step of `cfg` (tiny widths at B=2, N=512, or the
    deeper EPN schedules at full width), kernels on the card against the same
    weights on the CPU (plain versions), on the capsule clouds of the first
    of `seeds`; `fused_core=False` takes the chunked direction core.  Returns
    the card run's launch counts, which must be exactly the path's kernel
    set.

    f32: equal part labels, confidences within 1e-4 * (1 + max), markers
    within 1e-3, vectors and inner points within 1e-4 * (1 + max) for 99% of
    the values and 1e-2 for all (the direction head's chordal mean is
    ill-conditioned at random weights).  bf16: rounding to bf16 at the same
    points in another summation order flips a rounding now and then, and the
    flips travel through the network: part labels equal for 98% of the
    points, confidences and vector lengths (magnitude / 10, as directions
    are ill-conditioned) within a median relative error of 1e-2 and
    2e-2 * (1 + max) for all, finite outputs, and the direction head's
    output (captured by a forward hook) as accurate as the CPU's bf16 step
    against the f32 one (`direction_accuracy`).  bf16 at `full_width`: there
    the flips alone move the card's plain versions further from the CPU than
    that, so the card's step is held to be as accurate as the CPU's against
    the same weights served in f32 on the CPU (`bf16_step_accuracy`:
    confidences and vector lengths within AS_ACCURATE_STEP times the CPU bf16
    step's error, median relative and max, directions by their median angle,
    and part labels off the f32 ones on at most max(AS_ACCURATE_STEP times
    the CPU's share, 2%) of the points), over the steps of every seed in
    `seeds` pooled (their outputs concatenated along the batch); each seed's
    reading is printed beside it."""
    from etch_tpu_torch.pipeline import build_pipeline

    def serve(config, device, pts):
        """run_batch's dict, with the direction head's unit directions."""
        pipe = build_pipeline(config, MARKERSET, allow_synthetic_body=True, rng_seed=0,
                              device=device)
        head = pipe.model.direction_head
        head.fused_core = fused_core
        seen = {}
        hook = head.register_forward_hook(lambda _m, _i, o: seen.update(direction=o))
        out = pipe.run_batch(pts)
        hook.remove()
        return {**out, "direction": seen["direction"]}

    def finite(out):
        for key in ("vectors", "inner_points", "confidences", "markers", "verts", "joints"):
            if not torch.isfinite(out[key]).all():
                raise AssertionError(f"small reference {label}: {key} not finite")

    pts = capsule_clouds(cfg.batch_size, cfg.num_point, seed=seeds[0])
    _build.reset_launch_counts()
    gpu = serve(cfg, "cuda", pts)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    ran = {k for k, v in launches.items() if v}
    if ran != set(PATH_KERNELS[path]):
        raise AssertionError(f"small reference {label}: kernels launched {sorted(ran)}, "
                             f"expected {sorted(PATH_KERNELS[path])}")
    cpu = serve(cfg, "cpu", pts)
    finite(gpu)
    if cfg.use_bfloat16 and full_width:
        f32_cfg = cfg.replace(use_bfloat16=False)
        runs = [(gpu, cpu, serve(f32_cfg, "cpu", pts))]
        for seed in seeds[1:]:
            more = capsule_clouds(cfg.batch_size, cfg.num_point, seed=seed)
            runs.append((serve(cfg, "cuda", more), serve(cfg, "cpu", more),
                         serve(f32_cfg, "cpu", more)))
            finite(runs[-1][0])
        report, ok = bf16_step_accuracy(*[
            {k: torch.cat([run[i][k].cpu() for run in runs]) for k in STEP_OUTPUTS}
            for i in range(3)])
        if len(seeds) > 1:
            report = {f"seeds {list(seeds)} pooled": report,
                      **{f"seed {seed}": bf16_step_accuracy(*run)[0]
                         for seed, run in zip(seeds, runs)}}
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
        report["direction"], ok = direction_accuracy(
            gpu, cpu, serve(cfg.replace(use_bfloat16=False), "cpu", pts))
        if not ok:
            raise AssertionError(f"small reference {label}: directions {report['direction']}")
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


def function_checks(torch, dev):
    """Phase 7 (a): each inter-conv autograd Function on the card at a
    main-path chunk (B=8, 512 centers, 64 neighbours; the contraction at
    conv1's geometry, the occupancy convs at conv0's): its kernel forward
    against the plain version (f32: INTERCONV_RTOL; bf16: BF16_ATOL and
    BF16_MEDIAN_REL), its gradients to the points, the centers and the rows
    (or w) against the plain twin's autograd on the same cotangent (equal
    up to the order of the index backward's atomic sums: 1e-5 of the
    largest f32 gradient, BF16_ATOL of the largest bf16 one), and the
    device time of its backward, the plain twin recomputed.  Returns
    {kernel: backward ms}."""
    from etch_tpu_torch.geometry.icosahedral import get_anchors
    from etch_tpu_torch.geometry.kernel_points import get_kernel_points
    from etch_tpu_torch.nn import interconv
    from etch_tpu_torch.ops import ball_query
    from etch_tpu_torch.utils.config import EtchConfig, backbone_plan

    plan = backbone_plan(EtchConfig(num_point=N, batch_size=B))
    gen = torch.Generator(device=dev).manual_seed(7)

    def geometry(spec, P):
        pts = torch.from_numpy(capsule_clouds(B, P, seed=spec["dim_in"])).to(dev)
        ctr = pts[:, :512].contiguous()
        nbr = ball_query(ctr, pts, spec["radius"], spec["n_neighbor"])
        kp = get_kernel_points(spec["radius"], spec["kernel_size"])
        rk = np.einsum("aij,kj->aki", get_anchors(60), kp).reshape(-1, 3)
        return pts, ctr, nbr, torch.from_numpy(np.ascontiguousarray(rk)).to(dev), spec["sigma"]

    conv0, conv1 = plan[0][0], plan[0][1]
    g1, g0 = geometry(conv1, 2500), geometry(conv0, N)
    w = torch.randn((24, conv0["dim_out"]), device=dev, generator=gen) * 0.25
    cases = []
    for label, C, dt in (("interconv_t", 32, torch.float32), ("interconv_t_bf16", 32, torch.bfloat16),
                         ("interconv_t_c1", 1, torch.float32), ("interconv_t_c1 bf16", 1, torch.bfloat16)):
        pts, ctr, nbr, rk, sg = g1
        feats = torch.randn((B, 2500, 60 * C), device=dev, generator=gen).to(dt)
        plain = interconv.interconv_t_torch if C > 1 else interconv.interconv_t_c1_torch
        cases.append((label, (pts, ctr, feats),
                      lambda x, c, f, nbr=nbr, rk=rk, sg=sg: interconv.interconv_t(x, c, nbr, f, rk, sg, 60),
                      lambda x, c, f, nbr=nbr, rk=rk, sg=sg, plain=plain: plain(x, c, nbr, f, rk, sg, 60)))
    pts, ctr, nbr, rk, sg = g0
    cases.append(("interconv_ones", (pts, ctr),
                  lambda x, c: interconv.interconv_ones(x, c, nbr, rk, sg, 60),
                  lambda x, c: interconv.interconv_ones_torch(x, c, nbr, rk, sg, 60)))
    cases.append(("interconv_ones_proj", (pts, ctr, w),
                  lambda x, c, ww: interconv.interconv_ones_proj(x, c, nbr, rk, sg, 60, ww),
                  lambda x, c, ww: interconv.interconv_ones_proj_torch(x, c, nbr, rk, sg, 60, ww)))
    backward_ms = {}
    for label, inputs, fn, plain in cases:
        ins = [t.clone().requires_grad_(True) for t in inputs]
        out, ref = fn(*ins), plain(*ins)
        err = (out.float() - ref.float()).abs()
        scale = ref.float().abs().max().item()
        if out.dtype == torch.bfloat16:
            ok = err.max().item() <= BF16_ATOL * scale and median_rel(err, ref.float()) <= BF16_MEDIAN_REL
        else:
            ok = err.max().item() <= INTERCONV_RTOL * scale
        if not ok:
            raise AssertionError(f"{label} Function forward: max abs err {err.max().item()} of {scale}")
        cot = torch.randn(out.shape, device=dev, generator=gen).to(out.dtype)
        got = torch.autograd.grad(out, ins, cot, retain_graph=True)
        want = torch.autograd.grad(ref, ins, cot)
        worst = []
        for a, b in zip(got, want):
            tol = (BF16_ATOL if a.dtype == torch.bfloat16 else 1e-5) * b.float().abs().max().item()
            d = (a.float() - b.float()).abs().max().item()
            worst.append(d)
            if not d <= tol:
                raise AssertionError(f"{label} Function gradient: max abs err {d} > {tol}")
        kernel = label.split()[0]
        ms = cuda_ms(torch, lambda: torch.autograd.grad(out, ins, cot, retain_graph=True), 3)
        if kernel not in backward_ms or " " not in label:
            backward_ms[kernel] = ms
        print(f"  Function {label:21s} forward max abs err {err.max().item():.3g}, gradients "
              f"max abs err {', '.join(f'{d:.3g}' for d in worst)}; backward (plain twin) "
              f"{ms:.3f} ms")
        del out, ref, got, want, ins
        torch.cuda.empty_cache()
    return backward_ms


def gradient_error(torch, card, cpu):
    """Per-leaf max |card - cpu| / max |cpu| over the leaves whose gradient
    is not zero by construction: (median, 90th percentile, max, worst
    leaf)."""
    from etch_tpu_torch.train.state import ZERO_GRADIENT
    rows = sorted(((card[k].cpu() - g).abs().max().item() / max(g.abs().max().item(), 1e-30), k)
                  for k, g in cpu.items() if not ZERO_GRADIENT.search(k))
    vals = [r for r, _ in rows]
    return (statistics.median(vals), vals[int(0.9 * (len(vals) - 1))], vals[-1], rows[-1][1])


def train_step_card_vs_cpu(torch):
    """Phase 7 (b): one f32 train step of EtchConfig() at N=1024, B=2, the
    same weights and batch on the card and on the CPU; the card's step with
    the plain inter-conv versions in place of the kernels (the rounding
    floor); then the card's step with the contraction kernel's forward fed
    neighbour lists whose second entry repeats the first (a dropped
    neighbour), which must fail."""
    from etch_tpu_torch.nn import interconv
    from etch_tpu_torch.train.state import create_train_state, make_train_step
    from etch_tpu_torch.train.synthetic import make_batch
    from etch_tpu_torch.utils.config import EtchConfig

    cfg = EtchConfig(num_point=1024, batch_size=2)
    batch = make_batch(np.random.RandomState(7), 2, 1024)

    def step(device):
        model, state, opt = create_train_state(cfg, seed=0, device=device)
        _, losses = make_train_step(model, opt, cfg)(state, batch)
        return (float(losses["all_loss"]),
                {k: p.grad.detach().cpu() for k, p in model.named_parameters()})

    t0 = time.perf_counter()
    cpu_loss, cpu_grads = step("cpu")
    cpu_s = time.perf_counter() - t0
    readings = {}
    sound, ones = interconv.interconv_t_cuda, interconv.interconv_ones_cuda

    def dropped(xyz, centers, nbr, feats, rk, sigma, A):
        nbr = nbr.clone()
        nbr[..., 1] = nbr[..., 0]
        return sound(xyz, centers, nbr, feats, rk, sigma, A)

    for label, fns in (("sound", (sound, ones)),
                       ("plain inter-conv", (interconv.interconv_t_torch,
                                             interconv.interconv_ones_torch)),
                       ("dropped neighbour", (dropped, ones))):
        interconv.interconv_t_cuda, interconv.interconv_ones_cuda = fns
        try:
            loss, grads = step("cuda")
        finally:
            interconv.interconv_t_cuda, interconv.interconv_ones_cuda = sound, ones
        readings[label] = (abs(loss - cpu_loss) / abs(cpu_loss), *gradient_error(torch, grads, cpu_grads))
    for label, (lr, med, p90, mx, leaf) in readings.items():
        print(f"train step N=1024 B=2 f32, card ({label}) vs CPU: loss rel err {lr:.3g}, "
              f"gradient leaves' rel err median {med:.3g}, 90th pct {p90:.3g}, max {mx:.3g} "
              f"({leaf})")
    print(f"  (the CPU step took {cpu_s:.1f} s; limits: loss {TRAIN_LOSS_RTOL}, median "
          f"{TRAIN_GRAD_LIMIT})")
    lr, med = readings["sound"][:2]
    if not (lr <= TRAIN_LOSS_RTOL and med <= TRAIN_GRAD_LIMIT):
        raise AssertionError(f"train step card vs CPU: loss rel err {lr}, median {med}")
    lr, med = readings["dropped neighbour"][:2]
    if lr <= TRAIN_LOSS_RTOL or med <= TRAIN_GRAD_LIMIT:
        raise AssertionError("train step card vs CPU: a dropped neighbour passes the limits")


def full_width_train(torch, _build, timed_keys):
    """Phase 7 (c): make_train_step at EtchConfig(), B=8, N=5000 on capsule
    clouds with analytic ground truth: a warm step, then TRAIN_TIMED_STEPS
    timed ones.  Returns {kernel: launches a step}."""
    from etch_tpu_torch.train.state import create_train_state, make_train_step
    from etch_tpu_torch.train.synthetic import make_batch
    from etch_tpu_torch.utils.config import EtchConfig

    cfg = EtchConfig(num_point=N, batch_size=B)
    model, state, opt = create_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(model, opt, cfg)
    batch = make_batch(np.random.RandomState(1), B, N)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    marks, hooks = {}, []

    def mark(name):
        def record(*_):
            marks[name] = torch.cuda.Event(enable_timing=True)
            marks[name].record()
        return record

    hooks += [model.register_forward_pre_hook(mark("start")),
              model.register_forward_hook(mark("forward")),
              opt.register_step_pre_hook(mark("backward")),
              opt.register_step_post_hook(mark("optimizer"))]
    _build.reset_launch_counts()
    times, split, losses = [], [], None
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        state, losses = step(state, batch)
        mark("end")()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        split.append({k: marks[a].elapsed_time(marks[k]) for a, k in
                      (("start", "forward"), ("forward", "backward"), ("backward", "optimizer"),
                       ("optimizer", "end"))})
    launches = dict(_build.launches)
    shapes = {k: dict(v) for k, v in _build.shape_launches.items()}
    for h in hooks:
        h.remove()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ran = {k for k, v in launches.items() if v}
    if ran != set(PATH_KERNELS["train_f32"]):
        raise AssertionError(f"train step: kernels launched {sorted(ran)}, expected "
                             f"{sorted(PATH_KERNELS['train_f32'])}")
    untimed = {k: sorted(set(v) - timed_keys[k]) for k, v in shapes.items() if set(v) - timed_keys[k]}
    if untimed:
        raise AssertionError(f"train step: launches at shapes phase 3 did not time: {untimed}")
    if not all(torch.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"train step: losses {losses}")
    med = {k: statistics.median(s[k] for s in split) for k in split[0]}
    per_step = {k: v / TRAIN_TIMED_STEPS for k, v in launches.items() if v}
    print(f"train step B={B} N={N} f32 (EtchConfig()): warm {warm:.1f} s, timed ms "
          f"{[round(t, 2) for t in times]}, median {statistics.median(times):.2f} ms/step; "
          f"device ms (median): forward {med['forward']:.2f}, loss + backward "
          f"{med['backward']:.2f}, Adam {med['optimizer']:.2f}, guard {med['end']:.2f}; peak "
          f"memory {peak:.2f} GiB; losses "
          f"{json.dumps({k: round(float(v), 5) for k, v in losses.items()})}")
    print(f"  launches a train step: {json.dumps(per_step)}")
    for k in sorted(shapes):
        for key, n in sorted(shapes[k].items(), key=str):
            print(f"    {k:17s} x{n / TRAIN_TIMED_STEPS:g}/step {key}")
    del model, state, opt
    torch.cuda.empty_cache()
    return per_step


def bf16_train_step(torch, _build):
    """Phase 7 (c), bf16: one train step of EtchConfig(use_bfloat16=True) at
    N=1024, B=2 on the card: finite losses and gradients, and exactly the
    bf16 training kernel set (no kernel without a backward)."""
    from etch_tpu_torch.train.state import create_train_state, make_train_step
    from etch_tpu_torch.train.synthetic import make_batch
    from etch_tpu_torch.utils.config import EtchConfig

    cfg = EtchConfig(num_point=1024, batch_size=2, use_bfloat16=True)
    model, state, opt = create_train_state(cfg, seed=0, device="cuda")
    _build.reset_launch_counts()
    _, losses = make_train_step(model, opt, cfg)(state, make_batch(np.random.RandomState(7), 2, 1024))
    torch.cuda.synchronize()
    launches = {k: v for k, v in _build.launches.items() if v}
    if set(launches) != set(PATH_KERNELS["train_bf16"]):
        raise AssertionError(f"bf16 train step: kernels launched {sorted(launches)}")
    if not (all(torch.isfinite(v) for v in losses.values())
            and all(torch.isfinite(p.grad).all() for p in model.parameters())):
        raise AssertionError(f"bf16 train step: losses {losses}")
    print(f"bf16 train step N=1024 B=2: losses "
          f"{json.dumps({k: round(float(v), 5) for k, v in losses.items()})}; launches "
          f"{json.dumps(launches)}")


def nan_guard_on_card(torch):
    """Phase 7 (d): a NaN batch leaves the parameters and Adam's state
    bit-unchanged on the card while the BatchNorm statistics advance; a
    clean batch then moves them (EtchConfig.tiny, N=512, B=2)."""
    from etch_tpu_torch.train.state import create_train_state, make_train_step
    from etch_tpu_torch.train.synthetic import make_batch
    from etch_tpu_torch.utils.config import EtchConfig

    cfg = EtchConfig.tiny(num_point=512, batch_size=2)
    model, state, opt = create_train_state(cfg, seed=0, device="cuda")
    step = make_train_step(model, opt, cfg)
    clean = make_batch(np.random.RandomState(2), 2, 512)
    state, _ = step(state, clean)

    def snapshot():
        out = []
        for p in model.parameters():
            st = opt.state[p]
            out += [p.detach().clone(), st["exp_avg"].clone(), st["exp_avg_sq"].clone(),
                    st["step"].clone()]
        return out

    before = snapshot()
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    state, losses = step(state, dict(clean, vectors=np.full_like(clean["vectors"], np.nan)))
    if torch.isfinite(losses["all_loss"]):
        raise AssertionError("NaN guard: the NaN batch's loss is finite")
    if not all(torch.equal(a, b) for a, b in zip(before, snapshot())):
        raise AssertionError("NaN guard: a parameter or Adam state moved on a NaN batch")
    if all(torch.equal(v, model.state_dict()[k]) for k, v in stats.items()):
        raise AssertionError("NaN guard: the BatchNorm statistics did not advance")
    state, losses = step(state, clean)
    after = snapshot()
    moved = [any(not torch.equal(a, b) for a, b in zip(before[i::4], after[i::4])) for i in range(4)]
    if not (torch.isfinite(losses["all_loss"]) and all(moved) and int(state.step) == 3):
        raise AssertionError(f"NaN guard: a clean batch moved {moved}, step {int(state.step)}")
    print("NaN guard on the card: parameters, exp_avg, exp_avg_sq and Adam's step bit-unchanged "
          "on a NaN batch, BatchNorm statistics advanced; a clean batch moved all four")


def train_cli(torch, tmp):
    """Phase 7 (e): `cli.train` on the repository's 4D-DRESS sample (two
    epochs, B=1, N=5000, f32) into `tmp`, then its last checkpoint served:
    the same forward as the trained model, and run_scan's files.  Returns
    the checkpoint directory."""
    from etch_tpu_torch.cli import train
    from etch_tpu_torch.data import proximity
    from etch_tpu_torch.pipeline import build_pipeline, load_markerset
    from etch_tpu_torch.utils.config import EtchConfig

    root = os.path.dirname(os.path.abspath(__file__))
    scan_dir, smpl_dir, info_dir, ids = (os.path.join(root, p) for p in SAMPLE)
    t0 = time.perf_counter()
    out, state = train.main([
        "--epochs", "2", "--batch_size", "1", "--num_workers", "0", "--device", "cuda",
        "--output_folder", os.path.join(tmp, "exp"), "--scan_dir", scan_dir,
        "--smpl_dir", smpl_dir, "--infopoints_dir", info_dir, "--activated_ids_path", ids,
        "--markerset_path", os.path.join(root, MARKERSET_PATH)])
    cli_s = time.perf_counter() - t0
    ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
    if ckpts != ["0.pt", "1.pt"]:
        raise AssertionError(f"cli/train wrote checkpoints {ckpts}")
    with open(os.path.join(out, "log_all", "metrics.jsonl")) as fh:
        rows = [json.loads(line) for line in fh]
    pipe = build_pipeline(EtchConfig(epochs=2), load_markerset(os.path.join(root, MARKERSET_PATH)),
                          checkpoint_path=os.path.join(out, "checkpoints"),
                          allow_synthetic_body=True, device="cuda")
    pts = torch.from_numpy(capsule_clouds(1, N, seed=9)).cuda()
    with torch.no_grad():
        a, b = pipe.model(pts), state.model(pts)
    diff = max((a[k] - b[k]).abs().max().item() / (1 + b[k].abs().max().item()) for k in a)
    if not diff <= 1e-6:
        raise AssertionError(f"served checkpoint: forward differs from the trained model's by {diff}")
    scan = os.path.join(root, SCAN)
    result = pipe.run_scan(scan, seed=0)
    obj, npz = pipe.export(result, scan, os.path.join(tmp, "served"))
    if not (os.path.isfile(obj) and np.isfinite(np.load(npz)["joints"]).all()):
        raise AssertionError(f"served checkpoint: run_scan wrote {obj}, {npz}")
    print(f"cli/train (2 epochs, B=1, N={N}, f32, the bundled sample): {cli_s:.1f} s; epoch "
          f"losses {[round(r['all_loss'], 5) for r in rows]}; epoch seconds "
          f"{[round(r['epoch_time_s'], 2) for r in rows]}; ground truth's proximity backend: "
          f"{proximity.last_backend}; the last checkpoint served through build_pipeline: "
          f"forward {diff:.3g} from the trained model's, run_scan wrote {os.path.basename(obj)} and "
          f"{os.path.basename(npz)}")
    return os.path.join(out, "checkpoints")


def train_phase(torch, _build, timed, tmp):
    """Phase 7; returns ({kernel: launches a full-width train step},
    {kernel: its Function's backward ms}, the checkpoint directory that
    cli.train wrote under `tmp`)."""
    print("training:")
    backward_ms = function_checks(torch, torch.device("cuda", 0))
    train_step_card_vs_cpu(torch)
    per_step = full_width_train(torch, _build, timed)
    bf16_train_step(torch, _build)
    nan_guard_on_card(torch)
    ckpt = train_cli(torch, tmp)
    return per_step, backward_ms, ckpt


def data_parallel_phase(torch, _build, timed, tmp):
    """Phase 9: (a) one f32 train step of EtchConfig() on one B=8, N=5000
    batch of capsule clouds, in two gloo ranks on the card (B=4 each,
    tools/torch_parallel_check.py) against one rank: loss, gradients and
    BatchNorm statistics, then DP_TIMED_STEPS more steps for the ranks' ms
    a step and peak memory; the same step with the gradients summed and
    with per-rank BatchNorm must fail; (b) `cli.train_mixed` at world size
    1 for one epoch on the bundled item given twice, with and without the
    dynamic labels: its files, the f32 kernel set at shapes phase 3 timed."""
    from etch_tpu_torch.cli import train_mixed
    from etch_tpu_torch.train.state import ZERO_GRADIENT
    from etch_tpu_torch.train.synthetic import make_batch
    from etch_tpu_torch.utils.config import EtchConfig
    from tools import torch_parallel_check as check

    print("data parallel:")
    cfg = EtchConfig(num_point=N, batch_size=B)
    batch = make_batch(np.random.RandomState(3), B, N)
    flipped = {k: np.ascontiguousarray(np.concatenate([v[B // 2:], v[:B // 2]]))
               for k, v in batch.items()}
    t0 = time.perf_counter()
    single = check.run(1, cfg, [batch], device="cuda")[0][0]
    floor = check.compare(check.run(1, cfg, [flipped], device="cuda")[0], single, ZERO_GRADIENT)
    torch.cuda.empty_cache()
    fault_names = ("sum", "local_bn")
    ranks, *faulty = check.run(2, cfg, [batch], faults=(None,) + fault_names, device="cuda",
                               backend="gloo", timed_steps=DP_TIMED_STEPS, threads=4)
    got = check.compare(ranks, single, ZERO_GRADIENT)
    faults = {f: check.compare(r, single, ZERO_GRADIENT) for f, r in zip(fault_names, faulty)}
    fmt = lambda c: ", ".join(f"{k} {c[k]:.3g}" for k in
                              ("loss", "grads_global", "grads", "buffers", "ranks_apart"))
    print("  gloo refuses CUDA tensors in this build: the reductions are staged through "
          "pinned host copies; the compute stays on the card" if ranks[0]["staged"] else
          "  gloo takes CUDA tensors in this build: no staging")
    print(f"  2 gloo ranks on {ranks[0]['device']} (B=4 each) against 1 rank (B=8), f32, "
          f"N={N}, first step: {fmt(got)}")
    print(f"  1 rank with the batch's halves swapped (the floor): {fmt(floor)}")
    for f, c in faults.items():
        print(f"  planted fault {f}: {fmt(c)}")
    print(f"  ms a step (median of {DP_TIMED_STEPS}, each rank B=4): "
          f"{[round(r['step_ms'], 2) for r in ranks]}, with {ranks[0]['collectives']} "
          f"all-reduces a step; peak memory a rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; limits: loss {DP_LOSS_RTOL}, "
          f"gradients {DP_GRAD_LIMIT}, BatchNorm {DP_BUFFER_LIMIT}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not (got["loss"] <= DP_LOSS_RTOL and got["grads_global"] <= DP_GRAD_LIMIT
            and got["buffers"] <= DP_BUFFER_LIMIT and got["ranks_apart"] == 0.0):
        raise AssertionError(f"data parallel step against one rank: {got}")
    caught = [f for f, c in faults.items() if c["grads_global"] > DP_GRAD_LIMIT]
    if caught != list(faults):
        raise AssertionError(f"data parallel: planted faults passed the limits: {faults}")

    root = os.path.dirname(os.path.abspath(__file__))
    scan_dir, smpl_dir, info_dir, ids = (os.path.join(root, p) for p in SAMPLE)
    spec = ":".join((scan_dir, smpl_dir, info_dir, ids))
    for dynamic in (False, True):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out, state = train_mixed.main(
            ["--dataset_spec", spec, spec, "--epochs", "1", "--batch_size", "1",
             "--num_workers", "0", "--device", "cuda", "--markerset_path",
             os.path.join(root, MARKERSET_PATH),
             "--output_folder", os.path.join(tmp, f"mixed_{dynamic}")]
            + (["--use_dynamic_label_confidence"] if dynamic else []))
        secs = time.perf_counter() - t0
        ran = {k for k, v in _build.launches.items() if v}
        untimed = {k: sorted(set(v) - timed[k]) for k, v in _build.shape_launches.items()
                   if set(v) - timed[k]}
        with open(os.path.join(out, "log_all", "metrics.jsonl")) as fh:
            rows = [json.loads(line) for line in fh]
        files = sorted(os.listdir(out)), os.listdir(os.path.join(out, "checkpoints"))
        if files != (["checkpoints", "log_all", "training_args.json"], ["0.pt"]):
            raise AssertionError(f"cli/train_mixed wrote {files}")
        if ran != set(PATH_KERNELS["train_f32"]) or untimed:
            raise AssertionError(f"cli/train_mixed: kernels {sorted(ran)}, untimed {untimed}")
        if int(state.step) != 2 or not np.isfinite(rows[0]["all_loss"]):
            raise AssertionError(f"cli/train_mixed: {int(state.step)} steps, log {rows}")
        print(f"  cli/train_mixed (world size 1, 1 epoch over the bundled item twice, B=1, "
              f"N={N}, f32, dynamic labels {dynamic}): {secs:.1f} s, loss "
              f"{rows[0]['all_loss']:.5f}, launches {json.dumps(dict(_build.launches))}")


def fit_problem(torch, dev):
    """Phase 10's problem: the synthetic body at FIT_VERTS vertices posed by
    seeded parameters, its vertices (1, V, 3), a scan of FIT_SCAN points
    on its surface moved 5 mm off at random (no point on a vertex), its
    face centroids (1, F, 3) and the body."""
    from etch_tpu_torch.body.smpl import smpl_forward, synthetic_body_model

    body = synthetic_body_model(n_verts=FIT_VERTS).to(dev)
    rng = np.random.RandomState(11)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    params = (t(rng.randn(1, 10) * 0.5), t(rng.randn(1, 69) * 0.05), t([[0.1, -0.2, 0.15]]),
              t([[0.05, 0.1, -0.08]]))
    with torch.no_grad():
        verts, _ = smpl_forward(body, *params)
    tri = verts[0][torch.as_tensor(body.faces, dtype=torch.long, device=dev)]   # (F, 3, 3)
    face = rng.randint(0, tri.shape[0], FIT_SCAN)
    bary = t(rng.dirichlet([1.0, 1.0, 1.0], FIT_SCAN))
    scan = (bary[:, :, None] * tri[torch.as_tensor(face, device=dev)]).sum(1)
    scan = scan + t(rng.randn(FIT_SCAN, 3) * 5e-3)
    return {"body": body, "verts": verts.contiguous(), "scan": scan[None].contiguous(),
            "centroids": tri.mean(1)[None].contiguous()}


def fit_extras_phase(torch, _build, timed):
    """Phase 10: the fit's extras on the card, on `fit_problem`: `fit_smpl`
    (markers from inner points about 86 vertices, the two-stage LM, SMPL)
    against the CPU; `point_mesh_distance` (kNN kernel, k=8) and
    `chamfer_refine` from that fit (CHAMFER_ITERATIONS, both ways, the
    synthetic GMM prior; kNN kernel, k=1 each way) against the same calls
    with the plain kNN on the card, each kernel launch counted at a shape
    phase 3 timed; `fit_smpl_adam` (40 + 80 steps) against the CPU.
    Prints the seconds of each call."""
    from etch_tpu_torch.body.smpl import marker_forward, marker_submodel, smpl_forward
    from etch_tpu_torch.fit.adam import fit_smpl_adam
    from etch_tpu_torch.fit.chamfer_refine import chamfer_refine
    from etch_tpu_torch.fit.prior import synthetic_gmm
    from etch_tpu_torch.fit.smpl_fit import fit_smpl
    from etch_tpu_torch.ops.point_mesh import point_mesh_distance
    kn = importlib.import_module("etch_tpu_torch.ops.knn")

    print("the fit's extras:")
    dev = torch.device("cuda", 0)
    fit = fit_problem(torch, dev)
    body, cpu_body = fit["body"], fit["body"].to("cpu")
    vids = np.linspace(0, FIT_VERTS - 1, 86).astype(np.int32)
    rng = np.random.RandomState(12)
    inner = (fit["verts"][0, vids].repeat_interleave(4, 0)
             + torch.as_tensor(rng.randn(86 * 4, 3) * 2e-3, dtype=torch.float32, device=dev))[None]
    labels = torch.arange(86, device=dev).repeat_interleave(4)[None]
    conf = torch.as_tensor(rng.rand(1, 86 * 4, 1), dtype=torch.float32, device=dev)

    def timed_call(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def plain_knn(fn):
        sound = kn.knn_cuda
        kn.knn_cuda = kn.knn_torch
        try:
            return fn()
        finally:
            kn.knn_cuda = sound

    def counted(fn, want):
        """fn() with the launch counts set to 0 just before and read just
        after: only kNN, `want` times at each shape, each timed."""
        _build.reset_launch_counts()
        out = timed_call(fn)
        shapes = {k: dict(v) for k, v in _build.shape_launches.items() if v}
        if set(shapes) != {"knn"} or set(shapes["knn"].values()) != {want}:
            raise AssertionError(f"launches {shapes}, expected kNN x{want} at each shape")
        if set(shapes["knn"]) - timed["knn"]:
            raise AssertionError(f"kNN at shapes phase 3 did not time: {shapes}")
        return out, shapes["knn"]

    with torch.no_grad():
        (verts, params, mk, valid, _), fit_s = timed_call(
            lambda: fit_smpl(body, vids, inner, labels, conf))
        cpu = fit_smpl(cpu_body, vids, inner.cpu(), labels.cpu(), conf.cpu())
    fit_err = (verts.cpu() - cpu[0]).abs().max().item()
    marker_err = (verts[0, vids] - fit["verts"][0, vids]).norm(dim=-1).max().item()
    print(f"  fit_smpl (86 markers, LM 30 + 50, V={FIT_VERTS}): {fit_s:.2f} s; vertices "
          f"{fit_err:.3g} m from the CPU's; fitted markers within {marker_err:.3g} m of the "
          f"posed body's")
    if not fit_err <= FIT_TOL:
        raise AssertionError(f"fit_smpl: card and CPU vertices {fit_err} apart")

    with torch.no_grad():
        (d, pmd_s), pmd_shapes = counted(
            lambda: point_mesh_distance(fit["scan"], verts, body.faces, k=8), 1)
        d_plain = plain_knn(lambda: point_mesh_distance(fit["scan"], verts, body.faces, k=8))
    if not torch.equal(d, d_plain) or not torch.isfinite(d).all():
        raise AssertionError("point_mesh_distance: the kNN kernel's distances differ from "
                             "the plain kNN's")
    print(f"  point_mesh_distance ({FIT_SCAN} points, k=8 of {fit['centroids'].shape[1]} "
          f"faces): {pmd_s * 1e3:.2f} ms; equal to the plain kNN's; median "
          f"{d.median().item() * 1e3:.3f} mm; kNN launches {pmd_shapes}")

    prior = synthetic_gmm().to(dev)
    init = (params["pose"], params["betas"], params["global_orient"], params["transl"])
    refine = lambda: chamfer_refine(body, fit["scan"][0], *init, prior=prior,
                                    iterations=CHAMFER_ITERATIONS, bidirectional=True)
    (ref, ch_s), ch_shapes = counted(refine, CHAMFER_ITERATIONS)
    plain = plain_knn(refine)
    with torch.no_grad():
        v_ref, _ = smpl_forward(body, ref["betas"], ref["pose"], ref["orient"], ref["transl"])
        v_plain, _ = smpl_forward(body, plain["betas"], plain["pose"], plain["orient"],
                                  plain["transl"])
    ch_err = (v_ref - v_plain).abs().max().item()
    loss_err = abs(ref["final_loss"].item() - plain["final_loss"].item()) / abs(
        plain["final_loss"].item())
    moved = (v_ref - verts).norm(dim=-1).mean().item()
    print(f"  chamfer_refine ({CHAMFER_ITERATIONS} iterations, both ways, prior): {ch_s:.2f} s "
          f"({ch_s / CHAMFER_ITERATIONS * 1e3:.2f} ms an iteration); final loss "
          f"{ref['final_loss'].item():.6f}, {loss_err:.3g} from the plain kNN's, vertices "
          f"{ch_err:.3g} m from its; moved the fit {moved * 1e3:.3f} mm; kNN launches "
          f"{ch_shapes}")
    if not (ch_err <= FIT_TOL and loss_err <= FIT_LOSS_RTOL):
        raise AssertionError(f"chamfer_refine: kernel and plain kNN {ch_err} m, loss {loss_err}")

    sub = marker_submodel(body, vids)
    adam, adam_s = timed_call(lambda: fit_smpl_adam(sub, mk, valid, 40, 80))
    cpu_adam = fit_smpl_adam(marker_submodel(cpu_body, vids), mk.cpu(), valid.cpu(), 40, 80)
    with torch.no_grad():
        fwd = lambda s, p: marker_forward(s, p["betas"], p["pose"], p["global_orient"],
                                          p["transl"])
        adam_err = (fwd(sub, adam).cpu() - fwd(marker_submodel(cpu_body, vids), cpu_adam)
                    ).abs().max().item()
    adam_loss = abs(adam["final_loss"].item() - cpu_adam["final_loss"].item()) / abs(
        cpu_adam["final_loss"].item())
    print(f"  fit_smpl_adam (40 + 80 steps): {adam_s:.2f} s; markers {adam_err:.3g} m and "
          f"final loss {adam_loss:.3g} (relative) from the CPU's")
    if not (adam_err <= FIT_TOL and adam_loss <= 1e-2):
        raise AssertionError(f"fit_smpl_adam: card and CPU {adam_err} m, loss {adam_loss}")


def evaluate_phase(torch, _build, timed, ckpt, tmp):
    """Phase 8: `python -m etch_tpu_torch.cli.evaluate` (its `main`) on the
    repository's 4D-DRESS sample at EtchConfig(), N=5000, B=1, f32, with the
    checkpoint of phase 7 (e), the synthetic body and the debug exports, in
    a working directory under `tmp`; then `cli.compute_mpjpe` on its
    outputs against the sample's GT joints."""
    import contextlib
    import io
    import pickle

    from etch_tpu_torch.cli import compute_mpjpe, evaluate
    from etch_tpu_torch.data.mesh import load_obj, load_ply

    root = os.path.dirname(os.path.abspath(__file__))
    scan_dir, smpl_dir, info_dir, _ = (os.path.join(root, p) for p in SAMPLE)
    sample = os.path.splitext(os.path.basename(SCAN))[0]
    work = os.path.join(tmp, "eval")
    os.makedirs(work)
    ids = os.path.join(work, "ids.pkl")
    with open(ids, "wb") as fh:
        pickle.dump([sample], fh)
    cwd = os.getcwd()
    os.chdir(work)   # evaluate writes under all_experiments/ in the working directory
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        res = evaluate.main([
            "--num_point", str(N), "--batch_size", "1", "--num_workers", "0", "--i", "smoke",
            "--markerset_path", os.path.join(root, MARKERSET_PATH), "--activated_ids_path", ids,
            "--scan_dir", scan_dir, "--smpl_dir", smpl_dir, "--infopoints_dir", info_dir,
            "--model_path", ckpt, "--allow_synthetic_body", "--save_debug", "--device", "cuda"])
        eval_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    launches = dict(_build.launches)
    shapes = {k: dict(v) for k, v in _build.shape_launches.items()}
    ran = {k for k, v in launches.items() if v}
    if ran != set(PATH_KERNELS["f32"]):
        raise AssertionError(f"cli/evaluate: kernels launched {sorted(ran)}, expected "
                             f"{sorted(PATH_KERNELS['f32'])}")
    untimed = {k: sorted(set(v) - timed[k]) for k, v in shapes.items() if set(v) - timed[k]}
    if untimed:
        raise AssertionError(f"cli/evaluate: launches at shapes phase 3 did not time: {untimed}")

    out = os.path.join(work, res["output_folder"])
    d = os.path.join(out, sample)
    with open(os.path.join(out, "v2v_score.txt")) as fh:
        lines = fh.read().splitlines()
    if len(lines) != 5 or not lines[0].startswith(f"{sample}: ") or lines[1] != "==========" \
            or lines[4] != "sample num: 1":
        raise AssertionError(f"cli/evaluate: v2v_score.txt reads {lines}")
    v2v = float(lines[0].split(": ")[1].split()[0])
    if lines[2] != f"average v2v: {v2v}" or lines[3] != f"total v2v: {v2v}":
        raise AssertionError(f"cli/evaluate: v2v_score.txt reads {lines}")
    # V2V recomputed in float64 from the exported OBJ (8 decimals: each
    # vertex within sqrt(3) * 5e-9 m of the f32 one) and the GT mesh
    verts = load_obj(os.path.join(d, f"forwarded_smpl_mesh_on_pred_{sample}.obj")).vertices
    gt = load_obj(os.path.join(smpl_dir, sample, f"mesh_smpl_{sample}.obj")).vertices
    again = float(np.mean(np.linalg.norm(gt - verts, axis=1)))
    if verts.shape != (6890, 3) or not abs(again - v2v) <= 1e-8:
        raise AssertionError(f"cli/evaluate: V2V {v2v} written, {again} from the exported mesh")
    info = np.load(os.path.join(d, f"output_smpl_info_{sample}.npz"))
    got = {k: info[k].shape for k in info.files}
    if got != NPZ_SHAPES or not all(np.isfinite(info[k]).all() for k in info.files):
        raise AssertionError(f"cli/evaluate: output_smpl_info npz {got}")
    dbg = np.load(os.path.join(d, f"tightness_vectors_info_{sample}.npz"))
    want = {"hitpts": (N, 3), "pred_vectors": (N, 3), "pred_part_labels": (N,),
            "pred_confidences": (N, 1), "gt_vectors": (N, 3), "gt_labels": (N,),
            "gt_confidences": (N, 1)}
    got = {k: dbg[k].shape for k in dbg.files}
    if got != want:
        raise AssertionError(f"cli/evaluate: tightness_vectors_info npz {got}")
    plys = sorted(f for f in os.listdir(d) if f.endswith(".ply"))
    if len(plys) != 5:
        raise AssertionError(f"cli/evaluate: debug PLYs {plys}")
    for f in plys:
        pts = load_ply(os.path.join(d, f))
        if pts.shape != (N, 3) or not np.isfinite(pts).all():
            raise AssertionError(f"cli/evaluate: {f} reads back {pts.shape}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        compute_mpjpe.main(["--pred_dir", out, "--gt_dir", smpl_dir])
    mpjpe = [float(line.split()[-1]) for line in text.getvalue().splitlines()
             if line.startswith("mean MPJPE:")]
    if len(mpjpe) != 1 or not np.isfinite(mpjpe[0]):
        raise AssertionError(f"cli/compute_mpjpe printed {text.getvalue()!r}")
    sec = res["seconds"]
    print(f"cli/evaluate (B=1, N={N}, f32, the phase 7 checkpoint, synthetic body, debug "
          f"exports): {eval_s:.2f} s for the scan, first call in the process (dataset load "
          f"{sec['load']:.2f} s, pipeline build {sec['build']:.2f} s, forward "
          f"{sec['forward']:.2f} s, fit {sec['fit']:.2f} s, export {sec['export']:.2f} s); V2V {v2v:.6f} m, equal to the exported mesh's within "
          f"{abs(again - v2v):.2g} m; {len(plys)} debug PLYs of {N} points read back; MPJPE "
          f"{mpjpe[0]:.6f} m (cli/compute_mpjpe); launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}, each at a shape phase 3 timed")


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
    t0 = time.perf_counter()
    kernels = compare_kernels(torch, dev)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

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
    for label, overrides, path, seeds in DEEP_STEPS:
        small_step(torch, _build, label, deep_config(overrides), path, full_width=True,
                   seeds=seeds)
    print(f"small-input reference phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()

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
    print(f"main-path phase: {time.perf_counter() - t0:.1f} s")

    # 6. the single-scan entry point
    t0 = time.perf_counter()
    entry_point(torch, _build)
    print(f"entry-point phase: {time.perf_counter() - t0:.1f} s")

    timed = {k: {e["key"] for e in v["shapes"]} for k, v in kernels.items()}
    with tempfile.TemporaryDirectory() as tmp:
        # 7. training
        t0 = time.perf_counter()
        train_launches, backward_ms, ckpt = train_phase(torch, _build, timed, tmp)
        print(f"training phase: {time.perf_counter() - t0:.1f} s")

        # 8. evaluation, with phase 7's checkpoint
        t0 = time.perf_counter()
        evaluate_phase(torch, _build, timed, ckpt, tmp)
        print(f"evaluation phase: {time.perf_counter() - t0:.1f} s")

        # 9. data parallel
        t0 = time.perf_counter()
        data_parallel_phase(torch, _build, timed, tmp)
        print(f"data-parallel phase: {time.perf_counter() - t0:.1f} s")

    # 10. the fit's extras
    t0 = time.perf_counter()
    fit_extras_phase(torch, _build, timed)
    print(f"fit extras phase: {time.perf_counter() - t0:.1f} s")

    idle = [name for name in SOURCES if not launches.get(name)]
    if idle:
        raise AssertionError(f"kernels never launched on a path: {idle}")
    print("launches a request at each timed shape, counted on the main paths:")
    per_shape_launches(kernels, counted, counted_on)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"etch_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches[name],
         "launches_per_request": per_request[name][0], "launch_path": per_request[name][1],
         "train_launches_per_step": train_launches.get(name, 0),
         "train_backward_ms": backward_ms.get(name), **kernels[name]}
        for name, (src, replaces) in SOURCES.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
