"""The serving loop: `InferencePipeline.run_batch` on batches of scans.

Set-up makes the weights and a pool of distinct batches from the seed,
builds the pipeline and serves one warm batch of the cell's shape.  The
window is a closed loop with one client: each batch is dispatched as soon
as the previous one's outputs are on the host, until `seconds` have
passed; the rate is every scan completed over the whole window.  After the
window, a batch drawn from the seed among those it finished is held to the
plain reference (`compare.serve_numbers`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import compare, core, inputs, trace
from perfbench.reference import fit as ref_fit
from perfbench.reference import net as ref_net

HOST_KEYS = ("vectors", "inner_points", "part_labels", "confidences", "markers",
             "markers_valid", "verts", "joints")


def to_host(out: dict) -> dict:
    host = {k: out[k].cpu() for k in HOST_KEYS}
    host["fit_params"] = {k: v.cpu() for k, v in out["fit_params"].items()}
    return host


def build(cell, seed: int, device):
    """(pipeline, the weights on the host, the input pool, the body, the
    marker ids, the sampling stream) for a seed."""
    from etch_tpu_torch.body.smpl import SMPLModel
    from etch_tpu_torch.models.etch_net import EtchNet
    from etch_tpu_torch.pipeline import InferencePipeline

    ss = inputs.seed_streams(seed, 3)
    tr = cell.traffic
    ecfg = core.etch_config(cell.config)
    model = EtchNet(ecfg)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in EtchNet(ecfg).state_dict().items()}
    weights = inputs.make_weights(shapes, inputs.torch_seed(ss[0]), device)
    model.to(device).load_state_dict(weights)
    body = inputs.synthetic_body()
    bt = inputs.body_tensors(body, "cpu")
    program_body = SMPLModel(v_template=bt["v_template"], shapedirs=bt["shapedirs"],
                             posedirs=bt["posedirs"], J_regressor=bt["J_regressor"],
                             lbs_weights=bt["lbs_weights"], parents=body["parents"],
                             faces=body["faces"], landmark_ids=body["landmark_ids"])
    vids = inputs.marker_vids(body["v_template"].shape[0])
    pipe = InferencePipeline(ecfg, model, program_body, vids, device)
    mesh = inputs.read_obj(core.ROOT / tr["scan"])
    rng = np.random.default_rng(ss[1])
    pool = [inputs.scan_clouds(mesh, tr["batch"], tr["points"], tr["vertical_axis"], rng)
            for _ in range(tr["pool"])]
    host_weights = {k: v.cpu() for k, v in weights.items()}
    del weights
    return pipe, host_weights, pool, body, vids, np.random.default_rng(ss[2])


def reference_check(cell, weights, body, vids, points, served, device,
                    control: str = None, chain: bool = False) -> dict:
    """The numbers of one served batch against the reference.  With
    `control` the reference itself, one precision below the configuration
    (fp8 network, TF32 fit), takes the program's place."""
    cfg = cell.config
    P = {k: v.to(device) for k, v in weights.items()}
    bt = inputs.body_tensors(body, device)
    pts = torch.as_tensor(points, device=device)
    if control is not None:
        low = ref_net.predict(P, cfg, pts, ref_net.Numerics("fp8"))
        with ref_net.Numerics("tf32").scope():
            verts = ref_fit.fit(bt, vids, cfg, low["inner_points"], low["part_labels"],
                                low["confidences"])[0]
        served = {**low, "verts": verts}
    served = {k: v.to(device) for k, v in served.items() if torch.is_tensor(v)}
    ref = ref_net.predict(P, cfg, pts)
    own = (ref_net.predict(P, cfg, pts, ref_net.Numerics(cfg["precision"]))
           if cfg["precision"] != "f32" else None)
    ref_verts = ref_fit.fit(bt, vids, cfg, served["inner_points"], served["part_labels"],
                            served["confidences"])[0]
    numbers = compare.serve_numbers(served, ref, ref_verts, own)
    if chain:   # how far the fit moves with the network's rounding, and with f32's
        own = ref_fit.fit(bt, vids, cfg, ref["inner_points"], ref["part_labels"],
                          ref["confidences"])[0]
        numbers["chain_verts_mm"] = float(
            torch.linalg.norm(served["verts"] - own, dim=-1).max()) * 1e3
        b64 = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point() else v)
               for k, v in bt.items()}
        f64 = ref_fit.fit(b64, vids, cfg, served["inner_points"].double(),
                          served["part_labels"], served["confidences"].double())[0]
        numbers["f64_verts_mm"] = float(
            torch.linalg.norm(ref_verts.double() - f64, dim=-1).max()) * 1e3
    return numbers


PROFILED_BATCHES = 1   # a batch issues some 33,000 launches: one is enough to profile


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float):
    from etch_tpu_torch import _build

    tr = cell.traffic
    B = tr["batch"]
    t_start = time.perf_counter()
    pipe, weights, pool, body, vids, pick = build(cell, seed, device)
    t_built = time.perf_counter()
    out = to_host(pipe.run_batch(pool[0]))           # warm: the cell's shape, built and run
    del out
    core.sync(device)
    setup_s = time.perf_counter() - t0
    core.log_setup(t0, t_start, t_built, time.perf_counter())

    spans = trace.Spans()
    clock = trace.serve_clock(pipe.model, spans) if traced else None
    host_ms, outs = [], []
    core.reset_peak(device)
    start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        if clock:
            clock.begin()
            spans.start("serve.fit")
        res = to_host(pipe.run_batch(pool[i % len(pool)]))
        if clock:
            spans.stop("serve.fit")
            clock.end()
        host_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(res)
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    core.log_calls("batch", host_ms)
    peak = core.peak_bytes(device)
    n_scans = B * len(outs)
    failed = sum(int((~torch.isfinite(o["verts"]).reshape(B, -1).all(-1)).sum()) for o in outs)
    result = {"metrics": {"scans_per_s": n_scans / window_s, "setup_s": setup_s,
                          "peak_mem_gib": peak / 2 ** 30},
              "attempted": n_scans, "failed": failed, "peak": peak}

    if traced:
        fwd = clock.elapsed_ms("fwd0", "fwd1")
        layer_ms = {"forward": fwd, "fit": [h - f for h, f in zip(host_ms, fwd)]}

        def one(j):
            clock.begin()
            spans.start("serve.fit")
            to_host(pipe.run_batch(pool[j % len(pool)]))
            spans.stop("serve.fit")
            clock.end()

        prof = trace.profile_calls(one, PROFILED_BATCHES, ("serve.fit", "serve.forward"),
                                   _build)
        clock.remove()
        result["record"] = dict(kind="serve", items_per_call=B, calls=len(outs),
                                window_s=window_s, layer_ms=layer_ms, profile=prof,
                                item_flops=None)

    k = int(pick.integers(len(outs)))
    served = outs[k]
    del pipe, outs
    core.free(device)
    result["numbers"] = reference_check(cell, weights, body, vids, pool[k % len(pool)], served,
                                        device)
    return result
