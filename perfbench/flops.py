"""Analytic FLOP model of one ETCH scan, frozen for the benchmark.

A copy of `tools/flops_report.py` (its forward and fit model), reading the
EPN schedule from the frozen `reference/plan.py`.  It counts the
architecture's mathematics from the configuration's shapes (1 multiply-add
= 2 FLOPs), so it reads the same work whichever kernel computes it: 187.28
GFLOP forward and 1.57 GFLOP fit a scan at N=5000 and the reference widths.
"""

from __future__ import annotations

from perfbench.reference.plan import backbone_plan

A = 60         # icosahedral anchors
INTRA_NN = 12  # intra-conv anchor adjacency


def epn_flops(cfg: dict) -> float:
    """EPN encoder: ball query, kernel weights, contraction, projection,
    intra conv and skip conv of every conv."""
    total = 0.0
    K = {1: 24, 2: 30, 3: 66}[cfg.get("epn", {}).get("kernel_size", 1)]
    for block in backbone_plan(cfg):
        for conv in block:
            P2, nn, n_in = conv["n_out"], conv["n_neighbor"], conv["n_in"]
            Cin, Cout = conv["dim_in"], conv["dim_out"]
            total += P2 * n_in * 4
            total += P2 * nn * A * K * 8
            total += 2 * P2 * nn * A * K * Cin
            total += 2 * P2 * A * K * Cin * Cout
            total += 2 * P2 * A * INTRA_NN * Cout * Cout
            total += 2 * P2 * A * Cin * Cout
    return total


def pt_unet_flops(N, planes, blocks, strides, nsamples, share=8, in_dim=3843):
    """Point Transformer U-Net: per vector-attention layer the q/k/v
    linears, the position MLP, the weight MLP, softmax and aggregation and
    the out linear; transitions down and up; the final classifier."""
    total = 2 * N * in_dim * planes[0]
    n = N
    enc_ns = []
    for lvl, (p, b, s, ns) in enumerate(zip(planes, blocks, strides, nsamples)):
        p_prev = planes[0] if lvl == 0 else planes[lvl - 1]
        if s > 1:
            m = max(1, n // s)
            total += m * n * 4
            total += m * ns * 2 * p_prev * p
            n = m
        enc_ns.append(n)
        for _ in range(b):
            total += 3 * 2 * n * p * p
            total += n * ns * (2 * 3 * p + 2 * p * p)
            total += n * ns * (2 * p * (p // share))
            total += n * ns * 4 * p
            total += 2 * n * p * p
        total += n * n * 4
    for lvl in range(len(planes) - 1, 0, -1):
        p, p_out, n_hi = planes[lvl], planes[lvl - 1], enc_ns[lvl - 1]
        total += n_hi * enc_ns[lvl] * 4
        total += 2 * n_hi * 3 * p
        total += 2 * n_hi * p * p_out
        total += 3 * 2 * n_hi * p_out * p_out + \
            n_hi * nsamples[lvl - 1] * (2 * 3 * p_out + 2 * p_out * p_out
                                        + 2 * p_out * (p_out // share) + 4 * p_out) + \
            2 * n_hi * p_out * p_out
    total += 2 * N * planes[0] * planes[0]
    return total


def direction_head_flops(N, E=64, V=128, L=A, layers=2):
    """MHSA direction head: per point, L anchor tokens."""
    per_pt = 0.0
    for li in range(layers):
        out = V if li == layers - 1 else E
        per_pt += 3 * 2 * L * E * E + 2 * L * L * E + 5 * L * L + 2 * L * L * E + 2 * L * E * out
    per_pt += 2 * L * V * V * 2 + 2 * L * V + L * 9 * 4 + 9 * 9 * 6
    return N * per_pt


def featprop_flops(N, M, C):
    return N * M * 4 + 2 * N * 3 * C


def forward_flops(cfg: dict) -> float:
    """FLOPs of one scan's network forward at the configuration's shapes."""
    N = cfg["num_point"]
    plan = backbone_plan(cfg)
    last = plan[-1][-1]
    kw = dict(blocks=cfg["unet_blocks"], strides=cfg["unet_strides"],
              nsamples=cfg["unet_nsamples"], in_dim=3 + last["dim_out"] * A)
    return (epn_flops(cfg)
            + direction_head_flops(N, last["dim_out"], cfg["dir_value_dim"],
                                   layers=cfg["dir_num_layers"])
            + pt_unet_flops(N, cfg["unet_planes_magnitude"], **kw)
            + pt_unet_flops(N, cfg["unet_planes_confidence"], **kw)
            + featprop_flops(N, last["n_out"], last["dim_out"] * A))


def fit_flops(cfg: dict, P: int = 85, M: int = 86) -> float:
    """FLOPs of one scan's LM fit on the marker submodel (jacfwd: P
    tangents and the primal; J^T J; the solve)."""
    steps = cfg["fit_steps_stage0"] + cfg["fit_steps_stage1"]
    lbs = M * 24 * 16 * 2 + M * 3 * 10 * 2 + 207 * M * 3 * 2 + 24 * 64
    return steps * (lbs * (P + 1) + 2 * (M * 3) * P * P + P ** 3 // 3 * 2)
