"""The ETCH network in plain PyTorch, float32: the benchmark's reference.

A frozen, functional copy of the f32 path of the port's network
(`models/etch_net.py`, `nn/epn.py`, `nn/point_transformer.py`, the plain
versions in `nn/interconv.py`, `nn/dircore.py`, `nn/attention.py`,
`nn/vector_attention.py` and `nn/grouped_head.py`), which follows the
reference (`src/models/models_pointcloud.py`, vgtk's SO(3) convs,
`pointtransformer_seg.py`, `direction_backbones.py`).  It reads the weights
from a state_dict by the port's names and imports nothing of the port.

Everything is f32 with TF32 off, and no kernel runs: this is the
mathematics that a bf16 or f32 program is held to.  `Numerics` lowers the
precision of every matmul operand for the control: float8 e4m3 with a
per-tensor scale ("fp8", one step below bf16) or TF32 library matmuls
("tf32", one step below f32).

`train=True` is the training forward: batch-statistic BatchNorms (flax's
rule), recorded in `Ctx.stats` for the caller to fold into the running
statistics, with the port's recomputation points (each 512-center chunk of
an inter conv, each U-Net block, each chunk of the direction core) so that
a B=8, N=5000 step fits the card.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.geometry import (get_anchors, get_intra_idx, get_kernel_points,
                                          project_to_so3)
from perfbench.reference.ops import (ball_query, fps, gather_points, group_points, knn,
                                     knn_interpolate)
from perfbench.reference.plan import backbone_plan

BN_EPS = 1e-5
CHUNK = 512            # inter-conv centers a chunk
GROUPED_ROWS = 8192    # grouped-head rows a block
FP8_MAX = 448.0        # largest float8 e4m3 value


class Numerics:
    """How the reference rounds the operands of its matrix products: exactly
    (f32, `kind=None`); "bf16" (bf16 operands, f32 sums: the scale of a
    bf16 configuration's own rounding); or for the control one precision
    below the configuration's: "fp8" (scaled float8 e4m3 operands, below
    bf16) or "tf32" (library matmuls in TF32, below f32 with TF32 off)."""

    def __init__(self, kind=None):
        if kind not in (None, "bf16", "fp8", "tf32"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "bf16":
            return x.to(torch.bfloat16).float()
        if self.kind != "fp8":
            return x
        s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    @contextlib.contextmanager
    def scope(self):
        """TF32 library products while inside, for "tf32"; f32 otherwise."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        tf32 = self.kind == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Ctx:
    """One forward's settings: the weights P (name -> tensor), the numerics,
    train mode, and the batch statistics a train forward records
    (buffer name -> batch value)."""

    def __init__(self, P, cfg: dict, train: bool = False, numerics: Numerics = None):
        self.P, self.cfg, self.train = P, cfg, train
        self.num = numerics or Numerics()
        self.stats = {}

    def remat(self, fn, *args):
        if self.train and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        return fn(*args)


# ---- shared layers ------------------------------------------------------


def linear(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """flax Dense with the torch (out, in) weight layout; bias if present."""
    y = ctx.num.mm(x, ctx.P[name + ".weight"].T)
    b = ctx.P.get(name + ".bias")
    return y if b is None else y + b


def batch_norm(ctx: Ctx, name: str, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the last axis: running statistics in eval; in train
    the batch's over every leading axis, flax's biased E[x^2] - E[x]^2."""
    mean, var = ctx.P[name + ".running_mean"], ctx.P[name + ".running_var"]
    if ctx.train:
        dims = tuple(range(x.ndim - 1))
        mean, sq = x.mean(dims), (x * x).mean(dims)
        var = torch.clamp(sq - mean * mean, min=0.0)
        ctx.stats[name + ".running_mean"] = mean.detach()
        ctx.stats[name + ".running_var"] = var.detach()
    scale = torch.rsqrt(var + BN_EPS) * ctx.P[name + ".weight"]
    return (x - mean) * scale + ctx.P[name + ".bias"]


# ---- EPN encoder --------------------------------------------------------


def instance_norm_pa(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over (point, anchor) per channel, statistics in float64."""
    x64 = x.double()
    mean = x64.mean(dim=(1, 2), keepdim=True)
    var = x64.var(dim=(1, 2), keepdim=True, unbiased=False)
    return ((x64 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _conv_weights(xyz, ctr, idx, rk, sigma):
    """(B, c, nn, A*K) kernel-point weights relu(1 - |x - r|^2 / sigma)."""
    gx = group_points(xyz, idx) - ctr[:, :, None, :]
    d = [gx[..., None, i] - rk[:, i] for i in range(3)]
    return torch.relu(1.0 - (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) / sigma)


def inter_conv(ctx: Ctx, name: str, spec: dict, xyz, feats):
    """Spatial SO(3) conv: FPS (or the lazy arange), ball query, the
    kernel-point contraction in 512-center chunks, the (K*C -> Co)
    projection.  -> (new_xyz, (B, P2, A, Co), sample_idx)."""
    B, Pn, A, C = feats.shape
    P2 = -(-Pn // spec["stride"])
    sidx = fps(xyz, P2, lazy=spec["lazy_sample"])
    new_xyz = gather_points(xyz, sidx)
    nbr = ball_query(new_xyz, xyz, spec["radius"], spec["n_neighbor"])
    kernels = get_kernel_points(spec["radius"], spec["kernel_size"])
    rk = np.einsum("aij,kj->aki", get_anchors(60), kernels).reshape(-1, 3)
    rk = torch.as_tensor(np.ascontiguousarray(rk), device=xyz.device)
    K = kernels.shape[0]
    W, bias = ctx.P[name + ".W"], ctx.P[name + ".bias"]
    flat = None if spec["occupancy_input"] else feats.reshape(B, Pn, A * C)
    num = ctx.num

    def chunk(xyz, ctr, idx, flat):
        c = idx.shape[1]
        w = _conv_weights(xyz, ctr, idx, rk, spec["sigma"])
        if flat is None:      # all-ones occupancy input: a neighbour sum of the weights
            t = w.sum(2).reshape(B, c, A, K)
        else:
            gf = group_points(flat, idx).reshape(B, c, -1, A, C)
            t = torch.einsum("bcnak,bcnad->bcakd", num.q(w.reshape(B, c, -1, A, K)), num.q(gf))
        return num.mm(t.reshape(B, c, A, -1), W) + bias

    outs = [ctx.remat(chunk, xyz, new_xyz[:, s:s + CHUNK].contiguous(),
                      nbr[:, s:s + CHUNK].contiguous(), flat)
            for s in range(0, P2, CHUNK)]
    return new_xyz, torch.cat(outs, dim=1), sidx


def intra_conv(ctx: Ctx, name: str, feats):
    """Rotation-group conv: gather the 12 neighbouring anchors, one
    (12*C -> Co) product."""
    B, P, A, C = feats.shape
    intra = torch.as_tensor(get_intra_idx().astype(np.int64), device=feats.device)
    g = feats[:, :, intra, :]
    return ctx.num.mm(g.reshape(B, P, A, -1), ctx.P[name + ".W"]) + ctx.P[name + ".bias"]


def so3_block(ctx: Ctx, name: str, spec: dict, xyz, feats):
    """inter conv -> intra conv, with an instance-normalised skip."""
    act = lambda h: F.leaky_relu(h, 0.01)
    new_xyz, x, sidx = inter_conv(ctx, name + ".inter", spec, xyz, feats)
    h = act(instance_norm_pa(x))
    h = act(instance_norm_pa(intra_conv(ctx, name + ".intra", h)))
    skip = gather_points(feats, sidx) if spec["stride"] > 1 else feats
    skip = act(instance_norm_pa(linear(ctx, name + ".skip_conv", skip)))
    return new_xyz, h + skip


def encoder(ctx: Ctx, xyz):
    """(B, P, 3) -> (xyz', feats (B, P', 60, C_last))."""
    B, P, _ = xyz.shape
    feats = torch.ones((B, P, 60, 1), dtype=xyz.dtype, device=xyz.device)
    for bi, block in enumerate(backbone_plan(ctx.cfg)):
        for ci, spec in enumerate(block):
            xyz, feats = so3_block(ctx, f"encoder.block{bi}_conv{ci}", spec, xyz, feats)
    return xyz, feats


# ---- direction head -----------------------------------------------------


def attention(num: Numerics, q, k, v, num_heads: int):
    """Per-point multi-head attention over the anchor tokens, q pre-scaled:
    (Bc, L, E) -> (Bc, L, E), max taken per (query, head)."""
    Bc, L, E = q.shape
    split = lambda t: t.reshape(Bc, L, num_heads, E // num_heads).transpose(1, 2)
    z = torch.einsum("bhqd,bhkd->bhqk", num.q(split(q)), num.q(split(k)))
    a = torch.softmax(z, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", num.q(a), num.q(split(v)))
    return out.transpose(1, 2).reshape(Bc, L, E)


def direction_core(ctx: Ctx, tokens):
    """Stacked MHSA (residual on all but the last layer) -> BatchMLP ->
    Dense(1): (Bc, A, E) -> (Bc, A) anchor weights."""
    P, num, cfg = ctx.P, ctx.num, ctx.cfg
    pre = "direction_head."
    H, n_layers = cfg["dir_num_heads"], cfg["dir_num_layers"]
    h = tokens
    scale = 1.0 / math.sqrt(h.shape[-1] // H)
    for l in range(n_layers):
        q = num.mm(h, P[f"{pre}wq{l}"]) * scale
        k = num.mm(h, P[f"{pre}wk{l}"])
        v = num.mm(h, P[f"{pre}wv{l}"])
        y = num.mm(attention(num, q, k, v, H), P[f"{pre}wc{l}"]) + P[f"{pre}bc{l}"]
        h = y if l == n_layers - 1 else h + y
    h = torch.relu(num.mm(h, P[pre + "wm0"]) + P[pre + "bm0"])
    h = num.mm(h, P[pre + "wm1"]) + P[pre + "bm1"]
    return num.mm(h, P[pre + "wr"])[..., 0] + P[pre + "br"]


def direction_head(ctx: Ctx, equiv):
    """(B, N, A, C) -> unit directions (B, N, 3): anchor weights, their
    weighted chordal mean of the anchor rotations, its third column."""
    B, N, A, C = equiv.shape
    tokens = equiv.reshape(B * N, A, C)
    step = ctx.cfg["dir_chunk"]
    w = torch.cat([ctx.remat(lambda t: direction_core(ctx, t), tokens[s:s + step])
                   for s in range(0, B * N, step)])
    anchors = torch.as_tensor(get_anchors(60).reshape(60, 9), device=equiv.device)
    R = project_to_so3((w @ anchors).reshape(B * N, 3, 3))
    return R[..., :, 2].reshape(B, N, 3)


# ---- Point Transformer U-Nets ------------------------------------------


def unet_geometry(p, strides, nsamples, interp_k: int = 3):
    """Per-level sampling and neighbourhoods shared by both U-Nets."""
    levels, ps = [], []
    cur = p
    for lvl, s in enumerate(strides):
        ent = {}
        if s > 1:
            idx = fps(cur, max(1, cur.shape[1] // s))
            new = gather_points(cur, idx)
            nidx, _ = knn(new, cur, nsamples[lvl])
            ent["down"] = (idx, nidx)
            ent["down_pr"] = group_points(cur, nidx) - new[:, :, None, :]
            cur = new
        sidx, _ = knn(cur, cur, min(nsamples[lvl], cur.shape[1]))
        ent["self"] = sidx
        ent["p_r"] = group_points(cur, sidx) - cur[:, :, None, :]
        ps.append(cur)
        levels.append(ent)
    for lvl in range(len(strides) - 1):
        levels[lvl]["up"] = knn(ps[lvl], ps[lvl + 1], interp_k)
    return levels


def vector_attention_eval(ctx: Ctx, name: str, x, idx, pe):
    """Vector attention with both w-chain BatchNorms as the affines of their
    running statistics."""
    P, num = ctx.P, ctx.num
    B, N, ns = idx.shape
    c = x.shape[-1]
    R = B * N
    w0, w1 = P[name + ".w0_kernel"], P[name + ".w1_kernel"]
    cs = w0.shape[1]
    s0 = P[name + ".w_bn0_scale"] * torch.rsqrt(P[name + ".w_bn0_var"] + BN_EPS)
    b0 = P[name + ".w_bn0_bias"] - P[name + ".w_bn0_mean"] * s0
    s1 = P[name + ".w_bn1_scale"] * torch.rsqrt(P[name + ".w_bn1_var"] + BN_EPS)
    b1 = (P[name + ".w0_bias"] - P[name + ".w_bn1_mean"]) * s1 + P[name + ".w_bn1_bias"]
    xq = linear(ctx, name + ".linear_q", x).reshape(R, c)
    gk = group_points(linear(ctx, name + ".linear_k", x), idx).reshape(R, ns, c)
    gv = group_points(linear(ctx, name + ".linear_v", x), idx).reshape(R, ns, c)
    pe = pe.reshape(R, ns, c)
    w = torch.relu((gk - xq[:, None, :] + pe) * s0 + b0)
    z = torch.relu(num.mm(w, w0) * s1 + b1)
    s = torch.softmax(num.mm(z, w1) + P[name + ".w1_bias"], dim=1)
    v = (gv + pe).reshape(R, ns, c // cs, cs)
    return (v * s[:, :, None, :]).sum(1).reshape(B, N, c)


def _w_bn(ctx: Ctx, name: str, which: str, w):
    """The w-chain's train BatchNorm (two-pass biased variance)."""
    mu = w.mean((0, 1, 2))
    var = w.var((0, 1, 2), unbiased=False)
    ctx.stats[f"{name}.w_{which}_mean"] = mu.detach()
    ctx.stats[f"{name}.w_{which}_var"] = var.detach()
    P = ctx.P
    return (w - mu) * (P[f"{name}.w_{which}_scale"] / torch.sqrt(var + BN_EPS)) + \
        P[f"{name}.w_{which}_bias"]


def vector_attention_train(ctx: Ctx, name: str, x, idx, pe):
    """The training chain: both w-chain BatchNorms on batch statistics."""
    P, num = ctx.P, ctx.num
    B, N, ns = idx.shape
    c = x.shape[-1]
    cs = P[name + ".w0_kernel"].shape[1]
    xq = linear(ctx, name + ".linear_q", x)
    gk = group_points(linear(ctx, name + ".linear_k", x), idx)
    gv = group_points(linear(ctx, name + ".linear_v", x), idx)
    w = torch.relu(_w_bn(ctx, name, "bn0", gk - xq[:, :, None, :] + pe))
    w = num.mm(w, P[name + ".w0_kernel"]) + P[name + ".w0_bias"]
    w = torch.relu(_w_bn(ctx, name, "bn1", w))
    w = torch.softmax(num.mm(w, P[name + ".w1_kernel"]) + P[name + ".w1_bias"], dim=2)
    v = (gv + pe).reshape(B, N, ns, c // cs, cs)
    return (v * w[:, :, :, None, :]).sum(2).reshape(B, N, c)


def pt_layer(ctx: Ctx, name: str, x, idx, p_r):
    pe = linear(ctx, name + ".linear_p1", torch.relu(
        batch_norm(ctx, name + ".linear_p_bn", linear(ctx, name + ".linear_p0", p_r))))
    fn = vector_attention_train if ctx.train else vector_attention_eval
    return fn(ctx, name, x, idx, pe)


def pt_block(ctx: Ctx, name: str, x, idx, p_r):
    h = torch.relu(batch_norm(ctx, name + ".bn1", linear(ctx, name + ".linear1", x)))
    h = torch.relu(batch_norm(ctx, name + ".bn2", pt_layer(ctx, name + ".transformer2", h, idx,
                                                           p_r)))
    h = batch_norm(ctx, name + ".bn3", linear(ctx, name + ".linear3", h))
    return torch.relu(h + x)


def transition_down(ctx: Ctx, name: str, stride: int, p, x, g):
    if stride == 1:
        return p, torch.relu(batch_norm(ctx, name + ".BatchNorm_0", linear(ctx, name + ".Dense_0",
                                                                           x)))
    idx, nidx = g["down"]
    h = torch.cat([g["down_pr"], group_points(x, nidx)], dim=-1)
    h = torch.relu(batch_norm(ctx, name + ".BatchNorm_0", linear(ctx, name + ".Dense_0", h)))
    return gather_points(p, idx), h.amax(dim=2)


def transition_up_head(ctx: Ctx, name: str, x):
    g = torch.relu(linear(ctx, name + ".linear2", x.mean(dim=1, keepdim=True)))
    h = torch.cat([x, g.expand_as(x)], dim=-1)
    return torch.relu(batch_norm(ctx, name + ".bn1", linear(ctx, name + ".linear1", h)))


def transition_up(ctx: Ctx, name: str, p1, x1, p2, x2, up):
    a = torch.relu(batch_norm(ctx, name + ".bn1", linear(ctx, name + ".linear1", x1)))
    b = torch.relu(batch_norm(ctx, name + ".bn2", linear(ctx, name + ".linear2", x2)))
    return a + knn_interpolate(p2, p1, b, k=3, use_sqrt=True, idx_dist=up)


def unet(ctx: Ctx, name: str, p, x, geom):
    cfg = ctx.cfg
    blocks, strides = cfg["unet_blocks"], cfg["unet_strides"]

    def block(bname, p, x, g):
        return ctx.remat(lambda x_, i_, pr_: pt_block(ctx, bname, x_, i_, pr_),
                         x, g["self"], g["p_r"])

    skips = []
    for lvl in range(5):
        g = geom[lvl]
        p, x = transition_down(ctx, f"{name}.enc{lvl + 1}_down", strides[lvl], p, x, g)
        for i in range(blocks[lvl] - 1):
            x = block(f"{name}.enc{lvl + 1}_blocks.{i}", p, x, g)
        skips.append((p, x))
    p5, x5 = skips[4]
    x = block(f"{name}.dec5_block1", p5, transition_up_head(ctx, f"{name}.dec5_up", x5), geom[4])
    for lvl in range(3, -1, -1):
        p_f, x_f = skips[lvl]
        x = transition_up(ctx, f"{name}.dec{lvl + 1}_up", p_f, x_f, skips[lvl + 1][0], x,
                          geom[lvl]["up"])
        x = block(f"{name}.dec{lvl + 1}_block1", p_f, x, geom[lvl])
    return x


def grouped_head(ctx: Ctx, h):
    """Per-part confidences: relu(h @ w0 + b0) grouped by part, each group
    reduced against its row of wg: (R, c0) -> (R, k)."""
    P, num = ctx.P, ctx.num
    pre = "confidence_encoder."
    wg = P[pre + "confi1_w"]
    k, c0 = wg.shape
    outs = []
    for s in range(0, h.shape[0], GROUPED_ROWS):
        z = torch.relu(num.mm(h[s:s + GROUPED_ROWS], P[pre + "confi0_kernel"])
                       + P[pre + "confi0_bias"]).reshape(-1, k, c0)
        outs.append(torch.einsum("rkc,kc->rk", num.q(z), num.q(wg)) + P[pre + "confi1_b"])
    return torch.cat(outs)


def magnitude_head(ctx: Ctx, p, feat, geom):
    pre = "magnitude_encoder"
    h = unet(ctx, pre + ".unet", p, torch.cat([p, feat], dim=-1), geom)
    h = torch.relu(batch_norm(ctx, pre + ".final_bn", linear(ctx, pre + ".final0", h)))
    return linear(ctx, pre + ".final1", h)


def confidence_head(ctx: Ctx, p, feat, geom):
    pre = "confidence_encoder"
    h = unet(ctx, pre + ".unet", p, torch.cat([p, feat], dim=-1), geom)
    B, N, c0 = h.shape
    logits = linear(ctx, pre + ".cls1", torch.relu(
        batch_norm(ctx, pre + ".cls_bn", linear(ctx, pre + ".cls0", h))))
    per_part = grouped_head(ctx, h.reshape(B * N, c0)).reshape(B, N, -1)
    conf = (per_part * torch.softmax(logits, dim=-1)).sum(-1, keepdim=True)
    return logits, conf


def forward(ctx: Ctx, hitpts):
    """(B, N, 3) scans -> dict of direction (B, N, 3), magnitude (B, N, 1),
    part_labels (logits, B, N, k) and confidences (B, N, 1)."""
    B, N, _ = hitpts.shape
    xyz, feats = encoder(ctx, hitpts)
    K, A, C = feats.shape[1:]
    flat = feats.transpose(2, 3).reshape(B, K, C * A)
    equiv = knn_interpolate(xyz, hitpts, flat, k=3, use_sqrt=False).reshape(B, N, C, A)
    inv = equiv.mean(-1)
    cfg = ctx.cfg
    geom = unet_geometry(hitpts, cfg["unet_strides"], cfg["unet_nsamples"])
    logits, conf = confidence_head(ctx, hitpts, inv, geom)
    return {"part_labels": logits, "confidences": conf,
            "direction": direction_head(ctx, equiv.transpose(2, 3)),
            "magnitude": magnitude_head(ctx, hitpts, inv, geom)}


@torch.no_grad()
def predict(P, cfg: dict, points, numerics: Numerics = None, block: int = 8):
    """Eval forward of (B, N, 3) scans in blocks of `block` scans (every
    scan is independent in eval) -> the serving outputs: vectors,
    inner_points, part_labels (argmax), part_logits, confidences."""
    outs = []
    numerics = numerics or Numerics()
    with numerics.scope():
        for s in range(0, points.shape[0], block):
            pts = points[s:s + block]
            r = forward(Ctx(P, cfg, numerics=numerics), pts)
            vectors = r["direction"] * r["magnitude"] / cfg["scale_magnitude"]
            outs.append({"vectors": vectors, "inner_points": pts - vectors,
                         "part_labels": torch.argmax(r["part_labels"], dim=-1),
                         "part_logits": r["part_labels"], "confidences": r["confidences"]})
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
