"""Point Transformer U-Net heads on dense batched clouds.

Port of `etch_tpu/nn/point_transformer.py`.  Module and parameter names
follow the flax tree (`Dense_0`, `BatchNorm_0`, `linear_q`, `w_bn0_scale`,
...) so `convert.py` maps weights by path.  The `nn.scan`-stacked
`enc{l}_blocks` of the JAX package are a plain `ModuleList` here.  Every
`forward` takes `train`, as the flax modules do:

  - eval (`train=False`, the serving path): BatchNorm is the affine of its
    running statistics, and the vector-attention layer folds both of its BN
    affines as the JAX inference path does (`:191-209`).
  - train: BatchNorm takes its statistics over every leading axis in f32
    with the biased variance (flax's E[x^2] - E[x]^2), and moves
    `running_* = 0.9 old + 0.1 batch`, the biased variance included (flax's
    rule, not `torch.nn.BatchNorm1d`'s); the vector attention runs the JAX
    package's explicit train chain (`:168-189`), two batch-statistic BNs
    inside the w-chain, never the kernel; the grouped confidence head runs
    its plain version; every U-Net block is recomputed in the backward pass
    (`torch.utils.checkpoint`, where the JAX package has `nn.remat`), and a
    recomputed block does not move the running statistics a second time.

`dtype=torch.bfloat16` is the bf16 serving path (flax `dtype=bfloat16`):
every Dense and BatchNorm returns bf16 where flax does (`Dense`,
`BatchNorm` below), the vector-attention layer returns bf16, and the
vector attention and the grouped confidence head run their CUDA kernels on
the card.  Each kernel is dispatched by its own module, on its own operands.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from etch_tpu_torch.nn.bf16 import mm
from etch_tpu_torch.nn.grouped_head import grouped_head, grouped_head_torch
from etch_tpu_torch.nn.vector_attention import vector_attention
from etch_tpu_torch.ops import fps, gather_points, group_points, knn, knn_interpolate

_BN_EPS = 1e-5
_BN_MOM = 0.9  # torch BatchNorm1d momentum 0.1 == flax momentum 0.9
# above 0 while a checkpointed block recomputes its forward for the backward
_recomputing = [0]


def remat(fn, *args):
    """fn(*args) under `torch.utils.checkpoint` (non-reentrant): its
    activations are recomputed in the backward pass instead of kept.  The
    recomputation leaves the BatchNorm running statistics alone, so they
    advance once a step, as flax's functional update does."""
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        _recomputing[0] += 1
        try:
            return fn(*a)
        finally:
            _recomputing[0] -= 1

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


@torch.no_grad()
def update_running(running: torch.Tensor, batch: torch.Tensor) -> None:
    """running = 0.9 running + 0.1 batch (flax BatchNorm momentum 0.9), except
    while a checkpointed block recomputes."""
    if not _recomputing[0]:
        running.copy_(_BN_MOM * running + (1 - _BN_MOM) * batch)


class Dense(nn.Linear):
    """flax nn.Dense: f32 by default; with dtype=bf16, bf16 operands, an f32
    sum rounded to bf16, then the bf16 bias added and rounded again."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True, dtype=None):
        super().__init__(c_in, c_out, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        y = mm(x, self.weight.T).to(self.dtype)
        if self.bias is not None:
            y = (y.float() + self.bias.to(self.dtype).float()).to(self.dtype)
        return y


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (flax nn.BatchNorm, momentum 0.9): f32
    arithmetic, the result in `dtype` when set.  Eval uses the running
    statistics; train the batch's, over every leading axis, with flax's
    fast biased variance max(0, E[x^2] - E[x]^2), and updates the running
    ones."""

    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        mean, var = self.running_mean, self.running_var
        if train:
            xf = x.float()
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            update_running(self.running_mean, mean)
            update_running(self.running_var, var)
        scale = torch.rsqrt(var + _BN_EPS) * self.weight
        y = (x - mean) * scale + self.bias
        return y if self.dtype is None else y.to(self.dtype)


def unet_geometry(p: torch.Tensor, strides: Sequence[int] = (1, 4, 4, 4, 4),
                  nsamples: Sequence[int] = (8, 16, 16, 16, 16), interp_k: int = 3):
    """Per-level sampling / neighbourhood geometry shared by both U-Net heads
    (same contract as the JAX `unet_geometry`): per level a dict with
    down (fps_idx, group_idx) and down_pr for stride > 1 levels, self (the
    self-kNN indices), p_r (their relative coords) and up (the 3-NN of this
    level's points among the next coarser level's, as (idx, dist))."""
    levels, ps = [], []
    cur_p = p
    for lvl, s in enumerate(strides):
        ent = {}
        if s > 1:
            M = max(1, cur_p.shape[1] // s)
            idx = fps(cur_p, M)
            new_p = gather_points(cur_p, idx)
            nidx, _ = knn(new_p, cur_p, nsamples[lvl])
            ent["down"] = (idx, nidx)
            ent["down_pr"] = group_points(cur_p, nidx) - new_p[:, :, None, :]
            cur_p = new_p
        sidx, _ = knn(cur_p, cur_p, min(nsamples[lvl], cur_p.shape[1]))
        ent["self"] = sidx
        ent["p_r"] = group_points(cur_p, sidx) - cur_p[:, :, None, :]
        ps.append(cur_p)
        levels.append(ent)
    for lvl in range(len(strides) - 1):
        levels[lvl]["up"] = knn(ps[lvl], ps[lvl + 1], interp_k)
    return levels


class PointTransformerLayer(nn.Module):
    """Vector attention over the k nearest neighbours (reference :8-37)."""

    def __init__(self, c: int, share_planes: int = 8, dtype=None):
        super().__init__()
        cs = c // share_planes
        self.linear_q = Dense(c, c, dtype=dtype)
        self.linear_k = Dense(c, c, dtype=dtype)
        self.linear_v = Dense(c, c, dtype=dtype)
        self.linear_p0 = Dense(3, 3, dtype=dtype)
        self.linear_p_bn = BatchNorm(3, dtype)
        self.linear_p1 = Dense(3, c, dtype=dtype)
        self.w_bn0_scale = nn.Parameter(torch.ones(c))
        self.w_bn0_bias = nn.Parameter(torch.zeros(c))
        self.w_bn1_scale = nn.Parameter(torch.ones(cs))
        self.w_bn1_bias = nn.Parameter(torch.zeros(cs))
        self.w0_kernel = nn.Parameter(torch.empty(c, cs))
        self.w0_bias = nn.Parameter(torch.zeros(cs))
        self.w1_kernel = nn.Parameter(torch.empty(cs, cs))
        self.w1_bias = nn.Parameter(torch.zeros(cs))
        self.register_buffer("w_bn0_mean", torch.zeros(c))
        self.register_buffer("w_bn0_var", torch.ones(c))
        self.register_buffer("w_bn1_mean", torch.zeros(cs))
        self.register_buffer("w_bn1_var", torch.ones(cs))

    def forward(self, p, x, idx, p_r, train: bool = False):
        B, N, ns = idx.shape
        c = x.shape[-1]
        R = B * N
        pe = self.linear_p1(torch.relu(self.linear_p_bn(self.linear_p0(p_r), train)))
        if train:
            return self._train_chain(x, idx, pe)
        # eval BatchNorms folded to affines; the Dense-0 bias folds into BN-1
        s0e = self.w_bn0_scale * torch.rsqrt(self.w_bn0_var + _BN_EPS)
        a0 = torch.stack([s0e, self.w_bn0_bias - self.w_bn0_mean * s0e])
        s1e = self.w_bn1_scale * torch.rsqrt(self.w_bn1_var + _BN_EPS)
        a1 = torch.stack([s1e, (self.w0_bias - self.w_bn1_mean) * s1e + self.w_bn1_bias])
        out = vector_attention(
            self.linear_q(x).reshape(R, c), self.linear_k(x), self.linear_v(x),
            idx, pe.reshape(R, ns, c), a0, self.w0_kernel, a1,
            self.w1_kernel, self.w1_bias)
        return out.reshape(B, N, c).to(x.dtype)

    @staticmethod
    def _batch_norm(w, mean, var, scale, bias):
        """The w-chain's train BN (`jnp.mean` / `jnp.var` over the leading
        axes, as the JAX chain takes them) and its running-stat update."""
        mu = w.mean((0, 1, 2))
        v = w.var((0, 1, 2), unbiased=False)
        update_running(mean, mu)
        update_running(var, v)
        return (w - mu) * (scale / torch.sqrt(v + _BN_EPS)) + bias

    def _train_chain(self, x, idx, pe):
        """The JAX package's explicit train chain, f32 from the sum on."""
        B, N, ns = idx.shape
        c = x.shape[-1]
        cs = self.w0_kernel.shape[1]
        xq = self.linear_q(x)
        gk = group_points(self.linear_k(x), idx)                    # (B, N, ns, c)
        gv = group_points(self.linear_v(x), idx)
        w = (gk - xq[:, :, None, :] + pe).float()
        w = torch.relu(self._batch_norm(w, self.w_bn0_mean, self.w_bn0_var,
                                        self.w_bn0_scale, self.w_bn0_bias))
        w = w @ self.w0_kernel + self.w0_bias
        w = torch.relu(self._batch_norm(w, self.w_bn1_mean, self.w_bn1_var,
                                        self.w_bn1_scale, self.w_bn1_bias))
        w = torch.softmax(w @ self.w1_kernel + self.w1_bias, dim=2)  # (B, N, ns, cs)
        v = (gv + pe).float().reshape(B, N, ns, c // cs, cs)
        out = (v * w[:, :, :, None, :]).sum(2)                      # (B, N, s, cs)
        return out.reshape(B, N, c).to(x.dtype)


class TransitionDown(nn.Module):
    """FPS + kNN grouping + shared MLP + max-pool (reference :40-68); the
    sampling and grouping indices come precomputed from `unet_geometry`."""

    def __init__(self, in_planes: int, out_planes: int, stride: int, dtype=None):
        super().__init__()
        self.stride = stride
        self.Dense_0 = Dense(in_planes + (3 if stride > 1 else 0), out_planes,
                             bias=False, dtype=dtype)
        self.BatchNorm_0 = BatchNorm(out_planes, dtype)

    def forward(self, p, x, down=None, down_pr=None, train: bool = False):
        if self.stride == 1:
            return p, torch.relu(self.BatchNorm_0(self.Dense_0(x), train))
        idx, nidx = down
        h = torch.cat([down_pr, group_points(x, nidx)], dim=-1)   # promotes as jnp
        h = torch.relu(self.BatchNorm_0(self.Dense_0(h), train))
        return gather_points(p, idx), h.amax(dim=2)


class TransitionUp(nn.Module):
    """Decoder fusion (reference :71-98); the head variant fuses a global
    summary instead of interpolating from a coarser level."""

    def __init__(self, planes: int, coarse_planes: int = 0, is_head: bool = False,
                 dtype=None):
        super().__init__()
        self.is_head = is_head
        if is_head:
            self.linear2 = Dense(planes, planes, dtype=dtype)
            self.linear1 = Dense(2 * planes, planes, dtype=dtype)
            self.bn1 = BatchNorm(planes, dtype)
        else:
            self.linear1 = Dense(planes, planes, dtype=dtype)
            self.bn1 = BatchNorm(planes, dtype)
            self.linear2 = Dense(coarse_planes, planes, dtype=dtype)
            self.bn2 = BatchNorm(planes, dtype)

    def forward(self, p1, x1, p2=None, x2=None, up=None, train: bool = False):
        if self.is_head:
            # jnp.mean of bf16 sums in f32 and returns bf16
            mean = x1.float().mean(dim=1, keepdim=True).to(x1.dtype)
            g = torch.relu(self.linear2(mean))
            h = torch.cat([x1, g.expand_as(x1)], dim=-1)
            return torch.relu(self.bn1(self.linear1(h), train))
        a = torch.relu(self.bn1(self.linear1(x1), train))
        b = torch.relu(self.bn2(self.linear2(x2), train))
        return a + knn_interpolate(p2, p1, b, k=3, use_sqrt=True, idx_dist=up)


class PointTransformerBlock(nn.Module):
    """Residual block around the vector-attention layer (reference :101-122)."""

    def __init__(self, planes: int, share_planes: int = 8, dtype=None):
        super().__init__()
        self.linear1 = Dense(planes, planes, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.transformer2 = PointTransformerLayer(planes, share_planes, dtype)
        self.bn2 = BatchNorm(planes, dtype)
        self.linear3 = Dense(planes, planes, bias=False, dtype=dtype)
        self.bn3 = BatchNorm(planes, dtype)

    def forward(self, p, x, idx, p_r, train: bool = False):
        h = torch.relu(self.bn1(self.linear1(x), train))
        h = torch.relu(self.bn2(self.transformer2(p, h, idx, p_r, train), train))
        h = self.bn3(self.linear3(h), train)
        return torch.relu(h + x)


class PointTransformerUNet(nn.Module):
    """Shared 5-level encoder/decoder trunk (reference :125-260); returns
    per-point features at full resolution, (B, N, planes[0])."""

    def __init__(self, in_planes: int, planes: Sequence[int],
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 strides: Sequence[int] = (1, 4, 4, 4, 4), share_planes: int = 8,
                 dtype=None):
        super().__init__()
        self.blocks = tuple(blocks)
        c = in_planes
        for lvl in range(5):
            self.add_module(f"enc{lvl + 1}_down",
                            TransitionDown(c, planes[lvl], strides[lvl], dtype))
            c = planes[lvl]
            if blocks[lvl] > 1:
                self.add_module(f"enc{lvl + 1}_blocks", nn.ModuleList(
                    PointTransformerBlock(c, share_planes, dtype)
                    for _ in range(blocks[lvl] - 1)))
        self.dec5_up = TransitionUp(planes[4], is_head=True, dtype=dtype)
        self.dec5_block1 = PointTransformerBlock(planes[4], share_planes, dtype)
        for lvl in range(3, -1, -1):
            self.add_module(f"dec{lvl + 1}_up",
                            TransitionUp(planes[lvl], planes[lvl + 1], dtype=dtype))
            self.add_module(f"dec{lvl + 1}_block1",
                            PointTransformerBlock(planes[lvl], share_planes, dtype))

    def forward(self, p, x, geom, train: bool = False):
        def block(blk, p, x, g):
            # training recomputes each block's activations in the backward
            # pass (JAX: nn.remat around every block)
            if train:
                return remat(blk, p, x, g["self"], g["p_r"], True)
            return blk(p, x, g["self"], g["p_r"])

        skips = []
        for lvl in range(5):
            g = geom[lvl]
            p, x = getattr(self, f"enc{lvl + 1}_down")(p, x, g.get("down"),
                                                        g.get("down_pr"), train)
            if self.blocks[lvl] > 1:
                for blk in getattr(self, f"enc{lvl + 1}_blocks"):
                    x = block(blk, p, x, g)
            skips.append((p, x))
        p5, x5 = skips[4]
        x = block(self.dec5_block1, p5, self.dec5_up(p5, x5, train=train), geom[4])
        for lvl in range(3, -1, -1):
            p_f, x_f = skips[lvl]
            x = getattr(self, f"dec{lvl + 1}_up")(p_f, x_f, skips[lvl + 1][0], x,
                                                  up=geom[lvl]["up"], train=train)
            x = block(getattr(self, f"dec{lvl + 1}_block1"), p_f, x, geom[lvl])
        return x


class PointTransformerSeg(nn.Module):
    """Magnitude / confidence task heads over the shared trunk.

    mode="magnitude": (B, N, 1).  mode="confidence": (part logits (B, N, k),
    confidence (B, N, 1)) through the softmax-weighted per-part head.
    """

    def __init__(self, mode: str, in_planes: int, num_classes: int = 1,
                 planes: Sequence[int] = (64, 128, 256, 256, 512),
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 strides: Sequence[int] = (1, 4, 4, 4, 4), dtype=None):
        super().__init__()
        if mode not in ("magnitude", "confidence"):
            raise ValueError(f"unknown head mode {mode!r}")
        self.mode, self.dtype = mode, dtype
        c0 = planes[0]
        self.unet = PointTransformerUNet(in_planes, planes, blocks, strides, dtype=dtype)
        if mode == "magnitude":
            self.final0 = Dense(c0, c0, dtype=dtype)
            self.final_bn = BatchNorm(c0, dtype)
            self.final1 = Dense(c0, 1, dtype=dtype)
            return
        k = num_classes
        self.cls0 = Dense(c0, c0, dtype=dtype)
        self.cls_bn = BatchNorm(c0, dtype)
        self.cls1 = Dense(c0, k, dtype=dtype)
        self.confi0_kernel = nn.Parameter(torch.empty(c0, c0 * k))
        self.confi0_bias = nn.Parameter(torch.zeros(c0 * k))
        self.confi1_w = nn.Parameter(torch.empty(k, c0))
        self.confi1_b = nn.Parameter(torch.zeros(k))

    def forward(self, p, feat, geom, train: bool = False):
        h = self.unet(p, torch.cat([p, feat], dim=-1), geom, train)
        B, N, c0 = h.shape
        if self.mode == "magnitude":
            return self.final1(torch.relu(self.final_bn(self.final0(h), train)))
        logits = self.cls1(torch.relu(self.cls_bn(self.cls0(h), train)))
        # the kernel reads bf16 rows (the TPU kernel casts h to bf16 itself);
        # training takes the plain version (JAX: `not train`, `:475`)
        hk = h.reshape(B * N, c0)
        head = grouped_head_torch if train else grouped_head
        per_part = head(hk if self.dtype is None else hk.to(self.dtype),
                        self.confi0_kernel, self.confi0_bias, self.confi1_w,
                        self.confi1_b).reshape(B, N, -1)
        # softmax of bf16 logits is bf16 in JAX; the product promotes to f32
        parts = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
        confidence = (per_part * parts).sum(-1, keepdim=True)
        return logits, confidence
