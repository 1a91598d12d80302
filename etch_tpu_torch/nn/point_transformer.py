"""Point Transformer U-Net heads on dense batched clouds, eval path.

Port of `etch_tpu/nn/point_transformer.py`.  Module and parameter names
follow the flax tree (`Dense_0`, `BatchNorm_0`, `linear_q`, `w_bn0_scale`,
...) so `convert.py` maps weights by path.  Only the serving (eval) path is
ported: BatchNorm is the affine of its running statistics, and the
vector-attention layer folds both of its BN affines as the JAX inference
path does (`:191-209`).  The `nn.scan`-stacked `enc{l}_blocks` of the JAX
package are a plain `ModuleList` here.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from etch_tpu_torch.nn.grouped_head import grouped_head_ref
from etch_tpu_torch.nn.vector_attention import vector_attention_ref
from etch_tpu_torch.ops import fps, gather_points, group_points, knn, knn_interpolate

_BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis (flax nn.BatchNorm with
    use_running_average=True)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = torch.rsqrt(self.running_var + _BN_EPS) * self.weight
        return (x - self.running_mean) * scale + self.bias


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

    def __init__(self, c: int, share_planes: int = 8):
        super().__init__()
        cs = c // share_planes
        self.linear_q = nn.Linear(c, c)
        self.linear_k = nn.Linear(c, c)
        self.linear_v = nn.Linear(c, c)
        self.linear_p0 = nn.Linear(3, 3)
        self.linear_p_bn = BatchNorm(3)
        self.linear_p1 = nn.Linear(3, c)
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

    def forward(self, p, x, idx, p_r):
        B, N, ns = idx.shape
        c = x.shape[-1]
        R = B * N
        g_k = group_points(self.linear_k(x), idx)                # (B, N, ns, c)
        g_v = group_points(self.linear_v(x), idx)
        pe = self.linear_p1(torch.relu(self.linear_p_bn(self.linear_p0(p_r))))
        # eval BatchNorms folded to affines; the Dense-0 bias folds into BN-1
        s0e = self.w_bn0_scale * torch.rsqrt(self.w_bn0_var + _BN_EPS)
        a0 = torch.stack([s0e, self.w_bn0_bias - self.w_bn0_mean * s0e])
        s1e = self.w_bn1_scale * torch.rsqrt(self.w_bn1_var + _BN_EPS)
        a1 = torch.stack([s1e, (self.w0_bias - self.w_bn1_mean) * s1e + self.w_bn1_bias])
        out = vector_attention_ref(
            self.linear_q(x).reshape(R, c), g_k.reshape(R, ns, c),
            g_v.reshape(R, ns, c), pe.reshape(R, ns, c),
            a0, self.w0_kernel, a1, self.w1_kernel, self.w1_bias[None])
        return out.reshape(B, N, c)


class TransitionDown(nn.Module):
    """FPS + kNN grouping + shared MLP + max-pool (reference :40-68); the
    sampling and grouping indices come precomputed from `unet_geometry`."""

    def __init__(self, in_planes: int, out_planes: int, stride: int):
        super().__init__()
        self.stride = stride
        self.Dense_0 = nn.Linear(in_planes + (3 if stride > 1 else 0), out_planes,
                                 bias=False)
        self.BatchNorm_0 = BatchNorm(out_planes)

    def forward(self, p, x, down=None, down_pr=None):
        if self.stride == 1:
            return p, torch.relu(self.BatchNorm_0(self.Dense_0(x)))
        idx, nidx = down
        h = torch.cat([down_pr, group_points(x, nidx)], dim=-1)
        h = torch.relu(self.BatchNorm_0(self.Dense_0(h)))
        return gather_points(p, idx), h.amax(dim=2)


class TransitionUp(nn.Module):
    """Decoder fusion (reference :71-98); the head variant fuses a global
    summary instead of interpolating from a coarser level."""

    def __init__(self, planes: int, coarse_planes: int = 0, is_head: bool = False):
        super().__init__()
        self.is_head = is_head
        if is_head:
            self.linear2 = nn.Linear(planes, planes)
            self.linear1 = nn.Linear(2 * planes, planes)
            self.bn1 = BatchNorm(planes)
        else:
            self.linear1 = nn.Linear(planes, planes)
            self.bn1 = BatchNorm(planes)
            self.linear2 = nn.Linear(coarse_planes, planes)
            self.bn2 = BatchNorm(planes)

    def forward(self, p1, x1, p2=None, x2=None, up=None):
        if self.is_head:
            g = torch.relu(self.linear2(x1.mean(dim=1, keepdim=True)))
            h = torch.cat([x1, g.expand_as(x1)], dim=-1)
            return torch.relu(self.bn1(self.linear1(h)))
        a = torch.relu(self.bn1(self.linear1(x1)))
        b = torch.relu(self.bn2(self.linear2(x2)))
        return a + knn_interpolate(p2, p1, b, k=3, use_sqrt=True, idx_dist=up)


class PointTransformerBlock(nn.Module):
    """Residual block around the vector-attention layer (reference :101-122)."""

    def __init__(self, planes: int, share_planes: int = 8):
        super().__init__()
        self.linear1 = nn.Linear(planes, planes, bias=False)
        self.bn1 = BatchNorm(planes)
        self.transformer2 = PointTransformerLayer(planes, share_planes)
        self.bn2 = BatchNorm(planes)
        self.linear3 = nn.Linear(planes, planes, bias=False)
        self.bn3 = BatchNorm(planes)

    def forward(self, p, x, idx, p_r):
        h = torch.relu(self.bn1(self.linear1(x)))
        h = torch.relu(self.bn2(self.transformer2(p, h, idx, p_r)))
        h = self.bn3(self.linear3(h))
        return torch.relu(h + x)


class PointTransformerUNet(nn.Module):
    """Shared 5-level encoder/decoder trunk (reference :125-260); returns
    per-point features at full resolution, (B, N, planes[0])."""

    def __init__(self, in_planes: int, planes: Sequence[int],
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 strides: Sequence[int] = (1, 4, 4, 4, 4), share_planes: int = 8):
        super().__init__()
        self.blocks = tuple(blocks)
        c = in_planes
        for lvl in range(5):
            self.add_module(f"enc{lvl + 1}_down",
                            TransitionDown(c, planes[lvl], strides[lvl]))
            c = planes[lvl]
            if blocks[lvl] > 1:
                self.add_module(f"enc{lvl + 1}_blocks", nn.ModuleList(
                    PointTransformerBlock(c, share_planes)
                    for _ in range(blocks[lvl] - 1)))
        self.dec5_up = TransitionUp(planes[4], is_head=True)
        self.dec5_block1 = PointTransformerBlock(planes[4], share_planes)
        for lvl in range(3, -1, -1):
            self.add_module(f"dec{lvl + 1}_up",
                            TransitionUp(planes[lvl], planes[lvl + 1]))
            self.add_module(f"dec{lvl + 1}_block1",
                            PointTransformerBlock(planes[lvl], share_planes))

    def forward(self, p, x, geom):
        skips = []
        for lvl in range(5):
            g = geom[lvl]
            p, x = getattr(self, f"enc{lvl + 1}_down")(p, x, g.get("down"),
                                                        g.get("down_pr"))
            if self.blocks[lvl] > 1:
                for blk in getattr(self, f"enc{lvl + 1}_blocks"):
                    x = blk(p, x, g["self"], g["p_r"])
            skips.append((p, x))
        p5, x5 = skips[4]
        x = self.dec5_block1(p5, self.dec5_up(p5, x5), geom[4]["self"], geom[4]["p_r"])
        for lvl in range(3, -1, -1):
            p_f, x_f = skips[lvl]
            x = getattr(self, f"dec{lvl + 1}_up")(p_f, x_f, skips[lvl + 1][0], x,
                                                  up=geom[lvl]["up"])
            x = getattr(self, f"dec{lvl + 1}_block1")(p_f, x, geom[lvl]["self"],
                                                      geom[lvl]["p_r"])
        return x


class PointTransformerSeg(nn.Module):
    """Magnitude / confidence task heads over the shared trunk.

    mode="magnitude": (B, N, 1).  mode="confidence": (part logits (B, N, k),
    confidence (B, N, 1)) through the softmax-weighted per-part head.
    """

    def __init__(self, mode: str, in_planes: int, num_classes: int = 1,
                 planes: Sequence[int] = (64, 128, 256, 256, 512),
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 strides: Sequence[int] = (1, 4, 4, 4, 4)):
        super().__init__()
        if mode not in ("magnitude", "confidence"):
            raise ValueError(f"unknown head mode {mode!r}")
        self.mode = mode
        c0 = planes[0]
        self.unet = PointTransformerUNet(in_planes, planes, blocks, strides)
        if mode == "magnitude":
            self.final0 = nn.Linear(c0, c0)
            self.final_bn = BatchNorm(c0)
            self.final1 = nn.Linear(c0, 1)
            return
        k = num_classes
        self.cls0 = nn.Linear(c0, c0)
        self.cls_bn = BatchNorm(c0)
        self.cls1 = nn.Linear(c0, k)
        self.confi0_kernel = nn.Parameter(torch.empty(c0, c0 * k))
        self.confi0_bias = nn.Parameter(torch.zeros(c0 * k))
        self.confi1_w = nn.Parameter(torch.empty(k, c0))
        self.confi1_b = nn.Parameter(torch.zeros(k))

    def forward(self, p, feat, geom):
        h = self.unet(p, torch.cat([p, feat], dim=-1), geom)
        B, N, c0 = h.shape
        if self.mode == "magnitude":
            return self.final1(torch.relu(self.final_bn(self.final0(h))))
        logits = self.cls1(torch.relu(self.cls_bn(self.cls0(h))))
        per_part = grouped_head_ref(h.reshape(B * N, c0), self.confi0_kernel,
                                    self.confi0_bias, self.confi1_w,
                                    self.confi1_b).reshape(B, N, -1)
        confidence = (per_part * torch.softmax(logits, dim=-1)).sum(-1, keepdim=True)
        return logits, confidence
