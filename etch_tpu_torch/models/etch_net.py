"""Top-level ETCH network: EPN encoder + direction/magnitude/confidence heads.

Port of `etch_tpu/models/etch_net.py`, f32 or with `cfg.use_bfloat16` the
bf16 policy of `nn/bf16.py`.  Input is a batch of scans (B, N, 3); outputs
are per-point direction (B, N, 3, unit), magnitude (B, N, 1, scaled x10),
86-way part logits (B, N, 86) and confidence (B, N, 1), all f32.
Parameter names follow the flax tree so `convert.flax_to_state_dict` maps
weights by path.  `forward(hitpts, train=True)` is the training forward:
batch-statistic BatchNorms, the chunked and recomputed direction core with
the plain attention, the plain vector attention and grouped head; the
inter-conv kernels run in both modes (their backward is their plain twin's,
`nn/interconv.py`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from etch_tpu_torch.geometry.icosahedral import get_anchors
from etch_tpu_torch.geometry.so3 import project_to_so3
from etch_tpu_torch.nn.attention import attention, attention_torch
from etch_tpu_torch.nn.dircore import direction_core, direction_core_chunked
from etch_tpu_torch.nn.epn import EPNBackbone, InterSO3Conv, IntraSO3Conv
from etch_tpu_torch.nn.point_transformer import (BatchNorm, PointTransformerLayer,
                                                 PointTransformerSeg, unet_geometry)
from etch_tpu_torch.ops import knn_interpolate
from etch_tpu_torch.utils.config import EtchConfig, backbone_plan


class DirectionHead(nn.Module):
    """Anchor-attention direction decoder (reference
    models_pointcloud.py:52-54,111-126): per point, MHSA over the 60 anchor
    tokens -> MLP -> scalar anchor weights -> weighted chordal mean of the
    anchor rotations -> its third column (R @ [0, 0, 1]).  With dtype=bf16
    the tokens are cast to bf16 up front; the chordal mean and the SO(3)
    projection stay f32.

    The core runs by the JAX package's two routes (`nn/dircore.py`): the
    fused core when the tokens are bf16, there are two layers and
    `fused_core` is set (the counterpart of `ETCH_DIRCORE_PALLAS`, an
    attribute here, not an environment variable); otherwise the chunked
    core over `chunk` points, whose attention is the kernel of
    `nn/attention.py` for bf16 tokens and plain f32 for f32 tokens.
    Training takes neither kernel (JAX: `not train`,
    `models/etch_net.py:97`, `:112`): the chunked core with the plain
    attention, each chunk recomputed in the backward pass."""

    def __init__(self, embed_dim: int, value_dim: int = 128, num_heads: int = 8,
                 num_layers: int = 2, chunk: int = 2048, dtype=None,
                 fused_core: bool = True):
        super().__init__()
        self.num_heads, self.num_layers, self.chunk = num_heads, num_layers, chunk
        self.dtype, self.fused_core = dtype, fused_core
        E, V = embed_dim, value_dim
        for l in range(num_layers):
            out_d = V if l == num_layers - 1 else E
            for nm in ("wq", "wk", "wv"):
                self.register_parameter(f"{nm}{l}", nn.Parameter(torch.empty(E, E)))
            self.register_parameter(f"wc{l}", nn.Parameter(torch.empty(E, out_d)))
            self.register_parameter(f"bc{l}", nn.Parameter(torch.zeros(out_d)))
        self.wm0 = nn.Parameter(torch.empty(V, V))
        self.bm0 = nn.Parameter(torch.zeros(V))
        self.wm1 = nn.Parameter(torch.empty(V, V))
        self.bm1 = nn.Parameter(torch.zeros(V))
        self.wr = nn.Parameter(torch.empty(V, 1))
        self.br = nn.Parameter(torch.zeros(1))
        anchors = get_anchors(60).reshape(60, 9)
        self.register_buffer("anchors", torch.from_numpy(np.ascontiguousarray(anchors)),
                             persistent=False)

    def anchor_weights(self, tokens: torch.Tensor, train: bool = False) -> torch.Tensor:
        """tokens (M, A, C) -> (M, A) f32 anchor weights."""
        params = dict(self.named_parameters())
        x = tokens if self.dtype is None else tokens.to(self.dtype).contiguous()
        bf16 = x.dtype == torch.bfloat16
        if not train and self.fused_core and bf16 and self.num_layers == 2:
            return direction_core(x, params, self.num_heads, self.chunk)
        attn = attention if bf16 and not train else attention_torch
        return direction_core_chunked(x, params, self.num_heads, self.chunk, attn,
                                      remat=train)

    def forward(self, equiv_feat: torch.Tensor, train: bool = False) -> torch.Tensor:
        """equiv_feat (B, N, A, C) -> unit directions (B, N, 3)."""
        B, N, A, C = equiv_feat.shape
        w = self.anchor_weights(equiv_feat.reshape(B * N, A, C), train)
        R = project_to_so3((w @ self.anchors).reshape(B * N, 3, 3))
        return R[..., :, 2].reshape(B, N, 3)


class EtchNet(nn.Module):
    """GT_network_equiv equivalent (reference models_pointcloud.py:18-221)."""

    def __init__(self, cfg: EtchConfig):
        super().__init__()
        self.cfg = cfg
        plan = backbone_plan(cfg)
        dtype = torch.bfloat16 if cfg.use_bfloat16 else None
        self.encoder = EPNBackbone(plan, dtype)
        feat_dim = plan[-1][-1]["dim_out"]
        self.direction_head = DirectionHead(
            feat_dim, cfg.dir_value_dim, cfg.dir_num_heads, cfg.dir_num_layers,
            cfg.dir_chunk, dtype)
        self.magnitude_encoder = PointTransformerSeg(
            "magnitude", 3 + feat_dim, planes=cfg.unet_planes_magnitude,
            blocks=cfg.unet_blocks, strides=cfg.unet_strides, dtype=dtype)
        self.confidence_encoder = PointTransformerSeg(
            "confidence", 3 + feat_dim, num_classes=cfg.num_markers,
            planes=cfg.unet_planes_confidence, blocks=cfg.unet_blocks,
            strides=cfg.unet_strides, dtype=dtype)

    def forward(self, hitpts: torch.Tensor, train: bool = False):
        """hitpts (B, N, 3) -> dict with direction, magnitude, part_labels
        (logits) and confidences; `train` takes the training forward."""
        B, N, _ = hitpts.shape
        xyz, feats = self.encoder(hitpts)                     # (B, K, A, C)
        K, A, C = feats.shape[1:]
        # 3-NN propagation back to the N points with squared-distance IDW
        # (reference pointnet2_utils.py:45-74), on the (c, a)-ordered flatten
        flat = feats.transpose(2, 3).reshape(B, K, C * A)
        prop = knn_interpolate(xyz, hitpts, flat, k=3, use_sqrt=False)
        point_equiv = prop.reshape(B, N, C, A)
        point_inv = point_equiv.mean(-1)                      # (B, N, C)

        geom = unet_geometry(hitpts, self.cfg.unet_strides, self.cfg.unet_nsamples)
        logits, conf = self.confidence_encoder(hitpts, point_inv, geom, train)
        return {
            "part_labels": logits.float(),
            "confidences": conf.float(),
            "direction": self.direction_head(point_equiv.transpose(2, 3), train),
            "magnitude": self.magnitude_encoder(hitpts, point_inv, geom, train).float(),
        }


def _lecun_normal_(t: torch.Tensor, gen: torch.Generator) -> None:
    """flax lecun_normal on an (in, out) kernel: truncated normal (+-2 std)
    with variance 1/fan_in."""
    std = math.sqrt(1.0 / t.shape[0]) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def _xavier_uniform_(t: torch.Tensor, gen: torch.Generator) -> None:
    """flax xavier_uniform on an (in, out) matrix."""
    lim = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    nn.init.uniform_(t, -lim, lim, generator=gen)


@torch.no_grad()
def init_params(model: EtchNet, gen: torch.Generator) -> None:
    """Random weights with the flax initialisers of the JAX package (the
    numbers differ: torch.Generator is not jax.random)."""
    for mod in model.modules():
        if isinstance(mod, nn.Linear):
            _lecun_normal_(mod.weight.T, gen)   # torch (out, in) = flax kernel.T
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (InterSO3Conv, IntraSO3Conv)):
            _xavier_uniform_(mod.W, gen)
            mod.bias.fill_(1e-3)
        elif isinstance(mod, BatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, PointTransformerLayer):
            _lecun_normal_(mod.w0_kernel, gen)
            _lecun_normal_(mod.w1_kernel, gen)
        elif isinstance(mod, DirectionHead):
            for name, p in mod.named_parameters(recurse=False):
                if name.startswith("w"):
                    _lecun_normal_(p, gen)
        elif isinstance(mod, PointTransformerSeg) and mod.mode == "confidence":
            _lecun_normal_(mod.confi0_kernel, gen)
            _xavier_uniform_(mod.confi1_w, gen)
