"""Config dicts -> modules (port of point_cloud_reid_tpu/models/registry.py).

Head configs are lists of dicts like [{'type': 'LinearRes', ...}, {'type':
'Linear', ...}], as in the reidentifier config files. Every backbone, stage
and head layer type of the JAX registry is here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.nn as nn

from .attention_blocks import (CrossAttentionBlock, CrossLinAttn,
                               LocalSelfAttention, SelfAttentionBlock)
from .dgcnn import DGCNNBackbone
from .layers import (BatchNorm, Conv1d, Dense, GroupNorm, LayerNorm,
                     LinearRes, PostRes, Res1d, group_norm)
from .loftr import LoFTRStage
from .point_transformer import PointTransformerBackbone
from .pointnet import PointNetBackbone
from .vector_neurons import VNDGCNNBackbone

Spec = Dict[str, Any]


class _Conv1d(Conv1d):
    """Conv1d over a channel-last (B, L, C) input, stride 1, no padding;
    with a compute dtype, as flax's Conv(dtype=...)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class SequentialHead(nn.ModuleList):
    """Sequential stack built from config specs; threads `train` to the
    BatchNorm layers. Layer j is `{j}` in the state dict and
    `{j}_{type}` in the JAX package's variable tree.

    Types: LinearRes, PostRes (3x3 conv block over NHWC inputs), Res1d
    (1-D conv block over (B, L, C)), Linear, Conv1d (real 1-D conv, no
    padding), BatchNorm1d, GroupNorm, LayerNorm, ReLU, Sigmoid."""

    def __init__(self, specs: Sequence[Spec], n_in: int):
        layers: List[nn.Module] = []
        width = n_in
        for spec in specs:
            t = spec["type"]
            if t == "LinearRes":
                layers.append(LinearRes(spec["n_in"], spec["n_out"],
                                        norm=spec.get("norm", "GN"),
                                        ng=spec.get("ng", 32)))
                width = spec["n_out"]
            elif t in ("PostRes", "Res1d"):
                kw = dict(stride=spec.get("stride", 1),
                          norm=spec.get("norm", "GN"), ng=spec.get("ng", 32))
                if t == "Res1d":
                    kw["kernel_size"] = spec.get("kernel_size", 3)
                block = PostRes if t == "PostRes" else Res1d
                layers.append(block(width, spec["n_out"], **kw))
                width = spec["n_out"]
            elif t == "Linear":
                layers.append(Dense(width, spec["out_features"]))
                width = spec["out_features"]
            elif t == "Conv1d":
                layers.append(_Conv1d(width, spec["out_channels"],
                                      spec.get("kernel_size", 1)))
                width = spec["out_channels"]
            elif t == "BatchNorm1d":
                layers.append(BatchNorm(width))
            elif t == "GroupNorm":
                layers.append(GroupNorm(spec["num_groups"], width,
                                        eps=1e-5))
            elif t == "LayerNorm":
                layers.append(LayerNorm(width, eps=1e-5))
            elif t == "ReLU":
                layers.append(nn.ReLU())
            elif t == "Sigmoid":
                layers.append(nn.Sigmoid())
            else:
                raise NotImplementedError(f"SequentialHead type {t}")
        super().__init__(layers)
        self.types = [spec["type"] for spec in specs]
        self.out_width = width

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, (LinearRes, PostRes, Res1d, BatchNorm)):
                x = layer(x, train)
            elif isinstance(layer, nn.GroupNorm):
                x = group_norm(layer, x)
            else:
                x = layer(x)
        return x


def build_backbone(cfg: Spec, knn_method: str = "argsort") -> nn.Module:
    """Backbone factory. Every backbone has `out_channels`, the width of
    its per-point features. knn_method reaches the point-transformer's SA
    stages alone: DGCNN's kNN in feature space is a stable sort, as JAX's
    lax.top_k."""
    t = cfg["type"]
    if t in ("Pointnet_Backbone", "point_transformer"):
        return PointTransformerBackbone(
            input_channels=cfg.get("input_channels", 0),
            conv_out=cfg.get("conv_out", 32), mul=cfg.get("mul", 1),
            nsample=tuple(cfg.get("nsample", (32, 48, 48))),
            knn_method=knn_method,
            fused_train=bool(cfg.get("fused_train", False)),
            fused_train_vjp=bool(cfg.get("fused_train_vjp", True)),
            remat_stages=tuple(cfg.get("remat_stages", ())))
    if t in ("PointNet", "pointnet"):
        return PointNetBackbone(
            channel=6 if cfg.get("normal_channel", True) else 3)
    if t in ("dgcnn", "DGCNN"):
        return DGCNNBackbone(emb_dims=cfg.get("emb_dims", 1024),
                             k=cfg.get("k", 20))
    if t in ("vn_dgcnn", "VNDGCNN"):
        return VNDGCNNBackbone(n_knn=cfg.get("n_knn", 20),
                               pooling=cfg.get("pooling", "max"))
    raise NotImplementedError(f"backbone type {t}")


def build_stage(cfg: Optional[Spec]) -> Optional[nn.Module]:
    """Attention-stage factory (cross_stageN / local_stageN entries)."""
    if not cfg:
        return None
    t = cfg["type"]
    kw = dict(d_model=cfg["d_model"], nhead=cfg["nhead"],
              attention=cfg.get("attention", "linear"))
    if t == "corss_attention":
        return CrossAttentionBlock(**kw)
    if t == "cross_lin_attn":
        return CrossLinAttn(**kw)
    if t == "local_self_attention":
        return LocalSelfAttention(knum=cfg.get("knum", 32),
                                  pos_size=cfg.get("pos_size"), **kw)
    if t == "Self_Attention":
        return SelfAttentionBlock(**kw)
    if t == "loftr":
        return LoFTRStage(n_layers=cfg.get("n_layers", 2), **kw)
    raise NotImplementedError(f"stage type {t}")


def build_head(cfg: Union[None, Spec, List[Spec]], n_in: int
               ) -> Optional[SequentialHead]:
    """None | single spec | list of specs -> SequentialHead or None. `n_in`
    is the input width (torch layers are sized when they are built)."""
    if not cfg:
        return None
    specs = cfg if isinstance(cfg, (list, tuple)) else [cfg]
    return SequentialHead([dict(s) for s in specs], n_in)
