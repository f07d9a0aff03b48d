"""Config dicts -> modules (port of point_cloud_reid_tpu/models/registry.py).

Head configs are lists of dicts like [{'type': 'LinearRes', ...}, {'type':
'Linear', ...}], as in the reidentifier config files. The point backbones of
the registered leaves (point-transformer, PointNet, DGCNN) and the stage
types of the point and image heads are ported; VNDGCNN, the
local_self_attention and loftr stages and the PostRes / Res1d head layers
raise and wait for the rest of the model zoo (M7).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import torch
import torch.nn as nn

from ..utils.cache import cast
from .attention_blocks import (CrossAttentionBlock, CrossLinAttn,
                               SelfAttentionBlock)
from .dgcnn import DGCNNBackbone
from .layers import (BatchNorm, Dense, GroupNorm, LayerNorm, LinearRes,
                     add_bias, group_norm)
from .point_transformer import PointTransformerBackbone
from .pointnet import PointNetBackbone

Spec = Dict[str, Any]


class _Conv1d(nn.Conv1d):
    """Conv1d over a channel-last (B, L, C) input, stride 1, no padding;
    with a compute dtype, as flax's Conv(dtype=...)."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x).transpose(1, 2)
        return add_bias(self._conv_forward(x.to(dt), cast(self.weight, dt),
                                           None).transpose(1, 2), self.bias)


class SequentialHead(nn.ModuleList):
    """Sequential stack built from config specs; threads `train` to the
    BatchNorm layers. Layer j is `{j}` in the state dict and
    `{j}_{type}` in the JAX package's variable tree.

    Types: LinearRes, Linear, Conv1d (real 1-D conv, no padding),
    BatchNorm1d, GroupNorm, LayerNorm, ReLU, Sigmoid. PostRes and Res1d
    (conv residual blocks no point-model head uses) wait for M7."""

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
            elif t in ("PostRes", "Res1d"):
                raise NotImplementedError(
                    f"SequentialHead type {t} is not ported yet (M7)")
            else:
                raise NotImplementedError(f"SequentialHead type {t}")
        super().__init__(layers)
        self.types = [spec["type"] for spec in specs]
        self.out_width = width

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, (LinearRes, BatchNorm)):
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
        for knob in ("fused_train", "remat_stages"):
            if cfg.get(knob):
                raise NotImplementedError(
                    f"backbone {knob} is not ported (measured negative in "
                    "the JAX package)")
        return PointTransformerBackbone(
            input_channels=cfg.get("input_channels", 0),
            conv_out=cfg.get("conv_out", 32), mul=cfg.get("mul", 1),
            nsample=tuple(cfg.get("nsample", (32, 48, 48))),
            knn_method=knn_method)
    if t in ("PointNet", "pointnet"):
        return PointNetBackbone(
            channel=6 if cfg.get("normal_channel", True) else 3)
    if t in ("dgcnn", "DGCNN"):
        return DGCNNBackbone(emb_dims=cfg.get("emb_dims", 1024),
                             k=cfg.get("k", 20))
    raise NotImplementedError(f"backbone type {t} is not ported yet (M7)")


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
    if t == "Self_Attention":
        return SelfAttentionBlock(**kw)
    raise NotImplementedError(f"stage type {t} is not ported yet (M7)")


def build_head(cfg: Union[None, Spec, List[Spec]], n_in: int
               ) -> Optional[SequentialHead]:
    """None | single spec | list of specs -> SequentialHead or None. `n_in`
    is the input width (torch layers are sized when they are built)."""
    if not cfg:
        return None
    specs = cfg if isinstance(cfg, (list, tuple)) else [cfg]
    return SequentialHead([dict(s) for s in specs], n_in)
