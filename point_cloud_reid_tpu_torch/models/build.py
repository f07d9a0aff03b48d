"""Model factory: config dict -> eval-mode nn.Module on a device.

Port of point_cloud_reid_tpu/models/build.py for the types 'ReIDNet' and
'ReIDNetCosine' (points) and 'ImageReIDNet' (camera crops). Weights
are drawn from an explicit torch.Generator on the CPU and then moved, so a
seed gives the same model on every device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .image_reid import ImageReIDNet
from .reid_net import ReIDNet, ReIDNetCosine
from .vit import ViT


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: Linear weights and biases U(-1/sqrt(in),
    1/sqrt(in)) (PyTorch's default bounds); norm scales 1 + 0.1 N(0, 1) and
    shifts 0.1 N(0, 1); BatchNorm running means 0.1 N(0, 1) and variances
    U(0.5, 1.5), so the folded BN affines are not the identity. A ViT's
    patch embedding is drawn like a Linear over its fan-in, its tokens,
    position embedding and relative-position table 0.02 N(0, 1); its
    LayerScale factors keep their 0.1."""
    def normal(t):
        return torch.randn(t.shape, generator=generator, dtype=t.dtype)

    def uniform(t, lo, hi):
        return lo + (hi - lo) * torch.rand(t.shape, generator=generator,
                                           dtype=t.dtype)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.copy_(uniform(m.weight, -bound, bound))
            if m.bias is not None:
                m.bias.copy_(uniform(m.bias, -bound, bound))
        elif isinstance(m, ViT):
            for p in (m.cls_token, m.dist_token, m.pos_embed,
                      m.rel_pos_table):
                if p is not None:
                    p.copy_(0.02 * normal(p))
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d)):
            m.weight.copy_(1.0 + 0.1 * normal(m.weight))
            m.bias.copy_(0.1 * normal(m.bias))
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.copy_(0.1 * normal(m.running_mean))
                m.running_var.copy_(uniform(m.running_var, 0.5, 1.5))


_TYPES = {"ReIDNet": ReIDNet, "ReIDNetCosine": ReIDNetCosine,
          "ImageReIDNet": ImageReIDNet}


def build_model(cfg: Dict[str, Any], device: Optional[torch.device] = None,
                generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32) -> nn.Module:
    """Build the model of `cfg` in eval mode on `device`, with weights from
    `generator` (a CPU generator; seed 0 when omitted). The parameters are
    float32 at every `dtype`; with dtype=torch.bfloat16 the model computes
    in bf16 where the JAX package's build_model(cfg, dtype=bfloat16) does
    (models/layers.py), from the same seeded weights."""
    cfg = dict(cfg)
    t = cfg.pop("type", "ReIDNet")
    if t not in _TYPES:
        raise NotImplementedError(f"model type {t}")
    model = _TYPES[t](**cfg, dtype=dtype)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    model.eval().requires_grad_(False)
    return model.to(device) if device is not None else model
