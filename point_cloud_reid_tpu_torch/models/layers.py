"""Shared building blocks (port of point_cloud_reid_tpu/models/layers.py).

Channel-last (B, N, C) tensors throughout, as in the JAX package. Module and
parameter names follow the reference state dict (lanegcn_nets.py LinearRes:
linear1/norm1/linear2/norm2/transform.{0,1}; pos_mlp.{0,2} Sequentials), so
a reference checkpoint's keys name the same tensors here. The SA stages'
Conv-BN-ReLU layers live in models/point_transformer.py as mlp_convs /
mlp_bns: in eval mode they run folded into the sa_stage kernel, in train
mode through `BatchNorm.forward(x, train=True)` here.

Modules take an explicit `train` flag, as the JAX modules do; nn.Module's
own training flag is not read.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over all leading axes of a channel-last (..., C) tensor,
    with flax's running statistics: ra = 0.9 ra + 0.1 batch, where the batch
    variance is the BIASED one (torch.nn.BatchNorm1d stores the unbiased
    one), eps 1e-5. State-dict names are BatchNorm1d's."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        if not train:
            y = F.batch_norm(flat, self.running_mean, self.running_var,
                             self.weight, self.bias, False, 0.0, self.eps)
            return y.reshape(x.shape)
        n = flat.shape[0]
        # momentum 1 makes the kernel write the batch mean and the unbiased
        # batch variance into these buffers
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(flat, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m * (n - 1) / n)
        return y.reshape(x.shape)


def group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm of a channel-last (B, ..., C) tensor with flax's
    statistics: per sample and group over every non-batch axis."""
    if x.dim() == 2:
        return norm(x)
    return norm(x.movedim(-1, 1)).movedim(1, -1)


class LinearRes(nn.Module):
    """y = relu(norm(W2 relu(norm(W1 x))) + T(x)), biasless linears, GN or
    BN with eps 1e-5 (reference lanegcn_nets.py:193-241)."""

    def __init__(self, n_in: int, n_out: int, norm: str = "GN", ng: int = 32):
        super().__init__()
        if norm not in ("GN", "BN"):
            raise ValueError(f"LinearRes norm {norm}")

        def make_norm():
            if norm == "GN":
                return nn.GroupNorm(math.gcd(ng, n_out), n_out, eps=1e-5)
            return BatchNorm(n_out)

        self.linear1 = nn.Linear(n_in, n_out, bias=False)
        self.norm1 = make_norm()
        self.linear2 = nn.Linear(n_out, n_out, bias=False)
        self.norm2 = make_norm()
        if n_in != n_out:
            self.transform = nn.Sequential(
                nn.Linear(n_in, n_out, bias=False), make_norm())
        else:
            self.transform = None

    @staticmethod
    def _norm(norm: nn.Module, x: torch.Tensor, train: bool) -> torch.Tensor:
        if isinstance(norm, BatchNorm):
            return norm(x, train)
        return group_norm(norm, x)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(self._norm(self.norm1, self.linear1(x), train))
        out = self._norm(self.norm2, self.linear2(out), train)
        if self.transform is not None:
            sc = self._norm(self.transform[1], self.transform[0](x), train)
        else:
            sc = x
        return torch.relu(out + sc)


def pos_mlp(d_model: int, d_out: int | None = None) -> nn.Sequential:
    """Positional encoder Linear(3->d) -> ReLU -> Linear(d->out)
    (reference Self_Attention.pos_mlp, pointnet2_utils.py:66-70)."""
    return nn.Sequential(nn.Linear(3, d_model), nn.ReLU(),
                         nn.Linear(d_model, d_out or d_model))


def pooled_feats(h: torch.Tensor, pool_type: str = "both") -> torch.Tensor:
    """(B, N, C) -> (B, C) max over points, or (B, 2C) [max || avg] for the
    flagship's 'both' pooling (reference get_pooled_feats,
    ReIDNet.py:526-534)."""
    if pool_type == "max":
        return h.amax(dim=1)
    if pool_type == "both":
        return torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
    raise NotImplementedError(pool_type)
