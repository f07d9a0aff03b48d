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

Compute dtype, as flax's `dtype=`: parameters stay float32, and a module
whose `compute_dtype` is set (models.build_model(dtype=torch.bfloat16) sets
it on every module that has the attribute) casts where flax casts. Dense,
Conv2d and Conv1d cast input, weight and bias to it and return it; the
norms compute their statistics and normalise in float32 (at least) and
return it. With `compute_dtype` None, the default, a module computes in its
parameters' dtype and nothing is cast.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.cache import cast


def set_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute dtype of every submodule that has one; float32
    leaves them unset (the parameters' own dtype, no casts)."""
    value = None if dtype == torch.float32 else dtype
    for m in model.modules():
        if hasattr(type(m), "compute_dtype"):
            m.compute_dtype = value
    return model


def _wide(x: torch.Tensor) -> torch.Tensor:
    """x promoted to at least float32: where flax's norms compute."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def add_bias(y: torch.Tensor, bias, dim: int = -1) -> torch.Tensor:
    """y + bias in y's dtype along `dim`: flax adds the bias after the
    product is rounded to the compute dtype, so a bf16 layer rounds twice
    (a bias fused into the product would round once, and differ from JAX
    in about a quarter of the outputs by one ulp)."""
    if bias is None:
        return y
    b = cast(bias, y.dtype)
    return y + (b if dim == -1 else b.reshape((-1,) + (1,) * (-dim - 1)))


class Dense(nn.Linear):
    """nn.Linear as flax's Dense(dtype=compute_dtype): input, weight and
    bias cast to the compute dtype (the weights' copies made once,
    utils/cache.py), the product and then the bias-add in it."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return add_bias(F.linear(x.to(dt), cast(self.weight, dt)),
                        self.bias)


class Conv2d(nn.Conv2d):
    """nn.Conv2d as flax's Conv(dtype=compute_dtype), as Dense."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return add_bias(self._conv_forward(x.to(dt), cast(self.weight, dt),
                                           None), self.bias, dim=-3)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm as flax's LayerNorm(dtype=compute_dtype): float32
    statistics, the result in the compute dtype."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.layer_norm(_wide(x), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(dt)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm as flax's GroupNorm(dtype=compute_dtype); applied to
    channel-last tensors through `group_norm`."""

    compute_dtype = None


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over all leading axes of a channel-last (..., C) tensor,
    with flax's running statistics: ra = 0.9 ra + 0.1 batch, where the batch
    variance is the BIASED one (torch.nn.BatchNorm1d stores the unbiased
    one), eps 1e-5. State-dict names are BatchNorm1d's. A train-mode call
    updates the running statistics unless `update_stats` is False
    (frozen_statistics)."""

    compute_dtype = None
    update_stats = True

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is not None:
            return self._forward(_wide(x), train).to(dt)
        return self._forward(x, train)

    def _forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
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
        if not self.update_stats:
            return y.reshape(x.shape)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean, alpha=m)
            self.running_var.mul_(1 - m).add_(var, alpha=m * (n - 1) / n)
        return y.reshape(x.shape)


@contextlib.contextmanager
def frozen_statistics(model: nn.Module) -> Iterator[None]:
    """Train-mode BatchNorm calls of `model` inside the block normalise
    with batch statistics but leave the running statistics as they are:
    the recompute of a checkpointed forward (train/loop.py, remat) must not
    move them a second time."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            del m.update_stats


def group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm of a channel-last (B, ..., C) tensor with flax's
    statistics: per sample and group over every non-batch axis."""
    dt = getattr(norm, "compute_dtype", None)
    if dt is not None:
        return _group_norm(norm, _wide(x)).to(dt)
    return _group_norm(norm, x)


def _group_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
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
                return GroupNorm(math.gcd(ng, n_out), n_out, eps=1e-5)
            return BatchNorm(n_out)

        self.linear1 = Dense(n_in, n_out, bias=False)
        self.norm1 = make_norm()
        self.linear2 = Dense(n_out, n_out, bias=False)
        self.norm2 = make_norm()
        if n_in != n_out:
            self.transform = nn.Sequential(
                Dense(n_in, n_out, bias=False), make_norm())
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
    return nn.Sequential(Dense(3, d_model), nn.ReLU(),
                         Dense(d_model, d_out or d_model))


def pooled_feats(h: torch.Tensor, pool_type: str = "both") -> torch.Tensor:
    """(B, N, C) -> (B, C) max over points, or (B, 2C) [max || avg] for the
    flagship's 'both' pooling (reference get_pooled_feats,
    ReIDNet.py:526-534)."""
    if pool_type == "max":
        return h.amax(dim=1)
    if pool_type == "both":
        return torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
    raise NotImplementedError(pool_type)
