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
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.distributed import (dp_active, dp_group, global_sum,
                                    group_total, recording, replaying)
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


class Conv1d(nn.Conv1d):
    """nn.Conv1d as flax's Conv(dtype=compute_dtype), as Dense."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return add_bias(self._conv_forward(x.to(dt), cast(self.weight, dt),
                                           None), self.bias, dim=-2)


def same_pads(size: int, k: int, stride: int) -> tuple:
    """(before, after) padding of flax's padding='SAME' along an axis of
    `size`: ceil(size / stride) outputs, the odd pixel after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_channel_last(conv: nn.Module, x: torch.Tensor, pads) -> torch.Tensor:
    """A channel-first Conv1d / Conv2d over a channel-last (B, L, C) or
    (B, H, W, C) input, with explicit (before, after) pads per spatial axis
    (the conv's own padding is 0)."""
    h = x.movedim(-1, 1)
    flat = [p for axis in reversed(pads) for p in axis]   # last axis first
    if any(flat):
        h = F.pad(h, flat)
    return conv(h).movedim(1, -1)


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


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of (M, C) rows on the statistics of the
    data-parallel group's rows, through batch norm's fused kernels.

    Forward: this rank's mean and biased variance (one pass), one
    all-reduce of the sums, the sums of squares and the counts (global_sum,
    which a checkpoint's recompute replays), the global mean and flax's
    variance E[x^2] - E[x]^2 clamped at 0, and the eval-mode kernel with
    them (one pass). Backward, with r = rsqrt(var + eps), a = gamma r,
    xhat = (x - mean) r and N the global count: S = sum(dy) and T =
    sum(dy xhat) over this rank's rows (one pass), one all-reduce of S and
    T, then

        dx = a (dy - S / N - xhat T / N),

    SyncBatchNorm's two kernels on the card (batch_norm_backward_reduce,
    batch_norm_backward_elemt: one pass each); on the CPU the eval-mode
    backward kernel and two elementwise passes. dgamma = T and dbeta = S
    stay this rank's: the train step's all-reduce of the gradients sums
    them."""

    @staticmethod
    def forward(ctx, flat, weight, bias, eps):
        C = flat.shape[1]
        var_l, mean_l = torch.var_mean(flat, 0, correction=0)
        n = flat.shape[0]
        sums = global_sum(torch.cat([mean_l * n,
                                     (var_l + mean_l * mean_l) * n,
                                     mean_l.new_full((1,), n)]))
        count = sums[-1:]
        mean = sums[:C] / count
        var = (sums[C:2 * C] / count - mean * mean).clamp(min=0.0)
        y = F.batch_norm(flat, mean, var, weight, bias, False, 0.0, eps)
        ctx.eps, ctx.group = eps, dp_group()
        ctx.save_for_backward(flat, weight, mean, var, count)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, *_):
        flat, weight, mean, var, count = ctx.saved_tensors
        dy = dy.contiguous()
        C = flat.shape[1]
        r = torch.rsqrt(var + ctx.eps)
        if flat.is_cuda:
            s_sum, xmu_sum, t_sum, _ = torch.batch_norm_backward_reduce(
                dy, flat, mean, r, weight, True, True, False)
            both = group_total(torch.cat([s_sum, xmu_sum]), ctx.group)
            n = torch.round(count).to(torch.int32)
            dx = torch.batch_norm_backward_elemt(dy, flat, mean, r, weight,
                                                 both[:C], both[C:], n)
            return dx, t_sum, s_sum, None
        none = flat.new_empty(0)
        dx, t_sum, s_sum = torch.ops.aten.native_batch_norm_backward(
            dy, flat, weight, mean, var, none, none, False, ctx.eps,
            [True, True, True])
        both = group_total(torch.cat([s_sum, t_sum]), ctx.group) / count
        a = weight * r
        k1 = -a * r * both[C:]
        dx.addcmul_(flat, k1).sub_(a * both[:C] + k1 * mean)
        return dx, t_sum, s_sum, None


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over all leading axes of a channel-last (..., C) tensor,
    with flax's running statistics: ra = 0.9 ra + 0.1 batch, where the batch
    variance is the BIASED one (torch.nn.BatchNorm1d stores the unbiased
    one), eps 1e-5. State-dict names are BatchNorm1d's. A train-mode call
    updates the running statistics unless `update_stats` is False
    (frozen_statistics). In a data-parallel step (parallel.distributed.
    data_parallel) the statistics are the global batch's (_GlobalBatchNorm:
    the sums, sums of squares and counts of every rank reduced in one
    all-reduce, flax's variance E[x^2] - E[x]^2 clamped at 0)."""

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
        if dp_active():
            return self._global_batch_norm(flat).reshape(x.shape)
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

    def _global_batch_norm(self, flat: torch.Tensor) -> torch.Tensor:
        y, mean, var = _GlobalBatchNorm.apply(flat, self.weight, self.bias,
                                              self.eps)
        self.update_running(mean, var)
        return y

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """ra = 0.9 ra + 0.1 batch from a batch mean and BIASED variance
        (JAX's ConvBNReLU.update_stats, for paths that compute their own
        statistics); nothing while update_stats is False."""
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(var, alpha=m)


@contextlib.contextmanager
def frozen_statistics(model: nn.Module, tape: Optional[list] = None
                      ) -> Iterator[None]:
    """Train-mode BatchNorm calls of `model` inside the block normalise
    with batch statistics but leave the running statistics as they are:
    the recompute of a checkpointed forward (train/loop.py, remat) must not
    move them a second time. In a data-parallel step the global statistics
    come from `tape`, the forward's record (stage_checkpoint), and no
    collective is issued."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        with (contextlib.nullcontext() if tape is None
              else replaying(list(tape))):
            yield
    finally:
        for m in bns:
            del m.update_stats


def stage_contexts(module: nn.Module):
    """torch.utils.checkpoint's context_fn for a forward of `module`: the
    forward records a data-parallel step's global statistics, the
    recompute replays them with `module`'s BatchNorm running statistics
    frozen."""
    tape: list = []
    return recording(tape), frozen_statistics(module, tape)


def stage_checkpoint(module: nn.Module, fn, *args, **kwargs):
    """fn(*args, **kwargs), a forward of `module`, under non-reentrant
    torch.utils.checkpoint: only its inputs and outputs are kept, and the
    backward runs it again (stage_contexts)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: stage_contexts(module), **kwargs)


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


def norm_channel_last(norm: nn.Module, x: torch.Tensor,
                      train: bool) -> torch.Tensor:
    """A BatchNorm or a GroupNorm of a channel-last tensor."""
    if isinstance(norm, BatchNorm):
        return norm(x, train)
    return group_norm(norm, x)


def make_norm(norm: str, n_out: int, ng: int = 32) -> nn.Module:
    """The residual blocks' norms: 'GN' (gcd(ng, n_out) groups) or 'BN',
    eps 1e-5."""
    if norm == "GN":
        return GroupNorm(math.gcd(ng, n_out), n_out, eps=1e-5)
    if norm == "BN":
        return BatchNorm(n_out)
    raise ValueError(f"norm {norm}")


class LinearRes(nn.Module):
    """y = relu(norm(W2 relu(norm(W1 x))) + T(x)), biasless linears, GN or
    BN with eps 1e-5 (reference lanegcn_nets.py:193-241)."""

    def __init__(self, n_in: int, n_out: int, norm: str = "GN", ng: int = 32):
        super().__init__()
        self.linear1 = Dense(n_in, n_out, bias=False)
        self.norm1 = make_norm(norm, n_out, ng)
        self.linear2 = Dense(n_out, n_out, bias=False)
        self.norm2 = make_norm(norm, n_out, ng)
        if n_in != n_out:
            self.transform = nn.Sequential(
                Dense(n_in, n_out, bias=False), make_norm(norm, n_out, ng))
        else:
            self.transform = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = torch.relu(norm_channel_last(self.norm1, self.linear1(x),
                                           train))
        out = norm_channel_last(self.norm2, self.linear2(out), train)
        if self.transform is not None:
            sc = norm_channel_last(self.transform[1], self.transform[0](x),
                                   train)
        else:
            sc = x
        return torch.relu(out + sc)


class _ConvRes(nn.Module):
    """What PostRes and Res1d share: conv1 (stride) -> bn1 -> ReLU -> conv2
    -> bn2, plus the input, through downsample.{0: 1x1 conv with the
    stride, 1: norm} when the stride or the width changes, then ReLU when
    `act`. Biasless convs over channel-last inputs; names are the
    reference's (lanegcn_nets.py; flax: downsample_conv, downsample_norm)."""

    def _build(self, conv, n_in, n_out, k, stride, norm, ng, act):
        self.stride, self.act = stride, act
        self.conv1 = conv(n_in, n_out, k, stride=stride, bias=False)
        self.bn1 = make_norm(norm, n_out, ng)
        self.conv2 = conv(n_out, n_out, k, bias=False)
        self.bn2 = make_norm(norm, n_out, ng)
        if stride != 1 or n_in != n_out:
            self.downsample = nn.Sequential(
                conv(n_in, n_out, 1, stride=stride, bias=False),
                make_norm(norm, n_out, ng))
        else:
            self.downsample = None

    def _pads(self, x: torch.Tensor, k: int, stride: int):
        raise NotImplementedError

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        k = self.conv1.kernel_size[0]
        out = conv_channel_last(self.conv1, x, self._pads(x, k, self.stride))
        out = torch.relu(norm_channel_last(self.bn1, out, train))
        out = conv_channel_last(self.conv2, out, self._pads(out, k, 1))
        out = norm_channel_last(self.bn2, out, train)
        if self.downsample is not None:
            x = conv_channel_last(self.downsample[0], x,
                                  self._pads(x, 1, self.stride))
            x = norm_channel_last(self.downsample[1], x, train)
        out = out + x
        return torch.relu(out) if self.act else out


class PostRes(_ConvRes):
    """3x3 conv residual block over NHWC (B, H, W, C) inputs, flax's 'SAME'
    padding (at stride 2 the odd row and column pad after), GN or BN
    (lanegcn_nets.py:91-139)."""

    def __init__(self, n_in: int, n_out: int, stride: int = 1,
                 norm: str = "GN", ng: int = 32, act: bool = True):
        super().__init__()
        self._build(Conv2d, n_in, n_out, 3, stride, norm, ng, act)

    def _pads(self, x, k, stride):
        return [same_pads(x.shape[1], k, stride),
                same_pads(x.shape[2], k, stride)]


class Res1d(_ConvRes):
    """1-D conv residual block over (B, L, C) inputs: kernel_size convs
    padded (k - 1) // 2 on both sides, the 1-wide downsample unpadded
    (lanegcn_nets.py:142-191)."""

    def __init__(self, n_in: int, n_out: int, kernel_size: int = 3,
                 stride: int = 1, norm: str = "GN", ng: int = 32,
                 act: bool = True):
        super().__init__()
        self._build(Conv1d, n_in, n_out, kernel_size, stride, norm, ng, act)

    def _pads(self, x, k, stride):
        return [((k - 1) // 2, (k - 1) // 2)]


def pos_mlp(d_model: int, d_out: int | None = None) -> nn.Sequential:
    """Positional encoder Linear(3->d) -> ReLU -> Linear(d->out)
    (reference Self_Attention.pos_mlp, pointnet2_utils.py:66-70)."""
    return nn.Sequential(Dense(3, d_model), nn.ReLU(),
                         Dense(d_model, d_out or d_model))


def combine_features(o1: torch.Tensor, o2: torch.Tensor,
                     combine: str) -> torch.Tensor:
    """The match heads' combine of the two sides' (B, N, C) features:
    'add', 'minus', 'cat' (channels, (B, N, 2C)) or 'point-cat' (points,
    (B, 2N, C)); reference ReIDNet.py:244-249."""
    if combine == "add":
        return o1 + o2
    if combine == "minus":
        return o1 - o2
    if combine == "cat":
        return torch.cat([o1, o2], dim=-1)
    if combine == "point-cat":
        return torch.cat([o1, o2], dim=1)
    raise NotImplementedError(combine)


def pooled_feats(h: torch.Tensor, pool_type: str = "both") -> torch.Tensor:
    """(B, N, C) -> (B, C) max over points, or (B, 2C) [max || avg] for the
    flagship's 'both' pooling (reference get_pooled_feats,
    ReIDNet.py:526-534)."""
    if pool_type == "max":
        return h.amax(dim=1)
    if pool_type == "both":
        return torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
    raise NotImplementedError(pool_type)
