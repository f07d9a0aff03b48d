"""DGCNN backbone: four EdgeConv blocks -> concat -> pointwise conv to
emb_dims.

Port of point_cloud_reid_tpu/models/dgcnn.py (EdgeConv, DGCNNBackbone).
Channel-last: pts (B, N, 3) -> (pts, per-point features (B, N, emb_dims)).

Names follow the reference state dict (dgcnn_orig.py:89-152): each block's
conv is backbone.conv{i}.0 and its BatchNorm backbone.bn{i}; the reference's
Sequential registers that BatchNorm a second time as conv{i}.1, which the
port does not (an EdgeConv takes its BatchNorm as an argument). conv5.0 and
bn5 are the final conv and its BatchNorm. The convs are Linear layers
without bias ((out, in) weights; the reference's 1x1 Conv2d / Conv1d weights
squeeze to them). LeakyReLU slope 0.2; BatchNorm momentum 0.9 in flax's
convention (0.1 in torch's) and eps 1e-5, as models/layers.BatchNorm.

The kNN runs in feature space on every block's input (ops.geometry.
knn_feature_space: expanded-form distances in the input's dtype, the lower
index first among equal distances; on the card the kNN kernel of
kernels/knn.py, tier C past 3 channels or at bf16).

An EdgeConv block never holds the (B, N, k, .) edge tensor of the whole
batch (21.5 GB a tensor at 256 pairs of 2048 points, block 4): the conv
runs as per-point factors gathered onto the edges over chunks of centre
points, each chunk reduced to its statistics and its max over the
neighbours (_EdgeConvChunks); the backward recomputes each chunk from the
saved input and kNN indices. Train-mode statistics are over every edge.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import knn_feature_space
from ..parallel.distributed import dp_active, dp_group, global_sum, group_total
from ..utils.cache import cast
from .layers import BatchNorm, Dense, _wide

SLOPE = 0.2
# the most bytes a chunk's (rows, k, features) edge tensor may take at 4
# bytes an element: chunk sizes follow from the shapes
EDGE_CHUNK_BYTES = 1 << 30


def edge_chunks(rows: int, k: int, width: int) -> List[Tuple[int, int]]:
    """[r0, r1) ranges of the B * N centre rows, in order, each row's k x
    width float32 edges within EDGE_CHUNK_BYTES a chunk."""
    step = max(1, EDGE_CHUNK_BYTES // (4 * k * width))
    return [(r, min(rows, r + step)) for r in range(0, rows, step)]


def _factor_weights(weight: torch.Tensor, dt):
    """The conv's (F, 2C) weight W = [W_a | W_b] as the two factors of
    W [x_j - x_i || x_i] = W_a x_j + (W_b - W_a) x_i, in the compute dtype
    (the difference taken in the weight's dtype, then cast)."""
    C = weight.shape[1] // 2
    w_a, w_d = weight[:, :C], weight[:, C:] - weight[:, :C]
    if dt is None:
        return w_a, w_d
    return cast(weight, dt)[:, :C], w_d.to(dt)


def _pre(p: torch.Tensor, q: torch.Tensor, gidx: torch.Tensor, r0: int,
         r1: int) -> torch.Tensor:
    """The conv's output on the edges of centre rows [r0, r1): the
    neighbours' factor rows p[gidx] plus the centre's q, (r, k, F)."""
    rows = p.index_select(0, gidx[r0:r1].reshape(-1))
    return rows.view(r1 - r0, -1, p.shape[1]).add_(q[r0:r1, None, :])


class _EdgeConvChunks(torch.autograd.Function):
    """conv -> BatchNorm -> LeakyReLU -> max over k, chunk by chunk of
    centre rows. The conv of an edge [x_j - x_i || x_i] is computed as
    gathered per-point factors, W_a x_j + (W_b - W_a) x_i (two products
    over the B N points, as the SA kernel splits its conv1), in the
    Dense's compute dtype `dt`; the BatchNorm widened to float32 and cast
    to `bn_dt`, LeakyReLU and the max in it, as EdgeConv's modules.

    Forward, one pass over the chunks: in train mode each chunk's conv
    output gives its mean and biased variance (torch.var_mean), combined
    exactly over the chunks (in a data-parallel step the (sums, sums of
    squares, count) go through one global_sum as _GlobalBatchNorm's do,
    and a checkpoint's recompute replays them); in eval mode the running
    statistics. Each chunk also keeps its conv output's max and min over
    k: BatchNorm with a positive scale (gamma rsqrt(var + eps)), the cast
    and LeakyReLU are non-decreasing, so the max over k of the block's
    output is that of the conv's max (or min, where gamma < 0), and only
    (B N, F) values are normalised. Outputs (out, mean, var): the caller
    moves the running statistics.

    Backward, one pass that recomputes each chunk. With r = rsqrt(var +
    eps), a = gamma r, xhat = (y - mean) r, and dz the gradient at the
    BatchNorm's output through the max (split evenly among equal maxima,
    as torch's amax does) and LeakyReLU, the conv's output gradient is dy =
    a (dz - S / n - xhat T / n), S = sum(dz) and T = sum(dz xhat) over
    every edge (all-reduced in a data-parallel step). dy is linear in dz
    and xhat, so the pass sums each onto the neighbours' factor rows
    (index_add_) and over each centre's k edges, with S and T, in float32
    (float64 for a float64 model); then the factors' gradients, the
    input's and the weight's are products over the points. dgamma = T and
    dbeta = S stay this rank's, as _GlobalBatchNorm's do. The kNN indices
    are saved, not recomputed."""

    @staticmethod
    def forward(ctx, x, weight, gamma, beta, gidx, train: bool, dt, bn_dt,
                eps: float, running_mean, running_var):
        xf = x.reshape(-1, x.shape[-1])
        rows, k = gidx.shape
        F_out = weight.shape[0]
        w_a, w_d = _factor_weights(weight, dt)
        xd = xf if dt is None else xf.to(dt)
        p, q = F.linear(xd, w_a), F.linear(xd, w_d)
        top = p.new_empty((rows, F_out))
        low = p.new_empty((rows, F_out))
        parts = []
        for r0, r1 in edge_chunks(rows, k, F_out):
            y = _pre(p, q, gidx, r0, r1)
            torch.amax(y, dim=1, out=top[r0:r1])
            torch.amin(y, dim=1, out=low[r0:r1])
            if train:
                var_c, mean_c = torch.var_mean(_wide(y).reshape(-1, F_out),
                                               0, correction=0)
                parts.append(((r1 - r0) * k, mean_c, var_c))
            del y
        n = rows * k
        if train:
            mean = sum(c * m for c, m, _ in parts) / n
            var = sum(c * (v + (m - mean) ** 2) for c, m, v in parts) / n
            count = mean.new_full((1,), n)
            if dp_active():
                sums = global_sum(torch.cat([mean * n, (var + mean * mean) * n,
                                             count]))
                count = sums[-1:]
                mean = sums[:F_out] / count
                var = (sums[F_out:2 * F_out] / count - mean * mean).clamp(
                    min=0.0)
        else:
            mean, var = running_mean.clone(), running_var.clone()
            count = mean.new_full((1,), n)
        out = _bn_act(torch.where(gamma >= 0, top, low), mean, var, gamma,
                      beta, eps, bn_dt)
        ctx.train, ctx.dt, ctx.bn_dt, ctx.eps = train, dt, bn_dt, eps
        ctx.group = dp_group()
        ctx.x_shape = x.shape
        ctx.save_for_backward(x, weight, gamma, beta, gidx, mean, var, count)
        ctx.mark_non_differentiable(mean, var)
        return out.view(x.shape[:-1] + (F_out,)), mean, var

    @staticmethod
    def backward(ctx, dout, *_):
        x, weight, gamma, beta, gidx, mean, var, count = ctx.saved_tensors
        dt, bn_dt, eps = ctx.dt, ctx.bn_dt, ctx.eps
        xf = x.reshape(-1, x.shape[-1])
        C = xf.shape[1]
        rows, k = gidx.shape
        F_out = weight.shape[0]
        dout = dout.reshape(rows, F_out)
        w_a, w_d = _factor_weights(weight, dt)
        xd = xf if dt is None else xf.to(dt)
        p, q = F.linear(xd, w_a), F.linear(xd, w_d)
        r = torch.rsqrt(var + eps)
        acc = torch.promote_types(x.dtype, torch.float32)
        # dz and xhat: scattered onto the neighbours, summed a centre
        nb_dz = torch.zeros((rows, F_out), dtype=acc, device=x.device)
        ce_dz = torch.zeros_like(nb_dz)
        if ctx.train:
            nb_x, ce_x = torch.zeros_like(nb_dz), torch.zeros_like(nb_dz)
        s_loc = torch.zeros_like(mean)
        t_loc = torch.zeros_like(mean)
        for r0, r1 in edge_chunks(rows, k, F_out):
            yw = _wide(_pre(p, q, gidx, r0, r1))
            act = F.leaky_relu(_bn(yw, mean, var, gamma, beta, eps, bn_dt),
                               SLOPE)
            best = act.amax(dim=1, keepdim=True)
            top = act == best
            del act
            # the gradient at the BatchNorm's output: nonzero at the maxima
            # alone, where LeakyReLU's slope follows the max's sign
            g = dout[r0:r1, None, :] / top.sum(1, keepdim=True)
            dz = _wide(top * torch.where(best > 0, g, g * SLOPE))
            del top, g, best
            xhat = (yw - mean) * r
            del yw
            s_loc += dz.sum((0, 1))
            t_loc += (dz * xhat).sum((0, 1))
            idx = gidx[r0:r1].reshape(-1)
            nb_dz.index_add_(0, idx, dz.reshape(-1, F_out))
            ce_dz[r0:r1] = dz.sum(1)
            if ctx.train:
                nb_x.index_add_(0, idx, xhat.reshape(-1, F_out))
                ce_x[r0:r1] = xhat.sum(1)
            del dz, xhat
        a = gamma * r
        if ctx.train:
            both = group_total(torch.cat([s_loc, t_loc]), ctx.group) / count
            s_n, t_n = both[:F_out], both[F_out:]
            deg = torch.bincount(gidx.reshape(-1), minlength=rows).to(acc)
            dp = a * (nb_dz - deg[:, None] * s_n - nb_x * t_n)
            dq = a * (ce_dz - k * s_n - ce_x * t_n)
        else:
            dp, dq = a * nb_dz, a * ce_dz
        xa = xf.to(acc)
        w = weight.to(acc)
        dx = dp @ w[:, :C] + dq @ (w[:, C:] - w[:, :C])
        dw_a, dw_d = dp.t() @ xa, dq.t() @ xa
        dw = torch.cat([dw_a - dw_d, dw_d], dim=1).to(weight.dtype)
        return (dx.to(x.dtype).view(ctx.x_shape), dw, t_loc, s_loc, None,
                None, None, None, None, None, None)


def _bn(yw, mean, var, gamma, beta, eps, bn_dt) -> torch.Tensor:
    """The block's BatchNorm with given statistics on the widened conv
    output, cast to its compute dtype."""
    z = F.batch_norm(yw.reshape(-1, yw.shape[-1]), mean, var, gamma, beta,
                     False, 0.0, eps).view(yw.shape)
    return z if bn_dt is None else z.to(bn_dt)


def _bn_act(y, mean, var, gamma, beta, eps, bn_dt) -> torch.Tensor:
    return F.leaky_relu(_bn(_wide(y), mean, var, gamma, beta, eps, bn_dt),
                        SLOPE)


class EdgeConv(nn.Sequential):
    """[neighbour - centre || centre] over the k nearest neighbours in
    feature space -> conv (child 0) -> the block's BatchNorm -> LeakyReLU
    -> max over the neighbours: (B, N, C) -> (B, N, features), over chunks
    of centre points (_EdgeConvChunks)."""

    def __init__(self, c_in: int, features: int, k: int):
        super().__init__(Dense(2 * c_in, features, bias=False))
        self.k = k

    def forward(self, x: torch.Tensor, bn: BatchNorm, train: bool = False
                ) -> torch.Tensor:
        B, N = x.shape[:2]
        idx = knn_feature_space(x.transpose(1, 2), self.k)
        gidx = (idx + N * torch.arange(B, device=idx.device)[:, None, None]
                ).reshape(B * N, self.k)
        out, mean, var = _EdgeConvChunks.apply(
            x.contiguous(), self[0].weight, bn.weight, bn.bias, gidx, train,
            self[0].compute_dtype, bn.compute_dtype, bn.eps, bn.running_mean,
            bn.running_var)
        if train:
            bn.update_running(mean, var)
        return out


class DGCNNBackbone(nn.Module):
    """forward(pts (B, N, 3), numpoints unused) -> (pts, (B, N, emb_dims))."""

    def __init__(self, emb_dims: int = 1024, k: int = 20):
        super().__init__()
        self.out_channels = emb_dims
        self.bn1 = BatchNorm(64)
        self.bn2 = BatchNorm(64)
        self.bn3 = BatchNorm(128)
        self.bn4 = BatchNorm(256)
        self.bn5 = BatchNorm(emb_dims)
        self.conv1 = EdgeConv(3, 64, k)
        self.conv2 = EdgeConv(64, 64, k)
        self.conv3 = EdgeConv(64, 128, k)
        self.conv4 = EdgeConv(128, 256, k)
        self.conv5 = nn.Sequential(Dense(512, emb_dims, bias=False))

    def forward(self, pts: torch.Tensor, numpoints: Sequence[int] = (),
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        x1 = self.conv1(pts, self.bn1, train)
        x2 = self.conv2(x1, self.bn2, train)
        x3 = self.conv3(x2, self.bn3, train)
        x4 = self.conv4(x3, self.bn4, train)
        x = self.conv5[0](torch.cat([x1, x2, x3, x4], dim=-1))
        return pts, F.leaky_relu(self.bn5(x, train), SLOPE)
