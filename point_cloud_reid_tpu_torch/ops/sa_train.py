"""Train-mode SA conv chain with its own residual policy.

Port of point_cloud_reid_tpu/ops/sa_train.py (sa_train_pooled,
sa_train_reference, _pop_stats). The chain of one SA stage in train mode,

    h1 = gather(A, idx) + Ct        (B, S, K, C), the conv1 factoring
    z1 = relu(BN1(h1)),  h2 = z1 @ w2 + b2,  z2 = relu(BN2(h2)),
    h3 = z2 @ w3 + b3,   z3 = relu(BN3(h3)),  out = max over K of z3,

with BatchNorm on batch statistics over the population P = B S K (biased
variance, flax's E[x^2] - E[x]^2), as one function whose backward keeps

    A, Ct, idx, h2, h3 (the pre-BN conv outputs, compute dtype) and the
    per-layer BN coefficients,

and recomputes h1 by the gather, every elementwise value (normalised
outputs, ReLU masks, z) and the max-over-K tie masks. The BN backward is
the algebraic one over the population:

    dx = gamma r (dy - S / P - xhat T / P),  S = sum(dy), T = sum(dy xhat),
    dgamma = T,  dbeta = S,  r = rsqrt(var + eps).

Tie semantics are JAX's: the max over K splits the gradient evenly among
tied slots, and ReLU's derivative is 0 at exactly 0. sa_train_reference is
the same forward under autograd (torch.amax splits ties evenly as well),
the backbone's fused_train_vjp=False.

In a data-parallel step (parallel.distributed.data_parallel) the
population is the global batch's: the forward's sums go through
global_sum, and the backward reduces S, T over the ranks (each rank keeps
its own dgamma, dbeta, dW and db, whose all-reduce the train step does).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..parallel.distributed import dp_group, dp_size, global_sum, group_total
from .geometry import index_points

Stats = Tuple[Tuple[torch.Tensor, torch.Tensor], ...]


# the statistics and every elementwise value are float32 whatever the
# compute dtype, as in the JAX chain
F32 = torch.float32


def _pop_stats(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel population mean and biased variance over (B, S, K), in
    float32: E[x^2] - E[x]^2, unclamped, as the JAX chain. The sums and the
    count are the global batch's in a data-parallel step (global_sum)."""
    h32 = h.to(F32)
    C = h32.shape[-1]
    n = h32.shape[0] * h32.shape[1] * h32.shape[2]
    sums = global_sum(torch.cat([h32.sum((0, 1, 2)),
                                 (h32 * h32).sum((0, 1, 2)),
                                 h32.new_full((1,), n)]))
    mean, mean2 = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
    return mean, mean2 - mean * mean


def _bn_coeffs(gamma, beta, mean, var, eps: float):
    """Batch statistics folded into y = a h + c; also the mean and r."""
    r = torch.rsqrt(var + eps)
    a = gamma.to(r.dtype) * r
    c = beta.to(r.dtype) - mean * a
    return a, c, mean, r


def _gather_h1(A, Ct, idx):
    return index_points(A, idx) + Ct[:, :, None, :]


def _fwd_impl(eps: float, dt: torch.dtype, A, Ct, idx, w2, b2, w3, b3,
              g1, be1, g2, be2, g3, be3):
    wide = F32
    h1 = _gather_h1(A, Ct, idx)
    m1, v1 = _pop_stats(h1)
    a1, c1, _, _ = _bn_coeffs(g1, be1, m1, v1, eps)
    z1 = torch.relu(h1.to(wide) * a1 + c1).to(dt)
    h2 = (z1 @ w2.to(dt) + b2.to(dt)).to(dt)
    m2, v2 = _pop_stats(h2)
    a2, c2, _, _ = _bn_coeffs(g2, be2, m2, v2, eps)
    z2 = torch.relu(h2.to(wide) * a2 + c2).to(dt)
    h3 = (z2 @ w3.to(dt) + b3.to(dt)).to(dt)
    m3, v3 = _pop_stats(h3)
    a3, c3, _, _ = _bn_coeffs(g3, be3, m3, v3, eps)
    z3 = torch.relu(h3.to(wide) * a3 + c3).to(dt)
    out = z3.amax(dim=2)
    return out, ((m1, v1), (m2, v2), (m3, v3)), (h2, h3)


class _Chain(torch.autograd.Function):
    """The fused chain with the residual policy of the module docstring."""

    @staticmethod
    def forward(ctx, eps, dt, A, Ct, idx, w2, b2, w3, b3,
                g1, be1, g2, be2, g3, be3):
        out, stats, (h2, h3) = _fwd_impl(eps, dt, A, Ct, idx, w2, b2, w3,
                                         b3, g1, be1, g2, be2, g3, be3)
        coeffs = [_bn_coeffs(g, be, m, v, eps) for (g, be), (m, v) in zip(
            ((g1, be1), (g2, be2), (g3, be3)), stats)]
        ctx.dt = dt
        ctx.group, ctx.world = dp_group(), dp_size()
        ctx.save_for_backward(A, Ct, idx, w2, w3, h2, h3, out,
                              *[t for c in coeffs for t in c])
        ctx.dtypes = [t.dtype for t in (A, Ct, w2, b2, w3, b3,
                                        g1, be1, g2, be2, g3, be3)]
        flat = [t for mv in stats for t in mv]
        ctx.mark_non_differentiable(*flat)
        return (out, *flat)

    @staticmethod
    def backward(ctx, dout, *_):
        dt, group = ctx.dt, ctx.group
        A, Ct, idx, w2, w3, h2, h3, out, *co = ctx.saved_tensors
        (a1, c1, m1, r1), (a2, c2, m2, r2), (a3, c3, m3, r3) = (
            co[0:4], co[4:8], co[8:12])
        wide = F32
        dout = dout.to(wide)
        B, S, K = idx.shape
        P = float(B * S * K * ctx.world)

        def bn_bwd(dy, h32, a, m, r):
            xhat = (h32 - m) * r
            s_sum = dy.sum((0, 1, 2))
            t_sum = (dy * xhat).sum((0, 1, 2))
            # the population sums of every rank (the forward's group)
            both = group_total(torch.cat([s_sum, t_sum]), group)
            C = s_sum.shape[0]
            dh = a * (dy - both[:C] / P - xhat * (both[C:] / P))
            return dh, t_sum, s_sum

        def wgrad(zin, dh):
            return (zin.reshape(-1, zin.shape[-1]).to(wide).t()
                    @ dh.to(dt).to(wide).reshape(-1, dh.shape[-1]))

        def back_through(dh, w):
            return dh.to(dt).to(wide) @ w.to(dt).to(wide).t()

        # layer 3: max over K (ties split evenly), ReLU, BN
        h3_32 = h3.to(wide)
        y3 = h3_32 * a3 + c3
        z3 = torch.relu(y3).to(dt)
        eq = z3 == out[:, :, None, :]
        cnt = eq.sum(dim=2, keepdim=True).to(wide)
        dz3 = torch.where(eq, dout[:, :, None, :] / cnt,
                          torch.zeros((), dtype=wide, device=dout.device))
        dy3 = dz3 * (y3 > 0)
        dh3, dg3, dbe3 = bn_bwd(dy3, h3_32, a3, m3, r3)
        h2_32 = h2.to(wide)
        y2 = h2_32 * a2 + c2
        z2 = torch.relu(y2).to(dt)
        dW3 = wgrad(z2, dh3)
        db3 = dh3.sum((0, 1, 2))
        dz2 = back_through(dh3, w3)

        # layer 2
        dy2 = dz2 * (y2 > 0)
        dh2, dg2, dbe2 = bn_bwd(dy2, h2_32, a2, m2, r2)
        h1_32 = _gather_h1(A, Ct, idx).to(wide)       # recomputed: 1 gather
        y1 = h1_32 * a1 + c1
        z1 = torch.relu(y1).to(dt)
        dW2 = wgrad(z1, dh2)
        db2 = dh2.sum((0, 1, 2))
        dz1 = back_through(dh2, w2)

        # layer 1 -> the conv1 factors
        dy1 = dz1 * (y1 > 0)
        dh1, dg1, dbe1 = bn_bwd(dy1, h1_32, a1, m1, r1)
        dh1 = dh1.to(dt)
        C = A.shape[-1]
        flat = idx.reshape(B, S * K).long().clamp(0, A.shape[1] - 1)
        dA = torch.zeros(A.shape, dtype=dh1.dtype, device=A.device)
        dA.scatter_add_(1, flat[:, :, None].expand(-1, -1, C),
                        dh1.reshape(B, S * K, C))
        dCt = dh1.sum(dim=2)
        grads = (dA, dCt, dW2, db2, dW3, db3, dg1, dbe1, dg2, dbe2, dg3,
                 dbe3)
        (dA, dCt, dW2, db2, dW3, db3, dg1, dbe1, dg2, dbe2, dg3, dbe3) = (
            g.to(t) for g, t in zip(grads, ctx.dtypes))
        return (None, None, dA, dCt, None, dW2, db2, dW3, db3,
                dg1, dbe1, dg2, dbe2, dg3, dbe3)


def _unpack(cfg) -> Tuple[float, torch.dtype]:
    eps, dt = cfg
    return float(eps), dt


def sa_train_pooled(cfg, A, Ct, idx, w2, b2, w3, b3,
                    g1, be1, g2, be2, g3, be3) -> Tuple[torch.Tensor, Stats]:
    """The fused train-mode SA chain with the residual policy above.

    Args:
        cfg: (eps, compute dtype).
        A: (B, N, C) per-point conv1 factor; Ct: (B, S, C) per-centre term
            (ops.geometry.conv1_edge_factors).
        idx: (B, S, K) neighbour indices into N.
        w2 / b2, w3 / b3: conv2 / conv3 matrices (C, C) in (in, out) layout
            and biases (C,).
        g* / be*: the BatchNorms' scales and shifts (C,).
    Returns:
        out: (B, S, C) pooled stage features (before the self-attention);
        stats: ((mean, var),) * 3, each layer's batch statistics for the
            running-statistics update, without gradients.
    """
    eps, dt = _unpack(cfg)
    out, *flat = _Chain.apply(eps, dt, A, Ct, idx, w2, b2, w3, b3,
                              g1, be1, g2, be2, g3, be3)
    return out, tuple(zip(flat[0::2], flat[1::2]))


def sa_train_reference(cfg, A, Ct, idx, w2, b2, w3, b3,
                       g1, be1, g2, be2, g3, be3
                       ) -> Tuple[torch.Tensor, Stats]:
    """The same forward under autograd (the statistics detached)."""
    eps, dt = _unpack(cfg)
    out, stats, _ = _fwd_impl(eps, dt, A, Ct, idx, w2, b2, w3, b3,
                              g1, be1, g2, be2, g3, be3)
    return out, tuple((m.detach(), v.detach()) for m, v in stats)
