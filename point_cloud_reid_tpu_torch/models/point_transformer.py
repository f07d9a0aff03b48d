"""The "point-transformer" backbone: PointNet++ SSG with linear self-attention.

Port of point_cloud_reid_tpu/models/point_transformer.py:

  3x SetAbstractionEdgeSA  RANDOM (first-n) centres, kNN grouping, the edge
     MLP (3x Conv-BN-ReLU) + max over neighbours, then a linear
     self-attention block. In eval mode the MLP and the max run through
     kernels/sa_stage (the CUDA kernel on the card); in train mode they are
     plain autograd code with batch statistics, or with fused_train the
     chain of ops/sa_train.py (its own backward, or autograd with
     fused_train_vjp=False; JAX's fused_train branch). A stage built with
     sampling="FPS" picks its centres by farthest point sampling
     (kernels/fps on the card) and, as in the JAX module, runs the plain
     chain in both modes: the fused SA kernel's centres are the first n.
  3x FeaturePropagationSA  attention upsampling from coarse to fine.
  cov_final                pointwise Linear -> (B, N, conv_out).

remat_stages (JAX's nn.remat of the named SA stages) runs those stages of a
train-mode forward under torch.utils.checkpoint (models.layers.
stage_checkpoint): the backward recomputes the stage with its BatchNorm
running statistics frozen.

Names follow the reference state dict: backbone.SA_modules.{i}.mlp_convs.{j},
.mlp_bns.{j}, .self_attention.*, backbone.FP_modules.{i}.interpolation.*,
backbone.cov_final. The convs are Linear layers ((out, in) weights; the
reference's 1x1 Conv2d weights squeeze to them).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..kernels.sa_stage import sa_stage_inference
from ..ops.geometry import (conv1_edge_factors, index_points, knn_indices,
                            sample_and_group_edge, sample_centers)
from ..ops.sa_train import sa_train_pooled, sa_train_reference
from .attention_blocks import FPSA, SelfAttentionBlock
from .layers import BatchNorm, Dense, stage_checkpoint


class SetAbstractionEdgeSA(nn.Module):
    """One SA stage. mlp = [in, h1, h2, h3], where `in` is the edge-feature
    width 3 + 2D (3 when the stage has no input features). With a compute
    dtype (bf16) the conv1 factors A and Ct are computed in it, as the JAX
    stage computes them, and the stage's output is in it.

    fused_train: a train-mode forward runs the chain of ops/sa_train.py
    (sa_train_pooled, or sa_train_reference with fused_train_vjp=False) on
    the conv1 factors, with or without input features, and updates the
    running statistics from the chain's batch statistics. remat: the
    backbone runs this stage under torch.utils.checkpoint in train mode."""

    compute_dtype = None

    def __init__(self, mlp: Sequence[int], nsample: int,
                 knn_method: str = "argsort", sampling: str = "RANDOM",
                 fused_train: bool = False, fused_train_vjp: bool = True,
                 remat: bool = False):
        super().__init__()
        if sampling not in ("RANDOM", "FPS"):
            raise ValueError(f"unknown sampling {sampling}")
        self.nsample = nsample
        self.knn_method = knn_method
        self.sampling = sampling
        self.fused_train = fused_train
        self.fused_train_vjp = fused_train_vjp
        self.remat = remat
        self.mlp_convs = nn.ModuleList(
            Dense(a, b) for a, b in zip(mlp[:-1], mlp[1:]))
        self.mlp_bns = nn.ModuleList(BatchNorm(b) for b in mlp[1:])
        self.self_attention = SelfAttentionBlock(mlp[-1], nhead=2)

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                numpoints: int, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyz (B, N, 3); points (B, N, D) or None -> (B, S, 3), (B, S, C)."""
        if train and self.fused_train:
            new_xyz, h = self._fused_train_chain(xyz, points, numpoints)
            return new_xyz, self.self_attention(h, new_xyz)
        if train or self.sampling != "RANDOM":
            new_xyz, h = self._plain_chain(xyz, points, numpoints, train)
            return new_xyz, self.self_attention(h, new_xyz)
        cidx = torch.arange(numpoints, device=xyz.device).clamp(
            max=xyz.shape[1] - 1)
        new_xyz = xyz[:, cidx]
        idx = knn_indices(self.nsample, xyz, new_xyz, self.knn_method)
        convs = [(c.weight, c.bias) for c in self.mlp_convs]
        bns = [(b.weight, b.bias, b.running_mean, b.running_var)
               for b in self.mlp_bns]
        h = sa_stage_inference(xyz, points, idx, convs, bns,
                               eps=self.mlp_bns[0].eps,
                               dtype=self.compute_dtype)
        return new_xyz, self.self_attention(h, new_xyz)

    def _fused_train_chain(self, xyz, points, numpoints):
        """Centres, kNN, the conv1 factors and the fused chain; the running
        statistics move by the chain's batch statistics."""
        cidx = sample_centers(xyz, numpoints, self.sampling)
        new_xyz = index_points(xyz, cidx)
        idx = knn_indices(self.nsample, xyz, new_xyz, self.knn_method)
        conv1 = self.mlp_convs[0]
        A, Ct = conv1_edge_factors(
            conv1.weight.t(), conv1.bias, xyz, points, new_xyz,
            None if points is None else index_points(points, cidx),
            self.compute_dtype)
        (c2, c3), bns = self.mlp_convs[1:], self.mlp_bns
        chain = sa_train_pooled if self.fused_train_vjp else sa_train_reference
        out, stats = chain(
            (bns[0].eps, self.compute_dtype or A.dtype), A, Ct, idx,
            c2.weight.t(), c2.bias, c3.weight.t(), c3.bias,
            *[p for bn in bns for p in (bn.weight, bn.bias)])
        for bn, (mean, var) in zip(bns, stats):
            bn.update_running(mean, var)
        return new_xyz, out

    def _plain_chain(self, xyz, points, numpoints, train: bool):
        """The unfused edge MLP (conv + BatchNorm + ReLU, with batch
        statistics when train) and the max over K. With input features the
        first conv runs in factored form (conv1_edge_factors: one C-wide
        gather, the edge tensor is never built); without them (the first
        stage) the 3-wide edge tensor is built and convolved, as in the JAX
        stage."""
        conv1, bn1 = self.mlp_convs[0], self.mlp_bns[0]
        if points is None:
            new_xyz, edges = sample_and_group_edge(
                self.nsample, xyz, None, numpoints, sampling=self.sampling,
                knn_method=self.knn_method)
            h = conv1(edges)
        else:
            cidx = sample_centers(xyz, numpoints, self.sampling)
            new_xyz = index_points(xyz, cidx)
            idx = knn_indices(self.nsample, xyz, new_xyz, self.knn_method)
            A, Ct = conv1_edge_factors(conv1.weight.t(), conv1.bias, xyz,
                                       points, new_xyz,
                                       index_points(points, cidx),
                                       self.compute_dtype)
            h = index_points(A, idx) + Ct[:, :, None, :]
        h = torch.relu_(bn1(h, train))
        for conv, bn in zip(self.mlp_convs[1:], self.mlp_bns[1:]):
            h = torch.relu_(bn(conv(h), train))
        return new_xyz, h.amax(dim=2)


class FeaturePropagationSA(nn.Module):
    """FP stage: attention interpolation only (the reference's FP conv list
    is built but never used in its forward)."""

    def __init__(self, feat1_dim: int, feat2_dim: int, d_model: int,
                 out_dim: int):
        super().__init__()
        self.interpolation = FPSA(feat1_dim, feat2_dim, d_model, out_dim)

    def forward(self, xyz1, xyz2, points1, points2) -> torch.Tensor:
        return self.interpolation(points1, xyz1, points2, xyz2)


class PointTransformerBackbone(nn.Module):
    """forward(pts (B, N, 3), numpoints [n1, n2, n3]) -> (xyz (B, N, 3),
    feats (B, N, conv_out))."""

    def __init__(self, input_channels: int = 0, conv_out: int = 32,
                 mul: int = 1, nsample: Sequence[int] = (32, 48, 48),
                 knn_method: str = "argsort", fused_train: bool = False,
                 fused_train_vjp: bool = True,
                 remat_stages: Sequence[int] = ()):
        super().__init__()
        sa1, sa2, sa3 = 32 * mul, 64 * mul, 128 * mul
        self.SA_modules = nn.ModuleList([
            SetAbstractionEdgeSA(mlp, k, knn_method, fused_train=fused_train,
                                 fused_train_vjp=fused_train_vjp,
                                 remat=i in tuple(remat_stages))
            for i, (mlp, k) in enumerate((
                ([input_channels + 3, sa1, sa1, sa1], nsample[0]),
                ([sa2 + 3, sa2, sa2, sa2], nsample[1]),
                ([sa3 + 3, sa3, sa3, sa3], nsample[2])))])
        # widths as in the reference (backbone_net.py:84-86)
        self.FP_modules = nn.ModuleList([
            FeaturePropagationSA(3, sa2, sa2, sa1),
            FeaturePropagationSA(sa1, sa3, sa2, sa2),
            FeaturePropagationSA(sa2, sa3, sa2, sa3),
        ])
        self.cov_final = Dense(sa1, conv_out)
        self.out_channels = conv_out

    def forward(self, pointcloud: torch.Tensor, numpoints: Sequence[int],
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        xyz = pointcloud[..., :3]
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        l_xyz, l_feats = [xyz], [features]
        for i, sa in enumerate(self.SA_modules):
            args = (l_xyz[i], l_feats[i], numpoints[i], train)
            if train and sa.remat:
                li_xyz, li_feats = stage_checkpoint(sa, sa, *args)
            else:
                li_xyz, li_feats = sa(*args)
            l_xyz.append(li_xyz)
            l_feats.append(li_feats)
        l_feats[0] = xyz
        for i in (2, 1, 0):
            l_feats[i] = self.FP_modules[i](l_xyz[i], l_xyz[i + 1],
                                            l_feats[i], l_feats[i + 1])
        return l_xyz[0], self.cov_final(l_feats[0])
