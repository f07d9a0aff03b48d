"""ReIDNet, the Siamese point-cloud ReID model (port of models/reid_net.py).

The flagship config (match_type 'xcorr_eff', two cross-attention stages,
combine 'point-cat', pool 'both'), for serving and for training:

  embed(pts)             backbone embedding of a batch of crops;
  siamese(s1, s2)        both crops as one 2B batch through the backbone, so
                         BatchNorm sees both views;
  match_logits(...)      aligned pairs through both cross stages + head;
  match_logits_grid(...) the all-pairs grid with per-object work hoisted
                         (plain torch; the fused CUDA scorer in
                         kernels/match_grid.py is its drop-in equivalent);
  forward(batch, train)  everything the losses and metrics need.

Other match types, combines and backbones of the JAX model wait for M7.
`dtype` is the compute dtype (models/layers.py): float32 parameters at
every dtype; at bf16 the embeddings and logits are bf16 and xyz float32, as
in the JAX model.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import pooled_feats, set_compute_dtype
from .registry import build_backbone, build_head, build_stage


class ReIDNet(nn.Module):
    """Point-branch ReID network; config fields mirror the JAX ReIDNet."""

    def __init__(self, backbone: Dict[str, Any], match_head, cross_stage1,
                 cross_stage2, cls_head=None, shape_head=None, fp_head=None,
                 match_type: str = "xcorr_eff", pool_type: str = "both",
                 combine: str = "point-cat",
                 backbone_list: Sequence[int] = (128, 64, 32),
                 output_sequence_size: int = 32,
                 knn_method: str = "argsort",
                 dtype: torch.dtype = torch.float32, **unused):
        super().__init__()
        for s in (cross_stage1, cross_stage2):
            if not s or s.get("type") != "corss_attention":
                raise NotImplementedError(f"cross stage {s}")
        if (match_type, combine, pool_type) != ("xcorr_eff", "point-cat",
                                                "both"):
            raise NotImplementedError((match_type, combine, pool_type))
        for k, v in unused.items():
            if v not in (None, False) and k not in ("hidden_size",):
                raise NotImplementedError(f"{k}={v}")
        self.backbone_list = list(backbone_list)
        self.pool_type = pool_type
        self.backbone = build_backbone(dict(backbone), knn_method=knn_method)
        self.cross_stage1 = build_stage(cross_stage1)
        self.cross_stage2 = build_stage(cross_stage2)
        conv_out = backbone.get("conv_out", 32)
        self.match_head = build_head(match_head, 2 * cross_stage2["d_model"])
        self.cls_head = build_head(cls_head, 2 * conv_out)
        self.fp_head = build_head(fp_head, 2 * conv_out)
        self.shape_head = build_head(shape_head, conv_out)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def embed(self, pts: torch.Tensor, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, 3) crops -> xyz (B, N, 3), h (B, N, C)."""
        return self.backbone(pts, self.backbone_list, train)

    def siamese(self, sparse_1: torch.Tensor, sparse_2: torch.Tensor,
                train: bool = False):
        """Both crops as one 2B batch through the backbone, then split: the
        BatchNorm statistics cover both views."""
        b = sparse_1.shape[0]
        xyz, h = self.embed(torch.cat([sparse_1, sparse_2], dim=0), train)
        return xyz[:b], xyz[b:], h[:b], h[b:]

    def xcorr_eff(self, o1, xyz1, o2, xyz2):
        """Symmetric two-stage cross-attention, shared weights per stage.
        Returns (point-cat of both sides, o1, o2)."""
        o1_a = self.cross_stage1(o1, xyz1, o2, xyz2)
        o2_a = self.cross_stage1(o2, xyz2, o1, xyz1)
        o1_b = self.cross_stage2(o1_a, xyz1, o2_a, xyz2)
        o2_b = self.cross_stage2(o2_a, xyz2, o1_a, xyz1)
        return torch.cat([o1_b, o2_b], dim=1), o1_b, o2_b

    def match_logits(self, h1, xyz1, h2, xyz2, train: bool = False):
        """(B,) raw match logits of aligned pairs, and (o1, o2), the
        per-point features after the cross stages."""
        match_in, o1, o2 = self.xcorr_eff(h1, xyz1, h2, xyz2)
        pooled = pooled_feats(match_in, self.pool_type)
        return self.match_head(pooled, train)[..., 0], (o1, o2)

    def match_logits_grid(self, h_t, xyz_t, h_d, xyz_d) -> torch.Tensor:
        """(nt, nd) logits of every (track, det) pair, with the per-object
        work of stage 1 (queries, KV summaries) and stage 2's pos-MLP hoisted
        out of the pair batch, as ReIDNet.match_logits_grid in JAX."""
        nt, nd = h_t.shape[0], h_d.shape[0]
        npts = h_t.shape[1]

        def pair(a, b):
            pa = a[:, None].expand((nt, nd) + a.shape[1:])
            pb = b[None, :].expand((nt, nd) + b.shape[1:])
            return (pa.reshape((nt * nd,) + a.shape[1:]),
                    pb.reshape((nt * nd,) + b.shape[1:]))

        s1, s2 = self.cross_stage1, self.cross_stage2
        if s1.attention != "linear":
            # the decomposition below is the plain linear attention's:
            # any other primitive scores the materialised pair batch
            h1, h2 = pair(h_t, h_d)
            x1, x2 = pair(xyz_t, xyz_d)
            return self.match_logits(h1, x1, h2, x2)[0].reshape(nt, nd)
        q_t, q_d = s1.query_features(h_t), s1.query_features(h_d)
        kv_t, ks_t = s1.template_summary(h_t, xyz_t)
        kv_d, ks_d = s1.template_summary(h_d, xyz_d)
        h1, h2 = pair(h_t, h_d)
        q1, q2 = pair(q_t, q_d)
        kv1, kv2 = pair(kv_t, kv_d)
        ks1, ks2 = pair(ks_t, ks_d)
        o1_a = s1.finish_from_summary(h1, q1, kv2, ks2, npts)
        o2_a = s1.finish_from_summary(h2, q2, kv1, ks1, npts)
        pos1, pos2 = pair(s2.pos_mlp(xyz_t), s2.pos_mlp(xyz_d))
        o1_b = s2(o1_a, None, o2_a, None, template_pos=pos2)
        o2_b = s2(o2_a, None, o1_a, None, template_pos=pos1)
        pooled = pooled_feats(torch.cat([o1_b, o2_b], dim=1), self.pool_type)
        return self.match_head(pooled)[..., 0].reshape(nt, nd)

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                with_aux: bool = True) -> Dict[str, torch.Tensor]:
        """Full training / eval forward. batch: sparse_1, sparse_2 (B, N, 3)
        and optionally id_1, id_2. Returns xyz1, xyz2, h1, h2, match_logits,
        o1, o2, `match` when ids are given, and the aux heads' cls_logits,
        fp_logits, shape_points when configured and with_aux."""
        xyz1, xyz2, h1, h2 = self.siamese(batch["sparse_1"],
                                          batch["sparse_2"], train)
        out = dict(xyz1=xyz1, xyz2=xyz2, h1=h1, h2=h2)
        h_cat = torch.cat([h1, h2], dim=0)
        if with_aux and self.cls_head is not None:
            out["cls_logits"] = self.cls_head(
                pooled_feats(h_cat, self.pool_type), train)
        if with_aux and self.fp_head is not None:
            out["fp_logits"] = self.fp_head(
                pooled_feats(h_cat, self.pool_type), train)[..., 0]
        if with_aux and self.shape_head is not None:
            out["shape_points"] = self.shape_head(h_cat, train)
        if "id_1" in batch:
            out["match"] = (batch["id_1"] == batch["id_2"]).float()
        logits, (o1, o2) = self.match_logits(h1, xyz1, h2, xyz2, train)
        out["match_logits"] = logits
        out["o1"], out["o2"] = o1, o2
        return out
