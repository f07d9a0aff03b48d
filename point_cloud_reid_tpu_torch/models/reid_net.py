"""ReIDNet, the Siamese point-cloud ReID model (port of models/reid_net.py).

Backbones: the point-transformer, PointNet and DGCNN (models/registry.py);
PointNet and DGCNN emit 1024-wide features that `downsample` maps to the
match stages' width when `use_dgcnn` is set, inside `embed`, so the
tracker's caches hold the downsampled features. Match types:

  'xcorr_eff'      symmetric two-stage cross-attention, shared weights per
                   stage, combine 'point-cat' (every point leaf but the
                   baselines);
  'xcorr-baseline' the two cross stages one way: the search side attends
                   to the template twice, stage 2 to the ORIGINAL template
                   features and xyz;
  'concat'         [pool(h1) || pool(h2)], no cross stage.

  embed(pts)             backbone embedding of a batch of crops;
  siamese(s1, s2)        both crops as one 2B batch through the backbone, so
                         BatchNorm sees both views;
  match_logits(...)      aligned pairs through the match type + head;
  match_logits_grid(...) the all-pairs grid: for xcorr_eff with plain
                         linear attention, per-object work hoisted (the
                         fused CUDA scorer in kernels/match_grid.py is its
                         drop-in equivalent); any other head scores the
                         materialised pair batch, as JAX's fallback;
  forward(batch, train)  everything the losses and metrics need.

The 'xcorr' match type (local self-attention stages), ReIDNetCosine and the
combines other than 'point-cat' wait for M7. `dtype` is the compute dtype
(models/layers.py): float32 parameters at every dtype; at bf16 the
embeddings and logits are bf16 and xyz float32, as in the JAX model.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn as nn

from .layers import pooled_feats, set_compute_dtype
from .registry import build_backbone, build_head, build_stage

MATCH_TYPES = ("xcorr_eff", "xcorr-baseline", "concat")


class ReIDNet(nn.Module):
    """Point-branch ReID network; config fields mirror the JAX ReIDNet."""

    def __init__(self, backbone: Dict[str, Any], match_head,
                 cross_stage1=None, cross_stage2=None, cls_head=None,
                 shape_head=None, fp_head=None, downsample=None,
                 match_type: str = "xcorr_eff", pool_type: str = "both",
                 combine: str = "point-cat",
                 backbone_list: Sequence[int] = (128, 64, 32),
                 output_sequence_size: int = 32, use_dgcnn: bool = False,
                 knn_method: str = "argsort",
                 dtype: torch.dtype = torch.float32, **unused):
        super().__init__()
        if match_type not in MATCH_TYPES or pool_type != "both" or (
                match_type == "xcorr_eff" and combine != "point-cat"):
            raise NotImplementedError((match_type, combine, pool_type))
        # the JAX model calls its cross stages only in these match types
        with_stages = match_type != "concat"
        if with_stages:
            for s in (cross_stage1, cross_stage2):
                if not s or s.get("type") != "corss_attention":
                    raise NotImplementedError(f"cross stage {s}")
        for k, v in unused.items():
            if v not in (None, False) and k not in ("hidden_size",):
                raise NotImplementedError(f"{k}={v}")
        self.backbone_list = list(backbone_list)
        self.match_type, self.combine = match_type, combine
        self.pool_type = pool_type
        self.backbone = build_backbone(dict(backbone), knn_method=knn_method)
        width = self.backbone.out_channels
        # JAX applies (and so only then has parameters for) the downsample
        # with use_dgcnn
        self.downsample = build_head(downsample, width) if use_dgcnn else None
        if self.downsample is not None:
            width = self.downsample.out_width
        self.cross_stage1 = build_stage(cross_stage1) if with_stages else None
        self.cross_stage2 = build_stage(cross_stage2) if with_stages else None
        pooled = 2 * width      # pool 'both': [max || mean]
        # concat pools both sides; the cross stages' output is d_model wide
        head_in = (2 * pooled if match_type == "concat"
                   else 2 * cross_stage2["d_model"])
        self.match_head = build_head(match_head, head_in)
        self.cls_head = build_head(cls_head, pooled)
        self.fp_head = build_head(fp_head, pooled)
        self.shape_head = build_head(shape_head, width)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    def embed(self, pts: torch.Tensor, train: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, N, 3) crops -> xyz (B, N, 3), h (B, N, C): the backbone's
        features, downsampled when the model has a downsample."""
        xyz, h = self.backbone(pts, self.backbone_list, train)
        if self.downsample is not None:
            h = self.downsample(h, train)
        return xyz, h

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

    def xcorr_baseline(self, search_feat, search_xyz, template_feat,
                       template_xyz):
        """The two cross stages one way; stage 2 attends to the original
        template, as stage 1 does."""
        h = self.cross_stage1(search_feat, search_xyz, template_feat,
                              template_xyz)
        return self.cross_stage2(h, search_xyz, template_feat, template_xyz)

    def match_logits(self, h1, xyz1, h2, xyz2, train: bool = False):
        """(B,) raw match logits of aligned pairs, and (o1, o2), the
        per-point features after xcorr_eff's cross stages (None, None for
        the other match types)."""
        o1 = o2 = None
        if self.match_type == "xcorr_eff":
            match_in, o1, o2 = self.xcorr_eff(h1, xyz1, h2, xyz2)
            pooled = pooled_feats(match_in, self.pool_type)
        elif self.match_type == "xcorr-baseline":
            pooled = pooled_feats(self.xcorr_baseline(h1, xyz1, h2, xyz2),
                                  self.pool_type)
        else:
            pooled = torch.cat([pooled_feats(h1, self.pool_type),
                                pooled_feats(h2, self.pool_type)], dim=-1)
        return self.match_head(pooled, train)[..., 0], (o1, o2)

    def match_logits_grid(self, h_t, xyz_t, h_d, xyz_d) -> torch.Tensor:
        """(nt, nd) logits of every (track, det) pair, as
        ReIDNet.match_logits_grid in JAX: for xcorr_eff with plain linear
        attention the per-object work of stage 1 (queries, KV summaries)
        and stage 2's pos-MLP hoisted out of the pair batch; for any other
        head match_logits over the materialised pairs."""
        nt, nd = h_t.shape[0], h_d.shape[0]
        npts = h_t.shape[1]

        def pair(a, b):
            pa = a[:, None].expand((nt, nd) + a.shape[1:])
            pb = b[None, :].expand((nt, nd) + b.shape[1:])
            return (pa.reshape((nt * nd,) + a.shape[1:]),
                    pb.reshape((nt * nd,) + b.shape[1:]))

        s1, s2 = self.cross_stage1, self.cross_stage2
        if self.match_type != "xcorr_eff" or s1.attention != "linear":
            # the decomposition below is xcorr_eff's with the plain linear
            # attention: any other head scores the materialised pair batch
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
        o1 and o2 for xcorr_eff, `match` when ids are given, and the aux
        heads' cls_logits, fp_logits, shape_points when configured and
        with_aux."""
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
        if o1 is not None:
            out["o1"], out["o2"] = o1, o2
        return out
