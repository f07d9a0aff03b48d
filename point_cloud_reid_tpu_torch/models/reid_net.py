"""ReIDNet and ReIDNetCosine, the Siamese point-cloud ReID models (port of
models/reid_net.py).

Backbones: the point-transformer, PointNet, DGCNN and VN-DGCNN
(models/registry.py); PointNet, DGCNN and VN-DGCNN emit 1024- or 2046-wide
features that `downsample` maps to the match stages' width when
`use_dgcnn` is set, inside `embed`, so the tracker's caches hold the
downsampled features. Match types:

  'xcorr_eff'      symmetric two-stage cross-attention, shared weights per
                   stage, combine 'add', 'minus', 'cat' or 'point-cat' (every
                   released point leaf but the baselines: point-cat);
  'xcorr'          asymmetric: cross stage 1, local self-attention stage 1,
                   cross stage 2, local stage 2; the search side attends to
                   the original template both times;
  'xcorr-baseline' the two cross stages one way: the search side attends
                   to the template twice, stage 2 to the ORIGINAL template
                   features and xyz;
  'concat'         [pool(h1) || pool(h2)], no cross stage.

Pooling: 'both' ([max || mean]) or 'max'. ReIDNetCosine scores a pair by
10 x the cosine of the pooled embeddings and has no match stage or head.

  embed(pts)             backbone embedding of a batch of crops;
  siamese(s1, s2)        both crops as one 2B batch through the backbone, so
                         BatchNorm sees both views;
  match_logits(...)      aligned pairs through the match type + head;
  match_logits_pairs(...) listed (track, det) pairs of two embedded sets,
                         in chunks of pairs sized to PAIR_CHUNK_BYTES;
  match_logits_grid(...) the all-pairs grid: for xcorr_eff over plain
                         linear cross stages, per-object work hoisted (the
                         fused CUDA scorer in kernels/match_grid.py is its
                         drop-in equivalent); any other head scores the
                         materialised pairs (match_logits_pairs), as JAX's
                         fallback; ReIDNetCosine's grid is one matmul;
  forward(batch, train)  everything the losses and metrics need.

`dtype` is the compute dtype (models/layers.py): float32 parameters at every
dtype; at bf16 the embeddings and logits are bf16 and xyz float32, as in the
JAX model.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn as nn

from .attention_blocks import CrossAttentionBlock, LocalSelfAttention
from .layers import combine_features, pooled_feats, set_compute_dtype
from .loftr import LoFTRStage
from .registry import build_backbone, build_head, build_stage

MATCH_TYPES = ("xcorr_eff", "xcorr", "xcorr-baseline", "concat")
# the working set one chunk of materialised pairs may take
# (match_logits_pairs): a dense 128 x 128 grid of the 'xcorr' head on
# 128-point crops would hold ~17 GiB in one neighbour tensor alone
PAIR_CHUNK_BYTES = 4 << 30


class ReIDNet(nn.Module):
    """Point-branch ReID network; config fields mirror the JAX ReIDNet."""

    # whether the model scores pairs through match stages and a match head
    # (ReIDNetCosine does not, and has neither)
    _with_head = True

    def __init__(self, backbone: Dict[str, Any], match_head,
                 cross_stage1=None, cross_stage2=None, local_stage1=None,
                 local_stage2=None, cls_head=None, shape_head=None,
                 fp_head=None, downsample=None,
                 match_type: str = "xcorr_eff", pool_type: str = "both",
                 combine: str = "point-cat",
                 backbone_list: Sequence[int] = (128, 64, 32),
                 output_sequence_size: int = 32, use_dgcnn: bool = False,
                 knn_method: str = "argsort",
                 dtype: torch.dtype = torch.float32, **unused):
        super().__init__()
        if (match_type not in MATCH_TYPES or pool_type not in ("both", "max")
                or combine not in ("add", "minus", "cat", "point-cat")):
            raise NotImplementedError((match_type, combine, pool_type))
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
        per_vector = 2 if pool_type == "both" else 1    # [max || mean]
        # the JAX model calls (and so has parameters for) its cross stages
        # in the match types with stages alone, its local stages in 'xcorr'
        # alone
        stages = ()
        if self._with_head and match_type != "concat":
            stages = (cross_stage1, cross_stage2) + (
                (local_stage1, local_stage2) if match_type == "xcorr" else ())
            if not all(stages):
                raise ValueError(f"match type {match_type} needs its cross "
                                 "(and for xcorr local) stages")
        (self.cross_stage1, self.cross_stage2, self.local_stage1,
         self.local_stage2) = (build_stage(s) for s in stages + (None,) * (
             4 - len(stages)))
        if not self._with_head:
            head_in = 0
        elif match_type == "concat":
            head_in = 2 * per_vector * width
        else:
            # the last stage's d_model wide; 'cat' doubles the channels
            last = local_stage2 if match_type == "xcorr" else cross_stage2
            head_in = per_vector * last["d_model"] * (
                2 if match_type == "xcorr_eff" and combine == "cat" else 1)
        self.match_head = build_head(match_head, head_in) if head_in else None
        self.cls_head = build_head(cls_head, per_vector * width)
        self.fp_head = build_head(fp_head, per_vector * width)
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
        Returns (the combine of both sides, o1, o2)."""
        o1_a = self.cross_stage1(o1, xyz1, o2, xyz2)
        o2_a = self.cross_stage1(o2, xyz2, o1, xyz1)
        o1_b = self.cross_stage2(o1_a, xyz1, o2_a, xyz2)
        o2_b = self.cross_stage2(o2_a, xyz2, o1_a, xyz1)
        return combine_features(o1_b, o2_b, self.combine), o1_b, o2_b

    def xcorr(self, search_feat, search_xyz, template_feat, template_xyz):
        """Asymmetric cross and local self-attention stages in turn; both
        cross stages attend to the original template."""
        h = self.cross_stage1(search_feat, search_xyz, template_feat,
                              template_xyz)
        h = self.local_stage1(h, search_xyz)
        h = self.cross_stage2(h, search_xyz, template_feat, template_xyz)
        return self.local_stage2(h, search_xyz)

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
        elif self.match_type == "xcorr":
            pooled = pooled_feats(self.xcorr(h1, xyz1, h2, xyz2),
                                  self.pool_type)
        elif self.match_type == "xcorr-baseline":
            pooled = pooled_feats(self.xcorr_baseline(h1, xyz1, h2, xyz2),
                                  self.pool_type)
        else:
            pooled = torch.cat([pooled_feats(h1, self.pool_type),
                                pooled_feats(h2, self.pool_type)], dim=-1)
        return self.match_head(pooled, train)[..., 0], (o1, o2)

    def pair_chunk(self, n_pairs: int, h: torch.Tensor) -> int:
        """Pairs match_logits_pairs scores at once, for embeddings h (n,
        N, C): as many as keep the head's working set within
        PAIR_CHUNK_BYTES, in chunks of equal size. A pair's working set is
        counted as eight of its widest per-point tensors on both sides: a
        local stage's knum neighbours of d_model channels, a softmax LoFTR
        stage's N scores a head, or else four times the widest features
        (the stages' FFN)."""
        npts = h.shape[1]
        widths = [4 * h.shape[2]]
        for s in (self.cross_stage1, self.cross_stage2, self.local_stage1,
                  self.local_stage2):
            if isinstance(s, LocalSelfAttention):
                widths.append(s.knum * s.d_model)
            elif isinstance(s, LoFTRStage) and s.attention != "linear":
                widths.append(npts * s.nhead)
            elif s is not None:
                widths.append(4 * s.d_model)
        per_pair = 2 * 8 * npts * max(widths) * h.element_size()
        chunks = -(-n_pairs * per_pair // PAIR_CHUNK_BYTES)
        return max(1, -(-n_pairs // max(chunks, 1)))

    def match_logits_pairs(self, h_t, xyz_t, h_d, xyz_d, t_idx, d_idx
                           ) -> torch.Tensor:
        """(P,) logits of the listed (track t_idx[p], det d_idx[p]) pairs:
        match_logits over the gathered pairs, pair_chunk's count at a time.
        Pairs do not interact in eval, so the chunks' logits are the one
        batch's."""
        t_idx, d_idx = t_idx.long(), d_idx.long()
        n = t_idx.shape[0]
        chunk = self.pair_chunk(n, h_t)
        out = []
        for a in range(0, n, chunk):
            ti, di = t_idx[a:a + chunk], d_idx[a:a + chunk]
            out.append(self.match_logits(h_t[ti], xyz_t[ti], h_d[di],
                                         xyz_d[di])[0])
        return out[0] if len(out) == 1 else torch.cat(out)

    def match_logits_grid(self, h_t, xyz_t, h_d, xyz_d) -> torch.Tensor:
        """(nt, nd) logits of every (track, det) pair, as
        ReIDNet.match_logits_grid in JAX: for xcorr_eff over plain linear
        cross stages the per-object work of stage 1 (queries, KV
        summaries) and stage 2's pos-MLP hoisted out of the pair batch; for
        any other head match_logits over the materialised pairs, in chunks
        (match_logits_pairs)."""
        nt, nd = h_t.shape[0], h_d.shape[0]
        npts = h_t.shape[1]
        s1, s2 = self.cross_stage1, self.cross_stage2
        if not (self.match_type == "xcorr_eff"
                and isinstance(s1, CrossAttentionBlock)
                and isinstance(s2, CrossAttentionBlock)
                and s1.attention == "linear"):
            # the decomposition below is xcorr_eff's with the plain linear
            # attention: any other head scores the materialised pairs
            dev = h_t.device
            ti = torch.arange(nt, device=dev).repeat_interleave(nd)
            di = torch.arange(nd, device=dev).repeat(nt)
            return self.match_logits_pairs(h_t, xyz_t, h_d, xyz_d, ti,
                                           di).reshape(nt, nd)

        def pair(a, b):
            pa = a[:, None].expand((nt, nd) + a.shape[1:])
            pb = b[None, :].expand((nt, nd) + b.shape[1:])
            return (pa.reshape((nt * nd,) + a.shape[1:]),
                    pb.reshape((nt * nd,) + b.shape[1:]))

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
        pooled = pooled_feats(combine_features(o1_b, o2_b, self.combine),
                              self.pool_type)
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


class ReIDNetCosine(ReIDNet):
    """Scores a pair by 10 x the cosine of its pooled embeddings, with
    1e-8 added to the norms (reference ReIDNet.py:779-809): no match stage
    and no match head (the JAX model never calls its own, so it has no
    parameters for them)."""

    _with_head = False

    def _unit(self, h: torch.Tensor) -> torch.Tensor:
        p = pooled_feats(h, self.pool_type)
        return p / (torch.linalg.vector_norm(p, dim=-1, keepdim=True) + 1e-8)

    def match_logits(self, h1, xyz1, h2, xyz2, train: bool = False):
        return torch.sum(self._unit(h1) * self._unit(h2), dim=-1) * 10.0, (
            None, None)

    def match_logits_grid(self, h_t, xyz_t, h_d, xyz_d) -> torch.Tensor:
        """The whole grid as one (nt, C) x (C, nd) matmul of the unit
        pooled embeddings."""
        return torch.matmul(self._unit(h_t), self._unit(h_d).T) * 10.0
