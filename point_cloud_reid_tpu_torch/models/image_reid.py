"""ImageReIDNet: Siamese image re-identification over ViT token sequences.

Port of point_cloud_reid_tpu/models/image_reid.py: a ViT backbone on both
224 x 224 crops as one 2B batch, a per-token downsample MLP (dim -> 64)
before matching, two cross-attention stages without positions
(cross_lin_attn), and the match, cls, fp and visibility heads. Channel-last
token tensors (B, S, C) throughout.

  embed(images)            (B, 3, H, W) -> (B, S, dim) tokens;
  downsample_tokens(h)     per token dim -> downsample_dim;
  match_logits(h1d, h2d)   aligned pairs through both cross stages + head;
  match_logits_grid(...)   the all-pairs grid with per-object work hoisted
                           (plain torch; the fused CUDA scorer in
                           kernels/match_grid.py is its drop-in equivalent);
  forward(batch, train)    everything the losses and metrics need.

`dtype` is the compute dtype (models/layers.py), as the JAX model's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from .layers import combine_features, pooled_feats, set_compute_dtype
from .registry import build_head, build_stage
from .vit import build_vit


class ImageReIDNet(nn.Module):
    """Image-branch ReID network; config fields mirror the JAX ImageReIDNet."""

    def __init__(self, backbone: str = "deit-tiny", cross_lin_attn=None,
                 match_head=None, cls_head=None, fp_head=None, vis_head=None,
                 downsample=None, dim: int = 192, downsample_dim: int = 64,
                 combine: str = "point-cat", match_type: str = "xcorr_eff",
                 pool_type: str = "both", output_sequence_size: int = 198,
                 freeze_backbone: bool = False, pretrained: bool = False,
                 image_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        if combine not in ("add", "minus", "cat", "point-cat"):
            raise NotImplementedError(combine)
        if match_type not in ("xcorr_eff", "concat"):
            raise NotImplementedError(match_type)
        self.combine, self.match_type = combine, match_type
        self.pool_type = pool_type
        self.freeze_backbone = freeze_backbone
        self.image_size = image_size
        self.downsample_dim = downsample_dim
        self.backbone = build_vit(backbone, image_size=image_size,
                                  dtype=dtype)
        self.cross_stage1 = build_stage(cross_lin_attn)
        self.cross_stage2 = build_stage(cross_lin_attn)
        pooled = 2 if pool_type == "both" else 1
        if match_type == "concat":
            match_in = 2 * pooled * downsample_dim
        else:
            match_in = pooled * downsample_dim * (2 if combine == "cat" else 1)
        self.match_head = build_head(match_head, match_in)
        self.cls_head = build_head(cls_head, pooled * dim)
        self.fp_head = build_head(fp_head, pooled * dim)
        self.vis_head = build_head(vis_head, pooled * dim)
        self.downsample = build_head(downsample, dim)
        self.dtype = dtype
        set_compute_dtype(self, dtype)

    # ---- embedding ---------------------------------------------------------

    def embed(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, 3, H, W) -> (B, S, dim) token features."""
        feats = self.backbone(images, train)
        return feats.detach() if self.freeze_backbone else feats

    def siamese(self, img_1: torch.Tensor, img_2: torch.Tensor,
                train: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        b = img_1.shape[0]
        h = self.embed(torch.cat([img_1, img_2], dim=0), train)
        return h[:b], h[b:]

    def downsample_tokens(self, h: torch.Tensor, train: bool = False
                          ) -> torch.Tensor:
        """Per-token downsample dim -> downsample_dim, on flattened (B*S, C)
        rows so that the LinearRes GroupNorm normalises each token alone."""
        b, s_len, c = h.shape
        return self.downsample(h.reshape(-1, c), train).reshape(b, s_len, -1)

    # ---- match -------------------------------------------------------------

    def xcorr_eff(self, o1, o2):
        """Symmetric two-stage cross attention, no positions."""
        o1_a = self.cross_stage1(o1, o2)
        o2_a = self.cross_stage1(o2, o1)
        o1_b = self.cross_stage2(o1_a, o2_a)
        o2_b = self.cross_stage2(o2_a, o1_a)
        return combine_features(o1_b, o2_b, self.combine)

    def match_logits(self, h1d, h2d, train: bool = False) -> torch.Tensor:
        """(B,) raw match logits of aligned pairs of downsampled tokens."""
        if self.match_type == "xcorr_eff":
            pooled = pooled_feats(self.xcorr_eff(h1d, h2d), self.pool_type)
        else:
            pooled = torch.cat([pooled_feats(h1d, self.pool_type),
                                pooled_feats(h2d, self.pool_type)], dim=-1)
        return self.match_head(pooled, train)[..., 0]

    def match_logits_grid(self, h_t, h_d, train: bool = False) -> torch.Tensor:
        """(nt, nd) logits of every (track, det) pair of (n, S, C)
        downsampled token features, with stage 1's per-object work (queries,
        KV summaries) hoisted out of the pair batch, as
        ImageReIDNet.match_logits_grid in JAX."""
        nt, nd = h_t.shape[0], h_d.shape[0]
        stoks = h_t.shape[1]

        def pair(a, b):
            pa = a[:, None].expand((nt, nd) + a.shape[1:])
            pb = b[None, :].expand((nt, nd) + b.shape[1:])
            return (pa.reshape((nt * nd,) + a.shape[1:]),
                    pb.reshape((nt * nd,) + b.shape[1:]))

        s1, s2 = self.cross_stage1, self.cross_stage2
        if (self.match_type != "xcorr_eff" or s1 is None
                or s1.attention != "linear"):
            h1, h2 = pair(h_t, h_d)
            return self.match_logits(h1, h2, train).reshape(nt, nd)
        q_t, q_d = s1.query_features(h_t), s1.query_features(h_d)
        kv_t, ks_t = s1.template_summary(h_t)
        kv_d, ks_d = s1.template_summary(h_d)
        h1, h2 = pair(h_t, h_d)
        q1, q2 = pair(q_t, q_d)
        kv1, kv2 = pair(kv_t, kv_d)
        ks1, ks2 = pair(ks_t, ks_d)
        o1_a = s1.finish_from_summary(h1, q1, kv2, ks2, stoks)
        o2_a = s1.finish_from_summary(h2, q2, kv1, ks1, stoks)
        o1_b = s2(o1_a, o2_a)
        o2_b = s2(o2_a, o1_a)
        pooled = pooled_feats(combine_features(o1_b, o2_b, self.combine),
                              self.pool_type)
        return self.match_head(pooled, train)[..., 0].reshape(nt, nd)

    # ---- full forward ------------------------------------------------------

    def forward(self, batch: Dict[str, torch.Tensor], train: bool = False,
                with_aux: bool = True) -> Dict[str, torch.Tensor]:
        """batch: sparse_1, sparse_2 (B, 3, H, W) and optionally id_1, id_2.
        Returns h1, h2, h1d, h2d, match_logits, `match` when ids are given,
        and cls_logits, fp_logits, vis_logits where a head is configured and
        with_aux."""
        h1, h2 = self.siamese(batch["sparse_1"], batch["sparse_2"], train)
        out: Dict[str, Any] = dict(h1=h1, h2=h2)
        h_cat = torch.cat([h1, h2], dim=0)
        pooled: Optional[torch.Tensor] = None
        if with_aux and (self.cls_head is not None or self.fp_head is not None
                         or self.vis_head is not None):
            pooled = pooled_feats(h_cat, self.pool_type)
        if with_aux and self.cls_head is not None:
            out["cls_logits"] = self.cls_head(pooled, train)
        if with_aux and self.fp_head is not None:
            out["fp_logits"] = self.fp_head(pooled, train)[..., 0]
        if with_aux and self.vis_head is not None:
            out["vis_logits"] = self.vis_head(pooled, train)
        if "id_1" in batch:
            out["match"] = (batch["id_1"] == batch["id_2"]).float()
        hd = self.downsample_tokens(h_cat, train)
        b = h1.shape[0]
        out["h1d"], out["h2d"] = hd[:b], hd[b:]
        out["match_logits"] = self.match_logits(hd[:b], hd[b:], train)
        return out
