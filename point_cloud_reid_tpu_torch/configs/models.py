"""Model config factories: every released model family.

Copies of point_cloud_reid_tpu/configs/models.py (the JAX package's config
modules import jax through experiments.py, so the port cannot import them).
The dicts are value-for-value the JAX ones:
  point_transformer_point_cat  <- reid_pts_point-transformer_point-cat.py
                                  (mul=4, conv_out=64, two linear
                                  cross-attention stages, combine
                                  'point-cat', pool 'both')
  point_transformer_scaled     <- *-1.5M / -7M (output_sequence_size=128)
  point_transformer_baseline   <- reid_pts_point-transformer_baseline.py
                                  (match_type 'concat'), _stnet
                                  (match_type 'xcorr-baseline')
  pointnet_point_cat           <- reid_pts_pointnet_point-cat.py
  dgcnn_point_cat              <- reid_pts_dgcnn_point-cat.py
  image_deit_point_cat         <- image/reid_image_deit-{tiny,base}_
                                  point-cat.py
"""
from __future__ import annotations

from typing import Any, Dict


def _linear_res_head(n_in: int, n_out: int, ng: int, out_features: int):
    return [dict(type="LinearRes", n_in=n_in, n_out=n_out, norm="GN", ng=ng),
            dict(type="Linear", out_features=out_features)]


def point_transformer_point_cat(conv_out: int = 64, mul: int = 4,
                                nsample=(32, 48, 48),
                                backbone_list=(128, 64, 32),
                                combine: str = "point-cat",
                                match_type: str = "xcorr_eff",
                                with_aux_heads: bool = False,
                                num_classes: int = 10) -> Dict[str, Any]:
    """The flagship model (reid_pts_point-transformer_point-cat.py:14-50)."""
    hidden_match = 2 * conv_out  # 'both' pooling doubles channels
    cfg = dict(
        type="ReIDNet",
        backbone=dict(type="Pointnet_Backbone", input_channels=0,
                      use_xyz=True, conv_out=conv_out, mul=mul,
                      nsample=list(nsample)),
        match_head=_linear_res_head(hidden_match, hidden_match, 8, 1),
        cross_stage1=dict(type="corss_attention", d_model=conv_out, nhead=2,
                          attention="linear"),
        cross_stage2=dict(type="corss_attention", d_model=conv_out, nhead=2,
                          attention="linear"),
        local_stage1=None, local_stage2=None,
        cls_head=None, fp_head=None, shape_head=None, downsample=None,
        match_type=match_type, pool_type="both", combine=combine,
        backbone_list=list(backbone_list),
        output_sequence_size=conv_out,
        hidden_size=2 * conv_out,
    )
    if with_aux_heads:
        hs = 2 * conv_out
        cfg["cls_head"] = _linear_res_head(hs, hs, 16, 2 * num_classes)
        cfg["fp_head"] = _linear_res_head(hs, hs, 16, 1)
        cfg["shape_head"] = [dict(type="Linear", out_features=3)]
    return cfg


def point_transformer_scaled(size: str = "1.5M") -> Dict[str, Any]:
    """Scaled variants (reid_pts_point-transformer-1.5M/-7M_point-cat.py:
    output_sequence_size=128, mul 4 for 1.5M and 8 for 7M)."""
    conv_out = 128
    mul = 4 if size == "1.5M" else 8
    return point_transformer_point_cat(conv_out=conv_out, mul=mul)


def point_transformer_baseline(stnet: bool = False) -> Dict[str, Any]:
    """No-attention baselines: match_type 'concat'
    (reid_pts_point-transformer_baseline.py) or 'xcorr-baseline' (_stnet)."""
    cfg = point_transformer_point_cat(
        match_type="xcorr-baseline" if stnet else "concat")
    if not stnet:
        cfg["cross_stage1"] = cfg["cross_stage2"] = None
        # the concat head sees [pool(h1) || pool(h2)] = 4 * conv_out
        cfg["match_head"] = _linear_res_head(4 * 64, 4 * 64, 8, 1)
    return cfg


def pointnet_point_cat(num_classes: int = 10) -> Dict[str, Any]:
    """PointNet backbone family (reid_pts_pointnet_point-cat.py): 1024-wide
    per-point features, downsampled to the match stages' d = 64."""
    d = 64
    cfg = point_transformer_point_cat(conv_out=d, num_classes=num_classes)
    cfg["backbone"] = dict(type="PointNet", normal_channel=False)
    cfg["downsample"] = [dict(type="Linear", out_features=d)]
    cfg["use_dgcnn"] = True   # route the per-point feats through downsample
    return cfg


def dgcnn_point_cat(num_classes: int = 10, k: int = 20) -> Dict[str, Any]:
    """DGCNN backbone family (reid_pts_dgcnn_point-cat.py)."""
    d = 64
    cfg = point_transformer_point_cat(conv_out=d, num_classes=num_classes)
    cfg["backbone"] = dict(type="dgcnn", emb_dims=1024, k=k)
    cfg["downsample"] = [dict(type="Linear", out_features=d)]
    cfg["use_dgcnn"] = True
    return cfg


def image_deit_point_cat(variant: str = "deit-tiny",
                         num_classes: int = 10,
                         pretrained: bool = False) -> Dict[str, Any]:
    """Image branch (image/reid_image_deit-tiny_point-cat.py:1-45)."""
    dims = {"deit-tiny": 192, "deit-small": 384, "deit-base": 768,
            "deit-tiny-no-pt": 192, "deit-base-no-pt": 768, "beit": 768}
    # DeiT-distilled = 198 tokens (cls + dist + 196); plain ViT / BEiT = 197
    seq = 198 if variant.startswith("deit") and "no-pt" not in variant else 197
    hidden = dims[variant]
    hp = hidden * 2
    downsample_dim = 64
    hm = 2 * downsample_dim
    return dict(
        type="ImageReIDNet",
        backbone=variant,
        pretrained=pretrained,
        dim=hidden,
        downsample_dim=downsample_dim,
        combine="point-cat", match_type="xcorr_eff", pool_type="both",
        downsample=[
            dict(type="LinearRes", n_in=hidden, n_out=256, norm="GN", ng=32),
            dict(type="LinearRes", n_in=256, n_out=128, norm="GN", ng=16),
            dict(type="Linear", out_features=downsample_dim)],
        cross_lin_attn=dict(type="cross_lin_attn", d_model=downsample_dim,
                            nhead=2, attention="linear"),
        cls_head=_linear_res_head(hp, hp, 64, 2 * num_classes),
        fp_head=_linear_res_head(hp, hp, 64, 1),
        vis_head=_linear_res_head(hp, hp, 64, 4),
        match_head=_linear_res_head(hm, hm, 16, 1),
        output_sequence_size=seq,
    )
