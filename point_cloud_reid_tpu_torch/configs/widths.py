"""Registered leaves served at another head width, as (leaf, --set list):
the keys that give a consistent model when the match head's width moves.
tools/train.py, tools/test.py and tools/track.py take the same strings
(and so do the JAX package's CLIs):

    python -m point_cloud_reid_tpu_torch.tools.track LEAF --set S1 --set S2

A point leaf at conv_out C sets what configs.models.
point_transformer_point_cat(conv_out=C) sets: the backbone's conv_out, both
cross stages' d_model, the match head (LinearRes over the 2C pooled
features), output_sequence_size and hidden_size. An image leaf at
downsample_dim D sets downsample_dim, the last downsample layer, the cross
stage's d_model and the match head. The match kernels serve any such width
up to 1024 channels, in up to 16 heads up to 128 channels and up to 32
past them (kernels/match_grid.plan: the padded layout where the tiles have
no instantiation, the wide kernel past 128 channels), and the SA kernels
any stage width up to 8192 (kernels/sa_stage.kernel_width).

  conv_out96   the flagship at conv_out 96: two 48-channel heads;
  conv_out32   the flagship at conv_out 32: two 16-channel heads;
  image96      DeiT-tiny at downsample_dim 96: two 48-channel heads;
  conv_out256  the flagship at conv_out 256: two 128-channel heads (the
               rows tier's wide kernel);
  heads16      the 7M leaf (conv_out 128) with 16 heads of 8 channels in
               both cross stages;
  mul16        the 7M leaf at backbone mul 16: SA widths 512 / 1024 / 2048
               (the SA kernels past 1024 channels);
  mul6         the 7M leaf at backbone mul 6: SA widths 192 / 384 / 768
               (the float32 SA kernel's row tiles, the bf16 one's mma_sync
               tier);
  image256     DeiT-tiny at downsample_dim 256: two 128-channel heads;
  mul24        the 7M leaf at backbone mul 24: SA widths 768 / 1,536 /
               3,072 (the SA kernels past 2048 channels);
  conv_out512  the flagship at conv_out 512: two 256-channel heads (the
               wide kernel past 256 channels);
  heads32      the flagship at conv_out 256 with 32 heads of 8 channels in
               both cross stages (the wide kernel past 16 heads);
  image768     DeiT-tiny at downsample_dim 768: two 384-channel heads.
"""
from __future__ import annotations

FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
SEVEN_M = "pts_point-transformer-7M_point-cat_nus_det_4x256_500e"
IMAGE = "rgb_deit-tiny_point-cat_pt_nus_det_4x60_200e"


def _linear_res_head(n: int, ng: int) -> str:
    return (f"[{{'type':'LinearRes','n_in':{n},'n_out':{n},'norm':'GN',"
            f"'ng':{ng}}},{{'type':'Linear','out_features':1}}]")


def point_width_set(conv_out: int) -> list:
    """--set strings of a point-transformer leaf at conv_out channels."""
    return [f"model.backbone.conv_out={conv_out}",
            f"model.cross_stage1.d_model={conv_out}",
            f"model.cross_stage2.d_model={conv_out}",
            f"model.match_head={_linear_res_head(2 * conv_out, 8)}",
            f"model.output_sequence_size={conv_out}",
            f"model.hidden_size={2 * conv_out}"]


def image_width_set(dim: int, vit_dim: int = 192) -> list:
    """--set strings of a DeiT / ViT leaf (token width vit_dim) at
    downsample_dim `dim`."""
    downsample = (
        f"[{{'type':'LinearRes','n_in':{vit_dim},'n_out':256,'norm':'GN',"
        "'ng':32},{'type':'LinearRes','n_in':256,'n_out':128,'norm':'GN',"
        f"'ng':16}},{{'type':'Linear','out_features':{dim}}}]")
    return [f"model.downsample_dim={dim}",
            f"model.downsample={downsample}",
            f"model.cross_lin_attn.d_model={dim}",
            f"model.match_head={_linear_res_head(2 * dim, 16)}"]


WIDTHS = {
    "conv_out96": (FLAGSHIP, point_width_set(96)),
    "conv_out32": (FLAGSHIP, point_width_set(32)),
    "image96": (IMAGE, image_width_set(96)),
    "conv_out256": (FLAGSHIP, point_width_set(256)),
    "heads16": (SEVEN_M, ["model.cross_stage1.nhead=16",
                          "model.cross_stage2.nhead=16"]),
    "mul16": (SEVEN_M, ["model.backbone.mul=16"]),
    "mul6": (SEVEN_M, ["model.backbone.mul=6"]),
    "image256": (IMAGE, image_width_set(256)),
    "mul24": (SEVEN_M, ["model.backbone.mul=24"]),
    "conv_out512": (FLAGSHIP, point_width_set(512)),
    "heads32": (FLAGSHIP, point_width_set(256)
                + ["model.cross_stage1.nhead=32",
                   "model.cross_stage2.nhead=32"]),
    "image768": (IMAGE, image_width_set(768)),
}
