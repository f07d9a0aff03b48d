"""Shared set-up of the image-branch parity tests: one tiny ImageReIDNet on
both sides (JAX reference and PyTorch port) with the same weights.

Three tiny ViT presets (DeiT with and without the distillation token, BEiT)
are registered at import in both packages' VIT_PRESETS dicts, as
tests/test_convert_image_model.py does for the JAX one: dim 32, depth 2,
2 heads, 32 x 32 images in 16 x 16 patches, so 6 or 5 tokens. The weights
are the port's seeded init handed to JAX by convert.to_jax_variables.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch

import point_cloud_reid_tpu.models.vit as jax_vit
import point_cloud_reid_tpu_torch.models.vit as torch_vit
from point_cloud_reid_tpu_torch.convert import to_jax_variables

IMAGE_SIZE = 32
DIM, DS = 32, 16
_TINY = dict(dim=DIM, depth=2, heads=2, mlp_ratio=2.0)
TINY_PRESETS = {
    "deit-test": dict(_TINY, dist_token=True, final_norm=False),
    "deit-test-no-pt": dict(_TINY, dist_token=False, final_norm=False),
    "beit-test": dict(_TINY, dist_token=False, rel_pos_bias=True,
                      layer_scale=True, final_norm=True),
}
for _name, _preset in TINY_PRESETS.items():
    jax_vit.VIT_PRESETS[_name] = dict(_preset)
    torch_vit.VIT_PRESETS[_name] = dict(_preset)


def tiny_image_cfg(variant: str = "deit-test", aux: bool = True) -> dict:
    def head(n, ng, out):
        return [dict(type="LinearRes", n_in=n, n_out=n, norm="GN", ng=ng),
                dict(type="Linear", out_features=out)]

    cfg = dict(
        type="ImageReIDNet", backbone=variant, dim=DIM, downsample_dim=DS,
        image_size=IMAGE_SIZE, combine="point-cat", match_type="xcorr_eff",
        pool_type="both",
        downsample=[dict(type="LinearRes", n_in=DIM, n_out=DIM, norm="GN",
                         ng=8),
                    dict(type="Linear", out_features=DS)],
        cross_lin_attn=dict(type="cross_lin_attn", d_model=DS, nhead=2,
                            attention="linear"),
        match_head=head(2 * DS, 8, 1),
        output_sequence_size=6 if variant == "deit-test" else 5)
    if aux:
        cfg.update(cls_head=head(2 * DIM, 8, 20), fp_head=head(2 * DIM, 8, 1),
                   vis_head=head(2 * DIM, 8, 4))
    return cfg


def jax_variables_of(tmodel, variant: str):
    """The port model's weights as flax variables (jnp leaves), with the
    'consts' collection the JAX BEiT keeps its relative-position index in."""
    import jax
    import jax.numpy as jnp
    variables = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tmodel))
    if not variables["batch_stats"]:
        del variables["batch_stats"]
    if TINY_PRESETS.get(variant, {}).get("rel_pos_bias"):
        variables["consts"] = {"backbone": {
            "rel_pos_index": jax_vit._relative_position_index(
                IMAGE_SIZE // 16)}}
    return variables


@functools.lru_cache(maxsize=None)
def tiny_image_models(variant: str = "deit-test", seed: int = 0):
    """(jax_model, jax_variables, torch_model) sharing one set of weights."""
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_image_cfg(variant)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(seed))
    return (jax_build(copy.deepcopy(cfg)), jax_variables_of(tmodel, variant),
            tmodel)


def images(seed: int, n: int, size: int = IMAGE_SIZE) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, 3, size, size).astype(
        np.float32)


def tokens(seed: int, n: int, s: int, c: int = DS) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, s, c).astype(np.float32)
