"""The port's image model against the JAX package on the CPU: the ViT (DeiT
with and without the distillation token, BEiT), CrossLinAttn, ImageReIDNet's
match paths and full forward, and the weight converters (flax variables both
ways, HuggingFace names through both packages' converters). Same
numpy-seeded inputs and one set of weights on both sides, float32."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.convert.hf_vit import (  # noqa: E402
    convert_hf_vit_state_dict as jax_hf_convert)
from point_cloud_reid_tpu_torch.convert import (  # noqa: E402
    convert_hf_vit_state_dict, from_jax_variables, to_jax_variables)
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from tests._torch_image import (DIM, DS, TINY_PRESETS, images,  # noqa: E402
                                jax_variables_of, tiny_image_cfg,
                                tiny_image_models, tokens)
from tests._torch_threads import few_threads  # noqa: E402,F401

# float32 on both sides, a different summation order
TOL = 1e-4
VARIANTS = sorted(TINY_PRESETS)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("variant", VARIANTS)
def test_vit_tokens_match_jax(variant):
    jmodel, jvars, tmodel = tiny_image_models(variant)
    x = images(1, 3)
    want = jmodel.apply(jvars, jnp.asarray(x), train=False, method="embed")
    with torch.no_grad():
        got = tmodel.embed(torch.from_numpy(x))
    n_tok = 6 if TINY_PRESETS[variant]["dist_token"] else 5
    assert got.shape == (3, n_tok, DIM)
    _close(got, want)


def test_cross_lin_attn_matches_jax():
    jmodel, jvars, tmodel = tiny_image_models()
    a, b = tokens(2, 4, 6), tokens(3, 4, 6)
    want = jmodel.apply(jvars, jnp.asarray(a), jnp.asarray(b),
                        method=lambda m, s, t: m._cross_stage1(s, t))
    with torch.no_grad():
        got = tmodel.cross_stage1(torch.from_numpy(a), torch.from_numpy(b))
        kv, ks = tmodel.cross_stage1.template_summary(torch.from_numpy(b))
    _close(got, want)
    jkv, jks = jmodel.apply(jvars, jnp.asarray(b),
                            method=lambda m, t: m._cross_stage1
                            .template_summary(t))
    _close(kv, jkv)
    _close(ks, jks)


@pytest.mark.parametrize("S", [6, 11])
def test_match_logits_and_grid_match_jax(S):
    jmodel, jvars, tmodel = tiny_image_models()
    h_t, h_d = tokens(4, 3, S), tokens(5, 4, S)
    want_grid = jmodel.apply(jvars, jnp.asarray(h_t), jnp.asarray(h_d),
                             train=False, method="match_logits_grid")
    want_pairs = jmodel.apply(jvars, jnp.asarray(h_t), jnp.asarray(h_d[:3]),
                              train=False, method="match_logits")
    with torch.no_grad():
        grid = tmodel.match_logits_grid(torch.from_numpy(h_t),
                                        torch.from_numpy(h_d))
        pairs = tmodel.match_logits(torch.from_numpy(h_t),
                                    torch.from_numpy(h_d[:3]))
    assert grid.shape == (3, 4) and pairs.shape == (3,)
    _close(grid, want_grid)
    _close(pairs, want_pairs)
    # the hoisted grid is the aligned-pair forward on the diagonal
    _close(torch.diagonal(grid[:, :3]), pairs)


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant):
    jmodel, jvars, tmodel = tiny_image_models(variant)
    batch = dict(sparse_1=images(6, 3), sparse_2=images(7, 3),
                 id_1=np.array([0, 1, 2], np.int32),
                 id_2=np.array([0, 2, 2], np.int32))
    want = jmodel.apply(jvars, {k: jnp.asarray(v) for k, v in batch.items()},
                        train=False)
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    assert {"cls_logits", "fp_logits", "vis_logits", "match_logits",
            "match", "h1d"} <= set(got)
    for k in sorted(want):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k], what=k)


@pytest.mark.parametrize("variant", VARIANTS)
def test_flax_variables_round_trip(variant):
    """to_jax_variables gives every leaf the JAX model's own init has, in
    its shape; from_jax_variables of that tree (with BEiT's extra 'consts'
    collection in it) restores the port's weights bit for bit."""
    jmodel, jvars, tmodel = tiny_image_models(variant)
    x = jnp.zeros((1, 3, 32, 32))
    init = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), dict(sparse_1=x, sparse_2=x), train=False))
    want = jax.tree_util.tree_map(lambda a: a.shape, init["params"])
    have = jax.tree_util.tree_map(lambda a: a.shape, dict(jvars["params"]))
    assert have == want
    fresh = build_model(tiny_image_cfg(variant),
                        generator=torch.Generator().manual_seed(9))
    tree = jax.tree_util.tree_map(np.asarray, dict(jvars))
    from_jax_variables(fresh, tree)
    a, b = tmodel.state_dict(), fresh.state_dict()
    assert list(a) == list(b)
    assert "backbone.rel_pos_index" not in a
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _hf_state_dict(variant: str, seed: int = 0) -> dict:
    """A seeded random state dict with HuggingFace DeiT / BEiT names for the
    tiny preset, under the 'backbone.' prefix, plus keys that are not the
    ViT's."""
    p = TINY_PRESETS[variant]
    rs = np.random.RandomState(seed)
    dim, hid = p["dim"], int(p["dim"] * p["mlp_ratio"])
    n_tok = 5 + int(p["dist_token"])

    def r(*shape):
        return (rs.randn(*shape) * 0.1).astype(np.float32)

    sd = {"embeddings.cls_token": r(1, 1, dim),
          "embeddings.patch_embeddings.projection.weight": r(dim, 3, 16, 16),
          "embeddings.patch_embeddings.projection.bias": r(dim),
          "layernorm.weight": 1 + r(dim), "layernorm.bias": r(dim),
          "pooler.dense.weight": r(dim, dim)}
    if p["dist_token"]:
        sd["embeddings.distillation_token"] = r(1, 1, dim)
    beit = p.get("rel_pos_bias", False)
    if beit:
        sd["encoder.relative_position_bias.relative_position_bias_table"] = \
            r((2 * 2 - 1) ** 2 + 3, p["heads"])
        sd["encoder.relative_position_bias.relative_position_index"] = \
            np.zeros((5, 5), np.int64)
    else:
        sd["embeddings.position_embeddings"] = r(1, n_tok, dim)
    for i in range(p["depth"]):
        pre = f"encoder.layer.{i}."
        for n in ("query", "key", "value"):
            sd[pre + f"attention.attention.{n}.weight"] = r(dim, dim)
            if not (beit and n == "key"):            # BEiT has no key bias
                sd[pre + f"attention.attention.{n}.bias"] = r(dim)
        for name, shape in (("attention.output.dense", (dim, dim)),
                            ("intermediate.dense", (hid, dim)),
                            ("output.dense", (dim, hid))):
            sd[pre + name + ".weight"] = r(*shape)
            sd[pre + name + ".bias"] = r(shape[0])
        for name in ("layernorm_before", "layernorm_after"):
            sd[pre + name + ".weight"] = 1 + r(dim)
            sd[pre + name + ".bias"] = r(dim)
        if beit:
            sd[pre + "lambda_1"] = r(dim)
            sd[pre + "lambda_2"] = r(dim)
    sd = {"backbone." + k: v for k, v in sd.items()}
    sd["match_head.0.linear1.weight"] = r(4, 4)      # not the backbone's
    sd["backbone.encoder.layer.0.mystery.weight"] = r(2)
    return sd


@pytest.mark.parametrize("variant", VARIANTS)
def test_hf_vit_converter_matches_jax_converter(variant):
    """The same HF-named state dict through both packages' converters gives
    the same unmatched keys and the same tokens."""
    jmodel, jvars, _ = tiny_image_models(variant)
    tmodel = build_model(tiny_image_cfg(variant),
                         generator=torch.Generator().manual_seed(3))
    sd = _hf_state_dict(variant)
    jparams, j_unmatched = jax_hf_convert(sd, jvars["params"]["backbone"],
                                          prefix="backbone.")
    unmatched = convert_hf_vit_state_dict(sd, tmodel.backbone,
                                          prefix="backbone.")
    assert sorted(unmatched) == sorted(j_unmatched) == sorted(
        ["match_head.0.linear1.weight",
         "backbone.encoder.layer.0.mystery.weight"])
    # the port's ViT now holds what the JAX converter produced
    got = to_jax_variables(tmodel)["params"]["backbone"]
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams))
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
    x = images(8, 2)
    jv = dict(jvars, params=dict(jvars["params"], backbone=jparams))
    want = jmodel.apply(jv, jnp.asarray(x), train=False, method="embed")
    with torch.no_grad():
        _close(tmodel.embed(torch.from_numpy(x)), want)


def test_released_deit_tiny_width_on_two_crops():
    """The released widths (deit-tiny-no-pt: dim 192, depth 12, 3 heads, 197
    tokens; downsample 192 -> 256 -> 128 -> 64; two cross stages) on 2 crops
    of 224 x 224: embed, downsample and match logits against JAX."""
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.configs import get_experiment
    cfg = get_experiment("rgb_deit-tiny_point-cat_r_nus_det_4x60_200e")
    tmodel = build_model(cfg["model"],
                         generator=torch.Generator().manual_seed(0))
    jmodel = jax_build(dict(cfg["model"]))
    jvars = jax_variables_of(tmodel, "deit-tiny-no-pt")
    x = images(9, 2, 224)
    toks = jmodel.apply(jvars, jnp.asarray(x), train=False, method="embed")
    hd = jmodel.apply(jvars, toks, train=False, method="downsample_tokens")
    want = jmodel.apply(jvars, hd[:1], hd[1:], train=False,
                        method="match_logits")
    with torch.no_grad():
        t_toks = tmodel.embed(torch.from_numpy(x))
        t_hd = tmodel.downsample_tokens(t_toks)
        got = tmodel.match_logits(t_hd[:1], t_hd[1:])
    assert t_toks.shape == (2, 197, 192) and t_hd.shape == (2, 197, DS * 4)
    _close(t_toks, toks)
    _close(t_hd, hd)
    _close(got, want)
