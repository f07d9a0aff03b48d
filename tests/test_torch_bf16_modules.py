"""The port's modules at a bf16 compute dtype against the flax modules at
bf16, with the same float32 weights (the port's seeded init carried over by
convert.to_jax_variables) and the same numpy-seeded inputs: ConvBNReLU,
LinearRes, the two cross stages and their pos-MLP, the SA stages (fused and
plain), the whole embedding, and the output dtypes. kNN indices at bf16
equal float32's: xyz stays float32 on both sides."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests._torch_port import TINY, crops, to_jax_tree  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

BF16 = jnp.bfloat16
# the JAX suite's own bf16 bar (tests/test_ops_pallas.py, the fused SA stage
# at bf16 against its XLA path), rtol = atol
TOL = 3e-2


@functools.lru_cache(maxsize=1)
def models():
    """(port float32, port bf16, JAX bf16 model, flax variables): one set of
    float32 weights."""
    from point_cloud_reid_tpu.configs.models import (
        point_transformer_point_cat as jax_cfg)
    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
    from point_cloud_reid_tpu_torch.models import build_model
    cfg = point_transformer_point_cat(**TINY)
    t32 = build_model(cfg, generator=torch.Generator().manual_seed(0))
    t16 = build_model(cfg, generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(t32))
    return t32, t16, jax_build(jax_cfg(**TINY), dtype=BF16), jvars


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), BF16)


def _close(got: torch.Tensor, want, tol: float = TOL):
    assert str(got.dtype).split(".")[-1] == str(jnp.dtype(want.dtype)), (
        got.dtype, want.dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_params_stay_float32_and_compute_is_bf16():
    t32, t16, _, _ = models()
    assert all(p.dtype == torch.float32 for p in t16.parameters())
    for a, b in zip(t32.state_dict().values(), t16.state_dict().values()):
        assert torch.equal(a, b)
    assert t16.dtype == torch.bfloat16 and t32.dtype == torch.float32
    assert t16.cross_stage1.q_proj.compute_dtype == torch.bfloat16
    assert t32.cross_stage1.q_proj.compute_dtype is None


def test_conv_bn_relu_matches_flax():
    """An SA stage's Conv-BN-ReLU (the second layer of SA2), eval mode:
    flax's ConvBNReLU(dtype=bf16) against the port's Dense + BatchNorm."""
    from point_cloud_reid_tpu.models.layers import ConvBNReLU
    _, t16, _, jvars = models()
    stage = t16.backbone.SA_modules[1]
    x, jx = _bf16(_randn(0, 3, 8, 8, 64))
    variables = {"params": jvars["params"]["backbone"]["sa_1"]["mlp_1"],
                 "batch_stats": jvars["batch_stats"]["backbone"]["sa_1"][
                     "mlp_1"]}
    want = ConvBNReLU(64, dtype=BF16).apply(variables, jx, train=False)
    with torch.no_grad():
        got = torch.relu(stage.mlp_bns[1](stage.mlp_convs[1](x)))
    _close(got, want)


def test_linear_res_matches_flax():
    """The match head's LinearRes (biasless Dense, GroupNorm) at bf16."""
    from point_cloud_reid_tpu.models.layers import LinearRes
    _, t16, _, jvars = models()
    x, jx = _bf16(_randn(1, 12, 32))
    want = LinearRes(32, 32, norm="GN", ng=8, dtype=BF16).apply(
        {"params": jvars["params"]["match_head"]["0_LinearRes"]}, jx,
        train=False)
    with torch.no_grad():
        got = t16.match_head[0](x)
    _close(got, want)


@pytest.mark.parametrize("stage", ["cross_stage1", "cross_stage2"])
def test_cross_stages_and_pos_mlp_match_flax(stage):
    _, t16, j16, jvars = models()
    o1, jo1 = _bf16(_randn(2, 4, 32, 16))
    o2, jo2 = _bf16(_randn(3, 4, 32, 16))
    x1, x2 = _randn(4, 4, 32, 3, scale=0.6), _randn(5, 4, 32, 3, scale=0.6)
    want = j16.apply(jvars, jo1, jnp.asarray(x1), jo2, jnp.asarray(x2),
                     method=lambda m, *a: getattr(m, "_" + stage)(*a))
    want_pos = j16.apply(jvars, jnp.asarray(x2), method=lambda m, x: getattr(
        m, "_" + stage).pos_mlp(x))
    block = getattr(t16, stage)
    with torch.no_grad():
        got = block(o1, torch.from_numpy(x1), o2, torch.from_numpy(x2))
        got_pos = block.pos_mlp(torch.from_numpy(x2))
    _close(got, want)
    _close(got_pos, want_pos)


def _jax_stage(i: int, fused: bool):
    from point_cloud_reid_tpu.models.point_transformer import (
        SetAbstractionEdgeSA)
    sa1, sa2, sa3 = 32, 64, 128
    mlp = [[3, sa1, sa1, sa1], [sa2 + 3, sa2, sa2, sa2],
           [sa3 + 3, sa3, sa3, sa3]][i]
    return SetAbstractionEdgeSA(mlp=mlp, nsample=TINY["nsample"][i],
                                pallas_inference=fused,
                                pallas_interpret=True, dtype=BF16)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("i", [0, 1])
def test_sa_stage_matches_flax(i, fused):
    """An eval SA stage at bf16: the fused path (the port's kernel wrapper,
    here its plain version, against the Pallas kernel in interpret mode) and
    the plain chain (the port's unfused chain against JAX's XLA path). The
    centres and xyz stay float32 and equal."""
    _, t16, _, jvars = models()
    n_in = (32, 16)[i]
    xyz = _randn(6, 3, n_in, 3, scale=0.6)
    points = None if i == 0 else _randn(7, 3, n_in, 32)
    S = TINY["backbone_list"][i]
    v = {c: jvars[c]["backbone"][f"sa_{i}"] for c in jvars}
    jp = None if points is None else _bf16(points)[1]
    jxyz_out, want = _jax_stage(i, fused).apply(v, jnp.asarray(xyz), jp, S,
                                                train=False)
    stage = t16.backbone.SA_modules[i]
    tp = None if points is None else _bf16(points)[0]
    with torch.no_grad():
        if fused:
            xyz_out, got = stage(torch.from_numpy(xyz), tp, S)
        else:
            xyz_out, h = stage._plain_chain(torch.from_numpy(xyz), tp, S,
                                            train=False)
            got = stage.self_attention(h, xyz_out)
    assert xyz_out.dtype == torch.float32
    np.testing.assert_array_equal(xyz_out.numpy(), np.asarray(jxyz_out))
    _close(got, want)


def test_embed_and_logits_dtypes_match_jax():
    """The whole embedding and the grid's logits at bf16: xyz float32 and
    equal, h and the logits bf16 as JAX's; the embedding within the module
    bar."""
    _, t16, j16, jvars = models()
    x = crops(8, 4)
    jx, jh = jax.jit(lambda v, p: j16.apply(v, p, train=False,
                                            method="embed"))(jvars, x)
    with torch.no_grad():
        tx, th = t16.embed(torch.from_numpy(x))
        logits = t16.match_logits_grid(th[:2], tx[:2], th[2:], tx[2:])
    jlogits = jax.jit(lambda v, *a: j16.apply(
        v, *a, train=False, method="match_logits_grid"))(
            jvars, jh[:2], jx[:2], jh[2:], jx[2:])
    assert (jh.dtype, jx.dtype, jlogits.dtype) == (BF16, jnp.float32, BF16)
    assert (th.dtype, tx.dtype, logits.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    _close(th, jh)


def test_knn_indices_at_bf16_equal_float32(monkeypatch):
    """Every kNN of the bf16 embedding is the float32 model's: the indices
    come from float32 xyz on both. The kernel wrapper takes bf16 points as
    knn_pallas does, cast to float32."""
    from point_cloud_reid_tpu_torch.kernels.knn import knn, knn_reference
    from point_cloud_reid_tpu_torch.models import point_transformer as pt
    t32, t16, _, _ = models()
    seen = []
    real = pt.knn_indices

    def spy(k, xyz, new_xyz, method="argsort"):
        assert xyz.dtype == new_xyz.dtype == torch.float32
        idx = real(k, xyz, new_xyz, method)
        seen.append(idx)
        return idx
    monkeypatch.setattr(pt, "knn_indices", spy)
    x = torch.from_numpy(crops(9, 5))
    with torch.no_grad():
        t32.embed(x)
        t16.embed(x)
    assert len(seen) == 6
    for a, b in zip(seen[:3], seen[3:]):
        assert torch.equal(a, b)
    q = torch.from_numpy(_randn(10, 2, 16, 3)).to(torch.bfloat16)
    db = torch.from_numpy(_randn(11, 2, 32, 3)).to(torch.bfloat16)
    assert torch.equal(knn(q, db, 8), knn_reference(q.float(), db.float(), 8))


@pytest.mark.parametrize("variant", ["deit-test", "beit-test"])
def test_vit_and_downsample_bf16_match_flax(variant):
    """The image model at bf16 (tiny DeiT with the distillation token, and
    BEiT, whose float32 relative-position bias promotes its softmax to
    float32 as in JAX): the ViT's tokens (float32: the float32 class and
    position tokens keep the residual stream float32 in both packages) and
    the per-token downsample's bf16 output."""
    import copy

    from point_cloud_reid_tpu.models import build_model as jax_build
    from point_cloud_reid_tpu_torch.models import build_model
    from tests._torch_image import images, jax_variables_of, tiny_image_cfg
    cfg = tiny_image_cfg(variant, aux=False)
    t16 = build_model(copy.deepcopy(cfg),
                      generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    j16 = jax_build(copy.deepcopy(cfg), dtype=BF16)
    jvars = jax_variables_of(t16, variant)
    x = images(4, 3)
    jtok = jax.jit(lambda v, p: j16.apply(v, p, train=False,
                                          method="embed"))(jvars, x)
    jds = jax.jit(lambda v, h: j16.apply(v, h, train=False,
                                         method="downsample_tokens"))(
                                             jvars, jtok)
    with torch.no_grad():
        tok = t16.embed(torch.from_numpy(x))
        ds = t16.downsample_tokens(tok)
    _close(tok, jtok)
    _close(ds, jds)
