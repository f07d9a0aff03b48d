"""The match chain at every head width up to 128 channels (ROADMAP.md K6),
on the CPU.

The kernels' tiles are instantiated at 16 and 64 channels (cluster tier)
and 64 and 128 (rows tier); any other width runs in the padded layout of
kernels/match_grid (pad_side, pad_weights: the true channels first, zeros
past them), with the kernels masking elu+1 of a padded stage-2 q or k lane
and the LayerNorm statistics. Here:
  - the CPU model of that layout (padded_reference: the wrapper's padded
    factors and weights through the chain with the kernels' masks) against
    the unpadded plain chain, point and image head, and the same layout
    without the masks, which zeros alone get wrong;
  - the rows tier's stage copies of padded weights and [KV | Z], read back
    as the kernel reads them (tests/test_torch_match_rows_plan.read_stage);
  - kernels/match_grid.plan at every width, head count, head and dtype;
  - the port at conv_out 32 and 96 and at image downsample_dim 96 against
    JAX's model.apply and its scorers' grid and pairs, with the same
    converted weights, and the --set lines (configs/widths.py) read alike by
    both packages into the same parameter tree;
  - an image head the kernel does not compute (--set model.combine=add)
    scored by PairScorer(image_mode=True) as JAX scores it.
The card holds the kernels themselves to the plain version at these widths
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 16)."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.configs import experiments as jexp  # noqa: E402
from point_cloud_reid_tpu.configs import models as jmodels  # noqa: E402
from point_cloud_reid_tpu.inference import PairScorer as JaxScorer  # noqa: E402
from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu.ops.pallas import match_grid as jmg  # noqa: E402
from point_cloud_reid_tpu_torch import configs as tcfg  # noqa: E402
from point_cloud_reid_tpu_torch.configs.widths import WIDTHS  # noqa: E402
from point_cloud_reid_tpu_torch.convert import to_jax_variables  # noqa: E402
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.tools.ab_match import inputs  # noqa: E402
from tests._torch_image import (images, jax_variables_of,  # noqa: E402
                                tiny_image_cfg)
from tests._torch_port import TINY, crops  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401
from tests.test_torch_match_rows_plan import read_stage  # noqa: E402

BF16 = torch.bfloat16
# the padded layout against the plain chain, both float32, relative to
# max(1, |plain|): only the LayerNorm's 1/C and the summation order differ
# (read 3e-7 here at C = 120)
PAD_TOL = 1e-6
# the JAX suite's bars (tests/test_torch_flagship_family.py): the model
# through a converter; the grid and pair chains (tests/test_pair_grid.py),
# also those of the image tests (tests/test_torch_image_kernels.py)
MODEL_TOL = 1e-3
GRID_RTOL, GRID_ATOL = 2e-4, 2e-5
SHAPES = ((16, 2), (32, 2), (48, 4), (96, 2), (96, 3), (120, 8))


def _widths(C: int) -> list:
    """The kernel widths a head of C channels runs at: the cluster tier's
    (C <= 64) and the rows tier's."""
    out = {mg.kernel_width(C, mg.ROWS)}
    if C <= mg.CLUSTER_WIDTHS[-1]:
        out.add(mg.kernel_width(C, mg.CLUSTER))
    return sorted(out)


def _pairs():
    return torch.tensor([0, 1, 1, 0, 1]), torch.tensor([2, 0, 1, 1, 2])


# ---- the padded layout --------------------------------------------------------

@pytest.mark.parametrize("head", ["point", "image"])
@pytest.mark.parametrize("C,H", SHAPES)
def test_padded_layout_equals_the_plain_chain(head, C, H):
    """padded_reference at every kernel width of C equals the unpadded
    plain chain; the padded lanes of the padded chain's pooled output are
    exactly 0 (an unused head slot's message stays 0, not NaN)."""
    t, d, w1, w2, H = inputs(head, 2, 3, 5, C, H, device="cpu")
    ti, di = _pairs()
    want = mg.match_pooled_reference(t, d, w1, w2, H, ti, di)
    for W in _widths(C):
        got = mg.padded_reference(t, d, w1, w2, H, ti, di, W)
        assert got.shape == want.shape == (5, 2 * C)
        err = ((got - want).abs().max() / max(1.0, want.abs().max())).item()
        assert err <= PAD_TOL, (W, err)
        pw1, pw2 = mg.pad_weights(w1, w2, W)
        full = mg.match_pooled_reference(mg.pad_side(t, W), mg.pad_side(d, W),
                                         pw1, pw2, H, ti, di, ct=C)
        assert torch.isfinite(full).all()
        assert not full[:, C:W].any() and not full[:, W + C:].any()


@pytest.mark.parametrize("head", ["point", "image"])
def test_zeros_alone_get_the_padded_chain_wrong(head):
    """The padded layout without the kernels' masks: elu+1 of a zero lane
    is 1 (each padded stage-2 q and k lane adds 1 to q . sum k and to k^T v)
    and LayerNorm's statistics take in the padded lanes, so the chain moves
    far past the bar; the true width's heads and 1 / C without the lane
    masks do not mend it."""
    C, H, W = 96, 2, 128
    t, d, w1, w2, H = inputs(head, 2, 3, 5, C, H, device="cpu")
    ti, di = _pairs()
    want = mg.match_pooled_reference(t, d, w1, w2, H, ti, di)
    pw1, pw2 = mg.pad_weights(w1, w2, W)
    bare = mg.unpad_pooled(mg.match_pooled_reference(
        mg.pad_side(t, W), mg.pad_side(d, W), pw1, pw2, H, ti, di), C)
    assert (bare - want).abs().max() > 1e-2
    # the heads and LayerNorm's 1 / C of the true width, the lanes unmasked
    lane = mg._lane_mask
    try:
        mg._lane_mask = lambda W_, ct, device: torch.ones(W_, device=device)
        elu_only = mg.padded_reference(t, d, w1, w2, H, ti, di, W)
    finally:
        mg._lane_mask = lane
    assert (elu_only - want).abs().max() > 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("C,H", [(32, 2), (96, 3), (120, 8)])
def test_padded_stage_copies_read_back(C, H, dtype):
    """The rows tier's stage copies at the padded width W, byte for byte as
    the kernel reads them: every weight stage holds its block of the padded
    matrices (the true matrices in place, zeros elsewhere); the padded
    [KV | Z]'s message stages hold KV^T over one band of all W columns (the
    layout of one head, which the padded entry points take) and sum k is
    Z's diagonal, zero past C."""
    bf16 = dtype == BF16
    W = mg.kernel_width(C, mg.ROWS)
    pk = 64 if bf16 else 32
    t, d, w1, w2, H = inputs("point", 2, 1, 6, C, H, device="cpu",
                             dtype=dtype)
    pw1, pw2 = mg.pad_weights(w1, w2, W)
    stages = mg.rows_stage_weights(pw1, pw2, bf16).reshape(-1, 4096)
    seq = mg.weight_blocks(W, pk)
    assert stages.shape[0] == len(seq)
    mats = mg._weight_matrices(pw1, pw2)
    for i, (name, r0, k0) in enumerate(seq):
        want = mats[name][r0:r0 + 64, k0:k0 + pk]
        want = want.to(BF16).double() if bf16 else want.double()
        assert torch.equal(read_stage(stages[i], bf16), want), (i, name)
    # the padded matrices ((out, in) layout): the true blocks, zeros around
    true = mg._weight_matrices(w1, w2)
    place = {"merge1": [(0, 0, "merge1")], "merge2": [(0, 0, "merge2")],
             "q2": [(0, 0, "q2")], "fc1b1": [(0, 0, "fc1b1")],
             "fc1b2": [(0, 0, "fc1b2")], "fc1a2": [(0, 0, "fc1a2")],
             "fc2_1": [(0, 0, "fc2_1")], "fc2_2": [(0, 0, "fc2_2")],
             "kv2": [(0, 0, "k"), (W, 0, "v")]}
    true["k"], true["v"] = true["kv2"][:C], true["kv2"][C:]
    for name, m in mats.items():
        rest = m.clone()
        for r, c, src in place[name]:
            block = true[src]
            assert torch.equal(m[r:r + block.shape[0], c:c + block.shape[1]],
                               block), name
            rest[r:r + block.shape[0], c:c + block.shape[1]] = 0
        assert not rest.any(), name
    kvz = mg.pad_side(t, W)[2]
    assert torch.equal(kvz[:, :C, :C], t[2][:, :, :C])
    assert torch.equal(kvz[:, :C, W:W + C], t[2][:, :, C:])
    ms, ks = mg.message_stages(kvz, 1, bf16)
    blocks = mg.message_blocks(W, 1, pk)
    assert len(blocks) == mg.rows_layout(W, 1, dtype).kv_stages
    for o in range(2):
        kvt = kvz[o, :, :W].t().double()
        for i, (r0, k0) in enumerate(blocks):
            got = read_stage(ms[o, i * 4096:(i + 1) * 4096], bf16)
            assert torch.equal(got, kvt[r0:r0 + 64, k0:k0 + pk]), (o, i)
        assert torch.equal(ks[o, :C], torch.diagonal(t[2][o, :, C:]).float())
        assert not ks[o, C:].any()


# ---- the plan ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("pos", [True, False])
def test_plan_takes_every_width_to_128_channels(pos, dtype):
    """A tier for every C <= 128 and H <= 8 dividing it, point and image
    head, at both dtypes and any N, with the bytes of the width it runs at;
    past 1024 channels, or 16 heads where the rows tier is needed at 128
    channels or fewer, ValueError naming ROADMAP.md's K7
    (tests/test_torch_wide_widths.py and tests/test_torch_k7_widths.py take
    the widths and heads between)."""
    bf16 = dtype == BF16
    for C in range(1, 129):
        for H in (h for h in range(1, 9) if C % h == 0):
            for N in (1, 128, 197, 256, 2048, 5000):
                how = mg.plan(N, C, H, pos=pos, dtype=dtype)
                W = mg.kernel_width(C, how.tier)
                assert W >= C and how.smem <= mg.MAX_SMEM
                if how.tier == mg.CLUSTER:
                    assert how.smem == (mg.cluster_bytes_bf16 if bf16 else
                                        mg.cluster_bytes)(N, W)
                elif how.tier == mg.ROWS:   # 16 heads' normalisers padded
                    assert how.smem == mg.rows_layout(W, mg.layout_heads(
                        C, H, 5 if pos else 4), dtype).smem
                else:
                    assert (how.tier, C, pos) == (mg.ROWS_MMA, 16, True)
    for args in ((128, 1025, 1), (128, 2048, 2), (2048, 96, 24),
                 (300, 64, 32), (5000, 32, 32)):
        with pytest.raises(ValueError, match="K7"):
            mg.plan(*args, pos=pos, dtype=dtype)


# ---- the widths against JAX ------------------------------------------------------

def _point_models(conv_out: int):
    """(jax model, jax variables, torch model) of the tiny flagship at
    conv_out channels (two heads), one set of seeded weights."""
    kw = dict(TINY, conv_out=conv_out)
    tmodel = build_model(tcfg.point_transformer_point_cat(**kw),
                         generator=torch.Generator().manual_seed(conv_out))
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tmodel))
    return jax_build(jmodels.point_transformer_point_cat(**kw)), jvars, tmodel


def _image_cfg(dim: int) -> dict:
    """The tiny image model (tests/_torch_image.py) at downsample_dim dim."""
    cfg = copy.deepcopy(tiny_image_cfg("deit-test"))
    cfg["downsample_dim"] = dim
    cfg["downsample"][-1]["out_features"] = dim
    cfg["cross_lin_attn"]["d_model"] = dim
    cfg["match_head"][0].update(n_in=2 * dim, n_out=2 * dim)
    return cfg


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("conv_out", [32, 96])
def test_point_width_matches_jax(conv_out):
    """Embeddings, the scorer's grid and a pair list of the flagship at
    conv_out 32 / 96 (16- / 48-channel heads), the port against JAX."""
    jmodel, jvars, tmodel = _point_models(conv_out)
    a, b = crops(60, 3), crops(61, 4)
    with torch.no_grad():
        xt, ht = tmodel.embed(torch.from_numpy(a))
        xd, hd = tmodel.embed(torch.from_numpy(b))
    assert ht.shape == (3, 32, conv_out)
    _, jh = jmodel.apply(jvars, jnp.asarray(a), train=False, method="embed")
    _close(ht.numpy(), jh, MODEL_TOL, MODEL_TOL)
    args = (ht, xt, hd, xd)
    jargs = tuple(jnp.asarray(x.numpy()) for x in args)
    scorer = PairScorer(tmodel)
    assert scorer.fused
    ti, di = torch.tensor([0, 1, 2, 2, 0]), torch.tensor([3, 0, 1, 2, 2])
    with torch.no_grad():
        grid = scorer.cost_matrix(*args)
        pairs = scorer._pairs(*args, ti, di)
    _close(grid.numpy(), JaxScorer(jmodel, jvars).cost_matrix(*jargs),
           GRID_RTOL, GRID_ATOL)
    _close(pairs.numpy(), jmg.xla_pair_logits(
        jmodel, jvars, *jargs, jnp.asarray(ti.numpy()),
        jnp.asarray(di.numpy())), GRID_RTOL, GRID_ATOL)


def test_image_width_matches_jax():
    """Tokens, the scorer's grid and a pair list of the tiny image model at
    downsample_dim 96 (two 48-channel heads), the port against JAX."""
    cfg = _image_cfg(96)
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(96))
    jmodel, jvars = jax_build(copy.deepcopy(cfg)), jax_variables_of(
        tmodel, "deit-test")
    ia, ib = images(62, 3), images(63, 4)
    with torch.no_grad():
        ht = tmodel.downsample_tokens(tmodel.embed(torch.from_numpy(ia)))
        hd = tmodel.downsample_tokens(tmodel.embed(torch.from_numpy(ib)))
    assert ht.shape[-1] == 96
    jt = jmodel.apply(jvars, jmodel.apply(jvars, jnp.asarray(ia), train=False,
                                          method="embed"),
                      train=False, method="downsample_tokens")
    _close(ht.numpy(), jt, MODEL_TOL, MODEL_TOL)
    scorer = PairScorer(tmodel, image_mode=True)
    assert scorer.fused
    ti, di = torch.tensor([0, 1, 2, 2, 0]), torch.tensor([3, 0, 1, 2, 2])
    with torch.no_grad():
        grid = scorer.cost_matrix(ht, None, hd, None)
        pairs = scorer._image_pairs(ht, hd, ti, di)
    jt, jd = jnp.asarray(ht.numpy()), jnp.asarray(hd.numpy())
    _close(grid.numpy(), JaxScorer(jmodel, jvars, image_mode=True).cost_matrix(
        jt, None, jd, None), GRID_RTOL, GRID_ATOL)
    _close(pairs.numpy(), jmg.xla_image_pair_logits(
        jmodel, jvars, jt, jd, jnp.asarray(ti.numpy()),
        jnp.asarray(di.numpy())), GRID_RTOL, GRID_ATOL)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_shapes(v, p) if isinstance(v, dict)
                   else {p: tuple(v.shape)})
    return out


def _width_config(name: str) -> dict:
    """The model config a point entry of configs/widths.py stands for: the
    flagship at conv_out C (heads32: at 256 with 32 heads in both cross
    stages), or the 7M model (conv_out 128, mul 8) with 16 heads in both
    cross stages or at mul 16, 6 or 24."""
    if name.startswith("conv_out"):
        return tcfg.point_transformer_point_cat(conv_out=int(name[8:]))
    if name == "heads32":
        cfg = tcfg.point_transformer_point_cat(conv_out=256)
        cfg["cross_stage1"]["nhead"] = cfg["cross_stage2"]["nhead"] = 32
        return cfg
    cfg = tcfg.point_transformer_point_cat(
        conv_out=128, mul=int(name[3:]) if name.startswith("mul") else 8)
    if name == "heads16":
        cfg["cross_stage1"]["nhead"] = cfg["cross_stage2"]["nhead"] = 16
    return cfg


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_width_set_lines_build_the_same_tree(name):
    """Both packages read a width's --set lines into the same model config,
    the one the width's factory gives; the port's model of it has the JAX
    model's parameter tree (jax.eval_shape of its init), leaf for leaf."""
    leaf, sets = WIDTHS[name]
    cfg = tcfg.get_experiment(leaf, sets)["model"]
    assert cfg == jexp.get_experiment(leaf, sets)["model"]
    if name.startswith("image"):
        assert cfg["downsample_dim"] == cfg["cross_lin_attn"]["d_model"] \
            == cfg["downsample"][-1]["out_features"] == int(name[5:])
        x = jnp.zeros((1, 3, 224, 224))
    else:
        assert cfg == _width_config(name)
        x = jnp.zeros((1, 32, 3))
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(0))
    jmodel = jax_build(copy.deepcopy(cfg))
    init = jax.eval_shape(lambda k: jmodel.init(
        k, dict(sparse_1=x, sparse_2=x), train=False), jax.random.PRNGKey(0))
    have = to_jax_variables(tmodel)
    assert _shapes(dict(have["params"])) == _shapes(dict(init["params"]))


# ---- an image head the kernel does not compute --------------------------------

def test_image_head_the_kernel_does_not_compute_scores_as_jax():
    """DeiT-tiny's leaf with --set model.combine=add: fused_head_ok refuses
    it, PairScorer(image_mode=True) scores it by the model's own path (no
    match-kernel launch), grid and pairs as JAX's scorer and
    xla_image_pair_logits on the same converted weights."""
    leaf = "rgb_deit-tiny_point-cat_pt_nus_det_4x60_200e"
    sets = ["model.combine=add"]
    cfg = tcfg.get_experiment(leaf, sets)["model"]
    assert cfg == jexp.get_experiment(leaf, sets)["model"]
    tmodel = build_model(copy.deepcopy(cfg),
                         generator=torch.Generator().manual_seed(5))
    tmodel.eval()
    jmodel = jax_build(copy.deepcopy(cfg))
    jvars = jax_variables_of(tmodel, cfg["backbone"])
    assert not mg.fused_head_ok(tmodel, image_mode=True)
    scorer = PairScorer(tmodel, image_mode=True)
    assert not scorer.fused
    rs = np.random.RandomState(7)
    S, C = cfg["output_sequence_size"], cfg["downsample_dim"]
    ht = torch.from_numpy(rs.randn(3, S, C).astype(np.float32))
    hd = torch.from_numpy(rs.randn(4, S, C).astype(np.float32))
    ti, di = torch.tensor([0, 1, 2, 2, 0]), torch.tensor([3, 0, 1, 2, 2])
    before = {f: f.launches for f in (mg.fused_image_match_grid,
                                      mg.fused_image_match_pairs)}
    with torch.no_grad():
        grid = scorer.cost_matrix(ht, None, hd, None)
        pairs = scorer._image_pairs(ht, hd, ti, di)
    assert {f: f.launches for f in before} == before
    jt, jd = jnp.asarray(ht.numpy()), jnp.asarray(hd.numpy())
    want = JaxScorer(jmodel, jvars, image_mode=True).cost_matrix(
        jt, None, jd, None)
    _close(grid.numpy(), want, GRID_RTOL, GRID_ATOL)
    _close(pairs.numpy(), jmg.xla_image_pair_logits(
        jmodel, jvars, jt, jd, jnp.asarray(ti.numpy()),
        jnp.asarray(di.numpy())), GRID_RTOL, GRID_ATOL)
    _close(pairs.numpy(), grid.numpy()[ti.numpy(), di.numpy()], GRID_RTOL,
           GRID_ATOL)


@pytest.mark.parametrize("sparse", ["never", "always"])
def test_tracker_scores_an_image_head_the_kernel_does_not_compute(sparse):
    """TrackingManager over PairScorer(image_mode=True) with the tiny image
    model at combine 'add' (same weights on both sides): the same tracks
    and, dense and gated sparse, the same logits as JAX's manager."""
    from point_cloud_reid_tpu.tracking import TrackingManager as JaxManager
    from point_cloud_reid_tpu_torch.tracking import TrackingManager
    from tests._torch_image import tiny_image_models
    from tests.test_torch_image_tracking import _scene
    _, jvars, base = tiny_image_models()
    tmodel = copy.deepcopy(base)
    tmodel.combine = "add"
    cfg = dict(tiny_image_cfg("deit-test"), combine="add")
    jmodel = jax_build(copy.deepcopy(cfg))
    logits = {"jax": [], "port": []}

    class JaxRec(JaxManager):
        def _step_device_cached_image(self, *a, **k):
            out = super()._step_device_cached_image(*a, **k)
            logits["jax"].append(out[0])
            return out

    class PortRec(TrackingManager):
        def _step_device_cached_image(self, *a, **k):
            out = super()._step_device_cached_image(*a, **k)
            logits["port"].append(out)
            return out

    kw = dict(seed=1, sparse_scoring=sparse, max_distance=3.0)
    jmgr = JaxRec(JaxScorer(jmodel, jvars, image_mode=True), **kw)
    scorer = PairScorer(tmodel, image_mode=True)
    assert not scorer.fused
    tmgr = PortRec(scorer, **kw)
    for frame in _scene():
        jt, tt = jmgr.step(*frame), tmgr.step(*frame)
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
    scored = 0
    for t, j in zip(logits["port"], logits["jax"]):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
            fin = np.isfinite(j)
            scored += fin.sum()
            _close(t[fin], j[fin], GRID_RTOL, GRID_ATOL)
    assert scored > 0 and len(logits["port"]) == 4
    assert (scorer.last_frame["pairs"] is None) == (sparse == "never")
