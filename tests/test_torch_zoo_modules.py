"""The tracker-era zoo's modules against the JAX package: the attention
primitives with masks (linear and softmax) and the config strings that pick
them, LocalSelfAttention, the LoFTR layers and stage, the PostRes / Res1d
head layers and gated pooling, and the converter both ways for each.

Weights are the port's seeded init handed to JAX by
convert.to_jax_variables (or, for the round trips, JAX's init handed to the
port); inputs come from numpy seeds. Tolerances, relative to max(1, max
|JAX|):
  attention primitives: 1e-6;
  LocalSelfAttention: 1e-5, with 'linear' and with 'linear-pallas' (the
    JAX side runs linear_attention_pallas in interpret mode, as its own
    tests on the CPU; the port its kernel's plain version);
  LoFTR, PostRes, Res1d and gated pooling in eval: 1e-5; train mode
    (BatchNorm statistics) in float64 on both sides at 1e-9;
  converter round trips: bit for bit.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models import attention_blocks as jab  # noqa: E402
from point_cloud_reid_tpu.models import loftr as jloftr  # noqa: E402
from point_cloud_reid_tpu.models import node_pooling as jpool  # noqa: E402
from point_cloud_reid_tpu.models.registry import SequentialHead as JHead  # noqa: E402
from point_cloud_reid_tpu.ops import attention as jatt  # noqa: E402
from point_cloud_reid_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                                to_jax_variables)
from point_cloud_reid_tpu_torch.kernels import linear_attention as la  # noqa: E402
from point_cloud_reid_tpu_torch.models import attention_blocks as tab  # noqa: E402
from point_cloud_reid_tpu_torch.models import init_weights  # noqa: E402
from point_cloud_reid_tpu_torch.models import loftr as tloftr  # noqa: E402
from point_cloud_reid_tpu_torch.models import node_pooling as tpool  # noqa: E402
from point_cloud_reid_tpu_torch.models.registry import build_head  # noqa: E402
from point_cloud_reid_tpu_torch.ops import attention as tatt  # noqa: E402
from tests._torch_port import assert_close_scaled, port_flat  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

OP_TOL = 1e-6
MOD_TOL = 1e-5
TRAIN64_TOL = 1e-9


def _holder(name: str, module: torch.nn.Module, seed: int = 0):
    """(holder with `module` as `name`, its flax {'params', 'batch_stats'}
    under that name, as jnp arrays)."""
    holder = torch.nn.Module()
    setattr(holder, name, module)
    init_weights(holder, torch.Generator().manual_seed(seed))
    tree = to_jax_variables(holder)
    return holder, {c: jax.tree_util.tree_map(jnp.asarray, tree[c].get(
        name, {})) for c in tree}


def _round_trip(holder, name: str, jmodule, *args, **kwargs):
    """JAX's own init of `jmodule` (running statistics moved by a
    train-mode call when it has any) -> from_jax_variables ->
    to_jax_variables gives the same leaves, bit for bit."""
    variables = jmodule.init(jax.random.PRNGKey(3), *args, **kwargs)
    if "batch_stats" in variables:
        _, mut = jmodule.apply(variables, *args, **dict(kwargs, train=True),
                               mutable=["batch_stats"])
        variables = dict(variables, batch_stats=mut["batch_stats"])
    want = {c: {name: jax.tree_util.tree_map(np.asarray, v)}
            for c, v in variables.items()}
    got = to_jax_variables(from_jax_variables(holder, want))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        {c: got[c] for c in want})[0])
    assert len(flat_w) == len(flat_g) and flat_w
    for path, w in flat_w:
        g = flat_g[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


# ---- attention primitives ---------------------------------------------------

def _qkv(seed: int, B=3, L=5, S=7, H=2, D=4, V=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, L, H, D).astype(np.float32),
            rs.randn(B, S, H, D).astype(np.float32),
            rs.randn(B, S, H, V).astype(np.float32))


def _masks(kind: str, B=3, L=5, S=7):
    rs = np.random.RandomState(9)
    q = (rs.rand(B, L) > 0.3).astype(np.float32)
    kv = (rs.rand(B, S) > 0.3).astype(np.float32)
    q[0, 0], kv[1] = 0.0, 0.0     # a masked query; a sample with no key
    kv[0, 0] = 1.0
    return {"none": (None, None), "q": (q, None), "kv": (None, kv),
            "both": (q, kv)}[kind]


def _np_or_none(x, to):
    return None if x is None else to(x)


@pytest.mark.parametrize("masks", ["none", "q", "kv", "both"])
@pytest.mark.parametrize("fn", ["linear_attention", "full_attention"])
def test_attention_primitives_with_masks_match_jax(fn, masks):
    """Masked queries and keys drop out; in softmax attention a row with
    every score masked (a masked query, a sample with no key) is zeros, as
    JAX's nan_to_num gives."""
    q, k, v = _qkv(1)
    qm, kvm = _masks(masks)
    want = np.asarray(getattr(jatt, fn)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_mask=_np_or_none(qm, jnp.asarray),
        kv_mask=_np_or_none(kvm, jnp.asarray)))
    got = getattr(tatt, fn)(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_mask=_np_or_none(qm, torch.from_numpy),
        kv_mask=_np_or_none(kvm, torch.from_numpy)).numpy()
    assert np.isfinite(got).all()
    assert_close_scaled(got, want, OP_TOL, fn)
    if fn == "full_attention" and kvm is not None:
        assert not got[1].any()         # sample 1 has no key
    if fn == "full_attention" and qm is not None:
        assert not got[0, 0].any()      # a masked query


@pytest.mark.parametrize("masks", ["none", "both"])
def test_kernel_attention_falls_back_on_masks_as_jax(masks):
    """'linear-pallas' with masks is the composite, as JAX's dispatch runs
    it; without masks it is the kernel's Function (on CPU tensors its plain
    version), against linear_attention_pallas in interpret mode."""
    q, k, v = _qkv(2)
    qm, kvm = _masks(masks)
    want = np.asarray(jab._attn_fn("linear-pallas")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_mask=_np_or_none(qm, jnp.asarray),
        kv_mask=_np_or_none(kvm, jnp.asarray)))
    got = tab._attn_fn("linear-pallas")(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_mask=_np_or_none(qm, torch.from_numpy),
        kv_mask=_np_or_none(kvm, torch.from_numpy)).numpy()
    assert_close_scaled(got, want, OP_TOL, masks)


@pytest.mark.parametrize("kind", ["linear", "linear-pallas", "full",
                                  "softmax", "anything-else"])
def test_attention_config_strings_follow_jax(kind):
    """JAX's dispatch sends every string but 'linear' and 'linear-pallas'
    to softmax attention; the port's does the same."""
    got, want = tab._attn_fn(kind), jab._attn_fn(kind)
    if kind == "linear":
        assert got is tatt.linear_attention and want is jatt.linear_attention
    elif kind == "linear-pallas":
        assert got is la.fused_linear_attention
    else:
        assert got is tatt.full_attention and want is jatt.full_attention


# ---- LocalSelfAttention -----------------------------------------------------

def _local_inputs(seed: int, B=3, N=20, C=16):
    """Features with repeated rows (exact ties in the feature-space kNN)
    and xyz."""
    rs = np.random.RandomState(seed)
    f = rs.randn(B, N, C).astype(np.float32)
    f[:, -4:] = f[:, :4]
    return f, (rs.randn(B, N, 3) * 0.6).astype(np.float32)


@pytest.mark.parametrize("attention", ["linear", "linear-pallas"])
def test_local_self_attention_matches_jax(attention):
    holder, var = _holder("local_stage1", tab.LocalSelfAttention(
        16, 2, knum=6, pos_size=16, attention=attention))
    f, xyz = _local_inputs(4)
    jmod = jab.LocalSelfAttention(16, 2, knum=6, pos_size=16,
                                  attention=attention)
    want = np.asarray(jax.jit(jmod.apply)(
        {"params": var["params"]}, jnp.asarray(f), jnp.asarray(xyz)))
    with torch.no_grad():
        got = holder.local_stage1(torch.from_numpy(f), torch.from_numpy(xyz))
    assert got.shape == (3, 20, 16)
    assert_close_scaled(got.numpy(), want, MOD_TOL, attention)
    _round_trip(holder, "local_stage1", jmod, jnp.asarray(f),
                jnp.asarray(xyz))


def test_local_self_attention_pos_size_must_be_d_model():
    with pytest.raises(ValueError, match="pos_size"):
        tab.LocalSelfAttention(16, 2, pos_size=8)
    f, xyz = _local_inputs(5)
    with pytest.raises(ValueError, match="pos_size"):
        jab.LocalSelfAttention(16, 2, pos_size=8).init(
            jax.random.PRNGKey(0), jnp.asarray(f), jnp.asarray(xyz))


# ---- LoFTR ------------------------------------------------------------------

def _feats(seed: int, B=2, N=9, M=6, C=16):
    rs = np.random.RandomState(seed)
    return rs.randn(B, N, C).astype(np.float32), rs.randn(B, M, C).astype(
        np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("attention", ["full", "linear"])
def test_loftr_transformer_matches_jax(attention, masked):
    """LocalFeatureTransformer (self, cross, self, cross: four layers of
    their own weights) and each of its layers, with and without masks."""
    names = ("self", "cross") * 2
    t = tloftr.LocalFeatureTransformer(16, 2, names, attention)
    holder, var = _holder("loftr", t)
    x0, x1 = _feats(6)
    m0 = m1 = None
    if masked:
        rs = np.random.RandomState(7)
        m0 = (rs.rand(2, 9) > 0.3).astype(np.float32)
        m1 = (rs.rand(2, 6) > 0.3).astype(np.float32)
        m1[:, 0] = 1.0
    jmod = jloftr.LocalFeatureTransformer(16, 2, names, attention)
    jm = [_np_or_none(m, jnp.asarray) for m in (m0, m1)]
    want = jax.jit(jmod.apply)({"params": var["params"]}, jnp.asarray(x0),
                               jnp.asarray(x1), *jm)
    tm = [_np_or_none(m, torch.from_numpy) for m in (m0, m1)]
    with torch.no_grad():
        got = t(torch.from_numpy(x0), torch.from_numpy(x1), *tm)
        # the first layer alone, as a self layer and as a cross layer
        layer = jloftr.LoFTREncoderLayer(16, 2, attention)
        lvar = {"params": var["params"]["layers_0"]}
        for src, sm in ((x0, m0), (x1, m1)):
            lw = np.asarray(layer.apply(lvar, jnp.asarray(x0),
                                        jnp.asarray(src), jm[0],
                                        _np_or_none(sm, jnp.asarray)))
            lg = t.layers[0](torch.from_numpy(x0), torch.from_numpy(src),
                             tm[0], _np_or_none(sm, torch.from_numpy))
            assert_close_scaled(lg.numpy(), lw, MOD_TOL, "layer")
    for g, w, side in zip(got, want, ("feat0", "feat1")):
        assert_close_scaled(g.numpy(), np.asarray(w), MOD_TOL, side)


def test_loftr_stage_linear_pallas_is_softmax_as_jax():
    """The JAX layer runs softmax attention for every string but 'linear'
    (loftr.py:48), 'linear-pallas' included: the port's stage follows it
    and launches no kernel."""
    x0, x1 = _feats(8)
    outs = {}
    for attention in ("linear-pallas", "full", "linear"):
        holder, var = _holder("cross_stage1", tloftr.LoFTRStage(
            16, 2, attention=attention, n_layers=1))
        jmod = jloftr.LoFTRStage(16, 2, attention=attention, n_layers=1)
        want = np.asarray(jmod.apply({"params": var["params"]},
                                     jnp.asarray(x0), None, jnp.asarray(x1),
                                     None))
        with torch.no_grad():
            got = holder.cross_stage1(torch.from_numpy(x0), None,
                                      torch.from_numpy(x1), None).numpy()
        assert_close_scaled(got, want, MOD_TOL, attention)
        outs[attention] = got
        if attention == "linear-pallas":
            _round_trip(holder, "cross_stage1", jmod, jnp.asarray(x0), None,
                        jnp.asarray(x1), None)
    np.testing.assert_array_equal(outs["linear-pallas"], outs["full"])
    assert np.abs(outs["linear"] - outs["full"]).max() > 1e-3


# ---- PostRes / Res1d --------------------------------------------------------

CONV_HEADS = {
    # stride 1, same width: no downsample branch
    "postres-gn": ([dict(type="PostRes", n_out=8, norm="GN", ng=4)],
                   (2, 6, 5, 8)),
    # stride 2 over an odd and an even side, a new width: the downsample
    # branch, flax's SAME padding after the odd pixel
    "postres-bn-s2": ([dict(type="PostRes", n_out=12, stride=2, norm="BN"),
                       dict(type="ReLU")], (3, 7, 6, 8)),
    "res1d-gn": ([dict(type="Res1d", n_out=16, kernel_size=3, norm="GN",
                       ng=4), dict(type="Linear", out_features=3)],
                 (2, 9, 8)),
    "res1d-bn-s2-k5": ([dict(type="Res1d", n_out=12, kernel_size=5,
                             stride=2, norm="BN")], (3, 11, 8)),
}


def _conv_head(name: str, seed: int = 0):
    specs, shape = CONV_HEADS[name]
    thead = build_head(specs, shape[-1])
    holder, var = _holder("match_head", thead, seed)
    return holder, var, JHead(specs=tuple(dict(s) for s in specs)), shape


@pytest.mark.parametrize("name", list(CONV_HEADS))
def test_conv_residual_blocks_match_jax(name):
    """PostRes / Res1d in a SequentialHead: eval in float32; train mode in
    float64 with the BatchNorms' running statistics; the converter's round
    trip of JAX's own init."""
    holder, var, jhead, shape = _conv_head(name)
    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    want = jax.jit(functools.partial(jhead.apply, train=False))(
        var, jnp.asarray(x))
    with torch.no_grad():
        got = holder.match_head(torch.from_numpy(x))
    assert_close_scaled(got.numpy(), np.asarray(want), MOD_TOL, "eval")
    with jax.enable_x64():
        var64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       var)
        jhead64 = JHead(specs=jhead.specs, dtype=jnp.float64)
        want, mut = jhead64.apply(var64, jnp.asarray(x, jnp.float64),
                                  train=True, mutable=["batch_stats"])
        want = np.asarray(want)
        stats = port_flat({"match_head": jax.tree_util.tree_map(
            np.asarray, mut["batch_stats"])})
    holder = holder.double()
    with torch.no_grad():
        got = holder.match_head(torch.from_numpy(x).double(), True)
    assert_close_scaled(got.numpy(), want, TRAIN64_TOL, "train")
    got_stats = {k: v.numpy() for k, v in holder.state_dict().items()
                 if "running_" in k}
    assert set(got_stats) == set(stats)
    assert bool(stats) == ("bn" in name)
    for k, v in stats.items():
        assert_close_scaled(got_stats[k], v, TRAIN64_TOL, k)
    holder, _, jhead, _ = _conv_head(name, seed=1)
    _round_trip(holder, "match_head", jhead, jnp.asarray(x), train=False)


# ---- gated pooling ----------------------------------------------------------

def test_gated_pooling_matches_jax():
    """Both readouts over nodes and edges of graphs 0, 1 and 3 of 5 slots:
    the unused slots' sums are zero rows (the output there is the final
    Linear's bias)."""
    rs = np.random.RandomState(12)
    nodes = rs.randn(10, 6).astype(np.float32)
    edges = rs.randn(7, 4).astype(np.float32)
    nseg = np.array([0, 0, 1, 3, 3, 3, 1, 0, 3, 1])
    eseg = np.array([1, 1, 0, 3, 3, 0, 1])
    for kind in ("node", "edge"):
        if kind == "node":
            t = tpool.GatedPooling(6, 5)
            jmod = jpool.GatedPooling(6, 5)
            targs = (torch.from_numpy(nodes), torch.from_numpy(nseg), 5)
            jargs = (jnp.asarray(nodes), jnp.asarray(nseg), 5)
        else:
            t = tpool.EdgeGatedPooling(6, 4, 5)
            jmod = jpool.EdgeGatedPooling(6, 4, 5)
            targs = (torch.from_numpy(nodes), torch.from_numpy(edges),
                     torch.from_numpy(nseg), torch.from_numpy(eseg), 5)
            jargs = (jnp.asarray(nodes), jnp.asarray(edges),
                     jnp.asarray(nseg), jnp.asarray(eseg), 5)
        holder, var = _holder("pool", t)
        want = np.asarray(jmod.apply({"params": var["params"]}, *jargs))
        with torch.no_grad():
            got = t(*targs).numpy()
        assert got.shape == (5, 5)
        assert_close_scaled(got, want, MOD_TOL, kind)
        bias = t.poolingLayer[0].bias.detach().numpy()
        for slot in (2, 4):
            np.testing.assert_array_equal(got[slot], bias)
        _round_trip(holder, "pool", jmod, *jargs)
