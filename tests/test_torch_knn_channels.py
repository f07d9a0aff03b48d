"""The kNN kernel over C channels (kernels/knn.py tier C, the port of
knn_pallas at any channel count) and the chunked EdgeConv
(models/dgcnn._EdgeConvChunks) against the JAX package, on the CPU.

  - knn_reference (the kernel's plain version) at C = 5 and 64 against
    JAX's knn_pallas in interpret mode, on duplicated and random features:
    indices equal;
  - plan at C != 3 and at bf16: tier C, its stage width and shared bytes
    (within a block's 232,448); the wrapper's CPU route with and without
    keep_dtype, and knn_feature_space bit for bit as the sort it was;
  - EdgeConv with its chunks forced uneven (at least three) against JAX's
    EdgeConv, train and eval, float64: outputs, running statistics, and
    the gradients of input, weight, gamma and beta under a seeded
    cotangent, at the DGCNN tests' float64 bar (TRAIN64_TOL 1e-9); its
    backward against finite differences; a data-parallel group of one
    rank (the global sums' route) against the plain route;
  - the DGCNN leaf's train step with chunks forced against JAX's
    (tests/_torch_port.check_leaf_step, its tolerances), and against the
    port's unchunked step, plain and --remat (float64: logs at 1e-9, the
    weights at LEAF_STEP64_TOL).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models.dgcnn import EdgeConv as JEdgeConv  # noqa: E402
from point_cloud_reid_tpu.ops.pallas.knn import knn_pallas  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import knn as kk  # noqa: E402
from point_cloud_reid_tpu_torch.models import dgcnn as tdgcnn  # noqa: E402
from point_cloud_reid_tpu_torch.models.layers import BatchNorm  # noqa: E402
from point_cloud_reid_tpu_torch.ops import geometry as tgeo  # noqa: E402
from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud  # noqa: E402
from tests._torch_port import (LEAF_STEP64_TOL, assert_close_scaled,  # noqa: E402
                               check_leaf_step, compile_together, pair_batch,
                               port_step)
from tests._torch_threads import few_threads  # noqa: E402,F401
from tests.test_torch_pointnet_dgcnn import (DGCNN, TRAIN64_TOL,  # noqa: E402
                                             leaf_cfg)

# the EdgeConv module under test: C_IN channels in, F_OUT out, K
# neighbours, B clouds of N points (the last DUPS repeat earlier ones)
C_IN, F_OUT, K, B, N, DUPS = 5, 12, 4, 2, 25, 5
# 16 rows of edges a chunk: the module's 50 centre rows in 16, 16, 16, 2
CHUNK_ROWS = 16


def _features(kind: str, Bc: int, Nc: int, C: int, seed: int) -> np.ndarray:
    if kind == "duplicated":
        return knn_cloud("duplicates", Bc, Nc, seed, C)
    return knn_cloud("random", Bc, Nc, seed, C)


@pytest.mark.parametrize("kind", ["duplicated", "random"])
@pytest.mark.parametrize("C", [5, 64])
def test_knn_reference_equals_knn_pallas(C, kind):
    """The plain version of tier C against knn_pallas (interpret mode) at
    queries off the database (S < N) and at every point a query."""
    x = _features(kind, 2, 40, C, C)
    for S, k in ((13, 7), (40, 6)):
        q = x[:, :S]
        want = np.asarray(knn_pallas(jnp.asarray(q), jnp.asarray(x), k,
                                     interpret=True))
        got = kk.knn_reference(torch.from_numpy(q), torch.from_numpy(x), k)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_plan_picks_tier_c_past_three_channels():
    # one stage a tile while three tiles, the keys and the pending buffers
    # leave two blocks an SM: DGCNN's C = 64 at float32, C = 128 at bf16
    assert kk.plan(2048, 20, C=64) == kk.Plan(kk.CHANNELS, 64, 8, 87808)
    assert kk.plan(2048, 20, C=128, bf16=True) == kk.Plan(
        kk.CHANNELS, 128, 8, 87808)
    # past that, 64 channels a stage (queries staged too): C = 128 float32
    assert kk.plan(2048, 20, C=128) == kk.Plan(kk.CHANNELS, 64, 8, 105216)
    # xyz at bf16 keeps the bf16 roundings: tier C; float32 xyz the others
    assert kk.plan(2048, 20, C=3, bf16=True).tier == kk.CHANNELS
    assert kk.plan(2048, 20).tier == kk.SHARED
    for C in (1, 2, 4, 5, 6, 63, 64, 65, 127, 128, 129, 256, 1024, 8192):
        for bf16 in (False, True):
            how = kk.plan(100, 20, C=C, bf16=bf16)
            assert how.tier == kk.CHANNELS and how.warps == kk.CH_WARPS
            assert how.smem <= kk.MAX_SMEM == 232448
            assert how.smem == kk.channel_smem(C, how.points, bf16)
            assert how.points == C or how.points == kk.CH_STAGE
            if how.points == C:
                assert how.smem <= kk.CH_TWO_BLOCKS
            else:
                assert kk.channel_smem(C, C, bf16) > kk.CH_TWO_BLOCKS
    # rows padded to the k-step (8), then to an odd number of 4-element
    # groups
    assert [kk.channel_stride(w) for w in (1, 4, 5, 8, 64, 128)] == [
        12, 12, 12, 12, 68, 132]
    # a forced stage: C or a multiple of 16 below it
    assert kk.plan(100, 8, C=64, width=16).points == 16
    for kw in (dict(C=64, width=24), dict(C=64, width=80),
               dict(C=64, tier=kk.SHARED), dict(C=3, bf16=True,
                                                tier=kk.REG)):
        with pytest.raises(ValueError):
            kk.plan(100, 8, **kw)
    # the lists hold 64 entries a query
    assert kk.plan(100, 64, C=64).tier == kk.CHANNELS
    with pytest.raises(ValueError):
        kk.plan(100, 65, C=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_route_and_feature_space_bit_for_bit(dtype):
    """On CPU tensors the wrapper is its plain version and counts nothing;
    keep_dtype keeps bf16 distances, without it bf16 is cast to float32 as
    knn_pallas casts; knn_feature_space is the stable sort it was."""
    x = torch.from_numpy(_features("duplicated", 3, 50, 64, 1)).to(dtype)
    before = kk.knn.launches, dict(kk.knn.tier_launches)
    d = tgeo.square_distance(x, x)
    assert d.dtype == dtype
    sort = torch.sort(d, dim=-1, stable=True).indices[..., :9]
    assert torch.equal(kk.knn(x, x, 9, keep_dtype=True), sort)
    assert torch.equal(tgeo.knn_feature_space(x.transpose(1, 2), 9), sort)
    assert torch.equal(kk.knn(x, x, 9),
                       kk.knn_reference(x.float(), x.float(), 9))
    assert (kk.knn.launches, kk.knn.tier_launches) == before


# ---- the chunked EdgeConv against JAX's -------------------------------------

def _port_edgeconv(seed: int = 0):
    """(EdgeConv, its BatchNorm) in float64 with seeded weights and running
    statistics that are not the identity."""
    g = torch.Generator().manual_seed(seed)
    conv, bn = tdgcnn.EdgeConv(C_IN, F_OUT, K), BatchNorm(F_OUT)
    with torch.no_grad():
        conv[0].weight.copy_(torch.randn(F_OUT, 2 * C_IN, generator=g) / 3)
        bn.weight.copy_(torch.rand(F_OUT, generator=g) + 0.5)
        bn.bias.copy_(torch.rand(F_OUT, generator=g) - 0.5)
        bn.running_mean.copy_(torch.rand(F_OUT, generator=g) - 0.5)
        bn.running_var.copy_(torch.rand(F_OUT, generator=g) + 0.5)
    return conv.double(), bn.double()


def _inputs():
    """Crops of C_IN channels with duplicated points, and a cotangent."""
    rs = np.random.RandomState(3)
    base = rs.randn(B, N - DUPS, C_IN)
    x = np.concatenate([base, base[:, rs.randint(0, N - DUPS, DUPS)]], 1)
    return x, rs.randn(B, N, F_OUT)


def _jax_variables(conv, bn):
    return dict(
        params=dict(conv=dict(kernel=conv[0].weight.detach().numpy().T),
                    bn=dict(scale=bn.weight.detach().numpy(),
                            bias=bn.bias.detach().numpy())),
        batch_stats=dict(bn=dict(mean=bn.running_mean.numpy(),
                                 var=bn.running_var.numpy())))


@pytest.fixture(scope="module")
def jax_edgeconv():
    """JAX's EdgeConv in float64, train and eval: {train: (output, moved
    statistics, d input, d params)} for the seeded cotangent."""
    conv, bn = _port_edgeconv()
    x, cot = _inputs()
    with jax.enable_x64():
        variables = jax.tree_util.tree_map(jnp.asarray,
                                           _jax_variables(conv, bn))
        mod = JEdgeConv(F_OUT, K, dtype=jnp.float64)

        def run(train, x, params):
            if train:
                out, mut = mod.apply(
                    dict(params=params,
                         batch_stats=variables["batch_stats"]), x,
                    train=True, mutable=["batch_stats"])
                stats = mut["batch_stats"]
            else:
                out = mod.apply(dict(params=params,
                                     batch_stats=variables["batch_stats"]),
                                x, train=False)
                stats = variables["batch_stats"]
            return jnp.sum(out * cot), (out, stats)

        args = (jnp.asarray(x), variables["params"])
        fns = [jax.jit(jax.value_and_grad(functools.partial(run, train),
                                          argnums=(0, 1), has_aux=True))
               for train in (True, False)]
        compiled = compile_together(*[f.lower(*args) for f in fns])
        out = {}
        for train, fn in zip((True, False), compiled):
            (_, (y, stats)), (dx, dp) = fn(*args)
            out[train] = jax.tree_util.tree_map(np.asarray,
                                                (y, stats, dx, dp))
    return out


def _port_run(train: bool, monkeypatch, chunk_rows: int = CHUNK_ROWS):
    conv, bn = _port_edgeconv()
    x, cot = _inputs()
    monkeypatch.setattr(tdgcnn, "EDGE_CHUNK_BYTES", 4 * K * F_OUT * chunk_rows)
    xt = torch.from_numpy(x).requires_grad_()
    y = conv(xt, bn, train)
    y.backward(torch.from_numpy(cot))
    return conv, bn, xt, y


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_chunked_edgeconv_matches_jax(train, monkeypatch, jax_edgeconv):
    monkeypatch.setattr(tdgcnn, "EDGE_CHUNK_BYTES", 4 * K * F_OUT * CHUNK_ROWS)
    chunks = tdgcnn.edge_chunks(B * N, K, F_OUT)
    sizes = [r1 - r0 for r0, r1 in chunks]
    assert len(sizes) >= 3 and len(set(sizes)) > 1, sizes
    conv, bn, xt, y = _port_run(train, monkeypatch)
    want_y, want_stats, want_dx, want_dp = jax_edgeconv[train]
    assert_close_scaled(y.detach().numpy(), want_y, TRAIN64_TOL, "out")
    assert_close_scaled(bn.running_mean.numpy(), want_stats["bn"]["mean"],
                        TRAIN64_TOL, "running mean")
    assert_close_scaled(bn.running_var.numpy(), want_stats["bn"]["var"],
                        TRAIN64_TOL, "running var")
    for got, want, what in (
            (xt.grad, want_dx, "d input"),
            (conv[0].weight.grad.T, want_dp["conv"]["kernel"], "d weight"),
            (bn.weight.grad, want_dp["bn"]["scale"], "d gamma"),
            (bn.bias.grad, want_dp["bn"]["bias"], "d beta")):
        assert_close_scaled(got.numpy(), want, TRAIN64_TOL, what)


def test_chunked_edgeconv_gradients_against_finite_differences(monkeypatch):
    """_EdgeConvChunks' own backward in float64, three chunks, train mode
    (the statistics' gradient included), against torch.autograd.gradcheck."""
    monkeypatch.setattr(tdgcnn, "EDGE_CHUNK_BYTES", 4 * K * F_OUT * 7)
    conv, bn = _port_edgeconv(1)
    x, _ = _inputs()
    x = torch.from_numpy(x[:1, :20]).requires_grad_()
    idx = tgeo.knn_feature_space(x.detach().transpose(1, 2), K)
    gidx = idx.reshape(-1, K)
    w = conv[0].weight.detach().clone().requires_grad_()
    gamma = bn.weight.detach().clone().requires_grad_()
    beta = bn.bias.detach().clone().requires_grad_()

    def fn(x, w, gamma, beta):
        return tdgcnn._EdgeConvChunks.apply(
            x, w, gamma, beta, gidx, True, None, None, 1e-5,
            bn.running_mean, bn.running_var)[0]
    assert len(tdgcnn.edge_chunks(20, K, F_OUT)) == 3
    assert torch.autograd.gradcheck(fn, (x, w, gamma, beta))


def test_data_parallel_route_equals_plain(monkeypatch, tmp_path):
    """In a data-parallel step of one gloo rank the statistics go through
    global_sum as (sums, sums of squares, count), the backward's S and T
    through one all-reduce: the same outputs, statistics and gradients as
    the plain route, float64."""
    import torch.distributed as dist
    from point_cloud_reid_tpu_torch.parallel.distributed import data_parallel
    plain = _port_run(True, monkeypatch)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with data_parallel():
            dp = _port_run(True, monkeypatch)
    finally:
        dist.destroy_process_group()
    conv, bn, xt, y = plain
    conv_d, bn_d, xt_d, y_d = dp
    for got, want, what in (
            (y_d, y, "out"), (xt_d.grad, xt.grad, "d input"),
            (conv_d[0].weight.grad, conv[0].weight.grad, "d weight"),
            (bn_d.weight.grad, bn.weight.grad, "d gamma"),
            (bn_d.bias.grad, bn.bias.grad, "d beta"),
            (bn_d.running_mean, bn.running_mean, "running mean"),
            (bn_d.running_var, bn.running_var, "running var")):
        assert_close_scaled(got.detach().numpy(), want.detach().numpy(),
                            TRAIN64_TOL, what)


# ---- the DGCNN leaf's train step --------------------------------------------

# 6,144 bytes a centre row in block 4 (k = 6 x 256 x 4): 37 rows a chunk
# give every block of the 256 centre rows (4 pairs of 32-point crops) two
# to seven uneven chunks
LEAF_CHUNK_BYTES = 6144 * 37


def test_chunked_dgcnn_step_matches_jax(monkeypatch):
    monkeypatch.setattr(tdgcnn, "EDGE_CHUNK_BYTES", LEAF_CHUNK_BYTES)
    assert len(tdgcnn.edge_chunks(256, 6, 256)) == 7
    assert len(tdgcnn.edge_chunks(256, 6, 64)) == 2
    check_leaf_step(leaf_cfg(DGCNN))


def test_chunked_dgcnn_step_equals_unchunked(monkeypatch):
    """The port's step with chunks forced, plain and --remat, against its
    step with every block in one chunk, float64."""
    from point_cloud_reid_tpu_torch.models import build_model
    tmodel = build_model(leaf_cfg(DGCNN),
                         generator=torch.Generator().manual_seed(2))
    batch = pair_batch(33, B=4)
    neg = torch.from_numpy(np.random.RandomState(1).randint(0, 8, (4, 5)))
    want, want_w = port_step(tmodel, batch, torch.float64, neg)
    monkeypatch.setattr(tdgcnn, "EDGE_CHUNK_BYTES", LEAF_CHUNK_BYTES)
    for remat in (False, True):
        got, got_w = port_step(tmodel, batch, torch.float64, neg,
                               remat=remat)
        for k, w in want.items():
            assert abs(got[k] - w) <= TRAIN64_TOL * max(1.0, abs(w)), (
                remat, k, got[k], w)
        for k, w in want_w.items():
            assert_close_scaled(got_w[k], w, LEAF_STEP64_TOL, k)
