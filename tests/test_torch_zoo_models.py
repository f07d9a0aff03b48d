"""The tracker-era zoo's attention heads as whole models against the JAX
package: the 'xcorr' head with its local self-attention stages (plain and
on the linear-attention kernel's plain version), ReIDNetCosine and the
LoFTR cross stages (softmax and linear), each built by both packages from
the same --set strings (tests/_torch_zoo.py); the converter both ways on
each; the grid against pairwise scoring; and the chunked scoring of
materialised pairs.

Tolerances, relative to max(1, max |JAX|):
  float32 models: embed, forward, grid and pair list at 1e-4;
  the xcorr head in float64 on both sides at 1e-9: its local stages pick
    neighbours by the expanded-form distance of features whose norms are
    large against their distances, and in float32 that rounding decides
    some picks in either package (test_xcorr_float32_picks_differ_only_
    within_rounding measures how close those calls are); with
    'linear-pallas' at 1e-6, since JAX's kernel computes in float32 at
    any input dtype (ops/pallas/linear_attention.py:55-60) and the port's
    plain version in the inputs' dtype;
  the grid against pairwise match_logits, and chunked pairs against one
    batch: 1e-6 (the same function on other row batches);
  the converter's round trip: bit for bit.
"""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models import attention_blocks as jab  # noqa: E402
from point_cloud_reid_tpu_torch.convert import (from_jax_variables,  # noqa: E402
                                                to_jax_variables)
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.models import attention_blocks as tab  # noqa: E402
from point_cloud_reid_tpu_torch.models import reid_net  # noqa: E402
from tests._torch_port import (assert_close_scaled, pair_batch,  # noqa: E402
                               torch_batch)
from tests._torch_zoo import (D_IDX, N_PTS, T_IDX, dup_crops,  # noqa: E402
                              zoo_cfgs, zoo_models)
from tests._torch_threads import few_threads  # noqa: E402,F401

MODEL_TOL = 1e-4
F64_TOL = 1e-9
F64_KERNEL_TOL = 1e-6
SAME_TOL = 1e-6
HEADS = ["xcorr", "xcorr-pallas", "cosine", "loftr", "loftr-linear"]


def _jax_outputs(jmodel, jvars, x, batch):
    """JAX's embed, grid of 3 x 5 crops and full forward, in one jit."""
    @jax.jit
    def run(variables, x, batch):
        xyz, h = jmodel.apply(variables, x, train=False, method="embed")
        grid = jmodel.apply(variables, h[:3], xyz[:3], h, xyz,
                            method="match_logits_grid")
        return h, grid, jmodel.apply(variables, batch, train=False)
    return jax.tree_util.tree_map(np.asarray, run(jvars, x, batch))


def _port_outputs(tmodel, x, batch):
    with torch.no_grad():
        xyz, h = tmodel.embed(x)
        grid = mg.grid_logits(tmodel, h[:3], xyz[:3], h, xyz)
        pairs = mg.pair_logits(tmodel, h[:3], xyz[:3], h, xyz,
                               torch.from_numpy(T_IDX),
                               torch.from_numpy(D_IDX))
        return h, grid, pairs, tmodel(batch)


@pytest.mark.parametrize("name", HEADS)
def test_zoo_head_matches_jax(name):
    """The embed, the tracker's grid and pair-list entries (the gate sends
    these heads to the model's own scoring) and the forward (match logits,
    no aux head) against JAX's embed, match_logits_grid and __call__."""
    f64 = name.startswith("xcorr")
    dt, tol = (np.float64, F64_TOL) if f64 else (np.float32, MODEL_TOL)
    if name == "xcorr-pallas":
        tol = F64_KERNEL_TOL
    x = dup_crops(1).astype(dt)
    batch = {k: v for k, v in pair_batch(2, B=3).items()
             if k in ("sparse_1", "sparse_2", "id_1", "id_2")}
    batch = {k: v.astype(dt) if v.dtype.kind == "f" else v
             for k, v in batch.items()}
    with jax.enable_x64(f64):
        jmodel, jvars, tmodel = zoo_models(name, "float64" if f64
                                           else "float32")
        jh, jgrid, jout = _jax_outputs(jmodel, jvars, jnp.asarray(x),
                                       {k: jnp.asarray(v)
                                        for k, v in batch.items()})
    assert not mg.fused_head_ok(tmodel)
    th, tgrid, tpairs, tout = _port_outputs(
        tmodel, torch.from_numpy(x), torch_batch(batch))
    assert_close_scaled(th.numpy(), jh, tol, "embed")
    assert_close_scaled(tgrid.numpy(), jgrid, tol, "grid")
    assert_close_scaled(tpairs.numpy(), jgrid[T_IDX, D_IDX], tol, "pairs")
    assert set(tout) == set(jout)
    for k in jout:
        assert_close_scaled(tout[k].numpy(), jout[k], tol, k)


@pytest.mark.parametrize("name", ["xcorr", "cosine", "loftr-linear"])
def test_converter_round_trip_of_jax_init(name):
    """A JAX init of the whole model (random values on its own tree:
    LoFTR's layers, the local stages' *_knn names, ReIDNetCosine's tree
    without match stages or head) -> from_jax_variables ->
    to_jax_variables gives the same tree, leaf for leaf and bit for bit."""
    jmodel, _, tmodel = zoo_models(name)
    batch = {k: jnp.zeros((2, N_PTS, 3)) for k in ("sparse_1", "sparse_2")}
    shapes = jax.eval_shape(lambda k: jmodel.init(k, batch, train=False),
                            jax.random.PRNGKey(0))
    rs = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: rs.randn(*s.shape).astype(np.float32),
        {c: shapes[c] for c in ("params", "batch_stats")})
    back = to_jax_variables(from_jax_variables(copy.deepcopy(tmodel),
                                               variables))
    flat_in = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_out)
    params = variables["params"]
    if name == "cosine":
        assert not {"match_head", "cross_stage1"} & set(params)
    else:
        assert "match_head" in params
    for path, value in flat_in:
        np.testing.assert_array_equal(flat_out[path], value,
                                      err_msg=str(path))


@pytest.mark.parametrize("name", ["xcorr", "cosine"])
def test_grid_equals_pairwise_scoring(name):
    """match_logits_grid (chunked materialised pairs for xcorr, one matmul
    for ReIDNetCosine) equals match_logits over every pair."""
    _, _, tmodel = zoo_models(name)
    with torch.no_grad():
        xyz, h = tmodel.embed(torch.from_numpy(dup_crops(3, B=4)))
        grid = tmodel.match_logits_grid(h[:3], xyz[:3], h, xyz)
        ti = torch.arange(3).repeat_interleave(4)
        di = torch.arange(4).repeat(3)
        want = tmodel.match_logits(h[ti], xyz[ti], h[di], xyz[di])[0]
    assert grid.shape == (3, 4)
    assert_close_scaled(grid.reshape(-1).numpy(), want.numpy(), SAME_TOL,
                        name)


@pytest.mark.parametrize("name", ["xcorr", "loftr"])
def test_chunked_pairs_equal_one_batch(name, monkeypatch):
    """match_logits_pairs and the grid in chunks (as pair_chunk sizes them
    under a smaller budget) give one batch's logits; the chunk size follows
    the pair count and the head's widths."""
    _, _, tmodel = zoo_models(name)
    with torch.no_grad():
        xyz, h = tmodel.embed(torch.from_numpy(dup_crops(4, B=4)))
        ti = torch.arange(4).repeat_interleave(4)
        di = torch.arange(4).repeat(4)
        one = tmodel.match_logits(h[ti], xyz[ti], h[di], xyz[di])[0]
        assert tmodel.pair_chunk(16, h) == 16
        per_pair = reid_net.PAIR_CHUNK_BYTES // tmodel.pair_chunk(10 ** 6, h)
        for budget, chunk in ((5, 4), (3, 3)):
            monkeypatch.setattr(reid_net, "PAIR_CHUNK_BYTES",
                                budget * per_pair)
            # 16 pairs in equal chunks: 4 of 4, then 6 of at most 3
            assert tmodel.pair_chunk(16, h) == chunk
            pairs = tmodel.match_logits_pairs(h, xyz, h, xyz, ti, di)
            grid = tmodel.match_logits_grid(h, xyz, h, xyz)
            assert_close_scaled(pairs.numpy(), one.numpy(), SAME_TOL,
                                f"pairs, budget {budget}")
            assert_close_scaled(grid.reshape(-1).numpy(), one.numpy(),
                                SAME_TOL, f"grid, budget {budget}")


def test_xcorr_float32_picks_differ_only_within_rounding(monkeypatch):
    """In float32 the local stages' kNN picks of the two packages may
    differ where two candidates' distances lie within the expanded form's
    rounding: each pick the port makes that JAX does not (on the same
    inputs, recorded from JAX's eager run) is, by the float64 distance, no
    farther than JAX's own k-th neighbour plus 64 float32 ulps of the
    squared norms the form subtracts."""
    jmodel, jvars, tmodel = zoo_models("xcorr")
    x = dup_crops(5, B=4)
    with torch.no_grad():
        xyz, h = tmodel.embed(torch.from_numpy(x))
    ti = torch.arange(4).repeat_interleave(4)
    di = torch.arange(4).repeat(4)
    seen = {"jax": [], "port": []}
    jreal, treal = jab.knn_feature_space, tab.knn_feature_space

    def jrec(f, k, *a, **kw):
        idx = jreal(f, k, *a, **kw)
        seen["jax"].append(np.asarray(idx))
        return idx

    def trec(f, k):
        idx = treal(f, k)
        seen["port"].append((idx.numpy(), f.double().numpy()))
        return idx
    monkeypatch.setattr(jab, "knn_feature_space", jrec)
    monkeypatch.setattr(tab, "knn_feature_space", trec)
    args = [a[i].numpy() for a, i in ((h, ti), (xyz, ti), (h, di),
                                      (xyz, di))]
    jmodel.apply(jvars, *map(jnp.asarray, args), train=False,
                 method="match_logits")
    with torch.no_grad():
        tmodel.match_logits(*map(torch.from_numpy, args))
    assert len(seen["jax"]) == len(seen["port"]) == 2
    for jidx, (tidx, feats) in zip(seen["jax"], seen["port"]):
        f = feats.transpose(0, 2, 1)                         # (B, N, C)
        d = ((f[:, :, None] - f[:, None]) ** 2).sum(-1)      # float64
        norms = (f ** 2).sum(-1)
        ulp = np.finfo(np.float32).eps * (norms[:, :, None]
                                          + norms[:, None])
        kth = np.take_along_axis(d, jidx.astype(np.int64), -1).max(-1)
        for b, n in zip(*np.nonzero((np.sort(jidx, -1)
                                     != np.sort(tidx, -1)).any(-1))):
            extra = np.setdiff1d(tidx[b, n], jidx[b, n])
            assert (d[b, n, extra] <= kth[b, n]
                    + 64 * ulp[b, n, extra]).all(), (b, n)
