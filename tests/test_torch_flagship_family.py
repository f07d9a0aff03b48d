"""The rest of the point-transformer family in the port, against the JAX
package: the 53 leaves' configs, the kNN and match-chain plain versions at
the shapes the family gives them (any cloud size; C = 128; more than 224
rows), the scaled 1.5M / 7M models through the converter, a PairScorer cost
matrix, the kernel wrappers' tier plans, and tools/track.py serving a
scaled leaf and a point-count ablation at its crop size."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.configs import experiments as jexp  # noqa: E402
from point_cloud_reid_tpu.configs import models as jmodels  # noqa: E402
from point_cloud_reid_tpu.inference import PairScorer as JaxScorer  # noqa: E402
from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu.ops import geometry as jgeo  # noqa: E402
from point_cloud_reid_tpu.ops.pallas import match_grid as jmg  # noqa: E402
from point_cloud_reid_tpu.ops.pallas.knn import knn_pallas  # noqa: E402
from point_cloud_reid_tpu_torch import configs as tcfg  # noqa: E402
from point_cloud_reid_tpu_torch.convert import to_jax_variables  # noqa: E402
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import knn as kk  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as tmg  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.ops import geometry as tgeo  # noqa: E402
from point_cloud_reid_tpu_torch.tools import track  # noqa: E402
from point_cloud_reid_tpu_torch.tools.scenes import knn_cloud  # noqa: E402
from tests._torch_port import TINY, crops, jax_uniform_crops  # noqa: E402
from tests.test_torch_track_cli import (HEADLINE, TINY_SET,  # noqa: E402
                                        _jax_cli, _write_scenes)
from tests._torch_threads import few_threads  # noqa: E402,F401

# the JAX suite's bars: the full model through a converter
# (tests/test_convert_full_model.py), the grid and pair chains against
# the XLA path (tests/test_pair_grid.py)
MODEL_TOL = 1e-3
GRID_RTOL, GRID_ATOL = 2e-4, 2e-5


def _family_leaves() -> list:
    """The 53 point-transformer leaves the port adds, as the JAX registry
    names them (configs/experiments.py:139-212)."""
    out = []
    for ds, e in (("nus", 500), ("waymo", 400)):
        flagship = f"pts_point-transformer_point-cat_{ds}_det_4x256_{e}e"
        out += [f"{flagship}_accum{a}" for a in (2, 4, 8)]
        out += [f"{flagship}_{n}pts"
                for n in (160, 192, 224, 256, 512, 1024, 2048)]
        for size in ("1.5M", "7M"):
            base = f"pts_point-transformer-{size}_point-cat_{ds}_det_4x256_{e}e"
            out += [base, "testing_" + base]
            out += [f"{base}_accum{a}" for a in (2, 4, 8)]
    out += [f"pts_point-transformer_point-cat_{n}pts_nus_det_4x256_500e"
            for n in (256, 512)]
    out += [f"pts_point-transformer_point-cat_waymo_{n}pts"
            for n in (160, 256, 512, 1024, 2048)]
    out += [f"scaling_pts_point-transformer_point-cat_waymo_det_4x256_{e}e"
            for e in (800, 1600, 3200)]
    out += [f"scaling_pts_point-transformer_point-cat_nus_det_4x256_{e}e"
            for e in (1000, 2000, 4000)]
    return out


LEAVES = _family_leaves()


def test_the_family_is_53_leaves_of_both_registries():
    assert len(LEAVES) == len(set(LEAVES)) == 53
    assert set(LEAVES) <= set(jexp.EXPERIMENTS)
    assert set(LEAVES) <= set(tcfg.EXPERIMENTS)
    # no other point-transformer leaf of the JAX registry is missing
    family = {n for n in jexp.EXPERIMENTS
              if "point-transformer" in n and "baseline" not in n}
    assert family <= set(tcfg.EXPERIMENTS)


@pytest.mark.parametrize("name", LEAVES)
def test_leaf_config_matches_jax(name):
    t, j = tcfg.get_experiment(name), jexp.get_experiment(name)
    assert t["model"] == j["model"]
    assert dataclasses.asdict(t["schedule"]) == dataclasses.asdict(
        j["schedule"])
    assert t["losses_to_use"] == j["losses_to_use"]
    assert t["alpha"] == j["alpha"]
    assert t["runtime"] == j["runtime"]
    for k in ("cls_to_idx", "num_classes", "fp_label_threshold",
              "samples_per_device"):
        assert t["dataset"][k] == j["dataset"][k], k
    for split in ("train", "val"):
        assert t["dataset"][split] == j["dataset"][split], split
    assert t["dataset"]["subsample_sparse"] == j["dataset"]["train"][
        "subsample_sparse"]


# ---- kNN at any cloud size --------------------------------------------------

@pytest.mark.parametrize("kind", ["exact", "duplicates"])
@pytest.mark.parametrize("N,k", [(129, 32), (129, 48), (129, 129),
                                 (160, 32), (160, 48), (160, 160),
                                 (256, 32), (256, 48), (256, 256),
                                 (2048, 32), (2048, 48), (2048, 2048)])
def test_knn_pallas_plain_equals_jax_at_any_cloud_size(N, k, kind):
    """knn_indices(..., "pallas") on the CPU (the kernel's plain version)
    against JAX's argsort path and knn_pallas in interpret mode: the same
    indices in the same order. knn_pallas unrolls k argmin passes, so k = N
    at 2048 points is held against the argsort path alone."""
    xyz = knn_cloud(kind, 2, N, seed=N + k)
    q = xyz[:, :16]
    got = tgeo.knn_indices(k, torch.from_numpy(xyz), torch.from_numpy(q),
                           "pallas")
    assert got.dtype == torch.int64 and got.shape == (2, 16, k)
    want = np.asarray(jgeo.knn_indices(k, jnp.asarray(xyz), jnp.asarray(q),
                                       "argsort"))
    np.testing.assert_array_equal(got.numpy(), want)
    if (N, k) != (2048, 2048):
        np.testing.assert_array_equal(got.numpy(), np.asarray(knn_pallas(
            jnp.asarray(q), jnp.asarray(xyz), k, interpret=True)))


def test_knn_plan_picks_a_tier_for_every_cloud():
    assert kk.plan(1, 1) == kk.Plan(kk.REG, 2, 8, 16)
    assert kk.plan(64, 32) == kk.Plan(kk.REG, 2, 8, 1024)
    assert kk.plan(128, 128) == kk.Plan(kk.REG, 4, 8, 2048)
    assert kk.plan(129, 32) == kk.Plan(kk.SHARED, 0, 16, 2064)
    assert kk.plan(2048, 48) == kk.Plan(kk.SHARED, 0, 16, 32768)
    # 16 bytes a point fill a block's 227 KB at 14,528 points
    assert kk.plan(14528, 32) == kk.Plan(kk.SHARED, 0, 16, 232448)
    assert kk.plan(14529, 32) == kk.Plan(kk.GLOBAL, 0, 16, 0)
    assert kk.plan(20000, 32).tier == kk.GLOBAL
    # a forced tier, as the CUDA tests ask for each
    assert kk.plan(100, 8, kk.SHARED) == kk.Plan(kk.SHARED, 0, 16, 1600)
    assert kk.plan(100, 8, kk.GLOBAL) == kk.Plan(kk.GLOBAL, 0, 16, 0)
    for N, k, tier in ((129, 8, kk.REG), (20000, 8, kk.SHARED),
                       (10, 11, None), (10, 0, None), (10, 4, 7)):
        with pytest.raises(ValueError):
            kk.plan(N, k, tier)


def test_knn_wrapper_takes_large_clouds_on_the_cpu():
    xyz = torch.from_numpy(knn_cloud("duplicates", 2, 300, 0))
    before = (kk.knn.launches, dict(kk.knn.tier_launches))
    got = kk.knn(xyz[:, :10], xyz, 40)
    assert torch.equal(got, kk.knn_reference(xyz[:, :10], xyz, 40))
    assert (kk.knn.launches, kk.knn.tier_launches) == before


# ---- the match chain at C = 128 and past 224 rows ---------------------------

def _side(rs, n: int, N: int, C: int, nhead: int) -> tuple:
    """Seeded per-object factors (h, q, kvz, a1, pv) as grid_factors shapes
    them: q elu+1-positive, [KV | Z] block-diagonal per head."""
    D = C // nhead
    h = rs.randn(n, N, C).astype(np.float32)
    q = np.exp(np.minimum(rs.randn(n, N, C), 0)).astype(np.float32)
    k = np.exp(np.minimum(rs.randn(n, N, C), 0)).astype(np.float32)
    v = rs.randn(n, N, C).astype(np.float32)
    heads = np.arange(C) // D
    mask = (heads[:, None] == heads[None, :]).astype(np.float32)
    kv = np.einsum("bnc,bnd->bcd", k, v) * mask / N
    z = k.sum(1)[:, :, None] * mask[None] / N
    kvz = np.concatenate([kv, z], -1).astype(np.float32)
    a1 = (rs.randn(n, N, 2 * C) / np.sqrt(C)).astype(np.float32)
    pv = (0.1 * rs.randn(n, N, C)).astype(np.float32)
    return h, q, kvz, a1, pv


def _weights(rs, C: int) -> tuple:
    def mat(a, b):
        return (rs.randn(a, b) / np.sqrt(a)).astype(np.float32)

    def tail():
        return dict(merge=mat(C, C), fc1=mat(2 * C, 2 * C), fc2=mat(2 * C, C),
                    ln1_scale=(1 + 0.1 * rs.randn(C)).astype(np.float32),
                    ln1_bias=(0.1 * rs.randn(C)).astype(np.float32),
                    ln2_scale=(1 + 0.1 * rs.randn(C)).astype(np.float32),
                    ln2_bias=(0.1 * rs.randn(C)).astype(np.float32))
    w1, w2 = tail(), tail()
    w2.update(q=mat(C, C), kv=mat(C, 2 * C))
    return w1, w2


@pytest.mark.parametrize("nt,nd,N,C", [(2, 3, 16, 128), (2, 2, 232, 64)])
def test_match_chain_plain_matches_pallas(nt, nd, N, C):
    """The port's grid and pair chains (their plain versions on the CPU)
    against fused_match_grid / fused_match_pairs in interpret mode, at the
    1.5M / 7M models' width and past the cluster tier's 224 rows at C = 64,
    both of which the card scores in the rows tier."""
    nhead = 2
    rs = np.random.RandomState(N)
    t, d = _side(rs, nt, N, C, nhead), _side(rs, nd, N, C, nhead)
    w1, w2 = _weights(rs, C)
    assert tmg.plan(N, C, nhead).tier == tmg.ROWS
    jw1 = {k: jnp.asarray(v) for k, v in w1.items()}
    jw2 = {k: jnp.asarray(v) for k, v in w2.items()}
    want = np.asarray(jmg.fused_match_grid(
        *map(jnp.asarray, t), *map(jnp.asarray, d), jw1, jw2, nhead,
        det_block=nd, interpret=True))
    tt = tuple(map(torch.from_numpy, t))
    td = tuple(map(torch.from_numpy, d))
    tw1 = {k: torch.from_numpy(v) for k, v in w1.items()}
    tw2 = {k: torch.from_numpy(v) for k, v in w2.items()}
    got = tmg.fused_match_grid(tt, td, tw1, tw2, nhead)
    assert got.shape == (nt, nd, 2 * C)
    np.testing.assert_allclose(got.numpy(), want, rtol=GRID_RTOL,
                               atol=GRID_ATOL)
    t_idx = np.array([1, 0, 1, 0], np.int32)
    d_idx = np.array([nd - 1, 1, 0, 0], np.int32)
    jpairs = np.asarray(jmg.fused_match_pairs(
        *(jnp.asarray(x[t_idx]) for x in t),
        *(jnp.asarray(x[d_idx]) for x in d), jw1, jw2, nhead, pair_block=4,
        interpret=True))
    pairs = tmg.fused_match_pairs(tt, td, tw1, tw2, nhead,
                                  torch.from_numpy(t_idx),
                                  torch.from_numpy(d_idx))
    np.testing.assert_allclose(pairs.numpy(), jpairs, rtol=GRID_RTOL,
                               atol=GRID_ATOL)
    np.testing.assert_allclose(pairs.numpy(), got.numpy()[t_idx, d_idx],
                               rtol=GRID_RTOL, atol=GRID_ATOL)


def test_match_plan_picks_the_tier():
    # the cluster tier where its layout fits (the bytes of PR 4's layout)
    for N, C, smem in ((128, 64, 203520), (198, 64, 225280),
                       (224, 64, 229632), (128, 16, 42176),
                       (2048, 16, 195776)):
        assert tmg.plan(N, C, 2) == tmg.Plan(tmg.CLUSTER, smem)
        assert tmg.plan(N, C, 2, pos=False) == tmg.Plan(tmg.CLUSTER, smem)
    assert tmg.cluster_bytes(225, 64) == 233984 > tmg.MAX_SMEM
    # the rows tier for the rest of the point head: one layout a width, the
    # wgmma tier's at C = 64 / 128 (normalisers of 8 heads at 2 heads), the
    # first rows kernel's at C = 16
    for N, C, smem in ((225, 64, 224920), (2048, 64, 224920),
                       (1, 128, 231512), (128, 128, 231512),
                       (197, 128, 231512)):
        assert tmg.plan(N, C, 2) == tmg.Plan(tmg.ROWS, smem)
    for N in (2600, 20000):
        assert tmg.plan(N, 16, 2) == tmg.Plan(tmg.ROWS_MMA, 42048)
    assert tmg.plan(128, 128, 8).tier == tmg.ROWS
    # widths the tiles have no instantiation for, in the padded layout of
    # the smallest width that holds them, and the image head past the
    # cluster tier, on the rows tier
    for args, want in (((10, 12, 2), (tmg.CLUSTER, tmg.cluster_bytes(10, 16))),
                       ((128, 32, 2), (tmg.CLUSTER, 203520)),
                       ((128, 128, 2, False), (tmg.ROWS, 219208)),
                       ((260, 64, 2, False), (tmg.ROWS, 229016))):
        assert tmg.plan(*args) == tmg.Plan(*want)
    # what still raises: past 1024 channels, more heads than the rows tier
    # holds, bad shapes
    for args, match in (((128, 1032, 2), "K7"),
                        ((225, 64, 32), "at most 16 heads"),
                        ((0, 64, 2), "N >= 1"), ((128, 64, 3), "dividing")):
        with pytest.raises(ValueError, match=match):
            tmg.plan(*args)


# ---- the scaled models ------------------------------------------------------

@pytest.fixture(scope="module", params=["1.5M", "7M"])
def scaled(request):
    """(size, jax model, jax variables, torch model) of a scaled model at
    full width, seeded weights shared through the converter."""
    size = request.param
    tmodel = build_model(tcfg.point_transformer_scaled(size),
                         generator=torch.Generator().manual_seed(3))
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tmodel))
    return size, jax_build(jmodels.point_transformer_scaled(size)), jvars, \
        tmodel


def test_scaled_config_matches_jax():
    for size in ("1.5M", "7M"):
        assert (tcfg.point_transformer_scaled(size)
                == jmodels.point_transformer_scaled(size))


def test_scaled_variables_carry_across_both_ways(scaled):
    """The converter takes the scaled widths as the flagship's: the flax
    tree of one port model, read into a model of other weights, gives back
    every tensor (from_jax_variables is strict)."""
    from point_cloud_reid_tpu_torch.convert import from_jax_variables
    size, _, jvars, tmodel = scaled
    fresh = build_model(tcfg.point_transformer_scaled(size),
                        generator=torch.Generator().manual_seed(9))
    from_jax_variables(fresh, jax.tree_util.tree_map(np.asarray, jvars))
    want = tmodel.state_dict()
    got = fresh.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want
               if not k.endswith("num_batches_tracked"))


def test_scaled_model_logits_match_jax(scaled):
    """Embeddings and pair logits of 2 pairs of 32-point crops, the port
    against model.apply, to the converter bar."""
    size, jmodel, jvars, tmodel = scaled
    a, b = crops(40, 2), crops(41, 2)
    with torch.no_grad():
        xa, ha = tmodel.embed(torch.from_numpy(a))
        xb, hb = tmodel.embed(torch.from_numpy(b))
        logits, _ = tmodel.match_logits(ha, xa, hb, xb)
    assert ha.shape == (2, 32, 128)
    jx, jh = jmodel.apply(jvars, jnp.asarray(a), train=False, method="embed")
    np.testing.assert_allclose(ha.numpy(), np.asarray(jh), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    jl, _ = jmodel.apply(jvars, *(jnp.asarray(x.numpy())
                                  for x in (ha, xa, hb, xb)),
                         train=False, method="match_logits")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def test_scaled_pair_scorer_cost_matrix_matches_jax(scaled):
    """A gated cost matrix of the scaled model (the grid chain at C = 128):
    -inf exactly where the classes differ, the model bar elsewhere."""
    size, jmodel, jvars, tmodel = scaled
    if size != "1.5M":
        pytest.skip("the 1.5M model's scorer stands for both widths")
    with torch.no_grad():
        xt, ht = tmodel.embed(torch.from_numpy(crops(42, 3)))
        xd, hd = tmodel.embed(torch.from_numpy(crops(43, 4)))
        got = PairScorer(tmodel).cost_matrix(ht, xt, hd, xd,
                                             np.array([0, 1, 0]),
                                             np.array([0, 0, 1, 0]))
    want = np.asarray(JaxScorer(jmodel, jvars).cost_matrix(
        *(jnp.asarray(x.numpy()) for x in (ht, xt, hd, xd)),
        np.array([0, 1, 0]), np.array([0, 0, 1, 0])))
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=MODEL_TOL,
                               atol=MODEL_TOL)


# ---- tools/track.py ---------------------------------------------------------

@pytest.mark.parametrize("leaf,subsample,tiny", [
    ("pts_point-transformer-1.5M_point-cat_nus_det_4x256_500e", 32, False),
    ("pts_point-transformer_point-cat_nus_det_4x256_500e_256pts", 256, True)])
def test_track_cli_serves_the_family_as_jax(tmp_path, monkeypatch, capsys,
                                            leaf, subsample, tiny):
    """The port's CLI with a scaled leaf (full width) and with a point-count
    ablation at its own crop size (--subsample 256, tiny widths), against
    the JAX manager driven with the same frames, weights and crop draws."""
    from point_cloud_reid_tpu_torch.train import (ScheduleConfig, Trainer,
                                                  TrainState)
    jax_uniform_crops(monkeypatch)
    scenes, work = tmp_path / "scenes", tmp_path / "out"
    scenes.mkdir()
    _write_scenes(str(scenes), n_scenes=1, n_frames=3)
    sets = TINY_SET if tiny else []
    cfg = tcfg.get_experiment(leaf, set_options=sets)["model"]
    model = build_model(cfg, generator=torch.Generator().manual_seed(5))
    ckpt = Trainer(model, None, None, dict(work_dir=str(tmp_path))
                   ).save_checkpoint(TrainState.create(
                       model, ScheduleConfig(max_epochs=1), 1), tag="best")
    track.main([leaf, "--checkpoint", ckpt, "--scene-dir", str(scenes),
                "--subsample", str(subsample), "--match-threshold", "1.0",
                "--method", "hungarian", "--nms-threshold", "0.5",
                "--sparse", "auto", "--work-dir", str(work),
                "--device", "cpu"] + sum([["--set", s] for s in sets], []))
    headline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(headline) == HEADLINE
    assert headline["experiment"] == leaf and headline["frames"] == 3
    rows = [json.loads(line) for line in open(work / "tracks.jsonl")]
    summary = json.load(open(work / "tracking_summary.json"))
    jcfg = (jmodels.point_transformer_point_cat(**TINY) if tiny
            else jexp.get_experiment(leaf)["model"])
    want_rows, want_summary = _jax_cli(
        str(scenes), model, monkeypatch, jax_cfg=jcfg, subsample=subsample)
    assert rows == want_rows
    assert summary == want_summary
    assert [len(r["tracks"]) for r in rows] == [4, 4, 3]
    assert os.path.exists(work / "tracking_summary.json")
