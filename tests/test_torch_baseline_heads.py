"""The baseline match heads ('concat' and 'xcorr-baseline') against the JAX
package, the gate that sends heads to the fused match kernels, and the
registry.

  - the port's EXPERIMENTS is the JAX package's (148 leaves), each leaf's
    dict equal to JAX's, and every model of the registry builds on the CPU;
  - concat and xcorr-baseline match_logits and the pairing fallback of
    match_logits_grid (and grid_logits / pair_logits, which the gate sends
    there) against JAX's on the same weights and embeddings;
  - kernels.match_grid.fused_head_ok against the JAX scorer's
    _pallas_grid_ok(model, image_mode, interpret=True) for a leaf of each
    family, and the tracker scoring the baselines without the kernel chain
    (its wrappers made to raise) and PointNet through it;
  - one train step of a concat leaf (tests/_torch_port.check_leaf_step).

Tolerances: logits within 1e-5 of JAX's relative to max(1, max |JAX|)
(float32, the same operations); a frame's logits equal to match_logits on
its pairs within 1e-6 of the same scale (the same function on the same
rows; the row batch differs).
"""
import copy
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.configs import experiments as jexp  # noqa: E402
from point_cloud_reid_tpu.inference.pair_scoring import (  # noqa: E402
    _pallas_grid_ok)
from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu_torch import configs as tcfg  # noqa: E402
from point_cloud_reid_tpu_torch.convert import to_jax_variables  # noqa: E402
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.tools.scenes import bench_scene  # noqa: E402
from point_cloud_reid_tpu_torch.tracking import TrackingManager  # noqa: E402
from tests._torch_port import assert_close_scaled, check_leaf_step  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

CONCAT = "pts_point-transformer_baseline_nus_det_4x256_500e"
STNET = "pts_point-transformer_baseline-stnet_nus_det_4x256_500e"
POINTNET = "pts_pointnet_point-cat_nus_det_4x256_500e"
DGCNN = "pts_dgcnn_point-cat_nus_det_4x256_500e"
FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
IMAGE = "rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"
JAX_TOL = 1e-5
SAME_TOL = 1e-6
# the baselines' point-transformer backbone at test size (the heads keep
# their widths: the concat head is 4 x 64 wide)
TINY_BACKBONE = dict(mul=1, nsample=[8, 8, 8])
CROP = 32


def tiny_cfg(name: str) -> dict:
    cfg = tcfg.get_experiment(name)["model"]
    if cfg["backbone"]["type"] == "Pointnet_Backbone":
        cfg["backbone"].update(TINY_BACKBONE)
        cfg["backbone_list"] = [16, 8, 4]
    elif cfg["backbone"]["type"] == "dgcnn":
        cfg["backbone"].update(emb_dims=64, k=6)
    return cfg


# ---- the registry -----------------------------------------------------------

def test_registry_equals_jax():
    """Every leaf's dict is JAX's. The port's dataset dict carries the
    train spec's subsample_sparse at its top level besides the JAX keys
    (configs/datasets.py): it is checked and set aside."""
    assert set(tcfg.EXPERIMENTS) == set(jexp.EXPERIMENTS)
    assert len(tcfg.EXPERIMENTS) == 148
    for name in jexp.EXPERIMENTS:
        t, j = tcfg.get_experiment(name), jexp.get_experiment(name)
        assert set(t) == set(j), name
        data = dict(t["dataset"])
        assert data.pop("subsample_sparse") == data["train"][
            "subsample_sparse"]
        assert data == j["dataset"], name
        assert (dataclasses.asdict(t["schedule"])
                == dataclasses.asdict(j["schedule"])), name
        for k in set(j) - {"dataset", "schedule"}:
            assert t[k] == j[k], (name, k)


def _distinct_models() -> dict:
    """{first leaf: model dict} of the registry's distinct model dicts."""
    seen = {}
    for name in tcfg.EXPERIMENTS:
        cfg = tcfg.get_experiment(name)["model"]
        seen.setdefault(json.dumps(cfg, sort_keys=True), (name, cfg))
    return dict(seen.values())


MODELS = _distinct_models()


@pytest.mark.parametrize("leaf", sorted(MODELS))
def test_every_model_of_the_registry_builds(leaf):
    """Each distinct model dict of the 148 leaves (17) builds with
    build_model on the CPU at full width, and its parameters carry over to
    a flax tree with the JAX package's top-level modules."""
    model = build_model(MODELS[leaf])
    have = set(to_jax_variables(model)["params"])
    assert {"backbone", "match_head"} <= have, (leaf, sorted(have))
    if model.downsample is not None:
        assert "downsample" in have


# ---- the baseline heads against JAX -----------------------------------------

def _models(name: str, seed: int = 0):
    cfg = tiny_cfg(name)
    tmodel = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    jvars = jax.tree_util.tree_map(jnp.asarray, to_jax_variables(tmodel))
    return tmodel, jax_build(copy.deepcopy(cfg)), jvars


def _embeddings(seed: int, n: int, width: int = 64):
    rs = np.random.RandomState(seed)
    h = rs.randn(n, CROP, width).astype(np.float32)
    xyz = (rs.randn(n, CROP, 3) * 0.6).astype(np.float32)
    return h, xyz


@pytest.mark.parametrize("leaf", [CONCAT, STNET])
def test_match_logits_match_jax(leaf):
    tmodel, jmodel, jvars = _models(leaf)
    assert tmodel.match_type == ("concat" if leaf == CONCAT
                                 else "xcorr-baseline")
    assert (tmodel.cross_stage1 is None) == (leaf == CONCAT)
    h1, x1 = _embeddings(1, 6)
    h2, x2 = _embeddings(2, 6)
    want, (o1, o2) = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=False, method="match_logits"))(
        jvars, *map(jnp.asarray, (h1, x1, h2, x2)))
    assert o1 is None and o2 is None
    with torch.no_grad():
        got, (t1, t2) = tmodel.match_logits(
            *map(torch.from_numpy, (h1, x1, h2, x2)))
    assert t1 is None and t2 is None
    assert_close_scaled(got.numpy(), np.asarray(want), JAX_TOL, leaf)


@pytest.mark.parametrize("leaf", [CONCAT, STNET])
def test_match_logits_grid_fallback_matches_jax(leaf):
    """JAX's match_logits_grid pairs every (track, det) and runs
    match_logits for these heads; so do the port's, grid_logits (the gate
    refuses the head) and pair_logits on a pair list."""
    tmodel, jmodel, jvars = _models(leaf, seed=1)
    assert not mg.fused_head_ok(tmodel)
    ht, xt = _embeddings(3, 3)
    hd, xd = _embeddings(4, 5)
    want = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method="match_logits_grid"))(
        jvars, *map(jnp.asarray, (ht, xt, hd, xd))))
    args = tuple(map(torch.from_numpy, (ht, xt, hd, xd)))
    t_idx, d_idx = torch.tensor([2, 0, 1, 1]), torch.tensor([4, 0, 3, 1])
    with torch.no_grad():
        grid = tmodel.match_logits_grid(*args)
        fused = mg.grid_logits(tmodel, *args)
        pairs = mg.pair_logits(tmodel, *args, t_idx, d_idx)
    assert grid.shape == (3, 5)
    assert_close_scaled(grid.numpy(), want, JAX_TOL, "grid")
    assert_close_scaled(fused.numpy(), want, JAX_TOL, "grid_logits")
    assert_close_scaled(pairs.numpy(), want[t_idx, d_idx], JAX_TOL, "pairs")


# ---- the gate ---------------------------------------------------------------

GATE_LEAVES = [
    (FLAGSHIP, ()), (POINTNET, ()), (DGCNN, ()), (CONCAT, ()), (STNET, ()),
    (IMAGE, ()),
    # a kernel knob: the fused chain hard-codes the plain linear attention
    (FLAGSHIP, ("model.cross_stage2.attention=linear-pallas",)),
    (POINTNET, ("model.cross_stage1.attention=linear-pallas",)),
]


@pytest.mark.parametrize("image_mode", [False, True], ids=["point", "image"])
@pytest.mark.parametrize("leaf,options", GATE_LEAVES,
                         ids=[f"{n[:30]}{'+knob' if o else ''}"
                              for n, o in GATE_LEAVES])
def test_fused_head_gate_matches_jax(leaf, options, image_mode):
    options = list(options)
    tmodel = build_model(tcfg.get_experiment(leaf, options)["model"])
    jmodel = jax_build(jexp.get_experiment(leaf, options)["model"])
    want = _pallas_grid_ok(jmodel, image_mode, interpret=True)
    assert mg.fused_head_ok(tmodel, image_mode) == want
    # the flagship family's and the image leaf's own heads are fused
    if not options and leaf not in (CONCAT, STNET):
        assert want == (image_mode == (leaf == IMAGE))


# ---- the tracker: which heads reach the kernel chain ------------------------

def _frames(model, sparse: str, frames: int = 3):
    """TrackingManager over a small scene on the CPU; returns the scorer
    (its last frame), the last frame of every scored step and the
    manager."""
    scorer = PairScorer(model)
    mgr = TrackingManager(scorer, subsample_number=CROP, match_threshold=1.0,
                          seed=0, sparse_scoring=sparse)
    records = []
    for frame in bench_scene(6, 60, frames, seed=3):
        mgr.step(*frame)
        if scorer.last_frame is not None:
            records.append(scorer.last_frame)
    return scorer, records, mgr


@pytest.mark.parametrize("sparse", ["never", "always"])
@pytest.mark.parametrize("leaf", [CONCAT, STNET])
def test_baseline_frames_skip_the_match_kernels(leaf, sparse, monkeypatch):
    """With the fused chain's wrappers made to raise, the tracker scores a
    baseline leaf's dense and sparse frames, each equal to match_logits on
    its pairs."""
    def refuse(*a, **k):
        raise AssertionError("a baseline head reached the match kernels")
    for name in ("fused_match_grid", "fused_match_pairs", "match_factors"):
        monkeypatch.setattr(mg, name, refuse)
    model, _, _ = _models(leaf, seed=2)
    scorer, records, _ = _frames(model, sparse)
    assert records and not scorer.fused
    for rec in records:
        if rec["pairs"] is None:
            nt, nd = rec["h_t"].shape[0], rec["h_d"].shape[0]
            t_idx = torch.arange(nt).repeat_interleave(nd)
            d_idx = torch.arange(nd).repeat(nt)
        else:
            t_idx, d_idx = (p.long() for p in rec["pairs"])
        with torch.no_grad():
            want = model.match_logits(rec["h_t"][t_idx], rec["xyz_t"][t_idx],
                                      rec["h_d"][d_idx],
                                      rec["xyz_d"][d_idx])[0]
        assert_close_scaled(rec["logits"].reshape(-1).numpy(), want.numpy(),
                            SAME_TOL, leaf)


@pytest.mark.parametrize("leaf", [POINTNET, DGCNN])
def test_pointnet_and_dgcnn_frames_go_through_the_match_kernels(
        leaf, monkeypatch):
    """The same tracker on a PointNet and a DGCNN leaf calls the fused
    chain's wrappers (their plain versions on CPU tensors) once a dense
    frame and once a sparse one, on 64-wide downsampled features, which
    the device track cache holds."""
    calls = []
    for name in ("fused_match_grid", "fused_match_pairs"):
        real = getattr(mg, name)
        monkeypatch.setattr(mg, name, lambda *a, _real=real, _n=name, **k: (
            calls.append(_n), _real(*a, **k))[1])
    model, _, _ = _models(leaf)
    for sparse, want in (("never", "fused_match_grid"),
                         ("always", "fused_match_pairs")):
        calls.clear()
        scorer, records, mgr = _frames(model, sparse)
        assert scorer.fused and calls == [want] * len(records) and records
        assert records[-1]["h_d"].shape[-1] == 64
        assert mgr._dc.h_buf.shape[1:] == (CROP, 64)


# ---- training ---------------------------------------------------------------

def test_concat_train_step_matches_jax():
    check_leaf_step(tiny_cfg(CONCAT))
