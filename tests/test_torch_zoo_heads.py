"""The tracker-era zoo's other heads and backbone as whole models against
the JAX package, the kernel gate on every zoo config, and the tracker's
frames on them: VN-DGCNN (2046-wide features through the DGCNN leaf's
Linear(64) downsample, on the match kernels' plain version), the combines
'add', 'minus' and 'cat' and pool_type 'max', each built by both packages
from the same --set strings (tests/_torch_zoo.py).

Tolerances, relative to max(1, max |JAX|): embed, forward, grid and pair
list 1e-4 (float32); a frame's logits against match_logits on its pairs
1e-6 (the same function on other row batches).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.inference.pair_scoring import (  # noqa: E402
    _pallas_grid_ok)
from point_cloud_reid_tpu_torch.configs.zoo import ZOO  # noqa: E402
from point_cloud_reid_tpu_torch.inference import PairScorer  # noqa: E402
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model  # noqa: E402
from point_cloud_reid_tpu_torch.tools.scenes import bench_scene  # noqa: E402
from point_cloud_reid_tpu_torch.tracking import TrackingManager  # noqa: E402
from tests._torch_port import (assert_close_scaled, pair_batch,  # noqa: E402
                               torch_batch)
from tests._torch_zoo import (D_IDX, N_PTS, T_IDX, dup_crops,  # noqa: E402
                              zoo_cfgs, zoo_models)
from tests._torch_threads import few_threads  # noqa: E402,F401

MODEL_TOL = 1e-4
SAME_TOL = 1e-6
HEADS = ["vn_dgcnn", "add", "minus", "cat", "max"]


@pytest.mark.parametrize("name", HEADS)
def test_zoo_model_matches_jax(name):
    """The embed, the tracker's grid and pair-list entries (vn_dgcnn's
    through the match kernels' plain version, the others through the
    model's own scoring) and the forward against JAX's embed,
    match_logits_grid and __call__, in one jit."""
    jmodel, jvars, tmodel = zoo_models(name)
    x = dup_crops(1)
    batch = {k: v for k, v in pair_batch(2, B=3).items()
             if k in ("sparse_1", "sparse_2", "id_1", "id_2")}

    @jax.jit
    def run(variables, x, batch):
        xyz, h = jmodel.apply(variables, x, train=False, method="embed")
        grid = jmodel.apply(variables, h[:3], xyz[:3], h, xyz,
                            method="match_logits_grid")
        return h, grid, jmodel.apply(variables, batch, train=False)
    jh, jgrid, jout = jax.tree_util.tree_map(np.asarray, run(
        jvars, jnp.asarray(x), {k: jnp.asarray(v) for k, v in batch.items()}))
    assert mg.fused_head_ok(tmodel) == (name == "vn_dgcnn")
    with torch.no_grad():
        xyz, h = tmodel.embed(torch.from_numpy(x))
        grid = mg.grid_logits(tmodel, h[:3], xyz[:3], h, xyz)
        pairs = mg.pair_logits(tmodel, h[:3], xyz[:3], h, xyz,
                               torch.from_numpy(T_IDX),
                               torch.from_numpy(D_IDX))
        tout = tmodel(torch_batch(batch))
    assert h.shape == (5, N_PTS, 64)
    assert_close_scaled(h.numpy(), jh, MODEL_TOL, "embed")
    assert_close_scaled(grid.numpy(), jgrid, MODEL_TOL, "grid")
    assert_close_scaled(pairs.numpy(), jgrid[T_IDX, D_IDX], MODEL_TOL,
                        "pairs")
    assert set(tout) == set(jout)
    for k in jout:
        assert_close_scaled(tout[k].numpy(), jout[k], MODEL_TOL, k)


def test_head_widths_follow_combine_and_pool():
    """The match head's input is 2 x d for 'both' pooling (4 x d with
    'cat'), d for 'max'; the cls / fp heads take the pooled backbone
    features."""
    widths = {}
    for name in ("add", "cat", "max"):
        cfg, _ = zoo_cfgs(name)
        cfg["cls_head"] = [dict(type="Linear", out_features=3)]
        widths[name] = (build_model(cfg).match_head[0].linear1.in_features,
                        build_model(cfg).cls_head[0].in_features)
    assert widths == {"add": (128, 128), "cat": (256, 128), "max": (64, 64)}


@pytest.mark.parametrize("name", list(ZOO))
def test_fused_head_gate_matches_jax(name):
    """kernels/match_grid.fused_head_ok against the JAX scorer's
    _pallas_grid_ok(model, False, interpret=True) on every zoo config:
    only VN-DGCNN's head (xcorr_eff, point-cat, both pools, two plain
    linear cross stages) is the chain the kernels compute."""
    from point_cloud_reid_tpu.models import build_model as jax_build
    cfg, jcfg = zoo_cfgs(name)
    want = _pallas_grid_ok(jax_build(jcfg), False, interpret=True)
    assert mg.fused_head_ok(build_model(cfg)) == want == (name == "vn_dgcnn")


def _frames(model, sparse: str):
    """TrackingManager over a small scene on the CPU: (scorer, the last
    frame of every scored step)."""
    scorer = PairScorer(model)
    mgr = TrackingManager(scorer, subsample_number=N_PTS,
                          match_threshold=1.0, seed=0,
                          sparse_scoring=sparse)
    records = []
    for frame in bench_scene(5, 60, 3, seed=3):
        mgr.step(*frame)
        if scorer.last_frame is not None:
            records.append(scorer.last_frame)
    return scorer, records


@pytest.mark.parametrize("sparse", ["never", "always"])
@pytest.mark.parametrize("name", ["xcorr-pallas", "cosine", "loftr", "add"])
def test_zoo_frames_skip_the_match_kernels(name, sparse, monkeypatch):
    """With the fused chain's wrappers made to raise, the tracker scores a
    zoo head's dense and sparse frames by the model's own functions, each
    equal to match_logits on its pairs."""
    def refuse(*a, **k):
        raise AssertionError("a zoo head reached the match kernels")
    for fn in ("fused_match_grid", "fused_match_pairs", "match_factors"):
        monkeypatch.setattr(mg, fn, refuse)
    _, _, model = zoo_models(name)
    scorer, records = _frames(model, sparse)
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
                            SAME_TOL, name)


def test_vn_dgcnn_frames_go_through_the_match_kernels(monkeypatch):
    """VN-DGCNN's head is the fused chain: a dense frame calls the grid
    wrapper and a sparse one the pair wrapper (their plain versions on CPU
    tensors), on 64-wide downsampled features."""
    calls = []
    for fn in ("fused_match_grid", "fused_match_pairs"):
        real = getattr(mg, fn)
        monkeypatch.setattr(mg, fn, lambda *a, _real=real, _n=fn, **k: (
            calls.append(_n), _real(*a, **k))[1])
    _, _, model = zoo_models("vn_dgcnn")
    for sparse, want in (("never", "fused_match_grid"),
                         ("always", "fused_match_pairs")):
        calls.clear()
        scorer, records = _frames(model, sparse)
        assert scorer.fused and set(calls) == {want}
        assert records[-1]["h_d"].shape[-1] == 64
