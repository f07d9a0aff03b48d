"""The port's PointNet and DGCNN against the JAX package: DGCNN's kNN in
feature space and its edge features, the PointNet transforms (STN), both
backbones in eval and train mode with their BatchNorm statistics, the
feature-transform regularizer, both leaves' embed + match scoring, the
weight converter both ways, bf16, one train step of each leaf and its
--remat twin.

Weights are the port's seeded init handed to JAX by
convert.to_jax_variables (or JAX's init handed to the port by
from_jax_variables); inputs come from numpy seeds, crops with duplicated
points as resample-with-replacement makes them. Tolerances, each relative
to max(1, max |reference|) unless it says otherwise:
  kNN indices and edge features: equal;
  float32 eval forwards: 1e-5;
  train mode: float64 on both sides, 1e-9 (in float32 the small batches'
    BatchNorm statistics amplify rounding: the port's float32 PointNet lies
    5.6e-5 from the float64 reference and JAX's own float32 one 1.8e-4);
  train step: tests/_torch_port.check_leaf_step (the port in float64
    against JAX's float64 step at 1e-6, in float32 at 1e-3);
  remat: the plain step's logs to 1e-5;
  bf16: the JAX suite's bar, 3e-2 (BF16_TOL); the leaf's bf16 logits
    within 6e-2 of JAX's bf16 logits.
"""
import copy
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from point_cloud_reid_tpu.models import build_model as jax_build  # noqa: E402
from point_cloud_reid_tpu.models import dgcnn as jdgcnn  # noqa: E402
from point_cloud_reid_tpu.models.dgcnn import DGCNNBackbone as JDGCNN  # noqa: E402
from point_cloud_reid_tpu.models.pointnet import STN as JSTN  # noqa: E402
from point_cloud_reid_tpu.models.pointnet import (  # noqa: E402
    PointNetBackbone as JPointNet)
from point_cloud_reid_tpu.models.pointnet import (  # noqa: E402
    feature_transform_regularizer as j_regularizer)
from point_cloud_reid_tpu.ops import geometry as jgeo  # noqa: E402
from point_cloud_reid_tpu_torch.configs import get_experiment  # noqa: E402
from point_cloud_reid_tpu_torch.convert import (  # noqa: E402
    from_jax_variables, to_jax_variables)
from point_cloud_reid_tpu_torch.kernels import match_grid as mg  # noqa: E402
from point_cloud_reid_tpu_torch.models import build_model, init_weights  # noqa: E402
from point_cloud_reid_tpu_torch.models import dgcnn as tdgcnn  # noqa: E402
from point_cloud_reid_tpu_torch.models.dgcnn import DGCNNBackbone  # noqa: E402
from point_cloud_reid_tpu_torch.models.layers import set_compute_dtype  # noqa: E402
from point_cloud_reid_tpu_torch.models.pointnet import (  # noqa: E402
    PointNetBackbone, feature_transform_regularizer)
from point_cloud_reid_tpu_torch.ops import geometry as tgeo  # noqa: E402
from tests._torch_port import (BF16_TOL, assert_close_scaled,  # noqa: E402
                               check_leaf_step, pair_batch, port_flat,
                               port_step)

POINTNET = "pts_pointnet_point-cat_nus_det_4x256_500e"
DGCNN = "pts_dgcnn_point-cat_nus_det_4x256_500e"
# DGCNN at test size: the JAX converter test's widths
DGCNN_KW = dict(emb_dims=64, k=6)
EVAL_TOL = 1e-5
TRAIN64_TOL = 1e-9
REMAT_TOL = 1e-5
BF16_LOGIT_TOL = 6e-2


def dup_crops(seed: int, B: int = 4, N: int = 32, dups: int = 6,
              scale: float = 0.6) -> np.ndarray:
    """(B, N, 3) crops whose last `dups` points repeat earlier ones."""
    rs = np.random.RandomState(seed)
    base = (rs.randn(B, N - dups, 3) * scale).astype(np.float32)
    return np.concatenate([base, base[:, rs.randint(0, N - dups, dups)]], 1)


def backbone(family: str, seed: int = 0):
    """(port backbone under a holder named `backbone`, its flax variables
    {'params', 'batch_stats'} as numpy, the JAX module at a dtype)."""
    holder = torch.nn.Module()
    if family == "pointnet":
        holder.backbone = PointNetBackbone(channel=3)

        def jmod(dtype=jnp.float32):
            return JPointNet(channel=3, dtype=dtype)
    else:
        holder.backbone = DGCNNBackbone(**DGCNN_KW)

        def jmod(dtype=jnp.float32):
            return JDGCNN(**DGCNN_KW, dtype=dtype)
    init_weights(holder, torch.Generator().manual_seed(seed))
    tree = to_jax_variables(holder)
    return holder, {c: tree[c]["backbone"] for c in tree}, jmod


def as_jnp(tree, dtype=None):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype) if dtype else jnp.asarray(a), tree)


def leaf_cfg(name: str) -> dict:
    cfg = get_experiment(name)["model"]
    if cfg["backbone"]["type"] == "dgcnn":
        cfg["backbone"].update(DGCNN_KW)
    return cfg


# ---- feature-space kNN and edge features -----------------------------------

def _features(kind: str) -> np.ndarray:
    """(B, C, N) channel-first inputs of DGCNN's kNN."""
    if kind == "duplicated xyz":
        return dup_crops(1).transpose(0, 2, 1)
    if kind == "all-zero crop":
        return np.zeros((2, 3, 32), np.float32)
    # 64 channels, as the second EdgeConv block sees, with repeated columns
    rs = np.random.RandomState(2)
    x = rs.randn(3, 64, 26).astype(np.float32)
    return np.concatenate([x, x[:, :, rs.randint(0, 26, 6)]], axis=2)


@pytest.mark.parametrize("kind", ["duplicated xyz", "all-zero crop",
                                  "duplicated features"])
def test_knn_feature_space_indices_equal_jax(kind):
    x = _features(kind)
    want = np.asarray(jgeo.knn_feature_space(jnp.asarray(x), 6))
    got = tgeo.knn_feature_space(torch.from_numpy(x), 6).numpy()
    np.testing.assert_array_equal(got, want)
    # every point is its own first neighbour unless it repeats an earlier
    # one, which then comes first (the lower index among equal distances)
    assert (got[..., 0] <= np.arange(x.shape[2])).all()


@pytest.mark.parametrize("given_idx", [False, True],
                         ids=["own kNN", "given indices"])
def test_get_graph_feature_equals_jax(given_idx):
    x = _features("duplicated features")
    idx = np.random.RandomState(4).randint(0, x.shape[2], (3, x.shape[2], 6))
    want = np.asarray(jgeo.get_graph_feature(
        jnp.asarray(x), 6, idx=jnp.asarray(idx) if given_idx else None))
    got = tgeo.get_graph_feature(
        torch.from_numpy(x), 6,
        idx=torch.from_numpy(idx) if given_idx else None).numpy()
    np.testing.assert_array_equal(got, want)


# ---- modules ----------------------------------------------------------------

def _run_jax(jmod, variables, x, train: bool, jit: bool = True):
    """(output, batch_stats after the call); jitted unless `jit` is False
    (a call whose ops are recorded as they run)."""
    if train:
        fn = functools.partial(jmod.apply, train=True,
                               mutable=["batch_stats"])
        out, mut = (jax.jit(fn) if jit else fn)(variables, x)
        return out, mut["batch_stats"]
    fn = functools.partial(jmod.apply, train=False)
    return (jax.jit(fn) if jit else fn)(variables, x), variables["batch_stats"]


def _bn_stats(module: torch.nn.Module) -> dict:
    return {k: v.double().numpy() for k, v in module.state_dict().items()
            if "running_" in k}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("k", [3, 64])
def test_stn_matches_jax(k, train):
    holder, var, _ = backbone("pointnet")
    stn = holder.backbone.feat.stn if k == 3 else holder.backbone.feat.fstn
    var = {c: var[c]["feat"]["stn" if k == 3 else "fstn"] for c in var}
    x = dup_crops(3) if k == 3 else np.random.RandomState(3).randn(
        4, 32, 64).astype(np.float32)
    if not train:
        want, _ = _run_jax(JSTN(k=k), as_jnp(var), jnp.asarray(x), False)
        with torch.no_grad():
            got = stn(torch.from_numpy(x))
        assert_close_scaled(got.numpy(), np.asarray(want), EVAL_TOL, "stn")
        return
    name = "stn" if k == 3 else "fstn"
    with jax.enable_x64():
        want, stats = _run_jax(JSTN(k=k, dtype=jnp.float64),
                               as_jnp(var, jnp.float64),
                               jnp.asarray(x, jnp.float64), True)
        want = np.asarray(want)
        # the converter's names hold under the encoder's
        stats = port_flat({"feat": {name: jax.tree_util.tree_map(
            np.asarray, stats)}})
    stn = stn.double()
    with torch.no_grad():
        got = stn(torch.from_numpy(x).double(), True)
    assert_close_scaled(got.numpy(), want, TRAIN64_TOL, "stn")
    got_stats = {f"feat.{name}.{key}": v for key, v in _bn_stats(stn).items()}
    assert set(got_stats) == set(stats)
    for key, v in stats.items():
        assert_close_scaled(got_stats[key], v, TRAIN64_TOL, key)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("family", ["pointnet", "dgcnn"])
def test_backbone_matches_jax(family, train):
    """Per-point features, and in train mode the running statistics every
    BatchNorm moved to."""
    holder, var, jmod = backbone(family)
    x = dup_crops(4)
    if not train:
        (_, want), _ = _run_jax(jmod(), as_jnp(var), jnp.asarray(x), False)
        with torch.no_grad():
            xyz, got = holder.backbone(torch.from_numpy(x))
        assert got.shape == (4, 32, 1024 if family == "pointnet" else 64)
        np.testing.assert_array_equal(xyz.numpy(), x)
        assert_close_scaled(got.numpy(), np.asarray(want), EVAL_TOL, family)
        return
    with jax.enable_x64():
        (_, want), stats = _run_jax(jmod(jnp.float64),
                                    as_jnp(var, jnp.float64),
                                    jnp.asarray(x, jnp.float64), True)
        want = np.asarray(want)
        stats = port_flat({"backbone": jax.tree_util.tree_map(np.asarray,
                                                               stats)})
    holder = holder.double()
    with torch.no_grad():
        _, got = holder.backbone(torch.from_numpy(x).double(), (), True)
    assert_close_scaled(got.numpy(), want, TRAIN64_TOL, family)
    got_stats = _bn_stats(holder)
    assert set(got_stats) == set(stats) and got_stats
    for key, v in stats.items():
        assert_close_scaled(got_stats[key], v, TRAIN64_TOL, key)


def test_feature_transform_regularizer_matches_jax():
    trans = np.random.RandomState(5).randn(4, 64, 64).astype(np.float32)
    want = float(j_regularizer(jnp.asarray(trans)))
    got = float(feature_transform_regularizer(torch.from_numpy(trans)))
    assert abs(got - want) <= EVAL_TOL * max(1.0, abs(want))


# ---- the converter both ways ------------------------------------------------

@pytest.mark.parametrize("family", ["pointnet", "dgcnn"])
def test_jax_trees_round_trip_bit_for_bit(family):
    """A JAX init of the backbone (with running statistics a train-mode call
    moved) -> from_jax_variables -> to_jax_variables returns the same
    tree, leaf for leaf and bit for bit."""
    holder, _, jmod = backbone(family)
    jmod = jmod()
    x = jnp.asarray(dup_crops(6))
    variables = jmod.init(jax.random.PRNGKey(1), x, train=False)
    _, mut = jmod.apply(variables, x, train=True, mutable=["batch_stats"])
    want = {"params": {"backbone": variables["params"]},
            "batch_stats": {"backbone": mut["batch_stats"]}}
    want = jax.tree_util.tree_map(np.asarray, want)
    got = to_jax_variables(from_jax_variables(holder, want))
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = flat_g[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


# ---- the leaves: embed + scoring --------------------------------------------

@pytest.mark.parametrize("leaf", [POINTNET, DGCNN])
def test_leaf_embed_and_scoring_match_jax(leaf):
    """embed (backbone + downsample to d = 64), the grid through
    kernels/match_grid (the plain version of the fused chain on the CPU)
    and the pair list against JAX's embed and match_logits_grid."""
    cfg = leaf_cfg(leaf)
    tmodel = build_model(cfg, generator=torch.Generator().manual_seed(0))
    assert mg.fused_head_ok(tmodel)
    jmodel = jax_build(copy.deepcopy(cfg))
    jvars = as_jnp(to_jax_variables(tmodel))
    x = dup_crops(7, B=5)

    @jax.jit
    def jax_scores(variables, x):
        xyz, h = jmodel.apply(variables, x, train=False, method="embed")
        return h, jmodel.apply(variables, h[:3], xyz[:3], h, xyz,
                               method="match_logits_grid")
    jh, want = jax_scores(jvars, jnp.asarray(x))
    want = np.asarray(want)
    with torch.no_grad():
        xyz, h = tmodel.embed(torch.from_numpy(x))
        assert h.shape == (5, 32, 64)
        assert_close_scaled(h.numpy(), np.asarray(jh), EVAL_TOL, "embed")
        grid = mg.grid_logits(tmodel, h[:3], xyz[:3], h, xyz)
        t_idx, d_idx = torch.tensor([0, 2, 1, 2]), torch.tensor([4, 0, 1, 3])
        pairs = mg.pair_logits(tmodel, h[:3], xyz[:3], h, xyz, t_idx, d_idx)
    assert_close_scaled(grid.numpy(), want, 1e-4, "grid")
    assert_close_scaled(pairs.numpy(), want[t_idx, d_idx], 1e-4, "pairs")


# ---- bf16 -------------------------------------------------------------------

def _close_bf16(got: torch.Tensor, want, what: str):
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, what
    assert_close_scaled(got.float().numpy(), np.asarray(want, np.float32),
                        BF16_TOL, what)


@pytest.fixture
def jax_knn_fed(monkeypatch):
    """DGCNN's kNN picks at bf16 follow the features' roundings, which the
    two packages reach by different summation orders: on these inputs 17
    and 59 of 768 picks differ in the last two blocks. So the JAX module's
    picks are recorded block by block (get_graph_feature patched in the JAX
    module's namespace, eager apply) and fed to the port's blocks in the
    same order (knn_feature_space patched in models/dgcnn.py)."""
    picks = []
    real = jdgcnn.get_graph_feature

    def recording(x, k, idx=None, edge=True):
        idx = jgeo.knn_feature_space(x, k)
        picks.append(np.array(idx))
        return real(x, k, idx=idx, edge=edge)

    monkeypatch.setattr(jdgcnn, "get_graph_feature", recording)

    def fed(x, k):
        return torch.from_numpy(picks.pop(0)).long()

    monkeypatch.setattr(tdgcnn, "knn_feature_space", fed)
    return picks


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("k", [3, 64])
def test_stn_at_bf16_matches_jax(k, train):
    holder, var, _ = backbone("pointnet")
    stn = holder.backbone.feat.stn if k == 3 else holder.backbone.feat.fstn
    var = as_jnp({c: var[c]["feat"]["stn" if k == 3 else "fstn"]
                  for c in var})
    set_compute_dtype(holder, torch.bfloat16)
    if k == 3:      # float32 xyz on both sides
        x_t = torch.from_numpy(dup_crops(8))
        x_j = jnp.asarray(x_t.numpy())
    else:           # the feature transform sees bf16 features
        x_t = torch.from_numpy(np.random.RandomState(8).randn(
            4, 32, 64).astype(np.float32)).to(torch.bfloat16)
        x_j = jnp.asarray(x_t.float().numpy(), jnp.bfloat16)
    # op by op: in train mode JAX's jitted bf16 transform lies 0.053 (k=3)
    # and 0.080 (k=64) from its own op-by-op run at scales 1.6 and 2.3 (XLA
    # fuses across the bf16 roundings, and BatchNorm over the batch's 4 rows
    # amplifies the difference); the port follows the op-by-op roundings
    # (0.0 and 0.008 from them)
    want, _ = _run_jax(JSTN(k=k, dtype=jnp.bfloat16), var, x_j, train,
                       jit=False)
    with torch.no_grad():
        got = stn(x_t, train)
    _close_bf16(got, want, f"stn{k}")


def test_pointnet_at_bf16_matches_jax():
    """Eval mode. In train mode a bf16 PointNet's output is not a stable
    reference: BatchNorm over near-constant channels of conv3 amplifies
    rounding, and JAX's own bf16 and float32 outputs lie 2.6 apart at scale
    7.7 on these crops; its transforms are compared in train mode above."""
    holder, var, _ = backbone("pointnet")
    set_compute_dtype(holder, torch.bfloat16)
    x = dup_crops(9)
    (xyz, want), _ = _run_jax(JPointNet(channel=3, dtype=jnp.bfloat16),
                              as_jnp(var), jnp.asarray(x), False)
    with torch.no_grad():
        got_xyz, got = holder.backbone(torch.from_numpy(x))
    assert got_xyz.dtype == torch.float32 and xyz.dtype == jnp.float32
    _close_bf16(got, want, "pointnet")


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_dgcnn_at_bf16_matches_jax(train, jax_knn_fed):
    holder, var, _ = backbone("dgcnn")
    set_compute_dtype(holder, torch.bfloat16)
    x = dup_crops(10)
    (_, want), _ = _run_jax(JDGCNN(**DGCNN_KW, dtype=jnp.bfloat16),
                            as_jnp(var), jnp.asarray(x), train, jit=False)
    assert len(jax_knn_fed) == 4
    with torch.no_grad():
        _, got = holder.backbone(torch.from_numpy(x), (), train)
    assert not jax_knn_fed
    _close_bf16(got, want, "dgcnn")


def test_pointnet_leaf_logits_at_bf16_match_jax():
    """The serving path at bf16: embed + the plain fused chain + head, from
    the same float32 weights, against JAX's bf16 embed + match_logits_grid
    (the bar of tests/test_torch_bf16_serving.py)."""
    cfg = leaf_cfg(POINTNET)
    t16 = build_model(cfg, generator=torch.Generator().manual_seed(0),
                      dtype=torch.bfloat16)
    jmodel = jax_build(copy.deepcopy(cfg), dtype=jnp.bfloat16)
    jvars = as_jnp(to_jax_variables(t16))
    x = dup_crops(11, B=4)

    @jax.jit
    def jax_logits(variables, x):
        xyz, h = jmodel.apply(variables, x, train=False, method="embed")
        return jmodel.apply(variables, h, xyz, h, xyz,
                            method="match_logits_grid")
    want = np.asarray(jax_logits(jvars, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        xyz, h = t16.embed(torch.from_numpy(x))
        got = mg.grid_logits(t16, h, xyz, h, xyz)
    assert h.dtype == got.dtype == torch.bfloat16
    assert_close_scaled(got.float().numpy(), want, BF16_LOGIT_TOL, "logits")


# ---- training ---------------------------------------------------------------

@pytest.mark.parametrize("leaf", [POINTNET, DGCNN])
def test_train_step_matches_jax(leaf):
    check_leaf_step(leaf_cfg(leaf))


@pytest.mark.parametrize("leaf", [POINTNET, DGCNN])
def test_remat_step_equals_plain_step(leaf, monkeypatch):
    """--remat checkpoints PointNet's encoder (its transforms recomputed
    with it) and DGCNN's EdgeConv blocks (train/loop._REMAT_STAGES) and
    gives the plain step."""
    from point_cloud_reid_tpu_torch.train import loop
    tmodel = build_model(leaf_cfg(leaf),
                         generator=torch.Generator().manual_seed(1))
    stages = {type(m).__name__ for m in tmodel.modules()
              if isinstance(m, loop._REMAT_STAGES)}
    assert stages >= ({"PointNetEncoder"} if leaf == POINTNET
                      else {"EdgeConv"})
    calls = []
    real = loop.checkpoint
    monkeypatch.setattr(loop, "checkpoint", lambda fn, *a, **k: (
        calls.append(type(fn.__self__).__name__), real(fn, *a, **k))[1])
    batch = pair_batch(31, B=4)
    neg = torch.from_numpy(np.random.RandomState(0).randint(0, 8, (4, 5)))
    plain, _ = port_step(tmodel, batch, torch.float32, neg)
    assert not calls
    remat, _ = port_step(tmodel, batch, torch.float32, neg, remat=True)
    assert stages <= set(calls)
    for k, w in plain.items():
        assert abs(remat[k] - w) <= REMAT_TOL * max(1.0, abs(w)), (k,
                                                                   remat[k], w)
