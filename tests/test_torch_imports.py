"""Import hygiene of the PyTorch port, checked in a fresh interpreter (this
suite's conftest imports jax): no module of point_cloud_reid_tpu_torch, nor
chip_smoke.py, pulls in jax, flax, optax or the JAX package, nor does
reading a store that the JAX package wrote; the CPU path of
every kernel wrapper runs without building or loading the CUDA library; and
every entry point runs on the CUDA device by default, so without a card it
exits with an error instead of running on the CPU."""
import json
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from tests._torch_threads import TEST_THREADS, few_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each fresh interpreter takes the test files' thread count
# (tests/_torch_threads.py)
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(TEST_THREADS))

_IMPORT_ALL = """
import importlib, json, pkgutil, sys
import point_cloud_reid_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for n in names:
    importlib.import_module(n)
print(json.dumps(dict(n=len(names), names=names, jax='jax' in sys.modules,
                      flax='flax' in sys.modules,
                      optax='optax' in sys.modules,
                      matplotlib='matplotlib' in sys.modules,
                      jax_pkg=any(m.startswith('point_cloud_reid_tpu.')
                                  for m in sys.modules))))
"""

_CPU_PATH = """
import ctypes, json, numpy as np, torch
def refuse(*a, **k):
    raise AssertionError('ctypes library touched on the CPU path')
ctypes.CDLL = refuse
from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
from point_cloud_reid_tpu_torch.inference import PairScorer
from point_cloud_reid_tpu_torch.kernels import _lib, match_grid, sa_stage
from point_cloud_reid_tpu_torch.models import build_model
from point_cloud_reid_tpu_torch.tracking import TrackingManager
model = build_model(point_transformer_point_cat(
    conv_out=16, mul=1, nsample=(8, 8, 8), backbone_list=(16, 8, 4)))
mgr = TrackingManager(PairScorer(model), subsample_number=32,
                      sparse_scoring='always')
rs = np.random.RandomState(0)
c = (rs.rand(4, 3) * 10).astype(np.float32); c[:, 2] = 0
boxes = np.concatenate([c, np.full((4, 3), 2, np.float32),
                        np.zeros((4, 1), np.float32)], 1)
for _ in range(2):
    pts = np.repeat(c, 30, 0) + rs.randn(120, 3).astype(np.float32) * 0.4
    mgr.step(pts, boxes, np.ones(4, np.float32), np.zeros(4, np.int64))
with torch.no_grad():
    xyz, h = model.embed(torch.from_numpy(
        rs.randn(8, 32, 3).astype(np.float32)))
    match_grid.grid_logits(model, h, xyz, h, xyz)
# one train step with both kernel knobs on
from point_cloud_reid_tpu_torch.kernels import knn, linear_attention
from point_cloud_reid_tpu_torch.train import (ScheduleConfig,
    SyntheticPairLoader, TrainState, make_train_step, to_device)
cfg = point_transformer_point_cat(
    conv_out=16, mul=1, nsample=(8, 8, 8), backbone_list=(16, 8, 4))
cfg['knn_method'] = 'pallas'
cfg['cross_stage1']['attention'] = cfg['cross_stage2']['attention'] = \
    'linear-pallas'
model = build_model(cfg)
state = TrainState.create(model, ScheduleConfig(max_epochs=1), 1)
step = make_train_step(model, dict(match=True, kl=True, triplet=True), {})
batch = next(iter(SyntheticPairLoader(4, 1, num_points=32, num_objects=8)))
_, log = step(state, to_device(batch, 'cpu'),
              torch.Generator().manual_seed(0))
assert bool(torch.isfinite(log['reid_loss']))
# the image tracker (dense and gated sparse) and an FPS-sampled SA stage
from point_cloud_reid_tpu_torch.kernels import fps
from point_cloud_reid_tpu_torch.models import vit
from point_cloud_reid_tpu_torch.models.point_transformer import (
    SetAbstractionEdgeSA)
from point_cloud_reid_tpu_torch.tools.scenes import image_scene
vit.VIT_PRESETS['tiny'] = dict(dim=32, depth=1, heads=2, dist_token=True,
                               final_norm=False, mlp_ratio=2.0)
head = lambda n, out: [dict(type='LinearRes', n_in=n, n_out=n, ng=8),
                       dict(type='Linear', out_features=out)]
image = build_model(dict(
    type='ImageReIDNet', backbone='tiny', dim=32, downsample_dim=16,
    image_size=32, downsample=head(32, 16), match_head=head(32, 1),
    cross_lin_attn=dict(type='cross_lin_attn', d_model=16, nhead=2)))
for sparse in ('never', 'always'):
    mgr = TrackingManager(PairScorer(image, image_mode=True),
                          sparse_scoring=sparse)
    for frame in image_scene(4, 2, image_hw=(90, 160)):
        mgr.step(*frame)
    assert len(mgr.store.active()) >= 4
stage = SetAbstractionEdgeSA([3, 8, 8, 8], 4, knn_method='pallas',
                             sampling='FPS')
with torch.no_grad():
    stage(torch.from_numpy(rs.randn(2, 16, 3).astype(np.float32)), None, 8)
print(json.dumps(dict(
    loaded=_lib.LIBRARY._lib is not None,
    launches=[sa_stage.fused_sa_convmax.launches,
              match_grid.fused_match_grid.launches,
              match_grid.fused_match_pairs.launches,
              knn.knn.launches,
              linear_attention.linear_attention_forward.launches,
              match_grid.fused_image_match_grid.launches,
              match_grid.fused_image_match_pairs.launches,
              fps.fps.launches])))
"""

FLAGSHIP = "pts_point-transformer_point-cat_nus_det_4x256_500e"
NEW_MODULES = {
    "configs.datasets", "configs.experiments", "evaluation.matching",
    "kernels.knn", "kernels.linear_attention", "models.registry",
    "tools.train", "tools.profile_train", "train.loop", "train.losses",
    "train.schedules", "train.state", "train.synthetic", "utils.logging",
    "convert.hf_vit", "kernels.fps", "models.image_reid", "models.vit",
    "tracking.image_crops", "data", "data.store", "data.buckets",
    "data.pipeline", "data.samplers", "data.import_reference", "native",
    "native.plain", "tools.test", "tools.make_synthetic_data",
    "tools.dump_val_pairs", "tools.import_reference_store",
    "tools.profile_loader", "utils.cache", "utils.profiling",
    "models.pointnet", "models.dgcnn", "models.loftr",
    "models.vector_neurons", "models.node_pooling", "configs.zoo",
    "convert.torch_checkpoint", "ops.voxel", "ops.sparse", "ops.boxes3d",
    "tools.convert_checkpoint", "tools.parity_eval", "tools.acc_plots",
    "tools.tracking_plots", "tools.launcher", "parallel", "parallel.mesh",
    "parallel.distributed", "ops.sa_train"}
# the CUDA sources the bf16 serving path adds beside the float32 ones
BF16_SOURCES = {"sa_stage_bf16.cu", "match_grid_bf16.cu"}


def _run(code: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_or_flax():
    out = _run(_IMPORT_ALL)
    assert out["n"] >= 45
    have = {n.split(".", 1)[1] for n in out["names"]}
    assert NEW_MODULES <= have, NEW_MODULES - have
    assert not (out["jax"] or out["flax"] or out["optax"] or out["jax_pkg"])
    # the plot tools import matplotlib when they draw: the card's machine
    # has none
    assert not out["matplotlib"]


def test_bf16_kernel_sources_are_built_with_the_others():
    """The bf16 kernels' translation units are csrc/ sources of the one
    library (one nvcc each), plain C entry points, and name nothing of
    JAX."""
    from point_cloud_reid_tpu_torch.kernels import _lib
    names = {p.name for p in _lib.Library().sources()}
    assert BF16_SOURCES <= names
    for fn in ("pcr_sa_convmax_bf16", "pcr_sa_bf16_layout",
               "pcr_match_pooled_bf16",
               "pcr_match_pooled_image_bf16",
               "pcr_match_pooled_bf16_layout"):
        assert fn in _lib._SIGNATURES
    for name in BF16_SOURCES:
        with open(os.path.join(REPO, "point_cloud_reid_tpu_torch", "csrc",
                               name)) as f:
            text = f.read()
        assert 'extern "C"' in text and "#include <cuda_bf16.h>" in text
        assert not re.search(r"#include\s*[<\"](jax|xla|pallas)", text)


_CPU_PATH_BF16 = """
import ctypes, json, numpy as np, torch
def refuse(*a, **k):
    raise AssertionError('ctypes library touched on the CPU path')
ctypes.CDLL = refuse
from point_cloud_reid_tpu_torch.configs import point_transformer_point_cat
from point_cloud_reid_tpu_torch.inference import PairScorer
from point_cloud_reid_tpu_torch.kernels import _lib, match_grid, sa_stage
from point_cloud_reid_tpu_torch.models import build_model
from point_cloud_reid_tpu_torch.tracking import TrackingManager
model = build_model(point_transformer_point_cat(
    conv_out=16, mul=1, nsample=(8, 8, 8), backbone_list=(16, 8, 4)),
    dtype=torch.bfloat16)
rs = np.random.RandomState(0)
c = (rs.rand(4, 3) * 10).astype(np.float32); c[:, 2] = 0
boxes = np.concatenate([c, np.full((4, 3), 2, np.float32),
                        np.zeros((4, 1), np.float32)], 1)
for sparse, dc in (('always', True), ('never', True), ('never', False)):
    mgr = TrackingManager(PairScorer(model), subsample_number=32,
                          sparse_scoring=sparse, device_cache=dc)
    for _ in range(2):
        pts = np.repeat(c, 30, 0) + rs.randn(120, 3).astype(np.float32) * 0.4
        mgr.step(pts, boxes, np.ones(4, np.float32), np.zeros(4, np.int64))
    assert len(mgr.store.active()) >= 4
# a bf16 train step with both kernel knobs on, with and without remat, and
# its eval step (the bf16 SA kernel's plain version)
from point_cloud_reid_tpu_torch.kernels import knn, linear_attention
from point_cloud_reid_tpu_torch.train import (ScheduleConfig,
    SyntheticPairLoader, TrainState, make_eval_step, make_train_step,
    to_device)
cfg = point_transformer_point_cat(
    conv_out=16, mul=1, nsample=(8, 8, 8), backbone_list=(16, 8, 4))
cfg['knn_method'] = 'pallas'
cfg['cross_stage1']['attention'] = cfg['cross_stage2']['attention'] = \
    'linear-pallas'
model = build_model(cfg, dtype=torch.bfloat16)
state = TrainState.create(model, ScheduleConfig(max_epochs=1), 2)
batch = to_device(next(iter(SyntheticPairLoader(4, 1, num_points=32,
                                                num_objects=8))), 'cpu')
for remat in (False, True):
    step = make_train_step(model, dict(match=True, kl=True, triplet=True),
                           {}, remat=remat)
    _, log = step(state, batch, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(log['reid_loss']))
make_eval_step(model, dict(match=True), {})(state, batch)
print(json.dumps(dict(
    loaded=_lib.LIBRARY._lib is not None,
    train_launches=[knn.knn.launches,
                    linear_attention.linear_attention_forward.launches],
    launches=[f.bf16_launches for f in (
        sa_stage.fused_sa_convmax, match_grid.fused_match_grid,
        match_grid.fused_match_pairs, match_grid.fused_image_match_grid,
        match_grid.fused_image_match_pairs)],
    dtype=str(model.dtype))))
"""


def test_cpu_wrappers_at_bf16_never_touch_the_cuda_library():
    """The bf16 tracker on the CPU (device cache dense and sparse, host
    cache), and bf16 train steps with the kernel knobs on (with and
    without remat) and an eval step, run the plain versions: no kernel
    counted, no library."""
    out = _run(_CPU_PATH_BF16)
    assert out == dict(loaded=False, train_launches=[0, 0],
                       launches=[0] * 5, dtype="torch.bfloat16")


def test_no_source_file_of_the_port_names_a_jax_import():
    """The same as text, chip_smoke.py included (it cannot be imported
    here: it stops without a CUDA device)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|"
                     r"point_cloud_reid_tpu)\b", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "point_cloud_reid_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 50
    for path in files:
        with open(path) as f:
            hit = pat.search(f.read())
        assert hit is None, (path, hit.group(0))


_READ_JAX_STORE = """
import json, sys
from point_cloud_reid_tpu_torch import data, native
from point_cloud_reid_tpu_torch.tools import test, train
from point_cloud_reid_tpu_torch.configs import get_experiment
root = sys.argv[1]
store = data.CropStore(root)
complete = data.CompleteStore(root)
spec = get_experiment('pts_point-transformer_point-cat_nus_det_4x256_500e')
ds = data.build_pair_dataset(dict(spec['dataset']['val'],
                                  subsample_sparse=16), store, complete)
batch = next(iter(data.BatchLoader(ds, 8, shuffle=False)))
print(json.dumps(dict(
    records=type(next(iter(store.objects.values()))).__module__,
    n=len(store.objects), native=native.available(),
    batch=list(batch['sparse_1'].shape), jax='jax' in sys.modules,
    jax_pkg=any(m == 'point_cloud_reid_tpu' or
                m.startswith('point_cloud_reid_tpu.') for m in sys.modules))))
"""


def test_reading_a_store_the_jax_package_wrote_imports_no_jax(tmp_path):
    """The port's data, native loader and data CLIs, reading a store whose
    objects.pkl names the JAX package's ObjectRecord, in a fresh
    interpreter: neither jax nor the JAX package is imported."""
    from point_cloud_reid_tpu.data import SyntheticStore
    SyntheticStore(num_objects=20, seed=1, class_names=[
        "car", "truck", "pedestrian"]).save(str(tmp_path))
    with open(tmp_path / "objects.pkl", "rb") as f:
        assert b"point_cloud_reid_tpu.data.store" in f.read()
    proc = subprocess.run([sys.executable, "-c", _READ_JAX_STORE,
                           str(tmp_path)], cwd=REPO, env=ENV,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == dict(records="point_cloud_reid_tpu_torch.data.store", n=20,
                       native=True, batch=[8, 16, 3], jax=False,
                       jax_pkg=False)


def test_cpu_wrappers_never_touch_the_cuda_library():
    out = _run(_CPU_PATH)
    assert out == dict(loaded=False, launches=[0] * 8)


@pytest.mark.parametrize("argv", [
    ["-m", "point_cloud_reid_tpu_torch.tools.train", FLAGSHIP, "--epochs",
     "1"],
    ["-m", "point_cloud_reid_tpu_torch.tools.profile_train", "--batch", "4"],
    ["-m", "point_cloud_reid_tpu_torch.tools.track", "--frames", "1"],
    ["-m", "point_cloud_reid_tpu_torch.tools.profile_tracker"],
    ["chip_smoke.py"],
    ["-m", "point_cloud_reid_tpu_torch.tools.track", "--image", "--frames",
     "1"],
    ["-m", "point_cloud_reid_tpu_torch.tools.profile_tracker", "--image"],
    ["-m", "point_cloud_reid_tpu_torch.tools.test", "testing_" + FLAGSHIP],
    ["-m", "point_cloud_reid_tpu_torch.tools.train", FLAGSHIP, "--root",
     "no-such-store"],
    ["-m", "point_cloud_reid_tpu_torch.tools.profile_loader", "--root",
     "no-such-store"],
    ["-m", "point_cloud_reid_tpu_torch.tools.track", "--bf16", "--frames",
     "1"],
    ["-m", "point_cloud_reid_tpu_torch.tools.track", "--image", "--bf16",
     "--frames", "1"],
    ["-m", "point_cloud_reid_tpu_torch.tools.train",
     "rgb_deit-tiny_point-cat_r_nus_det_4x60_200e", "--bf16", "--remat",
     "--epochs", "1"],
    ["-m", "point_cloud_reid_tpu_torch.tools.test", "testing_" + FLAGSHIP,
     "--bf16"],
    ["-m", "point_cloud_reid_tpu_torch.tools.profile_train", "--bf16",
     "--experiment", "rgb_deit-tiny_point-cat_r_nus_det_4x60_200e"],
    ["-m", "point_cloud_reid_tpu_torch.tools.parity_eval",
     "testing_" + FLAGSHIP, "--pth", "no-such-file.pth"],
], ids=["train", "profile_train", "track", "profile_tracker", "chip_smoke",
        "track_image", "profile_tracker_image", "test", "train_root",
        "profile_loader", "track_bf16", "track_image_bf16",
        "train_image_bf16", "test_bf16", "profile_train_image_bf16",
        "parity_eval"])
def test_entry_points_default_to_cuda_and_stop_without_a_card(argv):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    env = dict(ENV, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "cuda" in proc.stderr.lower()
    assert '"ok"' not in proc.stdout
