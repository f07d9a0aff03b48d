"""The port's data pipeline (point_cloud_reid_tpu_torch.data) against the JAX
package's on the same inputs: stores, density buckets, samplers, the
BatchLoader, the importer and the image batch reads. The modules are copies
(numpy only), so everything is held equal bit for bit."""
import dataclasses
import json
import os
import pickle

import numpy as np
import pytest

pytest.importorskip("torch")

from point_cloud_reid_tpu import data as jd  # noqa: E402
from point_cloud_reid_tpu.data import import_reference as jir  # noqa: E402
from point_cloud_reid_tpu.data import store as jstore  # noqa: E402
from point_cloud_reid_tpu_torch import data as td  # noqa: E402
from point_cloud_reid_tpu_torch.data import import_reference as tir  # noqa: E402
from point_cloud_reid_tpu_torch.data import store as tstore  # noqa: E402
from tests.test_import_reference import _make_reference_tree  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

pytestmark = pytest.mark.quick

CLASSES = ["car", "truck", "pedestrian", "bicycle"]
CLS_TO_IDX = {c: i for i, c in enumerate(CLASSES)}
TRACKING = {c: c for c in CLASSES}
SPEC = dict(classes=CLASSES, cls_to_idx=CLS_TO_IDX,
            tracking_classes=TRACKING, subsample_sparse=16,
            subsample_dense=24)


@pytest.fixture(autouse=True, scope="module")
def jax_native_loaded():
    """Load the JAX package's native library before its loaders run. Its
    lazy first load is not thread-safe: BatchLoader workers that race it
    read their batches through the numpy fallback, another random stream
    (ROADMAP.md §3). The port's loader builds and loads under a lock."""
    from point_cloud_reid_tpu import native as jnative
    assert jnative.available()


def assert_same(a, b, what=""):
    """Equal bit for bit: arrays (values, dtype, shape), dicts, lists and
    scalars, recursively."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (what, a.keys(),
                                                          b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what
    else:
        assert type(a) is type(b) and a == b, (what, a, b)


def records(store) -> dict:
    return {k: dataclasses.asdict(r) for k, r in store.objects.items()}


def stores(tmp_path, name: str = "store", **kw):
    """(port CropStore, JAX CropStore) over one on-disk synthetic store
    written by the port."""
    root = str(tmp_path / name)
    td.SyntheticStore(**kw).save(root)
    return td.CropStore(root), jd.CropStore(root)


# ---- stores ------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(num_objects=12, seed=1),
    dict(num_objects=9, frames_per_obj=3, seed=2, with_images=True,
         crop_size=(8, 8), class_names=CLASSES),
    dict(num_objects=30, seed=3, metadata_only=True, fp_fraction=0.5),
], ids=["points", "images", "metadata_only"])
def test_synthetic_store_equal(kw):
    t, j = td.SyntheticStore(**kw), jd.SyntheticStore(**kw)
    assert records(t) == records(j)
    assert t.token_to_int == j.token_to_int
    assert_same(t._points, j._points, "points")
    assert_same(t._images, j._images, "images")
    assert_same(t._complete, j._complete, "complete")
    tok = next(iter(t.objects))
    assert t.frame_index() == j.frame_index()
    assert_same(t.load_image(tok, "0"), j.load_image(tok, "0"))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_saved_by_either_package_reads_in_the_other(tmp_path, writer):
    kw = dict(num_objects=10, frames_per_obj=3, seed=4, with_images=True,
              crop_size=(6, 6))
    t_root, j_root = str(tmp_path / "t"), str(tmp_path / "j")
    td.SyntheticStore(**kw).save(t_root)
    jd.SyntheticStore(**kw).save(j_root)
    # the same files, objects.pkl included: the port writes the JAX format
    for dirpath, _, names in os.walk(j_root):
        for n in names:
            jp = os.path.join(dirpath, n)
            tp = os.path.join(t_root, os.path.relpath(jp, j_root))
            with open(jp, "rb") as f, open(tp, "rb") as g:
                assert f.read() == g.read(), jp
    root = t_root if writer == "port" else j_root
    t, j = td.CropStore(root, crop_size=(6, 6)), jd.CropStore(
        root, crop_size=(6, 6))
    assert type(next(iter(t.objects.values()))) is tstore.ObjectRecord
    assert type(next(iter(j.objects.values()))) is jstore.ObjectRecord
    assert records(t) == records(j)
    assert t.token_to_int == j.token_to_int
    assert t.frame_index() == j.frame_index()
    for tok, frames in t.frame_index().items():
        for f in frames:
            assert_same(t.load_points(tok, f), j.load_points(tok, f))
            assert_same(t.load_image(tok, f), j.load_image(tok, f))
    tc, jc = td.CompleteStore(root), jd.CompleteStore(root)
    for tok in t.objects:
        assert_same(tc.load_complete(tok), jc.load_complete(tok))


def test_store_pre_schema_records_and_token_map(tmp_path):
    """Records pickled before `distance` / `crop_size` existed get the same
    fix-ups, and a staged token_to_int.pkl is read and checked the same."""
    root = str(tmp_path / "old")
    td.SyntheticStore(num_objects=6, frames_per_obj=3, seed=5).save(root)
    recs = jstore.CropStore(root).objects
    for r in recs.values():
        del r.distance, r.crop_size
    with open(os.path.join(root, "objects.pkl"), "wb") as f:
        pickle.dump(list(recs.values()), f)
    assert records(td.CropStore(root)) == records(jd.CropStore(root))
    assert all(r.distance == {} and r.crop_size is None
               for r in td.CropStore(root).objects.values())
    toks = sorted(t for t in recs if not t.startswith("FP"))
    with open(os.path.join(root, "token_to_int.pkl"), "wb") as f:
        pickle.dump({t: 100 + i for i, t in enumerate(toks[1:])}, f)
    for cls in (td.CropStore, jd.CropStore):
        with pytest.raises(ValueError, match="missing 1 TP object token"):
            cls(root)
    with open(os.path.join(root, "token_to_int.pkl"), "wb") as f:
        pickle.dump({t: 100 + i for i, t in enumerate(toks)}, f)
    assert td.CropStore(root).token_to_int == jd.CropStore(root).token_to_int


# ---- buckets -----------------------------------------------------------------

def test_density_buckets_equal():
    store = jd.SyntheticStore(num_objects=40, seed=6, metadata_only=True)
    frames = store.frame_index()
    num_pts = {k: r.num_pts for k, r in store.objects.items()}
    class_of = {k: ("FP_" if r.is_fp else "") + r.class_name
                for k, r in store.objects.items()}
    t = td.DensityBuckets(frames, num_pts, class_of)
    j = jd.DensityBuckets(frames, num_pts, class_of)
    assert t.obj_buckets == j.obj_buckets
    assert t.class_buckets == j.class_buckets
    assert_same(t.distribution, j.distribution)
    assert td.POW2_BUCKETS == jd.POW2_BUCKETS
    for n in (0, 1, 2, 3, 127, 128, 2 ** 25):
        assert td.buckets.bucket_of(n) == jd.buckets.bucket_of(n)
    rt, rj = np.random.RandomState(0), np.random.RandomState(0)
    for obj in list(frames)[:12]:
        for d in (0, 3, 6, 19):
            assert (t.nearest_nonempty_bucket(obj, d)
                    == j.nearest_nonempty_bucket(obj, d))
            assert (t.random_frame_in_bucket(rt, obj, d)
                    == j.random_frame_in_bucket(rj, obj, d))
        assert t.sample_density(rt, obj) == j.sample_density(rj, obj)
    for ck in t.class_buckets:
        for d in (0, 4, 9, 19):
            assert (t.class_list_at_density(ck, d)
                    == j.class_list_at_density(ck, d))
    rs = np.random.RandomState(1)
    pc = rs.randn(40, 4).astype(np.float32)
    for n in (0, 16, 40):
        for src in (pc, pc[:2]):
            assert_same(td.subsample_pc_np(np.random.RandomState(3), src, n),
                        jd.subsample_pc_np(np.random.RandomState(3), src, n))


# ---- samplers ----------------------------------------------------------------

def _pair(tmp_path, cls_name, on_disk, **kw):
    """(port dataset, JAX dataset) of the same class over the same store."""
    skw = dict(num_objects=36, frames_per_obj=5, seed=7, class_names=CLASSES)
    if on_disk:
        ts, js = stores(tmp_path, **skw)
    else:
        ts, js = td.SyntheticStore(**skw), jd.SyntheticStore(**skw)
    args = dict(SPEC, **kw)
    return (getattr(td, cls_name)(store=ts, complete_store=ts if not on_disk
                                  else None, **args),
            getattr(jd, cls_name)(store=js, complete_store=js if not on_disk
                                  else None, **args))


@pytest.mark.parametrize("on_disk", [False, True], ids=["memory", "disk"])
def test_pair_dataset_plan_sample_and_batch_two_epochs(tmp_path, on_disk):
    t, j = _pair(tmp_path, "PairDataset", on_disk, seed=3,
                 with_dense=not on_disk)
    assert len(t) == len(j) > 16
    assert t.tp_tokens == j.tp_tokens and t.fp_tokens == j.fp_tokens
    assert_same(t.tp_labels, j.tp_labels)
    idx = list(range(len(t))) + [0, 5, 5]
    for epoch in (0, 1):
        t.set_epoch(epoch, seed=9)
        j.set_epoch(epoch, seed=9)
        assert_same(t.plan_batch(idx), j.plan_batch(idx), f"plan{epoch}")
        for i in idx[:12]:
            assert_same(t.sample(i), j.sample(i), f"sample{epoch}.{i}")
        assert t.supports_batch_load == j.supports_batch_load == on_disk
        if on_disk:
            assert_same(t.sample_batch(idx), j.sample_batch(idx),
                        f"batch{epoch}")


def test_val_even_pairs_and_artifact_round_trip(tmp_path):
    t, j = _pair(tmp_path, "ValEvenPairs", True, max_combinations=4,
                 validation_seed=5)
    assert t.dump_pairs() == j.dump_pairs()
    assert len(t) == len(j) > 40
    idx = np.arange(len(t))
    assert_same(t.plan_batch(idx), j.plan_batch(idx))
    assert_same(t.sample_batch(idx[:24]), j.sample_batch(idx[:24]))
    for i in (0, 7, len(t) - 1):
        assert_same(t.sample(i), j.sample(i))
    art = json.loads(json.dumps(t.dump_pairs(), default=str))
    common = dict(SPEC, store=t.store, validation_seed=5)
    back = td.ValEvenPairs.from_artifact(art, **common)
    jback = jd.ValEvenPairs.from_artifact(art, **dict(common, store=j.store))
    assert back.dump_pairs() == jback.dump_pairs() == t.dump_pairs()
    assert_same(back.sample_batch(idx[:24]), t.sample_batch(idx[:24]))


def _err_file(tmp_path, store) -> str:
    toks = [t for t, r in store.objects.items() if not r.is_fp]
    frames = store.filtered_frames(store.objects[toks[0]])
    err = {"car": {"0.5": {
        "positives": [
            {"prev_sample_token": frames[0], "curr_sample_token": frames[1],
             "object_token": toks[0]},
            {"prev_sample_token": "nope", "curr_sample_token": frames[1],
             "object_token": toks[0]}],
        "negatives": [
            {"prev_sample_token": frames[0], "curr_sample_token": frames[1],
             "prev_object_token": toks[0], "curr_object_token": toks[1]}]}}}
    path = str(tmp_path / "errors.json")
    with open(path, "w") as f:
        json.dump(err, f)
    return path


@pytest.mark.parametrize("kind", [
    "train", "val", "class_balanced", "concat", "repeat", "val_err"])
def test_build_pair_dataset_specs(tmp_path, kind):
    from point_cloud_reid_tpu_torch.configs.datasets import nuscenes_pts
    ts, js = stores(tmp_path, num_objects=40, frames_per_obj=5, seed=8,
                    class_names=["car", "truck", "pedestrian"])
    spec = nuscenes_pts(subsample_sparse=16)
    train, val = spec["train"], dict(spec["val"], max_combinations=3)
    cfg = dict(train=train, val=val,
               class_balanced=dict(train, class_balanced=True,
                                   oversample_thr=0.6),
               concat=[train, dict(train, seed=4), val],
               repeat=dict(type="repeat", dataset=train, times=3),
               val_err=dict(val, err_filepath=_err_file(tmp_path, ts)))[kind]
    t = td.build_pair_dataset(cfg, ts)
    j = jd.build_pair_dataset(cfg, js)
    assert type(t).__name__ == type(j).__name__
    assert len(t) == len(j) > 0
    if kind == "val_err":
        assert t.val_positives == j.val_positives and len(t) == 2
        tes = td.TrackingErrorsSampler(cfg["err_filepath"])
        jes = jd.TrackingErrorsSampler(cfg["err_filepath"])
        assert tes.classes == jes.classes
        assert tes.get_positives() == jes.get_positives()
        assert tes.get_negatives() == jes.get_negatives()
    if kind == "class_balanced":
        assert_same(t.indices, j.indices)
    idx = [int(i) for i in np.random.RandomState(0).permutation(len(t))[:20]]
    for epoch in (0, 2):
        t.set_epoch(epoch, seed=1)
        j.set_epoch(epoch, seed=1)
        assert t.supports_batch_load and j.supports_batch_load
        assert_same(t.sample_batch(idx), j.sample_batch(idx), kind)
        for i in idx[:4]:
            assert_same(t.sample(i), j.sample(i), kind)


# ---- BatchLoader -------------------------------------------------------------

class _Failing:
    """A dataset whose sample_batch raises on the batch holding index 9."""

    supports_batch_load = True

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def sample_batch(self, idx):
        if 9 in list(idx):
            raise KeyError("index 9")
        return self.ds.sample_batch(idx)


@pytest.mark.parametrize("case", ["shuffle", "in_order_ragged", "shard0",
                                  "shard1", "transform", "worker_error"])
def test_batch_loader_sequence(tmp_path, case):
    t, j = _pair(tmp_path, "PairDataset", True)
    kw = dict(batch_size=6, seed=11, num_threads=3, prefetch=2)
    kw.update(dict(shuffle=dict(shuffle=True),
                   in_order_ragged=dict(shuffle=False, drop_last=False),
                   shard0=dict(num_shards=2, shard_id=0),
                   shard1=dict(num_shards=2, shard_id=1),
                   transform=dict(transform=lambda b: dict(
                       b, twice=b["sparse_1"] * 2)),
                   worker_error=dict(shuffle=False)).get(case, {}))
    if case == "worker_error":
        t, j = _Failing(t), _Failing(j)
    tl, jl = td.BatchLoader(t, **kw), jd.BatchLoader(j, **kw)
    assert len(tl) == len(jl) > 2
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        if case == "worker_error":
            for loader in (tl, jl):
                with pytest.raises(KeyError, match="index 9"):
                    list(loader)
            continue
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        assert_same(got, want, f"epoch{epoch}")
        if case == "in_order_ragged":
            assert len(got[-1]["id_1"]) == len(t) % 6
        if case.startswith("shard"):
            assert all(len(b["id_1"]) == 3 for b in got)


# ---- importer ----------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["nuscenes", "waymo"])
def test_import_reference_store_equal(tmp_path, dataset):
    rng = np.random.RandomState(11)
    root = str(tmp_path / "export")
    metadata = _make_reference_tree(root, rng, dataset=dataset)
    toks = sorted(k for k in metadata["obj_infos"] if not k.startswith("FP"))
    map_path = str(tmp_path / "instance_token_to_id.pkl")
    with open(map_path, "wb") as f:
        pickle.dump({t: 500 + i for i, t in enumerate(toks)}, f)
    meta = os.path.join(root, "metadata", "metadata.pkl")
    assert_same(tir.load_metadata(os.path.join(root, "metadata")),
                jir.load_metadata(meta))
    kept = tir.filter_by_scene_ids(metadata, ["scene0"])
    assert kept == jir.filter_by_scene_ids(metadata, ["scene0"])
    out = {}
    for name, mod in (("port", tir), ("jax", jir)):
        path, stats = mod.import_reference_store(
            metadata_path=meta, data_root=root, dataset=dataset,
            instance_token_to_id_path=map_path, verify_crops=True,
            out_name=f"objects_{name}.pkl")
        with open(path, "rb") as f:
            out[name] = (f.read(), stats)
    assert out["port"] == out["jax"]          # the same bytes and stats
    os.replace(os.path.join(root, "objects_port.pkl"),
               os.path.join(root, "objects.pkl"))
    t = td.CropStore(root, filter_mode="pts and vis")
    j = jd.CropStore(root, filter_mode="pts and vis")
    assert records(t) == records(j)
    assert t.token_to_int == j.token_to_int
    assert t.frame_index() == j.frame_index()
    frame = t.filtered_frames(t.objects[toks[0]])[0]
    os.remove(t.points_path(toks[0], frame))
    for mod in (tir, jir):
        with pytest.raises(FileNotFoundError, match="1 crop files"):
            mod.import_reference_store(metadata_path=meta, data_root=root,
                                       dataset=dataset, verify_crops=True)


# ---- image batches -----------------------------------------------------------

@pytest.mark.parametrize("stored,loader", [(8, 8), (12, 8), (5, 8)],
                         ids=["same", "oversize", "undersize"])
def test_load_image_batch_equal(tmp_path, stored, loader):
    root = str(tmp_path / "img")
    td.SyntheticStore(num_objects=16, frames_per_obj=4, seed=12,
                      with_images=True, crop_size=(stored, stored),
                      class_names=CLASSES).save(root)
    t = td.CropStore(root, crop_size=(loader, loader))
    j = jd.CropStore(root, crop_size=(loader, loader))
    pairs = [(tok, f) for tok, fl in t.frame_index().items() for f in fl]
    gone, short = pairs[0], pairs[1]
    os.remove(os.path.join(t._frame_dir(t.objects[gone[0]], gone[1]),
                           "img_crop.bin"))
    path = os.path.join(t._frame_dir(t.objects[short[0]], short[1]),
                        "img_crop.bin")
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)
    if stored < loader:
        for store in (t, j):
            with pytest.raises(ValueError, match="smaller than loader"):
                store.load_image_batch(pairs)
        pairs = [gone, short]           # missing and short: zeros, no raise
    got, want = t.load_image_batch(pairs), j.load_image_batch(pairs)
    assert_same(got, want)
    assert got[1][0] == got[1][1] == -1 and not got[0][:2].any()
    # image-mode pair batches through the samplers
    ds = [mod.PairDataset(store=s, mode="image", seed=2, **SPEC)
          for mod, s in ((td, t), (jd, j))]
    idx = list(range(min(8, len(ds[0]))))
    if stored >= loader:
        assert_same(ds[0].sample_batch(idx), ds[1].sample_batch(idx))
        assert_same(ds[0].sample(1), ds[1].sample(1))
