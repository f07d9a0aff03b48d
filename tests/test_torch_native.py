"""The port's native crop loader (point_cloud_reid_tpu_torch.native): built
with g++ from the port's copy of crop_loader.cpp under build/, its output
equal to the JAX package's library and to the plain numpy version on the
same files and seeds, missing and short files handled as in JAX, and a
failed build raising instead of falling back."""
import shutil
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from point_cloud_reid_tpu import native as jnative  # noqa: E402
from point_cloud_reid_tpu_torch import native  # noqa: E402
from point_cloud_reid_tpu_torch.native import plain  # noqa: E402
from tests._torch_threads import few_threads  # noqa: E402,F401

pytestmark = pytest.mark.quick

REPO = Path(__file__).resolve().parent.parent
SIZES = (10, 3, 2, 1, 0, 500, 128, 1000)


@pytest.fixture(scope="module")
def crop_files(tmp_path_factory):
    """Crops of SIZES points, a file whose size is no multiple of 12 (a
    short last point), and a path that does not exist."""
    d = tmp_path_factory.mktemp("crops")
    rng = np.random.RandomState(0)
    paths = []
    for i, n in enumerate(SIZES):
        p = str(d / f"c{i}_pts_xyz.bin")
        rng.randn(n, 3).astype(np.float32).tofile(p)
        paths.append(p)
    short = str(d / "short_pts_xyz.bin")
    with open(short, "wb") as f:
        f.write(rng.randn(7).astype(np.float32).tobytes()[:26])
    return paths + [short, str(d / "missing_pts_xyz.bin")]


def test_library_is_built_from_the_port_copy_under_build():
    path = native.LOADER.build()
    assert path.parent.parent == REPO / "build"
    assert path.parent.name.startswith("native-") and path.exists()
    src = REPO / "point_cloud_reid_tpu_torch" / "native" / "crop_loader.cpp"
    assert native.LOADER.source == src
    assert not list(src.parent.glob("*.so"))
    assert native.available()
    # the same entry points as the JAX package's source
    jsrc = (REPO / "point_cloud_reid_tpu" / "native" /
            "crop_loader.cpp").read_text()
    for name in native._SIGNATURES:
        assert f" {name}(" in jsrc and f" {name}(" in src.read_text()


@pytest.mark.parametrize("k,min_points,seeds", [
    (16, 3, "range"), (128, 3, "wide"), (64, 1, "wide"), (7, 4, "range")])
def test_point_batch_equals_jax_and_plain(crop_files, k, min_points, seeds):
    B = len(crop_files)
    seeds = (list(range(B)) if seeds == "range" else
             [(0x9E3779B97F4A7C15 * (i + 1)) % 2 ** 64 for i in range(B)])
    got = native.load_point_batch(crop_files, k, seeds, min_points)
    want = jnative.load_point_batch(crop_files, k, seeds, min_points)
    ref = plain.load_point_batch(crop_files, k, seeds, min_points)
    for a, b, c in zip(got, want, ref):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    counts = got[1].tolist()
    assert counts == list(SIZES) + [2, -1]
    for b, n in enumerate(counts):
        assert got[0][b].any() == (n >= min_points and n > 0)
    rows = np.array([p.encode() for p in crop_files])
    rows = rows.astype(f"S{rows.dtype.itemsize + 1}")
    strided = native.load_point_batch_strided(rows, k,
                                              np.asarray(seeds, np.uint64),
                                              min_points)
    jstrided = jnative.load_point_batch_strided(rows, k, seeds, min_points)
    for a, b, c in zip(strided, got, jstrided):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_point_batch_every_small_count(tmp_path):
    """Every point count from 3 to 130 (each bound of the bounded draw)
    and a few large ones, against the plain version."""
    rng = np.random.RandomState(3)
    paths = []
    for n in list(range(3, 131)) + [4097, 65536]:
        p = str(tmp_path / f"n{n}.bin")
        rng.randn(n, 3).astype(np.float32).tofile(p)
        paths.append(p)
    seeds = [int(s) for s in rng.randint(0, 2 ** 62, len(paths))]
    got = native.load_point_batch(paths, 48, seeds)
    ref = plain.load_point_batch(paths, 48, seeds)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert set(plain.bounded_draws(3, 5, 200)) == set(range(5))


@pytest.mark.parametrize("shape", [(3, 4, 4), (10, 3)])
def test_blob_batch_equals_jax_and_plain(crop_files, tmp_path, shape):
    img = np.random.RandomState(1).randn(*shape).astype(np.float32)
    good = str(tmp_path / "img_crop.bin")
    img.tofile(good)
    paths = [good, crop_files[0], crop_files[-1], crop_files[-2]]
    got = native.load_blob_batch(paths, shape)
    for other in (jnative.load_blob_batch(paths, shape),
                  plain.load_blob_batch(paths, shape)):
        for a, b in zip(got, other):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0][0], img)
    want_ok = [1, 1 if np.prod(shape) == 30 else -1, -1, -1]
    assert got[1].tolist() == want_ok


def test_first_load_from_many_threads(crop_files, monkeypatch):
    """Sixteen threads make the library's first load and their first batch
    at once (the BatchLoader's workers do): every batch is the library's
    stream, none a fallback's."""
    import sys
    import threading
    monkeypatch.setattr(native, "LOADER", native.Loader())
    want = plain.load_point_batch(crop_files, 32, range(len(crop_files)))
    got = [None] * 16
    start = threading.Barrier(16)

    def work(i):
        start.wait()
        got[i] = native.load_point_batch(crop_files, 32,
                                         range(len(crop_files)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for out in got:
        np.testing.assert_array_equal(out[0], want[0])
        np.testing.assert_array_equal(out[1], want[1])


def test_cropstore_batches_equal_jax(tmp_path):
    from point_cloud_reid_tpu.data import CropStore as JCropStore
    from point_cloud_reid_tpu_torch.data import CropStore, SyntheticStore
    SyntheticStore(num_objects=8, frames_per_obj=3, seed=2).save(
        str(tmp_path))
    t, j = CropStore(str(tmp_path)), JCropStore(str(tmp_path))
    pairs = [(tok, f) for tok, fl in t.frame_index().items() for f in fl]
    seeds = list(range(100, 100 + len(pairs)))
    for a, b in zip(t.load_point_batch(pairs, 32, seeds),
                    j.load_point_batch(pairs, 32, seeds)):
        np.testing.assert_array_equal(a, b)


def test_failed_build_raises_and_nothing_falls_back(tmp_path, monkeypatch,
                                                    crop_files):
    broken = tmp_path / "crop_loader.cpp"
    shutil.copy(native.LOADER.source, broken)
    with open(broken, "a") as f:
        f.write("\nint this_does_not_compile( {\n")
    loader = native.Loader(broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        loader.get()
    assert "error" in str(err.value)
    assert not (loader.out_dir() / "libpcrloader.so").exists()
    monkeypatch.setattr(native, "LOADER", loader)
    assert not native.available()
    for call in (lambda: native.load_point_batch(crop_files, 8, range(10)),
                 lambda: native.load_blob_batch(crop_files, (3,))):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()
    other = tmp_path / "other.cpp"
    other.write_text("int unbuilt_source;\n")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.Loader(other).build()


def test_inputs_are_checked_before_the_call(crop_files):
    rows = np.array([p.encode() for p in crop_files])   # no NUL in the row
    longest = int(np.argmax([len(p) for p in crop_files]))
    with pytest.raises(ValueError, match="NUL"):
        native.load_point_batch_strided(rows[longest:longest + 1], 8, [0])
    with pytest.raises(ValueError, match="seeds"):
        native.load_point_batch(crop_files, 8, [1, 2])
    with pytest.raises(ValueError, match="min_points"):
        native.load_point_batch(crop_files, 8, range(len(crop_files)), 0)
    with pytest.raises(ValueError, match="bytes array"):
        native.load_point_batch_strided(np.zeros(3), 8, [0, 1, 2])
