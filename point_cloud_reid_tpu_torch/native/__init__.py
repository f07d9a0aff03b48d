"""ctypes binding of the native crop-store batch loader (crop_loader.cpp).

At first use, crop_loader.cpp (a copy of the JAX package's) is compiled with

    g++ -O3 -std=c++17 -fPIC -Wall -pthread -shared

into build/native-<hash of the source and flags>/libpcrloader.so at the
root of the checkout (build/ is git-ignored) and loaded with ctypes. Nothing
is built when the package is imported, and nothing is built beside the
source. A failed build raises with the compiler's output: unlike the JAX
binding, there is no numpy fallback, whose RandomState stream would change
which points every batch trains on. native/plain.py reproduces the
library's output bit for bit in numpy; the tests hold the two together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "crop_loader.cpp"
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: name -> argtypes (restype int)
_SIGNATURES = {
    # paths (char**), batch, k, seeds, out, counts, min_points, nthreads
    "pcr_load_point_batch": [_P, _I, _I, _P, _P, _P, _I, _I],
    # paths (batch x stride chars), stride, batch, k, seeds, out, counts,
    # min_points, nthreads
    "pcr_load_point_batch_strided": [_P, ctypes.c_long, _I, _I, _P, _P, _P,
                                     _I, _I],
    # paths (char**), batch, elems, out, ok, nthreads
    "pcr_load_blob_batch": [_P, _I, ctypes.c_long, _P, _P, _I],
}


class Loader:
    """The shared library built from `source` (by default crop_loader.cpp
    beside this file) and loaded once per process at first use."""

    def __init__(self, source=None):
        self.source = Path(source).resolve() if source else _SOURCE
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ""

    def out_dir(self) -> Path:
        """build/native-<hash of the source and the flags>."""
        digest = hashlib.sha256(self.source.read_bytes())
        digest.update(" ".join(_CXX_FLAGS).encode())
        return _BUILD_ROOT / f"native-{digest.hexdigest()[:16]}"

    def build(self) -> Path:
        """Compile the library unless this source's build exists; returns
        its path. Raises RuntimeError with the compiler's output."""
        out_dir = self.out_dir()
        lib_path = out_dir / "libpcrloader.so"
        if lib_path.exists():
            return lib_path
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the native crop loader cannot "
                               "be built")
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libpcrloader.{os.getpid()}.so"
        proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", str(tmp),
                               str(self.source)],
                              capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on "
                               f"{self.source}:\n{self.build_log[-8000:]}")
        os.replace(tmp, lib_path)
        return lib_path

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LOADER = Loader()


def available() -> bool:
    """True when the library builds and loads (building it if need be);
    False when it cannot, and then every loader below raises."""
    try:
        LOADER.get()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _seeds(seeds, B: int) -> np.ndarray:
    if isinstance(seeds, np.ndarray) and seeds.dtype == np.uint64:
        s = np.ascontiguousarray(seeds)
    else:
        s = np.asarray([int(x) & (2 ** 64 - 1) for x in seeds],
                       dtype=np.uint64)
    if s.shape != (B,):
        raise ValueError(f"want {B} seeds, got {s.shape}")
    return s


def _check(k: int, min_points: int) -> None:
    # a crop below min_points loads as zeros; with min_points 0 an empty
    # file would be drawn from
    if k < 0 or min_points < 1:
        raise ValueError(f"want k >= 0 and min_points >= 1, got {k}, "
                         f"{min_points}")


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def load_point_batch(paths: Sequence[str], k: int, seeds: Sequence[int],
                     min_points: int = 3, nthreads: int = 8
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Read B pts_xyz.bin files and resample each to (k, 3) with replacement
    from the item's splitmix64 stream.

    Returns (batch (B, k, 3) float32, counts (B,) int32): a file's point
    count, -1 for a missing file; fewer than min_points load as zeros."""
    _check(k, min_points)
    lib = LOADER.get()
    B = len(paths)
    seeds_arr = _seeds(seeds, B)
    out = np.zeros((B, k, 3), np.float32)
    counts = np.zeros((B,), np.int32)
    arr = _paths_array(paths)
    lib.pcr_load_point_batch(ctypes.addressof(arr), B, k, _ptr(seeds_arr),
                             _ptr(out), _ptr(counts), min_points, nthreads)
    return out, counts


def load_point_batch_strided(paths: np.ndarray, k: int,
                             seeds: Sequence[int], min_points: int = 3,
                             nthreads: int = 8
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """load_point_batch over a (B,) fixed-width bytes array ('S<w>') of
    NUL-terminated paths (each at most w - 1 bytes), the layout a gather
    from the samplers' path table gives: no Python object per item."""
    paths = np.ascontiguousarray(paths)
    B = len(paths)
    if paths.dtype.kind != "S" or paths.ndim != 1:
        raise ValueError(f"want a (B,) bytes array, got {paths.dtype} "
                         f"{paths.shape}")
    width = paths.dtype.itemsize
    if B and paths.view(np.uint8).reshape(B, width)[:, -1].any():
        raise ValueError("every path must end in a NUL byte inside its row")
    _check(k, min_points)
    lib = LOADER.get()
    seeds_arr = _seeds(seeds, B)
    out = np.zeros((B, k, 3), np.float32)
    counts = np.zeros((B,), np.int32)
    lib.pcr_load_point_batch_strided(
        _ptr(paths), width, B, k, _ptr(seeds_arr), _ptr(out), _ptr(counts),
        min_points, nthreads)
    return out, counts


def load_blob_batch(paths: Sequence[str], shape: Tuple[int, ...],
                    nthreads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Read B fixed-size float32 blobs (img_crop.bin); a missing or short
    file loads as zeros.

    Returns (batch (B, *shape) float32, ok (B,) int32 1 / -1)."""
    lib = LOADER.get()
    B = len(paths)
    elems = int(np.prod(shape))
    out = np.zeros((B,) + tuple(shape), np.float32)
    ok = np.zeros((B,), np.int32)
    arr = _paths_array(paths)
    lib.pcr_load_blob_batch(ctypes.addressof(arr), B, elems, _ptr(out),
                            _ptr(ok), nthreads)
    return out, ok
