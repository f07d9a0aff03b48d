"""Build and load the CUDA kernels of csrc/ (nvcc + a plain C interface).

At first use, every csrc/*.cu is compiled to an object file with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
         -Xcompiler -fPIC

(one nvcc per source, all started together), and the objects are linked
into build/kernels-<hash of the sources>/libpcr_kernels.so at the root of
the checkout (build/ is git-ignored), then loaded with ctypes. Nothing is
compiled or loaded when the package is imported. A failed build raises.

Every C entry point takes its pointers and the CUDA stream as void* and
returns cudaGetLastError() after its launch; `check` raises on non-zero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures: name -> argtypes (restype is int, a cudaError_t)
_SIGNATURES = {
    # A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3, out, B, N, S, K, C, stream
    "pcr_sa_convmax": [_P] * 12 + [_I] * 5 + [_P],
    # the same at bf16 (csrc/sa_stage_bf16.cu)
    "pcr_sa_convmax_bf16": [_P] * 12 + [_I] * 5 + [_P],
    # C, K, the 8-value plan out (csrc/sa_stage.cu, csrc/sa_stage_bf16.cu)
    "pcr_sa_f32_layout": [_I] * 2 + [ctypes.POINTER(_L)],
    "pcr_sa_bf16_layout": [_I] * 2 + [ctypes.POINTER(_L)],
    # the wide layout (csrc/sa_wide_wg.cuh) of either dtype: A, Ct, idx, the
    # stage copies of w2 and w3, the six affines, out, scratch; B, N, S, K,
    # C, blocks, the scratch bytes a block, stream
    "pcr_sa_convmax_wide": [_P] * 13 + [_I] * 6 + [_L] + [_P],
    "pcr_sa_convmax_wide_bf16": [_P] * 13 + [_I] * 6 + [_L] + [_P],
    # 10 per-object factor pointers (track h,q,kvz,a1,pv then det), 16
    # weight pointers, t_idx, d_idx, out, nt, nd, P, N, C, H, stream
    "pcr_match_pooled": [_P] * 10 + [_P] * 16 + [_P] * 3 + [_I] * 6 + [_P],
    # the same for the image head: 8 factor pointers (h,q,kvz,a1 a side)
    "pcr_match_pooled_image": [_P] * 8 + [_P] * 16 + [_P] * 3 + [_I] * 6
                              + [_P],
    # N, C, H, out bytes, out limit
    "pcr_match_pooled_layout": [_I] * 3 + [ctypes.POINTER(_L)] * 2,
    # the three at bf16 (csrc/match_grid_bf16.cu)
    "pcr_match_pooled_bf16": [_P] * 10 + [_P] * 16 + [_P] * 3 + [_I] * 6
                             + [_P],
    "pcr_match_pooled_image_bf16": [_P] * 8 + [_P] * 16 + [_P] * 3
                                   + [_I] * 6 + [_P],
    "pcr_match_pooled_bf16_layout": [_I] * 3 + [ctypes.POINTER(_L)] * 2,
    # the first rows kernel (tier rows_mma): the point head's pointers, then
    # the scratch; nt, nd, P, N, C, H, blocks, stream
    "pcr_match_rows": [_P] * 10 + [_P] * 16 + [_P] * 4 + [_I] * 7 + [_P],
    "pcr_match_rows_layout": [_I] * 3 + [ctypes.POINTER(_L)] * 2,
    # the two at bf16 (csrc/match_rows_bf16.cu)
    "pcr_match_rows_bf16": [_P] * 10 + [_P] * 16 + [_P] * 4 + [_I] * 7 + [_P],
    "pcr_match_rows_bf16_layout": [_I] * 3 + [ctypes.POINTER(_L)] * 2,
    # the wgmma rows tier (csrc/match_rows_wg.cuh): 6 side pointers a side
    # (h, q, a1, pv, KV message stages, sum k), the weight stages, 8
    # LayerNorm vectors, t_idx, d_idx, out, scratch; nt, nd, P, N, C, H,
    # blocks, the scratch bytes a block, stream
    "pcr_match_rows_wg": [_P] * 12 + [_P] * 9 + [_P] * 4 + [_I] * 7 + [_L]
                         + [_P],
    "pcr_match_rows_wg_layout": [_I] * 3 + [ctypes.POINTER(_L)] * 2,
    "pcr_match_rows_wg_bf16": [_P] * 12 + [_P] * 9 + [_P] * 4 + [_I] * 7
                              + [_L] + [_P],
    "pcr_match_rows_wg_bf16_layout": [_I] * 3 + [ctypes.POINTER(_L)] * 2,
    # the padded layout's entry points (kernels/match_grid.pad_side): the
    # arguments above with the true channels ct after H
    "pcr_match_pooled_pad": [_P] * 10 + [_P] * 16 + [_P] * 3 + [_I] * 7
                            + [_P],
    "pcr_match_pooled_image_pad": [_P] * 8 + [_P] * 16 + [_P] * 3 + [_I] * 7
                                  + [_P],
    "pcr_match_pooled_pad_bf16": [_P] * 10 + [_P] * 16 + [_P] * 3 + [_I] * 7
                                 + [_P],
    "pcr_match_pooled_image_pad_bf16": [_P] * 8 + [_P] * 16 + [_P] * 3
                                       + [_I] * 7 + [_P],
    "pcr_match_rows_wg_pad": [_P] * 12 + [_P] * 9 + [_P] * 4 + [_I] * 8
                             + [_L] + [_P],
    "pcr_match_rows_wg_pad_bf16": [_P] * 12 + [_P] * 9 + [_P] * 4 + [_I] * 8
                                  + [_L] + [_P],
    # q, db, out (int64), B, S, N, k, stream
    "pcr_knn_i64": [_P] * 3 + [_I] * 4 + [_P],
    # the same, then the plan: tier, points, warps, smem; stream
    "pcr_knn_plan": [_P] * 3 + [_I] * 8 + [_P],
    # tier C (csrc/knn_channels.cu): q, db, out, B, S, N, C, k, channels a
    # stage, smem, bf16; stream
    "pcr_knn_channels": [_P] * 3 + [_I] * 8 + [_P],
    # q, k, v, out, B, L, S, H, D, V, 9 strides (q, k, v: batch, row, head,
    # in elements), eps, stream
    "pcr_linear_attention": [_P] * 4 + [_I] * 6 + [_L] * 9
                            + [ctypes.c_float, _P],
    # xyz, start, out, scratch, B, N, npoint, start64, then the plan: tier,
    # points, threads, clouds, smem; stream
    "pcr_fps_plan": [_P] * 4 + [_I] * 9 + [_P],
    # the same at any channel count: xyz, start, out, scratch, B, N, C,
    # npoint, start64, the plan; stream
    "pcr_fps_channels": [_P] * 4 + [_I] * 10 + [_P],
}


class Library:
    """A shared library built from `sources` (by default every csrc/*.cu)
    and loaded once per process at first use. Another set of sources, such
    as an older version of one kernel, builds into a directory of its own
    and binds the entry points it defines."""

    def __init__(self, sources=None):
        self._lock = threading.Lock()
        self._lib = None
        self._sources = sources
        self.build_log = ""

    def sources(self):
        if self._sources is not None:
            return [Path(p).resolve() for p in self._sources]
        return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))

    def _nvcc(self) -> str:
        nvcc = shutil.which("nvcc")
        if nvcc is None:
            from torch.utils.cpp_extension import CUDA_HOME
            if CUDA_HOME:
                nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        if nvcc is None or not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                               "built (set CUDA_HOME or put nvcc on PATH)")
        return nvcc

    def _build(self) -> Path:
        srcs = self.sources()
        digest = hashlib.sha256()
        for p in srcs:
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        digest.update(" ".join(_NVCC_FLAGS).encode())
        out_dir = _BUILD_ROOT / f"kernels-{digest.hexdigest()[:16]}"
        lib_path = out_dir / "libpcr_kernels.so"
        if lib_path.exists():
            log = out_dir / "build.log"
            self.build_log = log.read_text() if log.exists() else ""
            return lib_path
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = self._nvcc()
        tag = os.getpid()
        units = [p for p in srcs if p.suffix == ".cu"]
        objs = [out_dir / f"{p.stem}.{tag}.o" for p in units]
        procs = [subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-c", "-o", str(o), str(p)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for o, p in zip(objs, units)]
        logs = [proc.communicate()[0] for proc in procs]
        self.build_log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n"
                               + self.build_log[-8000:])
        tmp = out_dir / f"libpcr_kernels.{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs]],
            capture_output=True, text=True)
        self.build_log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               + self.build_log[-8000:])
        for o in objs:
            o.unlink()
        (out_dir / "build.log").write_text(self.build_log)
        os.replace(tmp, lib_path)
        return lib_path

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self._build()))
                for name, argtypes in _SIGNATURES.items():
                    if self._sources is not None and not hasattr(lib, name):
                        continue
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARY = Library()


def ptxas_usage(log: str) -> dict:
    """ptxas's account of each kernel in a build log (nvcc -Xptxas -v):
    mangled entry name -> dict(registers, stack, spill_stores,
    spill_loads), in bytes but registers."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = dict(registers=0, stack=0, spill_stores=0,
                              spill_loads=0)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[entry].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
    return out


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
