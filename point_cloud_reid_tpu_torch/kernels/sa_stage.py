"""Eval-mode SA stage: gather + edge-MLP + max over neighbours.

Port of point_cloud_reid_tpu/ops/pallas/sa_stage.py. `fused_sa_convmax`
launches the CUDA kernel of csrc/sa_stage.cu (its two products on the tensor
cores in three TF32 passes) on CUDA tensors and runs its
plain PyTorch version, `sa_convmax_reference`, on CPU tensors; any other
device raises. `sa_stage_inference` folds BatchNorm into per-channel affines
exactly as the JAX wrapper does (conv1's bias enters Ct through
conv1_edge_factors; conv2/conv3's biases enter t2/t3) and calls it.

Under a bf16 model (the JAX kernel with A and Ct in the model dtype) A, Ct
and the output are bf16 and the weights and affines float32; each product
multiplies bf16-rounded operands with float32 accumulation. On CUDA that is
csrc/sa_stage_bf16.cu (one mma.sync bf16 pass a product; the wrapper
converts w2 and w3 to bf16 once per weight tensor, utils/cache.py); its
launches count in `fused_sa_convmax.bf16_launches`, the float32 kernel's in
`fused_sa_convmax.launches`.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from ..ops.geometry import conv1_edge_factors
from ..utils.cache import derived
from . import _lib

BF16 = torch.bfloat16
# where the SA kernels' missing widths are queued
ROADMAP_SA_WIDTHS = ("ROADMAP.md section 2, 'K5. Row 1 at widths neither SA "
                     "kernel takes'")


def rounded_mm(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b as a product of `dtype` (bf16) operands with a float32 result,
    JAX's preferred_element_type=f32: each product of two bf16 values is
    exact in float32, so only the summation order differs from the
    kernel's (TF32 must be off on the card)."""
    return a.to(dtype).float() @ b.to(dtype).float()


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version's two C x C products: the products the kernel runs
    on the tensor cores, in one place."""
    return a @ b


def sa_convmax_reference(A: torch.Tensor, Ct: torch.Tensor, idx: torch.Tensor,
                         w2: torch.Tensor, w3: torch.Tensor,
                         s1, t1, s2, t2, s3, t3) -> torch.Tensor:
    """Plain version: (B, S, C) = max_k relu(relu(relu((A[idx] + Ct) s1 + t1)
    @ w2 s2 + t2) @ w3 s3 + t3), in A's dtype; at bf16 the chain runs in
    float32 with bf16 operands to each product, as the JAX kernel does."""
    B, S, K = idx.shape
    C = A.shape[-1]
    dt = A.dtype
    wide = torch.promote_types(dt, torch.float32)
    g = torch.gather(A, 1, idx.reshape(B, S * K, 1).long().expand(-1, -1, C))
    h = g.reshape(B, S, K, C).to(wide) + Ct.to(wide)[:, :, None, :]
    mm = _mm if dt != BF16 else functools.partial(rounded_mm, dtype=dt)
    h = torch.relu(h * s1 + t1)
    h = torch.relu(mm(h, w2) * s2 + t2)
    h = torch.relu(mm(h, w3) * s3 + t3)
    return h.amax(dim=2).to(dt)


def fused_sa_convmax(A: torch.Tensor, Ct: torch.Tensor, idx: torch.Tensor,
                     w2: torch.Tensor, w3: torch.Tensor,
                     s1, t1, s2, t2, s3, t3) -> torch.Tensor:
    """Batched gather + conv MLP + max over K.

    A (B, N, C) per-point conv1 factor; Ct (B, S, C) per-centre term;
    idx (B, S, K) neighbour indices into N; w2/w3 (C, C) in (in, out)
    layout; s*/t* (C,) folded BN affines. Returns (B, S, C) in A's dtype:
    float32, or bf16 (A and Ct bf16, the rest float32). On CUDA, C must be
    a multiple of 32 from 32 to 1024 (ValueError at float32,
    NotImplementedError at bf16).
    """
    if A.device.type == "cpu":
        return sa_convmax_reference(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3)
    if A.device.type != "cuda":
        raise RuntimeError(f"fused_sa_convmax: no kernel for {A.device}")
    out = launch(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3)
    if A.dtype == BF16:
        fused_sa_convmax.bf16_launches += 1
    else:
        fused_sa_convmax.launches += 1
    return out


def launch(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check CUDA inputs as fused_sa_convmax takes them and launch the
    kernel of their dtype: csrc/sa_stage.cu (float32), or
    csrc/sa_stage_bf16.cu (A and Ct bf16; w2, w3 float32 in any strides,
    handed to the kernel converted once, bf16 in (out, in) layout).
    `library` is another build of the entry points, as tools/ab_sa.py times
    versions of the kernel."""
    B, N, C = A.shape
    S, K = idx.shape[1], idx.shape[2]
    vecs = (s1, t1, s2, t2, s3, t3)
    bf16 = A.dtype == BF16
    dt = BF16 if bf16 else torch.float32
    _expect(A, (B, N, C), dt, "A")
    _expect(Ct, (B, S, C), dt, "Ct")
    _expect(idx, (B, S, K), torch.int32, "idx")
    for w, name in ((w2, "w2"), (w3, "w3")):
        _expect(w, (C, C), torch.float32, name, contiguous=not bf16)
    for i, v in enumerate(vecs):
        _expect(v, (C,), torch.float32, f"affine {i}")
    for t in (Ct, idx, w2, w3) + vecs:
        if t.device != A.device:
            raise ValueError("fused_sa_convmax: inputs on different devices")
    if C % 32 or not 32 <= C <= 1024:
        if bf16:
            raise NotImplementedError(
                f"fused_sa_convmax at bf16: C={C}; the bf16 kernel takes C "
                f"a multiple of 32 from 32 to 1024 ({ROADMAP_SA_WIDTHS})")
        raise ValueError(f"fused_sa_convmax: C={C}; the kernel takes C a "
                         "multiple of 32 from 32 to 1024 (the widths 32, 64 "
                         "and 128 x mul of the port's configs)")
    if B * S * K >= 2 ** 31:
        raise ValueError("fused_sa_convmax: B * S * K must be below 2^31")
    if bf16:
        w2, w3 = (derived((w,), "sa_stage_bf16",
                          lambda w=w: w.t().to(BF16).contiguous())
                  for w in (w2, w3))
    if any(t.data_ptr() % 16 for t in (A, Ct, w2, w3) + vecs):
        raise ValueError("fused_sa_convmax: float inputs must be 16-byte "
                         "aligned (the kernel reads them in float4 / float2)")
    out = torch.empty((B, S, C), dtype=dt, device=A.device)
    lib = (library or _lib.LIBRARY).get()
    entry = "pcr_sa_convmax_bf16" if bf16 else "pcr_sa_convmax"
    err = getattr(lib, entry)(
        *[t.data_ptr() for t in (A, Ct, idx, w2, w3) + vecs + (out,)],
        B, N, S, K, C, _lib.stream_ptr(A.device))
    _lib.check(err, entry)
    return out


fused_sa_convmax.launches = 0
fused_sa_convmax.bf16_launches = 0


def _expect(t: torch.Tensor, shape, dtype, name: str,
            contiguous: bool = True) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: want {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def bn_affine(bn: Tuple[torch.Tensor, ...], eps: float,
              conv_bias: Optional[torch.Tensor] = None):
    """Eval BatchNorm (gamma, beta, mean, var) -> (scale, shift), with an
    optional preceding conv bias folded into the shift."""
    gamma, beta, mean, var = bn
    s = gamma / torch.sqrt(var + eps)
    t = beta - mean * s
    if conv_bias is not None:
        t = t + conv_bias * s
    return s.contiguous(), t.contiguous()


def sa_stage_args(xyz: torch.Tensor, points: Optional[torch.Tensor],
                  idx: torch.Tensor,
                  convs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor]]],
                  bns: Sequence[Tuple[torch.Tensor, ...]],
                  eps: float = 1e-5, dtype: Optional[torch.dtype] = None
                  ) -> tuple:
    """The arguments of fused_sa_convmax for one eval-mode SA stage.

    xyz (B, N, 3); points (B, N, D) or None; idx (B, S, K) kNN indices with
    centres = the first S points (clamped when S > N); convs: three
    (weight (out, in), bias) pairs; bns: three (gamma, beta, mean, var).
    dtype: the model's compute dtype (bf16: A and Ct in it, and w2, w3 as
    transposed views of the weights, which the bf16 kernel converts once).
    """
    B, S, K = idx.shape
    N = xyz.shape[1]
    cidx = torch.arange(S, device=xyz.device).clamp(max=N - 1)
    (w1, b1), (w2, b2), (w3, b3) = convs
    A, Ct = conv1_edge_factors(
        w1.t(), b1, xyz, points, xyz[:, cidx],
        None if points is None else points[:, cidx], dtype)
    s1, t1 = bn_affine(bns[0], eps)
    s2, t2 = bn_affine(bns[1], eps, b2)
    s3, t3 = bn_affine(bns[2], eps, b3)
    w2, w3 = w2.t(), w3.t()
    if dtype is None:
        w2, w3 = w2.contiguous(), w3.contiguous()
    return (A.contiguous(), Ct.contiguous(), idx.to(torch.int32).contiguous(),
            w2, w3, s1, t1, s2, t2, s3, t3)


def sa_stage_inference(xyz, points, idx, convs, bns, eps: float = 1e-5,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Full eval-mode SA conv chain (arguments as sa_stage_args): (B, S, C)
    features after the max over neighbours, the input of the stage's
    self-attention block."""
    return fused_sa_convmax(*sa_stage_args(xyz, points, idx, convs, bns, eps,
                                           dtype))


def sa_stage_reference(xyz, points, idx, convs, bns, eps: float = 1e-5,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """sa_stage_inference through the plain version on any device: what
    the card's eval is held against."""
    return sa_convmax_reference(*sa_stage_args(xyz, points, idx, convs, bns,
                                               eps, dtype))
