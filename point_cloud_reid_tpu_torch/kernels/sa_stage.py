"""Eval-mode SA stage: gather + edge-MLP + max over neighbours.

Port of point_cloud_reid_tpu/ops/pallas/sa_stage.py. `fused_sa_convmax`
launches the CUDA kernel of csrc/sa_stage.cu (its two products on the tensor
cores in three TF32 passes) on CUDA tensors and runs its
plain PyTorch version, `sa_convmax_reference`, on CPU tensors; any other
device raises. `sa_stage_inference` folds BatchNorm into per-channel affines
exactly as the JAX wrapper does (conv1's bias enters Ct through
conv1_edge_factors; conv2/conv3's biases enter t2/t3) and calls it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.geometry import conv1_edge_factors
from . import _lib


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version's two C x C products: the products the kernel runs
    on the tensor cores, in one place."""
    return a @ b


def sa_convmax_reference(A: torch.Tensor, Ct: torch.Tensor, idx: torch.Tensor,
                         w2: torch.Tensor, w3: torch.Tensor,
                         s1, t1, s2, t2, s3, t3) -> torch.Tensor:
    """Plain version: (B, S, C) = max_k relu(relu(relu((A[idx] + Ct) s1 + t1)
    @ w2 s2 + t2) @ w3 s3 + t3)."""
    B, S, K = idx.shape
    C = A.shape[-1]
    g = torch.gather(A, 1, idx.reshape(B, S * K, 1).long().expand(-1, -1, C))
    h = g.reshape(B, S, K, C) + Ct[:, :, None, :]
    h = torch.relu(h * s1 + t1)
    h = torch.relu(_mm(h, w2) * s2 + t2)
    h = torch.relu(_mm(h, w3) * s3 + t3)
    return h.amax(dim=2)


def fused_sa_convmax(A: torch.Tensor, Ct: torch.Tensor, idx: torch.Tensor,
                     w2: torch.Tensor, w3: torch.Tensor,
                     s1, t1, s2, t2, s3, t3) -> torch.Tensor:
    """Batched gather + conv MLP + max over K.

    A (B, N, C) per-point conv1 factor; Ct (B, S, C) per-centre term;
    idx (B, S, K) neighbour indices into N; w2/w3 (C, C) in (in, out)
    layout; s*/t* (C,) folded BN affines. Returns (B, S, C) float32. On
    CUDA, C must be a multiple of 32 from 32 to 1024 (ValueError otherwise).
    """
    if A.device.type == "cpu":
        return sa_convmax_reference(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3)
    if A.device.type != "cuda":
        raise RuntimeError(f"fused_sa_convmax: no kernel for {A.device}")
    out = launch(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3)
    fused_sa_convmax.launches += 1
    return out


def launch(A, Ct, idx, w2, w3, s1, t1, s2, t2, s3, t3,
           library: Optional[_lib.Library] = None) -> torch.Tensor:
    """Check CUDA inputs as fused_sa_convmax takes them and launch the
    kernel. `library` is another build of csrc/sa_stage.cu's entry point, as
    tools/ab_sa.py times versions of the kernel."""
    B, N, C = A.shape
    S, K = idx.shape[1], idx.shape[2]
    vecs = (s1, t1, s2, t2, s3, t3)
    _expect(A, (B, N, C), torch.float32, "A")
    _expect(Ct, (B, S, C), torch.float32, "Ct")
    _expect(idx, (B, S, K), torch.int32, "idx")
    _expect(w2, (C, C), torch.float32, "w2")
    _expect(w3, (C, C), torch.float32, "w3")
    for i, v in enumerate(vecs):
        _expect(v, (C,), torch.float32, f"affine {i}")
    for t in (Ct, idx, w2, w3) + vecs:
        if t.device != A.device:
            raise ValueError("fused_sa_convmax: inputs on different devices")
    if C % 32 or not 32 <= C <= 1024:
        raise ValueError(f"fused_sa_convmax: C={C}; the kernel takes C a "
                         "multiple of 32 from 32 to 1024 (the widths 32, 64 "
                         "and 128 x mul of the port's configs)")
    if B * S * K >= 2 ** 31:
        raise ValueError("fused_sa_convmax: B * S * K must be below 2^31")
    if any(t.data_ptr() % 16 for t in (A, Ct, w2, w3) + vecs):
        raise ValueError("fused_sa_convmax: float inputs must be 16-byte "
                         "aligned (the kernel reads them in float4 / float2)")
    out = torch.empty((B, S, C), dtype=torch.float32, device=A.device)
    lib = (library or _lib.LIBRARY).get()
    err = lib.pcr_sa_convmax(
        *[t.data_ptr() for t in (A, Ct, idx, w2, w3) + vecs + (out,)],
        B, N, S, K, C, _lib.stream_ptr(A.device))
    _lib.check(err, "pcr_sa_convmax")
    return out


fused_sa_convmax.launches = 0


def _expect(t: torch.Tensor, shape, dtype, name: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: want {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
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
                  eps: float = 1e-5) -> tuple:
    """The arguments of fused_sa_convmax for one eval-mode SA stage.

    xyz (B, N, 3); points (B, N, D) or None; idx (B, S, K) kNN indices with
    centres = the first S points (clamped when S > N); convs: three
    (weight (out, in), bias) pairs; bns: three (gamma, beta, mean, var).
    """
    B, S, K = idx.shape
    N = xyz.shape[1]
    cidx = torch.arange(S, device=xyz.device).clamp(max=N - 1)
    (w1, b1), (w2, b2), (w3, b3) = convs
    A, Ct = conv1_edge_factors(
        w1.t(), b1, xyz, points, xyz[:, cidx],
        None if points is None else points[:, cidx])
    s1, t1 = bn_affine(bns[0], eps)
    s2, t2 = bn_affine(bns[1], eps, b2)
    s3, t3 = bn_affine(bns[2], eps, b3)
    return (A.contiguous(), Ct.contiguous(), idx.to(torch.int32).contiguous(),
            w2.t().contiguous(), w3.t().contiguous(), s1, t1, s2, t2, s3, t3)


def sa_stage_inference(xyz, points, idx, convs, bns, eps: float = 1e-5
                       ) -> torch.Tensor:
    """Full eval-mode SA conv chain (arguments as sa_stage_args): (B, S, C)
    features after the max over neighbours, the input of the stage's
    self-attention block."""
    return fused_sa_convmax(*sa_stage_args(xyz, points, idx, convs, bns, eps))


def sa_stage_reference(xyz, points, idx, convs, bns, eps: float = 1e-5
                       ) -> torch.Tensor:
    """sa_stage_inference through the plain version on any device: what
    the card's eval is held against."""
    return sa_convmax_reference(*sa_stage_args(xyz, points, idx, convs, bns,
                                               eps))
