"""Fused multi-head linear attention with a gradient.

Port of point_cloud_reid_tpu/ops/pallas/linear_attention.py.
`linear_attention_forward` launches the CUDA kernel of
csrc/linear_attention.cu on CUDA tensors and runs the plain composite
(ops.attention.linear_attention) on CPU tensors; any other device raises.
`fused_linear_attention` wraps it in an autograd Function whose backward
recomputes through the plain composite on the saved q, k, v, as the JAX
package's custom VJP does: there is no backward kernel in either package.
bf16 or float16 inputs (a bf16 model's) are cast to float32 for the kernel
and the output back to their dtype, as linear_attention_pallas does: the
kernel is float32 only. The backward recomputes in the inputs' own dtype,
with the incoming gradient cast to it, as JAX's `_lin_attn_bwd` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.attention import linear_attention as linear_attention_reference
from . import _lib


def _row_strided(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads 4-D views with any batch / row / head strides but
    wants unit stride along the last axis."""
    return t if t.stride(-1) == 1 else t.contiguous()


def linear_attention_forward(queries: torch.Tensor, keys: torch.Tensor,
                             values: torch.Tensor, eps: float = 1e-6
                             ) -> torch.Tensor:
    """queries (B, L, H, D), keys (B, S, H, D), values (B, S, H, V), float32
    -> (B, L, H, V). No autograd graph is recorded."""
    if queries.device.type == "cpu":
        with torch.no_grad():
            return linear_attention_reference(queries, keys, values,
                                              eps=eps)
    if queries.device.type != "cuda":
        raise RuntimeError(f"linear_attention: no kernel for {queries.device}")
    out = launch(queries, keys, values, eps)
    linear_attention_forward.launches += 1
    if queries.shape[1] == 1:
        linear_attention_forward.shape_launches["one_query"] += 1
    return out


linear_attention_forward.launches = 0
# launches at one query a row (the local self-attention stages' shape),
# beside the total
linear_attention_forward.shape_launches = {"one_query": 0}


def launch(queries: torch.Tensor, keys: torch.Tensor, values: torch.Tensor,
           eps: float = 1e-6, library: Optional[_lib.Library] = None
           ) -> torch.Tensor:
    """Check CUDA inputs as linear_attention_forward takes them and launch
    the kernel. `library` is another build of csrc/linear_attention.cu's
    entry point, as tools/ab_train_kernels.py times versions of the
    kernel."""
    if queries.dim() != 4 or keys.dim() != 4 or values.dim() != 4:
        raise ValueError("linear_attention: want 4-D q, k, v")
    B, L, H, D = queries.shape
    S, V = values.shape[1], values.shape[3]
    if (tuple(keys.shape) != (B, S, H, D)
            or tuple(values.shape) != (B, S, H, V) or D > 128 or V > 128):
        raise ValueError(
            f"linear_attention: want q (B, L, H, D), k (B, S, H, D), "
            f"v (B, S, H, V) with D, V <= 128, got {tuple(queries.shape)}, "
            f"{tuple(keys.shape)}, {tuple(values.shape)}")
    for t in (queries, keys, values):
        if t.dtype != torch.float32 or t.device != queries.device:
            raise ValueError("linear_attention: want float32 tensors on one "
                             "device")
    q, k, v = (_row_strided(t.detach()) for t in (queries, keys, values))
    out = torch.empty((B, L, H, V), dtype=torch.float32, device=q.device)
    strides = [t.stride(i) for t in (q, k, v) for i in (0, 1, 2)]
    lib = (library or _lib.LIBRARY).get()
    err = lib.pcr_linear_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, L, S, H, D, V, *strides, float(eps), _lib.stream_ptr(q.device))
    _lib.check(err, "pcr_linear_attention")
    return out


class _LinearAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, queries, keys, values, eps):
        ctx.save_for_backward(queries, keys, values)
        ctx.eps = eps
        dt = queries.dtype
        if dt not in (torch.bfloat16, torch.float16):
            return linear_attention_forward(queries, keys, values, eps)
        return linear_attention_forward(queries.float(), keys.float(),
                                        values.float(), eps).to(dt)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = linear_attention_reference(q, k, v, eps=ctx.eps)
        dq, dk, dv = torch.autograd.grad(
            out, (q, k, v), grad_out.to(q.dtype).contiguous())
        return dq, dk, dv, None


def fused_linear_attention(queries: torch.Tensor, keys: torch.Tensor,
                           values: torch.Tensor,
                           q_mask: Optional[torch.Tensor] = None,
                           kv_mask: Optional[torch.Tensor] = None,
                           eps: float = 1e-6) -> torch.Tensor:
    """Drop-in for ops.attention.linear_attention, usable in training;
    bf16 / float16 inputs run the kernel in float32 and return their
    dtype, and their gradients are the composite's in that dtype. The
    kernel takes no masks: with a mask the composite runs, as the JAX
    package's 'linear-pallas' attention falls back
    (models/attention_blocks._attn_fn)."""
    if q_mask is not None or kv_mask is not None:
        return linear_attention_reference(queries, keys, values, q_mask,
                                          kv_mask, eps)
    return _LinearAttention.apply(queries, keys, values, eps)
