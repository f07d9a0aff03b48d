"""TF32 emulation for the CPU tests of the kernels that run their products
on the tensor cores in three TF32 passes (tests/test_torch_match_tf32.py,
tests/test_torch_sa_tf32.py).

A kernel computes a product as hi*hi + hi*lo + lo*hi, where hi is the
operand truncated to TF32 (10 mantissa bits) and lo = x - hi as the tensor
core reads it (truncated to TF32 too). One pass is a product of the operands
rounded to TF32, as cuBLAS computes a TF32 product.
"""
import torch


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the magnitude half up at bit 13, keep 10
    mantissa bits."""
    return ((_bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 operand: the low 13 bits
    dropped."""
    return (_bits(x) & ~0x1FFF).view(torch.float32)


def mm_one_pass(a, b):
    return tf32_round(a) @ tf32_round(b)


def mm_three_pass(hi):
    """3xTF32 with `hi` splitting off the high part."""
    def mm(a, b):
        ah, bh = hi(a), hi(b)
        al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
        return al @ bh + ah @ bl + ah @ bh
    return mm


def rel(got, want) -> float:
    """max |got - want| / max(1, max |want|), the kernels' error measure."""
    return ((got - want).abs().max() / want.abs().max().clamp(min=1.0)).item()
