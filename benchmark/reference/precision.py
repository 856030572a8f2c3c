"""Products in a chosen precision, for the reference and its controls. The
reference multiplies in f32 with TF32 off; a control rounds each
product's inputs, forward and backward, one step below the precision a
configuration states and multiplies the rounded values in f32."""
from __future__ import annotations

import torch

FP8_MAX = 448.0        # largest finite float8_e4m3fn


def _tf32(x):
    """f32 with the mantissa rounded to TF32's 10 bits (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x):
    """float8_e4m3fn with one scale a tensor (its largest magnitude onto
    the format's largest value), as fp8 training scales a tensor."""
    amax = x.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


ROUNDINGS = {"float32": None, "tf32": _tf32, "bfloat16": _bf16,
             "float8": _fp8}


class _RoundedMatmul(torch.autograd.Function):
    """``a @ b`` of the rounded inputs; the backward's products round the
    incoming gradient too."""

    @staticmethod
    def forward(ctx, a, b, fn):
        ra, rb = fn(a), fn(b)
        ctx.save_for_backward(ra, rb)
        ctx.fn = fn
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = ctx.fn(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg, None


class Precision:
    """The products of a model in precision ``name`` ("float32", "tf32",
    "bfloat16" or "float8")."""

    def __init__(self, name: str = "float32"):
        self.name = name
        self.fn = ROUNDINGS[name]

    def mm(self, a, b):
        """``a @ b`` (2-D, or 3-D with a batch dimension on both)."""
        if self.fn is None:
            return a @ b
        return _RoundedMatmul.apply(a, b, self.fn)
