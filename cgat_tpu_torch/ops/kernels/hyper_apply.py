"""Fused hypernetwork predict + apply: CUDA kernel wrapper and its plain
PyTorch version.

Counterpart of the forward of ``cgat_tpu/ops/pallas/hyper_apply.py``. With
``k`` the last hypernetwork Linear's weight (O*I + O, C) and ``bias`` its
bias::

    P = bf16(hidden @ k^T + bias)                       (B, O*I + O)
    out[b, o] = bf16(sum_i P[b, o*I + i] * x[b, i] + P[b, O*I + o])

with f32 products and sums. The kernel is
``cgat_tpu_torch/csrc/hyper_apply.cu``; it never writes P to device memory.
CPU tensors go through :func:`hyper_apply_plain`; CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SMEM_LIMIT = 232448  # shared memory one H100 block may use


def smem_bytes(c_dim: int, in_ch: int) -> int:
    """Shared memory of one block (mirrors ``smem_bytes`` in the .cu):
    per-warp scratch, partial sums, bias tail, 64-row hidden and x tiles."""
    return (8 * 16 * 20 * 4 + 8 * 64 * 16 * 4 + 64 * 16 * 4
            + 64 * (c_dim + 8) * 2 + 64 * (in_ch + 8) * 2)


def supported(hidden_dim: int, in_ch: int, out_ch: int, dtype) -> bool:
    """Whether the kernel takes these widths: bf16, 16-multiple widths (the
    tensor-core fragment and the 16 outputs of a block), and tiles that fit
    one block's shared memory."""
    return (dtype == torch.bfloat16 and hidden_dim % 16 == 0
            and in_ch % 16 == 0 and out_ch % 16 == 0 and out_ch > 0
            and smem_bytes(hidden_dim, in_ch) <= SMEM_LIMIT)


@functools.cache
def _fwd():
    p = ctypes.c_void_p
    i = ctypes.c_int
    return build.entry("hyper_apply", "cgat_hyper_apply_fwd",
                       [p, p, p, p, p, i, i, i, i, p])


def hyper_apply_plain(hidden, k, bias, x, out_ch):
    """The kernel's function in plain torch ops (f32 products and sums,
    bf16-rounded predicted parameters, output in ``hidden``'s dtype)."""
    b, in_ch = x.shape
    w = out_ch * in_ch
    p = (hidden.float() @ k.float().T + bias.float()).to(hidden.dtype).float()
    y = torch.einsum("boi,bi->bo", p[:, :w].reshape(b, out_ch, in_ch),
                     x.float())
    return (y + p[:, w:]).to(hidden.dtype)


def hyper_apply(hidden, k, bias, x, out_ch):
    """hidden (B, C); k (O*I + O, C); bias (O*I + O,); x (B, I).
    Returns (B, O) in ``hidden``'s dtype."""
    if hidden.device.type == "cpu":
        return hyper_apply_plain(hidden, k, bias, x, out_ch)
    n, c_dim = hidden.shape
    in_ch = x.shape[1]
    if not supported(c_dim, in_ch, out_ch, hidden.dtype):
        raise ValueError(f"hyper_apply kernel does not take C={c_dim} "
                         f"I={in_ch} O={out_ch} {hidden.dtype}")
    f = out_ch * in_ch + out_ch
    shapes = {"hidden": (n, c_dim), "k": (f, c_dim), "bias": (f,),
              "x": (n, in_ch)}
    for name, t in (("hidden", hidden), ("k", k), ("bias", bias), ("x", x)):
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
        if t.device != hidden.device or t.dtype != hidden.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; hidden is "
                             f"{hidden.dtype} on {hidden.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{name} must be contiguous and 32-byte aligned")
    out = torch.empty((n, out_ch), dtype=hidden.dtype, device=hidden.device)
    code = _fwd()(hidden.data_ptr(), k.data_ptr(), bias.data_ptr(),
                  x.data_ptr(), out.data_ptr(), n, c_dim, in_ch, out_ch,
                  torch.cuda.current_stream(hidden.device).cuda_stream)
    build.check("hyper_apply", code)
    hyper_apply.launches += 1
    return out


hyper_apply.launches = 0
