"""Dropout with masks drawn on the device: CUDA kernel wrappers, their
plain PyTorch version and the autograd Function that joins them.

The port's own kernel (``cgat_tpu_torch/csrc/dropout.cu``): the JAX
package draws its masks with XLA's RNG, not with a Pallas kernel. Each
element is kept with probability ``1 - rate`` and scaled::

    out = keep ? x * scale : 0,   scale = f32(1 / (1 - rate))

``keep`` comes from Philox4x32-10 (:func:`philox4x32`) under a key of two
uint32 that the host derives from the dropout site's static path
(:func:`site_key`: ``(seed[, dp_index, edge_index], site)``), at the
counter ``(element // 4 as two uint32, step as two uint32)``; element
``i`` takes word ``i % 4`` and is kept when ``(word >> 8) < threshold``
(:func:`keep_threshold`). ``step`` is a device int64 tensor that the
trainer advances inside its step, so a CUDA graph of the step draws new
masks at each replay, and the masks stay a function of (seed, step, site)
alone: a resumed run and a recomputed layer (``remat``) draw the same
ones. The test is on integers, so the plain version draws the kernel's
masks bit for bit. The backward (:func:`dropout_bwd`) is the same kernel
on the incoming gradient, which recomputes the mask: nothing is stored.

CPU tensors go through :func:`dropout_plain` (Philox in int64 tensor
arithmetic); CUDA tensors launch the kernel or raise. Both wrappers
launch the one C entry ``cgat_dropout``, which counts their launches
together (``build.launch_counts``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

_P = ctypes.c_void_p
_DTYPES = (torch.bfloat16, torch.float32)
_U32 = 0xFFFFFFFF
# Philox4x32's multipliers and Weyl key increments (Random123)
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85


@functools.cache
def _entry():
    return build.entry("dropout", "cgat_dropout",
                       [_P, _P, ctypes.c_longlong, ctypes.c_uint32,
                        ctypes.c_uint32, _P, ctypes.c_uint32, ctypes.c_float,
                        ctypes.c_int, ctypes.c_int, _P])


@functools.lru_cache(maxsize=4096)
def site_key(*path: int) -> tuple[int, int]:
    """The Philox key (two uint32) of a dropout site's static path."""
    k0, k1 = np.random.SeedSequence(list(path)).generate_state(2)
    return int(k0), int(k1)


def keep_threshold(rate: float) -> int:
    """An element is kept when the top 24 bits of its word are below
    this."""
    return int(round((1.0 - rate) * 2 ** 24))


def keep_scale(rate: float) -> float:
    """The f32 factor of the kept elements, 1 / (1 - rate)."""
    return float(np.float32(1.0 / (1.0 - rate)))


def philox4x32(ctr: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 of the counters ``ctr`` (..., 4), int64 holding
    uint32, under ``key``. The 32x32-bit products wrap in int64, and their
    low 64 bits, all that is kept, are exact under the wrap-around."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        p0, p1 = c0 * _M0, c2 * _M1
        c0, c1, c2, c3 = ((p1 >> 32) & _U32) ^ c1 ^ k0, p1 & _U32, \
            ((p0 >> 32) & _U32) ^ c3 ^ k1, p0 & _U32
    return torch.stack([c0, c1, c2, c3], -1)


def keep_mask(n: int, key: tuple[int, int], step: torch.Tensor,
              threshold: int) -> torch.Tensor:
    """The (n,) bool mask of the kept elements, on ``step``'s device."""
    q = torch.arange((n + 3) // 4, dtype=torch.int64, device=step.device)
    s = step.to(torch.int64).expand_as(q)
    ctr = torch.stack([q & _U32, (q >> 32) & _U32, s & _U32,
                       (s >> 32) & _U32], -1)
    words = philox4x32(ctr, key).reshape(-1)[:n]
    return (words >> 8) < threshold


def dropout_plain(x, rate: float, key: tuple[int, int], step):
    """The kernel's function in plain torch ops."""
    keep = keep_mask(x.numel(), key, step, keep_threshold(rate))
    kept = (x.float() * keep_scale(rate)).to(x.dtype)
    return torch.where(keep.view(x.shape), kept, torch.zeros_like(x))


def _refuse(x, step):
    """The error for inputs the kernel does not take."""
    if x.dtype not in _DTYPES:
        return TypeError(f"dropout takes bf16 or f32, not {x.dtype}")
    if step.dtype != torch.int64 or step.numel() != 1:
        return ValueError(f"the step must be one int64, got "
                          f"{tuple(step.shape)} {step.dtype}")
    return ValueError(f"x must be contiguous and the step on {x.device}")


def _check(x, step) -> None:
    dtype = x.dtype
    if not ((dtype is torch.bfloat16 or dtype is torch.float32)
            and x.is_contiguous() and step.dtype is torch.int64
            and step.numel() == 1 and step.device == x.device):
        raise _refuse(x, step)


def dropout(x, rate: float, key: tuple[int, int], step):
    """Dropout of ``x`` (bf16 or f32, contiguous on a card) at ``rate`` <
    1 under the site key ``key`` and the device int64 ``step``; an empty
    ``x`` launches nothing."""
    if x.device.type == "cpu":
        return dropout_plain(x, rate, key, step)
    _check(x, step)
    out = torch.empty_like(x)
    if x.numel():
        code = build.run(_entry(), x.device, x.data_ptr(), out.data_ptr(),
                         x.numel(), *key, step.data_ptr(),
                         keep_threshold(rate), keep_scale(rate),
                         x.dtype is torch.bfloat16, 0)
        build.check("dropout", code)
    return out


def dropout_bwd(g, rate: float, key: tuple[int, int], step):
    """The gradient of :func:`dropout` for the incoming ``g``: the same
    mask and scale applied to ``g``."""
    if g.device.type == "cpu":
        return dropout_plain(g, rate, key, step)
    _check(g, step)
    out = torch.empty_like(g)
    if g.numel():
        code = build.run(_entry(), g.device, g.data_ptr(), out.data_ptr(),
                         g.numel(), *key, step.data_ptr(),
                         keep_threshold(rate), keep_scale(rate),
                         g.dtype is torch.bfloat16, 1)
        build.check("dropout", code)
    return out


class Dropout(torch.autograd.Function):
    """:func:`dropout` with :func:`dropout_bwd` as its backward; the key,
    rate and step are kept for the backward, not the mask."""

    @staticmethod
    def forward(ctx, x, rate, key, step):
        ctx.rate, ctx.key, ctx.step = rate, key, step
        return dropout(x.contiguous(), rate, key, step)

    @staticmethod
    def backward(ctx, g):
        return (dropout_bwd(g.contiguous(), ctx.rate, ctx.key, ctx.step),
                None, None, None)
