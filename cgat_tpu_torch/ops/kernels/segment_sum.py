"""Sorted CSR segment sum: CUDA kernel wrapper and its plain PyTorch version.

Counterpart of ``cgat_tpu/ops/pallas/segment_sum.py`` (``csr_segment_sum``),
the backward of the node-table gathers (``ops/gather.py``). For rows sorted
by segment id, with the unclamped CSR pointers ``offn`` of those ids::

    out[n] = sum_{offn[n] <= e < offn[n+1]} vals[e]

with f32 accumulation and output in ``vals``' dtype. Every row counts,
padding included: padded edges point at the last node slot and their
cotangents sum there, exactly as the JAX package's ``GatherPlan`` with
unclamped host pointers does. The kernel is
``cgat_tpu_torch/csrc/segment_sum.cu``. CPU tensors go through
:func:`segment_sum_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_P = ctypes.c_void_p
_DTYPES = (torch.bfloat16, torch.float32)


@functools.cache
def _entry():
    return build.entry("segment_sum", "cgat_segment_sum",
                       [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                        _P, _P])


def segment_sum_plain(vals, ids, num_segments):
    """The kernel's function in plain torch ops, over the sorted ids."""
    out = torch.zeros((num_segments, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, ids.long(), vals.float()).to(vals.dtype)


def _refuse(vals, offn, num_segments):
    """The error for inputs the kernel does not take."""
    if vals.dtype not in _DTYPES or vals.dim() != 2:
        return TypeError(f"segment_sum takes 2-D bf16 or f32, not "
                         f"{tuple(vals.shape)} {vals.dtype}")
    if offn.dtype != torch.int32 or offn.dim() != 1 \
            or offn.numel() < num_segments + 1:
        return ValueError(f"offn must be int32 with >= {num_segments + 1} "
                          f"entries, got {tuple(offn.shape)} {offn.dtype}")
    return ValueError(f"vals and offn must be contiguous on {vals.device}")


def segment_sum(vals, ids, offn, num_segments):
    """vals (E, F) bf16 or f32, rows sorted by segment; ids (E,) the sorted
    segment ids; offn (>= num_segments + 1,) int32 unclamped CSR pointers
    over ``ids``. Returns (num_segments, F) in ``vals``' dtype."""
    device = vals.device
    if device.type == "cpu":
        return segment_sum_plain(vals, ids, num_segments)
    # At the training step's shapes the kernel runs ~9 us on the H100,
    # about what this host path costs: the checks are one expression, and
    # the message is built only on refusal.
    dtype = vals.dtype
    if not ((dtype is torch.bfloat16 or dtype is torch.float32)
            and vals.dim() == 2 and offn.dtype is torch.int32
            and offn.dim() == 1 and offn.numel() > num_segments
            and offn.device == device and vals.is_contiguous()
            and offn.is_contiguous()):
        raise _refuse(vals, offn, num_segments)
    f = vals.shape[1]
    out = vals.new_empty(num_segments, f)
    code = build.run(_entry(), device, vals.data_ptr(), offn.data_ptr(),
                     num_segments, f, dtype is torch.bfloat16,
                     out.data_ptr())
    build.check("segment_sum", code)
    return out
