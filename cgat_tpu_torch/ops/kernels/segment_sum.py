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


def segment_sum(vals, ids, offn, num_segments):
    """vals (E, F) bf16 or f32, rows sorted by segment; ids (E,) the sorted
    segment ids; offn (>= num_segments + 1,) int32 unclamped CSR pointers
    over ``ids``. Returns (num_segments, F) in ``vals``' dtype."""
    if vals.device.type == "cpu":
        return segment_sum_plain(vals, ids, num_segments)
    if vals.dtype not in (torch.bfloat16, torch.float32) or vals.dim() != 2:
        raise TypeError(f"segment_sum takes 2-D bf16 or f32, not "
                        f"{tuple(vals.shape)} {vals.dtype}")
    if offn.dtype != torch.int32 or offn.dim() != 1 \
            or offn.numel() < num_segments + 1:
        raise ValueError(f"offn must be int32 with >= {num_segments + 1} "
                         f"entries, got {tuple(offn.shape)} {offn.dtype}")
    for name, t in (("vals", vals), ("offn", offn)):
        if t.device != vals.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {vals.device}")
    out = torch.empty((num_segments, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    code = _entry()(vals.data_ptr(), offn.data_ptr(), num_segments,
                    vals.shape[1], int(vals.dtype == torch.bfloat16),
                    out.data_ptr(),
                    torch.cuda.current_stream(vals.device).cuda_stream)
    build.check("segment_sum", code)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
