"""Node-table gather whose backward is the sorted CSR segment sum, and the
segment sum whose forward it is.

Counterpart of ``gather_rows`` and ``GatherPlan`` in
``cgat_tpu/ops/gather.py``. The forward is ``table[idx]``. The backward
scatters the cotangent rows back onto the table. The batch layout has the
destination ids sorted, and the collate ships the stable argsort of the
source ids with their sorted copy and CSR pointers, so that scatter is the
segment-sum kernel (``ops/kernels/segment_sum.py``) over ``g`` (sorted ids)
or ``g[perm]`` (source ids): deterministic, and the same sum as autograd's
``index_add``, padding included. :func:`segment_sum_rows` is the
transpose: the segment-sum kernel forward, a gather backward; both are
deterministic on the card, where autograd's ``index_add`` and indexing
backward sum with atomics.
"""
from __future__ import annotations

import dataclasses

import torch

from .kernels.segment_sum import segment_sum


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """Backward plan of one index array: its ids in sorted order, the
    permutation that sorts it (None when it is sorted already) and the
    unclamped CSR pointers over the sorted ids."""
    sorted_idx: torch.Tensor
    perm: torch.Tensor | None
    offn: torch.Tensor


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx, sorted_idx, perm, offn):
        ctx.save_for_backward(sorted_idx, perm, offn)
        ctx.num_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        sorted_idx, perm, offn = ctx.saved_tensors
        g = g.contiguous() if perm is None else g[perm]
        return (segment_sum(g, sorted_idx, offn, ctx.num_rows),
                None, None, None, None)


def gather_rows(table, idx, plan: GatherPlan):
    """``table[idx]`` for a 2-D table; ``plan`` is the backward plan of
    ``idx``, so the gradient runs as the segment-sum kernel."""
    return _GatherRows.apply(table, idx, plan.sorted_idx, plan.perm,
                             plan.offn)


class _SegmentSumRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, idx, sorted_idx, perm, offn, num_segments):
        ctx.save_for_backward(idx)
        rows = data if perm is None else data[perm]
        return segment_sum(rows.contiguous(), sorted_idx, offn, num_segments)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return g[idx.long()], None, None, None, None, None


def segment_sum_rows(data, idx, plan: GatherPlan, num_segments: int):
    """The rows of a 2-D ``data`` summed into the segments ``idx`` names
    (``plan`` its backward plan): the segment-sum kernel, whose gradient
    is ``g[idx]``."""
    return _SegmentSumRows.apply(data, idx, plan.sorted_idx, plan.perm,
                                 plan.offn, num_segments)
