"""Segment reductions over sorted segment ids, as plain torch ops.

Counterpart of ``cgat_tpu/ops/segment.py``. Segment ids are int tensors
referring to a static number of segments; padding is a boolean mask whose
masked rows contribute exactly zero to every reduction, including softmax
denominators. Given the ids' ``GatherPlan`` (``ops/gather.py``), the sums
and the gathers of :func:`segment_sum` and :func:`segment_softmax` run
through the segment-sum kernel instead of ``index_add`` and indexing, so
that they and their gradients are deterministic on the card (the same
bits in an eager step and a replayed one).
"""
from __future__ import annotations

import torch

from .gather import GatherPlan, gather_rows, segment_sum_rows

# large-but-finite negative instead of -inf, so fully masked segments give 0
# rather than NaN after the max subtraction
NEG_BIG = -1e30
SOFTMAX_EPS = 1e-16  # torch_geometric.utils.softmax denominator eps


def _expand(mask, data):
    """Broadcast a 1-D mask over the trailing dims of ``data``."""
    return mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))


def segment_sum(data, segment_ids, num_segments,
                plan: GatherPlan | None = None):
    """Sum ``data`` rows into ``num_segments`` buckets (through the
    segment-sum kernel when the ids' ``plan`` is given)."""
    if plan is not None:
        out = segment_sum_rows(data.reshape(data.shape[0], -1), segment_ids,
                               plan, num_segments)
        return out.view((num_segments,) + tuple(data.shape[1:]))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids.long(), data)


def take_rows(table, segment_ids, plan: GatherPlan | None):
    """``table[segment_ids]`` (through :func:`gather_rows` when the ids'
    ``plan`` is given)."""
    if plan is None:
        return table[segment_ids.long()]
    rows = gather_rows(table.reshape(table.shape[0], -1), segment_ids, plan)
    return rows.view((segment_ids.shape[0],) + tuple(table.shape[1:]))


def segment_max(data, segment_ids, num_segments):
    """Max-reduce ``data`` rows into ``num_segments`` buckets; empty segments
    give ``NEG_BIG``."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), NEG_BIG)
    idx = _expand(segment_ids.long(), data).expand_as(data)
    return out.scatter_reduce_(0, idx, data, "amax", include_self=True)


def segment_softmax(scores, segment_ids, num_segments, *, mask=None,
                    eps=SOFTMAX_EPS, plan: GatherPlan | None = None):
    """Numerically stable softmax over the rows of each segment, for every
    trailing position independently (torch_geometric.utils.softmax).
    Masked rows get weight exactly 0. ``plan``: the ids' gather plan, for
    the deterministic path."""
    if mask is not None:
        scores = torch.where(_expand(mask, scores), scores,
                             torch.full_like(scores, NEG_BIG))
    seg_max = segment_max(scores, segment_ids, num_segments)
    unnorm = torch.exp(scores - take_rows(seg_max, segment_ids, plan))
    if mask is not None:
        unnorm = torch.where(_expand(mask, unnorm), unnorm,
                             torch.zeros_like(unnorm))
    denom = segment_sum(unnorm, segment_ids, num_segments, plan)
    return unnorm / (take_rows(denom, segment_ids, plan) + eps)


def segment_softmax_pair(scores_a, ids_a, mask_a, scores_b, ids_b, mask_b,
                         num_segments, *, eps=SOFTMAX_EPS,
                         plan_a: GatherPlan | None = None,
                         plan_b: GatherPlan | None = None):
    """Segment softmax over the union of two row blocks (an edge-sharded
    batch's local and halo blocks): each segment normalises over its rows
    in both. Returns each block's weights ``(w_a, w_b)``, equal (the
    softmax is shift-invariant) to :func:`segment_softmax` of the
    concatenated blocks. Masked rows get weight exactly 0. ``plan_a``,
    ``plan_b``: the blocks' gather plans, for the deterministic path."""
    sa = torch.where(_expand(mask_a, scores_a), scores_a,
                     torch.full_like(scores_a, NEG_BIG))
    sb = torch.where(_expand(mask_b, scores_b), scores_b,
                     torch.full_like(scores_b, NEG_BIG))
    mx = torch.maximum(segment_max(sa, ids_a, num_segments),
                       segment_max(sb, ids_b, num_segments))
    # exponentiate the masked scores: masked rows sit at NEG_BIG, so no
    # exponent overflows in the branch that is not taken
    ea = torch.where(_expand(mask_a, sa),
                     torch.exp(sa - take_rows(mx, ids_a, plan_a)),
                     torch.zeros_like(sa))
    eb = torch.where(_expand(mask_b, sb),
                     torch.exp(sb - take_rows(mx, ids_b, plan_b)),
                     torch.zeros_like(sb))
    den = (segment_sum(ea, ids_a, num_segments, plan_a)
           + segment_sum(eb, ids_b, num_segments, plan_b))
    return (ea / (take_rows(den, ids_a, plan_a) + eps),
            eb / (take_rows(den, ids_b, plan_b) + eps))
