"""Fused edge-attention aggregation (segment softmax + weighted sum).

Counterpart of ``cgat_tpu/ops/attention.py`` with the JAX package's
``pallas`` backend: every call goes through the segment-attention kernel
wrapper, which launches the CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors. When a gradient is wanted the call goes through
the autograd Function, whose backward is the segment-attention backward
kernel.
"""
from __future__ import annotations

import torch

from .kernels.segment_attention import (SegmentAttention,
                                        SegmentAttentionPair,
                                        segment_attention,
                                        segment_attention_pair_plain)


def edge_softmax_aggregate(alpha, m, edge_dst, num_nodes, *, edge_mask=None,
                           offn=None):
    """softmax(alpha over destination segments) * m, summed per node.

    Args:
      alpha: (E, H, F) scores, (E, H, 1) for scalar attention, or (E, H*F)
        head-major flat.
      m: (E, H, F) or (E, H*F) messages.
      edge_dst: (E,) destination per edge, sorted ascending.
      num_nodes: number of node slots.
      edge_mask: (E,) bool, a False suffix over padded edges.
      offn: optional unclamped CSR pointers over ``edge_dst`` (at least
        ``num_nodes + 1`` entries); computed here when absent.

    Returns (num_nodes, *m.shape[1:]) in alpha's dtype (bf16 stays bf16,
    anything else computes in f32).
    """
    e = m.shape[0]
    keep = torch.bfloat16 if alpha.dtype == torch.bfloat16 else torch.float32
    if alpha.shape != m.shape:
        alpha = alpha.expand_as(m)     # one score for every feature
    a2 = alpha.reshape(e, -1).to(keep).contiguous()
    m2 = m.reshape(e, -1).to(keep).contiguous()
    if edge_mask is not None:
        n_real = edge_mask.sum(dtype=torch.int32)
    else:
        # filled on the device: no host-to-device copy, which a CUDA graph
        # capture of the step would refuse
        n_real = torch.full((), e, dtype=torch.int32, device=m.device)
    if offn is None:
        offn = torch.searchsorted(
            edge_dst, torch.arange(num_nodes + 1, dtype=edge_dst.dtype,
                                   device=edge_dst.device)).to(torch.int32)
    offn = offn.to(torch.int32)
    if torch.is_grad_enabled() and (a2.requires_grad or m2.requires_grad):
        out = SegmentAttention.apply(a2, m2, edge_dst.to(torch.int32), offn,
                                     n_real, num_nodes)
    else:
        out = segment_attention(a2, m2, offn, n_real, num_nodes)
    return out.reshape((num_nodes,) + tuple(m.shape[1:])).to(alpha.dtype)


def edge_softmax_aggregate_pair(alpha_l, m_l, dst_l, mask_l, alpha_h, m_h,
                                dst_h, mask_h, num_nodes, *, offn_l=None,
                                offn_h=None):
    """:func:`edge_softmax_aggregate` over the union of a local-src and a
    halo-src edge block (an edge-sharded batch): every destination's
    softmax normalises over its edges in both blocks, as on the
    concatenated blocks, while the blocks stay apart so the local one does
    not wait for the boundary exchange.

    alpha/m of each block as in :func:`edge_softmax_aggregate`; dst, mask
    (E,) per block. CUDA tensors go through
    :class:`~.kernels.segment_attention.SegmentAttentionPair` (the
    segment-attention kernels, twice each), which needs each block
    dst-sorted with a False-suffix mask and takes ``offn_l``/``offn_h``,
    the unclamped CSR pointers of each block's destinations (computed here
    when absent). CPU tensors run the plain pair function, which takes any
    mask. Returns (num_nodes, *m.shape[1:]) in alpha's dtype."""
    e_l, e_h = m_l.shape[0], m_h.shape[0]
    keep = torch.bfloat16 if alpha_l.dtype == torch.bfloat16 else torch.float32

    def flat(alpha, m, e):
        if alpha.shape != m.shape:
            alpha = alpha.expand_as(m)
        return (alpha.reshape(e, -1).to(keep).contiguous(),
                m.reshape(e, -1).to(keep).contiguous())

    a_l, f_l = flat(alpha_l, m_l, e_l)
    a_h, f_h = flat(alpha_h, m_h, e_h)
    if a_l.device.type == "cpu":
        out = segment_attention_pair_plain(a_l, f_l, dst_l, mask_l, a_h, f_h,
                                           dst_h, mask_h, num_nodes)
    else:
        def offsets(offn, dst):
            if offn is None:
                offn = torch.searchsorted(
                    dst, torch.arange(num_nodes + 1, dtype=dst.dtype,
                                      device=dst.device))
            return offn.to(torch.int32)

        out = SegmentAttentionPair.apply(
            a_l, f_l, dst_l.to(torch.int32), offsets(offn_l, dst_l),
            mask_l.sum(dtype=torch.int32).reshape(1), a_h, f_h,
            dst_h.to(torch.int32), offsets(offn_h, dst_h),
            mask_h.sum(dtype=torch.int32).reshape(1), num_nodes)
    return out.reshape((num_nodes,) + tuple(m_l.shape[1:])).to(alpha_l.dtype)
