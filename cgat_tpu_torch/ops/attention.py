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

from .kernels.segment_attention import SegmentAttention, segment_attention


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
