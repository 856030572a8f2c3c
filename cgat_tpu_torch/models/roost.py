"""Roost composition model, dense per crystal (torch.nn).

Counterpart of ``cgat_tpu/models/roost.py`` (reference
CGAT/roost_message.py:88-321). The composition graph of a crystal is
complete over its few distinct elements, so it is held as a masked dense
``(C, R, R)`` pair tensor and every reduction is a masked axis reduction.
Module attributes follow the reference, so the ``state_dict`` keys are
``roost.graphs.{i}.pooling.0.{gate_nn,message_nn,pow}`` and
``roost.cry_pool.0.{gate_nn,pow}``.
"""
from __future__ import annotations

import torch
from torch import nn

from .blocks import SimpleNetwork, TorchLinear

NEG_BIG = -1e30


def weighted_attention_dense(gate, weights, pow_, mask, dim):
    """Masked dense WeightedAttention gate (roost_message.py:305-311):
    max-subtracted exp, scaled by ``weights ** pow``, normalised over
    ``dim`` with +1e-13; zero at masked slots."""
    gate = torch.where(mask, gate, NEG_BIG)
    gmax = gate.amax(dim=dim, keepdim=True).clamp(min=NEG_BIG)
    g = torch.exp(gate - gmax)
    w = torch.where(mask, weights, 1.0)   # no 0 ** negative at padded slots
    g = torch.where(mask, (w ** pow_) * g, 0.0)
    return g / (g.sum(dim=dim, keepdim=True) + 1e-13)


class WeightedAttention(nn.Module):
    """One attention head's gate, message network and ``pow``
    (roost_message.py:286-321); no message network means identity."""

    def __init__(self, gate_in, fea_len, with_message=True):
        super().__init__()
        self.gate_nn = SimpleNetwork(gate_in, 1, [256])
        self.message_nn = (SimpleNetwork(gate_in, fea_len, [256])
                           if with_message else None)
        self.pow = nn.Parameter(torch.randn(1))


class MessageLayer(nn.Module):
    """Composition message passing (roost_message.py:88-156), one head:
    pair features ``[fea_s, fea_t]`` for all ordered pairs s != t, attention
    gated by the neighbour's fractional weight, summed over neighbours t,
    residual added."""

    def __init__(self, fea_len):
        super().__init__()
        self.pooling = nn.ModuleList([WeightedAttention(2 * fea_len,
                                                        fea_len)])

    def forward(self, weights, fea, mask):
        C, R, F = fea.shape
        pair = torch.cat([fea[:, :, None, :].expand(C, R, R, F),
                          fea[:, None, :, :].expand(C, R, R, F)], dim=-1)
        eye = torch.eye(R, dtype=torch.bool, device=fea.device)
        pair_mask = (mask[:, :, None] & mask[:, None, :] & ~eye)[..., None]
        nbr_w = weights[:, None, :, None].expand(C, R, R, 1)
        head = self.pooling[0]
        g = weighted_attention_dense(head.gate_nn(pair), nbr_w, head.pow,
                                     pair_mask, dim=2)
        return (g * head.message_nn(pair)).sum(dim=2) + fea


class Roost(nn.Module):
    """Composition GNN + weighted-attention crystal pooling
    (roost_message.py:159-264). Returns per-crystal features (C, fea_len)."""

    def __init__(self, orig_elem_fea_len, elem_fea_len, n_graph):
        super().__init__()
        self.embedding = TorchLinear(orig_elem_fea_len, elem_fea_len - 1)
        self.graphs = nn.ModuleList(MessageLayer(elem_fea_len)
                                    for _ in range(n_graph))
        self.cry_pool = nn.ModuleList([WeightedAttention(
            elem_fea_len, elem_fea_len, with_message=False)])

    def forward(self, comp_weight, comp_fea, comp_mask):
        fea = self.embedding(comp_fea)
        # the fractional weight is the last feature (roost_message.py:245)
        fea = torch.cat([fea, comp_weight[..., None].to(fea.dtype)], dim=-1)
        for layer in self.graphs:
            fea = layer(comp_weight, fea, comp_mask)
        pool = self.cry_pool[0]
        g = weighted_attention_dense(pool.gate_nn(fea), comp_weight[..., None],
                                     pool.pow, comp_mask[..., None], dim=1)
        return (g * fea).sum(dim=1)
