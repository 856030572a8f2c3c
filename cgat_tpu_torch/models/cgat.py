"""CGAtNet: crystal-graph attention network (torch.nn), single device.

Counterpart of ``cgat_tpu/models/cgat.py`` (reference CGAT/CGAT.py) with
the JAX package's production kernels engaged wherever they engage there:

  element embedding -> shell-index edge embedding -> n_graph x (node
  attention message passing + edge MLP update) with residual adds ->
  Roost composition feature -> global multi-head attention pool -> deep
  residual output head emitting (output, log_std).

Per forward at the reference defaults in bf16 that is 2 ``mh_network``,
1 ``segment_attention`` and 4 ``hyper_apply`` launches per message-passing
layer plus one ``segment_attention`` for the crystal pool. Each of those
ops is an autograd Function whose backward is a kernel too, and the two
node gathers per layer and the pool's crystal gather take the segment-sum
kernel as their backward (``ops/gather.py``), so a training step launches
as many backward kernels per op, plus 11 segment sums.

The parameters stay in their own dtype (f32 masters for training) and
every layer casts them to ``config.dtype`` at use; ``to_compute_dtype()``
casts them once for serving, which makes those casts no-ops.

Not ported yet: the edge-sharded (halo) layout, dropout, ``no_hyper=False``
and ``update_edges=False``.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..data.batching import CrystalBatch
from ..ops.attention import edge_softmax_aggregate
from ..ops.gather import GatherPlan, gather_rows
from .blocks import (MultiHeadNetwork, ResidualNetwork, SimpleNetwork,
                     TorchLinear)
from .hyper import HNet, HNet0, HyperLinear
from .roost import Roost

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class CGATConfig:
    """Model hyperparameters; defaults are the reference's effective
    defaults. The fields are the JAX package's ``CGATConfig`` less its
    training-only ones (``dropout``, ``split_projection``, ``remat``,
    ``hyper_remat``), which do not change the inference forward."""
    orig_elem_fea_len: int = 200
    elem_fea_len: int = 128
    n_graph: int = 5
    nbr_embedding_size: int = 128
    neighbor_number: int = 24
    mean_pooling: bool = False        # heads concatenated (effective default)
    rezero: bool = True
    msg_heads: int = 5
    update_edges: bool = True
    vector_attention: bool = True
    global_vector_attention: bool = True
    n_graph_roost: int = 3
    no_hyper: bool = True
    out_hidden: tuple = (1024, 1024, 512, 512, 256, 256, 128)
    compute_dtype: str = "float32"    # "bfloat16" for mixed precision

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def embedding_dim(self) -> int:
        """Graph-embedding width."""
        return (self.elem_fea_len if self.mean_pooling
                else self.elem_fea_len * self.msg_heads)


def _hnet_args(c):
    # HNet(0)(hyper_in, 3 hyper hidden layers, hyper width, hidden width,
    # 2 hidden layers, in, out) as CGAT.py:300-305 builds them
    return (c, 3, c, c, 2, c, c)


class GATConvNodes(nn.Module):
    """Node attention message passing (CGAT.py:233-335): per edge, the
    concat [x_dst, e, x_src] feeds multi-head gate and message networks,
    a segment softmax over each destination's in-edges weights the
    messages, heads are averaged, and a hypernetwork updates the node."""

    def __init__(self, in_channels, out_channels, nbr_channels, heads,
                 vector_attention, first):
        super().__init__()
        cat_dim = 2 * in_channels + nbr_channels
        hidden = int(cat_dim / 1.5)
        self.heads = heads
        self.out_channels = out_channels
        self.vector_attention = vector_attention
        self.first = first
        self.MH_A = MultiHeadNetwork(
            cat_dim, out_channels if vector_attention else 1, hidden, heads)
        self.MH_M = MultiHeadNetwork(cat_dim, out_channels, hidden, heads)
        hnet = HNet0 if first else HNet
        self.Pooling_NN = hnet(*_hnet_args(out_channels))

    def forward(self, x, edge_src, edge_dst, edge_attr, x_0, edge_mask,
                dst_offn, plans):
        """``plans``: the :class:`GatherPlan` of ``edge_dst`` and of
        ``edge_src``, which route the gathers' backward through the
        segment-sum kernel."""
        n = x.shape[0]
        m_cat = torch.cat([gather_rows(x, edge_dst, plans[0]), edge_attr,
                           gather_rows(x, edge_src, plans[1])], dim=-1)
        if (self.vector_attention and self.MH_A.flat_supported()
                and self.MH_M.flat_supported()):
            # flat path: (E, H*F) head-major tensors straight from the MH
            # kernel into the segment-attention kernel, no 3-D relayout
            alpha = self.MH_A(m_cat, flat=True)
            m = self.MH_M(m_cat, flat=True)
            aggr = edge_softmax_aggregate(alpha, m, edge_dst, n,
                                          edge_mask=edge_mask, offn=dst_offn)
            aggr = aggr.view(n, self.heads, self.out_channels)
            aggr = aggr.float().mean(dim=1).to(aggr.dtype)
        else:
            alpha = self.MH_A(m_cat)
            m = self.MH_M(m_cat)
            aggr = edge_softmax_aggregate(alpha, m, edge_dst, n,
                                          edge_mask=edge_mask, offn=dst_offn)
            aggr = aggr.mean(dim=1)                 # CGAT.py:329
        if self.first:
            return self.Pooling_NN(x, aggr)
        return self.Pooling_NN(x_0, x, aggr)


class GATConvEdges(nn.Module):
    """Edge embedding update (CGAT.py:115-230) under the default
    ``no_hyper=True``: an MLP of the edge feature. The reference overwrites
    its attention aggregate (CGAT.py:224-225), so ``MH_A``/``MH_M`` hold
    parameters (checkpoint parity) but are never computed."""

    def __init__(self, in_channels, out_channels, nbr_channels, heads,
                 vector_attention):
        super().__init__()
        cat_dim = 2 * in_channels + nbr_channels
        hidden = int(cat_dim / 1.5)
        self.MH_A = MultiHeadNetwork(
            cat_dim, out_channels if vector_attention else 1, hidden, heads)
        self.MH_M = MultiHeadNetwork(cat_dim, out_channels, hidden, heads)
        self.Pooling_NN = SimpleNetwork(nbr_channels, out_channels,
                                        [out_channels])

    def forward(self, edge_attr):
        return self.Pooling_NN(edge_attr)


class GraphLayer(nn.Module):
    """One message-passing layer: ``Node`` and ``Edge`` (CGAT.py:389-404)."""

    def __init__(self, node, edge):
        super().__init__()
        self.Node = node
        self.Edge = edge


class MHAttention(nn.Module):
    """Global crystal pooling (CGAT.py:14-62): a per-atom gate from
    ``[atom_fea || crystal_fea[graph]]``, a segment softmax over the atoms
    of each crystal, heads concatenated to (C, heads*out)."""

    def __init__(self, in_channels, out_channels, heads, vector_attention):
        super().__init__()
        self.heads = heads
        self.out_channels = out_channels
        self.MH_M = MultiHeadNetwork(in_channels, out_channels, in_channels,
                                     heads)
        self.MH_A = MultiHeadNetwork(
            2 * in_channels, out_channels if vector_attention else 1,
            in_channels, heads)

    def forward(self, fea, cry_fea, node2graph, node_mask, num_graphs,
                offn, plan):
        m = self.MH_M(fea)
        alpha = self.MH_A(torch.cat([fea, gather_rows(cry_fea, node2graph,
                                                      plan)], dim=-1))
        agg = edge_softmax_aggregate(alpha, m, node2graph, num_graphs,
                                     edge_mask=node_mask, offn=offn)
        return agg.reshape(-1, self.heads * self.out_channels)


class CGAtNet(nn.Module):
    """Full model (CGAT.py:343-613). ``forward(batch)`` -> (C, 2) f32."""

    def __init__(self, config: CGATConfig):
        super().__init__()
        if not config.no_hyper or not config.update_edges:
            raise NotImplementedError(
                "the port runs the reference defaults no_hyper=True and "
                "update_edges=True; other variants are not ported yet")
        cfg = self.config = config
        c = cfg.elem_fea_len
        self.embedding = TorchLinear(cfg.orig_elem_fea_len, c, bias=False)
        self.nbr_embedding = nn.Embedding(cfg.neighbor_number + 1,
                                          cfg.nbr_embedding_size)
        self.graphs = nn.ModuleList(
            GraphLayer(
                GATConvNodes(c, c, cfg.nbr_embedding_size, cfg.msg_heads,
                             cfg.vector_attention, first=(i == 0)),
                GATConvEdges(c, cfg.nbr_embedding_size,
                             cfg.nbr_embedding_size, cfg.msg_heads,
                             cfg.vector_attention))
            for i in range(cfg.n_graph))
        self.roost = Roost(cfg.orig_elem_fea_len, c, cfg.n_graph_roost)
        self.cry_pool = MHAttention(c, c, cfg.msg_heads,
                                    cfg.global_vector_attention)
        self.output_nn = ResidualNetwork(cfg.embedding_dim, 2,
                                         list(cfg.out_hidden),
                                         if_rezero=cfg.rezero)
        for mod in self.modules():
            if isinstance(mod, (TorchLinear, MultiHeadNetwork, HyperLinear)):
                mod.compute_dtype = cfg.dtype

    def to_compute_dtype(self) -> "CGAtNet":
        """Cast the weights to the config's compute dtype once, for serving;
        the forward's casts at use then do nothing. The scalar gates
        (``damping``, ``pow``, the ReZero ``alpha``) stay f32 because the
        JAX model computes with them in f32."""
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] not in ("damping", "pow", "alpha"):
                p.data = p.data.to(self.config.dtype)
        return self

    def embed(self, batch: CrystalBatch) -> torch.Tensor:
        """Graph embeddings (C, embedding_dim): everything before the head."""
        cfg = self.config
        dt = cfg.dtype
        # one gather plan per index array, shared by all layers
        plans = (GatherPlan(batch.edge_dst, None, batch.edge_dst_offn),
                 GatherPlan(batch.edge_src_sorted, batch.edge_src_perm,
                            batch.edge_src_offn))
        edge_attr = self.nbr_embedding(batch.edge_shell).to(dt)
        elem_fea = self.embedding(batch.nodes)
        elem_fea_0 = elem_fea
        for layer in self.graphs:
            node_update = layer.Node(
                elem_fea, batch.edge_src, batch.edge_dst, edge_attr,
                elem_fea_0, batch.edge_mask, dst_offn=batch.edge_dst_offn,
                plans=plans)
            edge_attr = edge_attr + layer.Edge(edge_attr)
            elem_fea = elem_fea + node_update
        crys_fea = self.roost(batch.comp_weight, batch.comp_fea.to(dt),
                              batch.comp_mask)
        crys_fea = self.cry_pool(
            elem_fea, crys_fea, batch.node2graph, batch.node_mask,
            batch.num_graphs, offn=batch.node2graph_offn,
            plan=GatherPlan(batch.node2graph, None, batch.node2graph_offn))
        if cfg.mean_pooling:
            crys_fea = crys_fea.view(-1, cfg.msg_heads,
                                     cfg.elem_fea_len).mean(dim=1)
        return crys_fea

    def head(self, crys_fea, *, last_layer=True) -> torch.Tensor:
        """The residual output head on graph embeddings, as f32."""
        return self.output_nn(crys_fea, last_layer=last_layer).float()

    def forward(self, batch: CrystalBatch, *, last_layer=True,
                return_graph_embedding=False):
        crys_fea = self.embed(batch)
        if return_graph_embedding:
            return crys_fea
        return self.head(crys_fea, last_layer=last_layer)
