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

The variants of the JAX package's ``CGATConfig`` are here too:
``no_hyper=False`` (the live edge update: head-normalised attention over
``[x_src, e, x_dst]`` conditioning HNet0 / HNet on every edge row, so the
``hyper_apply`` kernels run on E rows as well as N), ``update_edges=False``
(a node-only stack), ``dropout`` (training only, with masks drawn from
``(seed, step, site)``, see :func:`dropout`), ``remat`` and ``hyper_remat``
(``torch.utils.checkpoint`` over each message-passing layer or each
``HyperLinear``) and ``split_projection``. Not ported yet: the
edge-sharded (halo) layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.batching import CrystalBatch
from ..ops.attention import edge_softmax_aggregate
from ..ops.gather import GatherPlan, gather_rows
from ..ops.segment import segment_softmax, segment_sum
from .blocks import (MultiHeadNetwork, ResidualNetwork, SimpleNetwork,
                     TorchLinear)
from .hyper import HNet, HNet0, HyperLinear
from .roost import Roost

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class CGATConfig:
    """Model hyperparameters; defaults are the reference's effective
    defaults. The fields are the JAX package's ``CGATConfig``: ``dropout``
    acts in training only; ``split_projection`` (``fc_in`` per node, the
    projections gathered per edge: the same function on the einsum path),
    ``remat`` and ``hyper_remat`` (recompute each message-passing layer or
    each ``HyperLinear`` in the backward) change how, not what, the model
    computes."""
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
    dropout: float = 0.0
    out_hidden: tuple = (1024, 1024, 512, 512, 256, 256, 128)
    compute_dtype: str = "float32"    # "bfloat16" for mixed precision
    split_projection: bool = False
    remat: bool = False
    hyper_remat: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def embedding_dim(self) -> int:
        """Graph-embedding width."""
        return (self.elem_fea_len if self.mean_pooling
                else self.elem_fea_len * self.msg_heads)


def _seed(seed: int, step: int, site: int) -> int:
    """A generator seed for one dropout site of one training step."""
    state = np.random.SeedSequence([seed, step, site]).generate_state(2)
    return int(state[0]) << 31 | int(state[1]) >> 1


def dropout(x, rate: float, key: tuple[int, int, int]):
    """``flax.linen.Dropout``: keep each entry with probability 1 - rate
    and scale the kept ones by 1 / (1 - rate). The mask comes from a
    generator on ``x``'s device seeded from ``key`` = (seed, step, site),
    so a resumed run and a recomputed layer (``remat``) draw the same
    masks; they are not the JAX package's masks."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    gen = torch.Generator(device=x.device).manual_seed(_seed(*key))
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _hnet_args(c):
    # HNet(0)(hyper_in, 3 hyper hidden layers, hyper width, hidden width,
    # 2 hidden layers, in, out) as CGAT.py:300-305 builds them
    return (c, 3, c, c, 2, c, c)


class GATConvNodes(nn.Module):
    """Node attention message passing (CGAT.py:233-335): per edge, the
    concat [x_dst, e, x_src] feeds multi-head gate and message networks,
    a segment softmax over each destination's in-edges weights the
    messages, heads are averaged, and a hypernetwork updates the node.
    Under training dropout the weights are dropped between the softmax and
    the sum, which then run as plain torch ops, as in the JAX package."""

    def __init__(self, in_channels, out_channels, nbr_channels, heads,
                 vector_attention, first, dropout=0.0,
                 split_projection=False):
        super().__init__()
        cat_dim = 2 * in_channels + nbr_channels
        hidden = int(cat_dim / 1.5)
        self.heads = heads
        self.out_channels = out_channels
        self.vector_attention = vector_attention
        self.first = first
        self.dropout = dropout
        self.split_projection = split_projection
        self.MH_A = MultiHeadNetwork(
            cat_dim, out_channels if vector_attention else 1, hidden, heads)
        self.MH_M = MultiHeadNetwork(cat_dim, out_channels, hidden, heads)
        hnet = HNet0 if first else HNet
        self.Pooling_NN = hnet(*_hnet_args(out_channels))

    def forward(self, x, edge_src, edge_dst, edge_attr, x_0, edge_mask,
                dst_offn, plans, dropout_key=None):
        """``plans``: the :class:`GatherPlan` of ``edge_dst`` and of
        ``edge_src``, which route the gathers' backward through the
        segment-sum kernel. ``dropout_key``: (seed, step, site) when
        dropout is active (training with ``dropout > 0``), else None."""
        n = x.shape[0]
        drop = dropout_key is not None
        if self.split_projection:
            parts = [(x, edge_dst), (edge_attr, None), (x, edge_src)]
            alpha = self.MH_A(split_parts=parts)
            m = self.MH_M(split_parts=parts)
        else:
            m_cat = torch.cat([gather_rows(x, edge_dst, plans[0]),
                               edge_attr,
                               gather_rows(x, edge_src, plans[1])], dim=-1)
            if (not drop and self.vector_attention
                    and self.MH_A.flat_supported()
                    and self.MH_M.flat_supported()):
                # flat path: (E, H*F) head-major tensors straight from the
                # MH kernel into the segment-attention kernel, no 3-D
                # relayout
                alpha = self.MH_A(m_cat, flat=True)
                m = self.MH_M(m_cat, flat=True)
                aggr = edge_softmax_aggregate(alpha, m, edge_dst, n,
                                              edge_mask=edge_mask,
                                              offn=dst_offn)
                aggr = aggr.view(n, self.heads, self.out_channels)
                return self._update(x, x_0,
                                    aggr.float().mean(dim=1).to(aggr.dtype))
            alpha = self.MH_A(m_cat)
            m = self.MH_M(m_cat)
        if drop:
            w = segment_softmax(alpha, edge_dst, n, mask=edge_mask)
            w = dropout(w, self.dropout, dropout_key)
            weighted = torch.where(edge_mask[:, None, None], w * m,
                                   torch.zeros((), dtype=m.dtype,
                                               device=m.device))
            aggr = segment_sum(weighted, edge_dst, n)
        else:
            aggr = edge_softmax_aggregate(alpha, m, edge_dst, n,
                                          edge_mask=edge_mask, offn=dst_offn)
        return self._update(x, x_0, aggr.mean(dim=1))    # CGAT.py:329

    def _update(self, x, x_0, aggr):
        if self.first:
            return self.Pooling_NN(x, aggr)
        return self.Pooling_NN(x_0, x, aggr)


class GATConvEdges(nn.Module):
    """Edge embedding update (CGAT.py:115-230).

    ``no_hyper=True`` (the default): an MLP of the edge feature. The
    reference overwrites its attention aggregate (CGAT.py:224-225), so
    ``MH_A``/``MH_M`` hold parameters (checkpoint parity) but are never
    computed.

    ``no_hyper=False``: the live path (JAX ``cgat.py:308-326``). Per edge
    the concat [x_src, e, x_dst] (the node layer's order reversed) feeds
    MH_A and MH_M on the einsum path; ``alpha = exp(MH_A)`` is normalised
    across heads (no segment softmax, no max subtracted, in the compute
    dtype, as in the JAX package), dropped under training dropout, and
    weights the messages; their head mean conditions HNet0 (first layer)
    or HNet on the edge feature."""

    def __init__(self, in_channels, out_channels, nbr_channels, heads,
                 vector_attention, first=False, no_hyper=True, dropout=0.0):
        super().__init__()
        cat_dim = 2 * in_channels + nbr_channels
        hidden = int(cat_dim / 1.5)
        self.heads = heads
        self.out_channels = out_channels
        self.first = first
        self.no_hyper = no_hyper
        self.dropout = dropout
        self.MH_A = MultiHeadNetwork(
            cat_dim, out_channels if vector_attention else 1, hidden, heads)
        self.MH_M = MultiHeadNetwork(cat_dim, out_channels, hidden, heads)
        if no_hyper:
            self.Pooling_NN = SimpleNetwork(nbr_channels, out_channels,
                                            [out_channels])
        else:
            hnet = HNet0 if first else HNet
            self.Pooling_NN = hnet(*_hnet_args(out_channels))

    def forward(self, edge_attr, x, edge_src, edge_dst, edge_attr_0, plans,
                dropout_key=None):
        """The update of ``edge_attr`` (only it is read under
        ``no_hyper``) from the node features ``x``, the edge ids, the first
        layer's edge features and the gather ``plans`` of (``edge_dst``,
        ``edge_src``)."""
        if self.no_hyper:
            return self.Pooling_NN(edge_attr)
        m_cat = torch.cat([gather_rows(x, edge_src, plans[1]), edge_attr,
                           gather_rows(x, edge_dst, plans[0])], dim=-1)
        alpha = torch.exp(self.MH_A(m_cat))
        alpha = alpha / alpha.sum(dim=1, keepdim=True)      # across heads
        if dropout_key is not None:
            alpha = dropout(alpha, self.dropout, dropout_key)
        m = self.MH_M(m_cat)
        aggr = (m.reshape(-1, self.heads, self.out_channels)
                * alpha).mean(dim=1)
        if self.first:
            return self.Pooling_NN(edge_attr, aggr)
        return self.Pooling_NN(edge_attr_0, edge_attr, aggr)


class GraphLayer(nn.Module):
    """One message-passing layer: ``Node`` and ``Edge`` (CGAT.py:389-404);
    ``Edge`` is None in a node-only stack (``update_edges=False``)."""

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
        cfg = self.config = config
        c = cfg.elem_fea_len
        self.embedding = TorchLinear(cfg.orig_elem_fea_len, c, bias=False)
        self.nbr_embedding = nn.Embedding(cfg.neighbor_number + 1,
                                          cfg.nbr_embedding_size)
        self.graphs = nn.ModuleList(
            GraphLayer(
                GATConvNodes(c, c, cfg.nbr_embedding_size, cfg.msg_heads,
                             cfg.vector_attention, first=(i == 0),
                             dropout=cfg.dropout,
                             split_projection=cfg.split_projection),
                GATConvEdges(c, cfg.nbr_embedding_size,
                             cfg.nbr_embedding_size, cfg.msg_heads,
                             cfg.vector_attention, first=(i == 0),
                             no_hyper=cfg.no_hyper, dropout=cfg.dropout)
                if cfg.update_edges else None)
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
            if isinstance(mod, HyperLinear):
                mod.remat = cfg.hyper_remat

    def to_compute_dtype(self) -> "CGAtNet":
        """Cast the weights to the config's compute dtype once, for serving;
        the forward's casts at use then do nothing. The scalar gates
        (``damping``, ``pow``, the ReZero ``alpha``) stay f32 because the
        JAX model computes with them in f32."""
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1] not in ("damping", "pow", "alpha"):
                p.data = p.data.to(self.config.dtype)
        return self

    def embed(self, batch: CrystalBatch, *,
              dropout_key: tuple[int, int] | None = None) -> torch.Tensor:
        """Graph embeddings (C, embedding_dim): everything before the head.
        ``dropout_key``: the (seed, step) of the training step, which
        dropout (training mode with ``dropout > 0``) draws its masks from;
        such a forward without one raises, as a flax ``Dropout`` without
        its rng does."""
        cfg = self.config
        drop = self.training and cfg.dropout > 0.0
        if drop and dropout_key is None:
            raise ValueError(
                f"dropout {cfg.dropout} in training mode needs a "
                f"dropout_key (seed, step); call .eval() for inference")
        dt = cfg.dtype
        # one gather plan per index array, shared by all layers
        plans = (GatherPlan(batch.edge_dst, None, batch.edge_dst_offn),
                 GatherPlan(batch.edge_src_sorted, batch.edge_src_perm,
                            batch.edge_src_offn))
        edge_attr = self.nbr_embedding(batch.edge_shell).to(dt)
        elem_fea = self.embedding(batch.nodes)
        elem_fea_0, edge_attr_0 = elem_fea, edge_attr
        # rematerialise each message-passing module in the backward
        # (nn.remat over GATConvNodes and GATConvEdges in the JAX package)
        remat = cfg.remat and torch.is_grad_enabled()
        run = (lambda f, *a, **k: checkpoint(f, *a, use_reentrant=False,
                                             **k)) if remat else \
            (lambda f, *a, **k: f(*a, **k))
        last = len(self.graphs) - 1
        for i, layer in enumerate(self.graphs):
            key = (*dropout_key, 2 * i) if drop else None
            node_update = run(
                layer.Node, elem_fea, batch.edge_src, batch.edge_dst,
                edge_attr, elem_fea_0, batch.edge_mask,
                dst_offn=batch.edge_dst_offn, plans=plans, dropout_key=key)
            # nothing reads the last layer's edge update: the live
            # (no_hyper=False) one is skipped, its parameters kept for
            # checkpoint parity (no gradient, as in the JAX package, whose
            # XLA drops it); the default path's MLP still runs there
            if layer.Edge is not None and (cfg.no_hyper or i < last):
                key = (*dropout_key, 2 * i + 1) if drop else None
                edge_attr = edge_attr + run(
                    layer.Edge, edge_attr, elem_fea, batch.edge_src,
                    batch.edge_dst, edge_attr_0, plans, dropout_key=key)
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
                return_graph_embedding=False,
                dropout_key: tuple[int, int] | None = None):
        """The output (C, 2) as f32, or the graph embeddings;
        ``dropout_key`` as in :meth:`embed`."""
        crys_fea = self.embed(batch, dropout_key=dropout_key)
        if return_graph_embedding:
            return crys_fea
        return self.head(crys_fea, last_layer=last_layer)
