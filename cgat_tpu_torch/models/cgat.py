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
(a node-only stack), ``dropout`` (training only, with masks drawn on the
device from ``(seed, step, site)``, see :func:`dropout`), ``remat`` and
``hyper_remat`` (``torch.utils.checkpoint`` over each message-passing
layer or each ``HyperLinear``) and ``split_projection``.

The edge-sharded (halo) layout (a :class:`HaloBatch`) runs in one of two
ways. With ``edge_group`` (an edge axis of the mesh, one rank a shard) the
batch is this rank's part: its node slice, its local-src edge block (ids
inside the slice, so its gathers and per-edge networks need nothing from
the other ranks) and its halo-src block, whose sources index ``[local
nodes | received rows]``. Before each layer the boundary rows go to the
ranks that need them in one ``all_to_all``; each node layer aggregates
both blocks with the union softmax of the pair path (the segment-attention
kernels twice, forward and backward); the third gather plan, of the halo
block's destinations, takes the segment-sum kernel as its backward; the
crystal pool completes its per-crystal softmax with an all-gathered max
and a summed numerator and denominator. Without a group the whole sharded
layout runs in one process with the identity exchange (the JAX package's
single-device view, an oracle): its blocks interleave their padding, which
the kernels do not take, so that mode runs on the CPU only and raises on
a card.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.batching import OFFN_MARGIN, CrystalBatch, HaloBatch
from ..ops.attention import (edge_softmax_aggregate,
                             edge_softmax_aggregate_pair)
from ..ops.gather import GatherPlan, gather_rows
from ..ops.kernels.build import launch_scope
from ..ops.kernels.dropout import Dropout, site_key
from ..ops.segment import (NEG_BIG, SOFTMAX_EPS, segment_max,
                           segment_softmax, segment_softmax_pair,
                           segment_sum, take_rows)
from ..parallel.collectives import all_gather, all_reduce, all_to_all
from ..utils import counters
from ..utils.profiling import annotate
from .blocks import (MultiHeadNetwork, ResidualNetwork, SimpleNetwork,
                     TorchLinear)
from .hyper import HNet, HNet0, HyperLinear
from .roost import Roost

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the live edge updates run so far: [layers, edge rows through them]
_EDGE_UPDATES = counters.counter("edge_update", 2)


def edge_update_stats() -> dict[str, int]:
    """The live (``no_hyper=False``) edge updates this process has run, as
    ``native.collate_stats`` counts collates: ``layers``, the
    ``GATConvEdges`` forwards on the live path, and ``rows``, the edge
    slots through them. Counted as the forward runs on the host (under
    ``remat`` a layer's forward runs again in the backward and counts
    twice); a replay of a ``training.dispatch.StepGraphs`` graph adds
    what its capture counted (``utils.counters``)."""
    return {"layers": _EDGE_UPDATES[0], "rows": _EDGE_UPDATES[1]}


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


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """Where a training forward's dropout masks come from: the static
    ``path`` (seed, or (seed, dp_index, edge_index) on a rank of a parallel
    world) that each site extends with its own ids, and the step count
    ``step``, a 0-dim int64 tensor on the model's device that the trainer
    advances inside its step (so a CUDA graph of the step draws new masks
    at each replay)."""
    path: tuple[int, ...]
    step: torch.Tensor

    def site(self, *ids: int) -> "DropoutKey":
        return DropoutKey((*self.path, *ids), self.step)


def dropout(x, rate: float, key: DropoutKey):
    """``flax.linen.Dropout``: keep each entry with probability 1 - rate
    and scale the kept ones by 1 / (1 - rate) (as an f32 factor). The mask
    is drawn on ``x``'s device by the dropout kernel
    (``ops/kernels/dropout.py``: Philox keyed by the site's path, counted
    by the element and the device step), so a resumed run and a recomputed
    layer (``remat``) draw the same masks; they are not the JAX package's
    masks."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    return Dropout.apply(x, rate, site_key(*key.path), key.step)


@dataclasses.dataclass(frozen=True)
class Halo:
    """The halo block of one node layer in halo mode: its source ids into
    ``table`` ([local nodes | received rows]), its destination ids, edge
    features and mask, its destinations' CSR pointers (None: computed
    where needed) and their gather ``plan`` (None: plain indexing)."""
    src: torch.Tensor
    dst: torch.Tensor
    attr: torch.Tensor
    mask: torch.Tensor
    table: torch.Tensor
    offn: torch.Tensor | None
    plan: GatherPlan | None


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
    the sum, as in the JAX package, which then run as torch ops whose
    reductions and gathers are the segment-sum kernel (the dropout kernel
    between them)."""

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
                dst_offn, plans, dropout_key=None, halo: Halo | None = None):
        """``plans``: the :class:`GatherPlan` of ``edge_dst`` and of
        ``edge_src``, which route the gathers' backward through the
        segment-sum kernel (None in the one-process halo mode: plain
        indexing). ``dropout_key``: this site's :class:`DropoutKey` when
        dropout is active (training with ``dropout > 0``), else None.
        ``halo``: the halo block, whose edges the softmax normalises over
        with the primary (local) block's."""
        if halo is not None:
            return self._forward_halo(x, edge_src, edge_dst, edge_attr, x_0,
                                      edge_mask, dst_offn, plans,
                                      dropout_key, halo)
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
            if self._flat(drop):
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
            # the softmax's and the sum's reductions and gathers through
            # the segment-sum kernel (the destination plan): deterministic,
            # so a replayed dropout step gives an eager one's bits
            w = segment_softmax(alpha, edge_dst, n, mask=edge_mask,
                                plan=plans[0])
            w = dropout(w, self.dropout, dropout_key)
            weighted = torch.where(edge_mask[:, None, None], w * m,
                                   torch.zeros((), dtype=m.dtype,
                                               device=m.device))
            aggr = segment_sum(weighted, edge_dst, n, plans[0])
        else:
            aggr = edge_softmax_aggregate(alpha, m, edge_dst, n,
                                          edge_mask=edge_mask, offn=dst_offn)
        return self._update(x, x_0, aggr.mean(dim=1))    # CGAT.py:329

    def _flat(self, drop: bool) -> bool:
        return (not drop and self.vector_attention
                and self.MH_A.flat_supported()
                and self.MH_M.flat_supported())

    def _forward_halo(self, x, edge_src, edge_dst, edge_attr, x_0,
                      edge_mask, dst_offn, plans, dropout_key, h: Halo):
        """The layer over a local and a halo block (the JAX package's halo
        branch): both blocks' messages, the union softmax over them, the
        head mean and the hypernetwork update; ``split_projection`` does
        not apply here, as there."""
        n = x.shape[0]
        drop = dropout_key is not None
        m_cat = torch.cat([take_rows(x, edge_dst, plans and plans[0]),
                           edge_attr,
                           take_rows(x, edge_src, plans and plans[1])],
                          dim=-1)
        m_cat_h = torch.cat([take_rows(x, h.dst, h.plan), h.attr,
                             h.table[h.src.long()]], dim=-1)
        if self._flat(drop):
            # the MH kernel on both blocks, (E, H*F) into the pair path
            aggr = edge_softmax_aggregate_pair(
                self.MH_A(m_cat, flat=True), self.MH_M(m_cat, flat=True),
                edge_dst, edge_mask, self.MH_A(m_cat_h, flat=True),
                self.MH_M(m_cat_h, flat=True), h.dst, h.mask, n,
                offn_l=dst_offn, offn_h=h.offn)
            aggr = aggr.view(n, self.heads, self.out_channels)
            return self._update(x, x_0,
                                aggr.float().mean(dim=1).to(aggr.dtype))
        alpha, m = self.MH_A(m_cat), self.MH_M(m_cat)
        alpha_h, m_h = self.MH_A(m_cat_h), self.MH_M(m_cat_h)
        if drop:
            # through the segment-sum kernel with the blocks' plans, as
            # the single-shard dropout path: deterministic sums
            plan = plans and plans[0]
            w, w_h = segment_softmax_pair(alpha, edge_dst, edge_mask,
                                          alpha_h, h.dst, h.mask, n,
                                          plan_a=plan, plan_b=h.plan)
            w = dropout(w, self.dropout, dropout_key)
            w_h = dropout(w_h, self.dropout, dropout_key.site(1))
            zero = torch.zeros((), dtype=m.dtype, device=m.device)
            aggr = (segment_sum(torch.where(edge_mask[:, None, None], w * m,
                                            zero), edge_dst, n, plan)
                    + segment_sum(torch.where(h.mask[:, None, None],
                                              w_h * m_h, zero), h.dst, n,
                                  h.plan))
        else:
            aggr = edge_softmax_aggregate_pair(
                alpha, m, edge_dst, edge_mask, alpha_h, m_h, h.dst, h.mask,
                n, offn_l=dst_offn, offn_h=h.offn)
        return self._update(x, x_0, aggr.mean(dim=1))

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
    or HNet on the edge feature. The live update runs inside the span
    ``edge_update`` (``utils.profiling.annotate``) and the launch scope of
    that name (``ops.kernels.build.launch_scope``), and counts itself in
    :func:`edge_update_stats`."""

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
                dropout_key=None, src_table=None):
        """The update of ``edge_attr`` (only it is read under
        ``no_hyper``) from the node features ``x``, the edge ids, the first
        layer's edge features and the gather ``plans`` of (``edge_dst``,
        ``edge_src``) (None, or a None plan: plain indexing). The sources
        index ``src_table`` instead of ``x`` when it is given (a halo
        block's [local nodes | received rows])."""
        if self.no_hyper:
            return self.Pooling_NN(edge_attr)
        with annotate("edge_update"), launch_scope("edge_update"):
            _EDGE_UPDATES[0] += 1
            _EDGE_UPDATES[1] += edge_attr.shape[0]
            src_rows = (take_rows(x, edge_src, plans and plans[1])
                        if src_table is None
                        else src_table[edge_src.long()])
            m_cat = torch.cat([src_rows, edge_attr,
                               take_rows(x, edge_dst, plans and plans[0])],
                              dim=-1)
            alpha = torch.exp(self.MH_A(m_cat))
            alpha = alpha / alpha.sum(dim=1, keepdim=True)  # across heads
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
                offn, plan, edge_group=None):
        """``edge_group``: the edge axis the atoms are cut over. Each rank
        then pools its own atoms and completes every crystal's softmax
        with (C, H, F) collectives: the max all-gathered, the numerator and
        denominator summed (as the JAX package does under ``axis_name``,
        with gradients through all three; the gathers and sums go
        through the segment-sum kernel with ``plan``, so they are
        deterministic)."""
        m = self.MH_M(fea)
        alpha = self.MH_A(torch.cat([fea, take_rows(cry_fea, node2graph,
                                                  plan)], dim=-1))
        if edge_group is None:
            agg = edge_softmax_aggregate(alpha, m, node2graph, num_graphs,
                                         edge_mask=node_mask, offn=offn)
            return agg.reshape(-1, self.heads * self.out_channels)
        m = m.expand(m.shape[0], self.heads, self.out_channels)
        keep = node_mask[:, None, None]
        masked = torch.where(keep, alpha, torch.full_like(alpha, NEG_BIG))
        gmax = all_gather(segment_max(masked, node2graph, num_graphs),
                          edge_group.group).amax(dim=0)
        ex = torch.where(keep, torch.exp(alpha - take_rows(gmax, node2graph,
                                                           plan)),
                         torch.zeros_like(alpha))
        num, den = all_reduce(
            torch.stack(torch.broadcast_tensors(
                segment_sum(ex * m, node2graph, num_graphs, plan),
                segment_sum(ex, node2graph, num_graphs, plan))),
            edge_group.group)
        agg = num / (den + SOFTMAX_EPS)
        return agg.reshape(-1, self.heads * self.out_channels)


class _Layout:
    """The index arrays, gather plans and CSR pointers one forward uses,
    for the batch's layout: single-shard (the collate's plans), a rank's
    part of an edge-sharded batch (ids made local to its node slice, the
    third plan of the halo block's destinations, the boundary exchange),
    or a whole edge-sharded batch in one process (global ids, plain
    gathers, the identity exchange; CPU only)."""

    def __init__(self, batch: CrystalBatch, edge_group):
        self.halo = isinstance(batch, HaloBatch)
        if edge_group is not None and not self.halo:
            raise ValueError("an edge group needs an edge-sharded batch "
                             "(collate with edge_shards > 1)")
        if not self.halo:
            self.src, self.dst = batch.edge_src, batch.edge_dst
            self.offn = batch.edge_dst_offn
            self.plans = (GatherPlan(batch.edge_dst, None, batch.edge_dst_offn),
                          GatherPlan(batch.edge_src_sorted,
                                     batch.edge_src_perm, batch.edge_src_offn))
            self.pool_plan = GatherPlan(batch.node2graph, None,
                                        batch.node2graph_offn)
            return
        if edge_group is None:
            if batch.nodes.is_cuda:
                raise ValueError(
                    "a whole edge-sharded batch in one process runs on the "
                    "CPU only (its blocks interleave their padding, which "
                    "the kernels do not take); on a card run one rank a "
                    "shard with an edge group")
            self.src, self.dst = batch.edge_src, batch.edge_dst
            self.src_h, self.dst_h = batch.halo_src, batch.halo_dst
            self.offn = self.offn_h = self.plans = self.plan_h = None
            self.pool_plan = None
            self.exchange = lambda x: x
            return
        offset = edge_group.index * batch.nodes.shape[0]
        self.src = batch.edge_src - offset
        self.dst = batch.edge_dst - offset
        self.dst_h = batch.halo_dst - offset
        self.src_h = batch.halo_src_ext
        self.offn, self.offn_h = batch.edge_dst_offn, batch.halo_dst_offn
        self.plans = (GatherPlan(self.dst, None, batch.edge_dst_offn),
                      GatherPlan(batch.edge_src_sorted, batch.edge_src_perm,
                                 batch.edge_src_offn))
        self.plan_h = GatherPlan(self.dst_h, None, batch.halo_dst_offn)
        # the pool's plan over this rank's node slice (the collate ships
        # none for a sharded batch): its crystal ids are sorted, so their
        # CSR pointers are one search on the device
        ids = batch.node2graph
        self.pool_plan = GatherPlan(ids, None, torch.searchsorted(
            ids, torch.arange(batch.num_graphs + OFFN_MARGIN + 1,
                              dtype=ids.dtype, device=ids.device),
            out_int32=True))
        send = batch.halo_send_idx

        def exchange(x):
            """[x | the boundary rows the other shards send this one]."""
            recv = all_to_all(x[send.long()], edge_group.group)
            return torch.cat([x, recv.reshape(-1, x.shape[-1])])

        self.exchange = exchange


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
              dropout_key: DropoutKey | None = None,
              edge_group=None) -> torch.Tensor:
        """Graph embeddings (C, embedding_dim): everything before the head.
        ``dropout_key``: the training step's :class:`DropoutKey`, which
        dropout (training mode with ``dropout > 0``) draws its masks from
        (its path (seed,), or (seed, dp_index, edge_index) on a rank, each
        site adding its own ids); such a forward without one raises, as a
        flax ``Dropout`` without its rng does.
        ``edge_group``: the mesh's edge :class:`~..parallel.mesh.Axis` when
        ``batch`` is this rank's part of an edge-sharded batch (see the
        module's docstring)."""
        cfg = self.config
        drop = self.training and cfg.dropout > 0.0
        if drop and dropout_key is None:
            raise ValueError(
                f"dropout {cfg.dropout} in training mode needs a "
                f"dropout_key (a DropoutKey); call .eval() for inference")
        dt = cfg.dtype
        lay = _Layout(batch, edge_group)
        edge_attr = self.nbr_embedding(batch.edge_shell).to(dt)
        elem_fea = self.embedding(batch.nodes)
        elem_fea_0, edge_attr_0 = elem_fea, edge_attr
        if lay.halo:
            edge_attr_h = self.nbr_embedding(batch.halo_shell).to(dt)
            edge_attr_h_0 = edge_attr_h
        # rematerialise each message-passing module in the backward
        # (nn.remat over GATConvNodes and GATConvEdges in the JAX package)
        remat = cfg.remat and torch.is_grad_enabled()
        run = (lambda f, *a, **k: checkpoint(f, *a, use_reentrant=False,
                                             **k)) if remat else \
            (lambda f, *a, **k: f(*a, **k))
        last = len(self.graphs) - 1
        for i, layer in enumerate(self.graphs):
            key = dropout_key.site(2 * i) if drop else None
            halo = None
            if lay.halo:
                table = lay.exchange(elem_fea)
                halo = Halo(lay.src_h, lay.dst_h, edge_attr_h,
                            batch.halo_mask, table, lay.offn_h, lay.plan_h)
            node_update = run(
                layer.Node, elem_fea, lay.src, lay.dst, edge_attr,
                elem_fea_0, batch.edge_mask, dst_offn=lay.offn,
                plans=lay.plans, dropout_key=key, halo=halo)
            # nothing reads the last layer's edge update: the live
            # (no_hyper=False) one is skipped, its parameters kept for
            # checkpoint parity (no gradient, as in the JAX package, whose
            # XLA drops it); the default path's MLP still runs there
            if layer.Edge is not None and (cfg.no_hyper or i < last):
                key = dropout_key.site(2 * i + 1) if drop else None
                edge_attr = edge_attr + run(
                    layer.Edge, edge_attr, elem_fea, lay.src, lay.dst,
                    edge_attr_0, lay.plans, dropout_key=key)
                if lay.halo:
                    edge_attr_h = edge_attr_h + run(
                        layer.Edge, edge_attr_h, elem_fea, lay.src_h,
                        lay.dst_h, edge_attr_h_0, (lay.plan_h, None),
                        dropout_key=key and key.site(1), src_table=table)
            elem_fea = elem_fea + node_update
        crys_fea = self.roost(batch.comp_weight, batch.comp_fea.to(dt),
                              batch.comp_mask)
        crys_fea = self.cry_pool(
            elem_fea, crys_fea, batch.node2graph, batch.node_mask,
            batch.num_graphs, offn=batch.node2graph_offn,
            plan=lay.pool_plan, edge_group=edge_group)
        if cfg.mean_pooling:
            crys_fea = crys_fea.view(-1, cfg.msg_heads,
                                     cfg.elem_fea_len).mean(dim=1)
        return crys_fea

    def head(self, crys_fea, *, last_layer=True) -> torch.Tensor:
        """The residual output head on graph embeddings, as f32."""
        return self.output_nn(crys_fea, last_layer=last_layer).float()

    def forward(self, batch: CrystalBatch, *, last_layer=True,
                return_graph_embedding=False,
                dropout_key: DropoutKey | None = None,
                edge_group=None):
        """The output (C, 2) as f32, or the graph embeddings;
        ``dropout_key`` and ``edge_group`` as in :meth:`embed`."""
        crys_fea = self.embed(batch, dropout_key=dropout_key,
                              edge_group=edge_group)
        if return_graph_embedding:
            return crys_fea
        return self.head(crys_fea, last_layer=last_layer)
