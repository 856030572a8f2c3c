"""Static-shape batched crystal graphs as torch tensors (single shard).

Counterpart of ``cgat_tpu/data/batching.py``. The host-side layout is the
same numpy code, so a batch collated here equals the JAX package's batch
field for field:

* nodes and edges of all crystals are concatenated with index offsetting;
* edges are sorted by destination node, so every node's in-edges form one
  contiguous run (the segment-attention kernel reads them through CSR
  pointers);
* the Roost composition graph is stored dense per crystal, ``(C, R, ...)``.

Padding protocol: padded nodes and edges are a False suffix of their mask;
padded edges point at node slot ``N - 1`` and padded nodes belong to graph
slot ``C - 1``. Masks keep them out of every reduction.

Only the single-shard collate is here; the edge-sharded (halo) layout is not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass
class CrystalGraph:
    """Host-side featurised crystal (numpy). One entry of a prepared dataset."""
    atom_fea: np.ndarray      # (n, orig_fea) f32
    edge_src: np.ndarray      # (n*k,) i32   self_fea_idx
    edge_dst: np.ndarray      # (n*k,) i32   nbr_fea_idx
    edge_shell: np.ndarray    # (n*k,) i32
    comp_fea: np.ndarray      # (r, orig_fea) f32 distinct elements
    comp_weight: np.ndarray   # (r,) f32
    target: float             # per-crystal training target (already scaled)
    cry_id: object = None
    composition: str = ""

    @property
    def n_atoms(self) -> int:
        return self.atom_fea.shape[0]


@dataclasses.dataclass
class CrystalBatch:
    """One batch of crystal graphs with static shapes.

    Shapes: N node slots, E edge slots, C graph slots, R composition slots,
    L = N + OFFN_MARGIN + 1 CSR pointer entries.
    """
    nodes: torch.Tensor            # f32 (N, orig_fea)
    node_mask: torch.Tensor        # bool (N,)
    node2graph: torch.Tensor       # i32 (N,) sorted crystal id per node
    edge_src: torch.Tensor         # i32 (E,) source node
    edge_dst: torch.Tensor         # i32 (E,) destination node, sorted
    edge_shell: torch.Tensor       # i32 (E,) distance-shell index
    edge_mask: torch.Tensor        # bool (E,)
    comp_fea: torch.Tensor         # f32 (C, R, orig_fea)
    comp_weight: torch.Tensor      # f32 (C, R)
    comp_mask: torch.Tensor        # bool (C, R)
    target: torch.Tensor           # f32 (C,)
    graph_mask: torch.Tensor       # bool (C,)
    edge_src_perm: torch.Tensor    # i32 (E,) stable argsort of edge_src
    # unclamped CSR row pointers: offn[k] = first position in the sorted id
    # array with id >= k; consumers clamp them to the real-row count
    edge_dst_offn: torch.Tensor    # i32 (L,)
    edge_src_offn: torch.Tensor    # i32 (L,)
    edge_src_sorted: torch.Tensor  # i32 (E,) == edge_src[edge_src_perm]
    node2graph_offn: torch.Tensor  # i32 (C + OFFN_MARGIN + 1,)

    @property
    def num_node_slots(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.target.shape[0]

    @property
    def num_edge_slots(self) -> int:
        return self.edge_src.shape[0]

    def map(self, fn) -> "CrystalBatch":
        """The batch of ``fn`` applied to every tensor."""
        return CrystalBatch(**{f.name: fn(getattr(self, f.name))
                               for f in dataclasses.fields(self)})

    def to(self, device) -> "CrystalBatch":
        """The same batch with every tensor on ``device``."""
        return self.map(lambda t: t.to(device))

    def copy_(self, src: "CrystalBatch") -> "CrystalBatch":
        """Copy ``src``'s tensors, of the same shapes, into this batch's
        (in place, in stream order on a card)."""
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(getattr(src, f.name))
        return self


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# slack past the segment count in the CSR pointer arrays; kept equal to the
# JAX package's value so both collates ship identical arrays
OFFN_MARGIN = 1024


def host_offsets(sorted_ids: np.ndarray, n_hi: int) -> np.ndarray:
    """Unclamped CSR row pointers of a sorted id array:
    ``off[k] = searchsorted(sorted_ids, k)`` for k in [0, n_hi]."""
    off = np.zeros((n_hi + 1,), np.int32)
    off[1:] = np.searchsorted(sorted_ids, np.arange(1, n_hi + 1),
                              side="left").astype(np.int32)
    return off


def pad_to_bucket(n: int, multiple: int = 64) -> int:
    """Round a size up to the padding bucket."""
    return max(multiple, _round_up(n, multiple))


def collate(graphs: Sequence[CrystalGraph],
            *,
            num_graphs: int | None = None,
            num_node_slots: int | None = None,
            num_comp_slots: int | None = None,
            max_nbr: int = 24,
            node_bucket: int = 64,
            orig_fea: int | None = None,
            num_edge_slots: int | None = None,
            max_degree: int | None = None) -> CrystalBatch:
    """Build a static-shape :class:`CrystalBatch` (CPU tensors) from host
    graphs: index offsetting as the reference collate does, then a stable
    sort of the edges by destination and False-suffix padding."""
    C = num_graphs if num_graphs is not None else len(graphs)
    if len(graphs) > C:
        raise ValueError(f"{len(graphs)} graphs > {C} graph slots")
    n_real_nodes = sum(g.n_atoms for g in graphs)
    n_real_edges = sum(len(g.edge_src) for g in graphs)
    N = num_node_slots if num_node_slots is not None else pad_to_bucket(
        n_real_nodes, node_bucket)
    if n_real_nodes > N:
        raise ValueError(f"{n_real_nodes} atoms > {N} node slots")
    # edge slots: explicit count > N * max_degree > tight per-batch bucket,
    # never above N * max_nbr
    if num_edge_slots is not None:
        E = num_edge_slots
    elif max_degree is not None:
        E = N * min(max_degree, max_nbr)
    else:
        E = min(N * max_nbr, pad_to_bucket(n_real_edges, 8 * max_nbr))
    if n_real_edges > E:
        raise ValueError(f"{n_real_edges} edges > {E} edge slots")
    R = num_comp_slots if num_comp_slots is not None else max(
        (g.comp_fea.shape[0] for g in graphs), default=1)
    F = orig_fea if orig_fea is not None else (
        graphs[0].atom_fea.shape[1] if graphs else 200)

    nodes = np.zeros((N, F), np.float32)
    node_mask = np.zeros((N,), bool)
    node2graph = np.full((N,), C - 1, np.int32)
    src_l, dst_l, shell_l = [], [], []
    comp_fea = np.zeros((C, R, F), np.float32)
    comp_weight = np.zeros((C, R), np.float32)
    comp_mask = np.zeros((C, R), bool)
    target = np.zeros((C,), np.float32)
    graph_mask = np.zeros((C,), bool)

    base = 0
    for gi, g in enumerate(graphs):
        n = g.n_atoms
        nodes[base:base + n] = g.atom_fea
        node_mask[base:base + n] = True
        node2graph[base:base + n] = gi
        src_l.append(g.edge_src.astype(np.int64) + base)
        dst_l.append(g.edge_dst.astype(np.int64) + base)
        shell_l.append(g.edge_shell)
        r = g.comp_fea.shape[0]
        if r > R:
            raise ValueError(f"crystal has {r} distinct elements > {R} slots")
        comp_fea[gi, :r] = g.comp_fea
        comp_weight[gi, :r] = g.comp_weight
        comp_mask[gi, :r] = True
        target[gi] = g.target
        graph_mask[gi] = True
        base += n

    if src_l:
        src = np.concatenate(src_l)
        dst = np.concatenate(dst_l)
        shell = np.concatenate(shell_l).astype(np.int64)
        order = np.argsort(dst, kind="stable")
        src, dst, shell = src[order], dst[order], shell[order]
    else:
        src = dst = shell = np.zeros((0,), np.int64)

    e = len(src)
    edge_src = np.full((E,), N - 1, np.int32)
    edge_dst = np.full((E,), N - 1, np.int32)
    edge_shell = np.zeros((E,), np.int32)
    edge_mask = np.zeros((E,), bool)
    edge_src[:e] = src
    edge_dst[:e] = dst
    edge_shell[:e] = shell
    edge_mask[:e] = True

    src_perm = np.argsort(edge_src, kind="stable").astype(np.int32)
    src_sorted = edge_src[src_perm]
    t = torch.from_numpy
    return CrystalBatch(
        nodes=t(nodes),
        node_mask=t(node_mask),
        node2graph=t(node2graph),
        edge_src=t(edge_src),
        edge_dst=t(edge_dst),
        edge_shell=t(edge_shell),
        edge_mask=t(edge_mask),
        comp_fea=t(comp_fea),
        comp_weight=t(comp_weight),
        comp_mask=t(comp_mask),
        target=t(target),
        graph_mask=t(graph_mask),
        edge_src_perm=t(src_perm),
        edge_dst_offn=t(host_offsets(edge_dst, N + OFFN_MARGIN)),
        edge_src_offn=t(host_offsets(src_sorted, N + OFFN_MARGIN)),
        edge_src_sorted=t(np.ascontiguousarray(src_sorted)),
        node2graph_offn=t(host_offsets(node2graph, C + OFFN_MARGIN)),
    )
