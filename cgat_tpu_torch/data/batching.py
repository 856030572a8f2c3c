"""Static-shape batched crystal graphs as torch tensors (single shard).

Counterpart of ``cgat_tpu/data/batching.py``: the same host-side layout,
computed by the native core ``native/collate.cc``, so a batch collated here
equals the JAX package's batch field for field:

* nodes and edges of all crystals are concatenated with index offsetting;
* edges are sorted by destination node, so every node's in-edges form one
  contiguous run (the segment-attention kernel reads them through CSR
  pointers);
* the Roost composition graph is stored dense per crystal, ``(C, R, ...)``.

Padding protocol: padded nodes and edges are a False suffix of their mask;
padded edges point at node slot ``N - 1`` and padded nodes belong to graph
slot ``C - 1``. Masks keep them out of every reduction.

``collate(..., edge_shards=S)`` gives the edge-sharded layout, a
:class:`HaloBatch`: per destination-node slice a local-src edge block and a
halo-src edge block, the boundary exchange tables and per-shard CSR
pointers (the JAX package's ``edge_shards`` collate, field for field).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import native
from ..utils.profiling import annotate, annotated


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
        """The batch of ``fn`` applied to every tensor (a field that is
        None stays None)."""
        return type(self)(**{
            f.name: None if getattr(self, f.name) is None
            else fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def to(self, device) -> "CrystalBatch":
        """The same batch with every tensor on ``device`` (the span
        ``h2d`` from the host to a card)."""
        with _h2d(self.nodes.device, device):
            return self.map(lambda t: t.to(device))

    def copy_(self, src: "CrystalBatch") -> "CrystalBatch":
        """Copy ``src``'s tensors, of the same shapes, into this batch's
        (in place, in stream order on a card; the span ``h2d`` from the
        host to a card)."""
        with _h2d(src.nodes.device, self.nodes.device):
            for f in dataclasses.fields(self):
                if getattr(self, f.name) is not None:
                    getattr(self, f.name).copy_(getattr(src, f.name))
        return self


def _h2d(src, dst):
    """The span ``h2d`` of a copy from device ``src`` to ``dst`` that goes
    from the host to a card; no span for any other copy."""
    if torch.device(src).type == "cpu" and torch.device(dst).type == "cuda":
        return annotate("h2d")
    return contextlib.nullcontext()


@dataclasses.dataclass
class HaloBatch(CrystalBatch):
    """An edge-sharded batch (``collate(..., edge_shards=S)``).

    S = shards, n_loc = N / S nodes a shard, cap / cap_h local / halo edge
    slots a shard, H halo slots a (owner, destination) pair, L = n_loc +
    OFFN_MARGIN + 1. The primary edge arrays hold S LOCAL-src blocks of
    ``cap`` slots (source and destination in shard s's node slice); the
    ``halo_*`` arrays S HALO-src blocks of ``cap_h`` slots (destination in
    the slice, source owned by another shard). Each block is dst-sorted
    with False-suffix padding pointing at the slice's last node.
    ``edge_src_perm``, ``edge_src_sorted``, ``edge_dst_offn`` and
    ``edge_src_offn`` are per shard with block-local values (shard-major:
    block s is rows [s*cap, (s+1)*cap) or [s*L, (s+1)*L)), and
    ``node2graph_offn`` is None (the sharded pool completes its softmax
    with collectives)."""
    halo_src: torch.Tensor = None       # i32 (S*cap_h,) global source ids
    halo_dst: torch.Tensor = None       # i32 (S*cap_h,) global dst ids
    halo_shell: torch.Tensor = None     # i32 (S*cap_h,)
    halo_mask: torch.Tensor = None      # bool (S*cap_h,)
    # per halo edge, its source row in [local nodes | received halo rows]:
    # n_loc + owner*H + its place in the owner's send list (padding: n_loc-1)
    halo_src_ext: torch.Tensor = None   # i32 (S*cap_h,)
    # owner-major send table: row s*S + d holds the local indices of the
    # boundary nodes shard s sends to shard d (padded with n_loc - 1)
    halo_send_idx: torch.Tensor = None  # i32 (S*S, H)
    halo_dst_offn: torch.Tensor = None  # i32 (S*L,) over block-local dsts


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


def edge_shard_counts(graphs: Sequence[CrystalGraph], num_node_slots: int,
                      edge_shards: int) -> tuple[np.ndarray, np.ndarray]:
    """(local, halo) real-edge counts per destination-node slice of a
    prospective collate of ``graphs`` into ``num_node_slots`` slots (what a
    group's shared edge capacities are picked from). Local: source and
    destination in the same slice."""
    n_loc = num_node_slots // edge_shards
    loc = np.zeros((edge_shards,), np.int64)
    hal = np.zeros((edge_shards,), np.int64)
    base = 0
    for g in graphs:
        src = g.edge_src.astype(np.int64) + base
        dst = g.edge_dst.astype(np.int64) + base
        d = dst // n_loc
        lm = (src // n_loc) == d
        loc += np.bincount(d[lm], minlength=edge_shards)
        hal += np.bincount(d[~lm], minlength=edge_shards)
        base += g.n_atoms
    return loc, hal


def halo_pair_max(graphs: Sequence[CrystalGraph], num_node_slots: int,
                  edge_shards: int) -> int:
    """The largest count of distinct boundary nodes one shard needs from
    another in a prospective collate of ``graphs`` (a group's shared halo
    capacity is picked from it)."""
    S = edge_shards
    n_loc = num_node_slots // S
    src_l, dst_l, base = [], [], 0
    for g in graphs:
        src_l.append(g.edge_src.astype(np.int64) + base)
        dst_l.append(g.edge_dst.astype(np.int64) + base)
        base += g.n_atoms
    if not src_l:
        return 0
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    dest_shard = dst // n_loc
    owner = src // n_loc
    worst = 0
    for s in range(S):
        m = dest_shard == s
        for j in range(S):
            if j != s:
                worst = max(worst, len(np.unique(src[m & (owner == j)])))
    return worst


def _halo_layout(halo_src, halo_mask, n_loc, S, cap, halo_slots):
    """The boundary exchange of an edge-sharded batch from its S halo
    blocks' global source ids (``cap`` slots each): ``(halo_src_ext,
    halo_send_idx, H)`` as :class:`HaloBatch` describes them."""
    need = [[None] * S for _ in range(S)]
    for s in range(S):
        blk = slice(s * cap, (s + 1) * cap)
        gsrc = halo_src[blk].astype(np.int64)
        owner = gsrc // n_loc
        msk = halo_mask[blk]
        for j in range(S):
            if j != s:
                need[s][j] = np.unique(gsrc[msk & (owner == j)])
    worst = max((len(need[s][j]) for s in range(S) for j in range(S)
                 if j != s), default=0)
    H = halo_slots if halo_slots is not None else max(8, _round_up(worst, 8))
    if worst > H:
        raise ValueError(f"halo overflow: {worst} boundary nodes > {H} slots")

    src_ext = np.full((S * cap,), n_loc - 1, np.int32)
    for s in range(S):
        blk = slice(s * cap, (s + 1) * cap)
        gsrc = halo_src[blk].astype(np.int64)
        owner = gsrc // n_loc
        msk = halo_mask[blk]
        ext = np.full((cap,), n_loc - 1, np.int64)
        for j in range(S):
            if j == s:
                continue
            m = msk & (owner == j)
            if m.any():
                ext[m] = n_loc + j * H + np.searchsorted(need[s][j], gsrc[m])
        src_ext[blk] = ext

    halo_send = np.full((S * S, H), n_loc - 1, np.int32)
    for d in range(S):
        for j in range(S):
            if j != d:
                ids = need[d][j]
                halo_send[j * S + d, :len(ids)] = ids - j * n_loc
    return src_ext, halo_send, H


def _sharded_edges(src, dst, shell, N, S, max_nbr, cap, cap_h, halo_slots):
    """The edge fields of an S-shard collate from the dst-sorted real edges
    (see :class:`HaloBatch`): each shard's edges split stably into a local
    and a halo block (a selection of a sorted array stays sorted)."""
    n_loc = N // S
    e = len(src)
    bounds = np.searchsorted(dst, np.arange(1, S + 1) * n_loc, side="left")
    starts = np.concatenate([[0], bounds[:-1]])
    owner = src // n_loc
    parts = [owner[starts[s]:bounds[s]] == s for s in range(S)]
    loc_counts = np.array([int(lm.sum()) for lm in parts], np.int64)
    hal_counts = np.array([len(lm) - int(lm.sum()) for lm in parts],
                          np.int64)
    if cap is None:
        # a whole number of max_nbr rows a shard keeps the capacities a
        # small set of shapes across batches
        cap = int(pad_to_bucket(max(int(loc_counts.max()), 1) if e else 1,
                                8 * max_nbr))
    if cap_h is None:
        cap_h = int(pad_to_bucket(max(int(hal_counts.max()), 1), 16))
    if (loc_counts > cap).any():
        raise ValueError(f"edge shard overflow: {loc_counts.tolist()} > "
                         f"{cap} slots")
    if (hal_counts > cap_h).any():
        raise ValueError(f"halo edge overflow: {hal_counts.tolist()} > "
                         f"{cap_h} slots")
    out = {}
    for prefix, width, local in (("edge", cap, True), ("halo", cap_h, False)):
        a_src = np.empty((S * width,), np.int32)
        a_dst = np.empty((S * width,), np.int32)
        a_shell = np.zeros((S * width,), np.int32)
        a_mask = np.zeros((S * width,), bool)
        for s in range(S):
            last = (s + 1) * n_loc - 1      # padding target inside slice s
            sl = slice(starts[s], bounds[s])
            m = parts[s] if local else ~parts[s]
            c0, c = s * width, int(m.sum())
            a_src[c0:c0 + width] = last
            a_dst[c0:c0 + width] = last
            a_src[c0:c0 + c] = src[sl][m]
            a_dst[c0:c0 + c] = dst[sl][m]
            a_shell[c0:c0 + c] = shell[sl][m]
            a_mask[c0:c0 + c] = True
        out.update({f"{prefix}_src": a_src, f"{prefix}_dst": a_dst,
                    f"{prefix}_shell": a_shell, f"{prefix}_mask": a_mask})
    out["halo_src_ext"], out["halo_send_idx"], _ = _halo_layout(
        out["halo_src"], out["halo_mask"], n_loc, S, cap_h, halo_slots)
    # per shard: the stable argsort of the local block's sources, the
    # sorted sources and the CSR pointers of its destinations, sources and
    # halo destinations, all over block-local ids
    L = n_loc + OFFN_MARGIN + 1
    perm = np.empty((S * cap,), np.int32)
    src_sorted = np.empty((S * cap,), np.int32)
    dst_offn = np.empty((S * L,), np.int32)
    src_offn = np.empty((S * L,), np.int32)
    halo_offn = np.empty((S * L,), np.int32)
    for s in range(S):
        blk = slice(s * cap, (s + 1) * cap)
        row = slice(s * L, (s + 1) * L)
        perm[blk] = np.argsort(out["edge_src"][blk], kind="stable")
        dst_offn[row] = host_offsets(
            out["edge_dst"][blk].astype(np.int64) - s * n_loc,
            n_loc + OFFN_MARGIN)
        ss = (out["edge_src"][blk][perm[blk]].astype(np.int64)
              - s * n_loc).astype(np.int32)
        src_sorted[blk] = ss
        src_offn[row] = host_offsets(ss, n_loc + OFFN_MARGIN)
        hblk = slice(s * cap_h, (s + 1) * cap_h)
        halo_offn[row] = host_offsets(
            out["halo_dst"][hblk].astype(np.int64) - s * n_loc,
            n_loc + OFFN_MARGIN)
    out.update(edge_src_perm=perm, edge_src_sorted=src_sorted,
               edge_dst_offn=dst_offn, edge_src_offn=src_offn,
               halo_dst_offn=halo_offn)
    return out


@annotated("collate")
def collate(graphs: Sequence[CrystalGraph],
            *,
            num_graphs: int | None = None,
            num_node_slots: int | None = None,
            num_comp_slots: int | None = None,
            max_nbr: int = 24,
            node_bucket: int = 64,
            orig_fea: int | None = None,
            num_edge_slots: int | None = None,
            max_degree: int | None = None,
            edge_shards: int = 1,
            edge_slots_per_shard: int | None = None,
            halo_edge_slots: int | None = None,
            halo_slots: int | None = None) -> CrystalBatch:
    """Build a static-shape :class:`CrystalBatch` (CPU tensors) from host
    graphs: index offsetting as the reference collate does, then a stable
    sort of the edges by destination and False-suffix padding. The native
    core (``native/collate.cc``) reads each crystal's arrays where they lie,
    sorts its edges by counting and writes every field once; a crystal
    whose edges leave its own atoms raises ``ValueError``.

    ``edge_shards`` S > 1 gives a :class:`HaloBatch` instead: N a multiple
    of S, and per node slice a local block of ``edge_slots_per_shard`` and
    a halo block of ``halo_edge_slots`` edge slots with ``halo_slots``
    boundary rows a shard pair (each picked from the batch when None)."""
    graphs = graphs if isinstance(graphs, list) else list(graphs)
    G = len(graphs)
    C = num_graphs if num_graphs is not None else G
    if G > C:
        raise ValueError(f"{G} graphs > {C} graph slots")
    n_atoms, n_edges, n_comp = native.graph_counts(graphs)
    n_real_nodes = int(n_atoms.sum())
    n_real_edges = int(n_edges.sum())
    N = num_node_slots if num_node_slots is not None else pad_to_bucket(
        n_real_nodes, node_bucket * edge_shards)
    if n_real_nodes > N:
        raise ValueError(f"{n_real_nodes} atoms > {N} node slots")
    if N % edge_shards:
        raise ValueError(f"{N} node slots do not split into {edge_shards} "
                         f"edge shards")
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
    r_max = int(n_comp.max()) if G else 1
    R = num_comp_slots if num_comp_slots is not None else r_max
    F = orig_fea if orig_fea is not None else (
        graphs[0].atom_fea.shape[1] if graphs else 200)
    if r_max > R:
        raise ValueError(f"crystal has {r_max} distinct elements > {R} slots")

    # edge-sharded batches take the dst-sorted real edges, unpadded
    fields = native.collate_native(
        graphs, N=N, E=n_real_edges if edge_shards > 1 else E, C=C, R=R,
        F=F, margin=OFFN_MARGIN)

    t = torch.from_numpy
    batch = {k: t(v) for k, v in fields.items()}
    if edge_shards == 1:
        return CrystalBatch(**batch)
    out = _sharded_edges(fields["edge_src"], fields["edge_dst"],
                         fields["edge_shell"], N, edge_shards, max_nbr,
                         edge_slots_per_shard, halo_edge_slots, halo_slots)
    batch.update(node2graph_offn=None,
                 **{k: t(np.ascontiguousarray(v)) for k, v in out.items()})
    return HaloBatch(**batch)
