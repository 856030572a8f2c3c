"""Which fields of a stacked group each rank takes, counterpart of
``shardmap_batch_pspecs`` in ``cgat_tpu/parallel/sharding.py``.

A group (``collate_group``) stacks replica batches on a leading ``dp``
axis. Under edge sharding the node arrays, both edge blocks, the per-shard
permutation, sorted sources and CSR pointers and the send table are laid
out shard-major, so shard e's part is the e-th of S equal slices of each;
the composition and target arrays are the replica's whole, which every
rank of its edge group holds.
"""
from __future__ import annotations

from ..data.batching import CrystalBatch

# fields cut along the edge axis of an edge-sharded batch (the JAX
# package's P("dp", "edge") fields); the rest are P("dp")
EDGE_FIELDS = frozenset((
    "nodes", "node_mask", "node2graph", "edge_src", "edge_dst", "edge_shell",
    "edge_mask", "edge_src_perm", "edge_dst_offn", "edge_src_offn",
    "edge_src_sorted", "halo_src", "halo_dst", "halo_shell", "halo_mask",
    "halo_src_ext", "halo_send_idx", "halo_dst_offn"))


def local_batch(group: CrystalBatch, row: int, edge_index: int = 0,
                edge_shards: int = 1) -> CrystalBatch:
    """Row ``row`` of a stacked group, and of an edge-sharded one the part
    of edge shard ``edge_index`` of ``edge_shards``: what one rank
    computes on."""
    batch = group.map(lambda t: t[row])
    if edge_shards == 1:
        return batch
    fields = {}
    for name in batch.__dataclass_fields__:
        t = getattr(batch, name)
        if t is not None and name in EDGE_FIELDS:
            t = t.reshape(edge_shards, -1, *t.shape[1:])[edge_index]
        fields[name] = t
    return type(batch)(**fields)
