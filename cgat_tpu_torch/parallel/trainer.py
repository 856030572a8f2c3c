"""Groups of minibatches padded to one shape, counterpart of
``collate_group`` and ``ParallelLoader`` in ``cgat_tpu/parallel/trainer.py``.

The trainer's multi-step dispatch (``steps_per_dispatch`` K) takes K
consecutive minibatches at a time, collated to the same node-slot count
(the group's largest bucket) and so to the same shapes, and stacked on a
new leading axis. One process and one edge shard only: more shards or
processes are slice 4 (scale-out) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..data.batching import CrystalBatch, collate, pad_to_bucket
from ..data.dataset import GraphLoader


def _single_process(edge_shards: int, process_count: int) -> None:
    if edge_shards != 1 or process_count != 1:
        raise NotImplementedError(
            f"edge_shards={edge_shards}, process_count={process_count}: "
            f"grouping across shards or processes is not ported yet; it "
            f"comes with slice 4 (scale-out)")


def stack_batches(batches) -> CrystalBatch:
    """Stack same-shape batches on a new leading axis."""
    return CrystalBatch(**{
        f.name: torch.stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(CrystalBatch)})


def collate_group(chunks, *, batch_size, max_nbr, node_bucket,
                  num_comp_slots, max_degree=None, edge_shards=1,
                  process_index=0, process_count=1) -> CrystalBatch:
    """Collate D chunks of graphs into one stacked batch whose members all
    have the group's largest node-slot count (so one edge-slot count,
    ``max_degree`` a node) and the first non-empty chunk's feature width."""
    _single_process(edge_shards, process_count)
    n_max = max(pad_to_bucket(sum(x.n_atoms for x in c), node_bucket)
                for c in chunks)
    fea = next((c[0].atom_fea.shape[1] for c in chunks if c), None)
    return stack_batches([
        collate(c, max_nbr=max_nbr, num_graphs=batch_size,
                num_comp_slots=num_comp_slots, num_node_slots=n_max,
                orig_fea=fea, max_degree=max_degree)
        for c in chunks])


class ParallelLoader:
    """Groups D consecutive minibatches of a :class:`GraphLoader` over
    ``graphs`` into one stacked batch (:func:`collate_group`). With
    ``drop_last`` an epoch of n batches yields n // D groups; without, the
    tail group is padded with empty, fully masked batches.
    ``last_counts`` holds the real edges and graphs of the whole group."""

    def __init__(self, graphs, batch_size: int, n_replicas: int, *,
                 shuffle=False, seed=0, max_nbr=24, node_bucket=64,
                 num_comp_slots=None, drop_last=True, edge_shards=1,
                 process_index=0, process_count=1):
        _single_process(edge_shards, process_count)
        self.inner = GraphLoader(graphs, batch_size, shuffle=shuffle,
                                 seed=seed, max_nbr=max_nbr,
                                 node_bucket=node_bucket,
                                 num_comp_slots=num_comp_slots,
                                 drop_last=drop_last)
        self.n_replicas = n_replicas
        self.max_nbr = max_nbr
        self.node_bucket = node_bucket
        self.drop_last = drop_last

    def __len__(self):
        if self.drop_last:
            return len(self.inner) // self.n_replicas
        return -(-len(self.inner) // self.n_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    def __iter__(self):
        D = self.n_replicas
        inner = self.inner
        inner.drop_last = self.drop_last
        order = inner._order()
        bs = inner.batch_size
        for g in range(len(self)):
            chunks = [[inner.graphs[i]
                       for i in order[(g * D + d) * bs:(g * D + d + 1) * bs]]
                      for d in range(D)]
            self.last_counts = {
                "edges": sum(len(x.edge_src) for c in chunks for x in c),
                "graphs": sum(len(c) for c in chunks)}
            yield collate_group(chunks, batch_size=bs, max_nbr=self.max_nbr,
                                node_bucket=self.node_bucket,
                                num_comp_slots=inner.num_comp_slots,
                                max_degree=inner.max_degree)
