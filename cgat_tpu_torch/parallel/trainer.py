"""Data-parallel and edge-sharded steps over a ``torch.distributed``
world, and the grouped loaders; counterpart of
``cgat_tpu/parallel/trainer.py``.

Each rank runs the single-device model on its own part of the batch: the
``dp`` axis carries whole replicas (the reference's DDP, train.py:56), the
``edge`` axis cuts each replica's nodes and edges into the slices of an
edge-sharded collate, which exchange only their boundary rows between
layers and complete the crystal pool with small collectives
(``models/cgat.py``). The loss is the global masked mean: each rank's
masked sums, the count and the sums reduced over the world, each divided
by the edge axis size since the replica's edge ranks all hold its
crystals. Each rank differentiates its own share (the model's collectives
carry the cotangents across the edge group) and the gradients are summed
over the world, which gives the gradient of the global loss: the JAX
package's ``psum`` of ``value_and_grad``, and equal to one process on the
concatenated batch. Not DDP's mean of per-rank means, which differs
whenever ranks hold different numbers of real crystals.

``collate_group``, ``ParallelLoader`` and ``StreamingParallelLoader`` (the
same over a shard stream) group D consecutive minibatches, padded to
group-wide shapes that every rank computes alike; a rank collates only
its own replicas (``process_index`` of ``process_count``).
The K-step dispatch of one process (``steps_per_dispatch``) uses them with
one replica a step.
"""
from __future__ import annotations

import dataclasses

import torch

from ..data.batching import (CrystalBatch, collate, edge_shard_counts,
                             halo_pair_max, pad_to_bucket)
from ..data.dataset import GraphLoader
from .collectives import all_gather, all_reduce_, reduce_gradients
from .mesh import Mesh


def stack_batches(batches) -> CrystalBatch:
    """Stack same-shape batches on a new leading axis (a field that is
    None stays None)."""
    first = batches[0]
    return type(first)(**{
        f.name: None if getattr(first, f.name) is None
        else torch.stack([getattr(b, f.name) for b in batches])
        for f in dataclasses.fields(first)})


def collate_group(chunks, *, batch_size, max_nbr, node_bucket,
                  num_comp_slots, max_degree=None, edge_shards=1,
                  process_index=0, process_count=1) -> CrystalBatch:
    """Collate D chunks of graphs into one stacked batch whose members all
    have the group's largest node-slot count (a multiple of
    ``edge_shards``) and the first non-empty chunk's feature width: one
    edge-slot count (``max_degree`` a node), or with ``edge_shards`` S > 1
    one local and one halo edge capacity a shard and one halo slot count.
    Only the chunks of process ``process_index`` of ``process_count``
    (D / process_count consecutive ones) are collated; the shapes are the
    same in every process."""
    D = len(chunks)
    S = edge_shards
    if D % process_count:
        raise ValueError(f"{D} replicas do not split over "
                         f"{process_count} processes")
    n_max = max(pad_to_bucket(sum(x.n_atoms for x in c), node_bucket)
                for c in chunks)
    if S > 1 and n_max % S:
        n_max += S - n_max % S
    fea = next((c[0].atom_fea.shape[1] for c in chunks if c), None)
    cap = cap_h = halo = None
    if S > 1:
        splits = [edge_shard_counts(c, n_max, S) for c in chunks]
        cap = pad_to_bucket(max(max(int(l.max()) for l, _ in splits), 1),
                            8 * max_nbr)
        cap_h = pad_to_bucket(max(max(int(h.max()) for _, h in splits), 1),
                              16)
        halo = max(8, pad_to_bucket(
            max(halo_pair_max(c, n_max, S) for c in chunks), 8))
    d_local = D // process_count
    local = chunks[process_index * d_local:(process_index + 1) * d_local]
    return stack_batches([
        collate(c, max_nbr=max_nbr, num_graphs=batch_size,
                num_comp_slots=num_comp_slots, num_node_slots=n_max,
                orig_fea=fea, max_degree=max_degree if S == 1 else None,
                edge_shards=S, edge_slots_per_shard=cap,
                halo_edge_slots=cap_h, halo_slots=halo)
        for c in local])


class ParallelLoader:
    """Groups D consecutive minibatches of a :class:`GraphLoader` over
    ``graphs`` into one stacked batch (:func:`collate_group`). With
    ``drop_last`` an epoch of n batches yields n // D groups; without, the
    tail group is padded with empty, fully masked batches, so every graph
    is seen once. ``last_counts`` holds the real edges and graphs of the
    whole group (every process's replicas)."""

    def __init__(self, graphs, batch_size: int, n_replicas: int, *,
                 shuffle=False, seed=0, max_nbr=24, node_bucket=64,
                 num_comp_slots=None, drop_last=True, edge_shards=1,
                 process_index=0, process_count=1):
        if n_replicas % process_count:
            raise ValueError(f"n_replicas={n_replicas} not divisible by "
                             f"process_count={process_count}")
        self.inner = GraphLoader(graphs, batch_size, shuffle=shuffle,
                                 seed=seed, max_nbr=max_nbr,
                                 node_bucket=node_bucket,
                                 num_comp_slots=num_comp_slots,
                                 drop_last=drop_last)
        self.n_replicas = n_replicas
        self.max_nbr = max_nbr
        self.node_bucket = node_bucket
        self.drop_last = drop_last
        self.edge_shards = edge_shards
        self.process_index = process_index
        self.process_count = process_count

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
                                max_degree=inner.max_degree,
                                edge_shards=self.edge_shards,
                                process_index=self.process_index,
                                process_count=self.process_count)


class StreamingParallelLoader:
    """The grouped loader over an out-of-core shard stream
    (``data.streaming.StreamingGraphLoader``: one shard in host memory, the
    next parsed on a thread, the same order in a resumed run): D
    consecutive minibatches of the stream become one stacked group with
    group-wide shapes (:func:`collate_group`).

    Every process streams every shard in the same order, so the group's
    shapes agree, and collates only its own ``D / process_count`` replica
    rows; the stream itself must not be process-sliced. The tail partial
    group is dropped (training loaders drop the last batch)."""

    def __init__(self, stream, n_replicas: int, *, edge_shards: int = 1,
                 process_index: int = 0, process_count: int = 1):
        if n_replicas % process_count:
            raise ValueError(f"n_replicas={n_replicas} not divisible by "
                             f"process_count={process_count}")
        self.stream = stream
        self.n_replicas = n_replicas
        self.edge_shards = edge_shards
        self.process_index = process_index
        self.process_count = process_count

    def __len__(self):
        return len(self.stream) // self.n_replicas

    def set_epoch(self, epoch: int) -> None:
        self.stream.set_epoch(epoch)

    def __iter__(self):
        st = self.stream
        bs = st.batch_size
        D = self.n_replicas
        carry, group = [], []
        for graphs in st._shards():
            carry.extend(graphs)
            while len(carry) >= bs:
                group.append(carry[:bs])
                carry = carry[bs:]
                if len(group) == D:
                    self.last_counts = {
                        "edges": sum(len(x.edge_src)
                                     for c in group for x in c),
                        "graphs": sum(len(c) for c in group)}
                    yield collate_group(
                        group, batch_size=bs, max_nbr=st.max_nbr,
                        node_bucket=st.node_bucket,
                        num_comp_slots=st.num_comp_slots,
                        max_degree=st.max_degree,
                        edge_shards=self.edge_shards,
                        process_index=self.process_index,
                        process_count=self.process_count)
                    group = []


def _cell_sums(out, batch, mean, std, criterion):
    """One rank's masked sums: (loss_sum, sae, sse, n)."""
    output, log_std = out[:, 0], out[:, 1]
    mask = batch.graph_mask
    n = mask.float().sum()
    loss_sum = criterion(output, log_std, (batch.target - mean) / std,
                         mask) * n
    err = torch.where(mask, output * std + mean - batch.target,
                      torch.zeros((), device=out.device))
    return loss_sum, err.abs().sum(), (err * err).sum(), n


def global_loss_and_metrics(out, batch, mean, std, criterion, mesh: Mesh):
    """This rank's share of the global masked-mean loss (the shares of all
    ranks sum to it) and the global metrics, the same on every rank."""
    loss_sum, sae, sse, n = _cell_sums(out, batch, mean, std, criterion)
    S = float(mesh.edge.size)
    sums = all_reduce_(torch.stack([loss_sum.detach(), sae.detach(),
                                    sse.detach(), n]) / S, mesh.world)
    count = sums[3]
    return loss_sum / S / count, {"loss": sums[0] / count,
                                  "mae": sums[1] / count,
                                  "rmse": torch.sqrt(sums[2] / count)}


def _edge_axis(mesh: Mesh):
    return mesh.edge if mesh.edge.size > 1 else None


def make_parallel_train_step(model, opt, criterion, mean, std, mesh: Mesh,
                             *, seed: int = 0):
    """Returns ``step(batch, step_count) -> metrics``: on this rank's
    local batch (``step_count`` the trainer's device step count) the
    forward, the global loss, the backward, the gradients
    summed over the world (``opt.reduce``, which this sets: over the
    optimizer's flat gradient buffers where it has them), the optimizer's
    update on the device (``opt.apply``) and the damping projection. The
    host's part (``opt.advance``) and advancing the count are the caller's.
    Dropout masks are drawn from ``(seed, step_count, dp_index,
    edge_index)``, so each rank's sites keep their place in the mesh."""
    from ..models.cgat import DropoutKey           # (models imports parallel)
    from ..training.optim import project_params   # (training imports this)
    edge = _edge_axis(mesh)
    opt.reduce = lambda tensors: reduce_gradients(tensors, mesh.world)

    def step(batch, step_count):
        out = model(batch, edge_group=edge,
                    dropout_key=DropoutKey((seed, mesh.dp.index,
                                            mesh.edge.index), step_count))
        loss, metrics = global_loss_and_metrics(out, batch, mean, std,
                                                criterion, mesh)
        opt.zero_grad()
        loss.backward()
        opt.apply()
        project_params(model)
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_parallel_eval_step(model, criterion, mean, std, mesh: Mesh):
    """Returns ``eval(batch) -> sums``: the global sums of the loss, the
    absolute error and the count ``n`` over every rank's local batch, and
    the RMSE as ``sqrt(sse / n) * n`` (the JAX package's per-call
    aggregation), for the caller to add up and divide by ``n``."""
    edge = _edge_axis(mesh)

    @torch.no_grad()
    def step(batch):
        out = model(batch, edge_group=edge)
        sums = torch.stack(_cell_sums(out, batch, mean, std, criterion))
        loss, sae, sse, n = all_reduce_(sums / float(mesh.edge.size),
                                        mesh.world)
        return {"loss": loss, "mae": sae,
                "rmse": torch.sqrt(sse / torch.clamp(n, min=1.0)) * n,
                "n": n}

    return step


def make_parallel_embed_step(model, mesh: Mesh):
    """Returns ``embed(batch) -> (dp, C, embedding_dim + 1)`` f32: every
    replica's graph embeddings with its graph mask as the last column,
    gathered over the dp axis (each replica's edge ranks hold the same
    embeddings), the same on every rank."""
    edge = _edge_axis(mesh)

    @torch.no_grad()
    def step(batch):
        e = model(batch, edge_group=edge, return_graph_embedding=True)
        mine = torch.cat([e.float(), batch.graph_mask[:, None].float()], 1)
        return all_gather(mine, mesh.dp.group)

    return step
