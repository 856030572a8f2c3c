"""The ('dp', 'edge') mesh as process groups, counterpart of
``cgat_tpu/parallel/mesh.py``.

One process per rank; rank ``r = dp_index * edge + edge_index``, so the
edge axis is innermost and an edge group (the ranks that share one
replica's batch) is a run of adjacent ranks, which never straddles hosts
when each host holds a multiple of ``edge`` ranks
(:func:`~.distributed.local_dp_rows` checks it).
"""
from __future__ import annotations

import dataclasses

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as seen by this rank: its process group, this rank's
    index along it (its rank in ``group``) and its size."""
    group: object
    index: int
    size: int


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ``dp`` x ``edge`` world: ``world`` is every
    rank, ``dp`` the ranks of this edge index (one a replica), ``edge`` the
    ranks of this replica."""
    world: object
    dp: Axis
    edge: Axis

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp.size, "edge": self.edge.size}

    @property
    def backend(self) -> str:
        return dist.get_backend(self.world)


def make_mesh(dp: int, edge: int = 1) -> Mesh:
    """The mesh of the initialised world, which must hold ``dp * edge``
    ranks. Every rank creates every group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    world = dist.get_world_size()
    if dp < 1 or edge < 1 or dp * edge != world:
        raise ValueError(f"a mesh of dp={dp} x edge={edge} needs "
                         f"{dp * edge} ranks; the world has {world}")
    rank = dist.get_rank()
    dp_index, edge_index = divmod(rank, edge)
    edge_groups = [dist.new_group([d * edge + e for e in range(edge)])
                   for d in range(dp)]
    dp_groups = [dist.new_group([d * edge + e for d in range(dp)])
                 for e in range(edge)]
    return Mesh(world=dist.group.WORLD,
                dp=Axis(dp_groups[edge_index], dp_index, dp),
                edge=Axis(edge_groups[dp_index], edge_index, edge))
