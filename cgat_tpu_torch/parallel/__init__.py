"""Data-parallel and edge-sharded training over ``torch.distributed``
(counterpart of ``cgat_tpu/parallel``): the mesh as process groups, the
world's set-up, the collectives, which fields a rank takes, the grouped
loaders and the parallel train, eval and embedding steps."""
from .collectives import all_gather, all_reduce, all_to_all, reduce_gradients
from .distributed import init_distributed, local_dp_rows
from .mesh import Axis, Mesh, make_mesh
from .sharding import local_batch
from .trainer import (ParallelLoader, StreamingParallelLoader, collate_group,
                      global_loss_and_metrics, make_parallel_embed_step,
                      make_parallel_eval_step, make_parallel_train_step,
                      stack_batches)

__all__ = ["Axis", "Mesh", "ParallelLoader", "StreamingParallelLoader",
           "all_gather", "all_reduce", "all_to_all", "collate_group",
           "global_loss_and_metrics", "init_distributed", "local_batch",
           "local_dp_rows", "make_mesh", "make_parallel_embed_step",
           "make_parallel_eval_step", "make_parallel_train_step",
           "reduce_gradients", "stack_batches"]
