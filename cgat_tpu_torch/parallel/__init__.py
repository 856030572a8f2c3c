"""Grouped batches for the multi-step dispatch (counterpart of
``cgat_tpu/parallel``). Only the single-process, single-shard grouping is
ported; the data-parallel and edge-sharded trainers come with slice 4."""
from .trainer import ParallelLoader, collate_group, stack_batches

__all__ = ["ParallelLoader", "collate_group", "stack_batches"]
