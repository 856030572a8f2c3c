"""Dataset splits and the minibatch loader.

Counterpart of ``split_dataset`` and ``GraphLoader`` in
``cgat_tpu/data/dataset.py``. Loading prepared datasets from disk is not
ported yet.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from .batching import CrystalGraph, collate


def train_test_split(items: list, *, seed: int, test_size: float):
    """``sklearn.model_selection.train_test_split(items, random_state=seed,
    test_size=test_size)`` for a float ``test_size``, without sklearn: the
    test part is the first ``ceil(test_size * n)`` entries of
    ``RandomState(seed).permutation(n)``, the train part the rest."""
    n = len(items)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the "
                         f"(0, 1) range")
    n_test = math.ceil(test_size * n)
    if n - n_test <= 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the "
                         f"train set would be empty")
    perm = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


def split_dataset(n: int, *, seed: int = 0, val_size: float = 0.1,
                  test_size: float = 0.1, train_percentage: float = 0.0):
    """The reference's splits (lightning_module.py:78-117), index for index
    as the JAX package's sklearn-based ``split_dataset`` gives them.
    Returns (train_idx, val_idx, test_idx)."""
    train_idx, test_idx = train_test_split(list(range(n)), seed=seed,
                                           test_size=test_size)
    tr2, val2 = train_test_split(list(range(len(train_idx))), seed=seed,
                                 test_size=val_size / (1 - test_size))
    train_set = [train_idx[i] for i in tr2]
    val_set = [train_idx[i] for i in val2]
    if train_percentage != 0.0:
        keep, _ = train_test_split(
            list(range(len(train_set))), seed=seed,
            test_size=1.0 - train_percentage / (1 - val_size - test_size))
        train_set = [train_set[i] for i in keep]
    return train_set, val_set, test_idx


class GraphLoader:
    """Minibatch iterator over host graphs with static-shape collation.

    ``drop_last`` batching like the reference dataloaders
    (lightning_module.py:357-411); node slots padded to a bucket multiple
    and the edge axis a fixed multiple (the dataset's max degree) of it.
    Yields CPU :class:`~cgat_tpu_torch.data.batching.CrystalBatch` es.
    """

    def __init__(self, graphs: Sequence[CrystalGraph], batch_size: int,
                 *, shuffle: bool = False, seed: int = 0, max_nbr: int = 24,
                 node_bucket: int = 64, num_comp_slots: int | None = None,
                 num_node_slots: int | None = None, drop_last: bool = True):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self.max_nbr = max_nbr
        self.node_bucket = node_bucket
        self.num_comp_slots = num_comp_slots or max(
            (g.comp_fea.shape[0] for g in self.graphs), default=1)
        self.num_node_slots = num_node_slots
        self.drop_last = drop_last
        self.max_degree = min(max_nbr, max(
            (-(-len(g.edge_src) // max(g.n_atoms, 1)) for g in self.graphs),
            default=max_nbr))

    def __len__(self):
        if self.drop_last:
            return len(self.graphs) // self.batch_size
        return -(-len(self.graphs) // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle stream to an epoch."""
        self._epoch = int(epoch)

    def _order(self) -> np.ndarray:
        """Deterministic per-epoch permutation; advances the epoch counter."""
        order = np.arange(len(self.graphs))
        if self.shuffle:
            np.random.default_rng([self.seed, self._epoch]).shuffle(order)
        self._epoch += 1
        return order

    def __iter__(self):
        order = self._order()
        for b in range(len(self)):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield collate([self.graphs[i] for i in idx],
                          max_nbr=self.max_nbr,
                          node_bucket=self.node_bucket,
                          num_graphs=self.batch_size,
                          num_comp_slots=self.num_comp_slots,
                          num_node_slots=self.num_node_slots,
                          max_degree=self.max_degree)
