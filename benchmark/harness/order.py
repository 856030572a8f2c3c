"""Which crystals the program's loaders put in which batch, worked out by
the benchmark: frozen copies of the port's dataset split
(``data/dataset.py`` ``split_dataset``, the reference's sklearn split) and
of ``GraphLoader``'s per-epoch shuffle. The warm-up plans the batch shapes
of the window from them, and the reference takes its batches from them;
a program whose loader put other crystals together would fail the
comparison."""
from __future__ import annotations

import math

import numpy as np


def _train_test_split(n: int, seed: int, test_size: float):
    n_test = math.ceil(test_size * n)
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:], perm[:n_test]


def training_split(n: int, seed: int, val_size: float = 0.1,
                   test_size: float = 0.1) -> np.ndarray:
    """The training indices of ``n`` crystals (the trainer's split)."""
    train_idx, _ = _train_test_split(n, seed, test_size)
    tr2, _ = _train_test_split(len(train_idx), seed,
                               val_size / (1 - test_size))
    return np.asarray(train_idx)[tr2]


def epoch_batches(n: int, batch: int, seed: int, epoch: int) -> np.ndarray:
    """The batches (rows of positions into the loader's list) of one epoch
    of a shuffled, ``drop_last`` loader of ``n`` items."""
    order = np.arange(n)
    np.random.default_rng([seed, epoch]).shuffle(order)
    steps = n // batch
    return order[:steps * batch].reshape(steps, batch)
