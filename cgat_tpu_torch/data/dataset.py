"""Prepared-dataset loading, dataset splits and the minibatch loader.

Counterpart of ``cgat_tpu/data/dataset.py`` (reference: CGAT/data.py:16-144).

Reads the reference's featurised ``.pickle.gz`` dictionaries — keys
``input``, ``batch_ids``, ``batch_comp``, ``target``, ``comps`` — in both
storage formats (data.py:47-50), resolves element compositions exactly like
the reference (insertion-ordered distinct elements, regex fallback on the
composition string, data.py:62-96) and produces host-side
:class:`~cgat_tpu_torch.data.batching.CrystalGraph` records.

Quirk preserved: the training target is ``per_atom_target * n_atoms`` except
for ``target == 'volume'`` which stays per-atom (data.py:139-144).
"""
from __future__ import annotations

import glob
import gzip
import math
import os
import pickle
import re
from typing import Sequence

import numpy as np

from .batching import CrystalGraph, collate
from .embedding import Featuriser, load_featuriser

_COMP_RE = re.compile(r"([a-z]+)(\d+)", re.IGNORECASE)


def _parse_elements(entry, batch_comp) -> list[str]:
    """Element list for one crystal (data.py:62-79)."""
    elements = entry
    if isinstance(elements, str):
        try:
            matches = _COMP_RE.findall(batch_comp)
        except TypeError:
            matches = _COMP_RE.findall(batch_comp[0])
        elements = [el for el, count in matches for _ in range(int(count))]
    if hasattr(elements, "tolist"):
        elements = elements.tolist()
    if elements and isinstance(elements[0], (list, tuple, np.ndarray)):
        elements = [el[0] for el in elements]
    return [str(e) for e in elements]


def _as_2d(a, n_atoms: int) -> np.ndarray:
    """Normalise a stored per-atom neighbor array to (n_atoms, k)."""
    arr = np.asarray(a)
    if arr.dtype == object:
        arr = np.stack([np.asarray(x).reshape(-1) for x in arr])
    arr = np.squeeze(arr)
    return arr.reshape(n_atoms, -1)


def load_prepared(data, *, fea_path: str | None = None,
                  featuriser: Featuriser | None = None,
                  max_neighbor_number: int = 24,
                  target: str = "e_above_hull") -> list[CrystalGraph]:
    """Load a prepared dict (or the path of a gzipped pickle of one)."""
    if isinstance(data, (str, os.PathLike)):
        with gzip.open(data, "rb") as f:
            data = pickle.load(f)
    feat = featuriser or load_featuriser(fea_path)

    inputs = data["input"]
    # format 0: (3, n) rows [shell, self_idx, nbr_idx]; format 1: (n, 3)
    fmt = 1 if np.asarray(inputs, dtype=object).shape[0] > 3 else 0
    targets = data["target"][target]
    graphs: list[CrystalGraph] = []
    for idx in range(len(targets)):
        batch_comp = data["batch_comp"][idx]
        elements = _parse_elements(data["comps"][idx], batch_comp)
        n = len(elements)

        # distinct elements in insertion order, with fractional weights
        comp: dict[str, int] = {}
        for el in elements:
            comp[el] = comp.get(el, 0) + 1
        distinct = list(comp)
        weights = np.asarray([comp[el] / n for el in distinct], np.float32)

        rows = ([inputs[r][idx] for r in range(3)] if fmt == 0
                else [inputs[idx][r] for r in range(3)])
        shell, self_idx, nbr_idx = (
            _as_2d(a, n)[:, :max_neighbor_number].reshape(-1)
            .astype(np.int32) for a in rows)

        t = float(np.asarray(targets[idx]).reshape(-1)[0])
        y = t if target == "volume" else t * n  # data.py:139-144

        try:
            cry_id = data["batch_ids"][idx]
            if isinstance(cry_id, (list, tuple, np.ndarray)):
                cry_id = cry_id[0]
        except (KeyError, IndexError):
            cry_id = idx

        graphs.append(CrystalGraph(
            atom_fea=feat.matrix(elements),
            edge_src=self_idx,
            edge_dst=nbr_idx,
            edge_shell=shell,
            comp_fea=feat.matrix(distinct),
            comp_weight=weights,
            target=y,
            cry_id=cry_id,
            composition=str(batch_comp),
        ))
    return graphs


def load_dataset_dir(path: str, **kwargs) -> list[CrystalGraph]:
    """Load one file, or every ``*.pickle.gz`` in a folder
    (lightning_module.py:51-76); a file in the folder that cannot be read
    is reported and skipped, as the reference does."""
    if os.path.isfile(path):
        return load_prepared(path, **kwargs)
    files = sorted(glob.glob(os.path.join(path, "*.pickle.gz")))
    if not files:
        raise FileNotFoundError(f"no *.pickle.gz under {path}")
    graphs = []
    for f in files:
        try:
            graphs.extend(load_prepared(f, **kwargs))
            print(f"{f} loaded")
        except Exception as e:  # noqa: BLE001 - report it, load the rest
            print(f"{f} could not be loaded ({e!r})")
    return graphs


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
    Yields CPU :class:`~cgat_tpu_torch.data.batching.CrystalBatch` es and
    records each batch's real edge and graph counts in ``last_counts``.
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
            chunk = [self.graphs[i] for i in idx]
            # real edges and graphs of the batch, counted on the host
            self.last_counts = {"edges": sum(len(g.edge_src) for g in chunk),
                                "graphs": len(chunk)}
            yield collate(chunk, max_nbr=self.max_nbr,
                          node_bucket=self.node_bucket,
                          num_graphs=self.batch_size,
                          num_comp_slots=self.num_comp_slots,
                          num_node_slots=self.num_node_slots,
                          max_degree=self.max_degree)
