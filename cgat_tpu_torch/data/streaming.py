"""Out-of-core streaming over sharded prepared datasets.

Counterpart of ``cgat_tpu/data/streaming.py``. The reference's pool is
~2.83M entries stored as 283 shards of 10k (reference:
Utilities/sample.py:95, calculate_errors.py:71), far beyond what the
in-memory :class:`~cgat_tpu_torch.data.dataset.GraphLoader` should hold.
This module trains straight from the shard files:

* :func:`scan_shard_metadata` makes one pass over the shards and caches
  the dataset-wide statistics the static-shape batching and the trainer
  need (graph count, composition slots, max degree, target mean and
  unbiased std) in the sidecar ``.cgat_meta.json`` beside the shards,
  keyed by the shard files' names, sizes and mtimes. The JSON, its key
  and its arithmetic are the JAX package's, so either package reads the
  sidecar the other wrote.
* :class:`StreamingGraphLoader` iterates shard by shard: shard order and
  each shard's order are drawn per epoch from one
  ``np.random.default_rng([seed, epoch])`` (a resumed run takes the same
  batches), leftover graphs are carried across shard boundaries, and the
  next shard is parsed on a thread while the current one trains.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import threading
from typing import Sequence

import numpy as np

from .batching import collate
from .dataset import load_prepared
from .embedding import load_featuriser


def list_shards(path: str) -> list[str]:
    """Every ``*.pickle.gz`` under a directory (or the file itself)."""
    if os.path.isfile(path):
        return [path]
    files = sorted(glob.glob(os.path.join(path, "*.pickle.gz")))
    if not files:
        raise FileNotFoundError(f"no *.pickle.gz under {path}")
    return files


def _cache_key(paths: Sequence[str], target: str, max_nbr: int) -> str:
    h = hashlib.sha256()
    for p in paths:
        st = os.stat(p)
        h.update(f"{os.path.basename(p)}:{st.st_size}:{int(st.st_mtime)};"
                 .encode())
    h.update(f"{target}:{max_nbr}".encode())
    return h.hexdigest()[:16]


def scan_shard_metadata(path: str, *, target: str = "e_above_hull",
                        fea_path: str | None = None, max_nbr: int = 24,
                        cache: bool = True) -> dict:
    """Dataset-wide stats for streaming training, cached in a sidecar JSON.

    Returns ``{key, target, max_nbr, n_graphs, num_comp_slots, max_degree,
    mean, std, per_shard_counts}``. ``mean``/``std`` are over the training
    target y (the per-atom target times n_atoms, as the in-memory trainer
    takes it over its training split), with torch's unbiased std
    (reference lightning_module.py:124-126).
    """
    paths = list_shards(path)
    cache_file = os.path.join(
        os.path.dirname(os.path.abspath(paths[0])), ".cgat_meta.json")
    key = _cache_key(paths, target, max_nbr)
    if cache and os.path.exists(cache_file):
        try:
            with open(cache_file) as f:
                meta = json.load(f)
            if meta.get("key") == key:
                return meta
        except (OSError, ValueError):
            pass

    feat = load_featuriser(fea_path)
    n = 0
    comp_slots = 1
    max_degree = 1
    s1 = 0.0
    s2 = 0.0
    counts = []
    for p in paths:
        graphs = load_prepared(p, featuriser=feat,
                               max_neighbor_number=max_nbr, target=target)
        counts.append(len(graphs))
        n += len(graphs)
        for g in graphs:
            comp_slots = max(comp_slots, g.comp_fea.shape[0])
            max_degree = max(max_degree,
                             -(-len(g.edge_src) // max(g.n_atoms, 1)))
            y = float(g.target)
            s1 += y
            s2 += y * y
    mean = s1 / n if n else 0.0
    var = (s2 - n * mean * mean) / (n - 1) if n > 1 else 1.0
    meta = {
        "key": key,
        "target": target,
        "max_nbr": max_nbr,
        "n_graphs": n,
        "num_comp_slots": comp_slots,
        "max_degree": min(max_degree, max_nbr),
        "mean": mean,
        "std": float(np.sqrt(max(var, 0.0))) if n > 1 else 1.0,
        "per_shard_counts": counts,
    }
    if cache:
        try:
            with open(cache_file, "w") as f:
                json.dump(meta, f)
        except OSError:
            pass
    return meta


class StreamingGraphLoader:
    """Minibatch iterator over sharded prepared data, one shard in memory.

    The surface of ``GraphLoader``: ``set_epoch``, ``__len__``,
    ``__iter__`` yielding CPU ``CrystalBatch`` es, ``last_counts``, and
    the collation attributes (``num_comp_slots``, ``max_degree``) pinned
    from :func:`scan_shard_metadata` so every shard collates into the same
    family of shapes.

    ``process_index``/``process_count`` give each process a disjoint
    slice of the shard list (the reference's DDP sampler at shard
    granularity).
    """

    def __init__(self, path: str, batch_size: int, *,
                 target: str = "e_above_hull", fea_path: str | None = None,
                 shuffle: bool = True, seed: int = 0, max_nbr: int = 24,
                 node_bucket: int = 64, drop_last: bool = True,
                 meta: dict | None = None, prefetch: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self.paths = list_shards(path)
        self.batch_size = batch_size
        self.target = target
        self.shuffle = shuffle
        self.seed = seed
        self.max_nbr = max_nbr
        self.node_bucket = node_bucket
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0
        self._feat = load_featuriser(fea_path)
        self.meta = meta or scan_shard_metadata(
            path, target=target, fea_path=fea_path, max_nbr=max_nbr)
        self.num_comp_slots = self.meta["num_comp_slots"]
        self.max_degree = self.meta["max_degree"]
        if process_count > 1:
            if len(self.paths) < process_count:
                raise ValueError(
                    f"{len(self.paths)} shards < {process_count} processes")
            counts = self.meta["per_shard_counts"]
            self.paths = self.paths[process_index::process_count]
            self._n = sum(counts[process_index::process_count])
        else:
            self._n = self.meta["n_graphs"]

    @property
    def mean(self) -> float:
        return self.meta["mean"]

    @property
    def std(self) -> float:
        return self.meta["std"]

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __len__(self):
        if self.drop_last:
            return self._n // self.batch_size
        return -(-self._n // self.batch_size)

    def _load(self, path: str, rng: np.random.Generator | None):
        graphs = load_prepared(path, featuriser=self._feat,
                               max_neighbor_number=self.max_nbr,
                               target=self.target)
        if rng is not None:
            order = rng.permutation(len(graphs))
            graphs = [graphs[i] for i in order]
        return graphs

    def _shards(self):
        """Yield the parsed (shuffled) shards, the next one parsed on a
        thread meanwhile; advances the epoch counter, as the JAX package's
        loader does."""
        rng = (np.random.default_rng([self.seed, self._epoch])
               if self.shuffle else None)
        order = (rng.permutation(len(self.paths)) if rng is not None
                 else np.arange(len(self.paths)))
        paths = [self.paths[i] for i in order]
        self._epoch += 1
        if not self.prefetch:
            for p in paths:
                yield self._load(p, rng)
            return
        result: list = [None, None]       # the shard's graphs, or an error

        def fetch(p):
            try:
                result[0] = self._load(p, rng)
            except BaseException as e:  # noqa: BLE001 - raised below
                result[1] = e

        t = threading.Thread(target=fetch, args=(paths[0],))
        t.start()
        for nxt in list(paths[1:]) + [None]:
            t.join()
            graphs, err = result
            if err is not None:
                raise err
            if nxt is not None:
                result = [None, None]
                t = threading.Thread(target=fetch, args=(nxt,))
                t.start()
            yield graphs

    def __iter__(self):
        carry: list = []
        for graphs in self._shards():
            carry.extend(graphs)
            n_full = len(carry) // self.batch_size
            for b in range(n_full):
                chunk = carry[b * self.batch_size:(b + 1) * self.batch_size]
                yield self._emit(chunk)
            carry = carry[n_full * self.batch_size:]
        if carry and not self.drop_last:
            yield self._emit(carry)

    def _emit(self, chunk):
        self.last_counts = {"edges": sum(len(g.edge_src) for g in chunk),
                            "graphs": len(chunk)}
        return collate(chunk, max_nbr=self.max_nbr,
                       node_bucket=self.node_bucket,
                       num_graphs=self.batch_size,
                       num_comp_slots=self.num_comp_slots,
                       max_degree=self.max_degree)
