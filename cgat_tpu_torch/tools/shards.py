"""Sharded prepared-dataset bookkeeping for active learning; counterpart
of ``cgat_tpu/tools/shards.py``.

The reference's active-learning loop operates on 283 shards of 10k prepared
entries (Utilities/sample.py:95, calculate_errors.py:71) with ad-hoc
numpy-delete/pop manipulation; these helpers centralise that: shard paths,
id extraction, entry removal, and merging.
"""
from __future__ import annotations

import gzip
import os
import pickle

import numpy as np


def shard_path(i: int, path: str, prefix: str = "data",
               shard_size: int = 10000) -> str:
    """`<path>/data_{i*10000}_{(i+1)*10000}.pickle.gz`
    (Utilities/calculate_errors.py:14-15)."""
    return os.path.join(
        path, f"{prefix}_{i * shard_size}_{(i + 1) * shard_size}.pickle.gz")


def load_pickle(path: str):
    with gzip.open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj, path: str):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with gzip.open(path, "wb") as f:
        pickle.dump(obj, f)


def batch_id_str(entry) -> str:
    """Normalise a batch_ids entry (may be wrapped in a list/array)."""
    if isinstance(entry, (list, tuple, np.ndarray)):
        entry = entry[0]
    return str(entry)


def numeric_id(entry) -> int:
    """Leading integer of a 'id,extra,...' batch id
    (Utilities/sample.py:60-64)."""
    return int(batch_id_str(entry).split(",")[0])


def entry_ids(data: dict) -> list[str]:
    return [batch_id_str(b) for b in data["batch_ids"]]


def remove_entries(data: dict, indices) -> dict:
    """Delete entries (by position) from a prepared dict in place
    (Utilities/sample.py:236-243, get_highest_errors.py:47-57)."""
    indices = sorted(set(int(i) for i in indices), reverse=True)
    if not indices:
        return data
    data["input"] = np.delete(data["input"], indices, axis=1)
    batch_ids = list(data["batch_ids"])
    for j in indices:
        batch_ids.pop(j)
    data["batch_ids"] = batch_ids
    data["batch_comp"] = np.delete(np.asarray(data["batch_comp"],
                                              dtype=object), indices)
    data["comps"] = np.delete(np.asarray(data["comps"], dtype=object),
                              indices)
    for target in data["target"]:
        data["target"][target] = np.delete(data["target"][target], indices)
    return data


def select_entries(data: dict, indices) -> dict:
    """A new prepared dict containing only ``indices``."""
    indices = list(indices)
    return {
        "input": data["input"][:, indices],
        "batch_ids": [data["batch_ids"][j] for j in indices],
        "batch_comp": np.asarray(data["batch_comp"], dtype=object)[indices],
        "target": {t: np.asarray(v)[indices]
                   for t, v in data["target"].items()},
        "comps": np.asarray(data["comps"], dtype=object)[indices],
    }


def _obj1d(arr):
    """Force a 1-D object array of per-crystal entries: numpy collapses
    rectangular lists-of-lists (e.g. all crystals with equal atom counts)
    into 2-D object arrays, which breaks concatenation across shards."""
    a = np.asarray(arr, dtype=object)
    if a.ndim > 1:
        out = np.empty(a.shape[0], dtype=object)
        for i in range(a.shape[0]):
            out[i] = np.asarray(a[i])
        return out
    return a


def merge_prepared(dicts: list[dict]) -> dict:
    """Concatenate prepared dicts (inverse of sharding)."""
    out = {
        "input": np.concatenate([d["input"] for d in dicts], axis=1),
        "batch_ids": [b for d in dicts for b in d["batch_ids"]],
        "batch_comp": np.concatenate(
            [_obj1d(d["batch_comp"]) for d in dicts]),
        "comps": np.concatenate(
            [_obj1d(d["comps"]) for d in dicts]),
        "target": {},
    }
    for t in dicts[0]["target"]:
        out["target"][t] = np.concatenate(
            [np.asarray(d["target"][t]) for d in dicts])
    return out


def get_batch_ids(paths) -> set[str]:
    """All batch ids across one or many prepared files
    (Utilities/adjust_data.py:10-22)."""
    if isinstance(paths, str):
        paths = [paths]
    ids: set[str] = set()
    for p in paths:
        ids |= {batch_id_str(b) for b in load_pickle(p)["batch_ids"]}
    return ids


def remove_batch_ids(data: dict, batch_ids: set, *,
                     modify_batch_ids: bool = True) -> dict:
    """Drop prepared-dict entries by id (Utilities/adjust_data.py:25-54,
    prepare_active_learning.py:38-47); mutates and returns ``data``."""
    if not batch_ids:
        return data
    if not modify_batch_ids:
        batch_ids = set(batch_ids)
    idx = []
    for i, b in enumerate(data["batch_ids"]):
        bid = batch_id_str(b)
        if bid in batch_ids:
            idx.append(i)
            batch_ids.remove(bid)
    return remove_entries(data, idx)


def get_samples_from_unprepared_data(batch_ids: set, unprepared_files,
                                     *, modify_batch_ids: bool = True):
    """Collect raw structure entries matching ids across unprepared shards
    (Utilities/adjust_data.py:57-68)."""
    if not modify_batch_ids:
        batch_ids = set(batch_ids)
    sample = []
    for file in unprepared_files:
        for entry in load_pickle(file):
            d = entry.get("data", {}) if isinstance(entry, dict) \
                else getattr(entry, "data", {})
            eid = str(d.get("id"))
            if eid in batch_ids:
                sample.append(entry)
                batch_ids.remove(eid)
    return sample


def iter_shards(path: str, n_shards: int | None = None, prefix: str = "data",
                shard_size: int = 10000):
    """Yield (index, shard_path) for existing shards."""
    i = 0
    while True:
        p = shard_path(i, path, prefix, shard_size)
        if not os.path.exists(p):
            break
        yield i, p
        i += 1
        if n_shards is not None and i >= n_shards:
            break
