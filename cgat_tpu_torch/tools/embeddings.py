"""Graph-embedding export and filtering
(reference: Utilities/calculate_embeddings.py, filter_embeddings.py);
counterpart of ``cgat_tpu/tools/embeddings.py``.

``calculate_embeddings`` rewrites prepared dataset files with their 'input'
replaced by (C, embedding_dim) CGAT graph embeddings — the EmbeddingData
format consumed by the GP head; the model runs on the card unless the
caller passes ``device="cpu"``. ``filter_embeddings`` strips test/val ids
from embedding shards.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .shards import batch_id_str, load_pickle, save_pickle


def calculate_embeddings(ckpt_dir: str, data_paths, target_path: str, *,
                         fea_path: str | None = None, device=None):
    """Replace 'input' of each prepared file with graph embeddings
    (calculate_embeddings.py:56-75)."""
    from ..data.dataset import load_prepared
    from ..training.trainer import load_trainer

    trainer, _ = load_trainer(ckpt_dir, device=device)
    if isinstance(data_paths, str):
        data_paths = [data_paths]
    os.makedirs(target_path, exist_ok=True)
    for data_path in data_paths:
        files = (sorted(glob.glob(os.path.join(data_path, "*.pickle.gz")))
                 if os.path.isdir(data_path) else [data_path])
        for file in files:
            data = load_pickle(file)
            graphs = load_prepared(
                data, fea_path=fea_path or trainer.cfg.fea_path,
                max_neighbor_number=trainer.cfg.max_nbr,
                target=trainer.cfg.target)
            data["input"] = trainer.embeddings(graphs).astype(np.float32)
            save_pickle(data, os.path.join(target_path,
                                           os.path.basename(file)))


def remove_batch_ids(data: dict, batch_ids: set, *, inplace: bool = True,
                     modify_batch_ids: bool = True) -> dict:
    """Drop entries whose batch id is in ``batch_ids``; works on the
    EmbeddingData layout where 'input' is (C, D) (filter_embeddings.py:8-37).
    """
    if len(batch_ids) == 0:
        return data
    if not modify_batch_ids:
        batch_ids = set(batch_ids)
    idx = []
    for i, b in enumerate(data["batch_ids"]):
        bid = batch_id_str(b)
        if bid in batch_ids:
            idx.append(i)
            batch_ids.remove(bid)
    idx.reverse()
    new_data = data if inplace else {}
    new_data["input"] = np.delete(data["input"], idx, axis=0)
    ids = list(data["batch_ids"])
    for i in idx:
        ids.pop(i)
    new_data["batch_ids"] = ids
    new_data["batch_comp"] = np.delete(np.asarray(data["batch_comp"],
                                                  dtype=object), idx, axis=0)
    if not inplace:
        new_data["target"] = {}
    for t in data["target"]:
        new_data["target"][t] = np.delete(data["target"][t], idx, axis=0)
    new_data["comps"] = np.delete(np.asarray(data["comps"], dtype=object),
                                  idx, axis=0)
    return new_data


def get_ids(file: str) -> set[str]:
    return {batch_id_str(b) for b in load_pickle(file)["batch_ids"]}


def filter_embeddings(path: str, target_dir: str | None = None):
    """Remove test/val entries (under path/test, path/val) from every
    embedding shard at ``path`` (filter_embeddings.py:44-68)."""
    target_dir = target_dir or os.path.join(path, "train")
    files = (glob.glob(os.path.join(path, "val", "*.pickle.gz"))
             + glob.glob(os.path.join(path, "test", "*.pickle.gz")))
    test_val_ids = set()
    for f in files:
        test_val_ids |= get_ids(f)
    os.makedirs(target_dir, exist_ok=True)
    for f in glob.glob(os.path.join(path, "*.pickle.gz")):
        data = remove_batch_ids(load_pickle(f), test_val_ids)
        save_pickle(data, os.path.join(target_dir, os.path.basename(f)))
