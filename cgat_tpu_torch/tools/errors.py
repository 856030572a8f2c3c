"""Per-sample error ranking for active learning
(reference: Utilities/calculate_errors.py:18-97, get_highest_errors.py:14-65);
counterpart of ``cgat_tpu/tools/errors.py``.

``calculate_errors`` runs a trained checkpoint over every pool shard and
writes per-sample |error| CSVs; ``calculate_gp_uncertainties`` writes the
GP head's predictive std in their place; ``get_highest_errors`` globally
ranks them, moves the top-N entries out of the pool and returns them as
the next training sample. The model and the GP run on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import csv
import os

import numpy as np
import torch

from .shards import (entry_ids, iter_shards, load_pickle, merge_prepared,
                     remove_entries, save_pickle, select_entries, shard_path)


def error_csv_path(i: int, path: str) -> str:
    return shard_path(i, os.path.join(path, "temp"),
                      prefix="errors").replace("pickle.gz", "csv")


def _write_scores(i: int, pool_dir: str, data: dict, scores) -> None:
    out = error_csv_path(i, pool_dir)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["batch_ids", "errors"])     # the column holds any score
        for b, e in zip(entry_ids(data), scores):
            w.writerow([b, float(e)])


def calculate_errors(ckpt_dir: str, pool_dir: str, *,
                     n_shards: int | None = None, target: str | None = None,
                     device=None):
    """Predict every pool shard with a trained model; write per-sample
    absolute errors on the *per-atom* target scale (the reference compares
    trainer predictions against the stored per-atom targets,
    calculate_errors.py:81-90)."""
    from ..data.dataset import load_prepared
    from ..training.trainer import load_trainer

    trainer, _ = load_trainer(ckpt_dir, device=device)
    target = target or trainer.cfg.target
    for i, p in iter_shards(pool_dir, n_shards):
        data = load_pickle(p)
        graphs = load_prepared(data, fea_path=trainer.cfg.fea_path,
                               max_neighbor_number=trainer.cfg.max_nbr,
                               target=target)
        preds = trainer.predict(graphs)  # y-scale (per-atom * n)
        n_atoms = np.asarray([g.n_atoms for g in graphs], np.float64)
        stored = np.asarray(data["target"][target], np.float64).reshape(-1)
        # NOTE deviation from the reference: calculate_errors.py:88 compares
        # the y-scale prediction against the stored *per-atom* target
        # (mismatched scales, inflating errors for larger cells); here both
        # sides are per-atom.
        per_atom_pred = preds if target == "volume" else preds / n_atoms
        _write_scores(i, pool_dir, data, np.abs(per_atom_pred - stored))


def get_highest_errors(pool_dir: str, n: int = 25000, *,
                       n_shards: int | None = None,
                       out_sample: str | None = None):
    """Top-N error selection: rank all error CSVs, remove the entries from
    the pool shards (rewritten in place) and return the merged sample
    (get_highest_errors.py:14-65)."""
    rows = []
    for i, _ in iter_shards(pool_dir, n_shards):
        with open(error_csv_path(i, pool_dir), newline="") as f:
            for r in csv.DictReader(f):
                rows.append((r["batch_ids"], float(r["errors"])))
    rows.sort(key=lambda r: r[1], reverse=True)
    chosen = {b for b, _ in rows[:n]}

    picked = []
    for i, p in iter_shards(pool_dir, n_shards):
        data = load_pickle(p)
        idx = [j for j, b in enumerate(entry_ids(data)) if b in chosen]
        if idx:
            picked.append(select_entries(data, idx))
            remove_entries(data, idx)
            save_pickle(data, p)
    sample = merge_prepared(picked) if picked else None
    if sample is not None and out_sample:
        save_pickle(sample, out_sample)
    return sample


def calculate_gp_uncertainties(ckpt_dir: str, gp_path: str, pool_dir: str, *,
                               n_shards: int | None = None, device=None):
    """Uncertainty-sampling acquisition: score every pool entry by the GP
    head's predictive std (on the model's device) instead of |error|.

    Goes beyond the reference's error ranking (calculate_errors.py), which
    needs pool LABELS — predictive uncertainty needs none, so active
    learning works on genuinely unlabeled candidate pools (score first,
    compute/label only the selected entries). Writes the same per-shard CSV
    files, so :func:`get_highest_errors` ranks and absorbs them unchanged.
    """
    from ..data.dataset import load_prepared
    from ..training.trainer import load_trainer
    from ..uncertainty.gp import GPConfig, gp_predict_y, load_gp

    trainer, _ = load_trainer(ckpt_dir, device=device)
    gp_params, meta = load_gp(gp_path, device=trainer.device)
    cfg = GPConfig(zero_mean=bool(meta.get("zero_mean", False)))
    for i, p in iter_shards(pool_dir, n_shards):
        data = load_pickle(p)
        # the scorer never reads labels; load with whatever target key the
        # shard happens to carry (unlabeled pools may store a placeholder)
        tkey = (trainer.cfg.target if trainer.cfg.target in data["target"]
                else next(iter(data["target"])))
        graphs = load_prepared(data, fea_path=trainer.cfg.fea_path,
                               max_neighbor_number=trainer.cfg.max_nbr,
                               target=tkey)
        emb = torch.as_tensor(trainer.embeddings(graphs),
                              device=trainer.device)
        with torch.no_grad():
            _, var = gp_predict_y(gp_params, emb, cfg)
            std = torch.sqrt(var) * float(meta.get("std", 1.0))
        _write_scores(i, pool_dir, data, std.cpu().numpy())
