"""Active-learning round orchestration (reference SURVEY.md section 3.5);
counterpart of ``cgat_tpu/tools/loop.py``.

The reference runs its active-learning loop as a chain of standalone scripts
(sample.py -> train.sh -> calculate_errors.py -> get_highest_errors.py ->
retrain). This module ties the port's equivalents into one callable round:

  1. (first round) draw the initial candidate sample from the pool
     (random or Metropolis element-balanced), excluding test/val ids;
  2. train (or fine-tune) a model on the accumulated sample;
  3. rank the remaining pool by per-sample error with the trained model,
     or by the predictive std of a GP on its frozen embeddings;
  4. move the top-N from the pool into the training sample.

Each step is also usable on its own (``tools.sample`` / ``tools.errors``).
The model and the GP run on the card unless the caller passes
``device="cpu"``. A round drops its trainers and its GP fit before it
returns, so successive rounds on the card hold no more memory than one.
"""
from __future__ import annotations

import gzip
import os
import pickle
import tempfile

import numpy as np

from . import shards
from .errors import (calculate_errors, calculate_gp_uncertainties,
                     get_highest_errors)
from .sample import (extract_sample, metropolis_sample, random_sample,
                     scan_pool)


def initial_sample(pool_dir: str, out_dir: str, n: int, *,
                   method: str = "random", seed: int = 1,
                   exclude_ids: set[str] | None = None,
                   n_shards: int | None = None):
    """Step 1: draw the first training sample and rewrite the pool without it
    (Utilities/sample.py main flow). Returns the merged prepared dict."""
    ids, element_sets, stoich = scan_pool(pool_dir, exclude_ids=exclude_ids,
                                          n_shards=n_shards)
    if method == "metropolis":
        chosen = metropolis_sample(ids, element_sets, stoich, n, seed=seed)
    else:
        chosen = random_sample(ids, n, seed=seed)
    return extract_sample(pool_dir, out_dir, chosen, n_shards=n_shards)


def active_learning_round(pool_dir: str, sample_path: str, *,
                          trainer_cfg, model_cfg,
                          n_new: int = 25000,
                          pretrained_run: str | None = None,
                          n_shards: int | None = None,
                          target: str | None = None,
                          acquisition: str = "error",
                          gp_kwargs: dict | None = None,
                          device=None):
    """Steps 2-4: train on the current sample, rank the pool, absorb the
    top-N into the sample. Returns (run_dir, new_sample_dict).

    ``acquisition`` selects the pool-ranking score:
    * ``"error"`` — per-sample |error| with the trained model (the
      reference's scheme, calculate_errors.py; needs pool labels);
    * ``"gp_std"`` — predictive std of an SVGP fitted on the sample's frozen
      embeddings (uncertainty sampling; needs NO pool labels). ``gp_kwargs``
      forwards to ``fit_gp`` (num_inducing, epochs, batch_size, ...).

    ``pretrained_run`` starts the model from that run's best weights (its
    model config; ``model_cfg`` is then unused). ``sample_path`` is a
    prepared .pickle.gz holding the accumulated training sample; it is
    rewritten with the newly selected entries appended."""
    from ..data.dataset import load_prepared
    from ..training.trainer import Trainer, load_trainer

    graphs = load_prepared(sample_path, fea_path=trainer_cfg.fea_path,
                           max_neighbor_number=trainer_cfg.max_nbr,
                           target=target or trainer_cfg.target)
    state_dict = None
    if pretrained_run:
        old, _ = load_trainer(pretrained_run, device=device)
        model_cfg, state_dict = old.model_cfg, old.model.state_dict()
        del old
    trainer = Trainer(trainer_cfg, model_cfg, graphs, device=device)
    trainer.init_state(state_dict)
    del state_dict
    trainer.fit()
    run_dir = trainer.last_log_dir
    del trainer     # its step graphs go before the pool is scored

    if acquisition == "gp_std":
        _score_pool_by_gp_std(run_dir, pool_dir, graphs,
                              target=target or trainer_cfg.target,
                              n_shards=n_shards, device=device,
                              **(gp_kwargs or {}))
    else:
        calculate_errors(run_dir, pool_dir, n_shards=n_shards,
                         target=target or trainer_cfg.target, device=device)
    new_sample = get_highest_errors(pool_dir, n=n_new, n_shards=n_shards)
    if new_sample is not None:
        old_sample = shards.load_pickle(sample_path)
        merged = shards.merge_prepared([old_sample, new_sample])
        shards.save_pickle(merged, sample_path)
    return run_dir, new_sample


def _score_pool_by_gp_std(run_dir: str, pool_dir: str, sample_graphs, *,
                          target: str, n_shards: int | None = None,
                          num_inducing: int = 64, epochs: int = 30,
                          batch_size: int = 256, learning_rate: float = 0.01,
                          seed: int = 0, device=None):
    """Fit an SVGP on the training sample's frozen embeddings, then write
    GP-predictive-std score CSVs over the pool (uncertainty sampling). The
    GP is pickled in the layout ``uncertainty.gp.load_gp`` reads, to a
    temporary file that is removed after."""
    from ..training.trainer import load_trainer
    from ..uncertainty.gp import fit_gp

    trainer, _ = load_trainer(run_dir, device=device)
    emb = trainer.embeddings(sample_graphs)
    del trainer
    y = np.asarray([g.target for g in sample_graphs], np.float32)
    mean = float(np.mean(y))
    std = float(np.std(y, ddof=1)) if len(y) > 1 else 1.0
    gp_params, _ = fit_gp(emb, (y - mean) / std,
                          num_inducing=min(num_inducing, len(y)),
                          epochs=epochs, batch_size=batch_size,
                          learning_rate=learning_rate, seed=seed,
                          device=device)
    with tempfile.NamedTemporaryFile(suffix=".pickle.gz",
                                     delete=False) as tf:
        gp_path = tf.name
    with gzip.open(gp_path, "wb") as f:
        pickle.dump({"params": gp_params.map(lambda t: t.cpu().numpy()),
                     "mean": mean, "std": std, "zero_mean": False}, f)
    del gp_params
    try:
        calculate_gp_uncertainties(run_dir, gp_path, pool_dir,
                                   n_shards=n_shards, device=device)
    finally:
        os.unlink(gp_path)
