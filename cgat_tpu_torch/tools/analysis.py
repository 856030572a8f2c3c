"""Analysis utilities: ensemble prediction export, GP prediction CSVs, t-SNE
(reference: Utilities/prediction.py, gp_predict.py, tsne.py,
errors_of_additional_data.py); counterpart of
``cgat_tpu/tools/analysis.py``.

The model and the GP run on the card unless the caller passes
``device="cpu"``. ``tsne_embed`` is the port's own exact t-SNE in torch
(the JAX package calls openTSNE or scikit-learn, which the port does not
import).
"""
from __future__ import annotations

import csv
import math
import os

import numpy as np
import torch

from .shards import load_pickle

# scikit-learn's t-SNE constants (sklearn/manifold/_t_sne.py, _utils.pyx)
_MACHINE_EPSILON = np.finfo(np.double).eps
_PERPLEXITY_TOLERANCE = 1e-5
_PERPLEXITY_STEPS = 100
_EARLY_EXAGGERATION = 12.0
_EXPLORATION_ITERS = 250
_MAX_ITERS = 1000
_CHECK_EVERY = 50
_ITERS_WITHOUT_PROGRESS = 300
_MIN_GRAD_NORM = 1e-7
_MIN_GAIN = 0.01


def ensemble_predict(ckpt_dirs, data_paths, out_dir, *,
                     export_embeddings: bool = False, device=None):
    """Per-dataset predictions (or embeddings) for each checkpoint of a seed
    ensemble, written as text files like Utilities/prediction.py:30-68."""
    from ..data.dataset import load_prepared
    from ..training.trainer import load_trainer

    for ckpt in ckpt_dirs:
        trainer, _ = load_trainer(ckpt, device=device)
        seed = trainer.cfg.seed
        for path in data_paths:
            data = load_pickle(path)
            graphs = load_prepared(data, fea_path=trainer.cfg.fea_path,
                                   max_neighbor_number=trainer.cfg.max_nbr,
                                   target=trainer.cfg.target)
            comp = os.path.splitext(os.path.basename(path))[0]
            d = os.path.join(out_dir, comp)
            os.makedirs(d, exist_ok=True)
            if export_embeddings:
                np.savetxt(os.path.join(d, "graph_embeddings.txt"),
                           trainer.embeddings(graphs))
            else:
                preds = trainer.predict(graphs)
                np.savetxt(os.path.join(d, f"{seed}.txt"), preds.reshape(-1))
                np.savetxt(os.path.join(d, "target.txt"),
                           np.asarray([g.target for g in graphs]))


def gp_predict_csv(gp_path: str, data_paths, *,
                   target: str = "e_above_hull_new", device=None):
    """GP predictions + uncertainty (upper - mean) + |error| per embedding
    dataset, written as gp_results.csv next to the data
    (Utilities/gp_predict.py:11-36)."""
    from ..uncertainty.gp import (GPConfig, confidence_region, gp_predict_f,
                                  load_gp)

    params, d = load_gp(gp_path, device=device)
    cfg = GPConfig(zero_mean=d.get("zero_mean", False))
    mean, std = d["mean"], d["std"]
    for path in data_paths:
        data = load_pickle(path)
        x = np.asarray(data["input"], np.float32)
        y = np.asarray(data["target"][target], np.float32).reshape(-1)
        with torch.no_grad():
            mu, var = gp_predict_f(params, torch.as_tensor(
                x, device=params.inducing.device), cfg)
            _, upper = confidence_region(mu, var)
        pred = mu.cpu().numpy() * std + mean
        upper = upper.cpu().numpy() * std + mean
        out = os.path.join(os.path.dirname(path), "gp_results.csv")
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["prediction", "uncertainty", "absolute error"])
            for p, u, t in zip(pred, upper - pred, np.abs(pred - y)):
                w.writerow([float(p), float(u), float(t)])


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """(N, N) squared Euclidean distances of the rows of ``x``, computed in
    f64 and returned as f32 (scikit-learn's ``pairwise_distances(...,
    squared=True)`` for f32 input, cast to f32 as its t-SNE does)."""
    x = x.double()
    sq = (x * x).sum(1)
    d = (sq[:, None] + sq[None, :] - 2.0 * x @ x.T).clamp_min(0.0)
    d.fill_diagonal_(0.0)
    return d.float()


def joint_probabilities(sqdist: torch.Tensor,
                        perplexity: float) -> torch.Tensor:
    """t-SNE's symmetric input affinities P (N, N) from squared distances,
    as scikit-learn's exact method computes them
    (``_joint_probabilities``): each row's precision found by binary search
    until its conditional distribution's entropy is within 1e-5 of
    log(perplexity) (at most 100 steps; every row at once here, a row
    keeping the precision it converged at), then P = (P_cond + P_cond^T)
    normalised to sum 1, each off-diagonal entry at least f64's machine
    epsilon, the diagonal 0. In f64 on ``sqdist``'s device."""
    d = sqdist.float().double()
    n = d.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=d.device)
    beta = torch.ones(n, dtype=torch.float64, device=d.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=d.device)
    cond = torch.zeros_like(d)
    target = math.log(perplexity)
    for _ in range(_PERPLEXITY_STEPS):
        p = torch.where(off, torch.exp(-d * beta[:, None]),
                        torch.zeros((), dtype=d.dtype, device=d.device))
        s = p.sum(1)
        s = torch.where(s == 0.0, torch.full_like(s, 1e-8), s)
        p = p / s[:, None]
        diff = torch.log(s) + beta * (d * p).sum(1) - target
        cond = torch.where(done[:, None], cond, p)
        done = done | (diff.abs() <= _PERPLEXITY_TOLERANCE)
        if bool(done.all()):
            break
        up = ~done & (diff > 0)      # entropy too high: raise the precision
        down = ~done & (diff <= 0)
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2.0,
                                           (beta + hi) / 2.0), beta)
        beta = torch.where(down, torch.where(torch.isinf(lo), beta / 2.0,
                                             (beta + lo) / 2.0), beta)
    pj = cond + cond.T
    pj = pj / torch.clamp(pj.sum(), min=_MACHINE_EPSILON)
    return torch.where(off, pj.clamp_min(_MACHINE_EPSILON),
                       torch.zeros((), dtype=pj.dtype, device=pj.device))


def _kl_and_grad(p, y, dof: float):
    """KL(P || Q) and its gradient at the embedding ``y`` (N, k): Q a
    Student-t kernel with ``dof`` degrees of freedom, normalised over the
    off-diagonal pairs (scikit-learn's ``_kl_divergence`` on the full
    matrix)."""
    n = y.shape[0]
    sq = (y * y).sum(1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * y @ y.T).clamp_min(0.0)
    w = (1.0 + d2 / dof) ** ((dof + 1.0) / -2.0)
    w = w * (1.0 - torch.eye(n, dtype=w.dtype, device=w.device))
    q = (w / w.sum()).clamp_min(_MACHINE_EPSILON)
    kl = (p * torch.log(p.clamp_min(_MACHINE_EPSILON) / q)).sum()
    pqw = (p - q) * w
    grad = (pqw.sum(1)[:, None] * y - pqw @ y) * (2.0 * (dof + 1.0) / dof)
    return kl, grad


def _descend(p, y, dof: float, it: int, max_iter: int, momentum: float,
             learning_rate: float, without_progress: int):
    """scikit-learn's ``_gradient_descent`` from iteration ``it``: gains
    (+0.2 where the update and gradient disagree in sign, x0.8 elsewhere,
    at least 0.01), momentum, and every 50 iterations a stop when the
    error has not improved for ``without_progress`` iterations or the
    gradient's norm is below 1e-7. Returns (y, the last iteration)."""
    update = torch.zeros_like(y)
    gains = torch.ones_like(y)
    best_error, best_iter = math.inf, it
    i = it
    for i in range(it, max_iter):
        kl, grad = _kl_and_grad(p, y, dof)
        gains = torch.where(update * grad < 0.0, gains + 0.2,
                            gains * 0.8).clamp_min(_MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad
        y = y + update
        if (i + 1) % _CHECK_EVERY == 0:
            error = float(kl)
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > without_progress:
                break
            if float(torch.linalg.vector_norm(grad)) <= _MIN_GRAD_NORM:
                break
    return y, i


def tsne_embed(embeddings: np.ndarray, *, n_components: int = 2,
               perplexity: float = 30.0, seed: int = 0,
               device=None) -> np.ndarray:
    """t-SNE of graph embeddings (Utilities/tsne.py): the port's exact
    t-SNE in torch, on the card unless ``device`` says otherwise, with
    scikit-learn's objective and schedule (``TSNE(init="pca",
    learning_rate="auto", method="exact")``):

    * P: perplexity-calibrated, symmetrised, normalised
      (:func:`joint_probabilities`);
    * Q: a Student-t kernel with max(n_components - 1, 1) degrees of
      freedom;
    * start: the PCA projection (exact SVD of the centred rows), scaled
      so the first column's standard deviation is 1e-4;
    * early exaggeration 12 for 250 iterations at momentum 0.5, then
      momentum 0.8 up to 1,000 iterations; learning rate max(N / 12 / 4,
      50); gains with a minimum of 0.01.

    Every pair is computed, so time and memory are O(N^2): a handful of
    (N, N) matrices, which fit the card's 80 GB up to ~20k points. With a
    PCA start nothing is drawn at random; ``seed`` (the JAX package's
    argument, which seeds its library's solver) changes nothing here.
    Returns (N, n_components) f32."""
    from ..device import resolve_device

    del seed
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(embeddings, np.float32), device=device)
    n = x.shape[0]
    p = joint_probabilities(squared_distances(x), perplexity).float()
    xc = x.double() - x.double().mean(0)
    u, s, _ = torch.linalg.svd(xc, full_matrices=False)
    y = (u[:, :n_components] * s[:n_components]).float()
    y = y / y[:, 0].std(unbiased=False) * 1e-4
    dof = float(max(n_components - 1, 1))
    lr = max(n / _EARLY_EXAGGERATION / 4.0, 50.0)
    y, it = _descend(p * _EARLY_EXAGGERATION, y, dof, 0, _EXPLORATION_ITERS,
                     0.5, lr, _EXPLORATION_ITERS)
    y, _ = _descend(p, y, dof, it + 1, _MAX_ITERS, 0.8, lr,
                    _ITERS_WITHOUT_PROGRESS)
    return y.cpu().numpy()
