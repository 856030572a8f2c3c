"""Training-candidate sampling for active learning
(reference: Utilities/sample.py:83-255); counterpart of
``cgat_tpu/tools/sample.py``, with the same draws for the same seeds.

Builds the element co-occurrence correlation matrix over a shard pool,
derives the inverse-frequency element distribution, and draws either a
uniform random sample or a Metropolis element-balanced sample of N candidate
ids, excluding test/validation ids. Selected entries are removed from the
pool shards and returned/merged for the next training round.
"""
from __future__ import annotations

import random
from typing import Iterable

import numpy as np

from .metropolis import MarkovChain
from .periodic import MAX_Z, symbol_to_z
from .shards import (batch_id_str, entry_ids, iter_shards, load_pickle,
                     remove_entries, save_pickle, select_entries)


def composition_elements(batch_comp: str) -> set[int]:
    """Atomic numbers present in a composition string — space-separated
    pymatgen style ('Na1 Cl1', Utilities/sample.py:100) or compact
    ('Na1Cl1')."""
    import re
    comp = batch_comp[0] if isinstance(batch_comp, (list, tuple,
                                                    np.ndarray)) else batch_comp
    comp = str(comp)
    if " " in comp:
        return {symbol_to_z(tok) for tok in comp.split() if tok.strip()}
    return {symbol_to_z(el) for el, _ in
            re.findall(r"([A-Z][a-z]?)(\d*)", comp) if el}


def element_correlation(element_sets: Iterable[set[int]],
                        max_z: int = MAX_Z) -> np.ndarray:
    """Row-normalised co-occurrence matrix with zeroed diagonal
    (Utilities/sample.py:106-121, element_correlation.py)."""
    corr = np.zeros((max_z, max_z))
    for els in element_sets:
        for i in els:
            for j in els:
                corr[i - 1, j - 1] += 1
    diag = corr.diagonal()
    corr = (corr.T / np.where(diag != 0, diag, np.ones(max_z))).T
    np.fill_diagonal(corr, 0.0)
    return corr


def element_distribution(corr: np.ndarray, cap: float = 150.0):
    """Inverse-mean-correlation sampling weights
    (Utilities/sample.py:123-126)."""
    hist = element_weights(corr, cap)

    def f(z_index):
        return hist[int(z_index)]

    return f


def element_weights(corr: np.ndarray, cap: float = 150.0) -> np.ndarray:
    """Inverse-mean-correlation weights as an array indexed by z-1."""
    y = corr.mean(axis=0)
    inv = np.where(y > 1e-3, 1.0 / np.where(y > 0, y, 1.0), np.zeros_like(y))
    return np.minimum(cap, inv)


def scan_pool(pool_dir: str, exclude_ids: set[str] | None = None,
              n_shards: int | None = None):
    """Collect (batch_id, element-set, stoichiometry) over all pool shards,
    skipping excluded (test/val) ids (Utilities/sample.py:84-105)."""
    exclude_ids = exclude_ids or set()
    batch_ids, element_sets, stoich = [], [], []
    for _, p in iter_shards(pool_dir, n_shards):
        data = load_pickle(p)
        for j, b in enumerate(data["batch_ids"]):
            bid = batch_id_str(b)
            if bid in exclude_ids:
                continue
            batch_ids.append(bid)
            element_sets.append(composition_elements(data["batch_comp"][j]))
            stoich.append(str(np.asarray(data["batch_comp"][j]).reshape(-1)[0]))
    return batch_ids, element_sets, stoich


def random_sample(batch_ids: list[str], n: int, seed: int = 1) -> set[str]:
    """Uniform random candidate sample (Utilities/sample.py:182-184)."""
    rng = random.Random(seed)
    return set(rng.sample(batch_ids, n))


def metropolis_sample(batch_ids, element_sets, stoich, n: int,
                      seed: int = 1, max_z: int = MAX_Z) -> set[str]:
    """Element-balanced Metropolis sample: draw elements from the inverse
    correlation distribution, pick an unused compound containing each drawn
    element, skipping duplicate stoichiometries
    (Utilities/sample.py:148-180)."""
    corr = element_correlation(element_sets, max_z)
    chain = MarkovChain.discrete(element_weights(corr), seed=seed)

    ids = list(batch_ids)
    els = [set(e) for e in element_sets]
    sto = list(stoich)
    chosen: set[str] = set()
    seen_stoich: set[str] = set()
    guard = 0
    while len(chosen) < n and ids and guard < 100 * n:
        guard += 1
        chain.step(1)
        z = chain[-1] + 1
        while True:
            i = next((k for k, s in enumerate(els) if z in s), None)
            if i is None:
                break
            s = sto.pop(i)
            els.pop(i)
            bid = ids.pop(i)
            if s not in seen_stoich:
                chosen.add(bid)
                seen_stoich.add(s)
                break
    return chosen


def extract_sample(pool_dir: str, out_dir: str, chosen_ids: set[str],
                   n_shards: int | None = None, rewrite_pool: bool = True):
    """Remove chosen entries from pool shards (rewritten under ``out_dir``)
    and return the merged selected prepared dict
    (Utilities/sample.py:186-250 without the unprepared-structure fork)."""
    from .shards import merge_prepared, shard_path
    chosen = set(chosen_ids)
    picked = []
    for i, p in iter_shards(pool_dir, n_shards):
        data = load_pickle(p)
        idx = [j for j, b in enumerate(entry_ids(data)) if b in chosen]
        if idx:
            picked.append(select_entries(data, idx))
            remove_entries(data, idx)
        if rewrite_pool:
            save_pickle(data, shard_path(i, out_dir))
    return merge_prepared(picked) if picked else None
