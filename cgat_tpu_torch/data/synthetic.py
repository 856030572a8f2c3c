"""Synthetic crystal graphs for tests and the device smoke run.

Counterpart of ``cgat_tpu/data/synthetic.py`` (numpy, the same draws from
the same seed): a fixed out-degree per atom, monotone shell indices starting
at 1, no self-edges, and a composition graph over the distinct "elements".
"""
from __future__ import annotations

import numpy as np

from .batching import CrystalGraph


def random_graph(rng: np.random.Generator, *, n_atoms: int, max_nbr: int = 24,
                 orig_fea: int = 200, n_species: int = 8,
                 target_scale: float = 1.0,
                 full_degree: bool = False) -> CrystalGraph:
    """One random crystal graph. Species features are random but consistent
    within the graph (same species -> same feature row).

    ``full_degree=True`` gives every atom exactly ``max_nbr`` neighbours by
    sampling with replacement, the density of real featurizer output."""
    if full_degree and n_atoms > 1:
        k = max_nbr
    else:
        k = min(max_nbr, max(1, n_atoms - 1)) if n_atoms > 1 else 1
    species = rng.integers(0, n_species, size=n_atoms)
    species_fea = rng.standard_normal((n_species, orig_fea)).astype(np.float32)
    atom_fea = species_fea[species]

    src, dst, shell = [], [], []
    for i in range(n_atoms):
        if n_atoms == 1:
            nbrs = np.array([0])
        else:
            others = np.delete(np.arange(n_atoms), i)
            nbrs = rng.choice(others, size=k, replace=(len(others) < k))
        src.extend([i] * len(nbrs))
        dst.extend(nbrs.tolist())
        # shell index: non-decreasing from 1, random increments
        s = np.cumsum(rng.random(len(nbrs)) < 0.4).astype(np.int64) + 1
        shell.extend(np.minimum(s, max_nbr).tolist())

    uniq, counts = np.unique(species, return_counts=True)
    comp_fea = species_fea[uniq]
    comp_weight = (counts / counts.sum()).astype(np.float32)

    return CrystalGraph(
        atom_fea=atom_fea,
        edge_src=np.asarray(src, np.int32),
        edge_dst=np.asarray(dst, np.int32),
        edge_shell=np.asarray(shell, np.int32),
        comp_fea=comp_fea,
        comp_weight=comp_weight,
        target=float(rng.standard_normal() * target_scale),
        cry_id=int(rng.integers(0, 1 << 30)),
        composition="synthetic",
    )


def random_graphs(seed: int, n_graphs: int, *, n_atoms_range=(4, 10),
                  max_nbr: int = 24, orig_fea: int = 200,
                  full_degree: bool = False):
    rng = np.random.default_rng(seed)
    return [
        random_graph(rng, n_atoms=int(rng.integers(*n_atoms_range)),
                     max_nbr=max_nbr, orig_fea=orig_fea,
                     full_degree=full_degree)
        for _ in range(n_graphs)
    ]
