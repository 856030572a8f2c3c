"""Synthetic crystal graphs for tests and the device smoke run.

Counterpart of ``cgat_tpu/data/synthetic.py`` (numpy, the same draws from
the same seed): a fixed out-degree per atom, monotone shell indices starting
at 1, no self-edges, and a composition graph over the distinct "elements".
``segment_layout`` (no counterpart) gives destination-sorted edge layouts
that the segment kernels' tests and the smoke run hold the kernels on.
"""
from __future__ import annotations

import numpy as np

from .batching import CrystalGraph, host_offsets

# segment_layout's kinds
SEGMENT_LAYOUTS = ("empty_nodes", "padding_tail", "one_node", "n_real_0",
                   "n_real_e", "hub_2000", "many_nodes", "request",
                   "training", "gp")
# the main path's (node slots, real nodes) at 24 edge slots a node slot:
# serving request 0, the first training step, a GP batch of 512 crystals
_MAIN_SHAPES = {"request": (832, 772), "training": (768, 733),
                "gp": (5952, 5929)}


def segment_layout(kind: str, seed: int = 0) -> tuple[np.ndarray, int, int]:
    """A destination-sorted edge layout, ``(offn, n_real, num_nodes)``:
    unclamped CSR pointers (``num_nodes + 9`` entries; padded rows point at
    the last node slot), the real-row count and the node slots. Kinds:
    random degrees of 0 to 4 with empty nodes (``empty_nodes``); the same
    with an all-empty tail of 15 node slots (``padding_tail``); one node
    holding every real row (``one_node``); no real row (``n_real_0``);
    every row real (``n_real_e``); one node of 2,000 rows among small ones
    (``hub_2000``); 20,000 nodes of 0 to 3 rows (``many_nodes``: more node
    starts than the stream kernel's block counts in one round); and the
    main path's shapes, 24 rows a real node and empty padded node slots
    (``request``, ``training``, ``gp``)."""
    rng = np.random.default_rng(seed)
    if kind in _MAIN_SHAPES:
        num_nodes, real_nodes = _MAIN_SHAPES[kind]
        deg = np.where(np.arange(num_nodes) < real_nodes, 24, 0)
        n_pad = 24 * (num_nodes - real_nodes)
    elif kind == "many_nodes":
        num_nodes, n_pad = 20000, 7
        deg = rng.integers(0, 4, size=num_nodes)
    elif kind in SEGMENT_LAYOUTS:
        num_nodes, n_pad = 50, 7
        deg = rng.integers(0, 5, size=num_nodes)
        deg[rng.choice(num_nodes, 12, replace=False)] = 0
        if kind == "padding_tail":
            deg[-15:] = 0
        elif kind == "one_node":
            deg[:] = 0
            deg[20] = 300
        elif kind == "n_real_e":
            n_pad = 0
        elif kind == "hub_2000":
            deg[31] = 2000
    else:
        raise ValueError(f"no segment layout {kind!r}; one of "
                         f"{SEGMENT_LAYOUTS}")
    dst = np.repeat(np.arange(num_nodes), deg).astype(np.int32)
    n_real = 0 if kind == "n_real_0" else len(dst)
    dst = np.concatenate([dst, np.full(n_pad, num_nodes - 1, np.int32)])
    return host_offsets(dst, num_nodes + 8), n_real, num_nodes


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
