"""Synthetic crystals from a seed, the one generator every traffic mix
reads.

The draws follow ``random_graph`` of the port's ``data/synthetic.py`` with
``full_degree=True`` (the featuriser's density): every atom has
``max_nbr`` neighbours drawn with replacement from the other atoms of its
crystal, shell indices rise from 1 by a step with probability 0.4 (at most
``max_nbr``), species features are one standard normal row of
``orig_fea`` per species and crystal, the composition is the crystal's
distinct species with their fractions, and the target is a standard
normal. The crystals are drawn all at once with numpy, so the values are
not those of ``random_graph`` for the same seed; their distribution is.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Crystals:
    """A pool of crystals as flat arrays: atom ``a`` of crystal ``i`` is row
    ``atom_ptr[i] + a``; its edges are rows ``[atom*k, (atom+1)*k)`` of the
    edge arrays (``k`` = ``max_nbr``), with crystal-local source and
    destination ids; composition entries of crystal ``i`` are rows
    ``comp_ptr[i]:comp_ptr[i+1]``."""
    n_atoms: np.ndarray       # (n,) int64
    atom_ptr: np.ndarray      # (n + 1,) int64
    atom_fea: np.ndarray      # (A, orig_fea) f32
    edge_src: np.ndarray      # (A * k,) int32, crystal-local
    edge_dst: np.ndarray      # (A * k,) int32, crystal-local
    edge_shell: np.ndarray    # (A * k,) int32
    comp_ptr: np.ndarray      # (n + 1,) int64
    comp_fea: np.ndarray      # (R_total, orig_fea) f32
    comp_weight: np.ndarray   # (R_total,) f32
    target: np.ndarray        # (n,) f64
    max_nbr: int

    def __len__(self) -> int:
        return len(self.n_atoms)

    def edges(self, i: int) -> slice:
        k = self.max_nbr
        return slice(int(self.atom_ptr[i]) * k, int(self.atom_ptr[i + 1]) * k)

    def atoms(self, i: int) -> slice:
        return slice(int(self.atom_ptr[i]), int(self.atom_ptr[i + 1]))

    def comps(self, i: int) -> slice:
        return slice(int(self.comp_ptr[i]), int(self.comp_ptr[i + 1]))


def make_crystals(seed: int, n: int, *, atoms=(4, 20), n_species: int = 8,
                  max_nbr: int = 24, orig_fea: int = 200) -> Crystals:
    """``n`` crystals of ``atoms[0]`` to ``atoms[1]`` atoms (inclusive,
    uniform) from ``seed``."""
    rng = np.random.default_rng(seed)
    lo, hi = atoms
    n_atoms = rng.integers(lo, hi + 1, size=n).astype(np.int64)
    atom_ptr = np.concatenate([[0], np.cumsum(n_atoms)])
    total = int(atom_ptr[-1])
    crystal = np.repeat(np.arange(n), n_atoms)
    local = np.arange(total) - atom_ptr[crystal]
    species = rng.integers(0, n_species, size=total)
    table = rng.standard_normal((n, n_species, orig_fea)).astype(np.float32)
    atom_fea = table[crystal, species]
    k = max_nbr
    # each atom's neighbours: uniform over the other atoms of its crystal
    n_of_edge = np.repeat(n_atoms[crystal], k)
    src = np.repeat(local, k)
    draw = (rng.random(total * k) * (n_of_edge - 1)).astype(np.int64)
    dst = draw + (draw >= src)
    steps = (rng.random((total, k)) < 0.4).astype(np.int64)
    shell = np.minimum(np.cumsum(steps, axis=1) + 1, k).reshape(-1)
    # the composition: distinct species in ascending order, with fractions
    key = crystal * n_species + species
    uniq, counts = np.unique(key, return_counts=True)
    comp_crystal = uniq // n_species
    comp_species = uniq % n_species
    comp_ptr = np.concatenate([[0], np.cumsum(np.bincount(comp_crystal,
                                                          minlength=n))])
    comp_fea = table[comp_crystal, comp_species]
    comp_weight = (counts / n_atoms[comp_crystal]).astype(np.float32)
    target = rng.standard_normal(n)
    return Crystals(n_atoms, atom_ptr, atom_fea, src.astype(np.int32),
                    dst.astype(np.int32), shell.astype(np.int32), comp_ptr,
                    comp_fea, comp_weight, target, k)


def from_mix(seed: int, mix: dict, orig_fea: int) -> Crystals:
    """The pool a traffic mix's parameters describe (``pool`` crystals of
    ``atoms`` atoms, ``n_species`` species, ``max_nbr`` neighbours)."""
    return make_crystals(seed, mix["pool"], atoms=tuple(mix["atoms"]),
                         n_species=mix["n_species"], max_nbr=mix["max_nbr"],
                         orig_fea=orig_fea)


def dataset_rows(mix: dict, n_pool: int) -> np.ndarray:
    """The pool's crystal at each entry of the dataset that a mix
    describes: the pool repeated to ``dataset`` entries (the pool itself
    where the mix gives none), so that an epoch of the program's loader is
    longer than any window, as an epoch over the source's millions of
    crystals is."""
    return np.arange(int(mix.get("dataset", n_pool))) % n_pool


def to_graphs(crystals: Crystals, graph_cls, rows=None) -> list:
    """The pool as the program's host records (``graph_cls`` is the port's
    ``CrystalGraph``): views into the pool's arrays, no copies; with
    ``rows``, the dataset of those crystals (a repeated crystal is the same
    record)."""
    out = []
    for i in range(len(crystals)):
        a, e, r = crystals.atoms(i), crystals.edges(i), crystals.comps(i)
        out.append(graph_cls(
            atom_fea=crystals.atom_fea[a], edge_src=crystals.edge_src[e],
            edge_dst=crystals.edge_dst[e], edge_shell=crystals.edge_shell[e],
            comp_fea=crystals.comp_fea[r], comp_weight=crystals.comp_weight[r],
            target=float(crystals.target[i]), cry_id=i,
            composition="synthetic"))
    return out if rows is None else [out[i] for i in rows]


def batch_shapes(crystals: Crystals, idx, *, slots: int, node_bucket: int
                 ) -> dict:
    """The shapes of a batch of crystals ``idx`` in ``slots`` crystal
    slots: node slots ``N`` (the real atoms rounded up to
    ``node_bucket``), edge slots ``E`` (``max_nbr`` a node slot), the real
    atoms ``Nr`` and edges ``Er``, the crystal slots ``C``, the real
    composition entries ``Rr`` and ordered pairs ``P``, and the real
    crystals ``n``."""
    idx = np.asarray(idx)
    nr = int(crystals.n_atoms[idx].sum())
    N = max(node_bucket, -(-nr // node_bucket) * node_bucket)
    r = crystals.comp_ptr[idx + 1] - crystals.comp_ptr[idx]
    return {"N": N, "E": N * crystals.max_nbr, "Nr": nr,
            "Er": nr * crystals.max_nbr, "C": slots, "Rr": int(r.sum()),
            "P": int((r * (r - 1)).sum()), "n": len(idx)}
