"""Physically structured test crystals: perturbed known lattice prototypes.
Counterpart of ``cgat_tpu/data/structures.py``, drawing the same numbers
from the same ``default_rng`` streams, so both give equal structures.

The reference's end-to-end walkthrough runs on real dcgat pickles
(reference README.md:58-86); that data is not available offline, so this
module generates the closest physical stand-in: classic structure prototypes
(rocksalt, CsCl, zincblende, fluorite, perovskite) at realistic lattice
parameters with random strain + positional noise, carrying real element
symbols (so the matscholar featuriser applies) and a smooth
composition+geometry target. Every entry is a structure dict consumable by
``cgat_tpu_torch.data.featurizer`` (the schema ``prepare`` ingests), so
the FULL pipeline — periodic kNN featurisation, shell indices, prepare pickles,
training, GP, active learning — runs exactly as it would on dcgat data.
"""
from __future__ import annotations

import numpy as np

# cations / anions drawn from elements present in the matscholar embedding
CATIONS = ["Li", "Na", "K", "Rb", "Mg", "Ca", "Sr", "Ba", "Al", "Ga",
           "Ti", "Zr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Cd", "Pb"]
ANIONS = ["O", "S", "Se", "Te", "F", "Cl", "Br", "I", "N"]

# (name, basis as list[(site_kind, frac_coord)], typical lattice parameter A)
#  site_kind 0 = cation A, 1 = anion X, 2 = second cation B
PROTOTYPES = {
    "rocksalt": ([(0, (0, 0, 0)), (0, (.5, .5, 0)), (0, (.5, 0, .5)),
                  (0, (0, .5, .5)),
                  (1, (.5, 0, 0)), (1, (0, .5, 0)), (1, (0, 0, .5)),
                  (1, (.5, .5, .5))], 5.3),
    "cscl": ([(0, (0, 0, 0)), (1, (.5, .5, .5))], 4.1),
    "zincblende": ([(0, (0, 0, 0)), (0, (.5, .5, 0)), (0, (.5, 0, .5)),
                    (0, (0, .5, .5)),
                    (1, (.25, .25, .25)), (1, (.75, .75, .25)),
                    (1, (.75, .25, .75)), (1, (.25, .75, .75))], 5.6),
    "fluorite": ([(0, (0, 0, 0)), (0, (.5, .5, 0)), (0, (.5, 0, .5)),
                  (0, (0, .5, .5)),
                  (1, (.25, .25, .25)), (1, (.75, .25, .25)),
                  (1, (.25, .75, .25)), (1, (.25, .25, .75)),
                  (1, (.75, .75, .25)), (1, (.75, .25, .75)),
                  (1, (.25, .75, .75)), (1, (.75, .75, .75))], 5.5),
    "perovskite": ([(0, (0, 0, 0)), (2, (.5, .5, .5)),
                    (1, (.5, .5, 0)), (1, (.5, 0, .5)),
                    (1, (0, .5, .5))], 3.9),
}


def _target_fn(species: list[str], a: float) -> float:
    """Smooth deterministic per-atom pseudo-target (an e_above_hull
    stand-in): composition-dependent base + geometric term in the lattice
    parameter. Learnable from (element features, shell structure)."""
    import zlib
    h = np.asarray([(zlib.crc32(s.encode()) % 997) / 997.0 for s in species])
    return float(0.4 * h.mean() + 0.15 * np.sin(1.7 * a) + 0.02 * h.std())


def make_structure(rng: np.random.Generator, kind: str | None = None,
                   *, noise: float = 0.02, strain: float = 0.03,
                   index: int = 0) -> dict:
    """One perturbed prototype crystal as a featuriser structure dict."""
    if kind is None:
        kind = list(PROTOTYPES)[rng.integers(0, len(PROTOTYPES))]
    basis, a0 = PROTOTYPES[kind]
    A_el = CATIONS[rng.integers(0, len(CATIONS))]
    X_el = ANIONS[rng.integers(0, len(ANIONS))]
    B_el = CATIONS[rng.integers(0, len(CATIONS))]
    pick = {0: A_el, 1: X_el, 2: B_el}

    a = a0 * float(1.0 + strain * rng.standard_normal())
    # random symmetric strain on a cubic cell
    eps = strain * 0.5 * rng.standard_normal((3, 3))
    eps = 0.5 * (eps + eps.T)
    lattice = a * (np.eye(3) + eps)

    frac = np.asarray([c for _, c in basis], np.float64)
    species = [pick[k] for k, _ in basis]
    # positional noise in cartesian, folded back to fractional
    cart = frac @ lattice + noise * rng.standard_normal(frac.shape)
    frac = (cart @ np.linalg.inv(lattice)) % 1.0

    y = _target_fn(species, a)
    return {
        "lattice": lattice,
        "frac_coords": frac,
        "species": species,
        "composition": " ".join(
            f"{el}{species.count(el)}" for el in dict.fromkeys(species)),
        "data": {
            "id": f"{kind}-{index}",
            # totals: the featuriser stores them per-atom
            # (prepare_data.py:139), the dataset rescales by n
            "e_above_hull": y * len(species),
            "e_form": (y - 0.5) * len(species),
            "volume": float(abs(np.linalg.det(lattice))),
        },
    }


def random_structures(seed: int, n: int, *, kinds=None, noise: float = 0.02,
                      strain: float = 0.03) -> list[dict]:
    """n perturbed prototype crystals (mixed kinds by default)."""
    rng = np.random.default_rng(seed)
    kinds = list(kinds) if kinds else list(PROTOTYPES)
    return [make_structure(rng, kinds[i % len(kinds)], noise=noise,
                           strain=strain, index=i) for i in range(n)]
