"""Dataset annotation: volume target + sequential ids, unary removal
(reference: CGAT/add_volume_target.py:9-39); counterpart of
``cgat_tpu/tools/annotate.py``.

Operates on lists of structure entries (dicts with lattice/frac_coords/
species/data, or pymatgen ComputedStructureEntry when available): adds
``volume`` = cell volume / n_sites, rewrites ``id`` to "<seq>,<spg>", drops
single-element crystals.
"""
from __future__ import annotations

import re

import numpy as np

_SPG_RE = re.compile(r"spg(\d{1,3})")


def _volume(entry) -> float:
    if isinstance(entry, dict):
        lat = np.asarray(entry["lattice"], float)
        return abs(np.linalg.det(lat)) / len(entry["species"])
    s = getattr(entry, "structure", entry)
    return s.volume / s.num_sites


def _species(entry):
    if isinstance(entry, dict):
        return entry["species"]
    s = getattr(entry, "structure", entry)
    return [site.specie.symbol for site in s]


def _data(entry) -> dict:
    if isinstance(entry, dict):
        return entry.setdefault("data", {})
    return entry.data


def annotate_volume_and_ids(entries, start_id: int = 0,
                            drop_unaries: bool = True):
    """Returns (kept_entries, next_id). Mirrors add_volume_target.py:14-36:
    per-atom volume, "id,spg" ids (spg from data or the id string; 0 when
    unavailable), unaries removed."""
    kept = []
    id_ = start_id
    for entry in entries:
        d = _data(entry)
        d["volume"] = _volume(entry)
        spg = d.get("spg")
        if spg is None:
            m = _SPG_RE.search(str(d.get("id", "")))
            spg = int(m.group(1)) if m else 0
        if len(set(_species(entry))) == 1 and drop_unaries:
            continue
        d["id"] = f"{id_},{spg}"
        id_ += 1
        kept.append(entry)
    return kept, id_
