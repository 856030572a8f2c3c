"""Featurise new prototype batches for active learning
(reference: Utilities/get_additional_data.py, errors_of_additional_data.py);
counterpart of ``cgat_tpu/tools/additional_data.py``.

Walks directories of ``<AxByCz>/annotated/*.json.bz2`` structure batches,
featurises them with :func:`cgat_tpu_torch.data.featurizer
.build_dataset_prepare` and writes prepared pickles grouped by prototype
composition. The batches are read in pymatgen's JSON dict layout
(``ComputedStructureEntry.as_dict()``) by this module itself; pymatgen is
never imported.
"""
from __future__ import annotations

import bz2
import glob
import json
import os
import re

from .shards import save_pickle

_COMP_RE = re.compile(r"(?:/|\\)" + r"([A-Z]\d*)" + r"([A-Z]\d*)?" * 10
                      + r"(?:/|\\)")
_NAME_RE = re.compile(r"([\w-]*)\.json\.bz2")


def get_composition(file: str) -> str:
    """Prototype label (e.g. 'A2B3C') from a path
    (get_additional_data.py:14-16)."""
    return "".join(filter(None, _COMP_RE.search(file).groups()))


def get_file_name(file: str) -> str:
    return _NAME_RE.search(file)[1]


def _entries_from_json(json_data):
    """Structure entries (the featuriser's dicts) from a pymatgen-style JSON
    dump: a list of entries, or a dict holding them under 'entries'."""
    entries = json_data["entries"] if isinstance(json_data, dict) else json_data
    out = []
    for e in entries:
        s = e["structure"]
        out.append({
            "lattice": s["lattice"]["matrix"],
            "frac_coords": [site["abc"] for site in s["sites"]],
            "species": [site["species"][0]["element"]
                        for site in s["sites"]],
            "data": dict(e.get("data", {})),
        })
    return out


def prepare_additional_data(source_globs, out_dir: str = "additional_data",
                            target_property=("e_above_hull_new", "e-form"),
                            **prepare_kwargs):
    """Featurise every matched json.bz2 batch into
    ``out_dir/<comp>/<name>.pickle.gz`` (get_additional_data.py:23-39);
    returns the number of batches."""
    from ..data.featurizer import build_dataset_prepare

    if isinstance(source_globs, str):
        source_globs = [source_globs]
    files = [f for g in source_globs for f in glob.glob(g)]
    for file in files:
        comp_dir = os.path.join(out_dir, get_composition(file))
        os.makedirs(comp_dir, exist_ok=True)
        with bz2.open(file, "rb") as f:
            entries = _entries_from_json(json.load(f))
        prepared = build_dataset_prepare(
            entries, target_property=tuple(target_property),
            progress=False, **prepare_kwargs)
        save_pickle(prepared, os.path.join(
            comp_dir, f"{get_file_name(file)}.pickle.gz"))
    return len(files)
