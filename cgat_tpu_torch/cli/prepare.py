"""Offline featurisation, counterpart of ``cgat_tpu/cli/prepare.py``
(reference: CGAT/prepare_data.py:372-387).

    python -m cgat_tpu_torch.cli.prepare --file <structures .pickle.gz> \
        --source-dir <dir> --target-dir <dir>

Reads a gzipped pickle of structure entries (dicts with lattice/frac_coords/
species/data, or pymatgen ComputedStructureEntry when pymatgen is installed)
and writes the featurised dataset dict in the reference schema. It runs on
the host: the neighbor search is the native C++ core, built at first use.
"""
from __future__ import annotations

import argparse
import gzip
import os
import pickle


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--file", default="dcgat_1_000.pickle.gz")
    p.add_argument("--source-dir", default="./")
    p.add_argument("--target-dir", default="./")
    p.add_argument("--target-file", default=None)
    p.add_argument("--radius", type=float, default=18.0)
    p.add_argument("--max-nbr", type=int, default=24)
    p.add_argument("--targets", nargs="+",
                   default=["e_above_hull", "e_form"])
    p.add_argument("--cache-dir", default=None,
                   help="incremental featurisation cache directory: repeat "
                        "runs over overlapping structure sets (AL rounds) "
                        "skip the neighbor search for known structures")
    p.add_argument("--workers", type=int, default=0,
                   help="parallel featurisation processes (the reference "
                        "parallelises prepare with a shell loop over "
                        "shards, Utilities/prepare.sh; 0/1 = serial)")
    args = p.parse_args(argv)

    from ..data.featurizer import build_dataset_prepare
    out = build_dataset_prepare(
        os.path.join(args.source_dir, args.file),
        target_property=tuple(args.targets), radius=args.radius,
        max_neighbor_number=args.max_nbr, cache=args.cache_dir,
        workers=args.workers)
    name = args.target_file or os.path.basename(args.file)
    path = os.path.join(args.target_dir, name)
    with gzip.open(path, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {len(out['batch_ids'])} entries to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
