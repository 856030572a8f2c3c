"""Batch inference, counterpart of ``cgat_tpu/cli/predict.py`` (reference:
CGAT/predict.py:10-40).

    python -m cgat_tpu_torch.cli.predict <run dir> <dataset> [--embeddings]

Loads the ``best`` checkpoint, runs denormalised predictions (or graph
embeddings) over a prepared dataset and writes them to a gzipped pickle.
Runs on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import gzip
import pickle

from .common import add_device_arg, device_from_args


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpt", help="checkpoint run directory")
    p.add_argument("data", help="prepared .pickle.gz dataset (file or dir)")
    p.add_argument("--out", default="predictions.pickle.gz")
    p.add_argument("--target", default=None,
                   help="override target key (default: from checkpoint)")
    p.add_argument("--embeddings", action="store_true",
                   help="export graph embeddings instead of predictions "
                        "(Utilities/calculate_embeddings.py flow)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = device_from_args(args)

    from ..data.dataset import load_dataset_dir
    from ..training.trainer import load_trainer
    trainer, _ = load_trainer(args.ckpt, device=device)
    target = args.target or trainer.cfg.target
    graphs = load_dataset_dir(args.data, fea_path=trainer.cfg.fea_path,
                              max_neighbor_number=trainer.cfg.max_nbr,
                              target=target)
    if args.embeddings:
        out = {"embeddings": trainer.embeddings(graphs),
               "ids": [g.cry_id for g in graphs]}
    else:
        out = {"pred": trainer.predict(graphs),
               "ids": [g.cry_id for g in graphs],
               "target": [g.target for g in graphs]}
    with gzip.open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
