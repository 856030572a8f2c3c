"""Checkpoint evaluation, counterpart of ``cgat_tpu/cli/evaluate.py``
(reference: test.py:21-38).

    python -m cgat_tpu_torch.cli.evaluate <run dir> [--data-path <dataset>]

Loads the ``best`` checkpoint and prints loss/MAE/RMSE as one JSON line, on
the test split of its dataset or on an explicit dataset. Runs on the CUDA
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json

from .common import add_device_arg, device_from_args


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpt", help="checkpoint run directory")
    p.add_argument("--data-path", default=None,
                   help="override dataset (default: checkpoint's data_path, "
                        "evaluated on its test split)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = device_from_args(args)

    from ..data.dataset import load_dataset_dir
    from ..training.trainer import load_trainer
    if args.data_path:
        trainer, _ = load_trainer(args.ckpt, device=device)
        graphs = load_dataset_dir(args.data_path,
                                  fea_path=trainer.cfg.fea_path,
                                  max_neighbor_number=trainer.cfg.max_nbr,
                                  target=trainer.cfg.target)
    else:
        trainer, _ = load_trainer(args.ckpt, train=True, device=device)
        graphs = trainer.test_graphs
    metrics = trainer.evaluate_split(graphs)
    print(json.dumps({f"test_{k}": v for k, v in metrics.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
