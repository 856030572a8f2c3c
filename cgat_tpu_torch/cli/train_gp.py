"""GP uncertainty head on frozen CGAT embeddings, counterpart of
``cgat_tpu/cli/train_gp.py`` (reference: CGAT/gaussian_process.py:568-673).

    python -m cgat_tpu_torch.cli.train_gp --cgat-model <run dir> [--on-the-fly]

Trains a sparse variational GP (``cgat_tpu_torch.uncertainty``) on the
graph embeddings of a trained port run and writes a gzipped pickle of the
JAX package's layout (``params``, ``mean``, ``std``, ``zero_mean``,
``val_mae``, ``history``). Runs on the CUDA card unless ``--device cpu``.
``--devices N`` (N > 1) embeds across N ranks: this command starts N rank
processes on this host (NCCL, one card each; gloo with ``--device cpu``),
each running it as one rank; inside a world that torchrun started it is
one rank itself. Every rank fits the same GP and rank 0 writes ``--out``.
"""
from __future__ import annotations

import argparse
import sys

from .common import add_device_arg, device_from_args, in_world, launch


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cgat-model", required=True,
                   help="trained CGAT checkpoint run directory")
    p.add_argument("--data-path", default=None,
                   help="prepared dataset (default: checkpoint's data_path)")
    p.add_argument("--embedding-path", default=None,
                   help="precomputed embedding pickle (EmbeddingData path, "
                        "gaussian_process.py:95-138)")
    p.add_argument("--inducing-points", type=int, default=500)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--zero-mean", action="store_true",
                   help="ZeroMean instead of ConstantMean")
    p.add_argument("--on-the-fly", action="store_true", dest="on_the_fly",
                   help="embed each batch through the frozen CGAT inside "
                        "the GP step instead of precomputing all embeddings "
                        "(reference on-the-fly mode, "
                        "gaussian_process.py:241-296; use for huge pools)")
    p.add_argument("--devices", type=int, default=1,
                   help="ranks the embedding pass is shared over (the "
                        "reference's DDP GP, gaussian_process.py:644-672)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="gp_model.pickle.gz")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = device_from_args(args)
    if args.devices < 1:
        raise ValueError(f"--devices must be at least 1, not {args.devices}")
    if args.devices > 1 and not in_world():
        launch(main, args.devices, argv, device)
        return 0

    from ..uncertainty.gp import train_gp_from_checkpoint
    train_gp_from_checkpoint(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
