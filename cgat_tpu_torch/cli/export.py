"""Freeze a port training run into a serving artifact, counterpart of
``cgat_tpu/cli/export.py``.

    python -m cgat_tpu_torch.cli.export <run dir> <artifact dir>

The artifact holds the weights as the JAX package's flat ``params.npz``
and a ``manifest.json`` of its format (normalisation, model and collate
config, signature table); ``cgat_tpu_torch.serving.load_artifact`` serves
it, on the card as one replayed CUDA graph a signature. No StableHLO
module is lowered, so ``--platforms`` takes only where the port serves
(``cuda``, ``cpu``); a TPU artifact comes from ``python -m
cgat_tpu.cli.export``. See cgat_tpu_torch/serving/artifact.py.
"""
from __future__ import annotations

import argparse

from ..serving.artifact import PLATFORMS, export_artifact


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir", help="training run directory (with checkpoints/)")
    p.add_argument("out_dir", help="artifact output directory")
    p.add_argument("--tag", default="best", choices=("best", "last"))
    p.add_argument("--batch-size", type=int, default=None,
                   help="graphs per serving batch (default: trainer's)")
    p.add_argument("--node-buckets", type=int, nargs="+", default=None,
                   help="node-slot signatures "
                        "(default: 1x/2x/4x the trainer's node bucket)")
    p.add_argument("--platforms", nargs="+", default=list(PLATFORMS),
                   help="where the artifact is served (recorded in the "
                        "manifest): cuda and/or cpu")
    args = p.parse_args(argv)

    manifest = export_artifact(args.run_dir, args.out_dir, tag=args.tag,
                               batch_size=args.batch_size,
                               node_buckets=args.node_buckets,
                               platforms=args.platforms)
    sigs = ", ".join(s["key"] for s in manifest["signatures"])
    print(f"wrote {args.out_dir} ({sigs}; platforms "
          f"{','.join(manifest['platforms'])})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
