"""``python -m cgat_tpu_torch.tools.tsne``: t-SNE projection of graph
embeddings; counterpart of ``cgat_tpu/tools/tsne.py``.

Runnable form of the reference's ``Utilities/tsne.py`` analysis script
(which hardcoded its active-learning directory): reads one or more
EmbeddingData pickles (``prepare``d datasets whose ``input`` was replaced by
graph embeddings, see ``cli.predict --embeddings`` or
``tools.embeddings.calculate_embeddings``), computes the 2-D projection with
:func:`cgat_tpu_torch.tools.analysis.tsne_embed` on the card (or on the
CPU with ``--device cpu``), and writes a CSV of coordinates + targets for
plotting.
"""
from __future__ import annotations

import argparse
import csv

import numpy as np


def main(argv=None):
    from ..cli.common import add_device_arg, device_from_args

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("data", nargs="+", help="EmbeddingData pickle(s)")
    p.add_argument("--target", default="e_above_hull_new")
    p.add_argument("--perplexity", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="tsne.csv")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = device_from_args(args)

    from ..uncertainty.gp import embedding_dataset
    from .analysis import tsne_embed

    xs, ys, srcs = [], [], []
    for path in args.data:
        x, y = embedding_dataset(path, args.target)
        xs.append(x)
        ys.append(y)
        srcs.extend([path] * len(y))
    emb = tsne_embed(np.concatenate(xs), perplexity=args.perplexity,
                     seed=args.seed, device=device)
    y = np.concatenate(ys)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["x", "y", "target", "source"])
        for (cx, cy), t, s in zip(emb, y, srcs):
            w.writerow([float(cx), float(cy), float(t), s])
    print(f"wrote {args.out} ({len(y)} points)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
