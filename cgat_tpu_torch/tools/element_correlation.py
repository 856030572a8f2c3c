"""``python -m cgat_tpu_torch.tools.element_correlation``: element
co-occurrence statistics over a shard pool; counterpart of
``cgat_tpu/tools/element_correlation.py``.

Runnable form of the reference's ``Utilities/element_correlation.py``
(hardcoded 283-shard loop): scans a pool directory, builds the
diagonal-normalised element co-occurrence matrix
(:func:`cgat_tpu_torch.tools.sample.element_correlation`), saves it as
``.npz`` and prints the strongest correlations (the reference printed the
top 9). Host-only: numpy, no device.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pool-dir", required=True,
                   help="directory of prepared shard pickles")
    p.add_argument("--out", default="element_correlation.npz")
    p.add_argument("--top", type=int, default=9)
    args = p.parse_args(argv)

    from .sample import element_correlation, scan_pool

    batch_ids, element_sets, _ = scan_pool(args.pool_dir)
    corr = element_correlation(element_sets)
    np.savez(args.out, correlation=corr)
    flat = np.argsort(corr, axis=None)[::-1][: args.top]
    print(f"wrote {args.out} ({len(element_sets)} compositions, "
          f"Z up to {corr.shape[0]})")
    for k in flat:
        i, j = divmod(int(k), corr.shape[1])
        print(f"  Z={i + 1} ~ Z={j + 1}: {corr[i, j]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
