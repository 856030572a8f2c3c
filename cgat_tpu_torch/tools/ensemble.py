"""Seed ensembles and model soups: train K members, predict, aggregate,
average; counterpart of ``cgat_tpu/tools/ensemble.py``.

The reference runs seed ensembles by hand (shell loops over ``train-CGAT
--seed s``, training_scripts/train.sh, and per-seed prediction export,
Utilities/prediction.py:30-68). Here::

    python -m cgat_tpu_torch.tools.ensemble train --seeds 0 1 2 -- \\
        <cli.train flags>
    python -m cgat_tpu_torch.tools.ensemble predict --out-dir P \\
        --data D.pickle.gz
    python -m cgat_tpu_torch.tools.ensemble summarize --out-dir P
    python -m cgat_tpu_torch.tools.ensemble soup --out-run tb_logs/runs/soup

* ``train``: the same configuration under K seeds, one after another in
  this process (``cli.train``); runs land under
  ``<ckpt-dir>/runs/<prefix>f-<seed>``.
* ``predict``: every member over prepared datasets, a column of
  predictions a seed, as Utilities/prediction.py writes them.
* ``summarize``: the member columns into ``ensemble.csv`` a dataset: the
  ensemble mean, the members' spread (std, the uncertainty the reference's
  active-learning workflow ranks by) and |error| against the stored target.
* ``soup``: the members' weights averaged into one model (a uniform model
  soup), served at the cost of one.

``train`` and ``predict`` run on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os

import numpy as np


def member_run_name(prefix: str, seed: int) -> str:
    """The reference's run naming (train.py:38: f-{seed}_t-{date}) without
    the timestamp, so the members can be found."""
    return f"{prefix}f-{seed}"


def train_ensemble(seeds, train_argv, *, ckpt_dir: str = "tb_logs",
                   run_prefix: str = "ens_", device: str | None = None
                   ) -> list[str]:
    """Train one member per seed through ``cli.train`` (on ``device`` when
    given); returns the member run directories."""
    from ..cli import train as cli_train

    run_dirs = []
    for seed in seeds:
        name = member_run_name(run_prefix, seed)
        argv = list(train_argv) + ["--seed", str(seed), "--run-name", name,
                                   "--ckpt-dir", ckpt_dir]
        if device is not None:
            argv += ["--device", device]
        rc = cli_train.main(argv)
        if rc not in (0, None):
            raise RuntimeError(f"member seed={seed} failed with rc={rc}")
        run_dirs.append(os.path.join(ckpt_dir, "runs", name))
    return run_dirs


def find_members(ckpt_dir: str, run_prefix: str = "ens_") -> list[str]:
    """Member run dirs under ``<ckpt_dir>/runs`` matching the prefix."""
    pat = os.path.join(ckpt_dir, "runs", f"{run_prefix}f-*")
    return sorted(d for d in glob.glob(pat) if os.path.isdir(d))


def summarize(out_dir: str) -> dict:
    """Aggregate the per-seed prediction columns ``ensemble_predict`` writes
    (``<out_dir>/<dataset>/<seed>.txt`` and ``target.txt``) into
    ``ensemble.csv`` a dataset; returns {dataset: MAE of the ensemble
    mean}."""
    results = {}
    for d in sorted(glob.glob(os.path.join(out_dir, "*"))):
        if not os.path.isdir(d):
            continue
        member_files = sorted(
            f for f in glob.glob(os.path.join(d, "*.txt"))
            if os.path.basename(f) != "target.txt")
        if not member_files:
            continue
        preds = np.stack([np.loadtxt(f).reshape(-1) for f in member_files])
        mean = preds.mean(axis=0)
        spread = preds.std(axis=0, ddof=1) if len(member_files) > 1 \
            else np.zeros_like(mean)
        tfile = os.path.join(d, "target.txt")
        target = (np.loadtxt(tfile).reshape(-1) if os.path.exists(tfile)
                  else np.full_like(mean, np.nan))
        err = np.abs(mean - target)
        with open(os.path.join(d, "ensemble.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["prediction", "uncertainty", "absolute error"])
            for p, u, e in zip(mean, spread, err):
                w.writerow([float(p), float(u), float(e)])
        results[os.path.basename(d)] = float(np.nanmean(err))
    return results


def soup(ckpt_dir: str, out_run: str, *, run_prefix: str = "ens_",
         tag: str = "best") -> str:
    """Uniform model soup: the members' weights averaged into one model
    (Wortsman et al. 2022, "Model soups"), in f64 and stored as f32 in
    ``<out_run>/checkpoints/best.pt`` without optimizer state. The members
    must share a model configuration; their normalisation mean and std are
    averaged (they differ only through the seed's split). Returns
    ``out_run``, which ``cli.evaluate``, ``cli.predict`` and
    ``--pretrained-model`` load."""
    import torch

    from ..training.trainer import CheckpointManager

    members = find_members(ckpt_dir, run_prefix)
    if len(members) < 2:
        raise ValueError(f"need >=2 members under {ckpt_dir}/runs "
                         f"with prefix {run_prefix!r}, found {len(members)}")
    states, metas = [], []
    for m in members:
        state, meta = CheckpointManager.load(m, tag=tag, map_location="cpu")
        states.append(state)
        metas.append(meta)
    mc0 = metas[0]["model_config"]
    if any(meta["model_config"] != mc0 for meta in metas[1:]):
        raise ValueError("members have different model configs; "
                         "cannot average parameters")
    n = float(len(states))
    avg = {k: (sum(s[k].to(torch.float64) for s in states) / n)
           .to(torch.float32) for k in states[0]}
    d = os.path.abspath(os.path.join(out_run, "checkpoints"))
    os.makedirs(d, exist_ok=True)
    torch.save({"model": avg, "step": 0}, os.path.join(d, "best.pt"))
    meta = {
        "epoch": 0, "val_mae": float("nan"), "best_val": float("inf"),
        "plateau": None,
        "mean": float(np.mean([m["mean"] for m in metas])),
        "std": float(np.mean([m["std"] for m in metas])),
        "trainer_config": metas[0]["trainer_config"],
        "model_config": mc0,
        "soup_members": [os.path.basename(m) for m in members],
    }
    with open(os.path.join(d, "best.json"), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return out_run


def main(argv=None):
    from ..cli.common import add_device_arg

    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train K seeds of one configuration")
    pt.add_argument("--seeds", type=int, nargs="+", default=None,
                    help="explicit member seeds")
    pt.add_argument("--n-members", type=int, default=5,
                    help="members 0..N-1 when --seeds not given")
    pt.add_argument("--run-prefix", type=str, default="ens_")
    pt.add_argument("--ckpt-dir", type=str, default="tb_logs")
    add_device_arg(pt)
    pt.add_argument("train_args", nargs=argparse.REMAINDER,
                    help="flags forwarded to cli.train (put -- first)")

    pp = sub.add_parser("predict",
                        help="member predictions over prepared datasets")
    pp.add_argument("--ckpt-dir", type=str, default="tb_logs")
    pp.add_argument("--run-prefix", type=str, default="ens_")
    pp.add_argument("--out-dir", type=str, required=True)
    pp.add_argument("--data", type=str, nargs="+", required=True,
                    help="prepared .pickle.gz files")
    pp.add_argument("--summarize", action="store_true",
                    help="also write ensemble.csv aggregates")
    add_device_arg(pp)

    ps = sub.add_parser("summarize",
                        help="aggregate member columns into ensemble.csv")
    ps.add_argument("--out-dir", type=str, required=True)

    po = sub.add_parser("soup", help="average members into one model "
                                     "(uniform model soup)")
    po.add_argument("--ckpt-dir", type=str, default="tb_logs")
    po.add_argument("--run-prefix", type=str, default="ens_")
    po.add_argument("--out-run", type=str, required=True,
                    help="run dir to create for the averaged model")

    args = p.parse_args(argv)
    if args.cmd == "train":
        seeds = args.seeds if args.seeds is not None \
            else list(range(args.n_members))
        extra = [a for a in args.train_args if a != "--"]
        dirs = train_ensemble(seeds, extra, ckpt_dir=args.ckpt_dir,
                              run_prefix=args.run_prefix, device=args.device)
        print("\n".join(dirs))
    elif args.cmd == "predict":
        from ..cli.common import device_from_args
        from .analysis import ensemble_predict

        device = device_from_args(args)
        members = find_members(args.ckpt_dir, args.run_prefix)
        if not members:
            raise SystemExit(f"no member runs under {args.ckpt_dir}/runs "
                             f"with prefix {args.run_prefix!r}")
        ensemble_predict(members, args.data, args.out_dir, device=device)
        if args.summarize:
            print(summarize(args.out_dir))
    elif args.cmd == "soup":
        print(soup(args.ckpt_dir, args.out_run, run_prefix=args.run_prefix))
    else:
        print(summarize(args.out_dir))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
