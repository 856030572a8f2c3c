"""The numbers that decide ``correct``, each judged against its limit.

A training cell (the trainer's step, the GP's step) compares, against the
plain reference that follows every step of the set-up from the same
seed and inputs (the checked steps, the warm-up, the replayed steps):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: by the worst leaf of more than one element, the gap
  between the norm of the first gradient as the optimizer got it (from
  its second moment after one step) and the reference's, over the larger
  of the reference's norm of that leaf and of the median leaf (a leaf of
  one element, such as a hypernetwork's ``damping``, has for gradient one
  sum over the whole batch whose terms cancel, and its gap swings from
  seed to seed with the rounding of the terms);
* ``change_gap``: the same of the norm of each leaf's change over the
  replayed steps (replays of the window's CUDA graphs), leaving out the
  leaves whose first reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone);
* ``emb_gap`` (the GP's step): the largest relative gap of a graph
  embedding of the frozen backbone, over the inducing rows and every
  step's batch.

A screening cell compares the answers of a sample of the window's
requests: ``pred_gap``, the largest gap of a crystal's prediction over the
reference's scale of it (the norm of the prediction's gradient with
respect to the crystal's graph embedding times the embedding's norm: the
gap a relative error of the embedding of 1 would make), and ``emb_gap``.
"""
from __future__ import annotations

import math
import sys

import numpy as np

# leaves whose first reference gradient is below this share of the median
# leaf's are left out of change_gap
STILL_LEAF = 1e-3


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def leaf_gap(prog: dict, ref: dict, keys=None) -> float:
    """max over ``keys`` of |prog - ref| / max(ref, the median of ref)."""
    keys = list(ref) if keys is None else list(keys)
    med = float(np.median([ref[k] for k in ref]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def moving_leaves(ref_grad: dict) -> list:
    med = float(np.median(list(ref_grad.values())))
    return [k for k, v in ref_grad.items() if v >= STILL_LEAF * med]


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (every step's), ``grad``
    (leaf -> first gradient norm) and ``change`` (leaf -> norm of the
    change over the replayed steps); ``ref`` also ``sizes`` (leaf -> its
    elements)."""
    keep = moving_leaves(ref["grad"])
    vectors = [k for k, n in ref["sizes"].items() if n > 1]
    return {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": leaf_gap(prog["grad"], ref["grad"], vectors),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep)}


def worst_leaves(prog: dict, ref: dict, keys=None, n: int = 3) -> list:
    """The ``n`` leaves with the largest gaps of :func:`leaf_gap`, with
    their norms (what a reading's look starts from)."""
    keys = list(ref) if keys is None else list(keys)
    med = float(np.median([ref[k] for k in ref]))
    gaps = sorted(((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), k)
                   for k in keys), reverse=True)[:n]
    return [[k, g, prog[k], ref[k], med] for g, k in gaps]


def training_notes(prog: dict, ref: dict) -> dict:
    """The leaves that read the largest gaps, for the run's notes."""
    vectors = [k for k, n in ref["sizes"].items() if n > 1]
    return {"worst_grad": worst_leaves(prog["grad"], ref["grad"], vectors),
            "worst_change": worst_leaves(prog["change"], ref["change"],
                                         moving_leaves(ref["grad"]))}


def emb_gap(emb, ref_emb) -> float:
    """The largest relative gap of a row of ``emb`` (rows of embeddings)."""
    emb, ref_emb = (np.asarray(x, np.float64) for x in (emb, ref_emb))
    return float(np.max(np.linalg.norm(emb - ref_emb, axis=1)
                        / np.linalg.norm(ref_emb, axis=1)))


def screening_numbers(pred, ref_pred, emb, ref_emb, scale) -> dict:
    """``scale``: the reference's scale of each prediction."""
    f = lambda x: np.asarray(x, np.float64)
    return {"pred_gap": float(np.max(np.abs(f(pred) - f(ref_pred))
                                     / f(scale))),
            "emb_gap": emb_gap(emb, ref_emb)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Whether every number is finite and within its limit, and the
    numbers with their limits (as the result line carries them). A number
    without a limit fails."""
    out, ok = {}, True
    for name, v in numbers.items():
        lim = limits.get(name)
        good = lim is not None and math.isfinite(v) and v <= lim
        ok &= good
        out[name] = {"value": v, "limit": lim}
    return ok and bool(numbers), out


def print_checks(checks: dict) -> None:
    """One line a number on stderr, its value beside its limit."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
