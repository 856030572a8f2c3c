"""Metropolis independence sampler (role of reference Utilities/metropolis.py,
own design); counterpart of ``cgat_tpu/tools/metropolis.py``, with the same
RNG calls in the same order, so a seed gives the same chain.

Used by element-balanced active-learning sampling to draw atomic numbers from
an inverse element-correlation distribution. Unlike the reference's
list-append chain around Python's global ``random``, this is a seedable
numpy-``Generator`` sampler that pre-draws proposals and acceptance uniforms
in vectorised blocks and stores the chain as a growing array; the discrete
case (finite weight table, uniform proposals — the only case the AL loop
needs) evaluates all proposal weights in one vectorised lookup.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


class MarkovChain:
    """Metropolis chain with independence proposals.

    ``distribution`` is an unnormalised target density evaluated at a state;
    ``proposal`` draws a candidate state given a ``numpy.random.Generator``.
    Acceptance follows the independence-sampler rule
    ``u <= p(y) / p(x_t)`` (clipped at 1). The chain records every step, so
    rejected proposals repeat the previous state — exactly what a histogram
    of ``chain`` needs to converge to the target.
    """

    def __init__(self, distribution: Callable, proposal: Callable,
                 *, seed=None, rng: np.random.Generator | None = None,
                 start=None, max_init_tries: int = 10_000):
        self._p = distribution
        self._proposal = proposal
        self._rng = rng if rng is not None else np.random.default_rng(seed)
        if start is None:
            for _ in range(max_init_tries):
                start = proposal(self._rng)
                if self._p(start) > 0:
                    break
            else:
                raise ValueError(
                    "no feasible start found: distribution was <= 0 for "
                    f"{max_init_tries} proposals")
        self._states: list = [start]
        self._p_cur = float(self._p(start))

    @classmethod
    def discrete(cls, weights, *, seed=None,
                 rng: np.random.Generator | None = None,
                 start: int | None = None) -> "MarkovChain":
        """Chain over ``{0..K-1}`` targeting ``weights`` (unnormalised) with
        uniform integer proposals. ``step`` is fully vectorised apart from
        the inherently sequential accept recursion."""
        w = np.asarray(weights, dtype=np.float64)
        if w.ndim != 1 or w.size == 0:
            raise ValueError("weights must be a non-empty 1-D array")
        if not np.any(w > 0):
            raise ValueError("weights has no positive mass")
        rng = rng if rng is not None else np.random.default_rng(seed)
        if start is None:
            start = int(rng.choice(np.flatnonzero(w > 0)))
        chain = cls(lambda z: float(w[int(z)]),
                    lambda g: int(g.integers(0, w.size)),
                    rng=rng, start=int(start))
        chain._weights = w
        return chain

    # -- chain container protocol -------------------------------------------
    @property
    def chain(self) -> np.ndarray:
        return np.asarray(self._states)

    def __getitem__(self, item):
        return self._states[item]

    def __iter__(self):
        return iter(self._states)

    def __len__(self) -> int:
        return len(self._states)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of steps that moved (distinct consecutive states)."""
        if len(self._states) < 2:
            return 0.0
        arr = self.chain
        return float(np.mean(arr[1:] != arr[:-1]))

    # -- stepping -----------------------------------------------------------
    def step(self, n: int = 1) -> "MarkovChain":
        """Advance ``n`` steps. RNG draws happen in one vectorised block;
        for discrete chains the proposal weights do too."""
        if n <= 0:
            return self
        us = self._rng.random(n)
        if getattr(self, "_weights", None) is not None:
            ys = self._rng.integers(0, self._weights.size, size=n)
            pys = self._weights[ys]
        else:
            ys = [self._proposal(self._rng) for _ in range(n)]
            pys = np.asarray([float(self._p(y)) for y in ys])
        cur, p_cur = self._states[-1], self._p_cur
        out = []
        for y, py, u in zip(ys, pys, us):
            # u <= min(1, py/p_cur), written multiplication-only so a zero
            # current weight (possible only via an explicit `start`) accepts
            if py > 0 and u * p_cur <= py:
                cur, p_cur = y, float(py)
            out.append(cur)
        self._states.extend(out)
        self._p_cur = p_cur
        return self
