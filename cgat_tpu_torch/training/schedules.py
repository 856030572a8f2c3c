"""Learning-rate schedules, counterpart of ``cyclical_lr`` and
``ReduceLROnPlateau`` in ``cgat_tpu/training/schedules.py`` (reference
CGAT/utils.py:50-64, lightning_module.py:340-354).

The reference steps its schedulers once per epoch; here a schedule is a
plain ``epoch -> lr multiplier`` function the trainer evaluates on the host
and sets on the optimizer each epoch.
"""
from __future__ import annotations

import math


def cyclical_lr(period: int = 100, cycle_mul: float = 0.2,
                tune_mul: float = 0.05):
    """Triangular cyclic multiplier in [cycle_mul, 1] (utils.py:50-64).
    ``tune_mul`` is accepted for signature parity and, as in the reference,
    unused."""
    def relative(it):
        cycle = math.floor(1 + it / period)
        x = abs(2 * (it / period - cycle) + 1)
        return max(0.0, 1.0 - x)

    return lambda it: cycle_mul + (1.0 - cycle_mul) * relative(it)


class ReduceLROnPlateau:
    """Host-side plateau scheduler with the torch defaults the reference
    uses (lightning_module.py:346-354): mode=min, factor=0.1, patience=5,
    threshold=2e-4 relative."""

    def __init__(self, factor=0.1, patience=5, threshold=2e-4,
                 cooldown=0, eps=1e-8):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.eps = eps
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                new_scale = self.scale * self.factor
                if self.scale - new_scale > self.eps:
                    self.scale = new_scale
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
        return self.scale
