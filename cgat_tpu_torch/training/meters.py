"""Small metric helpers, counterpart of ``cgat_tpu/training/meters.py``
(reference: CGAT/prepare_data.py:325-370)."""
from __future__ import annotations

import numpy as np


class AverageMeter:
    """Running average (AverageMeter, prepare_data.py:325-341)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Normalizer:
    """Fit/normalise/denormalise with persistable state
    (Normalizer, prepare_data.py:344-370). Uses the same unbiased std as the
    trainer's normalisation."""

    def __init__(self):
        self.mean = 0.0
        self.std = 1.0

    def fit(self, values):
        values = np.asarray(values, np.float64)
        self.mean = float(values.mean())
        self.std = float(values.std(ddof=1)) if values.size > 1 else 1.0

    def norm(self, x):
        return (x - self.mean) / self.std

    def denorm(self, x):
        return x * self.std + self.mean

    def state_dict(self):
        return {"mean": self.mean, "std": self.std}

    def load_state_dict(self, d):
        self.mean = float(d["mean"])
        self.std = float(d["std"])
