"""Step-throughput meter, counterpart of ``ThroughputMeter`` in
``cgat_tpu/utils/profiling.py``: the trainer logs its ``rates()`` each
epoch. The device trace (``trace`` there) comes with slice 9 (tracing)."""
from __future__ import annotations

import time


class ThroughputMeter:
    """Accumulates an epoch's step count and its real (unpadded) edge and
    graph totals, counted on the host; ``rates()`` divides them by the wall
    time since the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.t0 = time.perf_counter()
        self.steps = 0
        self.edges = 0
        self.graphs = 0

    def update(self, *, edges: int = 0, graphs: int = 0, steps: int = 1):
        self.steps += steps
        self.edges += edges
        self.graphs += graphs

    def rates(self) -> dict:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "edges_per_sec": self.edges / dt,
            "graphs_per_sec": self.graphs / dt,
            "steps_per_sec": self.steps / dt,
            "epoch_time": dt,
        }
