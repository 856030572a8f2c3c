"""Host counters that a CUDA graph's replay keeps true.

A forward that counts on the host what it runs counts nothing when its
graph is replayed, since a replay runs no Python. A counter made by
:func:`counter` is one that ``training.dispatch.StepGraphs`` moves: what a
capture counted is taken back there (a capture computes nothing) and
added on each replay of that graph. ``ops.kernels.build.launch_counts``
(every kernel launch, by C entry), ``models.cgat.edge_update_stats`` and
``ops.kernels.adamw.stats`` read such counters.
"""
from __future__ import annotations

# name -> its fields' running counts
_COUNTERS: dict[str, list[int]] = {}


def counter(name: str, fields: int) -> list[int]:
    """The counter ``name`` of ``fields`` counts, made at zero on its first
    call; the owner adds to it in place."""
    return _COUNTERS.setdefault(name, [0] * fields)


def snapshot() -> dict[str, tuple[int, ...]]:
    """Every counter's counts now."""
    return {name: tuple(c) for name, c in _COUNTERS.items()}


def since(before: dict) -> dict[str, tuple[int, ...]]:
    """What each counter counted after :func:`snapshot` gave ``before``:
    the counters that moved, with their increments."""
    out = {}
    for name, c in _COUNTERS.items():
        old = before.get(name, (0,) * len(c))
        moved = tuple(n - o for n, o in zip(c, old))
        if any(moved):
            out[name] = moved
    return out


def reset() -> None:
    """Set every counter's counts to 0, in place."""
    for c in _COUNTERS.values():
        c[:] = [0] * len(c)


def add(counts: dict, sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (as :func:`since` gives them)."""
    for name, moved in counts.items():
        c = _COUNTERS[name]
        for i, n in enumerate(moved):
            c[i] += sign * n
