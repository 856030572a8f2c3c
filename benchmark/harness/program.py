"""What the per-layer metrics read from the program's own spans: the
step, GP step or request spans (entries) and, inside or between them, the
spans of the host's work that can hold the card (leaves:
``prefetch_wait``, ``collate``, ``h2d``, ``replay``, ``capture``,
``readback``; the program's ``utils/profiling.py`` names them).

A :class:`trace.View` keeps the benchmark's spans and the device's events
but not the program's. The program keeps the spans a profiler recorded
(``utils.profiling.recorded_spans``: thread, name, start and end on the
Unix clock, which the profiler's host events are stamped on too, less the
profile's start). So the offset from the record to the view's clock is
found from the benchmark's spans, in two rounds. First the benchmark's
spans that hold one entry each (``step``, ``predict``): the window's k of
them hold the record's last k entries, and the offsets that put each
entry inside its span form a range; where it is empty the record is not
this window's, and nothing is read. That range is as wide as the least
work that precedes an entry inside its span (the GP driver's copy, some
ms). Then every span of the record near the window has to lie inside one
of the benchmark's spans (the program runs only inside the benchmark's
calls): the offsets in the range that place each so leave a few
microseconds, the Python between the two stamps, and their middle is
taken.

Each reader returns None where the window holds no program span, as in a
program that keeps no record."""
from __future__ import annotations

from . import trace as tr

ENTRIES = ("train_step", "gp_step", "predict")
OUTER = ("step", "predict")     # the benchmark's spans around an entry
SLACK_NS = 50_000               # the entries' misfit accepted
CLOCK_NS = 2_000                # the two stamps' disagreement accepted
_CACHE = "program_spans"        # the aligned spans, kept in ``View.extra``


def _record() -> list:
    """The program's record of its spans, or [] where it keeps none."""
    try:
        from cgat_tpu_torch.utils import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded_spans", None)
    return list(recorded()) if recorded is not None else []


def align(view: tr.View, record: list) -> list:
    """The (name, start, end) in seconds on the view's clock of the
    record's spans on the thread of the window's entries, or [] where the
    record does not fit the window."""
    lo, hi = view.window
    outer = sorted((s, e) for n, s, e in view.spans
                   if n in OUTER and s >= lo and e <= hi)
    entries = sorted((r for r in record if r[1] in ENTRIES),
                     key=lambda r: r[2])[-len(outer):] if outer else []
    if not outer or len(entries) != len(outer):
        return []
    thread = entries[0][0]
    if any(r[0] != thread for r in entries):
        return []
    ns = lambda t: round(t * 1e9)  # noqa: E731
    # offset d (ns): each entry's [start + d, end + d] inside its span
    low = max(ns(s) - r[2] for (s, _), r in zip(outer, entries)) - CLOCK_NS
    high = min(ns(e) - r[3] for (_, e), r in zip(outer, entries)) + CLOCK_NS
    if low > high + SLACK_NS:
        return []
    mine = [r for r in record if r[0] == thread]
    d = _refine(mine, [(ns(s), ns(e)) for n, s, e in view.spans
                       if n != tr.WINDOW], (ns(lo), ns(hi)), low,
                max(low, high))
    return sorted(((n, (a + d) / 1e9, (b + d) / 1e9)
                   for _, n, a, b in mine),
                  key=lambda x: (x[1], -x[2]))


def _refine(record: list, bench: list, window: tuple, low: int,
            high: int) -> int:
    """The middle of the offsets in [low, high] that place each span of
    ``record`` that can fall in the window inside a span of ``bench``
    (each widened by ``CLOCK_NS``); the middle of [low, high] where no
    offset does."""
    allowed = [(low, high)]
    for _, _, a, b in record:
        if b + high < window[0] or a + low > window[1]:
            continue            # outside the window whatever the offset
        fits = [(s - CLOCK_NS - a, e + CLOCK_NS - b) for s, e in bench]
        allowed = [(max(x, y), min(z, w)) for x, z in allowed
                   for y, w in fits if max(x, y) <= min(z, w)]
        if not allowed:
            return (low + high) // 2
    x, z = max(allowed, key=lambda p: p[1] - p[0])
    return (x + z) // 2


def spans(view: tr.View) -> list:
    """The program's spans aligned to the view (:func:`align` on the
    program's record), read once a view."""
    if _CACHE not in view.extra:
        view.extra[_CACHE] = align(view, _record())
    return view.extra[_CACHE]


def _inside(view: tr.View) -> list:
    """The program spans that lie inside the window."""
    lo, hi = view.window
    return [(n, s, e) for n, s, e in spans(view) if s >= lo and e <= hi]


def ms_per_entry(view: tr.View, name: str):
    """The ms of the program's spans ``name`` in the window over the
    number of entry spans in it: ms a step or request."""
    inside = _inside(view)
    entries = sum(1 for n, _, _ in inside if n in ENTRIES)
    if not entries:
        return None
    return sum(e - s for n, s, e in inside if n == name) / entries * 1e3


def count(view: tr.View, name: str):
    """The number of the program's spans ``name`` in the window."""
    inside = _inside(view)
    if not inside:
        return None
    return sum(1 for n, _, _ in inside if n == name)


def _union(intervals: list) -> list:
    """The union of (start, end) intervals, as disjoint sorted ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_unattributed_pct(view: tr.View):
    """The share (%) of the window's idle time during which no leaf span
    of the program is open on the window's thread: the card waits on an
    entry span's own time, on the benchmark's spans alone, or on
    nothing. Exact intervals: each idle stretch less its overlap with the
    union of the leaf spans."""
    program = spans(view)
    if not program or not view.device:
        return None
    gaps = view.gaps()
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    leaves = _union([(s, e) for n, s, e in program if n not in ENTRIES])
    # both lists are sorted and disjoint: one sweep over the two
    covered, j = 0.0, 0
    for s, e in gaps:
        while j < len(leaves) and leaves[j][1] <= s:
            j += 1
        k = j
        while k < len(leaves) and leaves[k][0] < e:
            covered += min(e, leaves[k][1]) - max(s, leaves[k][0])
            k += 1
    return 100.0 * (idle - covered) / idle

