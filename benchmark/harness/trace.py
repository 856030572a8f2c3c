"""The traced window and what is read from it.

A traced run records the window with ``torch.profiler`` (the CPU and the
card). The window opens with 64 empty kernels, whose records are left
out, and a 5 ms pause, and closes with a pause: the profiler can drop the
first device records of a profile (the arithmetic of the port's
``utils/profiling.py`` ``device_ms``, copied). The benchmark's own spans
(``span(name)``: the loader, the collate, the step, the request) are
``record_function`` ranges in it. :class:`View` holds the device's events
and the spans on one clock, in seconds, with what the driver recorded of
each step, and is what the per-layer metrics read."""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from . import yardsticks

PAD_S = 0.005
PRIMER_LAUNCHES = 64
PRIMER_KERNEL = "spin_kernel"
SPAN_PREFIX = "bench."
WINDOW = "window"


def span(name: str, on: bool):
    """A benchmark span ``name`` in the trace (nothing when ``on`` is
    false)."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclasses.dataclass
class View:
    """The traced window: ``device`` (name, start, end) of every kernel,
    copy and memset; ``spans`` (name, start, end) of the benchmark's
    spans; ``window`` (start, end); all in seconds on the profiler's
    clock. ``steps``: the driver's record of each step or request of the
    window (its batch shapes, its kind); ``model``: the model's widths."""
    device: list
    spans: list
    window: tuple
    steps: list
    model: dict
    extra: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.device = sorted(self.device, key=lambda ev: (ev[1], ev[2]))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self, lo=None, hi=None) -> float:
        """Seconds in [lo, hi] (the window by default) in which some device
        event ran: the union of their intervals."""
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        busy, end = 0.0, lo
        for _, s, e in self.device:
            s, e = max(s, end), min(e, hi)
            if e > s:
                busy += e - s
                end = e
        return busy

    def gaps(self) -> list:
        """(start, end) of every idle stretch of the window."""
        out, end = [], self.window[0]
        for _, s, e in self.device:
            if s > end:
                out.append((end, min(s, self.window[1])))
            end = max(end, e)
        if self.window[1] > end:
            out.append((end, self.window[1]))
        return [(s, e) for s, e in out if e > s]

    def spans_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.spans if n == name]

    def label(self, t: float) -> str:
        """The innermost benchmark span open at ``t`` ("none" if none)."""
        best = None
        for n, s, e in self.spans:
            if n != WINDOW and s <= t <= e and (best is None
                                                 or s >= best[1]):
                best = (n, s)
        return best[0] if best else "none"

    def category_s(self) -> dict:
        """Device seconds by ``yardsticks.categorize``'s category."""
        out: dict = {}
        for n, s, e in self.device:
            c = yardsticks.categorize(n)
            out[c] = out.get(c, 0.0) + (e - s)
        return out

    def count(self, category: str, pattern: str) -> int:
        """Device events of ``category`` whose name holds ``pattern``."""
        return sum(1 for n, _, _ in self.device
                   if pattern in n and yardsticks.categorize(n) == category)


@contextlib.contextmanager
def profiled(on: bool, holder: dict):
    """Profile the scope when ``on``; ``holder["prof"]`` gets the
    profiler."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_LAUNCHES):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        yield
        torch.cuda.synchronize()
        time.sleep(PAD_S)
    holder["prof"] = prof


def view_of(prof, steps: list, model: dict) -> View:
    """The :class:`View` of a profile whose window is the span
    ``bench.window``."""
    from torch.autograd import DeviceType

    device, spans = [], []
    for e in prof.events():
        s, t = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if e.is_user_annotation or PRIMER_KERNEL in e.name:
                continue
            device.append((e.name, s, t))
        elif e.is_user_annotation and e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], s, t))
    window = [(s, t) for n, s, t in spans if n == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    lo, hi = window[0]
    device = [ev for ev in device if ev[2] > lo and ev[1] < hi]
    return View(device, spans, (lo, hi), steps, model)


def breakdown(view: View, top: int = 10) -> dict:
    """The device operations that took most time (by category) and the
    longest idle gaps by the span open on the host, seconds each."""
    ops = sorted(view.category_s().items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((view.label((s + e) / 2), e - s) for s, e in view.gaps()),
                  key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


def kernels_bound_and_time(view: View, training: bool) -> tuple:
    """(bound ms, device ms) summed over the port's kernels in the window:
    each kernel's calls counted from the trace, each call's bound from the
    work functions at the shapes of the steps the window ran (the mean
    call of the window). A kernel absent from the trace adds nothing."""
    per_kernel_s: dict = {}
    for n, s, e in view.device:
        c = yardsticks.categorize(n)
        if c in yardsticks.CALLS:
            per_kernel_s[c] = per_kernel_s.get(c, 0.0) + (e - s)
    if not per_kernel_s or not view.steps:
        return 0.0, 0.0
    # the mean bound of each kernel's call over the window's steps
    mean_call: dict = {}
    for st in view.steps:
        for name, calls in yardsticks.kernel_calls(
                view.model, st, st.get("training", training)).items():
            b = yardsticks.kernel_bound_ms(name, calls, 1.0)
            tot, n = mean_call.get(name, (0.0, 0))
            mean_call[name] = (tot + b, n + 1)
    bound_ms = device_ms = 0.0
    for cat, secs in per_kernel_s.items():
        work, pattern, per_call = yardsticks.CALLS[cat]
        if work not in mean_call:
            continue
        calls = view.count(cat, pattern) / per_call
        tot, n = mean_call[work]
        bound_ms += calls * tot / n
        device_ms += secs * 1e3
    return bound_ms, device_ms
