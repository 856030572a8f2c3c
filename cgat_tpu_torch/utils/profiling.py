"""Profiling and throughput, counterpart of ``cgat_tpu/utils/profiling.py``.

``trace`` records a Chrome/TensorBoard trace of a scope with
``torch.profiler`` (the trainer wraps ``TrainerConfig.profile_epoch``'s
epoch in it), ``annotate`` names a span in it (``annotated``: around each
call of a function), ``device_ms`` profiles a function's runs and sums
the card's time by kernel name (what ``chip_smoke.py``,
``utils/roofline.py`` and ``tools/step_trace.py`` read device time
from), ``trace_kernels`` sums a written trace's device kernels the same
way, and ``ThroughputMeter`` is the step-throughput meter the trainer
logs each epoch.

The port's spans, each ``cgat.<name>`` in a trace, one a step, request,
batch or copy (never one a crystal, field or kernel); a leaf inside an
entry on the same thread belongs to that step or request:

* entries: ``train_step`` (``Trainer.train_step``), ``gp_step``
  (``GPFit.step``), ``predict`` (``ServingModel.predict``);
* leaves: ``prefetch_wait`` (``PrefetchLoader``'s consumer blocked on its
  queue), ``collate`` (``data.batching.collate``), ``h2d``
  (``CrystalBatch.to`` and ``.copy_`` from the host to a card),
  ``replay`` (a CUDA graph's ``replay()`` in
  ``training.dispatch.StepGraphs``), ``capture`` (a new key's eager
  first step or forward and its capture), ``readback`` (a served
  chunk's answers read to the host, waiting for its replay).

The profiler records a span only on a thread it traces: on the thread
that started it, not on ``PrefetchLoader``'s, whose collates it does not
see. Where no profiler traces the calling thread, ``annotate`` checks
that once and returns a shared empty context (tracing off). A span that
a profiler records is also kept, with its thread and its ends on the Unix
clock, in a bounded record that ``recorded_spans`` returns: for a reader
that has a profile's events without the program's spans. The profiler
stamps its host events on the same clock, relative to its start, so one
offset maps the record onto a profile's times.

The profiler can drop the first device records of a profile: the first 5
to 7 kernels of an eager forward (``python3 chip_variants.py
profiler_window`` counts such losses), up to 24 records in a long
process on the H100. So ``device_ms`` opens its
window with ``PRIMER_LAUNCHES`` empty kernels, whose records it leaves
out, and runs ``fn`` ``PROFILE_PAD_S`` inside the window at each end;
``trace`` pauses so too.
"""
from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import threading
import time
from collections import deque

import torch

PROFILE_PAD_S = 0.005          # host pause at each end of a profiled window
PRIMER_LAUNCHES = 64           # empty kernels that open a device_ms window
PRIMER_KERNEL = "spin_kernel"  # their name (``torch.cuda._sleep``)
SPAN_NAMESPACE = "cgat."       # what ``annotate`` puts before a span's name
_NO_SPAN = contextlib.nullcontext()
# whether a profiler records the calling thread (bound once: the off path
# of ``annotate`` is this one call)
_profiler_enabled = torch._C._autograd._profiler_enabled
RECORDED_SPANS = 1 << 16       # the record's bound: the newest spans kept
# (thread, name, start_ns, end_ns) of each span a profiler recorded
_RECORD: deque = deque(maxlen=RECORDED_SPANS)


def _profile(**kwargs):
    """``torch.profiler.profile`` of the CPU and, with a card, the card."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, **kwargs)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Record the scope (CPU ops and, with a card, its device kernels) as
    a Chrome/TensorBoard trace ``rank<r>.<ns>.pt.trace.json`` under
    ``log_dir``, ``r`` this process's rank in a ``torch.distributed``
    world (0 outside one); nothing when ``log_dir`` is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    with _profile(on_trace_ready=tensorboard_trace_handler(
            log_dir, worker_name=f"rank{_rank()}")):
        if cuda:
            time.sleep(PROFILE_PAD_S)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.synchronize()
                time.sleep(PROFILE_PAD_S)


def annotate(name: str):
    """The span ``cgat.<name>`` in the trace of an enclosing profiler
    (:func:`trace`, or any ``torch.profiler.profile``) that records this
    thread; where none does, a shared empty context, and no
    ``record_function`` is made (the off path: one check)."""
    if not _profiler_enabled():
        return _NO_SPAN
    return _Span(name)


class _Span:
    """An on span: the profiler's ``record_function`` range, inside the
    Unix-clock ends that it adds to the record when it closes."""
    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time_ns()
        self.rf = torch.profiler.record_function(SPAN_NAMESPACE + self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        _RECORD.append((threading.get_ident(), self.name, self.t0,
                        time.time_ns()))
        return False


def recorded_spans() -> list[tuple[int, str, int, int]]:
    """The newest spans that a profiler recorded (at most
    ``RECORDED_SPANS``), oldest closed first: (``threading.get_ident()``
    of the thread, name without the namespace, start ns, end ns), on the
    Unix clock, each enclosing its event in the profile."""
    return list(_RECORD)


def annotated(name: str):
    """Decorator: each call of the function inside ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def trace_files(log_dir: str) -> list[str]:
    """The traces :func:`trace` wrote under ``log_dir``, sorted."""
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")))


def trace_kernels(path: str) -> dict[str, list[float]]:
    """Device time (ms) and count of each kernel name in a written trace,
    and of each ``annotate`` span under ``span:<name>``, without its
    namespace (its host time)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict[str, list[float]] = {}
    for e in events:
        cat = e.get("cat")
        if cat == "kernel":
            name = e["name"]
        elif cat == "user_annotation":
            name = f"span:{e['name'].removeprefix(SPAN_NAMESPACE)}"
        else:
            continue
        ms, count = out.get(name, (0.0, 0))
        out[name] = [ms + e.get("dur", 0) / 1e3, count + 1]
    return out


def device_ms(fn, n_runs: int, by_launch: bool = False,
              pad_s: float = PROFILE_PAD_S, primer: int = PRIMER_LAUNCHES,
              export: str | None = None) -> dict[str, list[float]]:
    """Device time and event count per run of ``fn`` by kernel name, from
    torch.profiler's device events over ``n_runs`` runs (empty if it
    recorded none); raises without a card. ``by_launch`` gives each launch
    of a kernel that runs c > 1 times a run a row of its own, "[j/c] name"
    for its j-th launch in the run's time order. The runs start and end
    ``pad_s`` inside the profiler's window, after ``primer`` empty
    kernels (the module's docstring). ``export`` names a file to write
    the profile's Chrome trace to."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA card")
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with _profile() as prof:
        for _ in range(primer):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        for _ in range(n_runs):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    if export:
        prof.export_chrome_trace(export)
    # the device's kernels, copies and memsets; not the primer's, nor the
    # device-side spans of ``annotate``
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and not e.is_user_annotation
                     and PRIMER_KERNEL not in e.name),
                    key=lambda e: e.time_range.start)
    names = [e.name.replace("(anonymous namespace)::", "") for e in events]
    per_run = {n: max(1, round(names.count(n) / n_runs)) for n in set(names)}
    seen: dict[str, int] = {}
    per_name: dict[str, list[float]] = {}
    for name, e in zip(names, events):
        if by_launch and per_run[name] > 1:
            j = seen.get(name, 0)
            seen[name] = j + 1
            name = f"[{j % per_run[name] + 1}/{per_run[name]}] {name}"
        ms, count = per_name.get(name, (0.0, 0.0))
        per_name[name] = [ms + e.time_range.elapsed_us() / 1e3 / n_runs,
                          count + 1.0 / n_runs]
    return per_name


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
