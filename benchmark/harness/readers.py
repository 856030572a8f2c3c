"""What the per-layer metrics read from a traced window (``trace.View``).
Each metric's file under ``benchmark/metrics/`` calls one of these; each
returns None where the window holds nothing to read."""
from __future__ import annotations

from . import trace as tr
from . import yardsticks


def span_ms(view: tr.View, name: str):
    """The mean ms of the benchmark's spans ``name`` in the window."""
    spans = [(s, e) for s, e in view.spans_named(name)
             if s >= view.window[0] and e <= view.window[1]]
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) * 1e3


def host_ms(view: tr.View, name: str):
    """The mean ms of a span ``name`` in which the card ran nothing: the
    span's wall time less the device's busy time inside it."""
    spans = view.spans_named(name)
    if not spans or not view.device:
        return None
    return sum((e - s) - view.busy_s(s, e) for s, e in spans) \
        / len(spans) * 1e3


def category_ms_per_step(view: tr.View, category: str):
    """Device ms a step in one of ``yardsticks.categorize``'s categories."""
    secs = view.category_s().get(category)
    if not secs or not view.steps:
        return None
    return secs * 1e3 / len(view.steps)


def idle_pct(view: tr.View):
    """The share (%) of the window in which the device ran nothing."""
    if not view.device:
        return None
    return 100.0 * (1.0 - view.busy_s() / view.window_s)


def mfu_pct(view: tr.View):
    """The model's matrix FLOPs over the window's seconds, as a share (%)
    of the card's bf16 tensor-core peak."""
    flops = view.extra.get("flops")
    if not flops:
        return None
    return 100.0 * flops / (view.window_s * yardsticks.BF16_TENSOR_FLOPS)


def kernels_roofline_pct(view: tr.View):
    """The port's kernels' summed bounds over their summed device time
    (%)."""
    bound_ms, device_ms = tr.kernels_bound_and_time(view, training=False)
    if not device_ms:
        return None
    return 100.0 * bound_ms / device_ms
