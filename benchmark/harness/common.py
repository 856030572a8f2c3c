"""What the drivers share: the device's clock edges, the memory peak, the
window loop, the reference's settings, the planning of the window's batch
shapes, and the set-up of a training cell (its checked steps, its
warm-up and its replayed steps)."""
from __future__ import annotations

import gc
import math
import time

import torch


def model_config(config_cls, model: dict):
    """The program's model config (``config_cls``, its ``CGATConfig``) of
    a configuration file's widths."""
    return config_cls(**{**model, "out_hidden": tuple(model["out_hidden"])})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def graphs_held(graphs) -> int:
    """The CUDA graphs a ``StepGraphs`` or ``ServingGraphs`` holds (0 off
    the card, where it is None)."""
    return len(graphs.graphs) if graphs is not None else 0


def memory_peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def release(device) -> None:
    """Free what the program left once its objects are dropped."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference_mode() -> None:
    """f32 products with TF32 off, for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def planned_steps(cell) -> int:
    """A generous bound on the steps (or requests) a window can take: the
    traced window's count, or the window's seconds at the mix's
    ``max_rate`` a second."""
    if cell.trace:
        return int(cell.traffic["trace_steps"])
    return int(math.ceil(cell.seconds * cell.traffic["max_rate"])) + 8


class Window:
    """The measured window: ``step()`` after each step or request says
    whether it is over (the traced window's count, or the seconds);
    ``close()`` synchronises the device and ends it."""

    def __init__(self, cell):
        self.cell = cell
        self.n = 0
        self.t_start = time.perf_counter()
        self.t_end = None

    def step(self) -> bool:
        self.n += 1
        if self.cell.trace:
            return self.n >= int(self.cell.traffic["trace_steps"])
        return time.perf_counter() - self.t_start >= self.cell.seconds

    def close(self) -> float:
        sync(self.cell.device)
        self.t_end = time.perf_counter()
        return self.t_end - self.t_start


class Phases:
    """Logs each set-up phase's seconds on stderr (where set-up goes)."""

    def __init__(self, cell):
        self.cell = cell
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.cell.log(f"set-up: {name} {now - self.t:.2f} s")
        self.t = now


def change_norms(now: dict, before: dict) -> dict:
    return {k: float((now[k].detach().double() - before[k].double()).norm())
            for k in now}


def snapshot(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def set_up_sequence(plan, k: int, planned: int) -> tuple[list, int]:
    """The plan's steps that a training cell's set-up takes, in order, and
    the position where its replayed steps start: ``k`` checked steps
    through the window's feed; then the warm-up, one step of each batch
    shape that is new within the ``planned`` steps after them, collated
    apart; then the feed's next ``k`` steps, which replay (their shapes
    are warm). The reference follows the whole sequence."""
    seq = list(range(k))
    seen = {plan.shapes(s)["N"] for s in seq}
    for s in range(k, k + planned):
        n = plan.shapes(s)["N"]
        if n not in seen:
            seen.add(n)
            seq.append(s)
    return seq + list(range(k, 2 * k)), len(seq)


def drive_set_up(plan, k: int, planned: int, *, feed, warm_batch, step,
                 params, first_grad, graphs) -> dict:
    """Drives a training cell's one trainer (or GP fit) through
    :func:`set_up_sequence`: ``feed()`` gives the window's next (plan
    step, batch), ``warm_batch(s)`` collates plan step ``s`` apart,
    ``step(batch)`` runs the window's call and returns its loss (a device
    scalar), ``params()`` the trained leaves by name, ``first_grad()`` each
    leaf's first gradient norm from the optimizer's state after one step,
    ``graphs()`` the CUDA graphs held. Returns the sequence, each step's
    loss, the first gradient, each leaf's change over the replayed steps
    and how many of them replayed."""
    seq, start = set_up_sequence(plan, k, planned)
    losses, replayed, before, grad = [], 0, None, None
    for j, s in enumerate(seq):
        if j == start:
            before = snapshot(params())
        if j < k or j >= start:
            got, batch = feed()
            if got != s:
                raise RuntimeError(f"the feed gave step {got}, not {s}")
        else:
            batch = warm_batch(s)
        held = graphs()
        losses.append(step(batch))
        replayed += j >= start and bool(held) and graphs() == held
        if j == 0:
            grad = first_grad()
    return {"seq": seq, "start": start,
            "losses": [float(x) for x in losses], "grad": grad,
            "change": change_norms(params(), before), "replayed": replayed}


def run_window(cell, take, step, wait_span: str, record) -> tuple:
    """The measured window of a training cell: ``take()`` gives (plan
    step, batch) inside the span ``wait_span``, ``step(batch)`` runs inside
    the span ``step``; in a traced run ``record(s)`` is kept for each step.
    Returns the closed :class:`Window`, the profiler's holder and the
    records."""
    from . import trace as tr
    holder, steps = {}, []
    with tr.profiled(cell.trace, holder):
        win = Window(cell)
        with tr.span(tr.WINDOW, cell.trace):
            while True:
                with tr.span(wait_span, cell.trace):
                    s, batch = take()
                with tr.span("step", cell.trace):
                    step(batch)
                if cell.trace:
                    steps.append(record(s))
                if win.step():
                    break
            win.close()
    return win, holder, steps
