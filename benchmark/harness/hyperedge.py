"""The work of the hypernetwork-edge model (``no_hyper`` False) and what
its per-layer metrics read from a traced window.

The live edge update of layers 0 .. n_graph - 2 adds, on each edge row,
two multi-head networks (on PyTorch's einsum path, not the port's #3 and
#4) and an edge hypernetwork of four ``hyper_linear`` (#5 forward, #6 and
#7 backward, each on the edge slots), and, in the backward, the segment
sums (#8) of its two node gathers; it takes the place of the edge MLP.
The work functions are :mod:`yardsticks`'s (frozen), at each launch's own
rows.

A replayed step's #5 to #7 launches on edge rows are told from those on
node rows by their order: the program's launch record
(``ops.kernels.build``, kept by ``StepGraphs`` for each captured graph)
gives each captured launch's kernel, rows and whether the live edge
update's scope enclosed it, and the driver puts it in
``View.extra["launches"]`` by the graph's node slots. A program without
the record leaves nothing there, and the readers that need it read
nothing."""
from __future__ import annotations

from . import trace as tr
from .yardsticks import (CALLS, PEAKS, _mlp, bound, categorize, hyper_work,
                         kernel_calls, mh_network_work, model_flops,
                         segment_sum_work)

EDGE_SCOPE = "edge_update"
# the launch record's C entries of #5 to #7, and their work functions
HYPER_ENTRIES = {"cgat_hyper_apply_fwd": "hyper_apply",
                 "cgat_hyper_apply_bwd_dhdx": "hyper_apply_bwd_dhdx",
                 "cgat_hyper_apply_bwd_dk": "hyper_apply_bwd_dk"}
HYPER_CATEGORIES = {"#5 hyper_apply": "hyper_apply",
                    "#6 hyper_apply_bwd_dhdx": "hyper_apply_bwd_dhdx",
                    "#7 hyper_apply_bwd_dk": "hyper_apply_bwd_dk"}


def live_layers(model: dict) -> int:
    """The edge layers whose live update runs (the last one's is never
    read, so the program skips it)."""
    if model.get("no_hyper", True) or not model.get("update_edges", True):
        return 0
    return model["n_graph"] - 1


def edge_flops(model: dict, rows: float) -> float:
    """The matrix FLOPs of one live edge update on ``rows`` edge rows: the
    MH_A and MH_M networks on [x_src, e, x_dst] (#3's operations, though
    they run on the einsum path), and four ``hyper_linear`` of width
    ``nbr`` (each its FCBlock's four Tanh layers, the last Linear to the
    predicted weights, the predicted product)."""
    c, heads = model["elem_fea_len"], model["msg_heads"]
    nbr = model["nbr_embedding_size"]
    cat = 2 * c + nbr
    hid = int(cat / 1.5)
    mh = mh_network_work(rows, cat, heads, hid, nbr)[1]
    predicted = nbr * nbr + nbr
    hyper_linear = _mlp(rows, [nbr] * 5) + 2.0 * rows * nbr * predicted \
        + 2.0 * rows * nbr * nbr
    return 2 * mh + 4 * hyper_linear


def hyperedge_flops(model: dict, shapes: dict, head: bool = True) -> float:
    """:func:`yardsticks.model_flops` of the hypernetwork-edge model: the
    live edge updates on the real edges ``Er`` in place of the edge MLP of
    every layer."""
    flops = model_flops(model, shapes, head=head)
    layers = live_layers(model)
    if not layers:
        return flops
    nbr = model["nbr_embedding_size"]
    flops -= model["n_graph"] * _mlp(shapes["Er"], [nbr, nbr, nbr])
    return flops + layers * edge_flops(model, shapes["Er"])


def hyperedge_calls(model: dict, shapes: dict, training: bool) -> dict:
    """:func:`yardsticks.kernel_calls` with the live edge updates' port
    kernels added, each at its own rows: #5 four times a live layer on the
    ``E`` edge slots and, in ``training``, #6 and #7 as often and two #8
    (the backward of the update's two node gathers, E rows into N)."""
    calls = kernel_calls(model, shapes, training)
    layers = live_layers(model)
    if not layers:
        return calls
    nbr, c = model["nbr_embedding_size"], model["elem_fea_len"]
    E, N = shapes["E"], shapes["N"]
    edge = hyper_work(E, nbr, nbr, nbr)
    calls["hyper_apply"] = calls["hyper_apply"] + [edge["hyper_apply"]] \
        * 4 * layers
    if training:
        for k in ("hyper_apply_bwd_dhdx", "hyper_apply_bwd_dk"):
            calls[k] = calls[k] + [edge[k]] * 4 * layers
        calls["segment_sum"] = calls["segment_sum"] \
            + [segment_sum_work(E, c, N)] * 2 * layers
    return calls


def kernels_bound_and_time(view: tr.View) -> tuple:
    """(bound ms, device ms) summed over the port's kernels in the window:
    each kernel's bound the sum of its calls' bounds over the window's
    steps (:func:`hyperedge_calls` at each step's shapes), scaled by the
    calls the trace counts over the calls listed (1 where they agree)."""
    per_kernel_s: dict = {}
    for n, s, e in view.device:
        cat = categorize(n)
        if cat in CALLS:
            per_kernel_s[cat] = per_kernel_s.get(cat, 0.0) + (e - s)
    if not per_kernel_s or not view.steps:
        return 0.0, 0.0
    listed: dict = {}
    for st in view.steps:
        for name, calls in hyperedge_calls(view.model, st,
                                           st.get("training", True)).items():
            ms = sum(bound(b, o, PEAKS[name])[0] for b, o in calls)
            tot, n = listed.get(name, (0.0, 0))
            listed[name] = (tot + ms, n + len(calls))
    bound_ms = device_ms = 0.0
    for cat, secs in per_kernel_s.items():
        work, pattern, per_call = CALLS[cat]
        if work not in listed or not listed[work][1]:
            continue
        tot, n = listed[work]
        bound_ms += tot * (view.count(cat, pattern) / per_call) / n
        device_ms += secs * 1e3
    return bound_ms, device_ms


def kernels_roofline_pct(view: tr.View):
    bound_ms, device_ms = kernels_bound_and_time(view)
    if not device_ms:
        return None
    return 100.0 * bound_ms / device_ms


def edge_update_launches(launches: list, edge_rows: int) -> int:
    """The #5 launches of a capture's launch record made in the live edge
    update's scope on ``edge_rows`` rows: 4 a live layer on the graph's
    edge slots."""
    return sum(1 for entry, rows, scope in launches
               if entry == "cgat_hyper_apply_fwd" and scope == EDGE_SCOPE
               and rows == edge_rows)


def hyper_calls(view: tr.View) -> list:
    """The window's #5 to #7 calls in time order: (category, ms), a call
    its first device kernel's and the rest of its kernels' (#6's
    reduction) added to it."""
    calls: list = []
    last: dict = {}
    for n, s, e in view.device:
        cat = categorize(n)
        if cat not in HYPER_CATEGORIES:
            continue
        if CALLS[cat][1] in n:
            last[cat] = len(calls)
            calls.append([cat, (e - s) * 1e3])
        elif cat in last:
            calls[last[cat]][1] += (e - s) * 1e3
    return calls


def edge_calls(view: tr.View):
    """(work function, rows, ms) of each #5 to #7 call of the window on
    edge rows, or None where the launch record is missing or does not
    match the trace. The window's calls are matched in order with the
    record's launches of each step's graph; a launch is on edge rows when
    the edge update's scope enclosed it, or (the backward, which runs
    outside it) when it runs on the rows the scoped launches of its graph
    ran on."""
    record = view.extra.get("launches")
    if not record or not view.steps:
        return None
    expected = []
    for st in view.steps:
        launches = record.get(st["N"])
        if launches is None:
            return None
        hyper = [(HYPER_ENTRIES[k], rows, scope) for k, rows, scope
                 in launches if k in HYPER_ENTRIES]
        edge_rows = {rows for _, rows, scope in hyper if scope == EDGE_SCOPE}
        expected += [(work, rows, scope == EDGE_SCOPE or rows in edge_rows)
                     for work, rows, scope in hyper]
    calls = hyper_calls(view)
    if len(calls) != len(expected) or any(
            HYPER_CATEGORIES[cat] != work
            for (cat, _), (work, _, _) in zip(calls, expected)):
        return None
    return [(work, rows, ms) for (_, ms), (work, rows, edge)
            in zip(calls, expected) if edge]


def edge_hyper_ms(view: tr.View):
    """Device ms a step in #5 to #7 calls on edge rows."""
    calls = edge_calls(view)
    if not calls:
        return None
    return sum(ms for _, _, ms in calls) / len(view.steps)


def edge_hyper_roofline_pct(view: tr.View):
    """The #5 to #7 calls on edge rows: their bounds, each at its own rows,
    over their device time (%)."""
    calls = edge_calls(view)
    if not calls:
        return None
    nbr = view.model["nbr_embedding_size"]
    bound_ms = sum(bound(*hyper_work(rows, nbr, nbr, nbr)[work],
                         PEAKS[work])[0] for work, rows, _ in calls)
    return 100.0 * bound_ms / sum(ms for _, _, ms in calls)
