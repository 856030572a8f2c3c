"""The hypernetwork-edge cell's pieces on the CPU: its readers on a
synthetic traced window and launch record (edge-row calls told from
node-row ones by their order; shares of exactly 100 % when each call
takes exactly its bound; nothing where the record is missing or does not
fit), its FLOP count against the reference's products, its call list, and
both new cells' files loading."""
import json

import numpy as np
import pytest
import torch

from harness import cell as cells
from harness import hyperedge, traffic, yardsticks
from harness import trace as tr
from reference import hyperedge as ref
from reference.precision import Precision

FULL = json.loads((cells.BENCH / "configs" / "cgat-hyperedge.json")
                  .read_text())["model"]
STEP = {"N": 768, "E": 18432, "Nr": 752, "Er": 18048, "C": 64, "Rr": 378,
        "P": 2008, "n": 64, "training": True}
FWD, DHDX, DK = ("cgat_hyper_apply_fwd", "cgat_hyper_apply_bwd_dhdx",
                 "cgat_hyper_apply_bwd_dk")
NAMES = {FWD: "void (anonymous namespace)::fwd::kernel(CUtensorMap_st, int)",
         DHDX: "void (anonymous namespace)::dhdx::bwd_kernel(CUtensorMap_st)",
         DK: "void (anonymous namespace)::dk::kernel(CUtensorMap_st, int)"}
REDUCE = "void (anonymous namespace)::dhdx::reduce_kernel(float const*, int)"
WORK = {FWD: "hyper_apply", DHDX: "hyper_apply_bwd_dhdx",
        DK: "hyper_apply_bwd_dk"}


def _record(model, N, E):
    """A capture's launch record as the program keeps it: each layer's
    node MH networks, its four node #5, the live layers' four edge #5 in
    the edge update's scope; then the backward, last layer first, each
    HNet's #6 and #7 (the node ones and the live edge ones, outside any
    scope), with launches of other kernels between."""
    n, live = model["n_graph"], hyperedge.live_layers(model)
    rec = []
    for i in range(n):
        rec += [("cgat_mh_network_fwd", E, None)] * 2
        rec += [(FWD, N, None)] * 4
        if i < live:
            rec += [(FWD, E, "edge_update")] * 4
    for i in reversed(range(n)):
        if i < live:
            rec += [(DHDX, E, None), (DK, E, None)] * 4
        rec += [(DHDX, N, None), (DK, N, None)] * 4
        rec += [("cgat_mh_network_bwd", E, None)] * 2
    return rec


def _device(record, ms_of, t0=0.0):
    """Device events in the record's order: each #5 to #7 launch one
    kernel (#6 two: its units and its reduction) taking ``ms_of(entry,
    rows)`` ms, each other launch 1 us of another kernel."""
    out, t = [], t0
    for entry, rows, _ in record:
        if entry not in NAMES:
            out.append(("elementwise_kernel<x>", t, t + 1e-6))
            t += 2e-6
            continue
        ms = ms_of(entry, rows)
        if entry == DHDX:
            out += [(NAMES[entry], t, t + 0.9 * ms * 1e-3),
                    (REDUCE, t + 0.9 * ms * 1e-3, t + ms * 1e-3)]
        else:
            out.append((NAMES[entry], t, t + ms * 1e-3))
        t += ms * 1e-3 + 1e-6
    return out, t


def _bound(entry, rows, width=128):
    work = WORK[entry]
    return yardsticks.bound(*yardsticks.hyper_work(rows, width, width,
                                                   width)[work],
                            yardsticks.PEAKS[work])[0]


def _view(model, steps, ms_of, record=True):
    rec = _record(model, STEP["N"], STEP["E"])
    device, t = [], 0.0
    for _ in range(steps):
        ev, t = _device(rec, ms_of, t)
        device += ev
    view = tr.View(device, [("window", 0.0, t)], (0.0, t), [STEP] * steps,
                   model)
    if record:
        view.extra["launches"] = {STEP["N"]: rec}
    return view


def test_edge_calls_are_told_by_their_order():
    """Edge-row calls 1 ms, node-row calls 0.01 ms: the reader sums the
    edge ones only, 16 each of #5 to #7 a step at 5 layers."""
    view = _view(FULL, 3, lambda e, rows: 1.0 if rows == STEP["E"]
                 else 0.01)
    calls = hyperedge.edge_calls(view)
    assert len(calls) == 3 * 48
    assert sorted({(w, r) for w, r, _ in calls}) == sorted(
        (w, STEP["E"]) for w in WORK.values())
    assert hyperedge.edge_hyper_ms(view) == pytest.approx(48.0)


def test_shares_are_100_when_each_call_takes_its_bound():
    view = _view(FULL, 2, _bound)
    assert hyperedge.edge_hyper_roofline_pct(view) == pytest.approx(100.0)
    ms = sum(_bound(e, STEP["E"]) for e in WORK) * 4 * 4
    assert hyperedge.edge_hyper_ms(view) == pytest.approx(ms)
    half = _view(FULL, 2, lambda e, rows: 2 * _bound(e, rows))
    assert hyperedge.edge_hyper_roofline_pct(half) == pytest.approx(50.0)


def test_readers_read_nothing_without_a_fitting_record():
    assert hyperedge.edge_hyper_ms(_view(FULL, 2, _bound, record=False)) \
        is None
    short = _view(FULL, 2, _bound)
    rec = short.extra["launches"][STEP["N"]]
    rec.remove((FWD, STEP["E"], "edge_update"))
    assert hyperedge.edge_calls(short) is None
    other = _view(FULL, 2, _bound)
    other.extra["launches"] = {STEP["N"] + 64: other.extra["launches"][
        STEP["N"]]}
    assert hyperedge.edge_hyper_roofline_pct(other) is None
    empty = tr.View([], [("window", 0.0, 1.0)], (0.0, 1.0), [STEP], FULL)
    assert hyperedge.kernels_roofline_pct(empty) is None
    assert hyperedge.edge_hyper_ms(empty) is None


def test_kernels_roofline_is_100_when_each_call_takes_its_bound():
    """One event (two for #3) a call of the model's call list, each
    taking its bound at its own rows: the share is 100 %, with the edge
    rows' #5 to #8 in the list."""
    calls = hyperedge.hyperedge_calls(FULL, STEP, True)
    assert len(calls["hyper_apply"]) == 4 * 5 + 4 * 4
    assert len(calls["segment_sum"]) == 11 + 8
    device, t = [], 0.0
    for cat, (work, pattern, per_call) in yardsticks.CALLS.items():
        for b, o in calls.get(work, []):
            ms = yardsticks.bound(b, o, yardsticks.PEAKS[work])[0]
            for _ in range(per_call):
                device.append((pattern, t, t + ms / per_call * 1e-3))
                t += ms / per_call * 1e-3
    view = tr.View(device, [], (0.0, t), [STEP], FULL)
    assert hyperedge.kernels_roofline_pct(view) == pytest.approx(100.0)
    default = {**FULL, "no_hyper": True}
    assert hyperedge.hyperedge_calls(default, STEP, True) == \
        yardsticks.kernel_calls(default, STEP, True)


class _Tally(Precision):
    """f32 products that count 2 m n k each."""

    def __init__(self):
        super().__init__("float32")
        self.flops = 0.0

    def mm(self, a, b):
        self.flops += 2.0 * a[..., 0].numel() * a.shape[-1] * b.shape[-1]
        return super().mm(a, b)


@pytest.mark.parametrize("n_graph", [2, 3])
def test_flops_count_the_references_products(n_graph):
    """The hypernetwork-edge FLOP count equals the reference's products
    (edge width apart from the node width, crystals of 3 species as in
    the default count's test)."""
    cfg = {"orig_elem_fea_len": 200, "elem_fea_len": 16, "n_graph": n_graph,
           "nbr_embedding_size": 12, "neighbor_number": 24, "msg_heads": 2,
           "n_graph_roost": 1, "out_hidden": [32, 32, 16],
           "update_edges": True, "no_hyper": False}
    crystals = traffic.make_crystals(3, 64, atoms=(6, 9), n_species=3)
    idx = np.flatnonzero(np.diff(crystals.comp_ptr) == 3)[:5]
    P = {k: torch.randn(s) * 0.1 for k, s in ref.param_shapes(cfg).items()}
    tally = _Tally()
    with torch.no_grad():
        ref.CGAT(cfg, tally).forward(P, ref.make_batch(crystals, idx, "cpu"))
    sh = {**traffic.batch_shapes(crystals, idx, slots=len(idx),
                                 node_bucket=64), "P": len(idx) * 9}
    assert hyperedge.hyperedge_flops(cfg, sh) == pytest.approx(tally.flops,
                                                               rel=1e-12)


@pytest.mark.parametrize("cell", ["train-hyperedge.b64",
                                  "screen-default.r64"])
def test_new_cells_load(cell):
    c = cells.load(cell, seed=2 ** 33 + 1, seconds=20, trace=False,
                   device="cpu")
    assert c.workload["chips"] == 1 and set(c.limits)
    model = c.config["model"]
    assert model["elem_fea_len"] == 128 and model["n_graph"] == 5
    if cell.startswith("train"):
        assert model["no_hyper"] is False and c.config["reduced"] == []
        assert c.config["parameters"] == sum(
            int(np.prod(s)) for s in ref.param_shapes(model).values())
        driver = cells.module("drivers", c.workload["driver"])
        assert driver.CONTROLS == ("float8",)
        assert driver.FAULTS == ("half_batch", "still")
    else:
        assert (c.traffic["request"], c.traffic["chunk"]) == (64, 64)


def test_edge_update_launches_count_the_scoped_edge_row_launches():
    """A capture of the 5-layer model: 4 live layers, 4 #5 launches each
    in the edge update's scope on the edge slots."""
    rec = _record(FULL, STEP["N"], STEP["E"])
    assert hyperedge.edge_update_launches(rec, STEP["E"]) == 16
    assert hyperedge.edge_update_launches(rec, STEP["N"]) == 0
    rec.remove((FWD, STEP["E"], "edge_update"))
    assert hyperedge.edge_update_launches(rec, STEP["E"]) == 15


@pytest.fixture(scope="module")
def tiny_hyperedge(tmp_path_factory):
    """The benchmark at tiny widths (``test_bench_harness.tiny_bench``),
    the hypernetwork-edge configuration's model live."""
    from test_bench_harness import tiny_bench
    root, bench = tiny_bench(tmp_path_factory.mktemp("bench"))
    path = bench / "configs" / "cgat-hyperedge.json"
    c = json.loads(path.read_text())
    c["model"]["no_hyper"] = False
    path.write_text(json.dumps(c))
    return root, bench


def _run_tiny(root, bench):
    from test_bench_harness import run_tiny
    return run_tiny(root, bench, "train-hyperedge.b64")


def test_dry_run_of_the_hyperedge_cell(tiny_hyperedge):
    """Correct at tiny widths on the CPU, judged on ``loss_gap``,
    ``change_gap`` and ``emb_gap`` (``grad_gap`` is in the notes only);
    the counter matched the window's steps."""
    out = _run_tiny(*tiny_hyperedge)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"loss_gap", "change_gap", "emb_gap"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_a_fault_under_autograd_alone_moves_emb_gap(tiny_hyperedge,
                                                     monkeypatch):
    """Graph embeddings 10 % off only where autograd records (the training
    step's forward; a forward under ``no_grad`` takes other launches):
    ``emb_gap`` reads it, since it reads the first training step's
    embeddings."""
    from cgat_tpu_torch.models.cgat import CGAtNet
    embed = CGAtNet.embed

    def altered(self, batch, **k):
        out = embed(self, batch, **k)
        return out * 1.1 if torch.is_grad_enabled() else out

    monkeypatch.setattr(CGAtNet, "embed", altered)
    out = _run_tiny(*tiny_hyperedge)
    gap = out["checks"]["emb_gap"]
    assert not out["correct"] and gap["value"] > gap["limit"], out["checks"]
