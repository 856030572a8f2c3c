"""The hypernetwork-edge model (``no_hyper=False``) against the benchmark's
plain reference (``benchmark/reference/hyperedge.py``), and the live edge
update's tracing: its span, its counter and the kernels' launch record.

At tiny widths on the CPU in f32, on seeded random weights (the
benchmark's own draw, with the ReZero gates and the ``damping`` moved off
their initial values so that every branch carries a gradient): the
forward, the graph embeddings, the L1 loss, every leaf's gradient and one
AdamW step. ``n_graph`` 2 and 3 hit HNet0, HNet with its ``damping``, and
the skipped last edge layer (no gradient). Tolerances: the two sides
differ in summation order only, so values agree to rtol 1e-5 and
gradients to 1e-4 of each leaf's largest entry (:func:`_close_grads`).
The replay half of the counter and the launch record of a capture are in
``test_torch_gpu.py``; here, the counters' registry as ``StepGraphs``
moves a capture's counts.
This file imports no JAX."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import traffic, weights  # noqa: E402
from reference import hyperedge as ref  # noqa: E402
from reference import optim as ref_optim  # noqa: E402

from cgat_tpu_torch.data.batching import CrystalGraph, collate  # noqa: E402
from cgat_tpu_torch.models import cgat  # noqa: E402
from cgat_tpu_torch.models.cgat import CGATConfig, CGAtNet  # noqa: E402
from cgat_tpu_torch.ops.kernels import build  # noqa: E402
from cgat_tpu_torch.training.optim import AdamW, project_params  # noqa: E402
from cgat_tpu_torch.utils import counters, profiling  # noqa: E402

TINY = {"orig_elem_fea_len": 24, "elem_fea_len": 16, "n_graph": 2,
        "nbr_embedding_size": 16, "neighbor_number": 12,
        "mean_pooling": False, "rezero": True, "msg_heads": 2,
        "update_edges": True, "vector_attention": True,
        "global_vector_attention": True, "n_graph_roost": 1,
        "no_hyper": False, "dropout": 0.0, "out_hidden": [32, 16],
        "compute_dtype": "float32"}
SEED = 2 ** 31 + 77
LR, WD = 1e-3, 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test: the ops are tiny, and beside the other
    test processes a pool of threads only contends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n_graph: int) -> dict:
    return {**TINY, "n_graph": n_graph}


def _port(cfg: dict) -> CGAtNet:
    return CGAtNet(CGATConfig(**{**cfg, "out_hidden": tuple(
        cfg["out_hidden"])}))


def _case(n_graph: int):
    """The model's config, seeded weights (the benchmark's draw, gates
    moved), the port's batch of 5 crystals and the reference's."""
    cfg = _cfg(n_graph)
    P = weights.make_weights(ref.param_shapes(cfg), SEED, "cpu")
    g = torch.Generator().manual_seed(3)
    for k, v in P.items():
        if k.endswith(".alpha") or k.endswith(".damping"):
            v.copy_(torch.rand(v.shape, generator=g) * 0.6 + 0.2)
    crystals = traffic.make_crystals(SEED, 12, atoms=(3, 7),
                                     max_nbr=cfg["neighbor_number"],
                                     orig_fea=cfg["orig_elem_fea_len"])
    idx = np.array([1, 4, 5, 8, 10])
    graphs = traffic.to_graphs(crystals, CrystalGraph)
    batch = collate([graphs[i] for i in idx], num_graphs=len(idx),
                    max_nbr=cfg["neighbor_number"], node_bucket=8)
    return cfg, P, batch, ref.make_batch(crystals, idx, "cpu")


def _loss(out, target, mean=0.1, std=1.3):
    return (out[:, 0] - (target - mean) / std).abs().mean()


def _close_grads(got: dict, want: dict):
    """Each leaf to 1e-4 of its largest entry. A leaf whose reference
    gradient stays under 1e-5 of the median leaf's largest entry
    is zero but for rounding (a bias that shifts every logit of a softmax
    alike: the node layers' and the pool's ``MH_A`` output biases, Roost's
    gates'): the port's has to stay under that too."""
    tops = {k: float(w.abs().max()) for k, w in want.items()}
    tiny = 1e-5 * float(np.median(list(tops.values())))
    for k, w in want.items():
        if tops[k] < tiny:
            assert float(got[k].abs().max()) < tiny, k
            continue
        torch.testing.assert_close(got[k], w, rtol=0, atol=1e-4 * tops[k],
                                   msg=k)


def test_param_shapes_are_the_ports_state_dict():
    for n_graph in (2, 3, 5):
        cfg = _cfg(n_graph)
        sd = {k: tuple(v.shape) for k, v in _port(cfg).state_dict().items()}
        assert ref.param_shapes(cfg) == sd
    default = {**TINY, "no_hyper": True}
    sd = {k: tuple(v.shape) for k, v in _port(default).state_dict().items()}
    assert ref.param_shapes(default) == sd


@pytest.mark.parametrize("n_graph", [2, 3])
def test_port_matches_the_reference(n_graph):
    """Forward, embeddings, loss, every leaf's gradient (the last edge
    layer's none on both sides) and one AdamW step with the damping
    projection on the reference's gradients."""
    cfg, P, batch, b = _case(n_graph)
    model = _port(cfg)
    model.load_state_dict(P, strict=True)
    net = ref.CGAT(cfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in P.items()}

    emb = model(batch, return_graph_embedding=True)
    torch.testing.assert_close(emb, net.embed(P, b), rtol=1e-5, atol=1e-6)
    out = model(batch)
    want_out = net.forward(leaves, b)
    torch.testing.assert_close(out, want_out.detach(), rtol=1e-5,
                               atol=1e-6)
    loss = _loss(out, batch.target)
    want_loss = _loss(want_out, b.target)
    torch.testing.assert_close(loss, want_loss.detach(), rtol=1e-5, atol=0)

    loss.backward()
    got = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
           for k, p in model.named_parameters()}
    want = ref_optim.grads_of(want_loss, leaves)
    last = f"graphs.{n_graph - 1}.Edge."
    skipped = [k for k in P if k.startswith(last)]
    assert skipped and not any(k in want for k in skipped)
    assert all(float(got[k].abs().max()) == 0.0 for k in skipped)
    want = {k: want.get(k, torch.zeros_like(v)) for k, v in P.items()}
    _close_grads(got, want)
    hnet = [k for k in want if ".Edge.Pooling_NN." in k
            and not k.startswith(last)]
    assert all(float(want[k].abs().max()) > 0 for k in hnet)
    if n_graph == 3:
        assert "graphs.1.Edge.Pooling_NN.damping" in hnet

    # one AdamW step on the same gradients (Adam's update of a zero-but-
    # for-rounding gradient is +-lr either way)
    for k, p in model.named_parameters():
        p.grad = want[k].clone()
    opt = AdamW(list(model.parameters()), LR, weight_decay=WD)
    opt.step()
    project_params(model)
    ref_opt = ref_optim.AdamW(leaves, LR, weight_decay=WD)
    ref_opt.step(want)
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), leaves[k].detach(), rtol=0,
                                   atol=1e-6, msg=k)


def _edge_spans(fn):
    """``fn()`` and the ``edge_update`` spans it added to the port's
    record."""
    before = len(profiling.recorded_spans())
    fn()
    new = profiling.recorded_spans()[before:] \
        if len(profiling.recorded_spans()) > before else []
    return [s for s in new if s[1] == "edge_update"]


def test_counter_and_span_of_an_eager_forward():
    """An eager forward counts n_graph - 1 live edge layers on the batch's
    edge slots; no span is recorded with tracing off, one a live layer
    under a profiler; the default model counts none."""
    cfg, P, batch, _ = _case(3)
    model = _port(cfg)
    model.load_state_dict(P, strict=True)
    E = batch.num_edge_slots
    before = cgat.edge_update_stats()
    with torch.no_grad():
        assert _edge_spans(lambda: model(batch)) == []
    after = cgat.edge_update_stats()
    assert after["layers"] - before["layers"] == 2
    assert after["rows"] - before["rows"] == 2 * E

    from torch.profiler import ProfilerActivity, profile
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        spans = _edge_spans(lambda: model(batch))
    assert len(spans) == 2 and all(s[2] <= s[3] for s in spans)

    default = _port({**cfg, "no_hyper": True})
    before = cgat.edge_update_stats()
    with torch.no_grad():
        default(batch)
    assert cgat.edge_update_stats() == before


def test_launch_record_keeps_entries_rows_and_scope(monkeypatch):
    """While a record is open each launch adds (entry, rows, innermost
    launch scope); with none open ``launch_scope`` is the shared empty
    context and nothing is kept."""
    monkeypatch.setattr(build, "stream", lambda device: 0)
    calls = []

    def cgat_fake_kernel(*args):
        calls.append(args)
        return 0

    dev = torch.device("cpu")
    assert build.launch_scope("edge_update") is build._NO_SCOPE
    build.run(cgat_fake_kernel, dev, 1, rows=7)
    kept = []
    with build.recording(kept):
        build.run(cgat_fake_kernel, dev, 2, rows=5)
        with build.launch_scope("edge_update"):
            build.run(cgat_fake_kernel, dev, 3, rows=9)
        build.run(cgat_fake_kernel, dev, 4)
    build.run(cgat_fake_kernel, dev, 5, rows=3)
    assert kept == [("cgat_fake_kernel", 5, None),
                    ("cgat_fake_kernel", 9, "edge_update"),
                    ("cgat_fake_kernel", None, None)]
    assert [c[0] for c in calls] == [1, 2, 3, 4, 5]
    assert build._record is None and build._scopes == []
    assert not build.recording_launches()
    build.record_launches(True)
    try:
        assert build.recording_launches()
    finally:
        build.record_launches(False)


def test_counters_move_a_captures_count_to_its_replays():
    """What ``StepGraphs`` does with ``utils.counters``: a capture's counts
    (``since`` its snapshot) taken back, then added once a replay; the
    model's ``edge_update`` counter is one of the registry's, a capture
    that counted nothing gives nothing to add, and ``reset`` sets every
    count to 0 in the lists their owners hold."""
    assert "edge_update" in counters.snapshot()
    mine = counters.counter("test_replayed", 2)
    assert counters.counter("test_replayed", 2) is mine
    start = tuple(mine)
    before = counters.snapshot()
    assert counters.since(before) == {}
    mine[0] += 1
    mine[1] += 40
    counted = counters.since(before)
    assert counted == {"test_replayed": (1, 40)}
    counters.add(counted, -1)
    assert counters.snapshot() == before
    for _ in range(3):
        counters.add(counted)
    assert tuple(mine) == (start[0] + 3, start[1] + 120)
    assert cgat.edge_update_stats() == dict(zip(
        ("layers", "rows"), counters.snapshot()["edge_update"]))
    counters.reset()
    assert mine == [0, 0] and counters.counter("test_replayed", 2) is mine
    assert not any(any(c) for c in counters.snapshot().values())
    assert cgat.edge_update_stats() == {"layers": 0, "rows": 0}
