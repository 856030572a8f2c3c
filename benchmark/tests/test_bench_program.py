"""The readers of the program's own spans on the CPU
(``benchmark/harness/program.py``): the program's record aligned to a
traced window by the benchmark's spans around each entry, the readers'
values on a hand-computed window, the readers of the other per-layer
metrics and the breakdown unchanged by a record, and a real profile whose
program spans the alignment puts back where the profiler saw them."""
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
DECLARED = json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]
UNIX_NS = 1_760_000_000_123_456_789   # the record's clock at the view's 0
MAIN, OTHER = 11, 12                  # two threads' idents


def _view():
    """A traced training window: two steps inside the benchmark's spans,
    device events leaving the idle stretches (0.2, 0.4) and (0.6, 0.9)."""
    from harness import trace as tr
    mh = "void sm90::gemm_kernel<(sm90::Epilogue)1>(CUtensorMap_st)"
    opt = "multi_tensor_apply_kernel<x>"
    dev = [(mh, 0.0, 0.2), (opt, 0.4, 0.6), (mh, 0.9, 1.0)]
    spans = [("window", 0.0, 1.0), ("loader", 0.02, 0.1),
             ("step", 0.1, 0.45), ("loader", 0.45, 0.55),
             ("step", 0.55, 0.95)]
    model = {"elem_fea_len": 128, "msg_heads": 5, "nbr_embedding_size": 128,
             "n_graph": 5, "orig_elem_fea_len": 200, "n_graph_roost": 3,
             "out_hidden": [1024, 1024, 512, 512, 256, 256, 128]}
    steps = [{"N": 768, "E": 18432, "Nr": 733, "Er": 733 * 24, "C": 64,
              "Rr": 200, "P": 600, "training": True}] * 2
    v = tr.View(dev, spans, (0.0, 1.0), steps, model)
    v.extra["flops"] = 989e12 * 0.25
    return v


# the program's spans on the view's clock (s): each step's entry 0.1 ms
# inside the benchmark's step at both ends; the idle stretch (0.2, 0.4) is
# half under a replay and half under the first step's own time, (0.6,
# 0.9) a third under a capture and the rest under the second step's own
# time; an earlier profile's step and capture, and a span of another
# thread, are left out
PROGRAM = [(MAIN, "train_step", -5.0, -4.9), (MAIN, "capture", -0.5, -0.4),
           (MAIN, "prefetch_wait", 0.03, 0.09),
           (MAIN, "train_step", 0.1001, 0.4499), (MAIN, "h2d", 0.1001, 0.15),
           (MAIN, "replay", 0.25, 0.35), (OTHER, "collate", 0.3, 0.5),
           (MAIN, "prefetch_wait", 0.45, 0.55),
           (MAIN, "train_step", 0.5501, 0.9499), (MAIN, "h2d", 0.5501, 0.6),
           (MAIN, "capture", 0.7, 0.8)]


def _record(program=PROGRAM, shift_ns=UNIX_NS):
    """``program`` as the program records it: (thread, name, start ns,
    end ns) on the Unix clock, in the order the spans close."""
    rec = [(t, n, round(s * 1e9) + shift_ns, round(e * 1e9) + shift_ns)
           for t, n, s, e in program]
    return sorted(rec, key=lambda r: r[3])


def _with_record(monkeypatch, record):
    from harness import program
    monkeypatch.setattr(program, "_record", lambda: list(record))


def _read(name, view):
    from harness import cell as cells
    return cells.metric(name).read(view)


@pytest.mark.parametrize("name", [m["name"] for m in DECLARED
                                  if m["source"] != "program_span"])
def test_a_record_leaves_the_other_readings_alone(monkeypatch, name):
    """Each per-layer metric that reads no program span, and the
    breakdown's device operations and gaps by the benchmark's spans, read
    the same with and without the program's record."""
    from harness import trace as tr
    _with_record(monkeypatch, [])
    bare = _view()
    want, want_b = _read(name, bare), tr.breakdown(bare)
    _with_record(monkeypatch, _record())
    traced = _view()
    assert _read(name, traced) == want
    assert tr.breakdown(traced) == want_b


def test_program_readers_on_a_synthetic_window(monkeypatch):
    _with_record(monkeypatch, _record())
    v = _view()
    read = lambda name: _read(name, v)  # noqa: E731
    assert read("prefetch_wait_ms.train") == pytest.approx(
        (0.06 + 0.10) / 2 * 1e3)
    assert read("h2d_ms.train") == pytest.approx(0.0499 * 2 / 2 * 1e3)
    assert read("collate_span_ms.gp") == 0.0
    assert read("readback_ms.screen") == 0.0
    assert read("captures.train") == 1
    # idle 0.2 + 0.3 s, of which the replay 0.1 and the capture 0.1 lie
    # under a leaf
    assert read("idle_unattributed.train") == pytest.approx(
        100 * (0.5 - 0.2) / 0.5)


@pytest.mark.parametrize("case", ["no record", "another thread's entry",
                                  "one entry short", "a later window",
                                  "an entry outside its step"])
def test_a_record_that_does_not_fit_the_window_is_not_read(monkeypatch,
                                                            case):
    """Where the record's last entries cannot sit inside the window's
    steps, or are not one thread's, every program reader reads nothing."""
    program = list(PROGRAM)
    if case == "no record":
        program = []
    elif case == "another thread's entry":
        program[8] = (OTHER,) + program[8][1:]
    elif case == "one entry short":
        program = [p for p in program if 0 < p[2] < 0.5]
    elif case == "a later window":
        program += [(MAIN, "train_step", 3.0, 3.2)]
    else:
        program[3] = (MAIN, "train_step", 0.1001, 0.5)
    _with_record(monkeypatch, _record(program))
    v = _view()
    for m in DECLARED:
        if m["source"] == "program_span":
            assert _read(m["name"], v) is None, m["name"]


def test_alignment_takes_the_middle_of_the_offsets_that_fit():
    """Entries 0.1 ms inside their steps at one end and 0.3 ms at the
    other put every span 0.1 ms late on the view's clock."""
    from harness import program
    v = _view()
    rec = _record([(MAIN, "train_step", 0.1001, 0.4497),
                   (MAIN, "h2d", 0.2, 0.3),
                   (MAIN, "train_step", 0.5501, 0.9497)])
    got = program.align(v, rec)
    assert [n for n, _, _ in got] == ["train_step", "h2d", "train_step"]
    assert [(s, e) for _, s, e in got] == pytest.approx(
        [(0.1002, 0.4498), (0.2001, 0.3001), (0.5502, 0.9498)], abs=1e-9)


def test_the_spans_before_an_entry_narrow_the_offsets():
    """A GP step: the benchmark's step holds a 30 ms copy, then the
    entry. The entries alone leave 30 ms of offsets; the copy inside the
    same step and the collate inside the benchmark's own span leave 0.2
    ms, and their middle is the true offset."""
    from harness import program
    from harness import trace as tr
    spans = [("window", 0.0, 1.0), ("collate", 0.01, 0.1),
             ("step", 0.1, 0.45), ("collate", 0.46, 0.55),
             ("step", 0.55, 0.95)]
    v = tr.View([], spans, (0.0, 1.0), [], {})
    rec = _record([(MAIN, "collate", 0.05, 0.0999), (MAIN, "h2d", 0.1001, 0.13),
                   (MAIN, "gp_step", 0.1301, 0.4499),
                   (MAIN, "collate", 0.5, 0.5499), (MAIN, "h2d", 0.5501, 0.58),
                   (MAIN, "gp_step", 0.5801, 0.9499)])
    got = program.align(v, rec)
    assert [(s, e) for _, s, e in got] == pytest.approx(
        [(0.05, 0.0999), (0.1001, 0.13), (0.1301, 0.4499), (0.5, 0.5499),
         (0.5501, 0.58), (0.5801, 0.9499)], abs=1e-9)


def test_a_profiles_program_spans_come_back_on_its_clock():
    """A CPU profile of two benchmark steps, each holding the program's
    step and a leaf: the record aligned to the benchmark's view puts each
    program span within microseconds of the profiler's own event."""
    from torch.profiler import ProfilerActivity, profile

    from cgat_tpu_torch.utils.profiling import annotate
    from harness import program
    from harness import trace as tr
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span(tr.WINDOW, True):
            for _ in range(2):
                with tr.span("step", True):
                    with annotate("train_step"):
                        with annotate("h2d"):
                            torch.ones(64).sum()
    v = tr.view_of(prof, [], {})
    got = program._inside(v)
    seen = sorted(((e.name.removeprefix("cgat."), e.time_range.start / 1e6,
                    e.time_range.end / 1e6) for e in prof.events()
                   if e.name.startswith("cgat.")), key=lambda x: x[1])
    assert [n for n, _, _ in got] == [n for n, _, _ in seen] == \
        ["train_step", "h2d"] * 2
    for (_, s, e), (_, ps, pe) in zip(got, seen):
        # the record's ends enclose the profiler's, up to the clocks'
        # agreement and the Python around the range
        assert s <= ps + 2e-5 and pe <= e + 2e-5
        assert ps - s < 2e-3 and e - pe < 2e-3
