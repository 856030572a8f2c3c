"""The harness on the CPU: isolation (no JAX, no JAX package; the reference
loads nothing of the program), a run that finds no card, dry runs of each
cell at tiny widths, a throwaway cell added as new files only, the trace
reduction, and the faults that ``correct`` must catch, each planted under
the timed path. The run on the card is marked ``gpu``."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CELLS = ("train-default.b64", "gp-svgp.b512", "screen-default.b5000")
TINY = {"orig_elem_fea_len": 200, "elem_fea_len": 16, "n_graph": 2,
        "nbr_embedding_size": 16, "neighbor_number": 24, "mean_pooling": False,
        "rezero": True, "msg_heads": 2, "update_edges": True,
        "vector_attention": True, "global_vector_attention": True,
        "n_graph_roost": 1, "no_hyper": True, "dropout": 0.0,
        "out_hidden": [32, 32, 16], "compute_dtype": "float32"}
SEED = 2 ** 31 + 4321


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(BENCH)])
    return env


def _modules_after(code: str) -> set:
    """The top-level names of the modules loaded after ``code`` runs in a
    fresh interpreter."""
    prog = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')"\
        "[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def tiny_bench(tmp: Path) -> tuple[Path, Path]:
    """A copy of the benchmark at tiny widths and pools under ``tmp``:
    (its root, its benchmark directory)."""
    root = tmp / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in (bench / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["model" if "model" in c else "backbone"] = TINY
        if "gp" in c:
            c["gp"].update(num_inducing=20, batch_size=32)
        else:
            c["trainer"]["batch_size"] = 8
        path.write_text(json.dumps(c))
    for path in (bench / "traffic").glob("*.json"):
        c = json.loads(path.read_text())
        c.update(pool=256, trace_steps=4, max_rate=2)
        if "dataset" in c:
            c.update(dataset=512)
        if "request" in c:
            c.update(request=32, chunk=8, sample_requests=2, min_rate=1,
                     signature_step=64, reference_block=8)
        path.write_text(json.dumps(c))
    return root, bench


def run_tiny(root, bench, cell, seed=SEED):
    import run
    return run.run_cell(cell, seed=seed, seconds=0.5, trace=False,
                        device="cpu", bench=bench, root=root)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("bench"))


# ---------------------------------------------------------------- isolation

FORBIDDEN = {"jax", "jaxlib", "flax", "cgat_tpu"}


def test_harness_and_drivers_load_no_jax():
    """Every harness module, driver and metric reader, and the program the
    drivers drive: nothing whose top-level name is JAX's or the JAX
    package's (``cgat_tpu_torch`` is compared whole, so it is not)."""
    code = "\n".join(
        ["import run", "from harness import cell"]
        + [f"import harness.{p.stem}" for p in (BENCH / "harness").glob("*.py")
           if p.stem != "__init__"]
        + [f"cell.module('drivers', {p.stem!r})._program()"
           for p in (BENCH / "drivers").glob("*.py")]
        + [f"cell.module('metrics', {p.stem!r})"
           for p in (BENCH / "metrics").glob("*.py")])
    loaded = _modules_after(code)
    assert "cgat_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = "\n".join(f"import reference.{p.stem}"
                     for p in (BENCH / "reference").glob("*.py"))
    code += "\nimport harness.checks, harness.traffic, harness.weights"
    loaded = _modules_after(code)
    assert not loaded & (FORBIDDEN | {"cgat_tpu_torch"})


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "cgat_tpu_torch_x", sys)
    assert "cgat_tpu_torch_x" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cgat_tpu.models", sys)
    assert run.forbidden_modules() == ["cgat_tpu"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env={**_env(), "CUDA_VISIBLE_DEVICES":
                                             ""}, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "card" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """In a directory with BENCHMARK.json and benchmark/ only (no program),
    a run exits with an error and prints no result."""
    shutil.copytree(BENCH, tmp_path / "benchmark")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, cwd=tmp_path, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_every_per_layer_metric_has_a_reader():
    """Each per-layer metric of BENCHMARK.json finds its reader: its own
    file or its quantity's (``device_idle.train`` reads
    ``metrics/device_idle.py``)."""
    from harness import cell as cells
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert callable(cells.metric(m["name"]).read), m["name"]
    with pytest.raises(FileNotFoundError):
        cells.metric("no_such_quantity.train")


# ----------------------------------------------------------- dry runs

@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_of_each_cell(tiny, cell):
    """Each cell at tiny widths on the CPU: the result line's keys, its
    end-to-end metrics as BENCHMARK.json gives them, and ``correct``."""
    root, bench = tiny
    out = run_tiny(root, bench, cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    declared = {m["name"] for m in json.loads(
        (root / "BENCHMARK.json").read_text())["end_to_end"]
        if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == declared
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


def _digest(path: Path) -> dict:
    return {str(p.relative_to(path)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(path.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    """A throwaway configuration, traffic mix, cell and per-layer metric,
    added as new files and BENCHMARK.json entries: the harness runs the
    cell, and no file the benchmark had changes."""
    root, bench = tiny_bench(tmp_path)
    before = _digest(bench)
    (bench / "configs" / "throwaway.json").write_text(
        (bench / "configs" / "cgat-default.json").read_text())
    mix = json.loads((bench / "traffic" / "train.b64.json").read_text())
    (bench / "traffic" / "throwaway.json").write_text(json.dumps(
        {**mix, "atoms": [6, 9], "pool": 128}))
    (bench / "workloads" / "throwaway.cell.json").write_text(json.dumps({
        "config": "throwaway", "traffic": "throwaway", "driver": "train",
        "chips": 1, "why": "a test's cell",
        "limits": {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}}))
    (bench / "metrics" / "steps.throwaway.py").write_text(
        "def read(view):\n    return len(view.steps)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "throwaway.cell", "config": "throwaway",
                              "traffic": "throwaway", "chips": 1,
                              "why": "a test's cell"})
    spec["end_to_end"][0]["workloads"].append("throwaway.cell")
    spec["per_layer"].append({"name": "steps.throwaway", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "data", "moves": "train_graphs_per_s",
                              "workloads": ["throwaway.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_tiny(root, bench, "throwaway.cell")
    assert out["correct"]
    assert set(out["metrics"]) == {"train_graphs_per_s", "setup_s"}
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
    import run
    from harness import trace as tr
    view = tr.View([("k", 0.0, 0.5)], [], (0.0, 1.0), [{}, {}], TINY)
    from harness import cell as cells
    metric = [m for m in spec["per_layer"] if m["name"] == "steps.throwaway"]
    cell = cells.load("throwaway.cell", seed=1, seconds=1, trace=True,
                      device="cpu", bench=bench)
    assert run.per_layer(cell, view, metric) == {
        "steps.throwaway": {"value": 2.0, "unit": "steps"}}


@pytest.mark.parametrize("cell", CELLS[:2])
def test_set_up_warms_every_shape_before_its_replayed_steps(tiny, cell):
    """The set-up's sequence: the checked steps, then one step of each
    shape new within the planned steps, then the feed's next steps, every
    one of whose shapes is warm by then; the dataset is the pool
    repeated, so an epoch is longer than the planned steps."""
    from harness import cell as cells
    from harness import common
    root, bench = tiny
    c = cells.load(cell, seed=SEED, seconds=20, trace=False, device="cpu",
                   bench=bench)
    driver = cells.module("drivers", c.workload["driver"], bench)
    plan = driver.Plan(c, driver.pool(c))
    k, planned = int(c.traffic["checked_steps"]), common.planned_steps(c)
    seq, start = common.set_up_sequence(plan, k, planned)
    assert seq[:k] == list(range(k)) and seq[start:] == list(range(k, 2 * k))
    warm = {plan.shapes(s)["N"] for s in seq[:start]}
    assert {plan.shapes(s)["N"] for s in range(k + planned)} == warm
    assert len(warm) == start - k + len({plan.shapes(s)["N"]
                                         for s in range(k)})
    assert len(plan.rows) == c.traffic["dataset"] > len(plan.crystals)
    assert (plan.rows < len(plan.crystals)).all()


# ------------------------------------------------------- trace reduction

def test_trace_view_reduction():
    """Busy time is the union of device events; gaps are labelled by the
    innermost open span; readers leave out what they cannot read."""
    from harness import readers
    from harness import trace as tr
    mh = "void sm90::gemm_kernel<(sm90::Epilogue)1>(CUtensorMap_st)"
    opt = "multi_tensor_apply_kernel<x>"
    dev = [(mh, 0.10, 0.30), (mh, 0.20, 0.40), (opt, 0.60, 0.70)]
    spans = [("window", 0.0, 1.0), ("step", 0.05, 0.45),
             ("loader", 0.45, 0.60), ("step", 0.60, 0.95)]
    model = {"elem_fea_len": 128, "msg_heads": 5, "nbr_embedding_size": 128,
             "n_graph": 5, "orig_elem_fea_len": 200, "n_graph_roost": 3,
             "out_hidden": [1024, 1024, 512, 512, 256, 256, 128]}
    steps = [{"N": 768, "E": 18432, "Nr": 733, "Er": 733 * 24, "C": 64,
              "Rr": 200, "P": 600, "training": True}] * 2
    v = tr.View(sorted(dev), spans, (0.0, 1.0), steps, model)
    assert v.busy_s() == pytest.approx(0.4)
    assert v.gaps() == [(0.0, 0.1), (0.4, 0.6), (0.7, 1.0)]
    assert readers.idle_pct(v) == pytest.approx(60.0)
    assert readers.span_ms(v, "loader") == pytest.approx(150.0)
    assert readers.span_ms(v, "collate") is None
    assert readers.category_ms_per_step(v, "optimizer") == pytest.approx(50)
    assert readers.host_ms(v, "step") == pytest.approx(
        ((0.40 - 0.30) + (0.35 - 0.10)) / 2 * 1e3)
    b = tr.breakdown(v)
    assert [g[0] for g in b["idle_gaps"]] == ["step", "loader", "step"]
    assert [g[1] for g in b["idle_gaps"]] == pytest.approx([0.3, 0.2, 0.1])
    assert b["device_ops"][0] == ["#3 mh_network", pytest.approx(0.4)]
    # two GEMM events are one #3 call: its bound at the steps' shapes, over
    # the 0.4 s the two took
    from harness import yardsticks
    bound, device = tr.kernels_bound_and_time(v, training=True)
    one = yardsticks.bound(*yardsticks.mh_network_work(18432, 384, 5, 256,
                                                       128), 989e12)[0]
    assert bound == pytest.approx(one) and device == pytest.approx(400.0)
    assert readers.mfu_pct(v) is None
    v.extra["flops"] = 989e12 * 0.25
    assert readers.mfu_pct(v) == pytest.approx(25.0)
    empty = tr.View([], spans, (0.0, 1.0), steps, model)
    assert readers.kernels_roofline_pct(empty) is None
    assert readers.idle_pct(empty) is None


# ------------------------------------------------------------ faults

def _plant(monkeypatch, cell, fault):
    """Break the timed path underneath: a step that leaves its state as it
    was; half of each batch left out of the loss, the mean taken over the
    rest; an answer altered where it is produced."""
    from cgat_tpu_torch.models.cgat import CGAtNet
    from cgat_tpu_torch.serving import artifact
    from cgat_tpu_torch.training import trainer
    from cgat_tpu_torch.uncertainty import gp

    def half(mask):
        keep = torch.arange(mask.shape[0], device=mask.device) \
            < mask.sum() // 2
        return mask & keep

    if cell == "train-default.b64":
        if fault == "still":
            monkeypatch.setattr(trainer.Trainer, "_update_on_device",
                                lambda self: self.step_count.add_(1))
        elif fault == "half_batch":
            metrics = trainer._metrics
            monkeypatch.setattr(trainer, "_metrics",
                                lambda o, s, t, m, *a: metrics(o, s, t,
                                                               half(m), *a))
        else:
            head = CGAtNet.head
            monkeypatch.setattr(CGAtNet, "head", lambda self, x, **k:
                                head(self, x, **k) * 1.05)
    elif cell == "gp-svgp.b512":
        if fault == "still":
            monkeypatch.setattr(gp.Adam, "apply", lambda self: None)
        elif fault == "half_batch":
            elbo = gp.elbo
            monkeypatch.setattr(gp, "elbo", lambda p, x, y, n, c, mask=None:
                                elbo(p, x, y, n, c, mask=half(mask)))
        else:
            embed = gp.frozen_embed
            monkeypatch.setattr(gp, "frozen_embed",
                                lambda model, b: embed(model, b) * 1.05)
    else:
        forward = artifact.ServingModel.forward
        if fault == "half_batch":
            def halved(self, batch):
                pred, log_std, emb = forward(self, batch)
                n = int(batch.graph_mask.sum()) // 2
                pred = pred.clone()
                pred[n:] = pred[:n].mean()
                return pred, log_std, emb
            monkeypatch.setattr(artifact.ServingModel, "forward", halved)
        else:
            def altered(self, batch):
                pred, log_std, emb = forward(self, batch)
                return pred + 0.05 * pred.abs().max(), log_std, emb
            monkeypatch.setattr(artifact.ServingModel, "forward", altered)


FAULTS = [(c, f) for c in CELLS[:2] for f in ("still", "half_batch",
                                               "answer")] \
    + [(CELLS[2], f) for f in ("half_batch", "answer")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_reads_not_correct(tiny, monkeypatch, cell, fault):
    """The run with its real limits: each fault makes ``correct`` false."""
    root, bench = tiny
    _plant(monkeypatch, cell, fault)
    out = run_tiny(root, bench, cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_not_correct(tiny, cell):
    """The reference in the precision below the configuration's (float8
    products for the bf16 model, TF32 for the f32 SVGP), put in the
    program's place against the f32 reference, fails a limit of its cell
    at the tiny widths too (``calibrate.py`` reads it at the cell's size
    on the card)."""
    import calibrate
    root, bench = tiny
    numbers = calibrate.control_numbers(cell, SEED, device="cpu", bench=bench,
                                        root=root)
    from harness import cell as cells
    limits = cells.load(cell, seed=SEED, seconds=1, trace=False,
                        bench=bench).limits
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", cell,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
