"""A cell and its files, found by name.

* ``benchmark/workloads/<cell>.json``: the configuration's and the traffic
  mix's names, the driver, the chips, ``why`` and the limits of the
  numbers that decide ``correct``;
* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/traffic/<traffic>.json``: the traffic mix's parameters;
* ``benchmark/drivers/<driver>.py``: the loop the window runs;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, or
  where there is none, ``benchmark/metrics/<quantity>.py`` for a metric
  named ``<quantity>.<cells>`` (one reader of idle time for
  ``device_idle.train`` and ``device_idle.gp``).

A new cell, configuration, mix or metric is a new file and an entry in
``BENCHMARK.json``; no file here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str, bench: Path = BENCH):
    """The module ``<bench>/<kind>/<name>.py`` (its name may hold dots)."""
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, bench: Path = BENCH):
    """The reader of per-layer metric ``name``: its own file, or its
    quantity's (the name before the first dot)."""
    own = bench / "metrics" / f"{name}.py"
    return module("metrics", name if own.is_file() else name.split(".")[0],
                  bench)


@dataclasses.dataclass
class Cell:
    """One run of one cell: its files' contents and the run's arguments.
    ``device`` is where the program runs (the card in every benchmark
    run; the CPU in the tests)."""
    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = 0.0
    bench: Path = BENCH

    @property
    def program_seed(self) -> int:
        """The seed handed to the program's own seeded choices (the
        dataset split, the loaders' shuffles), which take 32 bits."""
        return self.seed % (1 << 32)

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})

    def log(self, *args) -> None:
        print(f"[{self.name}]", *args, file=sys.stderr, flush=True)


def load(name: str, *, seed: int, seconds: float, trace: bool,
         device: str = "cuda", t0: float = 0.0, bench: Path = BENCH) -> Cell:
    work = _json(bench / "workloads" / f"{name}.json")
    return Cell(name=name, workload=work,
                config=_json(bench / "configs" / f"{work['config']}.json"),
                traffic=_json(bench / "traffic" / f"{work['traffic']}.json"),
                seed=seed, seconds=seconds, trace=trace, device=device,
                t0=t0, bench=bench)


def declared_metrics(name: str, kind: str, root: Path = ROOT) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics ``BENCHMARK.json`` gives
    cell ``name`` (those listing it, or listing no cells)."""
    bench = _json(root / "BENCHMARK.json")
    return [m for m in bench[kind]
            if name in m.get("workloads", [name])]
