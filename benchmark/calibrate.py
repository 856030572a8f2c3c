"""The readings the limits of ``correct`` are set from (not run by the
benchmark's runs):

* ``program``: the numbers a sound run of the program gives (a whole run
  of the cell), one a seed;
* ``control``: each of the driver's ``CONTROLS``, the reference computed
  one precision below the one the configuration states (float8 products,
  one scale a tensor, below bf16; TF32 below f32), put in the program's
  place against the f32 reference;
* ``faults``: each of the driver's ``FAULTS``, the f32 reference put in
  the program's place with the fault planted.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --what program,control,faults

prints one JSON line a reading on stdout. Each driver gives its numbers
by ``numbers(cell, precision, fault)``, so nothing here knows a driver.
Needs the card (or ``--device cpu`` at the tiny widths of a test's
copy).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import cell as cells  # noqa: E402
from harness import common  # noqa: E402


def run_seconds(root: Path = ROOT) -> float:
    with open(root / "BENCHMARK.json") as f:
        return float(json.load(f)["run_seconds"])


def driver_of(name: str, bench: Path = BENCH):
    work = cells.load(name, seed=0, seconds=1, trace=False,
                      bench=bench).workload
    return cells.module("drivers", work["driver"], bench)


def lowered_numbers(name: str, seed: int, precision: str,
                    fault: str | None = None, *, device: str = "cuda",
                    bench: Path = BENCH, root: Path = ROOT) -> dict:
    """The cell's numbers of the reference in ``precision`` with ``fault``
    planted, against the f32 reference, over what a run of
    ``run_seconds`` compares."""
    cell = cells.load(name, seed=seed, seconds=run_seconds(root),
                      trace=False, device=device, bench=bench)
    with contextlib.redirect_stdout(sys.stderr):
        out = driver_of(name, bench).numbers(cell, precision, fault)
    common.release(device)
    return out


def control_numbers(name, seed, device="cuda", bench=BENCH,
                    root=ROOT) -> dict:
    """The cell's control: the driver's first control."""
    return lowered_numbers(name, seed, driver_of(name, bench).CONTROLS[0],
                           device=device, bench=bench, root=root)


def program_numbers(name, seed, device="cuda", bench=BENCH,
                    root=ROOT) -> dict:
    import run
    out = run.run_cell(name, seed=seed, seconds=run_seconds(root),
                       trace=False, device=device, bench=bench, root=root)
    return {k: v["value"] for k, v in out["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control,faults")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    what = args.what.split(",")
    driver = driver_of(args.workload)
    for seed in seeds:
        jobs = []
        if "program" in what:
            jobs.append(("program", lambda: program_numbers(
                args.workload, seed, args.device)))
        if "control" in what:
            jobs += [(p, lambda p=p: lowered_numbers(
                args.workload, seed, p, device=args.device))
                for p in driver.CONTROLS]
        if "faults" in what:
            jobs += [(f, lambda f=f: lowered_numbers(
                args.workload, seed, "float32", f, device=args.device))
                for f in driver.FAULTS]
        for kind, job in jobs:
            t = time.perf_counter()
            numbers = job()
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": kind, "numbers": numbers,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
