"""The benchmark of cgat_tpu_torch on the card: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell's files (``harness/cell.py``), runs its driver (set-up,
then the window of ``--seconds``, or with ``--trace 1`` a traced window of
the mix's ``trace_steps``), checks what the window produced against the
plain reference, and prints one JSON line last on stdout: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1`` also
``busy_s`` and ``window_s``), with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared with its limit, also printed as the last
lines of stderr. Everything else goes to stderr. Exits 1 without a CUDA
card (or with fewer than the cell asks for), and 1 if JAX or the JAX
package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
FORBIDDEN = ("jax", "jaxlib", "flax", "cgat_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (whole names: ``cgat_tpu_torch`` is not
    ``cgat_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def device_info(cell, res: dict) -> dict:
    import torch
    info = {"platform": "gpu" if torch.device(cell.device).type == "cuda"
            else "cpu",
            "kind": (torch.cuda.get_device_name(0)
                     if torch.device(cell.device).type == "cuda" else "cpu"),
            "count": int(cell.workload["chips"]),
            "memory_peak_bytes": int(res["memory_peak_bytes"])}
    view = res.get("view")
    if view is not None:
        info["busy_s"] = view.busy_s()
        info["window_s"] = view.window_s
    return info


def per_layer(cell, view, names: list[str]) -> dict:
    """Each per-layer metric's reader on the traced window; a reader that
    finds nothing to read returns None and its metric is left out."""
    from harness import cell as cells
    out = {}
    for m in names:
        value = cells.metric(m["name"], cell.bench).read(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(name: str, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: Path = BENCH,
             root: Path = ROOT) -> dict:
    """One run of cell ``name``: the result line as a dict. The card's
    presence is the caller's to check (``main`` does)."""
    from harness import cell as cells
    from harness import checks
    from harness import trace as tr

    cell = cells.load(name, seed=seed, seconds=seconds, trace=trace,
                      device=device, t0=T0, bench=bench)
    driver = cells.module("drivers", cell.workload["driver"], bench)
    with contextlib.redirect_stdout(sys.stderr):
        res = driver.run(cell)
    correct, judged = checks.judge(res["numbers"], cell.limits)
    kind = "per_layer" if trace else "end_to_end"
    declared = cells.declared_metrics(name, kind, root)
    if trace:
        metrics = per_layer(cell, res["view"], declared)
    else:
        metrics = {m["name"]: res["metrics"][m["name"]] for m in declared
                   if m["name"] in res["metrics"]}
    notes = res.get("notes", {})
    if notes.get("captures_in_window"):
        cell.log(f"{notes['captures_in_window']} captures in the window")
    cell.log("notes", json.dumps(notes))
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics,
           "device": device_info(cell, res)}
    if trace:
        out["breakdown"] = tr.breakdown(res["view"])
    out["checks"] = judged
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import cell as cells
    from harness import checks
    work = cells.load(args.workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace)).workload
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < int(work["chips"]):
        print(f"the cell asks for {work['chips']} cards; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    out = run_cell(args.workload, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 1
    checks.print_checks(out["checks"])
    print(json.dumps(out))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
