"""Where does a replayed training step's device time go? (needs the card)

Counterpart of the repository's ``tools/step_trace.py``. Builds the
reference-default ``Trainer`` (bf16 compute, bf16 first moment, AdamW,
batch 64 of synthetic full-degree crystals, as ``chip_smoke.py``'s
dispatch phase), takes the first step of a batch (eager, then captured as
a CUDA graph), then profiles ``--iters`` replays through
``utils.profiling.device_ms`` and sorts the device events into categories
by kernel name (:func:`categorize`)::

    python -m cgat_tpu_torch.tools.step_trace [--iters 10] [--dump-top 30]
        [--keep DIR] [--batch 64] [--dtype bfloat16] [--k 1]

Prints one JSON object: the card, the device ms a step in all and by
category, and the top events with their ms and calls a step. ``--k K``
replays groups of K steps (``steps_per_dispatch``); ``--keep DIR`` also
writes the profile's Chrome trace there.
"""
from __future__ import annotations

import argparse
import json
import os

# the port's kernels: a name for each, and substrings of the names of the
# device kernels its wrapper launches
PORT_KERNELS = (
    ("#1 segment_attention", ("segment_attention_fwd",)),
    ("#2 segment_attention_bwd", ("segment_attention_bwd",)),
    ("#3 mh_network", ("sm90::gemm_kernel<",)),
    ("#4 mh_network_bwd", ("pass_a::kernel(", "pass_b::kernel(",
                           "reduce_parts(")),
    ("#5 hyper_apply", ("fwd::kernel(",)),
    ("#6 hyper_apply_bwd_dhdx", ("dhdx::bwd_kernel(",
                                 "dhdx::reduce_kernel(")),
    ("#7 hyper_apply_bwd_dk", ("dk::kernel(",)),
    ("#8 segment_sum", ("segment_sum_kernel",)),
    ("dropout", ("dropout_fwd_kernel", "dropout_bwd_kernel")),
)
# PyTorch's and its libraries' kernels, in the order they are tried
CATEGORIES = (
    ("optimizer", ("multi_tensor_apply",)),
    ("copies and memsets", ("Memcpy", "Memset", "CatArrayBatchedCopy")),
    ("GEMMs", ("gemm", "Gemm", "gemv", "xmma", "cutlass", "nvjet",
               "splitK", "cublas")),
    ("reductions", ("reduce_kernel", "Reduce", "softmax", "SoftMax",
                    "scan", "Scan")),
    ("casts and other elementwise", ("elementwise_kernel",)),
)
OTHER = "other"


def categorize(name: str) -> str:
    """The category of a device event by its kernel name: one of the
    port's kernels (by its number and name), else the first of
    ``CATEGORIES`` whose substrings it holds, else "other"."""
    for category, patterns in PORT_KERNELS + CATEGORIES:
        if any(p in name for p in patterns):
            return category
    return OTHER


def split(per_name: dict, steps: int) -> dict:
    """``device_ms``'s result for runs of ``steps`` steps each, as ms and
    events a step in all, by category and by event name."""
    cats: dict[str, list[float]] = {}
    for name, (ms, count) in per_name.items():
        c = cats.setdefault(categorize(name), [0.0, 0.0])
        c[0] += ms / steps
        c[1] += count / steps
    return {"device_ms_per_step": sum(v[0] for v in per_name.values()) / steps,
            "events_per_step": sum(v[1] for v in per_name.values()) / steps,
            "categories": {k: {"ms": v[0], "events": v[1]} for k, v in sorted(
                cats.items(), key=lambda kv: -kv[1][0])},
            "events": sorted(
                ({"name": n, "category": categorize(n), "ms_per_step": ms /
                  steps, "calls_per_step": count / steps}
                 for n, (ms, count) in per_name.items()),
                key=lambda e: -e["ms_per_step"])}


def step_trace(iters: int = 10, batch: int = 64, dtype: str = "bfloat16",
               k: int = 1, keep: str | None = None) -> dict:
    """Profile ``iters`` replays of ``k`` steps of the default model on the
    card; returns :func:`split`'s result with the config. Raises without a
    card."""
    import torch

    from ..data.synthetic import random_graphs
    from ..models import CGATConfig
    from ..training import Trainer, TrainerConfig
    from ..utils.profiling import device_ms

    if not torch.cuda.is_available():
        raise RuntimeError("step_trace needs a CUDA card")
    graphs = random_graphs(100, 5 * batch * k, n_atoms_range=(8, 16),
                           max_nbr=24, full_degree=True)
    trainer = Trainer(TrainerConfig(batch_size=batch, moment_dtype=dtype,
                                    steps_per_dispatch=k),
                      CGATConfig(compute_dtype=dtype), graphs, device="cuda")
    trainer.init_state()
    if k > 1:
        data = next(iter(trainer.grouped_loader(trainer.train_graphs)))
        data = data.to("cuda")
        run = lambda: trainer.train_group(data)
    else:
        data = next(iter(trainer.loader(trainer.train_graphs, shuffle=True)))
        data = data.to("cuda")
        run = lambda: trainer.train_step(data)
    run()                       # the first step of the shape, and its capture
    run()
    torch.cuda.synchronize()
    if keep:
        os.makedirs(keep, exist_ok=True)
    per_name = device_ms(run, iters, export=keep and os.path.join(
        keep, "step_trace.pt.trace.json"))
    if not per_name:
        raise RuntimeError("the profiler recorded no device events")
    return {"config": {"batch": batch, "dtype": dtype, "iters": iters,
                       "k": k}, **split(per_name, k)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dump-top", type=int, default=30)
    ap.add_argument("--keep", default=None)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--k", type=int, default=1,
                    help="steps_per_dispatch (1 isolates one step cleanly)")
    args = ap.parse_args(argv)

    from ..device import card_line

    res = step_trace(args.iters, args.batch, args.dtype, args.k, args.keep)
    events = res.pop("events")
    print(json.dumps({"metric": "step_trace_ms_per_step", "card": card_line(),
                      **res, "top_events": events[:args.dump_top]},
                     indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
