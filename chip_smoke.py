#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cgat_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; imports nothing of JAX. Four phases, any
failure exits non-zero:

1. build the CUDA kernels from ``cgat_tpu_torch/csrc`` with nvcc (sm_90a);
2. hold each kernel against its plain PyTorch version on the card at the
   shapes the serving forward gives it, and time both with CUDA events;
3. serve: the reference-default CGAtNet in bf16 (seeded random weights)
   answers 3 requests of 64 crystals through ``ServingModel.predict``; each
   forward must launch mh_network x10, segment_attention x6 and
   hyper_apply x20, give finite outputs, and (first request) agree with the
   port's own bf16 forward on the CPU; then one request's time is broken
   down into collate, copy, forward and the card's busy time;
4. report the card, and the kernels as one JSON line; the last line is
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores

N_GRAPHS = 64                  # crystals per request
N_REQUESTS = 3
N_TIMED = 10                   # extra timed requests after the checked ones
KERNEL_TOL = 2e-2              # kernel vs plain, times max|plain| (bf16 I/O)
MODEL_RTOL = 5e-2              # card vs CPU forward (bf16 end to end)
PER_FORWARD = {"mh_network": 10, "segment_attention": 6, "hyper_apply": 20}
REPLACES = {
    "segment_attention": "cgat_tpu/ops/pallas/segment_attention.py:82",
    "mh_network": "cgat_tpu/ops/pallas/mh_network.py:63",
    "hyper_apply": "cgat_tpu/ops/pallas/hyper_apply.py:82",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def bound(n_bytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got, want) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > KERNEL_TOL * scale:
        fail(f"{name}: max |kernel - plain| {err:.3e} > {KERNEL_TOL} * "
             f"max|plain| ({scale:.3e})")
    return err


def build_kernels() -> None:
    from cgat_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    info = build.build()
    print(f"[build] {len(info)} kernels in {time.perf_counter() - t0:.1f} s "
          f"({build.BUILD_DIR})")
    for name, rec in info.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def check_kernels(model, batch) -> list[dict]:
    """Phase 2: each kernel vs its plain version at the serving shapes, with
    the first message-passing layer's weights and real activations."""
    from cgat_tpu_torch.ops.kernels import hyper_apply as hk
    from cgat_tpu_torch.ops.kernels import mh_network as mk
    from cgat_tpu_torch.ops.kernels import segment_attention as sk

    node = model.graphs[0].Node
    rows = []
    with torch.inference_mode():
        x = model.embedding(batch.nodes)
        e_attr = model.nbr_embedding(batch.edge_shell)
        m_cat = torch.cat([x[batch.edge_dst], e_attr, x[batch.edge_src]], -1)
        n_edges, cat = m_cat.shape
        n_nodes = x.shape[0]

        # mh_network: MH_A and MH_M of layer 0 on the real edge features
        def mh_args(net):
            H, hid, f = net.nb_heads, net.hidden_layer_dim, net.output_dim
            return (m_cat, net.fc_in.weight.view(H * hid, cat),
                    net.fc_in.bias, net.fc_out.weight.view(H * f, hid),
                    net.fc_out.bias, H)
        args_a, args_m = mh_args(node.MH_A), mh_args(node.MH_M)
        alpha = mk.mh_network(*args_a)
        msg = mk.mh_network(*args_m)
        err = max(compare("mh_network", alpha, mk.mh_network_plain(*args_a)),
                  compare("mh_network", msg, mk.mh_network_plain(*args_m)))
        H, hid, f = node.MH_A.nb_heads, node.MH_A.hidden_layer_dim, \
            node.MH_A.output_dim
        flops = 2.0 * n_edges * (cat * H * hid + H * hid * f)
        nbytes = 2.0 * (n_edges * cat + H * hid * cat + H * hid
                        + H * f * hid + H * f + n_edges * H * f)
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        rows.append({"name": "mh_network", "shape": [n_edges, cat, H * hid,
                                                     H * f],
                     "max_abs_err": err,
                     "ms": time_ms(lambda: mk.mh_network(*args_a)),
                     "plain_ms": time_ms(lambda: mk.mh_network_plain(*args_a)),
                     "bound_ms": b_ms, "bound_by": b_by})

        # segment_attention: the layer-0 aggregation (edges -> nodes) and the
        # crystal pool's shape (nodes -> crystals)
        n_real = batch.edge_mask.sum(dtype=torch.int32)
        seg_args = (alpha, msg, batch.edge_dst_offn, n_real, n_nodes)
        out, mx, den = sk.segment_attention(*seg_args, return_stats=True)
        p_out, p_mx, p_den = sk.segment_attention_plain(*seg_args)
        err = compare("segment_attention", out, p_out)
        if not torch.equal(mx, p_mx):
            fail("segment_attention: per-node max differs from the plain "
                 "version")
        torch.testing.assert_close(den, p_den, rtol=1e-4, atol=1e-6)
        hf = alpha.shape[1]
        n_pool = int(batch.node_mask.sum())
        gen = torch.Generator(device=x.device).manual_seed(0)
        pa = torch.randn(n_nodes, hf, generator=gen,
                         device=x.device).to(torch.bfloat16)
        pm = torch.randn(n_nodes, hf, generator=gen,
                         device=x.device).to(torch.bfloat16)
        pool_args = (pa, pm, batch.node2graph_offn,
                     batch.node_mask.sum(dtype=torch.int32),
                     batch.num_graphs)
        err = max(err, compare("segment_attention",
                               sk.segment_attention(*pool_args),
                               sk.segment_attention_plain(*pool_args)[0]))
        real_e = int(n_real)
        flops = 6.0 * real_e * hf          # max, sub, exp, add, fma (2)
        nbytes = 2.0 * 2 * real_e * hf + 4.0 * (n_nodes + 1) \
            + 2.0 * n_nodes * hf
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        rows.append({"name": "segment_attention",
                     "shape": [n_edges, hf, n_nodes], "max_abs_err": err,
                     "ms": time_ms(lambda: sk.segment_attention(*seg_args)),
                     "plain_ms": time_ms(
                         lambda: sk.segment_attention_plain(*seg_args)),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "pool_ms": time_ms(lambda: sk.segment_attention(
                         *pool_args))})

        # hyper_apply: layer 0's first HyperLinear on the real node features
        hl = node.Pooling_NN.Hyper.layers[0].hyper_linear
        last = hl.hypo_params.net[-1]
        hidden = hl.hypo_params.hidden(x).contiguous()
        h_args = (hidden, last.weight, last.bias, x.contiguous(), hl.out_ch)
        err = compare("hyper_apply", hk.hyper_apply(*h_args),
                      hk.hyper_apply_plain(*h_args))
        C, I, O = hidden.shape[1], hl.in_ch, hl.out_ch
        F = O * I + O
        flops = 2.0 * n_nodes * C * F + 2.0 * n_nodes * O * I
        nbytes = 2.0 * (n_nodes * C + F * C + F + n_nodes * I + n_nodes * O)
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        rows.append({"name": "hyper_apply", "shape": [n_nodes, C, I, O],
                     "max_abs_err": err,
                     "ms": time_ms(lambda: hk.hyper_apply(*h_args)),
                     "plain_ms": time_ms(lambda: hk.hyper_apply_plain(*h_args)),
                     "bound_ms": b_ms, "bound_by": b_by})
    for r in rows:
        print(f"[kernels] {r['name']} {r['shape']}: max_abs_err "
              f"{r['max_abs_err']:.3e} (tol {KERNEL_TOL} x max|plain|), "
              f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms"
              + (f", pool shape {r['pool_ms']:.4f} ms" if "pool_ms" in r
                 else ""))
    return rows


def serve(model, requests) -> tuple[dict, dict]:
    """Phase 3: answer the requests through ServingModel.predict."""
    from cgat_tpu_torch.data import pad_to_bucket
    from cgat_tpu_torch.ops.kernels import KERNEL_WRAPPERS
    from cgat_tpu_torch.serving import ServingModel

    max_atoms = max(sum(g.n_atoms for g in r) for r in requests)
    sigs = [{"key": f"c{N_GRAPHS}_n{n}", "num_graphs": N_GRAPHS,
             "num_node_slots": n, "num_edge_slots": n * 24,
             "num_comp_slots": 8}
            for n in range(64, pad_to_bucket(max_atoms, 64) + 1, 64)]
    manifest = {"mean": 0.0, "std": 1.0, "signatures": sigs,
                "collate": {"max_nbr": 24, "orig_fea": 200}}
    server = ServingModel(manifest, model)
    for k in KERNEL_WRAPPERS:
        k.launches = 0
    ms = []
    for i, graphs in enumerate(requests):
        before = {k.__name__: k.launches for k in KERNEL_WRAPPERS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred, log_std = server.predict(graphs)
        ms.append((time.perf_counter() - t0) * 1e3)
        got = {k.__name__: k.launches - before[k.__name__]
               for k in KERNEL_WRAPPERS}
        if got != PER_FORWARD:
            fail(f"request {i}: kernel launches {got} != {PER_FORWARD}")
        if pred.shape != (len(graphs),) or not (
                np.isfinite(pred).all() and np.isfinite(log_std).all()):
            fail(f"request {i}: predictions not finite with shape "
                 f"({len(graphs)},)")
        print(f"[serve] request {i}: {len(graphs)} crystals, "
              f"{sum(g.n_atoms for g in graphs)} atoms, {ms[-1]:.2f} ms, "
              f"launches {got}")
    launches = {k.__name__: k.launches for k in KERNEL_WRAPPERS}
    timed = []
    for _ in range(N_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.predict(requests[1])
        timed.append((time.perf_counter() - t0) * 1e3)
    stats = {"request_ms": ms, "steady_ms_median": float(np.median(timed)),
             "steady_ms_min": float(np.min(timed))}
    print(f"[serve] steady state over {N_TIMED} requests of {N_GRAPHS}: "
          f"median {stats['steady_ms_median']:.2f} ms, min "
          f"{stats['steady_ms_min']:.2f} ms")
    return launches, stats


def breakdown(model, graphs, rows, reps: int = 10) -> dict:
    """Where one request's time goes. The steps of ``ServingModel.predict``
    (collate on the host, copy to the card, forward, copy back) are timed
    one by one on the host clock, each ending in a synchronise; medians over
    ``reps`` requests. Then the card's busy time in one forward, from
    torch.profiler's device events, and the three kernels' part of the
    forward (phase 2 times x launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cgat_tpu_torch.data import collate, pad_to_bucket

    n = pad_to_bucket(sum(g.n_atoms for g in graphs), 64)
    kw = dict(num_graphs=N_GRAPHS, num_node_slots=n, num_edge_slots=n * 24,
              num_comp_slots=8, max_nbr=24, orig_fea=200)

    def forward(batch):
        with torch.inference_mode():
            return model.head(model.embed(batch))

    steps = {"collate_ms": [], "to_card_ms": [], "forward_ms": [],
             "to_host_ms": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        batch = collate(graphs, **kw)
        t.append(time.perf_counter())
        batch = batch.to("cuda")
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = forward(batch)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out.cpu().numpy()
        t.append(time.perf_counter())
        for k, a, b in zip(steps, t[:-1], t[1:]):
            steps[k].append((b - a) * 1e3)
    res = {k: float(np.median(v)) for k, v in steps.items()}
    res["kernels_ms"] = sum(r["ms"] * PER_FORWARD[r["name"]] for r in rows)

    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            forward(batch)
        torch.cuda.synchronize()
    per_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_name[e.name] = (per_name.get(e.name, 0.0)
                                + e.time_range.elapsed_us() / 1e3 / n_prof)
    if per_name:
        busy = sum(per_name.values())
        res.update(device_busy_ms=busy,
                   device_idle_share=1.0 - busy / res["forward_ms"],
                   top_device_ms=[[k[:70], v] for k, v in sorted(
                       per_name.items(), key=lambda kv: -kv[1])[:8]])
    else:           # the profiler saw no device activity on this machine
        res.update(device_busy_ms=None, device_idle_share=None,
                   top_device_ms=None)
    print(f"[breakdown] {n} node slots, medians of {reps}: collate "
          f"{res['collate_ms']:.2f} ms, to card {res['to_card_ms']:.2f} ms, "
          f"forward {res['forward_ms']:.2f} ms, to host "
          f"{res['to_host_ms']:.2f} ms; the three kernels "
          f"{res['kernels_ms']:.2f} ms of the forward")
    if per_name:
        print(f"[breakdown] device busy {busy:.2f} ms per forward, idle "
              f"share {res['device_idle_share']:.3f}")
        for name, ms in res["top_device_ms"]:
            print(f"[breakdown]   {ms:8.4f} ms  {name}")
    else:
        print("[breakdown] device busy time: not measured (the profiler "
              "recorded no device events)")
    return res


def check_against_cpu(model, cpu_model, graphs, sig_nodes) -> float:
    """The card's forward vs the port's own bf16 forward on the CPU (plain
    versions), same weights, same batch."""
    from cgat_tpu_torch.data import collate
    batch = collate(graphs, num_graphs=N_GRAPHS, num_node_slots=sig_nodes,
                    num_edge_slots=sig_nodes * 24, num_comp_slots=8,
                    max_nbr=24, orig_fea=200)
    with torch.inference_mode():
        got = model(batch.to("cuda")).cpu()
        want = cpu_model(batch)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not torch.allclose(
            got, want, rtol=MODEL_RTOL, atol=MODEL_RTOL * scale):
        fail(f"card vs CPU forward: max abs diff {err:.3e} "
             f"(max|out| {scale:.3e})")
    print(f"[serve] card vs CPU bf16 forward: max abs diff {err:.3e}, "
          f"max|out| {scale:.3e} (rtol {MODEL_RTOL}, atol {MODEL_RTOL} x "
          f"max|out|)")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from cgat_tpu_torch.data import collate, pad_to_bucket
    from cgat_tpu_torch.data.synthetic import random_graphs
    from cgat_tpu_torch.models import CGATConfig, CGAtNet, init_state_dict

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    build_kernels()

    cfg = CGATConfig(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    cpu_model = CGAtNet(cfg)
    cpu_model.load_state_dict(init_state_dict(cpu_model, seed=0), strict=True)
    cpu_model.to_compute_dtype().eval()
    model = CGAtNet(cfg)
    model.load_state_dict(cpu_model.state_dict(), strict=True)
    model = model.to_compute_dtype().to(device).eval()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[model] reference-default CGAtNet, bf16, {n_params} parameters, "
          f"built in {time.perf_counter() - t0:.1f} s")

    requests = [random_graphs(seed, N_GRAPHS, n_atoms_range=(8, 16),
                              max_nbr=24, full_degree=True)
                for seed in range(N_REQUESTS)]
    n0 = pad_to_bucket(sum(g.n_atoms for g in requests[0]), 64)
    batch0 = collate(requests[0], num_graphs=N_GRAPHS, num_node_slots=n0,
                     num_edge_slots=n0 * 24, num_comp_slots=8, max_nbr=24,
                     orig_fea=200).to(device)
    rows = check_kernels(model, batch0)
    launches, stats = serve(model, requests)
    stats["breakdown"] = breakdown(model, requests[1], rows)
    for name, count in launches.items():
        if count != PER_FORWARD[name] * N_REQUESTS:
            fail(f"{name} launched {count} times on the main path")
    check_against_cpu(model, cpu_model, requests[0], n0)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"serving": {"crystals_per_request": N_GRAPHS,
                                  "edge_slots": int(batch0.num_edge_slots),
                                  "node_slots": int(batch0.num_node_slots),
                                  **stats}}))
    kernels = [{"name": r["name"], "route": "cuda",
                "source": f"cgat_tpu_torch/csrc/{r['name']}.cu",
                "replaces": REPLACES[r["name"]],
                "launches": launches[r["name"]],
                "max_abs_err": r["max_abs_err"], "tolerance": KERNEL_TOL,
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None} for r in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
