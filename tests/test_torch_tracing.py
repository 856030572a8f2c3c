"""The port's tracing and rooflines (``cgat_tpu_torch/utils/profiling.py``,
``utils/roofline.py``, ``tools/step_trace.py``) on the CPU.

``trace`` writes a trace that loads and holds an ``annotate`` span (as
``cgat.<name>``, keyed without the namespace), and nothing without a
directory; ``Trainer.fit`` traces ``profile_epoch``'s epoch only, one
``train_step`` span a step, eager and grouped. A served request, a GP step
and a prefetched loader record their spans on the calling thread, in the
profile and in the program's record (its Unix-clock ends around the
profile's), and with no profiler none of them makes a
``record_function`` or adds to the record. The work
functions at the main path's shapes give PERF.md §6's bound column, and
the MH kernels' operations are cgat_tpu's ``mh_*_accounting`` MXU FLOPs.
The step trace's categoriser sorts a fixed list of H100 kernel names; the
measurements raise without a card.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from cgat_tpu.utils import roofline as jroofline
from cgat_tpu_torch.data.dataset import GraphLoader
from cgat_tpu_torch.data.prefetch import PrefetchLoader
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import CGATConfig, CGAtNet
from cgat_tpu_torch.models.init import init_state_dict
from cgat_tpu_torch.serving import ServingModel
from cgat_tpu_torch.tools import step_trace
from cgat_tpu_torch.training import Trainer, TrainerConfig
from cgat_tpu_torch.uncertainty import gp
from cgat_tpu_torch.utils import roofline
from cgat_tpu_torch.utils.profiling import (annotate, recorded_spans, trace,
                                            trace_files, trace_kernels)

TINY = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
            nbr_embedding_size=8, neighbor_number=6, msg_heads=2,
            n_graph_roost=1, out_hidden=(32, 32, 16))
GRAPHS = dict(n_atoms_range=(3, 7), max_nbr=6, orig_fea=16)
TRAIN = dict(batch_size=4, node_bucket=8, max_nbr=6, num_comp_slots=8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (tiny ops beside the other test
    processes); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_trace_holds_an_annotate_span(tmp_path):
    with trace(str(tmp_path / "t")):
        with annotate("my_span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    path, = trace_files(str(tmp_path / "t"))
    assert os.path.basename(path).startswith("rank0.")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert [e["name"] for e in events
            if e.get("cat") == "user_annotation"] == ["cgat.my_span"]
    assert trace_kernels(path)["span:my_span"][1] == 1


def test_trace_without_a_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for log_dir in (None, ""):
        with trace(log_dir):
            with annotate("my_span"):
                torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("k", [1, 2])
def test_fit_traces_its_profile_epoch_only(tmp_path, k):
    """Two epochs with profile_epoch=1: one trace, with epoch 1's steps
    (steps_per_dispatch K runs them in groups)."""
    graphs = random_graphs(3, 24, **GRAPHS)
    t = Trainer(TrainerConfig(**TRAIN, ckpt_dir=str(tmp_path),
                              run_name="r", profile_epoch=1,
                              steps_per_dispatch=k),
                CGATConfig(**TINY), graphs, device="cpu")
    history = t.fit(epochs=2)
    assert [h["epoch"] for h in history] == [0, 1]
    path, = trace_files(str(tmp_path / "runs" / "r" / "profile"))
    steps = len(t.train_graphs) // 4 // k * k
    assert t.step == 2 * steps
    assert trace_kernels(path)["span:train_step"][1] == steps


def _serve():
    """A CPU server (a tiny model, signatures of 6 graph slots) answering
    one request of 10 crystals: two chunks."""
    cfg = CGATConfig(**TINY)
    model = CGAtNet(cfg)
    model.load_state_dict(init_state_dict(model, seed=0), strict=True)
    sigs = [{"key": f"c6_n{n}", "num_graphs": 6, "num_node_slots": n,
             "num_edge_slots": n * 6, "num_comp_slots": 8} for n in (64,)]
    server = ServingModel({"mean": 0.5, "std": 2.0, "signatures": sigs,
                           "collate": {"max_nbr": 6, "orig_fea": 16}}, model)
    server.predict(random_graphs(5, 10, **GRAPHS), return_embeddings=True)


def _gp_step():
    """One eager GP step on fixed embeddings."""
    rng = np.random.default_rng(0)
    cfg = gp.GPConfig()
    x = torch.as_tensor(rng.normal(size=(8, 4)), dtype=torch.float32)
    fit = gp.GPFit(gp.init_gp(x[:3].numpy(), cfg), cfg, 1e-2,
                   lambda p, b: gp.elbo(p, b.x, b.y, 8, cfg),
                   torch.device("cpu"))
    fit.step(gp._Rows(x, torch.zeros(8)))


def _prefetch():
    """Three batches through a ``PrefetchLoader``, collated on its
    thread."""
    loader = GraphLoader(random_graphs(6, 12, **GRAPHS), 4, max_nbr=6,
                         node_bucket=8)
    assert len(list(PrefetchLoader(loader))) == 3


# each call, and the program's spans it records in start order: a request
# holds each chunk's collate and readback; the prefetch thread's collates
# are not recorded, the consumer's three waits and its wait for the end
# are
SPANS = {"predict": (_serve, ["predict", "collate", "readback", "collate",
                              "readback"]),
         "gp_step": (_gp_step, ["gp_step"]),
         "prefetch_wait": (_prefetch, ["prefetch_wait"] * 4)}


@pytest.mark.parametrize("entry", sorted(SPANS))
def test_calls_record_their_spans_on_the_calling_thread(entry):
    from torch.profiler import ProfilerActivity, profile

    call, want = SPANS[entry]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("caller"):
            call()
    spans = sorted(((e.name, e.thread, e.time_range.start,
                     e.time_range.end) for e in prof.events()
                    if e.is_user_annotation), key=lambda x: x[2])
    caller = spans[0]
    assert caller[0] == "caller"
    got = spans[1:]
    assert [n for n, _, _, _ in got] == ["cgat." + n for n in want]
    assert all(t == caller[1] for _, t, _, _ in got)
    if entry != "prefetch_wait":
        _, _, lo, hi = got[0]
        assert all(lo <= s <= e <= hi for _, _, s, e in got[1:])


@pytest.mark.parametrize("entry", sorted(SPANS))
def test_the_record_encloses_the_profiles_spans(entry):
    """``recorded_spans`` holds each span the profile holds, on the calling
    thread, its Unix-clock ends around the profiler's own."""
    from torch.profiler import ProfilerActivity, profile

    call, want = SPANS[entry]
    before = len(recorded_spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    got = sorted(recorded_spans()[before:], key=lambda r: r[2])
    assert [n for _, n, _, _ in got] == want
    assert {t for t, _, _, _ in got} == {threading.get_ident()}
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    seen = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.is_user_annotation)
    for (_, _, s, e), (ps, pe) in zip(got, seen):
        # microseconds from the trace's start; the clocks agree to ~1 us
        assert s <= start_ns + ps * 1e3 + 2e3
        assert start_ns + pe * 1e3 <= e + 2e3


@pytest.mark.parametrize("entry", sorted(SPANS))
def test_without_a_profiler_no_record_function_is_made(monkeypatch, entry):
    def made(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", made)
    before = recorded_spans()
    SPANS[entry][0]()
    with annotate("train_step"):
        pass
    assert recorded_spans() == before


def test_bounds_reproduce_the_table():
    """PERF.md §6's bound column (ms), from serving request 0's and the
    first training step's batches."""
    req = roofline.request_batch("cpu")
    tr = roofline.training_batch("cpu")
    n, e = int(req.num_node_slots), int(req.num_edge_slots)
    tn, te = int(tr.num_node_slots), int(tr.num_edge_slots)
    assert (n, e, tn, te) == (832, 19968, 768, 18432)
    hyper_f, hyper_b = roofline.hyper_work(n, 128, 128, 128), \
        roofline.hyper_work(tn, 128, 128, 128)
    work = {
        "segment_attention": roofline.segment_attention_work(
            int(req.edge_mask.sum()), 640, n),
        "segment_attention_bwd": roofline.segment_attention_bwd_work(
            te, int(tr.edge_mask.sum()), 640, tn),
        "mh_network": roofline.mh_network_work(e, 384, 5, 256, 128),
        "mh_network_bwd": roofline.mh_network_bwd_work(te, 384, 5, 256, 128),
        "hyper_apply": hyper_f["hyper_apply"],
        "hyper_apply_bwd_dhdx": hyper_b["hyper_apply_bwd_dhdx"],
        "hyper_apply_bwd_dk": hyper_b["hyper_apply_bwd_dk"],
        "segment_sum": roofline.segment_sum_work(te, 128, tn),
        "dropout": roofline.dropout_work(e * 640)}
    table = {"segment_attention": (0.0145, "bytes"),
             "segment_attention_bwd": (0.0293, "bytes"),
             "mh_network": (0.0265, "operations"),
             "mh_network_bwd": (0.0489, "operations"),
             "hyper_apply": (0.0036, "operations"),
             "hyper_apply_bwd_dhdx": (0.0066, "operations"),
             "hyper_apply_bwd_dk": (0.0033, "operations"),
             "segment_sum": (0.0015, "bytes"), "dropout": (0.0153, "bytes")}
    got = {k: roofline.bound(*w, roofline.PEAKS[k]) for k, w in work.items()}
    assert {k: (round(ms, 4), by) for k, (ms, by) in got.items()} == table
    s = roofline.summarize(work["mh_network"], 1e-4,
                           roofline.PEAKS["mh_network"])
    assert s["ops_share"] == pytest.approx(got["mh_network"][0] / 0.1)
    assert s["bound_by"] == "operations" and s["bytes_share"] < 1


def test_segment_attention_bounds_at_each_shape():
    """#1's bound (ms) at the three shapes ``measure_kernels`` times it at:
    request 0's without stats (the table's), the first training step's
    with the f32 max and exp-sum written (2 x N x H*F x 4 bytes more), and
    the first GP batch's (phase 11's: 5,952 node and 142,848 edge slots)."""
    req = roofline.request_batch("cpu")
    tr = roofline.training_batch("cpu")
    gp = roofline.gp_batch("cpu")
    assert (int(gp.num_node_slots), int(gp.num_edge_slots)) == (5952, 142848)
    got = {}
    for name, b, stats in (("request", req, False), ("training", tr, True),
                           ("gp", gp, False)):
        n, real = int(b.num_node_slots), int(b.edge_mask.sum())
        work = roofline.segment_attention_work(real, 640, n, stats)
        plain = roofline.segment_attention_work(real, 640, n)
        assert work[0] - plain[0] == (8.0 * n * 640 if stats else 0)
        assert work[1] == plain[1] == 6.0 * real * 640
        ms, by = roofline.bound(*work, roofline.PEAKS["segment_attention"])
        got[name] = (round(ms, 4), by)
    assert got == {"request": (0.0145, "bytes"),
                   "training": (0.0149, "bytes"), "gp": (0.111, "bytes")}


@pytest.mark.parametrize("e,cat,hid,f,heads", [(8448, 384, 256, 128, 5),
                                               (18432, 384, 256, 128, 5),
                                               (37, 48, 32, 16, 2)])
def test_mh_operations_equal_cgat_tpus_mxu_flops(e, cat, hid, f, heads):
    assert roofline.mh_network_work(e, cat, heads, hid, f)[1] == \
        jroofline.mh_fwd_accounting(e, cat, hid, f, heads)["mxu_flops"]
    assert roofline.mh_network_bwd_work(e, cat, heads, hid, f)[1] == \
        jroofline.mh_bwd_accounting(e, cat, hid, f, heads)["mxu_flops"]


# device kernel names as the profiler gives them on an H100 (the port's
# with their anonymous namespace, PyTorch's and cuBLAS's)
NAMES = {
    "void (anonymous namespace)::segment_attention_fwd<__nv_bfloat16, 4>"
    "(__nv_bfloat16 const*, __nv_bfloat16 const*, int const*, int const*, "
    "int, int, __nv_bfloat16*, float*, float*)": "#1 segment_attention",
    "void (anonymous namespace)::bulk::segment_attention_fwd_stream<"
    "__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16 const*, int const*, "
    "int const*, int, int, int, int, __nv_bfloat16*, float*, float*)":
        "#1 segment_attention",
    "void (anonymous namespace)::segment_attention_bwd<__nv_bfloat16>"
    "(__nv_bfloat16 const*)": "#2 segment_attention_bwd",
    "void sm90::gemm_kernel<(sm90::Epilogue)1>(CUtensorMap_st, "
    "CUtensorMap_st, sm90::Params)": "#3 mh_network",
    "void (anonymous namespace)::pass_a::kernel(CUtensorMap_st)":
        "#4 mh_network_bwd",
    "void (anonymous namespace)::pass_b::kernel(CUtensorMap_st)":
        "#4 mh_network_bwd",
    "void (anonymous namespace)::reduce_parts((anonymous namespace)::"
    "ReduceJob, int)": "#4 mh_network_bwd",
    "void (anonymous namespace)::fwd::kernel(CUtensorMap_st, int)":
        "#5 hyper_apply",
    "void (anonymous namespace)::dhdx::bwd_kernel(CUtensorMap_st)":
        "#6 hyper_apply_bwd_dhdx",
    "void (anonymous namespace)::dhdx::reduce_kernel(float const*, int)":
        "#6 hyper_apply_bwd_dhdx",
    "void (anonymous namespace)::dk::kernel(CUtensorMap_st, int)":
        "#7 hyper_apply_bwd_dk",
    "void (anonymous namespace)::segment_sum_kernel<__nv_bfloat16>"
    "(__nv_bfloat16 const*, int const*, int, int, __nv_bfloat16*)":
        "#8 segment_sum",
    "void (anonymous namespace)::dropout_fwd_kernel<__nv_bfloat16>"
    "(__nv_bfloat16 const*)": "dropout",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<"
    "at::native::(anonymous namespace)::TensorListMetadata<4>>(int)":
        "optimizer",
    "Memcpy DtoD (Device -> Device)": "copies and memsets",
    "Memset (Device)": "copies and memsets",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<"
    "at::native::(anonymous namespace)::OpaqueType<2u>, unsigned int, 2, "
    "128, 1>()": "copies and memsets",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroup"
    "size1x1x1_execute_segment_k_off_kernel__5x_cublas": "GEMMs",
    "nvjet_hsh_128x128_64x4_1x2_h_bz_coopA_NTN": "GEMMs",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, float>()":
        "GEMMs",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<c10::"
    "BFloat16, at::native::func_wrapper_t<float, at::native::sum_functor<"
    "c10::BFloat16, float, float>>, unsigned int, c10::BFloat16, 4, 4>>()":
        "reductions",
    "void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>"
    "()": "reductions",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}"
    ", std::array<char*, 2ul>>(int)": "casts and other elementwise",
    "void at::native::unrolled_elementwise_kernel<at::native::"
    "direct_copy_kernel_cuda(at::TensorIteratorBase&)>()":
        "casts and other elementwise",
    "void at::native::index_elementwise_kernel<128, 4>(long)":
        "casts and other elementwise",
    "void at::native::(anonymous namespace)::indexSelectLargeIndex<c10::"
    "BFloat16, long, unsigned int, 2, 2, -2, true>()": "other",
    "void at::native::(anonymous namespace)::embedding_backward_feature_"
    "kernel<float, float, long>()": "other",
}


def test_step_trace_categorizes_h100_kernel_names():
    assert {n: step_trace.categorize(n) for n in NAMES} == NAMES


def test_step_trace_categories_add_up():
    per_name = {n: [0.01 * (i + 1), float(i % 3 + 1)]
                for i, n in enumerate(NAMES)}
    res = step_trace.split(per_name, 2)
    cats = res["categories"]
    assert sum(c["ms"] for c in cats.values()) == pytest.approx(
        res["device_ms_per_step"], rel=1e-12)
    assert res["device_ms_per_step"] == pytest.approx(
        sum(v[0] for v in per_name.values()) / 2)
    assert sum(c["events"] for c in cats.values()) == pytest.approx(
        res["events_per_step"])
    assert [e["ms_per_step"] for e in res["events"]] == sorted(
        (e["ms_per_step"] for e in res["events"]), reverse=True)


def test_measurements_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (roofline.measure_kernels, roofline.measure_mh_kernels,
               roofline.measure_hyper_kernels, step_trace.step_trace,
               roofline.main, lambda: step_trace.main([])):
        with pytest.raises(RuntimeError, match="CUDA card"):
            fn()
