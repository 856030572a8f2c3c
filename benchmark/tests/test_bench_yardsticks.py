"""The benchmark's frozen yardsticks against the port's values today: the
peaks and work functions against ``utils/roofline.py`` and PERF.md's bound
column at the main path's shapes, the categories against
``tools/step_trace.py`` on H100 kernel names, the model's FLOP count
against the reference's products, and the traffic generator's crystals."""
import numpy as np
import pytest
import torch

from cgat_tpu_torch.tools import step_trace
from cgat_tpu_torch.utils import roofline
from harness import traffic, yardsticks
from reference import model as ref_model
from reference.precision import Precision

# device kernel names as the profiler gives them on an H100, and their
# categories (the port's test of tools/step_trace.py holds the same)
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

# (node slots, real edges) of serving request 0 and the first training
# step, and PERF.md's bound column (ms) at them
REQUEST, TRAINING = (832, 19968), (768, 18432)
TABLE = {"segment_attention": (0.0145, "bytes"),
         "segment_attention_bwd": (0.0293, "bytes"),
         "mh_network": (0.0265, "operations"),
         "mh_network_bwd": (0.0489, "operations"),
         "hyper_apply": (0.0036, "operations"),
         "hyper_apply_bwd_dhdx": (0.0066, "operations"),
         "hyper_apply_bwd_dk": (0.0033, "operations"),
         "segment_sum": (0.0015, "bytes"), "dropout": (0.0153, "bytes")}


def _works(mod, req_real, tr_real):
    (n, e), (tn, te) = REQUEST, TRAINING
    hf, hb = mod.hyper_work(n, 128, 128, 128), mod.hyper_work(tn, 128, 128,
                                                              128)
    return {"segment_attention": mod.segment_attention_work(req_real, 640, n),
            "segment_attention_bwd": mod.segment_attention_bwd_work(
                te, tr_real, 640, tn),
            "mh_network": mod.mh_network_work(e, 384, 5, 256, 128),
            "mh_network_bwd": mod.mh_network_bwd_work(te, 384, 5, 256, 128),
            "hyper_apply": hf["hyper_apply"],
            "hyper_apply_bwd_dhdx": hb["hyper_apply_bwd_dhdx"],
            "hyper_apply_bwd_dk": hb["hyper_apply_bwd_dk"],
            "segment_sum": mod.segment_sum_work(te, 128, tn),
            "dropout": mod.dropout_work(e * 640)}


def test_peaks_are_the_ports():
    assert (yardsticks.HBM_BYTES_PER_S, yardsticks.BF16_TENSOR_FLOPS,
            yardsticks.F32_FLOPS) == (roofline.HBM_BYTES_PER_S,
                                      roofline.BF16_TENSOR_FLOPS,
                                      roofline.F32_FLOPS)
    for k, v in yardsticks.PEAKS.items():
        assert roofline.PEAKS[k] == v


@pytest.mark.parametrize("kernel", sorted(TABLE))
def test_bound_column_at_the_main_shapes(kernel):
    """Each work function at the main path's shapes gives PERF.md's bound
    and the port's work function's (bytes, operations)."""
    req_real, tr_real = 772 * 24, 733 * 24
    mine = _works(yardsticks, req_real, tr_real)[kernel]
    ports = _works(roofline, req_real, tr_real)[kernel]
    assert mine == ports
    ms, by = yardsticks.bound(*mine, yardsticks.PEAKS[kernel])
    assert (round(ms, 4), by) == TABLE[kernel]


@pytest.mark.parametrize("stats", [False, True])
def test_segment_attention_stats_term(stats):
    n, real = 768, 733 * 24
    assert yardsticks.segment_attention_work(real, 640, n, stats) == \
        roofline.segment_attention_work(real, 640, n, stats)


def test_categories_of_h100_names():
    assert {n: yardsticks.categorize(n) for n in NAMES} == NAMES
    assert {n: step_trace.categorize(n) for n in NAMES} == NAMES
    assert yardsticks.PORT_KERNELS == step_trace.PORT_KERNELS
    assert yardsticks.CATEGORIES == step_trace.CATEGORIES


def test_calls_count_by_an_event_of_their_category():
    for cat, (work, pattern, per_call) in yardsticks.CALLS.items():
        names = [n for n, c in NAMES.items() if c == cat and pattern in n]
        assert names, cat
        assert work in yardsticks.PEAKS and per_call >= 1


def test_kernel_calls_a_step():
    """Calls a forward and a training step of the default model: 6 #1,
    10 #3, 20 #5 a forward; 6 #2, 10 #4, 20 #6 and #7, 11 #8 a backward
    (PERF.md §6's launches)."""
    model = {"elem_fea_len": 128, "msg_heads": 5, "nbr_embedding_size": 128,
             "n_graph": 5}
    shapes = {"N": 768, "E": 18432, "Nr": 733, "Er": 733 * 24, "C": 64}
    fwd = yardsticks.kernel_calls(model, shapes, False)
    assert {k: len(v) for k, v in fwd.items()} == {
        "segment_attention": 6, "mh_network": 10, "hyper_apply": 20}
    step = yardsticks.kernel_calls(model, shapes, True)
    assert {k: len(v) for k, v in step.items()} == {
        "segment_attention": 6, "mh_network": 10, "hyper_apply": 20,
        "segment_attention_bwd": 6, "mh_network_bwd": 10,
        "hyper_apply_bwd_dhdx": 20, "hyper_apply_bwd_dk": 20,
        "segment_sum": 11}
    assert step["segment_attention"][0] == yardsticks.segment_attention_work(
        733 * 24, 640, 768, True)


class _Tally(Precision):
    """f32 products that count 2 m n k each."""

    def __init__(self):
        super().__init__("float32")
        self.flops = 0.0

    def mm(self, a, b):
        self.flops += 2.0 * a[..., 0].numel() * a.shape[-1] * b.shape[-1]
        return super().mm(a, b)


@pytest.mark.parametrize("head", [True, False])
def test_model_flops_count_the_references_products(head):
    """The FLOP count equals the reference's products on a batch whose
    crystals all have 3 species (Roost's dense pairs then are R x R, the
    count's P; the diagonal counted as the dense layout computes it)."""
    cfg = {"orig_elem_fea_len": 200, "elem_fea_len": 16, "n_graph": 2,
           "nbr_embedding_size": 16, "neighbor_number": 24, "msg_heads": 2,
           "n_graph_roost": 1, "out_hidden": [32, 32, 16],
           "update_edges": True}
    crystals = traffic.make_crystals(3, 64, atoms=(6, 9), n_species=3)
    r = np.diff(crystals.comp_ptr)
    idx = np.flatnonzero(r == 3)[:5]
    P = {k: torch.randn(s) * 0.1
         for k, s in ref_model.param_shapes(cfg).items()}
    tally = _Tally()
    net = ref_model.CGAT(cfg, tally)
    b = ref_model.make_batch(crystals, idx, "cpu")
    with torch.no_grad():
        net.forward(P, b) if head else net.embed(P, b)
    sh = traffic.batch_shapes(crystals, idx, slots=len(idx), node_bucket=64)
    sh = {**sh, "P": len(idx) * 9}
    assert yardsticks.model_flops(cfg, sh, head=head) == pytest.approx(
        tally.flops, rel=1e-12)


def test_crystals_follow_random_graphs_rules():
    c = traffic.make_crystals(2 ** 33 + 5, 300, atoms=(4, 20))
    assert c.n_atoms.min() >= 4 and c.n_atoms.max() <= 20
    assert len(c.edge_src) == c.n_atoms.sum() * 24
    for i in range(len(c)):
        e = c.edges(i)
        src, dst = c.edge_src[e], c.edge_dst[e]
        assert np.all(src != dst)
        assert dst.min() >= 0 and dst.max() < c.n_atoms[i]
        assert np.all(np.bincount(src, minlength=c.n_atoms[i]) == 24)
        sh = c.edge_shell[e].reshape(-1, 24)
        assert np.all(sh[:, 0] >= 1) and np.all(np.diff(sh, axis=1) >= 0)
        assert sh.max() <= 24
        assert c.comp_weight[c.comps(i)].sum() == pytest.approx(1.0,
                                                               abs=1e-6)
    again = traffic.make_crystals(2 ** 33 + 5, 300, atoms=(4, 20))
    assert np.array_equal(again.edge_dst, c.edge_dst)
    assert np.array_equal(again.atom_fea, c.atom_fea)


def test_batch_shapes_match_the_ports_collate():
    from cgat_tpu_torch.data.batching import CrystalGraph, collate

    c = traffic.make_crystals(7, 40, atoms=(4, 20))
    graphs = traffic.to_graphs(c, CrystalGraph)
    idx = np.arange(5, 21)
    b = collate([graphs[i] for i in idx], num_graphs=16, max_degree=24)
    sh = traffic.batch_shapes(c, idx, slots=16, node_bucket=64)
    assert (sh["N"], sh["E"], sh["Nr"], sh["Er"], sh["C"]) == (
        b.num_node_slots, b.num_edge_slots, int(b.node_mask.sum()),
        int(b.edge_mask.sum()), b.num_graphs)
