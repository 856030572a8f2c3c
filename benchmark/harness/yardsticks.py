"""Frozen yardsticks: the H100's peaks, each kernel's work from its shapes,
the categories of device events by kernel name, and the model's matrix
FLOPs. Copied from the port (``utils/roofline.py``,
``tools/step_trace.py``) as they stood when the benchmark was written, so
that a change to the program cannot move the measure it is judged by;
``benchmark/tests/test_bench_yardsticks.py`` holds the copies equal to
those values.

A kernel's work is what its inputs need, whatever implements it: each
input read once and each output written once, and the operations these
inputs need. Its bound is the larger of its bytes over the memory rate
and its operations over the peak for their type.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12     # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores

PEAKS = {"segment_attention": F32_FLOPS, "segment_attention_bwd": F32_FLOPS,
         "mh_network": BF16_TENSOR_FLOPS, "mh_network_bwd": BF16_TENSOR_FLOPS,
         "hyper_apply": BF16_TENSOR_FLOPS,
         "hyper_apply_bwd_dhdx": BF16_TENSOR_FLOPS,
         "hyper_apply_bwd_dk": BF16_TENSOR_FLOPS, "segment_sum": F32_FLOPS,
         "dropout": F32_FLOPS}


def bound(n_bytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least ms the card could take for ``n_bytes`` and ``ops`` at
    ``peak`` operations a second, and which of the two bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segment_attention_work(real_edges, hf, num_nodes, stats=False):
    """#1: alpha and m read on the real rows, the CSR pointers read, out
    written (bf16), with ``stats`` the f32 max and exp-sum written."""
    return (2.0 * 2 * real_edges * hf + 4.0 * (num_nodes + 1)
            + 2.0 * num_nodes * hf + (8.0 * num_nodes * hf if stats else 0),
            6.0 * real_edges * hf)


def segment_attention_bwd_work(edge_rows, real_edges, hf, num_nodes):
    """#2: alpha and m read on the real rows, dalpha and dm written on all
    rows, the ids read, g and out (bf16) and max and den (f32) read."""
    return (2.0 * 2 * real_edges * hf + 2.0 * 2 * edge_rows * hf
            + 4.0 * real_edges + (2.0 + 2.0 + 4.0 + 4.0) * num_nodes * hf,
            7.0 * real_edges * hf)


def mh_network_work(edge_rows, cat, heads, hid, f):
    """#3 (bf16): x, weights and biases read, the output written; the two
    products of each head."""
    return (2.0 * (edge_rows * cat + heads * hid * cat + heads * hid
                   + heads * f * hid + heads * f + edge_rows * heads * f),
            2.0 * edge_rows * (cat * heads * hid + heads * hid * f))


def mh_network_bwd_work(edge_rows, cat, heads, hid, f):
    """#4 (bf16): x, h and g read, dx written, the weights read and their
    gradients and the biases' written; the four products."""
    hh, hf = heads * hid, heads * f
    return (2.0 * (edge_rows * cat + edge_rows * hh + edge_rows * hf
                   + edge_rows * cat + 2 * (hh * cat + hh + hf * hid + hf)),
            4.0 * edge_rows * hh * (f + cat))


def hyper_work(b, c, i, o):
    """#5, #6 and #7 on ``b`` rows (hidden width C, I inputs, O outputs)."""
    f = o * i + o
    return {"hyper_apply": (2.0 * (b * c + f * c + f + b * i + b * o),
                            2.0 * b * c * f + 2.0 * b * o * i),
            "hyper_apply_bwd_dhdx": (
                2.0 * (2 * b * c + 2 * b * i + b * o + f * c + f),
                4.0 * b * f * c + 2.0 * b * o * i),
            "hyper_apply_bwd_dk": (
                2.0 * (b * c + b * i + b * o + o * i * c) + 4.0 * o * i,
                2.0 * b * o * i * c)}


def segment_sum_work(rows, f, num_segments):
    """#8 (bf16): the rows read, the sums written, the CSR pointers read."""
    return (2.0 * (rows * f + num_segments * f) + 4.0 * (num_segments + 1),
            1.0 * rows * f)


def dropout_work(n):
    """The dropout kernel on ``n`` bf16 elements."""
    return 2.0 * 2 * n, float(n)


# ------------------------------------------------ device events by name

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
    port's kernels, else the first of ``CATEGORIES`` whose substrings it
    holds, else "other"."""
    for category, patterns in PORT_KERNELS + CATEGORIES:
        if any(p in name for p in patterns):
            return category
    return OTHER


# a call of each port kernel: the work function's name, and the device
# events a call launches of the event that counts calls (#3 launches two
# GEMMs; #4 and #6 count by their first kernel, which runs once a call)
CALLS = {
    "#1 segment_attention": ("segment_attention", "segment_attention_fwd", 1),
    "#2 segment_attention_bwd": ("segment_attention_bwd",
                                 "segment_attention_bwd", 1),
    "#3 mh_network": ("mh_network", "sm90::gemm_kernel<", 2),
    "#4 mh_network_bwd": ("mh_network_bwd", "pass_a::kernel(", 1),
    "#5 hyper_apply": ("hyper_apply", "fwd::kernel(", 1),
    "#6 hyper_apply_bwd_dhdx": ("hyper_apply_bwd_dhdx", "dhdx::bwd_kernel(",
                                1),
    "#7 hyper_apply_bwd_dk": ("hyper_apply_bwd_dk", "dk::kernel(", 1),
    "#8 segment_sum": ("segment_sum", "segment_sum_kernel", 1),
    "dropout": ("dropout", "dropout_", 1),
}


def kernel_calls(model: dict, shapes: dict, training: bool) -> dict:
    """Every port-kernel call of one forward (and, in ``training``, its
    backward) of the CGAT model ``model`` (its widths) on a batch of
    ``shapes`` (``N``/``E`` node and edge slots, ``Nr``/``Er`` real nodes
    and edges, ``C`` crystal slots): work function name -> list of
    (bytes, operations), one entry a call. Only the default path
    (``no_hyper``, vector attention, no dropout) is counted."""
    c, heads = model["elem_fea_len"], model["msg_heads"]
    cat = 2 * c + model["nbr_embedding_size"]
    hid = int(cat / 1.5)
    hf = heads * c
    layers = model["n_graph"]
    N, E, Nr, Er, C = (shapes[k] for k in ("N", "E", "Nr", "Er", "C"))
    hyper = hyper_work(N, c, c, c)
    calls = {
        "segment_attention": [segment_attention_work(Er, hf, N, training)]
        * layers + [segment_attention_work(Nr, hf, C, training)],
        "mh_network": [mh_network_work(E, cat, heads, hid, c)] * 2 * layers,
        "hyper_apply": [hyper["hyper_apply"]] * 4 * layers,
    }
    if training:
        calls.update({
            "segment_attention_bwd": [segment_attention_bwd_work(
                E, Er, hf, N)] * layers
            + [segment_attention_bwd_work(N, Nr, hf, C)],
            "mh_network_bwd": [mh_network_bwd_work(E, cat, heads, hid, c)]
            * 2 * layers,
            "hyper_apply_bwd_dhdx": [hyper["hyper_apply_bwd_dhdx"]]
            * 4 * layers,
            "hyper_apply_bwd_dk": [hyper["hyper_apply_bwd_dk"]] * 4 * layers,
            "segment_sum": [segment_sum_work(E, c, N)] * 2 * layers
            + [segment_sum_work(N, c, C)],
        })
    return calls


def kernel_bound_ms(work_name: str, calls: list, n_calls: float) -> float:
    """The bound (ms) of ``n_calls`` calls of a kernel, each the mean of
    ``calls``' bounds (the calls of one step, at its shapes)."""
    if not calls:
        return 0.0
    each = sum(bound(b, o, PEAKS[work_name])[0] for b, o in calls) / len(calls)
    return each * n_calls


# ------------------------------------------------------------ model FLOPs

def _mlp(rows, dims):
    """2 m n k of a chain of Linear layers ``dims`` on ``rows`` rows."""
    return sum(2.0 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def model_flops(model: dict, shapes: dict, head: bool = True) -> float:
    """The matrix FLOPs (2 m n k a product) of one forward of the CGAT
    model ``model`` on the real rows of a batch: ``Er`` real edges, ``Nr``
    real nodes, ``C`` real crystals, ``Rr`` real composition entries and
    ``P`` real ordered composition pairs (s != t within a crystal). The
    message-passing layers' MH networks and hypernetworks, the edge MLP,
    the element embedding, Roost, the pool and the output head; not the
    elementwise work, the softmaxes or the gathers. ``head`` False leaves
    the output head out (a forward to the graph embeddings)."""
    c, heads = model["elem_fea_len"], model["msg_heads"]
    nbr = model["nbr_embedding_size"]
    cat = 2 * c + nbr
    hid = int(cat / 1.5)
    orig = model["orig_elem_fea_len"]
    Er, Nr, C, Rr, P = (shapes[k] for k in ("Er", "Nr", "C", "Rr", "P"))
    # one MH network: each head in -> hid -> out
    mh = lambda rows, d_in, d_hid, d_out: 2.0 * rows * heads * (
        d_in * d_hid + d_hid * d_out)
    # a HyperLinear (128 -> 128): the FCBlock's 4 Tanh layers and its last
    # Linear to the predicted weights, then the predicted product
    f_pred = c * c + c
    hyper_linear = _mlp(Nr, [c] * 5) + 2.0 * Nr * c * f_pred \
        + 2.0 * Nr * c * c
    layer = 2 * mh(Er, cat, hid, c) + 4 * hyper_linear
    if model.get("update_edges", True):
        layer += _mlp(Er, [nbr, nbr, nbr])
    flops = model["n_graph"] * layer + 2.0 * Nr * orig * c
    # Roost: the embedding, each message layer's gate and message networks
    # on the pairs, the pool's gate
    flops += 2.0 * Rr * orig * (c - 1)
    flops += model["n_graph_roost"] * (_mlp(P, [2 * c, 256, 1])
                                       + _mlp(P, [2 * c, 256, c]))
    flops += _mlp(Rr, [c, 256, 1])
    # the crystal pool: MH_M on the atoms, MH_A on [atom | crystal]
    flops += mh(Nr, c, c, c) + mh(Nr, 2 * c, c, c)
    if not head:
        return flops
    # the output head: each Linear and each skip whose width changes
    dims = [heads * c, *model["out_hidden"]]
    flops += _mlp(C, dims) + 2.0 * C * dims[-1] * 2
    flops += sum(2.0 * C * a * b for a, b in zip(dims[:-1], dims[1:])
                 if a != b)
    return flops


def svgp_flops(m: int, b: int, d: int) -> float:
    """The matrix FLOPs of one SVGP ELBO on ``b`` rows of width ``d`` with
    ``m`` inducing points: Kzz and Kzx, the Cholesky factor, the triangular
    solve, and L^T A."""
    return (2.0 * m * m * d + 2.0 * m * b * d + m ** 3 / 3.0
            + 1.0 * m * m * b + 2.0 * m * m * b)
