"""Forward and gradient of each autograd Function of the port against the
JAX function it ports, on the CPU (the port's wrappers run their plain
versions for CPU tensors; the JAX side runs its Pallas kernels in interpret
mode). Inputs are made with numpy from a seed and handed to both.

Tolerances: f32 at 1e-5 (summation order only). bf16 against cgat_tpu's f32
XLA path at the norm-relative tolerances cgat_tpu's own tests use
(tests/test_pallas_kernels.py:129, 302: forward 2e-2, gradients 3e-2;
tests/test_mh_kernel.py: 5e-2 for the MH network), and against cgat_tpu's
bf16 Pallas kernels, which round at the same places, at the same bounds.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cgat_tpu.data import collate as jcollate
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.models import CGAtNet as JNet
from cgat_tpu.models.host_init import init_params_host
from cgat_tpu.ops import attention as jatt
from cgat_tpu.ops import gather as jgather
from cgat_tpu.ops.pallas import hyper_apply as jhyper
from cgat_tpu.ops.pallas import mh_network as jmh
from cgat_tpu.ops.pallas import segment_attention as jsa
from cgat_tpu.ops.pallas.segment_sum import csr_segment_sum
from cgat_tpu_torch.data import collate, host_offsets
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import CGATConfig, CGAtNet, state_dict_from_jax
from cgat_tpu_torch.ops import attention
from cgat_tpu_torch.ops.gather import GatherPlan, gather_rows
from cgat_tpu_torch.ops.kernels import hyper_apply, mh_network, segment_sum

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# Start torch's CPU thread pool now: its first parallel kernel after JAX's
# CPU runtime has started can come out less exact (torch.exp off by ~1e-4
# relative, once), which the f32 comparisons below would see.
torch.exp(torch.zeros(1 << 20))

BF = jnp.bfloat16


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30)


def _bf16(a):
    """The bf16 values of ``a`` as f32 numpy, identical on both sides."""
    return np.asarray(jnp.asarray(a, BF), np.float32)


def _t(a, dtype=torch.float32, grad=False):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                        requires_grad=grad)


def _seg_problem(seed, n_nodes=64, n_real=900, e_tot=1024, hf=256):
    rng = np.random.default_rng(seed)
    dst = np.sort(rng.integers(0, n_nodes, size=n_real)).astype(np.int32)
    dst = np.concatenate([dst, np.full(e_tot - n_real, n_nodes - 1, np.int32)])
    mask = np.arange(e_tot) < n_real
    alpha = rng.standard_normal((e_tot, hf)).astype(np.float32) * 2
    m = rng.standard_normal((e_tot, hf)).astype(np.float32)
    cot = rng.standard_normal((n_nodes, hf)).astype(np.float32)
    return alpha, m, dst, mask, cot, n_nodes


def _port_seg(alpha, m, dst, mask, cot, n, dtype):
    a, mm = _t(alpha, dtype, True), _t(m, dtype, True)
    out = attention.edge_softmax_aggregate(
        a, mm, torch.from_numpy(dst), n, edge_mask=torch.from_numpy(mask),
        offn=torch.from_numpy(host_offsets(dst, n)))
    (out.float() * _t(cot)).sum().backward()
    return out.detach().float().numpy(), a.grad.float(), mm.grad.float()


def test_segment_attention_grad_f32_matches_jax_pallas():
    alpha, m, dst, mask, cot, n = _seg_problem(0)

    def f(a, mm):
        return jsa.edge_softmax_aggregate_flat(
            a, mm, jnp.asarray(dst), n, edge_mask=jnp.asarray(mask),
            block_edges=256, interpret=True)
    want, vjp = jax.vjp(f, jnp.asarray(alpha), jnp.asarray(m))
    got = _port_seg(alpha, m, dst, mask, cot, n, torch.float32)
    np.testing.assert_allclose(got[0], np.asarray(want), rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], vjp(jnp.asarray(cot))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert not got[1][~mask].any() and not got[2][~mask].any()


def test_segment_attention_grad_bf16_matches_jax_f32_xla():
    alpha, m, dst, mask, cot, n = _seg_problem(1)
    alpha, m, cot = _bf16(alpha * 0.75), _bf16(m), _bf16(cot)
    e, hf = alpha.shape

    def f(a, mm):
        return jatt.edge_softmax_aggregate(
            a.reshape(e, 2, hf // 2), mm.reshape(e, 2, hf // 2),
            jnp.asarray(dst), n, edge_mask=jnp.asarray(mask),
            backend="xla").reshape(n, hf)
    want, vjp = jax.vjp(f, jnp.asarray(alpha), jnp.asarray(m))
    got = _port_seg(alpha, m, dst, mask, cot, n, torch.bfloat16)
    assert _rel(got[0], want) < 2e-2
    for g, w in zip(got[1:], vjp(jnp.asarray(cot))):
        assert _rel(g, w) < 3e-2


def _mh_problem(seed, e=256, cat=384, hid=256, f=128, heads=5):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((e, cat)))
    w_in = _bf16(rng.standard_normal((heads, hid, cat)) * 0.05)
    b_in = _bf16(rng.standard_normal((heads, hid)) * 0.05)
    w_out = _bf16(rng.standard_normal((heads, f, hid)) * 0.05)
    b_out = _bf16(rng.standard_normal((heads, f)) * 0.05)
    cot = _bf16(rng.standard_normal((e, heads * f)))
    return x, w_in, b_in, w_out, b_out, cot


def test_mh_network_grad_matches_jax():
    """The Function's plain forward and backward against the bf16 Pallas
    kernel (interpret mode) and against the f32 einsum path."""
    x, w_in, b_in, w_out, b_out, cot = _mh_problem(2)
    heads, hid, cat = w_in.shape
    f = w_out.shape[1]

    def pallas(x, w_in, b_in, w_out, b_out):
        win = w_in.transpose(2, 0, 1).reshape(cat, -1)
        wout = w_out.transpose(0, 2, 1).reshape(-1, f)
        return jmh.mh_network(x, win, b_in.reshape(-1), wout,
                              b_out.reshape(-1), heads=heads, hid=hid, f=f,
                              interpret=True)

    def einsum(x, w_in, b_in, w_out, b_out):
        h = jnp.einsum("bi,hji->bhj", x, w_in) + b_in
        h = jnp.where(h > 0, h, jmh.LEAKY_SLOPE * h)
        y = jnp.einsum("bhj,hoj->bho", h, w_out) + b_out
        return y.reshape(x.shape[0], -1)

    args = (x, w_in, b_in, w_out, b_out)
    port = [_t(a, torch.bfloat16, True) for a in args]
    out = mh_network.mh_network_op(
        port[0], port[1].reshape(heads * hid, cat), port[2].reshape(-1),
        port[3].reshape(heads * f, hid), port[4].reshape(-1), heads)
    assert out.dtype == torch.bfloat16 and out.shape == (x.shape[0], heads * f)
    (out.float() * _t(cot)).sum().backward()
    for fn, dt in ((pallas, BF), (einsum, jnp.float32)):
        want, vjp = jax.vjp(fn, *(jnp.asarray(a, dt) for a in args))
        assert _rel(out.detach().float(), want) < 2e-2
        for p, w in zip(port, vjp(jnp.asarray(cot, dt))):
            assert p.grad.dtype == torch.bfloat16
            assert _rel(p.grad.float(), w) < 5e-2, p.shape


@pytest.mark.parametrize("b", [96, 100])
def test_hyper_apply_grad_matches_jax(b):
    """All four inputs' gradients against the bf16 Pallas kernels (interpret
    mode) and the f32 XLA formulation; the port's k is JAX's kernel
    transposed."""
    rng = np.random.default_rng(b)
    c = i = o = 128
    f = o * i + o
    hidden = _bf16(np.tanh(rng.standard_normal((b, c))))
    kernel = _bf16(rng.standard_normal((c, f)) * 0.05)
    bias = _bf16(rng.standard_normal(f) * 0.05)
    x = _bf16(rng.standard_normal((b, i)))
    cot = _bf16(rng.standard_normal((b, o)))

    def pallas(h, k, bb, xx):
        return jhyper.hyper_apply(h, k, bb, xx, out_ch=o, interpret=True)

    def ref(h, k, bb, xx):
        p = h @ k + bb
        return (jnp.einsum("boi,bi->bo", p[:, :o * i].reshape(-1, o, i), xx)
                + p[:, o * i:])

    ph, pk, pb, px = (_t(hidden, torch.bfloat16, True),
                      _t(kernel.T, torch.bfloat16, True),
                      _t(bias, torch.bfloat16, True),
                      _t(x, torch.bfloat16, True))
    out = hyper_apply.hyper_apply_op(ph, pk, pb, px, o)
    (out.float() * _t(cot)).sum().backward()
    got = (ph.grad, pk.grad.T, pb.grad, px.grad)
    for fn, dt in ((pallas, BF), (ref, jnp.float32)):
        args = (hidden, kernel, bias, x)
        want, vjp = jax.vjp(fn, *(jnp.asarray(a, dt) for a in args))
        assert _rel(out.detach().float(), want) < 2e-2
        for g, w in zip(got, vjp(jnp.asarray(cot, dt))):
            assert g.dtype == torch.bfloat16
            assert _rel(g.float(), w) < 3e-2


@pytest.mark.parametrize("c,i,o", [(128, 128, 128), (64, 48, 16)])
def test_hyper_apply_bwd_dk_plain_matches_jax_pallas(c, i, o):
    """The dK kernel's plain version (its function on the card) against
    the Pallas dK kernel, run through cgat_tpu's _fused_bwd in interpret
    mode: dk_w (O*I, C) is JAX's dK columns [0, O*I) transposed, db_w its
    bias-grad entries [0, O*I), kept f32 by an f32 bias. B = 100 is no
    multiple of the Pallas kernel's 128-row batches.

    Tolerance: the plain version rounds each dP = g x to bf16, as the TPU
    kernel does; XLA on the CPU may keep that bf16 product in f32 (its
    excess precision), so each term may differ by dP's rounding, at most
    2**-8 |dP| (bf16's unit roundoff). Per entry, |got - want| <= 2**-8 x
    sum_b |dP| |hidden| (db_w: sum_b |dP|), plus for dk_w one bf16 step of
    the entry (2**-7) for the final rounding of both, plus 1e-6 of the
    largest entry for f32 summation order."""
    rng = np.random.default_rng(c + i + o)
    b, f = 100, o * i + o
    hidden = _bf16(np.tanh(rng.standard_normal((b, c))))
    kernel = _bf16(rng.standard_normal((c, f)) * 0.05)
    bias = rng.standard_normal(f).astype(np.float32) * 0.05
    x = _bf16(rng.standard_normal((b, i)))
    cot = _bf16(rng.standard_normal((b, o)))
    _, dk, db, _ = jhyper._fused_bwd(
        jnp.asarray(hidden, BF), jnp.asarray(kernel, BF), jnp.asarray(bias),
        jnp.asarray(x, BF), jnp.asarray(cot, BF), o, True)
    assert db.dtype == jnp.float32
    want_dk = np.asarray(dk, np.float32)[:, :o * i].T
    want_db = np.asarray(db)[:o * i]
    dk_w, db_w = hyper_apply.hyper_apply_bwd_dk_plain(
        _t(hidden, torch.bfloat16), _t(x, torch.bfloat16),
        _t(cot, torch.bfloat16), o)
    assert dk_w.dtype == torch.bfloat16 and dk_w.shape == (o * i, c)
    assert db_w.dtype == torch.float32 and db_w.shape == (o * i,)
    dp = np.abs(cot[:, :, None].astype(np.float64)
                * x[:, None, :]).reshape(b, o * i)
    err_dk = np.abs(dk_w.float().numpy() - want_dk)
    tol_dk = (2 ** -8 * (dp.T @ np.abs(hidden)) + 2 ** -7 * np.abs(want_dk)
              + 1e-6 * np.abs(want_dk).max())
    assert (err_dk <= tol_dk).all(), float((err_dk / tol_dk).max())
    err_db = np.abs(db_w.numpy() - want_db)
    tol_db = 2 ** -8 * dp.sum(0) + 1e-6 * np.abs(want_db).max()
    assert (err_db <= tol_db).all(), float((err_db / tol_db).max())
    # the differences are dP's rounding, not a different function
    assert _rel(dk_w.float(), want_dk) < 1e-2
    assert _rel(db_w, want_db) < 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_matches_jax_csr_segment_sum(dtype):
    """Every row counts, padding included, as csr_segment_sum without
    n_real does; f32 accumulation, output in the input dtype."""
    rng = np.random.default_rng(3)
    n, e_real, e_tot = 48, 700, 1024
    ids = np.sort(rng.integers(0, n, size=e_real)).astype(np.int32)
    ids = np.concatenate([ids, np.full(e_tot - e_real, n - 1, np.int32)])
    vals = _bf16(rng.standard_normal((e_tot, 128)))
    want = np.asarray(csr_segment_sum(
        jnp.asarray(vals, getattr(jnp, dtype)), jnp.asarray(ids), n,
        out_dtype=jnp.float32, interpret=True))
    got = segment_sum.segment_sum(
        _t(vals, getattr(torch, dtype)), torch.from_numpy(ids),
        torch.from_numpy(host_offsets(ids, n)), n)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("which", ["dst", "src", "pool"])
def test_gather_rows_grad_matches_jax(which):
    """The three gathers of the model, with the batch's plans, against
    cgat_tpu's gather_rows with its GatherPlan (Pallas backward in
    interpret mode), f32 at 1e-5."""
    graphs = dict(n_atoms_range=(3, 9), max_nbr=6, orig_fea=8)
    jb = jcollate(jrandom_graphs(4, 6, **graphs), max_nbr=6, node_bucket=16)
    b = collate(random_graphs(4, 6, **graphs), max_nbr=6, node_bucket=16)
    if which == "dst":
        jplan = (jb.edge_dst, dict(offn=jb.edge_dst_offn))
        plan = GatherPlan(b.edge_dst, None, b.edge_dst_offn)
        idx, rows = b.edge_dst, b.num_node_slots
    elif which == "src":
        jplan = (jb.edge_src, dict(perm=jb.edge_src_perm,
                                   sidx=jb.edge_src_sorted,
                                   offn=jb.edge_src_offn))
        plan = GatherPlan(b.edge_src_sorted, b.edge_src_perm, b.edge_src_offn)
        idx, rows = b.edge_src, b.num_node_slots
    else:
        jplan = (jb.node2graph, dict(offn=jb.node2graph_offn))
        plan = GatherPlan(b.node2graph, None, b.node2graph_offn)
        idx, rows = b.node2graph, b.num_graphs
    rng = np.random.default_rng(5)
    table = rng.standard_normal((rows, 128)).astype(np.float32)
    cot = rng.standard_normal((idx.shape[0], 128)).astype(np.float32)
    old = jatt.get_backend()
    jatt.set_backend("pallas")
    try:
        p = jgather.GatherPlan.build(jnp.asarray(jplan[0]), rows,
                                     **{k: jnp.asarray(v)
                                        for k, v in jplan[1].items()})
        want = jax.grad(lambda t: jnp.sum(jgather.gather_rows(
            t, jnp.asarray(jplan[0]), plan=p) * cot))(jnp.asarray(table))
    finally:
        jatt.set_backend(old)
    t = _t(table, grad=True)
    out = gather_rows(t, idx, plan)
    torch.testing.assert_close(out.detach(), _t(table[idx.numpy()]))
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


TINY = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
            nbr_embedding_size=8, neighbor_number=6, msg_heads=2,
            n_graph_roost=1, out_hidden=(32, 32, 16))


@pytest.mark.parametrize("damping", [1.7, -0.4, 0.3])
def test_damping_grad_matches_jax(damping):
    """HNet's damping is a straight-through clip: outside [0, 1] its value
    is clamped and its gradient is that of the clamped value, not 0."""
    jb = jcollate(jrandom_graphs(6, 5, n_atoms_range=(3, 7), max_nbr=6,
                                 orig_fea=16), max_nbr=6, node_bucket=8)
    b = collate(random_graphs(6, 5, n_atoms_range=(3, 7), max_nbr=6,
                              orig_fea=16), max_nbr=6, node_bucket=8)
    jmodel = JNet(JConfig(**TINY))
    params = init_params_host(jmodel, jb, seed=6)
    params["graph_1_Node"]["Pooling_NN"]["damping"] = np.full(
        (1,), damping, np.float32)
    cot = np.random.default_rng(7).standard_normal((5, 2)).astype(np.float32)

    def loss(d):
        p = jax.tree.map(lambda a: a, params)
        p["graph_1_Node"]["Pooling_NN"]["damping"] = d
        return jnp.sum(jmodel.apply({"params": p}, jb)[:5] * cot)
    want = float(jax.grad(loss)(jnp.full((1,), damping, jnp.float32))[0])
    cfg = CGATConfig(**TINY)
    model = CGAtNet(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    (model(b)[:5] * _t(cot)).sum().backward()
    got = float(model.graphs[1].Node.Pooling_NN.damping.grad[0])
    assert want != 0.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_kernel_gates_are_the_forwards():
    """The backward kernels take every width the forward kernels take, so
    the gates are the forwards' own (one forward block's shared memory) and
    a model that serves through a kernel trains through it too: widths past
    a 256-wide hypernetwork hidden layer and 8 x 272 hidden columns of the
    MH network pass."""
    bf = torch.bfloat16
    for c, i, o in ((128, 128, 128), (384, 384, 384), (512, 160, 32),
                    (1024, 128, 128), (1408, 16, 16)):
        assert hyper_apply.supported(c, i, o, bf)
    assert not hyper_apply.supported(1424, 16, 16, bf)   # forward's limit
    for cat, hid, f, heads in ((384, 256, 128, 5), (144, 272, 160, 8),
                               (128, 256, 2048, 16), (896, 816, 16, 1)):
        assert mh_network.supported(cat, hid, f, heads, bf)
    assert not mh_network.supported(896, 832, 16, 1, bf)  # forward's limit
