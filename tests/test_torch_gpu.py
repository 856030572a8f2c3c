"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and nvcc and skips without them. This
file imports no JAX, so it also runs where JAX is absent; the directory's
``conftest.py`` imports JAX, so on such a machine run it without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: f32 results differ from the plain version only in summation
order (rtol 1e-5); bf16 outputs may differ by one rounding step of the
f32 result (2**-8 relative), so they are held at 2e-2 of the largest entry
elementwise and, so that small entries count too, at 1e-2 norm-wise.
"""
import numpy as np
import pytest
import torch

from cgat_tpu_torch.data import collate, host_offsets
from cgat_tpu_torch.data.synthetic import (SEGMENT_LAYOUTS, random_graphs,
                                           segment_layout)
from cgat_tpu_torch.models import CGATConfig, CGAtNet, init_state_dict
from cgat_tpu_torch.ops.kernels import (KERNEL_WRAPPERS, dropout,
                                        hyper_apply, mh_network,
                                        segment_attention, segment_sum)
from cgat_tpu_torch.training import Trainer, TrainerConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    return {k.__name__: k.launches for k in KERNEL_WRAPPERS}


def _seg_case(rng, hf, num_nodes=300, n_pad=40):
    """Destination-sorted rows with empty nodes, a 150-row hub and a padded
    suffix pointing at the last node slot."""
    deg = rng.integers(0, 6, size=num_nodes)
    deg[rng.choice(num_nodes, 30, replace=False)] = 0
    deg[17] = 150
    deg[-1] = 0
    dst = np.repeat(np.arange(num_nodes), deg).astype(np.int32)
    n_real = len(dst)
    dst = np.concatenate([dst, np.full(n_pad, num_nodes - 1, np.int32)])
    alpha = rng.standard_normal((len(dst), hf)) * 3
    m = rng.standard_normal((len(dst), hf))
    return alpha, m, host_offsets(dst, num_nodes + 8), n_real


def _layout_case(rng, hf, layout):
    """``_seg_case`` (``hub``) or one of ``segment_layout``'s layouts, with
    random rows of width ``hf``."""
    if layout == "hub":
        return (*_seg_case(rng, hf), 300)
    offn, n_real, num_nodes = segment_layout(layout)
    e = int(offn[-1])
    alpha = rng.standard_normal((e, hf), dtype=np.float32) * 3
    m = rng.standard_normal((e, hf), dtype=np.float32)
    return alpha, m, offn, n_real, num_nodes


@pytest.mark.parametrize("layout", ["hub", *SEGMENT_LAYOUTS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hf", [640, 6, 13])
def test_segment_attention_kernel(dev, dtype, hf, layout):
    """Each layout against the plain version: out, the exact max, den.
    Rows of whole 16-byte groups (640) take the stream kernel, 6 and 13
    (odd) the per-node kernel, each counted under its own counter; the
    same bits twice, and without the stats."""
    alpha, m, offn, n_real, n = _layout_case(np.random.default_rng(0), hf,
                                             layout)
    args = (torch.tensor(alpha, dtype=dtype, device=dev),
            torch.tensor(m, dtype=dtype, device=dev),
            torch.from_numpy(offn).to(dev),
            torch.tensor(n_real, dtype=torch.int32, device=dev), n)
    sk = segment_attention.segment_attention
    before = (sk.launches, sk.stream_launches, sk.per_node_launches)
    out, mx, den = sk(*args, return_stats=True)
    stream = hf == 640
    assert (sk.launches, sk.stream_launches, sk.per_node_launches) == (
        before[0] + 1, before[1] + stream, before[2] + (not stream))
    p_out, p_mx, p_den = segment_attention.segment_attention_plain(*args)
    assert out.dtype == dtype and mx.dtype == den.dtype == torch.float32
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), p_out.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(mx, p_mx, rtol=0, atol=0)
    torch.testing.assert_close(den, p_den, rtol=1e-5, atol=1e-6)
    empty = torch.from_numpy(np.diff(np.minimum(offn[:n + 1], n_real)) == 0)
    assert empty.any() and not out[empty.to(dev)].float().abs().any()
    again = sk(*args, return_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, mx, den)))
    assert torch.equal(sk(*args), out)


@pytest.mark.parametrize("rows,cat,hid,f,heads",
                         [(1000, 384, 256, 128, 5), (37, 48, 32, 16, 2),
                          (300, 384, 80, 128, 5), (500, 64, 128, 16, 2),
                          (0, 384, 256, 128, 5), (200, 896, 816, 16, 1),
                          (150, 128, 256, 2048, 16)])
def test_mh_network_kernel(dev, rows, cat, hid, f, heads):
    """Row counts that are no multiple of the 128-row tile (1000, 37, 300,
    500, 200, 150) and none; cat and hid below one 64-wide K box (48, 32);
    hid = 80, where a head's second K box would run into the next head's
    columns of h; F = 16 with 2 heads, where a 128-row box of Wout would
    run into the next head's rows; and the widest widths the gate takes.
    Both forms (h as scratch, h returned), h against the plain version's,
    and the same bits in two launches."""
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                               * scale).bfloat16()
    args = (r(rows, cat), r(heads * hid, cat, scale=cat ** -0.5),
            r(heads * hid, scale=0.1), r(heads * f, hid, scale=hid ** -0.5),
            r(heads * f, scale=0.1), heads)
    assert mh_network.supported(cat, hid, f, heads, torch.bfloat16)
    before = _launches()
    got = mh_network.mh_network(*args)
    got_out, got_h = mh_network.mh_network(*args, return_hidden=True)
    assert _launches()["mh_network"] == before["mh_network"] + 2
    want, want_h = mh_network.mh_network_plain(*args, return_hidden=True)
    assert got.shape == got_out.shape == (rows, heads * f)
    assert got_h.shape == (rows, heads * hid)
    assert got.dtype == got_h.dtype == torch.bfloat16
    if rows:
        _close(got, want, torch.bfloat16)
        _close(got_out, want, torch.bfloat16)
        _close(got_h, want_h, torch.bfloat16)
    assert torch.equal(got, got_out)
    again, again_h = mh_network.mh_network(*args, return_hidden=True)
    assert torch.equal(again, got_out) and torch.equal(again_h, got_h)


@pytest.mark.parametrize("rows,c,i,o", [(100, 128, 128, 128), (7, 64, 32, 48),
                                        (768, 128, 128, 128),
                                        (832, 128, 128, 128),
                                        (300, 128, 384, 48),
                                        (200, 1408, 16, 16),
                                        (70, 48, 64, 32),
                                        (129, 64, 48, 32),
                                        (300, 128, 64, 208),
                                        (2000, 64, 32, 512)])
def test_hyper_apply_kernel(dev, rows, c, i, o):
    """The shapes of the serving forward (768 and 832 rows, C = I = O =
    128; 832 leaves 64 live rows in the last 128-row tile); I = 384, three
    128-column tiles of I per output; C = 1,408, the gate's edge, with
    I = O = 16; C = 48, a last k-block narrower than 64; I = 48 and 32,
    where the bias slot's columns past I hold stale bytes; O = 208, which
    the plan's groups do not divide evenly; and O = 512 at 2,000 rows,
    groups of the kernel's most outputs (32, four tail products) and more
    units than one wave. The same bits in two launches."""
    assert hyper_apply.supported(c, i, o, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    hidden = torch.randn(rows, c, generator=g, device=dev).tanh().bfloat16()
    k = (torch.randn(o * i + o, c, generator=g, device=dev)
         * (0.1 * (2 / c) ** 0.5)).bfloat16()
    bias = (torch.rand(o * i + o, generator=g, device=dev) * 0.1).bfloat16()
    x = torch.randn(rows, i, generator=g, device=dev).bfloat16()
    before = _launches()
    got = hyper_apply.hyper_apply(hidden, k, bias, x, o)
    assert _launches()["hyper_apply"] == before["hyper_apply"] + 1
    want = hyper_apply.hyper_apply_plain(hidden, k, bias, x, o)
    assert got.shape == (rows, o) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2 * float(want.float().abs().max()))
    _close(got, want, torch.bfloat16)
    assert torch.equal(hyper_apply.hyper_apply(hidden, k, bias, x, o), got)


def _close(got, want, dtype):
    """f32: summation order only; bf16: one rounding step of the f32 value
    relative to the largest entry, and 1e-2 of the norm."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, rtol=2e-2,
                                   atol=2e-2 * float(want.abs().max()))
        assert float(torch.linalg.vector_norm(got - want)) <= 1e-2 * float(
            torch.linalg.vector_norm(want))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hf", [640, 6])
def test_segment_attention_bwd_kernel(dev, dtype, hf):
    """Empty nodes, a 150-edge hub and a padded suffix, which gets 0."""
    alpha, m, offn, n_real = _seg_case(np.random.default_rng(2), hf)
    dst = np.repeat(np.arange(300), np.diff(offn[:301])).astype(np.int32)
    t = lambda a, dt=dtype: torch.tensor(a, dtype=dt, device=dev)
    a, mm = t(alpha), t(m)
    nr = torch.tensor(n_real, dtype=torch.int32, device=dev)
    out, mx, den = segment_attention.segment_attention(
        a, mm, torch.from_numpy(offn).to(dev), nr, 300, return_stats=True)
    g = t(np.random.default_rng(3).standard_normal((300, hf)))
    args = (a, mm, torch.from_numpy(dst).to(dev), nr, g, out, mx, den)
    before = segment_attention.segment_attention_bwd.launches
    got = segment_attention.segment_attention_bwd(*args)
    assert segment_attention.segment_attention_bwd.launches == before + 1
    want = segment_attention.segment_attention_bwd_plain(*args)
    for x, y in zip(got, want):
        _close(x, y, dtype)
        assert not x[n_real:].float().abs().any()


def _segsum_ids(case, rng):
    """Sorted segment ids and the segment count of a test case."""
    if case == "mixed":       # empty segments; a padded suffix on the last
        ids = np.sort(rng.integers(0, 99, size=3000) * 2)
        return np.concatenate([ids, np.full(40, 199)]), 200
    if case == "hub":         # one segment holds most rows
        return np.concatenate([np.zeros(5000, int), np.arange(1, 50)]), 60
    if case == "empty_runs":  # long runs of empty segments
        return np.array([3] * 7 + [400] * 5 + [401] + [900] * 2), 1000
    if case == "tiny":        # fewer rows than one warp covers
        return np.array([0, 0, 1, 2, 2]), 4
    # the crystal pool's shape: 64 segments of 8 to 16 atoms
    return np.repeat(np.arange(64), rng.integers(8, 17, 64)), 64


@pytest.mark.parametrize("case", ["mixed", "hub", "empty_runs", "tiny",
                                  "pool"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f", [128, 6])
def test_segment_sum_kernel(dev, dtype, f, case):
    """Sorted ids with empty segments; every row counts, padding included."""
    rng = np.random.default_rng(4)
    ids, n_seg = _segsum_ids(case, rng)
    ids = ids.astype(np.int32)
    offn = host_offsets(ids, n_seg + 8)
    vals = torch.tensor(rng.standard_normal((len(ids), f)), dtype=dtype,
                        device=dev)
    tid = torch.from_numpy(ids).to(dev)
    before = segment_sum.segment_sum.launches
    got = segment_sum.segment_sum(vals, tid, torch.from_numpy(offn).to(dev),
                                  n_seg)
    assert segment_sum.segment_sum.launches == before + 1
    if dtype == torch.float32 and case == "hub":
        # 5000 rows in one f32 sum: two summation orders differ by more
        # than rtol allows, so the kernel is held to the exact (f64) sum.
        # Even a sequential f32 sum of these rows is off by only ~2e-4
        # (u n / sqrt(2), u = 2**-24); the kernel's tree was 3.9e-5 off on
        # the H100. One row dropped or counted twice moves a sum by |x|,
        # which at F = 6 exceeds 1e-3 in some column all but ~1e-18 of the
        # time.
        exact = torch.zeros((n_seg, f), dtype=torch.float64,
                            device=dev).index_add_(0, tid.long(),
                                                   vals.double())
        torch.testing.assert_close(got.double(), exact, rtol=0, atol=1e-3)
    else:
        _close(got, segment_sum.segment_sum_plain(vals, tid, n_seg), dtype)
    empty = torch.from_numpy(np.bincount(ids, minlength=n_seg) == 0).to(dev)
    assert not got[empty].float().abs().any()


@pytest.mark.parametrize("rows,cat,hid,f,heads",
                         [(1000, 384, 256, 128, 5), (37, 48, 32, 16, 2),
                          (100, 144, 272, 160, 8), (1, 384, 256, 128, 5),
                          (129, 384, 256, 128, 5), (1, 16, 16, 16, 1),
                          (18432, 384, 256, 128, 5), (18433, 384, 256, 128, 5),
                          (600, 64, 256, 32, 72)])
def test_mh_network_bwd_kernel(dev, rows, cat, hid, f, heads):
    """Row counts that are no multiple of the 128-row tile (1000, 129, 37,
    100) and a single row; widths that are no multiple of the 64-wide
    boxes or the 128-wide tiles (F = 160, hid = 272, cat = 144: a head's
    box runs past its edge); 8 x 272 hidden columns; one head of 16. The
    training step's shape (18,432 rows); 18,433 rows, whose last pass-A
    range ends in a tile of one row; 72 heads, more (head, hid tile) units
    than the card has SMs, so that blocks run several units. F = 160 takes
    the old split (dpre and dWout as two products), the others pass A.
    Two launches give the same bits."""
    g = torch.Generator(device=dev).manual_seed(5)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                               * scale).bfloat16()
    x, win, b_in = (r(rows, cat), r(heads * hid, cat, scale=cat ** -0.5),
                    r(heads * hid, scale=0.1))
    wout, b_out = r(heads * f, hid, scale=hid ** -0.5), r(heads * f, scale=0.1)
    out, h = mh_network.mh_network(x, win, b_in, wout, b_out, heads,
                                   return_hidden=True)
    p_out, p_h = mh_network.mh_network_plain(x, win, b_in, wout, b_out,
                                             heads, return_hidden=True)
    _close(out, p_out, torch.bfloat16)
    _close(h, p_h, torch.bfloat16)
    cot = r(rows, heads * f)
    before = mh_network.mh_network_bwd.launches
    got = mh_network.mh_network_bwd(x, h, cot, win, wout, heads)
    assert mh_network.mh_network_bwd.launches == before + 1
    want = mh_network.mh_network_bwd_plain(x, h, cot, win, wout, heads)
    for a, b in zip(got, want):
        _close(a, b, torch.bfloat16)
    again = mh_network.mh_network_bwd(x, h, cot, win, wout, heads)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("rows,c,i,o", [(100, 128, 128, 128), (7, 64, 32, 48),
                                        (70, 48, 16, 16), (70, 512, 160, 32),
                                        (100, 384, 384, 384),
                                        (768, 128, 128, 128),
                                        (1, 128, 128, 128),
                                        (129, 128, 128, 128),
                                        (200, 256, 48, 32)])
def test_hyper_apply_bwd_kernels(dev, rows, c, i, o):
    """Every width the forward takes: I = 16, 32 and 48, whose K_o box and
    dK tile run past its output's rows; I = 160 and 384 and C = 256 and
    512, several 128-column tiles of I and of C (dK's db comes from the
    first C tile's); C = 48, below one 64-wide box; the training step's
    shape (768 rows) and row counts that are no multiple of the 128-row
    tile or of dK's 64-row k-blocks (1, 7, 70, 100, 129, 200)."""
    assert hyper_apply.supported(c, i, o, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(6)
    hidden = torch.randn(rows, c, generator=g, device=dev).tanh().bfloat16()
    k = (torch.randn(o * i + o, c, generator=g, device=dev)
         * (0.1 * (2 / c) ** 0.5)).bfloat16()
    bias = (torch.rand(o * i + o, generator=g, device=dev) * 0.1).bfloat16()
    x = torch.randn(rows, i, generator=g, device=dev).bfloat16()
    cot = torch.randn(rows, o, generator=g, device=dev).bfloat16()
    before = _launches()
    got = hyper_apply.hyper_apply_bwd_dhdx(hidden, k, bias, x, cot, o)
    got_k = hyper_apply.hyper_apply_bwd_dk(hidden, x, cot, o)
    after = _launches()
    assert after["hyper_apply_bwd_dhdx"] == before["hyper_apply_bwd_dhdx"] + 1
    assert after["hyper_apply_bwd_dk"] == before["hyper_apply_bwd_dk"] + 1
    want = hyper_apply.hyper_apply_bwd_dhdx_plain(hidden, k, bias, x, cot, o)
    want_k = hyper_apply.hyper_apply_bwd_dk_plain(hidden, x, cot, o)
    for a, b in zip(got, want):
        _close(a, b, torch.bfloat16)
    _close(got_k[0], want_k[0], torch.bfloat16)
    torch.testing.assert_close(got_k[1], want_k[1], rtol=1e-5, atol=1e-4)


def test_redesigned_kernels_are_deterministic(dev):
    """No atomics: two launches on the same inputs give the same bits, at
    the step's shapes (E rows split over the weight-grad GEMMs)."""
    g = torch.Generator(device=dev).manual_seed(7)
    rows, cat, hid, f, heads = 3000, 384, 256, 128, 5
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev)
                               * scale).bfloat16()
    x, win = r(rows, cat), r(heads * hid, cat, scale=cat ** -0.5)
    wout = r(heads * f, hid, scale=hid ** -0.5)
    _, h = mh_network.mh_network(x, win, r(heads * hid, scale=0.1), wout,
                                 r(heads * f, scale=0.1), heads,
                                 return_hidden=True)
    cot = r(rows, heads * f)
    first = mh_network.mh_network_bwd(x, h, cot, win, wout, heads)
    second = mh_network.mh_network_bwd(x, h, cot, win, wout, heads)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    ids = np.repeat(np.arange(768), 24).astype(np.int32)
    offn = torch.from_numpy(host_offsets(ids, 776)).to(dev)
    tid = torch.from_numpy(ids).to(dev)
    vals = r(len(ids), 128)
    assert torch.equal(segment_sum.segment_sum(vals, tid, offn, 768),
                       segment_sum.segment_sum(vals, tid, offn, 768))
    # hyper_apply_bwd_dhdx at the training step's shape: every output group
    # writes its own partial planes, which one reduce adds in order
    b = c = i = o = 128
    b = 768
    hidden, k = r(b, c).tanh(), r(o * i + o, c, scale=0.1 * (2 / c) ** 0.5)
    args = (hidden, k, r(o * i + o, scale=0.1), r(b, i), r(b, o), o)
    first = hyper_apply.hyper_apply_bwd_dhdx(*args)
    second = hyper_apply.hyper_apply_bwd_dhdx(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    # hyper_apply at the same shape: each unit adds its rows' products in a
    # fixed order and stores its outputs once
    fargs = args[:4] + (o,)
    assert torch.equal(hyper_apply.hyper_apply(*fargs),
                       hyper_apply.hyper_apply(*fargs))
    # hyper_apply_bwd_dk at the same shape: each tile writes its dK tile
    # once, and db sums in a fixed order
    args = (hidden, args[3], args[4], o)
    first = hyper_apply.hyper_apply_bwd_dk(*args)
    second = hyper_apply.hyper_apply_bwd_dk(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_kernels_launch_on_the_tensors_device(dev):
    """Every kernel on cuda:1 tensors while cuda:0 is current: each launch
    makes its tensors' device current and the GEMM kernels' per-device
    state (SM count, shared-memory limit) is set on that device; device 0
    stays current after."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    g = torch.Generator(device=d1).manual_seed(8)
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=d1)
                               * scale).bfloat16()
    before = _launches()
    # mh_network, forward and backward
    x, win, b_in = r(300, 48), r(64, 48, scale=0.1), r(64, scale=0.1)
    wout, b_out = r(32, 32, scale=0.2), r(32, scale=0.1)
    out, h = mh_network.mh_network(x, win, b_in, wout, b_out, 2,
                                   return_hidden=True)
    for a, b in zip((out, h), mh_network.mh_network_plain(
            x, win, b_in, wout, b_out, 2, return_hidden=True)):
        _close(a, b, torch.bfloat16)
    cot = r(300, 32)
    for a, b in zip(mh_network.mh_network_bwd(x, h, cot, win, wout, 2),
                    mh_network.mh_network_bwd_plain(x, h, cot, win, wout, 2)):
        _close(a, b, torch.bfloat16)
    # hyper_apply, its two backward kernels
    o, i, c = 48, 32, 64
    hidden, k = r(100, c).tanh(), r(o * i + o, c, scale=0.02)
    bias, xi, cot = r(o * i + o, scale=0.1), r(100, i), r(100, o)
    _close(hyper_apply.hyper_apply(hidden, k, bias, xi, o),
           hyper_apply.hyper_apply_plain(hidden, k, bias, xi, o),
           torch.bfloat16)
    for a, b in zip(
            hyper_apply.hyper_apply_bwd_dhdx(hidden, k, bias, xi, cot, o),
            hyper_apply.hyper_apply_bwd_dhdx_plain(hidden, k, bias, xi, cot,
                                                   o)):
        _close(a, b, torch.bfloat16)
    _close(hyper_apply.hyper_apply_bwd_dk(hidden, xi, cot, o)[0],
           hyper_apply.hyper_apply_bwd_dk_plain(hidden, xi, cot, o)[0],
           torch.bfloat16)
    # segment_attention, forward and backward; segment_sum
    alpha, m, offn, n_real = _seg_case(np.random.default_rng(9), 64)
    ids = torch.from_numpy(np.repeat(np.arange(300), np.diff(offn[:301]))
                           .astype(np.int32)).to(d1)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=d1)
    offn, nr = torch.from_numpy(offn).to(d1), torch.tensor(
        n_real, dtype=torch.int32, device=d1)
    sa = (t(alpha), t(m), offn, nr, 300)
    got = segment_attention.segment_attention(*sa, return_stats=True)
    want = segment_attention.segment_attention_plain(*sa)
    _close(got[0], want[0], torch.float32)
    bwd = (t(alpha), t(m), ids, nr, t(np.ones((300, 64))), *got)
    for a, b in zip(segment_attention.segment_attention_bwd(*bwd),
                    segment_attention.segment_attention_bwd_plain(*bwd)):
        _close(a, b, torch.float32)
    vals = t(m)
    _close(segment_sum.segment_sum(vals, ids, offn, 300),
           segment_sum.segment_sum_plain(vals, ids, 300), torch.float32)
    # dropout, forward and backward
    step = torch.tensor(3, dtype=torch.int64, device=d1)
    for fn in (dropout.dropout, dropout.dropout_bwd):
        assert torch.equal(fn(vals, 0.2, (1, 2), step),
                           dropout.dropout_plain(vals, 0.2, (1, 2), step))
    assert torch.cuda.current_device() == 0
    assert all(v - before[k] == 1 for k, v in _launches().items())


def test_mh_network_bwd_refuses_a_plan_for_another_tiling(dev, monkeypatch):
    """The library owns the tile size: a plan made for 64-row tiles has
    twice the bias partials' rows and is refused before any launch."""
    x = torch.zeros(300, 16, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(16, 16, device=dev, dtype=torch.bfloat16)
    g = torch.zeros(300, 16, device=dev, dtype=torch.bfloat16)
    mh_network.mh_network_bwd(x, x, g, w, w, 1)
    monkeypatch.setattr(mh_network, "TILE", 64)
    with pytest.raises(RuntimeError, match="invalid argument"):
        mh_network.mh_network_bwd(x, x, g, w, w, 1)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(64, 48, device=dev)
    w_in, w_out = torch.zeros(64, 48, device=dev), torch.zeros(32, 32, device=dev)
    b_in, b_out = torch.zeros(64, device=dev), torch.zeros(32, device=dev)
    with pytest.raises(ValueError):       # f32 is not a kernel dtype
        mh_network.mh_network(x, w_in, b_in, w_out, b_out, 2)
    h = torch.zeros(8, 64, device=dev, dtype=torch.bfloat16)
    k = torch.zeros(32 * 16 + 16, 64, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(32 * 16 + 16, device=dev, dtype=torch.bfloat16)
    xt = torch.zeros(32, 8, device=dev, dtype=torch.bfloat16).T
    with pytest.raises(ValueError):       # non-contiguous input
        hyper_apply.hyper_apply(h, k, b, xt, 16)
    a = torch.zeros(10, 8, device=dev)
    with pytest.raises(ValueError):       # int64 CSR pointers
        segment_attention.segment_attention(
            a, a, torch.zeros(5, dtype=torch.int64, device=dev),
            torch.tensor(10, dtype=torch.int32, device=dev), 4)
    ids = torch.zeros(10, dtype=torch.int32, device=dev)
    nr = torch.tensor(10, dtype=torch.int32, device=dev)
    node = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError):       # a bf16 max, not the f32 one
        segment_attention.segment_attention_bwd(
            a, a, ids, nr, node, node, node.bfloat16(), node)
    with pytest.raises(ValueError):       # int64 CSR pointers
        segment_sum.segment_sum(a, ids, torch.zeros(5, dtype=torch.int64,
                                                    device=dev), 4)
    with pytest.raises(ValueError):       # f32 is not a kernel dtype
        mh_network.mh_network_bwd(x, torch.zeros(64, 64, device=dev),
                                  torch.zeros(64, 32, device=dev), w_in,
                                  w_out, 2)
    odd = torch.zeros(8, 40, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):       # no 16-multiple width
        hyper_apply.hyper_apply_bwd_dk(odd, h[:, :32].contiguous(),
                                       torch.zeros(8, 16, device=dev,
                                                   dtype=torch.bfloat16), 16)


# 128-wide, 2 layers, 5 heads: every kernel engages in bf16
SMALL = dict(orig_elem_fea_len=16, elem_fea_len=128, n_graph=2,
             nbr_embedding_size=128, neighbor_number=16, msg_heads=5,
             n_graph_roost=1, out_hidden=(64, 32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_model_on_card_matches_cpu(dev, dtype):
    """The forward on the card against the same forward on the CPU (plain
    versions). bf16: all three kernels, 2 + 1 + 4 launches per layer plus
    the crystal pool; f32: the segment-attention kernel only."""
    cfg = CGATConfig(**SMALL, compute_dtype=dtype)
    cpu = CGAtNet(cfg)
    cpu.load_state_dict(init_state_dict(cpu, seed=0), strict=True)
    cpu.to_compute_dtype().eval()
    card = CGAtNet(cfg)
    card.load_state_dict(cpu.state_dict(), strict=True)
    card = card.to_compute_dtype().to(dev).eval()
    batch = collate(random_graphs(0, 6, n_atoms_range=(5, 9), max_nbr=16,
                                  orig_fea=16, full_degree=True),
                    max_nbr=16, node_bucket=16)
    before = _launches()
    with torch.inference_mode():
        got = card(batch.to(dev)).cpu()
        want = cpu(batch)
    n = cfg.n_graph
    per_layer = dict.fromkeys(_launches(), 0)     # no backward in inference
    per_layer.update({"mh_network": 2 * n, "segment_attention": n + 1,
                      "hyper_apply": 4 * n} if dtype == "bfloat16" else
                     {"segment_attention": n + 1})
    assert {k: v - before[k] for k, v in _launches().items()} == per_layer
    assert torch.isfinite(got).all()
    if dtype == "bfloat16":
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=5e-2, atol=5e-2 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=1e-5)


def test_train_step_on_card_matches_cpu(dev):
    """One bf16 training step of the 2-layer model on the card against the
    same step on the CPU (plain versions): the loss before the update
    agrees, every backward kernel runs its count, the grads are finite."""
    graphs = random_graphs(1, 30, n_atoms_range=(5, 9), max_nbr=16,
                           orig_fea=16, full_degree=True)
    cfg = TrainerConfig(batch_size=6, node_bucket=16, max_nbr=16,
                        moment_dtype="bfloat16")
    mcfg = CGATConfig(**SMALL, compute_dtype="bfloat16")
    cpu = Trainer(cfg, mcfg, graphs, device="cpu")
    card = Trainer(cfg, mcfg, graphs, device=dev)
    sd = init_state_dict(cpu.init_state(), seed=0)
    cpu.init_state(sd)
    card.init_state(sd)
    batch = next(iter(cpu.loader(cpu.train_graphs, shuffle=True)))
    with torch.no_grad():
        want, _ = cpu.forward_loss(batch)
    before = _launches()
    loss, _ = card.forward_loss(batch.to(dev))
    card.backward(loss)
    n = mcfg.n_graph
    assert {k: v - before[k] for k, v in _launches().items()} == {
        "segment_attention": n + 1, "mh_network": 2 * n,
        "hyper_apply": 4 * n, "segment_attention_bwd": n + 1,
        "mh_network_bwd": 2 * n, "hyper_apply_bwd_dhdx": 4 * n,
        "hyper_apply_bwd_dk": 4 * n, "segment_sum": 2 * n + 1,
        "dropout": 0, "dropout_bwd": 0}
    grads = [p.grad for p in card.model.parameters() if p.grad is not None]
    assert all(g.dtype == torch.float32 for g in grads)
    assert torch.isfinite(torch.stack(torch._foreach_norm(grads))).all()
    card.apply_update()
    torch.testing.assert_close(loss.detach().cpu(), want, rtol=5e-2,
                               atol=5e-2)


def test_cli_train_and_resume_on_card(dev, tmp_path):
    """``cli.prepare`` -> ``cli.train --smoke-test`` on the card (its
    default device) -> the checkpoint loads onto the card -> ``--ckp``
    continues at epoch 2; every kernel launches, the metrics are finite."""
    import gzip
    import json
    import pickle

    from cgat_tpu_torch.cli import prepare as cli_prepare
    from cgat_tpu_torch.cli import train as cli_train
    from cgat_tpu_torch.data.structures import random_structures
    from cgat_tpu_torch.training import load_trainer

    with gzip.open(tmp_path / "s.pickle.gz", "wb") as f:
        pickle.dump(random_structures(1, 40), f)
    assert cli_prepare.main(["--file", "s.pickle.gz", "--source-dir",
                             str(tmp_path), "--target-dir", str(tmp_path),
                             "--target-file", "p.pickle.gz",
                             "--max-nbr", "16"]) == 0
    flags = ["--atom-fea-len", "128", "--n-graph", "2",
             "--nbr-embedding-size", "128", "--msg-heads", "5",
             "--n-graph-roost", "1", "--max-nbr", "16", "--batch-size", "6",
             "--node-bucket", "16", "--target", "e_above_hull"]
    before = _launches()
    assert cli_train.main(["--data-path", str(tmp_path / "p.pickle.gz"),
                           "--smoke-test", "--ckpt-dir", str(tmp_path),
                           "--run-name", "r", *flags]) == 0
    # every kernel but dropout's (the model has none)
    assert all(v > before[k] for k, v in _launches().items()
               if not k.startswith("dropout"))
    run = tmp_path / "runs" / "r"
    trainer, meta = load_trainer(str(run), tag="last")
    assert meta["epoch"] == 1
    assert all(p.device.type == "cuda" for p in trainer.model.parameters())
    assert cli_train.main(["--ckp", str(run), "--epochs", "3"]) == 0
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in recs if "train_loss" in r] == [0, 1, 2]
    assert all(np.isfinite(v) for r in recs for v in r.values())


@pytest.mark.parametrize("rows", [18432, 19968])
def test_hyper_apply_kernels_at_edge_rows(dev, rows):
    """The hyper-edge model's edge HNets at the reference width: 24 edge
    rows a node slot at 768 and 832 node slots, C = I = O = 128, 144 and
    156 row tiles, so the persistent forward and dh/dx kernels each walk
    several units a CTA. Forward, dh/dx and dK against their plain
    versions, and the same bits in two launches."""
    c = i = o = 128
    g = torch.Generator(device=dev).manual_seed(11)
    hidden = torch.randn(rows, c, generator=g, device=dev).tanh().bfloat16()
    k = (torch.randn(o * i + o, c, generator=g, device=dev)
         * (0.1 * (2 / c) ** 0.5)).bfloat16()
    bias = (torch.rand(o * i + o, generator=g, device=dev) * 0.1).bfloat16()
    x = torch.randn(rows, i, generator=g, device=dev).bfloat16()
    cot = torch.randn(rows, o, generator=g, device=dev).bfloat16()
    got = hyper_apply.hyper_apply(hidden, k, bias, x, o)
    _close(got, hyper_apply.hyper_apply_plain(hidden, k, bias, x, o),
           torch.bfloat16)
    assert torch.equal(hyper_apply.hyper_apply(hidden, k, bias, x, o), got)
    got = hyper_apply.hyper_apply_bwd_dhdx(hidden, k, bias, x, cot, o)
    want = hyper_apply.hyper_apply_bwd_dhdx_plain(hidden, k, bias, x, cot, o)
    for a, b in zip(got, want):
        _close(a, b, torch.bfloat16)
    del want
    again = hyper_apply.hyper_apply_bwd_dhdx(hidden, k, bias, x, cot, o)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    got = hyper_apply.hyper_apply_bwd_dk(hidden, x, cot, o)
    want = hyper_apply.hyper_apply_bwd_dk_plain(hidden, x, cot, o)
    _close(got[0], want[0], torch.bfloat16)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-3)
    again = hyper_apply.hyper_apply_bwd_dk(hidden, x, cot, o)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_hyper_edge_train_step_launch_counts(dev):
    """One bf16 training step of the 2-layer hyper-edge model on the card:
    the first layer's edge HNets and gathers (the last layer's edge update
    feeds nothing and is skipped) add 4 hyper_apply launches to the
    forward and 4 dh/dx, 4 dK and 2 segment sums to the backward;
    the loss agrees with the CPU's and the grads are finite."""
    graphs = random_graphs(2, 30, n_atoms_range=(5, 9), max_nbr=16,
                           orig_fea=16, full_degree=True)
    cfg = TrainerConfig(batch_size=6, node_bucket=16, max_nbr=16,
                        moment_dtype="bfloat16", optim="LAMB")
    mcfg = CGATConfig(**SMALL, compute_dtype="bfloat16", no_hyper=False)
    cpu = Trainer(cfg, mcfg, graphs, device="cpu")
    card = Trainer(cfg, mcfg, graphs, device=dev)
    sd = init_state_dict(cpu.init_state(), seed=0)
    cpu.init_state(sd)
    card.init_state(sd)
    batch = next(iter(cpu.loader(cpu.train_graphs, shuffle=True)))
    with torch.no_grad():
        want, _ = cpu.forward_loss(batch)
    before = _launches()
    loss, _ = card.forward_loss(batch.to(dev))
    card.backward(loss)
    n = mcfg.n_graph
    assert {k: v - before[k] for k, v in _launches().items()} == {
        "segment_attention": n + 1, "mh_network": 2 * n,
        "hyper_apply": 8 * n - 4, "segment_attention_bwd": n + 1,
        "mh_network_bwd": 2 * n, "hyper_apply_bwd_dhdx": 8 * n - 4,
        "hyper_apply_bwd_dk": 8 * n - 4, "segment_sum": 4 * n - 1,
        "dropout": 0, "dropout_bwd": 0}
    grads = [p.grad for p in card.model.parameters() if p.grad is not None]
    assert torch.isfinite(torch.stack(torch._foreach_norm(grads))).all()
    card.apply_update()
    torch.testing.assert_close(loss.detach().cpu(), want, rtol=5e-2,
                               atol=5e-2)


def test_replayed_hyper_edge_steps_count_their_edge_updates(dev):
    """The replay half of the live edge update's counter and the launch
    record: a replayed step of the 2-layer hyper-edge model counts its one
    live edge layer on the batch's edge slots (the capture counts none),
    the capture keeps its launches by key while the record is on, with the
    4 edge-row #5 launches in the ``edge_update`` scope and 4 #6 and 4 #7
    on the same rows; the default model's graphs count nothing."""
    from cgat_tpu_torch.models.cgat import edge_update_stats
    from cgat_tpu_torch.ops.kernels import build

    graphs = random_graphs(2, 30, n_atoms_range=(5, 9), max_nbr=16,
                           orig_fea=16, full_degree=True)
    cfg = TrainerConfig(batch_size=6, node_bucket=16, max_nbr=16,
                        moment_dtype="bfloat16")
    build.record_launches(True)
    try:
        for no_hyper in (False, True):
            mcfg = CGATConfig(**SMALL, compute_dtype="bfloat16",
                              no_hyper=no_hyper)
            t = Trainer(cfg, mcfg, graphs, device=dev)
            t.init_state(init_state_dict(t.init_state(), seed=0))
            batch = next(iter(t.loader(t.train_graphs, shuffle=True)))
            before = edge_update_stats()
            for _ in range(3):
                t.train_step(batch)
            torch.cuda.synchronize()
            after = edge_update_stats()
            live = 0 if no_hyper else mcfg.n_graph - 1
            E = batch.num_edge_slots
            assert after["layers"] - before["layers"] == 3 * live
            assert after["rows"] - before["rows"] == 3 * live * E
            (key, g), = t.step_graphs.graphs.items()
            assert g.counted == (None if no_hyper
                                 else {"edge_update": (live, live * E)})
            launches = t.step_graphs.launches[key]
            hyper = [(k, rows, scope) for k, rows, scope in launches
                     if k.startswith("cgat_hyper_apply")]
            edge = [h for h in hyper if h[1] == E]
            assert [h for h in hyper if h[2] == "edge_update"] == \
                [("cgat_hyper_apply_fwd", E, "edge_update")] * 4 * live
            assert sorted(k for k, _, _ in edge) == sorted(
                ["cgat_hyper_apply_fwd", "cgat_hyper_apply_bwd_dhdx",
                 "cgat_hyper_apply_bwd_dk"] * 4 * live)
            assert len(hyper) == 12 * mcfg.n_graph + len(edge)
    finally:
        build.record_launches(False)


def _dispatch_pair(dev, tkw, mkw):
    """An eager and a graph trainer (``steps_per_dispatch`` 2 unless
    ``tkw`` says otherwise) of the bf16 2-layer model from one state, and
    the groups of batches both take."""
    graphs = random_graphs(3, 60, n_atoms_range=(5, 9), max_nbr=16,
                           orig_fea=16, full_degree=True)
    cfg = TrainerConfig(batch_size=6, node_bucket=16, max_nbr=16,
                        moment_dtype="bfloat16",
                        **{"steps_per_dispatch": 2, **tkw})
    mcfg = CGATConfig(**SMALL, compute_dtype="bfloat16", **mkw)
    pair = [Trainer(cfg, mcfg, graphs, device=dev) for _ in range(2)]
    sd = init_state_dict(pair[0].init_state(), seed=0)
    for t in pair:
        t.init_state(sd)
    loader = pair[1].grouped_loader(pair[1].train_graphs)
    groups = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        groups += list(loader)
    return pair, groups


def _eager_step(t, batch):
    """One eager step on the card: the work a graph of the step captures."""
    loss, metrics = t.forward_loss(batch)
    t.backward(loss)
    t.apply_update()
    return {k: v.detach() for k, v in metrics.items()}


@pytest.mark.parametrize("tkw,mkw", [
    ({}, {}), ({}, {"remat": True}), ({}, {"hyper_remat": True}),
    ({"optim": "LAMB", "acc_batches": 2}, {}),
    ({"optim": "SGD", "acc_batches": 3}, {}),
    ({"steps_per_dispatch": 1}, {}),
    ({}, {"dropout": 0.1}), ({"steps_per_dispatch": 1}, {"dropout": 0.1})])
def test_graph_steps_match_eager_steps(dev, tkw, mkw):
    """Two epochs of groups of batches, taken one step by one step
    eagerly and one group by one group through ``train_group`` (every
    ``train_step`` on the card: each shape's and optimizer phase's first
    step eager, the rest replays of its CUDA graph), the learning rate
    changed half way: the same losses and parameters, bit for bit, under
    remat's checkpoints, MultiSteps' phases, dropout (its masks drawn from
    the device step count) and K = 1 too."""
    (eager, graph), groups = _dispatch_pair(dev, tkw, mkw)
    got, want = [], []
    for j, group in enumerate(groups):
        if j == len(groups) // 2:
            eager.opt.lr = graph.opt.lr = 1e-3
        gdev = group.to(dev)
        k = group.target.shape[0]
        want += [float(_eager_step(eager, gdev.map(lambda t: t[i]))["loss"])
                 for i in range(k)]
        got += [float(m["loss"]) for m in graph.train_group(group)]
    assert graph.step == eager.step == len(got) == sum(
        g.target.shape[0] for g in groups)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(eager.model.parameters(),
                                                 graph.model.parameters()))
    assert len(graph.step_graphs.graphs) < graph.step


def test_replayed_step_launches_every_kernel(dev):
    """A replayed step calls no kernel wrapper, and its device events of
    each wrapper's kernels (by name, from the profiler) are an eager
    step's: 3/4/8 forward and 3/4/8/8/5 backward calls at 2 layers."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_names(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return Counter(e.name for e in prof.events()
                       if e.device_type == DeviceType.CUDA)

    (eager, graph), groups = _dispatch_pair(dev, {}, {})
    batch = groups[0].to(dev).map(lambda t: t[0])
    graph.train_step(batch)
    _eager_step(eager, batch)
    before = _launches()
    eager_names = device_names(lambda: _eager_step(eager, batch))
    n = SMALL["n_graph"]
    assert {k: v - before[k] for k, v in _launches().items()} == {
        "segment_attention": n + 1, "mh_network": 2 * n,
        "hyper_apply": 4 * n, "segment_attention_bwd": n + 1,
        "mh_network_bwd": 2 * n, "hyper_apply_bwd_dhdx": 4 * n,
        "hyper_apply_bwd_dk": 4 * n, "segment_sum": 2 * n + 1,
        "dropout": 0, "dropout_bwd": 0}
    before = _launches()
    replay_names = device_names(lambda: graph.train_step(batch))
    assert _launches() == before
    ours = ("segment_attention_", "gemm_kernel", "pass_a::", "pass_b::",
            "reduce_parts", "fwd::kernel", "dhdx::", "dk::kernel",
            "segment_sum_kernel")
    mine = {k: v for k, v in eager_names.items() if any(s in k for s in ours)}
    assert sum(mine.values()) >= 8 * n
    assert {k: replay_names[k] for k in mine} == mine


def test_a_trace_of_replayed_steps_holds_every_kernel(dev, tmp_path):
    """``utils.profiling.trace`` around 3 replayed steps: the written
    trace holds 3 times an eager step's device events of each of the
    eight kernels (by name) and one ``train_step`` span a step."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cgat_tpu_torch.utils.profiling import (trace, trace_files,
                                                trace_kernels)

    (eager, graph), groups = _dispatch_pair(dev, {}, {})
    batch = groups[0].to(dev).map(lambda t: t[0])
    graph.train_step(batch)
    _eager_step(eager, batch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _eager_step(eager, batch)
        torch.cuda.synchronize()
    eager_names = Counter(e.name for e in prof.events()
                          if e.device_type == DeviceType.CUDA)
    with trace(str(tmp_path)):
        for _ in range(3):
            graph.train_step(batch)
    path, = trace_files(str(tmp_path))
    per_name = trace_kernels(path)
    ours = ("segment_attention_fwd", "segment_attention_bwd", "gemm_kernel",
            "pass_a::", "fwd::kernel", "dhdx::", "dk::kernel",
            "segment_sum_kernel")
    for pattern in ours:
        want = sum(v for k, v in eager_names.items() if pattern in k)
        got = sum(v[1] for k, v in per_name.items() if pattern in k)
        assert want > 0 and got == 3 * want, pattern
    assert per_name["span:train_step"][1] == 3


def test_measured_kernels_stay_under_their_rooflines(dev):
    """``utils.roofline``'s measurements at the main path's shapes (#1 also
    with its stats at the training step's and at a GP batch): no kernel
    reads above 1.05 of the bound its work sets."""
    from cgat_tpu_torch.utils import roofline

    rows = {**roofline.measure_kernels(iters=5),
            **roofline.measure_mh_kernels(iters=5),
            **roofline.measure_hyper_kernels(iters=5)}
    assert len(rows) == 11
    for name, r in rows.items():
        assert 0 < r["share"] <= 1.05, (name, r)
        assert r["share"] == pytest.approx(max(r["bytes_share"],
                                               r["ops_share"]))


def test_step_trace_categories_add_up_to_its_total(dev):
    from cgat_tpu_torch.tools import step_trace

    res = step_trace.step_trace(iters=3)
    cats = res["categories"]
    assert sum(c["ms"] for c in cats.values()) == pytest.approx(
        res["device_ms_per_step"], rel=1e-9)
    for name in ("#1 segment_attention", "#3 mh_network", "#4 mh_network_bwd",
                 "#8 segment_sum", "optimizer"):
        assert cats[name]["ms"] > 0, name


def test_a_dropped_trainer_frees_its_step_graphs(dev):
    """The graphs of the step hold no reference to their trainer, so a
    trainer that is dropped goes at once, with its graphs' memory (not at
    the next cyclic garbage collection)."""
    import weakref

    (trainer, _), groups = _dispatch_pair(dev, {"steps_per_dispatch": 1}, {})
    trainer.train_step(groups[0].map(lambda t: t[0]))
    assert len(trainer.step_graphs.graphs) == 1
    gone = weakref.ref(trainer)
    del trainer
    assert gone() is None


def _pair_blocks(rng, hf, dtype, dev, n=400):
    """A local and a halo block over ``n`` nodes, each dst-sorted with a
    padded suffix, each skipping destinations the other has (and some
    nodes in neither)."""
    blocks = []
    for nodes, rows, real in ((rng.choice(n, 300, replace=False), 4000,
                               3500),
                              (rng.choice(n, 90, replace=False), 640, 500)):
        dst = np.sort(rng.choice(nodes, real)).astype(np.int32)
        dst = np.concatenate([dst, np.full(rows - real, n - 1, np.int32)])
        blocks += [torch.tensor(rng.standard_normal((rows, hf)) * 3,
                                dtype=dtype, device=dev),
                   torch.tensor(rng.standard_normal((rows, hf)),
                                dtype=dtype, device=dev),
                   torch.from_numpy(dst).to(dev),
                   torch.from_numpy(np.arange(rows) < real).to(dev)]
    return blocks


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pair_path_kernels_match_plain(dev, dtype):
    """The pair path (#1 on each block, the f32 merge, #2 on each block
    against the merged arrays) against the plain pair function and its
    autograd gradient, on dst-sparse blocks; two launches the same bits."""
    from cgat_tpu_torch.ops.attention import edge_softmax_aggregate_pair
    from cgat_tpu_torch.ops.kernels.segment_attention import (
        SegmentAttentionPair, segment_attention_pair_plain)
    n = 400
    blocks = _pair_blocks(np.random.default_rng(3), 640, dtype, dev, n)
    g = torch.randn(n, 640, device=dev).to(dtype)
    leaves = [blocks[i] for i in (0, 1, 4, 5)]

    def run(fn):
        xs = [x.detach().clone().requires_grad_() for x in leaves]
        out = fn(xs[0], xs[1], blocks[2], blocks[3], xs[2], xs[3],
                 blocks[6], blocks[7], n)
        return [out.detach()] + list(torch.autograd.grad(out, xs, g))

    before = (SegmentAttentionPair.fwd_launches,
              SegmentAttentionPair.bwd_launches, _launches())
    got = run(edge_softmax_aggregate_pair)
    assert (SegmentAttentionPair.fwd_launches,
            SegmentAttentionPair.bwd_launches) == (before[0] + 2,
                                                   before[1] + 2)
    after = _launches()
    assert after["segment_attention"] == before[2]["segment_attention"] + 2
    assert after["segment_attention_bwd"] == \
        before[2]["segment_attention_bwd"] + 2
    want = run(segment_attention_pair_plain)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        else:
            scale = float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) \
                <= 2e-2 * scale
    again = run(edge_softmax_aggregate_pair)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_two_rank_nccl_matches_one_rank(dev, tmp_path):
    """dp = 2 over NCCL, one card a rank, each step a replay: the loss and
    the parameters after one AdamW step against one process on the
    concatenated group (the CPU's f32 oracle)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import json
    import os
    import socket
    import subprocess
    import sys
    from cgat_tpu_torch.data.synthetic import random_graphs as graphs_of
    from cgat_tpu_torch.models import CGATConfig as Config
    from cgat_tpu_torch.parallel import ParallelLoader
    from cgat_tpu_torch.training import losses, make_optimizer
    from cgat_tpu_torch.training.optim import project_params
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from _torch_parallel_worker import GRAPHS, MEAN, STD, TINY
    cfg = Config(**TINY)
    state = init_state_dict(CGAtNet(cfg), seed=0)
    torch.save(state, tmp_path / "w.pt")
    spec = {"n_devices": 2, "edge_shards": 1, "device": "cuda",
            "state_dict": str(tmp_path / "w.pt"), "graphs": 16,
            "out": str(tmp_path / "out.pt")}
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(here, "_torch_parallel_worker.py"),
         "step", str(tmp_path / "spec.json")],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                 MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-4000:]
    got = torch.load(tmp_path / "out.pt")
    model = CGAtNet(cfg)
    model.load_state_dict(state)
    group = next(iter(ParallelLoader(graphs_of(0, 16, **GRAPHS), 4, 2,
                                     max_nbr=4, node_bucket=8,
                                     num_comp_slots=8)))
    out = torch.stack([model(group.map(lambda t: t[d])) for d in range(2)])
    loss = losses.make_loss("L1", False)(out[..., 0], out[..., 1],
                                         (group.target - MEAN) / STD,
                                         group.graph_mask)
    loss.backward()
    opt = make_optimizer(TrainerConfig(optim="AdamW", learning_rate=1e-3),
                         list(model.parameters()))
    opt.apply()
    project_params(model)
    np.testing.assert_allclose(got["loss"], loss.item(), rtol=1e-4)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=1e-2, atol=1e-3, err_msg=k)


def _server(dev):
    """A ServingModel of the bf16 2-layer model on the card with one
    signature (64 node slots), and two requests of 6 crystals."""
    from cgat_tpu_torch.serving import ServingModel

    cfg = CGATConfig(**SMALL, compute_dtype="bfloat16")
    model = CGAtNet(cfg)
    model.load_state_dict(init_state_dict(model, seed=0), strict=True)
    model = model.to_compute_dtype().to(dev)
    sigs = [{"key": f"c6_n{n}", "num_graphs": 6, "num_node_slots": n,
             "num_edge_slots": n * 16, "num_comp_slots": 8}
            for n in (64,)]
    manifest = {"mean": 0.5, "std": 2.0, "signatures": sigs,
                "collate": {"max_nbr": 16, "orig_fea": 16}}
    requests = [random_graphs(s, 6, n_atoms_range=(5, 9), max_nbr=16,
                              orig_fea=16, full_degree=True)
                for s in (10, 11)]
    return ServingModel(manifest, model), model, requests


def test_replayed_request_equals_the_eager_warm_up(dev):
    """A signature's first request runs eagerly, then is captured (each
    wrapper called twice a forward); a second request of the same batch
    replays the graph (no wrapper called) and gives the warm-up's bits;
    another batch of the signature replays and gives an eager forward's
    bits, so the CSR pointers and every other field are copied in."""
    server, model, (req, other) = _server(dev)
    n = SMALL["n_graph"]
    fwd = {"mh_network": 2 * n, "segment_attention": n + 1,
           "hyper_apply": 4 * n}
    before = _launches()
    first = server.predict(req, return_embeddings=True)
    assert {k: v - before[k] for k, v in _launches().items() if v != before[k]
            } == {k: 2 * v for k, v in fwd.items()}
    assert len(server.graphs.graphs) == 1
    before = _launches()
    again = server.predict(req, return_embeddings=True)
    got = server.predict(other, return_embeddings=True)
    assert _launches() == before and len(server.graphs.graphs) == 1
    for a, b in zip(first, again):
        assert np.array_equal(a, b)
    from cgat_tpu_torch.serving import ServingModel
    eager = ServingModel(server.manifest, model)
    eager.graphs = None              # the same forward, eagerly
    for a, b in zip(got, eager.predict(other, return_embeddings=True)):
        assert np.array_equal(a, b)
    assert all(np.isfinite(a).all() for a in got)


def test_a_dropped_serving_model_releases_its_graph_pool(dev):
    """The graphs hold no reference to their ServingModel: dropping it
    frees its graphs, their static buffers and their pool at once (the
    model it served stays). A first server is dropped before the memory
    is read, so what the process sets up once for its first capture is
    not counted."""
    import gc
    import weakref

    from cgat_tpu_torch.serving import ServingModel

    server, model, (req, _) = _server(dev)
    server.predict(req)
    server.predict(req)
    manifest = server.manifest
    del server
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated = torch.cuda.memory_allocated(dev)
    reserved = torch.cuda.memory_reserved(dev)
    server = ServingModel(manifest, model)
    server.predict(req)
    server.predict(req)
    assert len(server.graphs.graphs) == 1
    assert torch.cuda.memory_allocated(dev) > allocated
    gone = weakref.ref(server)
    del server
    assert gone() is None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated(dev) == allocated
    assert torch.cuda.memory_reserved(dev) <= reserved
    assert next(model.parameters()).is_cuda


def test_streaming_train_step_replays(dev, tmp_path):
    """A streaming trainer on the card (two shards from ``cli.prepare``):
    each batch shape's first step runs eagerly and is captured (every
    wrapper twice), every later step of a shape replays (no wrapper);
    the stream pins the composition slots and the degree, so an epoch
    captures fewer keys than it takes steps; the losses are finite."""
    import gzip
    import pickle

    from cgat_tpu_torch.cli import prepare as cli_prepare
    from cgat_tpu_torch.data.structures import random_structures

    for name, seed, n in (("shards", 1, 40), ("shards", 2, 40),
                          ("val", 3, 12)):
        raw = f"raw{seed}.pickle.gz"
        with gzip.open(tmp_path / raw, "wb") as f:
            pickle.dump(random_structures(seed, n), f)
        (tmp_path / name).mkdir(exist_ok=True)
        assert cli_prepare.main(["--file", raw, "--source-dir",
                                 str(tmp_path), "--target-dir",
                                 str(tmp_path / name), "--target-file",
                                 f"p{seed}.pickle.gz", "--max-nbr",
                                 "16"]) == 0
    cfg = TrainerConfig(data_path=str(tmp_path / "shards"),
                        val_path=str(tmp_path / "val"), streaming=True,
                        target="e_above_hull", batch_size=6, node_bucket=16,
                        max_nbr=16, moment_dtype="bfloat16")
    trainer = Trainer(cfg, CGATConfig(**dict(SMALL, orig_elem_fea_len=200),
                                      compute_dtype="bfloat16"), device=dev)
    trainer.init_state()
    n = SMALL["n_graph"]
    step = {"segment_attention": n + 1, "mh_network": 2 * n,
            "hyper_apply": 4 * n, "segment_attention_bwd": n + 1,
            "mh_network_bwd": 2 * n, "hyper_apply_bwd_dhdx": 4 * n,
            "hyper_apply_bwd_dk": 4 * n, "segment_sum": 2 * n + 1}
    loader = trainer.train_loader()
    losses, replays = [], 0
    for epoch in range(2):
        loader.set_epoch(epoch)
        for batch in loader:
            keys = len(trainer.step_graphs.graphs) if trainer.step_graphs \
                else 0
            before = _launches()
            losses.append(float(trainer.train_step(batch)["loss"]))
            got = {k: v - before[k] for k, v in _launches().items()}
            new = len(trainer.step_graphs.graphs) - keys
            assert got == {**dict.fromkeys(got, 0),
                           **{k: 2 * new * v for k, v in step.items()}}
            replays += 1 - new
    assert len(losses) == 2 * len(loader) and replays > len(losses) // 2
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [18432 * 640, 1001, 3])
def test_dropout_kernel_equals_plain_bit_for_bit(dev, dtype, n):
    """Both entry points give the plain version's bits (the same masks
    and the same rounding of x * scale) at the node layers' shape, a
    ragged tail and an unaligned view (the one-at-a-time path), at a step
    past 2**32; an empty tensor launches nothing."""
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev).to(dtype)
    step = torch.tensor(2 ** 32 + 5, dtype=torch.int64, device=dev)
    key = dropout.site_key(0, 1, 2)
    for fn in (dropout.dropout, dropout.dropout_bwd):
        for v in (x, x[1:]):
            got = fn(v, 0.1, key, step)
            want = dropout.dropout_plain(v, 0.1, key, step)
            assert torch.equal(got, want)
            assert torch.equal(got != 0, want != 0)
    before = _launches()
    assert dropout.dropout(x[:0], 0.1, key, step).numel() == 0
    assert _launches() == before


def test_dropout_replays_draw_new_masks(dev):
    """A CUDA graph of a dropout call and the step's increment: each
    replay reads the device step, so two replays draw different masks,
    each the plain version's at its step."""
    x = torch.ones(1 << 16, device=dev)
    step = torch.zeros((), dtype=torch.int64, device=dev)
    key = dropout.site_key(7)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dropout.dropout(x, 0.5, key, step)
        step.add_(1)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = dropout.dropout(x, 0.5, key, step)
        step.add_(1)
    masks = []
    for _ in range(2):
        graph.replay()
        masks.append(out.clone())
    assert not torch.equal(masks[0], masks[1])
    for i, m in enumerate(masks):
        assert torch.equal(m, dropout.dropout_plain(
            x, 0.5, key, torch.tensor(i + 1, device=dev)))
    assert int(step) == 3


def _gp_case(dev):
    """The bf16 2-layer model on the card (eval), 60 graphs, and the
    arguments of an on-the-fly GP fit of 3 epochs of 3 steps."""
    model = CGAtNet(CGATConfig(**SMALL, compute_dtype="bfloat16"))
    model.load_state_dict(init_state_dict(model, seed=0))
    graphs = random_graphs(4, 60, n_atoms_range=(5, 9), max_nbr=16,
                           orig_fea=16, full_degree=True)
    kw = dict(mean=0.1, std=1.3, num_inducing=16, epochs=3, batch_size=16,
              max_nbr=16, node_bucket=16, verbose=False)
    return model.to(dev).eval(), graphs, kw


def test_replayed_gp_step_equals_an_eager_one(dev, monkeypatch):
    """``fit_gp_streaming`` on the card: the inducing batch's forward,
    then each batch shape's eager first step and capture call the
    forward's wrappers (none of a backward: the backbone is frozen), a
    replay none; the history and parameters equal a fit whose every step
    is eager on the card, bit for bit."""
    from cgat_tpu_torch.data.dataset import GraphLoader
    from cgat_tpu_torch.training.dispatch import signature
    from cgat_tpu_torch.uncertainty import gp

    model, graphs, kw = _gp_case(dev)
    loader = GraphLoader(graphs, 16, shuffle=True, seed=0, max_nbr=16,
                         node_bucket=16)
    keys, steps = set(), 0
    for epoch in range(kw["epochs"]):
        loader.set_epoch(epoch)
        for b in loader:
            keys.add(signature(b))
            steps += 1
    n = SMALL["n_graph"]
    before = _launches()
    got = gp.fit_gp_streaming(model, graphs, **kw)
    assert {k: v - before[k] for k, v in _launches().items()} == {
        **dict.fromkeys(before, 0),
        **{k: v * (1 + 2 * len(keys)) for k, v in (
            ("segment_attention", n + 1), ("mh_network", 2 * n),
            ("hyper_apply", 4 * n))}}
    assert len(keys) < steps
    monkeypatch.setattr(gp, "StepGraphs", lambda device: None)
    want = gp.fit_gp_streaming(model, graphs, **kw)
    assert got[1] == want[1] and all(np.isfinite(got[1]))
    for (name, a), (_, b) in zip(got[0].named(), want[0].named()):
        assert torch.equal(a, b), name


def test_a_dropped_gp_fit_frees_its_graphs(dev):
    """Nothing of a GP fit's graphs outlives it: once its parameters are
    dropped, the card holds what it held before the fit (cuBLAS's
    per-stream workspaces cleared both times: the fit's side stream makes
    one, which is not the graphs' memory)."""
    import gc

    from cgat_tpu_torch.uncertainty import gp

    def settled():
        gc.collect()
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(dev)

    model, graphs, kw = _gp_case(dev)
    gp.fit_gp_streaming(model, graphs, **kw)
    before = settled()
    params, history = gp.fit_gp_streaming(model, graphs, **kw)
    assert params.inducing.is_cuda and np.isfinite(history).all()
    assert settled() > before
    del params
    assert settled() == before


def test_dropped_trainers_and_gp_fits_leave_no_memory(dev):
    """Every ``StepGraphs`` on a card runs its eager first steps on the
    card's one side stream (``training/dispatch.py``), so five trainers
    and five ``fit_gp``s, each capturing its step and then dropped, leave
    the card's allocated memory where a first one left it, within 1 MiB
    (cuBLAS's workspaces not cleared: a side stream of each owner's own
    kept one of ~33 MiB for each)."""
    import gc

    from cgat_tpu_torch.uncertainty import gp

    graphs = random_graphs(5, 8, n_atoms_range=(5, 9), max_nbr=16,
                           orig_fea=16, full_degree=True)
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((64, 32)).astype(np.float32)
    y = rng.standard_normal(64).astype(np.float32)

    def settled():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(dev)

    def owners():
        t = Trainer(TrainerConfig(batch_size=8, node_bucket=16, max_nbr=16),
                    CGATConfig(**SMALL, compute_dtype="bfloat16"), mean=0.1,
                    std=1.3, device=dev)
        t.init_state()
        batch = collate(graphs, max_nbr=16, node_bucket=16)
        losses = [float(t.train_step(batch)["loss"]) for _ in range(2)]
        assert len(t.step_graphs.graphs) == 1 and np.isfinite(losses).all()
        params, history = gp.fit_gp(emb, y, num_inducing=16, epochs=3,
                                    batch_size=32, verbose=False, device=dev)
        assert params.inducing.is_cuda and np.isfinite(history).all()

    owners()
    before = settled()
    for _ in range(5):
        owners()
    assert abs(settled() - before) <= 1 << 20
