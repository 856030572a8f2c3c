"""Each kernel module's plain version against the JAX function it ports.

The JAX side runs its Pallas kernels in interpret mode (and the XLA path);
the port's wrappers run their plain PyTorch versions because the tensors
lie on the CPU. The CUDA kernels themselves are checked on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import inspect
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cgat_tpu.ops import attention as jatt
from cgat_tpu.ops import segment as jseg
from cgat_tpu.ops.pallas import hyper_apply as jhyper
from cgat_tpu.ops.pallas import mh_network as jmh
from cgat_tpu.ops.pallas import segment_attention as jsa
from cgat_tpu_torch.data import host_offsets
from cgat_tpu_torch.data.synthetic import SEGMENT_LAYOUTS, segment_layout
from cgat_tpu_torch.ops import attention, segment
from cgat_tpu_torch.ops import kernels
from cgat_tpu_torch.ops.kernels import (build, hyper_apply, mh_network,
                                        segment_attention)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _entry_stub(symbol, calls):
    """A stand-in for the C entry ``symbol`` (ctypes names an entry by its
    symbol, and ``build.run`` counts it under that name): it records its
    arguments and returns 0."""
    def entry(*args):
        calls.append(args)
        return 0
    entry.__name__ = symbol
    return entry


def _launched(entry: str) -> int:
    """The launches ``build.run`` has counted of C entry ``entry``."""
    return build.launch_counts().get(entry, 0)


def _edges(rng, num_nodes=300, n_pad=40):
    """Destination-sorted edges with empty nodes, a hub node and a padded
    suffix pointing at the last node slot."""
    deg = rng.integers(0, 6, size=num_nodes)
    deg[rng.choice(num_nodes, 30, replace=False)] = 0     # empty nodes
    deg[17] = 150                                         # hub
    deg[-1] = 0
    dst = np.repeat(np.arange(num_nodes), deg).astype(np.int32)
    n_real = len(dst)
    dst = np.concatenate([dst, np.full(n_pad, num_nodes - 1, np.int32)])
    mask = np.arange(len(dst)) < n_real
    return dst, mask


def _seg_inputs(dtype, heads=2, feat=64, seed=0):
    rng = np.random.default_rng(seed)
    dst, mask = _edges(rng)
    e = len(dst)
    alpha = (rng.standard_normal((e, heads, feat)) * 3).astype(np.float32)
    m = rng.standard_normal((e, heads, feat)).astype(np.float32)
    if dtype == "bfloat16":       # identical bf16 values on both sides
        alpha = np.asarray(jnp.asarray(alpha, jnp.bfloat16), np.float32)
        m = np.asarray(jnp.asarray(m, jnp.bfloat16), np.float32)
    return alpha, m, dst, mask


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("with_offn", [True, False])
def test_segment_attention_matches_jax(dtype, tol, with_offn):
    alpha, m, dst, mask = _seg_inputs(dtype)
    n = 300
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    offn = host_offsets(dst, n + 64)
    want_k = np.asarray(jsa.edge_softmax_aggregate(
        jnp.asarray(alpha, jdt), jnp.asarray(m, jdt), jnp.asarray(dst), n,
        edge_mask=jnp.asarray(mask), offn=jnp.asarray(offn),
        interpret=True), np.float32)
    want_x = np.asarray(jatt.edge_softmax_aggregate(
        jnp.asarray(alpha, jdt), jnp.asarray(m, jdt), jnp.asarray(dst), n,
        edge_mask=jnp.asarray(mask), backend="xla"), np.float32)
    tdt = getattr(torch, dtype)
    got = attention.edge_softmax_aggregate(
        torch.tensor(alpha, dtype=tdt), torch.tensor(m, dtype=tdt),
        torch.from_numpy(dst), n, edge_mask=torch.from_numpy(mask),
        offn=torch.from_numpy(offn) if with_offn else None)
    assert got.dtype == tdt and got.shape == (n, 2, 64)
    got = got.float().numpy()
    for want in (want_k, want_x):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # empty nodes and the padded tail's node get exactly 0
    empty = np.bincount(dst[mask], minlength=n) == 0
    assert empty.any() and not np.abs(got[empty]).any()


def test_segment_attention_plain_stats_and_flat_layout():
    alpha, m, dst, mask = _seg_inputs("float32", seed=1)
    e, n = len(dst), 300
    a2 = torch.from_numpy(alpha.reshape(e, -1))
    m2 = torch.from_numpy(m.reshape(e, -1))
    offn = torch.from_numpy(host_offsets(dst, n))
    n_real = torch.tensor(int(mask.sum()), dtype=torch.int32)
    before = build.launch_counts()
    out, mx, den = segment_attention.segment_attention(
        a2, m2, offn, n_real, n, return_stats=True)
    assert build.launch_counts() == before        # CPU calls launch nothing
    # numpy reference with the exact per-node max
    for node in (0, 17, 299):
        rows = np.flatnonzero((dst == node) & mask)
        if len(rows) == 0:
            assert (out[node] == 0).all() and (den[node] == 0).all()
            continue
        a = alpha.reshape(e, -1)[rows]
        ex = np.exp(a - a.max(0))
        np.testing.assert_array_equal(mx[node].numpy(), a.max(0))
        np.testing.assert_allclose(den[node].numpy(), ex.sum(0), rtol=1e-5)
        np.testing.assert_allclose(
            out[node].numpy(),
            (ex * m.reshape(e, -1)[rows]).sum(0) / (ex.sum(0) + 1e-16),
            rtol=1e-5, atol=1e-6)
    flat = attention.edge_softmax_aggregate(
        a2, m2, torch.from_numpy(dst), n, edge_mask=torch.from_numpy(mask))
    torch.testing.assert_close(flat, out)


def test_scalar_attention_matches_jax_xla():
    alpha, m, dst, mask = _seg_inputs("float32", seed=2)
    alpha = alpha[:, :, :1]                                   # (E, H, 1)
    want = np.asarray(jatt.edge_softmax_aggregate(
        jnp.asarray(alpha), jnp.asarray(m), jnp.asarray(dst), 300,
        edge_mask=jnp.asarray(mask), backend="xla"))
    got = attention.edge_softmax_aggregate(
        torch.from_numpy(alpha), torch.from_numpy(m), torch.from_numpy(dst),
        300, edge_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(4)
    dst, mask = _edges(rng, num_nodes=50, n_pad=7)
    x = rng.standard_normal((len(dst), 3)).astype(np.float32)
    tx, tid = torch.from_numpy(x), torch.from_numpy(dst)
    np.testing.assert_allclose(
        segment.segment_sum(tx, tid, 50).numpy(),
        np.asarray(jseg.segment_sum(x, dst, 50)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        segment.segment_max(tx, tid, 50).numpy(),
        np.maximum(np.asarray(jseg.segment_max(x, dst, 50)), jseg.NEG_BIG))
    np.testing.assert_allclose(
        segment.segment_softmax(tx, tid, 50,
                                mask=torch.from_numpy(mask)).numpy(),
        np.asarray(jseg.segment_softmax(x, dst, 50, mask=mask)),
        rtol=1e-5, atol=1e-7)


def _mh_inputs(rng, e=1024, cat=384, hid=256, f=128, heads=5):
    """bf16 inputs of test_mh_kernel.py, in the JAX flat layout and in the
    port's grouped-Conv1d layout."""
    bf = jnp.bfloat16
    x = jnp.asarray(rng.standard_normal((e, cat)), bf)
    w_in = jnp.asarray(rng.standard_normal((heads, hid, cat)) * 0.05, bf)
    b_in = jnp.asarray(rng.standard_normal((heads, hid)) * 0.05, bf)
    w_out = jnp.asarray(rng.standard_normal((heads, f, hid)) * 0.05, bf)
    b_out = jnp.asarray(rng.standard_normal((heads, f)) * 0.05, bf)
    jax_args = (x, w_in.transpose(2, 0, 1).reshape(cat, -1), b_in.reshape(-1),
                w_out.transpose(0, 2, 1).reshape(-1, f), b_out.reshape(-1))
    t = lambda a: torch.tensor(np.asarray(a, np.float32),
                               dtype=torch.bfloat16)
    port_args = (t(x), t(w_in).reshape(heads * hid, cat), t(b_in).reshape(-1),
                 t(w_out).reshape(heads * f, hid), t(b_out).reshape(-1))
    return jax_args, port_args


def test_mh_network_matches_jax(rng):
    jax_args, port_args = _mh_inputs(rng)
    want = np.asarray(jmh.mh_network(*jax_args, heads=5, hid=256, f=128,
                                     interpret=True), np.float32)
    got = mh_network.mh_network(*port_args, 5)
    assert got.dtype == torch.bfloat16 and got.shape == (1024, 640)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=5e-2,
                               atol=2e-2 * np.abs(want).max())


def test_mh_network_gate():
    assert mh_network.supported(384, 256, 128, 5, torch.bfloat16)
    assert mh_network.supported(48, 32, 16, 2, torch.bfloat16)
    assert not mh_network.supported(384, 256, 128, 5, torch.float32)
    assert not mh_network.supported(384, 250, 128, 5, torch.bfloat16)
    assert not mh_network.supported(8192, 4096, 128, 5, torch.bfloat16)


@pytest.mark.parametrize("f,heads", [(128, 5), (16, 2)])
def test_mh_network_gate_keeps_its_widths(f, heads):
    """The gate takes the widths it always took: those whose 64-row tiles
    of x and h fit one block of the first forward design (a 10,240-byte
    scratch and rows padded by 8, in 232,448 bytes of shared memory)."""
    for cat in range(16, 2049, 16):
        for hid in range(16, 2049, 16):
            old = 10240 + 64 * (cat + 8) * 2 + 64 * (hid + 8) * 2 <= 232448
            assert mh_network.supported(cat, hid, f, heads,
                                        torch.bfloat16) == old


def test_mh_network_wrapper_allocates_the_hidden_scratch(monkeypatch):
    """Off the CPU the wrapper makes one call of the C entry per call, with
    out (E, H*F) and h (E, H*hid) allocated in both forms: the kernel
    writes h between its two products, and refuses a null one. Meta tensors
    stand in for the card's, and a stub for the library."""
    calls, allocated = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        allocated.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(mh_network, "_fwd",
                        lambda: _entry_stub("cgat_mh_network_fwd", calls))
    monkeypatch.setattr(build, "stream", lambda device: 0)
    monkeypatch.setattr(torch, "empty", empty)
    meta = lambda *s: real_empty(*s, dtype=torch.bfloat16, device="meta")
    args = (meta(37, 48), meta(2 * 32, 48), meta(64), meta(2 * 16, 32),
            meta(32), 2)
    before = _launched("cgat_mh_network_fwd")
    out = mh_network.mh_network(*args)
    out2, h = mh_network.mh_network(*args, return_hidden=True)
    assert out.shape == out2.shape == (37, 32) and h.shape == (37, 64)
    assert _launched("cgat_mh_network_fwd") == before + 2
    assert allocated == [(37, 32), (37, 64)] * 2
    assert [c[7:12] for c in calls] == [(37, 48, 32, 16, 2)] * 2
    assert all(c[6] is not None for c in calls)    # h, in both forms


@pytest.mark.parametrize("b", [96, 100])
def test_hyper_apply_matches_jax(rng, b):
    c = i = o = 128
    f = o * i + o
    bf = jnp.bfloat16
    hidden = jnp.asarray(np.tanh(rng.standard_normal((b, c))), bf)
    kernel = jnp.asarray(rng.standard_normal((c, f)) * np.sqrt(2 / c) * 0.1,
                         bf)
    bias = jnp.asarray(rng.uniform(-1, 1, f) / np.sqrt(c), bf)
    x = jnp.asarray(rng.standard_normal((b, i)), bf)
    want = np.asarray(jhyper.hyper_apply(hidden, kernel, bias, x, out_ch=o,
                                         interpret=True), np.float32)
    t = lambda a: torch.tensor(np.asarray(a, np.float32),
                               dtype=torch.bfloat16)
    got = hyper_apply.hyper_apply(t(hidden), t(kernel).T.contiguous(),
                                  t(bias), t(x), o)
    assert got.dtype == torch.bfloat16 and got.shape == (b, o)
    got = got.float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_hyper_apply_gate():
    assert hyper_apply.supported(128, 128, 128, torch.bfloat16)
    assert not hyper_apply.supported(128, 128, 128, torch.float32)
    assert not hyper_apply.supported(128, 128, 120, torch.bfloat16)


def test_build_targets_hopper():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").exists()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR and name in path.name
    # every source holds the kernels of one wrapper module, which loads
    # its entry points from that source's library
    assert set(kernels.__all__) == set(build.KERNELS)
    for name in build.KERNELS:
        source = inspect.getsource(getattr(kernels, name))
        assert f'build.entry("{name}", ' in source
    # ENTRIES names wrappers of these modules and C entries they load
    sources = [inspect.getsource(getattr(kernels, m)) for m in build.KERNELS]
    for wrapper, entry in kernels.ENTRIES.items():
        assert any(callable(getattr(getattr(kernels, m), wrapper, None))
                   for m in build.KERNELS)
        assert any(f'"{entry}"' in s for s in sources)


def test_library_path_covers_headers_and_flags(tmp_path, monkeypatch):
    """A library is named after its source, every header of csrc/ and the
    flags, so an edited header (or a new flag) never loads a stale one."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in build.CSRC.iterdir():
        if src.suffix in (".cu", ".cuh"):
            (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("mh_network")
    (csrc / "gemm_sm90.cuh").write_text(
        (csrc / "gemm_sm90.cuh").read_text() + "\n// edited\n")
    edited = build.library_path("mh_network")
    assert edited != before
    (csrc / "extra.cuh").write_text("#pragma once\n")     # a new header
    added = build.library_path("mh_network")
    assert added != edited
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        (*build.NVCC_FLAGS, "-I/usr/local/cutlass/include"))
    assert build.library_path("mh_network") != added


def _pass_b_units(plan: dict, rows: int, cat: int, hh: int):
    """Pass B's units per block, in the kernel's order (``pass_b::unit_at``
    in ``csrc/mh_network.cu``): block b's dWin units b, b + blocks, ...
    (the tile fastest, then the split), then its dx tiles, dealt out in
    rounds. Yields (block, kind, m tile, n tile, split, k-blocks)."""
    tile, step = mh_network.TILE, mh_network.K_STEP
    n_tiles = -(-cat // tile)
    w_tiles = -(-hh // tile) * n_tiles
    splits, per = plan["win"]
    blocks, (a, ra, c, rc) = plan["blocks"], plan["dx"]
    n_w = w_tiles * splits
    rw = n_w % blocks
    count = [a + (b < ra) if b < rw else c + (b - rw < rc)
             for b in range(blocks)]
    for b in range(blocks):
        for u in range(b, n_w, blocks):
            t, s = u % w_tiles, u // w_tiles
            yield (b, "dwin", t // n_tiles, t % n_tiles, s,
                   -(-(min(rows, (s + 1) * per) - s * per) // step))
        for j in range(count[b]):
            # the tiles of rounds 0 .. j - 1, then b's place in round j
            x = (sum(min(n, j) for n in count)
                 + sum(count[i] > j for i in range(b)))
            yield b, "dx", x // n_tiles, x % n_tiles, 0, -(-hh // step)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,cat,hid,f,heads",
                         [(18432, 384, 256, 128, 5), (19968, 384, 256, 128, 5),
                          (1000, 144, 272, 160, 8), (129, 48, 32, 16, 2),
                          (1, 16, 16, 16, 1), (1025, 384, 256, 128, 5),
                          (600, 64, 256, 32, 72), (3000, 384, 256, 64, 5)])
def test_mh_network_bwd_plan_covers_every_row_once(rows, cat, hid, f, heads,
                                                   sms):
    """The backward's host plan. Pass A (F <= 128 only, the old split where
    F > 128): its E ranges are whole 128-row tiles, cover every row once,
    none empty, and fill at most about one wave of the card's SMs (132 on
    the H100 SXM, 114 on the PCIe card); where F > 128, dWout's splits
    (multiples of 64 rows, at least 1024 where E allows) do. Pass B: every
    dx tile and every (dWin tile, split) falls in exactly one unit, the
    splits cover every row once and none is empty, and no block runs more
    than one dx tile longer than the mean of all blocks."""
    plan = mh_network.bwd_plan(rows, cat, hid, f, heads, sms)
    tile, step = mh_network.TILE, mh_network.K_STEP
    hh = heads * hid
    m_tiles = -(-rows // tile)
    assert plan["fused"] == (f <= tile)

    def covers_once(splits, per):
        covered = np.zeros(rows, int)
        for s in range(splits):
            lo, hi = s * per, min(rows, (s + 1) * per)
            assert lo < hi                                  # none empty
            covered[lo:hi] += 1
        assert (covered == 1).all()

    ranges, per = plan["wout"]
    covers_once(ranges, per)
    if plan["fused"]:
        assert per % tile == 0 and plan["bias_parts"] == ranges
        pairs = heads * -(-hid // tile)
        assert ranges * pairs <= max(sms, pairs)
    else:
        out_tiles = heads * -(-f // tile) * -(-hid // tile)
        assert per % step == 0 and plan["bias_parts"] == m_tiles
        if rows >= mh_network.MIN_SPLIT:
            assert per >= mh_network.MIN_SPLIT or ranges == 1
        assert ranges * out_tiles <= max(sms, out_tiles)

    splits, per = plan["win"]
    assert per % step == 0
    covers_once(splits, per)
    units = list(_pass_b_units(plan, rows, cat, hh))
    n_tiles = -(-cat // tile)
    dx = sorted(u[2:4] for u in units if u[1] == "dx")
    assert dx == [(m, n) for m in range(m_tiles) for n in range(n_tiles)]
    dwin = sorted(u[2:5] for u in units if u[1] == "dwin")
    assert dwin == [(m, n, s) for m in range(-(-hh // tile))
                    for n in range(n_tiles) for s in range(splits)]
    assert 1 <= plan["blocks"] <= sms
    load = np.zeros(plan["blocks"], int)
    for u in units:
        load[u[0]] += u[5]
    assert load.max() <= load.sum() / plan["blocks"] + -(-hh // step)


@pytest.mark.parametrize("blocks", [1, 114, 132])
@pytest.mark.parametrize("kind", SEGMENT_LAYOUTS)
def test_stream_spans_write_every_node_once(kind, blocks):
    """The forward's stream kernel partition (``stream_spans``, the device
    count in torch ops): every node slot is written by exactly one block; a
    block's streamed nodes are those whose start lies in its span of the
    real rows, and their rows lie within [0, n_real); the blocks' rows
    cover every real row from the first node's start once (the bytes a
    block streams: its span, and its last node's overrun); the nodes that
    start at n_real are spread evenly."""
    offn, n_real, num_nodes = segment_layout(kind)
    n_lo, n_hi, r0, r1, e_lo, e_hi = (
        x.numpy() for x in segment_attention.stream_spans(
            torch.from_numpy(offn), torch.tensor(n_real, dtype=torch.int32),
            num_nodes, blocks))
    starts = np.minimum(offn[:num_nodes + 1], n_real)
    per, extra = divmod(n_real, blocks)
    ends = np.arange(blocks + 1) * per + np.minimum(np.arange(blocks + 1),
                                                    extra)
    assert ends[-1] == n_real
    written = np.zeros(num_nodes, int)
    rows = np.zeros(n_real, int)
    for b in range(blocks):
        written[n_lo[b]:n_hi[b]] += 1
        written[e_lo[b]:e_hi[b]] += 1
        assert (starts[e_lo[b]:e_hi[b]] == n_real).all()
        if n_lo[b] == n_hi[b]:
            continue
        own = starts[n_lo[b]:n_hi[b]]
        assert ((own >= ends[b]) & (own < ends[b + 1])).all()
        assert (r0[b], r1[b]) == (starts[n_lo[b]], starts[n_hi[b]])
        assert 0 <= r0[b] <= r1[b] <= n_real
        rows[r0[b]:r1[b]] += 1
    assert (written == 1).all()
    assert (rows[starts[0]:] == 1).all() and not rows[:starts[0]].any()
    assert (e_hi - e_lo).max() <= -(-(starts[:num_nodes] == n_real).sum()
                                    // blocks)
    if kind in ("request", "training", "gp") and blocks > 1:
        # balanced by bytes: no block streams more than its span and a node
        assert (r1 - r0).max() <= -(-n_real // blocks) + 24


def test_stream_gate_matches_the_source():
    """The wrapper's copy of the widths the stream kernel takes is the
    source's."""
    src = (build.CSRC / "segment_attention.cu").read_text()
    threads = int(re.search(r"MAX_THREADS = (\d+);", src).group(1))
    assert "MAX_GROUPS = MAX_THREADS - 32;" in src
    assert segment_attention.STREAM_MAX_GROUPS == threads - 32


def _bwd_units(plan: dict, out_ch: int):
    """The plan's units in the kernel's order (``dhdx::unit_at`` in
    ``csrc/hyper_apply.cu``): the dx units, then the dh units, each kind
    with the group fastest, then the column tile, then the row tile.
    Yields (kind, row tile, column tile, group, first output, end output,
    tail), tail marking the dh unit that also adds g K_tail."""
    groups, per = plan["groups"]
    for kind, cols in (("dx", plan["x_tiles"]), ("dh", plan["h_tiles"])):
        for m in range(plan["m_tiles"]):
            for col in range(cols):
                for grp in range(groups):
                    yield (kind, m, col, grp, grp * per,
                           min(out_ch, (grp + 1) * per),
                           kind == "dh" and grp == groups - 1)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,c,i,o",
                         [(768, 128, 128, 128), (832, 128, 128, 128),
                          (1, 128, 128, 128), (129, 128, 128, 128),
                          (70, 48, 16, 16), (70, 512, 160, 32),
                          (100, 384, 384, 384), (7, 64, 32, 48)])
def test_hyper_apply_bwd_plan_covers_every_output_once(rows, c, i, o, sms):
    """The dh/dx kernel's host plan: every (row tile, o) of dx and every
    (row tile, C tile, o) of dh falls in exactly one unit, in output order;
    no unit is empty; the last group's dh unit of each tile adds the tail;
    and the units fill at most about one wave of the card's SMs (132 on
    the H100 SXM, 114 on the PCIe card)."""
    plan = hyper_apply.bwd_plan(rows, c, i, o, sms)
    units = list(_bwd_units(plan, o))
    tile = hyper_apply.TILE
    m_tiles = -(-rows // tile)
    widths = {"dx": i, "dh": c}
    assert [u[0] for u in units] == sorted((u[0] for u in units),
                                           key=["dx", "dh"].index)
    groups, per = plan["groups"]
    for kind, width in widths.items():
        seen, tails = {}, []
        for k, m, col, grp, lo, hi, tail in units:
            if k != kind:
                continue
            assert lo < hi and lo == grp * per             # none empty
            seen.setdefault((m, col), []).extend(range(lo, hi))
            if tail:
                tails.append((m, col))
                assert grp == groups - 1
        tiles = {(m, col) for m in range(m_tiles)
                 for col in range(-(-width // tile))}
        assert set(seen) == tiles
        assert all(v == list(range(o)) for v in seen.values())
        assert sorted(tails) == (sorted(tiles) if kind == "dh" else [])
    per_o = m_tiles * (plan["x_tiles"] + plan["h_tiles"])
    assert len(units) <= max(sms, per_o)


def _fwd_units(plan: dict, out_ch: int):
    """The forward plan's units in the kernel's order (``fwd::unit_at`` in
    ``csrc/hyper_apply.cu``): the group fastest, then the row tile. Yields
    (row tile, group, first output, end output)."""
    groups, per = plan["groups"]
    for m in range(plan["m_tiles"]):
        for grp in range(groups):
            yield m, grp, grp * per, min(out_ch, (grp + 1) * per)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("rows,c,i,o",
                         [(768, 128, 128, 128), (832, 128, 128, 128),
                          (1, 128, 128, 128), (129, 128, 128, 128),
                          (70, 48, 16, 16), (70, 512, 160, 32),
                          (100, 384, 384, 384), (7, 64, 32, 48)])
def test_hyper_apply_fwd_plan_covers_every_output_once(rows, c, i, o, sms):
    """The forward kernel's host plan: every (row tile, o) falls in exactly
    one unit, in output order; no group is empty or wider than the
    kernel's PER_MAX outputs; the I tiles are the 128-column tiles of I;
    and the units fill at most about one wave of the card's SMs (132 on the
    H100 SXM, 114 on the PCIe card), or as few waves as PER_MAX allows."""
    plan = hyper_apply.fwd_plan(rows, c, i, o, sms)
    units = list(_fwd_units(plan, o))
    m_tiles = -(-rows // hyper_apply.TILE)
    assert plan["m_tiles"] == m_tiles
    assert plan["x_tiles"] == -(-i // hyper_apply.TILE)
    groups, per = plan["groups"]
    assert 1 <= per <= hyper_apply.PER_MAX and groups == -(-o // per)
    seen = {}
    for m, grp, lo, hi in units:
        assert lo < hi and lo == grp * per                 # none empty
        seen.setdefault(m, []).extend(range(lo, hi))
    assert sorted(seen) == list(range(m_tiles))
    assert all(v == list(range(o)) for v in seen.values())
    assert len(units) <= max(sms, m_tiles * -(-o // hyper_apply.PER_MAX))


def test_hyper_apply_wrapper_passes_its_plan(monkeypatch):
    """Off the CPU the forward wrapper makes one call of the C entry with
    the plan for the card's SM count, and allocates the output and nothing
    else: no P (B, O*I + O). Meta tensors stand in for the card's, and
    stubs for the library and the card."""
    calls, allocated = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        allocated.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(hyper_apply, "_entry",
                        lambda symbol, *a: _entry_stub(symbol, calls))
    monkeypatch.setattr(build, "stream", lambda device: 0)
    monkeypatch.setattr(build, "sm_count", lambda index: 114)
    monkeypatch.setattr(torch, "empty", empty)
    meta = lambda *s: real_empty(*s, dtype=torch.bfloat16, device="meta")
    n, c, i, o = 300, 64, 32, 48
    before = _launched("cgat_hyper_apply_fwd")
    out = hyper_apply.hyper_apply(meta(n, c), meta(o * i + o, c),
                                  meta(o * i + o), meta(n, i), o)
    assert out.shape == (n, o) and out.dtype == torch.bfloat16
    assert _launched("cgat_hyper_apply_fwd") == before + 1
    assert allocated == [(n, o)]
    groups, per = hyper_apply.fwd_plan(n, c, i, o, 114)["groups"]
    (call,) = calls
    assert call[4] == out.data_ptr()
    assert call[5:11] == (n, c, i, o, groups, per)
    assert groups == -(-o // per) and per <= hyper_apply.PER_MAX


def test_hyper_apply_bwd_dhdx_wrapper_passes_its_plan(monkeypatch):
    """Off the CPU the wrapper makes one call of the C entry with the plan
    for the card's SM count and the f32 partial planes that plan needs:
    (groups, B, I) and (groups, B, C). Meta tensors stand in for the
    card's, and stubs for the library and the card."""
    calls, allocated = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        allocated.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(hyper_apply, "_entry",
                        lambda symbol, *a: _entry_stub(symbol, calls))
    monkeypatch.setattr(build, "stream", lambda device: 0)
    monkeypatch.setattr(build, "sm_count", lambda index: 114)
    monkeypatch.setattr(torch, "empty", empty)
    meta = lambda *s: real_empty(*s, dtype=torch.bfloat16, device="meta")
    n, c, i, o = 300, 64, 32, 48
    args = (meta(n, c), meta(o * i + o, c), meta(o * i + o), meta(n, i),
            meta(n, o), o)
    before = _launched("cgat_hyper_apply_bwd_dhdx")
    dh, dx = hyper_apply.hyper_apply_bwd_dhdx(*args)
    assert dh.shape == (n, c) and dx.shape == (n, i)
    assert _launched("cgat_hyper_apply_bwd_dhdx") == before + 1
    groups, per = hyper_apply.bwd_plan(n, c, i, o, 114)["groups"]
    assert allocated == [(groups, n, i), (groups, n, c)]
    (call,) = calls
    assert call[5:11] == (n, c, i, o, groups, per)
    assert groups == -(-o // per)       # what the C entry checks


def test_hyper_apply_bwd_dk_wrapper_allocates_only_its_outputs(monkeypatch):
    """Off the CPU the wrapper makes one call of the C entry with the
    shapes, and allocates dk (O*I, C) and db (O*I,) and nothing else: no
    dP buffer (B, O*I), which the kernel builds in registers. Meta tensors
    stand in for the card's, and stubs for the library and the card."""
    calls, allocated = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        allocated.append((tuple(shape), kw.get("dtype")))
        return real_empty(shape, **kw)

    monkeypatch.setattr(hyper_apply, "_entry",
                        lambda symbol, *a: _entry_stub(symbol, calls))
    monkeypatch.setattr(build, "stream", lambda device: 0)
    monkeypatch.setattr(torch, "empty", empty)
    meta = lambda *s: real_empty(*s, dtype=torch.bfloat16, device="meta")
    n, c, i, o = 300, 256, 48, 32
    before = _launched("cgat_hyper_apply_bwd_dk")
    dk, db = hyper_apply.hyper_apply_bwd_dk(meta(n, c), meta(n, i),
                                            meta(n, o), o)
    assert dk.shape == (o * i, c) and dk.dtype == torch.bfloat16
    assert db.shape == (o * i,) and db.dtype == torch.float32
    assert _launched("cgat_hyper_apply_bwd_dk") == before + 1
    assert allocated == [((o * i, c), torch.bfloat16),
                         ((o * i,), torch.float32)]
    (call,) = calls
    assert call[3:7] == (n, c, i, o)
    assert call[7:9] == (dk.data_ptr(), db.data_ptr())


def test_launches_follow_the_tensors_device(monkeypatch):
    """build.run makes the tensor's device current for the launch only when
    it is not, and restores the previous one, also when the launch raises;
    a device with no index is left alone; each call counts one launch of
    its entry, on whichever device it runs."""
    current, switches, asked = [0], [], []

    def current_device():
        asked.append(1)
        return current[0]

    def set_device(index):
        switches.append(index)
        current[0] = index

    monkeypatch.setattr(torch.cuda, "current_device", current_device)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    monkeypatch.setattr(build, "stream", lambda device: 100 + device.index)
    seen = []

    def entry(*args):
        seen.append((current[0], args))
        return 0

    before = _launched("entry")
    assert build.run(entry, torch.device("cuda", 0), 7) == 0
    assert switches == [] and seen == [(0, (7, 100))]
    assert build.run(entry, torch.device("cuda", 1), 7) == 0
    assert switches == [1, 0] and seen[-1] == (1, (7, 101))
    assert current == [0]

    def boom(*args):
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError, match="launch failed"):
        build.run(boom, torch.device("cuda", 2), 7)
    assert switches == [1, 0, 2, 0] and current == [0]
    n_asked = len(asked)
    monkeypatch.setattr(build, "stream", lambda device: 0)
    build.run(entry, torch.device("meta"), 7)
    assert len(asked) == n_asked and switches == [1, 0, 2, 0]
    assert _launched("entry") == before + 3


def test_every_launch_goes_through_the_device_guard():
    """Each kernel wrapper launches through build.run, one call a wrapper
    (#1's, #3's and dropout's forward and backward, hyper_apply's three,
    segment_sum's and adamw's: 11), and none reads a stream by itself."""
    sources = [inspect.getsource(getattr(kernels, m)) for m in build.KERNELS]
    assert not any("build.stream(" in s for s in sources)
    assert sum(s.count("build.run(") for s in sources) == 11
