"""The port's data-parallel and edge-sharded path (slice 4) against the JAX
package: the edge-sharded collate field for field, the pair op and its
gradient, the one-process halo-mode forward, gloo worlds of 2 and 4 ranks
against one process and against cgat_tpu's mesh step, ``fit`` (in memory
and streaming) and ``cli.train`` on ranks, and what raises.

The worlds run as subprocesses (``tests/_torch_parallel_worker.py``, one a
rank, gloo on the CPU, one torch thread each) on free ports, so test
workers do not collide."""
import dataclasses
import gzip
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from cgat_tpu.data import batching as jbatching
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.models import CGAtNet as JNet
from cgat_tpu.models.host_init import init_params_host
from cgat_tpu.ops.attention import \
    edge_softmax_aggregate_pair as jpair
from cgat_tpu.parallel import ParallelLoader as JParallelLoader
from cgat_tpu.parallel import make_mesh as jmake_mesh
from cgat_tpu.parallel import make_parallel_train_step, replicate
from cgat_tpu.parallel.sharding import shardmap_batch_pspecs
from cgat_tpu.training import TrainerConfig as JTrainerConfig
from cgat_tpu.training import losses as jlosses
from cgat_tpu.training import make_optimizer as jmake_optimizer
from cgat_tpu.training.trainer import TrainState
from cgat_tpu_torch.cli import common
from cgat_tpu_torch.cli import prepare as cli_prepare
from cgat_tpu_torch.data import collate
from cgat_tpu_torch.data.batching import HaloBatch
from cgat_tpu_torch.data.structures import random_structures
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import CGATConfig, CGAtNet, state_dict_from_jax
from cgat_tpu_torch.ops.attention import (edge_softmax_aggregate,
                                          edge_softmax_aggregate_pair)
from cgat_tpu_torch.ops.kernels.segment_attention import SegmentAttentionPair
from cgat_tpu_torch.ops.segment import segment_softmax, segment_softmax_pair
from cgat_tpu_torch.parallel import (ParallelLoader, StreamingParallelLoader,
                                     collate_group, local_batch, make_mesh)
from cgat_tpu_torch.parallel.distributed import local_dp_rows, rank_device
from cgat_tpu_torch.parallel.mesh import Axis, Mesh
from cgat_tpu_torch.training import Trainer, TrainerConfig, make_optimizer
from cgat_tpu_torch.training import losses
from cgat_tpu_torch.training.optim import project_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_parallel_worker import GRAPHS, MEAN, STD, TINY  # noqa: E402

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_parallel_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (ranks, edge shards): dp = 2; edge = 2; dp = 2 x edge = 2
WORLDS = [(2, 1), (2, 2), (4, 2)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (the workers share the machine's cores);
    the count is restored, and its pool started, after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        torch.exp(torch.zeros(1 << 20))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_world(mode: str, spec: dict, n: int, tmp) -> list:
    """Start ``n`` rank processes of the worker; returns them running."""
    path = os.path.join(tmp, f"{mode}-{n}-{spec.get('edge_shards')}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, mode, path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _join(procs) -> list[str]:
    """Wait for every rank; each must exit 0. Returns their outputs."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, out[-4000:]
        outs.append(out)
    return outs


# ------------------------------------------------------------ the collate

def _assert_same_fields(got, want):
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        g = getattr(got, f.name)
        if w is None:
            assert g is None, f.name
            continue
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (f.name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_edge_sharded_collate_equals_cgat_tpu(shards, seed):
    kw = dict(n_atoms_range=(2, 9), max_nbr=6, orig_fea=12)
    got = collate(random_graphs(seed, 9, **kw), max_nbr=6, node_bucket=8,
                  edge_shards=shards)
    want = jbatching.collate(jrandom_graphs(seed, 9, **kw), max_nbr=6,
                             node_bucket=8, edge_shards=shards)
    assert isinstance(got, HaloBatch)
    _assert_same_fields(got, want)


def test_grouped_sharded_loader_equals_cgat_tpu():
    """Group-wide capacities, process slicing (the second of two
    processes) and the shuffled order, against cgat_tpu's loader."""
    kw = dict(shuffle=True, seed=3, max_nbr=4, node_bucket=8,
              num_comp_slots=8, edge_shards=2, process_index=1,
              process_count=2)
    port = ParallelLoader(random_graphs(4, 29, **GRAPHS), 4, 4, **kw)
    ref = JParallelLoader(jrandom_graphs(4, 29, **GRAPHS), 4, 4, **kw)
    for b, jb in zip(port, ref, strict=True):
        assert port.last_counts == ref.last_counts
        assert b.nodes.shape[0] == 2
        _assert_same_fields(b, jb)


def test_local_batch_takes_the_shard_map_slices():
    """Each field of a rank's batch is cgat_tpu's shard_map slice of the
    stacked group: P("dp", "edge") fields cut along edge, P("dp") whole."""
    S = 2
    chunks = [random_graphs(s, 4, **GRAPHS) for s in (0, 1)]
    group = collate_group(chunks, batch_size=4, max_nbr=4, node_bucket=8,
                          num_comp_slots=8, edge_shards=S)
    specs = shardmap_batch_pspecs(True)
    for d in range(2):
        for e in range(S):
            rank = local_batch(group, d, e, S)
            for f in dataclasses.fields(group):
                full = getattr(group, f.name)
                spec = getattr(specs, f.name)
                if full is None:
                    assert getattr(rank, f.name) is None, f.name
                    continue
                want = full[d]
                if tuple(spec) == ("dp", "edge"):
                    want = np.split(want.numpy(), S)[e]
                else:
                    assert tuple(spec) == ("dp",), f.name
                np.testing.assert_array_equal(
                    getattr(rank, f.name).numpy(), np.asarray(want),
                    err_msg=f.name)


# ----------------------------------------------------------- the pair op

def _block(rng, rows, real, nodes, n):
    """A dst-sorted block of ``rows`` slots, ``real`` of them real, whose
    destinations are drawn from ``nodes`` only (the rest skipped)."""
    dst = np.sort(rng.choice(nodes, real)).astype(np.int32)
    dst = np.concatenate([dst, np.full(rows - real, n - 1, np.int32)])
    return dst, np.arange(rows) < real


@pytest.mark.parametrize("shape,route", [
    ((2, 3), "plain"), ((2, 1), "plain"), ((6,), "plain"),
    ((2, 3), "kernels"), ((6,), "kernels")])
def test_pair_op_and_grad_match_cgat_tpu_and_the_unsharded_op(shape, route):
    """Dst-sparse local and halo blocks: the union softmax-aggregate and
    its gradients against cgat_tpu's XLA pair op and against the port's
    single-block op on the concatenated real rows. ``kernels``: the
    autograd Function of the card's path (the forward and backward kernel
    functions on each block, the f32 merge) run by its plain kernels."""
    rng = np.random.default_rng(0)
    n, e_l, e_h = 11, 24, 16
    dst_l, mask_l = _block(rng, e_l, 17, [0, 1, 2, 5, 6, 9], n)
    dst_h, mask_h = _block(rng, e_h, 9, [2, 3, 6, 7, 9], n)
    heads = shape[0] if len(shape) == 2 else 2
    msg = (heads, 3) if len(shape) == 2 else (heads * 3,)
    a_l, a_h = (rng.standard_normal((e,) + shape).astype(np.float32)
                for e in (e_l, e_h))
    m_l, m_h = (rng.standard_normal((e,) + msg).astype(np.float32)
                for e in (e_l, e_h))
    g = rng.standard_normal((n,) + msg).astype(np.float32)
    t = [torch.tensor(x, requires_grad=True) for x in (a_l, m_l, a_h, m_h)]
    ids = [torch.tensor(x) for x in (dst_l, mask_l, dst_h, mask_h)]
    if route == "plain":
        out = edge_softmax_aggregate_pair(t[0], t[1], ids[0], ids[1], t[2],
                                          t[3], ids[2], ids[3], n)
    else:
        # the Function takes (E, H*F) rows (the op expands scalar scores
        # before it)
        from cgat_tpu_torch.data import host_offsets

        def offn(d):
            return torch.tensor(host_offsets(d, n + 4))

        flat = [x.reshape(x.shape[0], -1) for x in t]
        out = SegmentAttentionPair.apply(
            flat[0], flat[1], ids[0], offn(dst_l),
            torch.tensor([int(mask_l.sum())], dtype=torch.int32), flat[2],
            flat[3], ids[2], offn(dst_h),
            torch.tensor([int(mask_h.sum())], dtype=torch.int32),
            n).reshape((n,) + msg)
    grads = torch.autograd.grad(out, t, torch.tensor(g))

    def ref(a_l, m_l, a_h, m_h):
        if len(shape) == 1:       # cgat_tpu takes (E, H, F)
            a_l, m_l, a_h, m_h = (x.reshape(x.shape[0], heads, -1)
                                  for x in (a_l, m_l, a_h, m_h))
        y = jpair(a_l, m_l, jnp.asarray(dst_l), jnp.asarray(mask_l), a_h,
                  m_h, jnp.asarray(dst_h), jnp.asarray(mask_h), n,
                  backend="xla")
        return y.reshape((n,) + msg)

    want, vjp = jax.vjp(ref, a_l, m_l, a_h, m_h)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    for got_g, want_g in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-6)
    # the unsharded op on the concatenated real rows
    cat_dst = np.concatenate([dst_l[mask_l], dst_h[mask_h]])
    order = np.argsort(cat_dst, kind="stable")
    alpha = torch.cat([t[0][ids[1]], t[2][ids[3]]])[order]
    m = torch.cat([t[1][ids[1]], t[3][ids[3]]])[order]
    a3 = alpha.reshape(alpha.shape[0], heads, -1)
    one = edge_softmax_aggregate(a3, m.reshape(m.shape[0], heads, -1),
                                 torch.tensor(cat_dst[order]), n)
    np.testing.assert_allclose(out.detach().numpy(),
                               one.reshape((n,) + msg).detach().numpy(),
                               rtol=1e-6, atol=1e-6)


def test_segment_softmax_pair_is_the_softmax_of_the_union():
    rng = np.random.default_rng(1)
    n = 7
    dst_l, mask_l = _block(rng, 12, 9, [0, 2, 3], n)
    dst_h, mask_h = _block(rng, 8, 5, [1, 3, 4], n)
    s_l, s_h = (torch.tensor(rng.standard_normal((e, 2, 3)),
                             dtype=torch.float32) for e in (12, 8))
    w_l, w_h = segment_softmax_pair(s_l, torch.tensor(dst_l),
                                    torch.tensor(mask_l), s_h,
                                    torch.tensor(dst_h), torch.tensor(mask_h),
                                    n)
    w = segment_softmax(torch.cat([s_l, s_h]),
                        torch.tensor(np.concatenate([dst_l, dst_h])), n,
                        mask=torch.tensor(np.concatenate([mask_l, mask_h])))
    torch.testing.assert_close(torch.cat([w_l, w_h]), w, rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------- the halo-mode forward

SMALL = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
             nbr_embedding_size=8, neighbor_number=6, msg_heads=2,
             n_graph_roost=1, out_hidden=(32, 32, 16))


@pytest.mark.parametrize("variant,shards", [
    ({}, 2), ({}, 4), ({"no_hyper": False}, 2),
    ({"vector_attention": False}, 4)])
def test_one_process_halo_forward_matches_cgat_tpu_and_unsharded(
        variant, shards):
    kw = {**SMALL, **variant}
    gkw = dict(n_atoms_range=(3, 7), max_nbr=6, orig_fea=16)
    jb = jbatching.collate(jrandom_graphs(0, 6, **gkw), max_nbr=6,
                           node_bucket=8, edge_shards=shards)
    graphs = random_graphs(0, 6, **gkw)
    batch = collate(graphs, max_nbr=6, node_bucket=8, edge_shards=shards)
    whole = collate(graphs, max_nbr=6, node_bucket=8,
                    num_node_slots=batch.num_node_slots)
    jmodel = JNet(JConfig(**kw))
    params = init_params_host(jmodel, jb, seed=0)
    cfg = CGATConfig(**kw)
    model = CGAtNet(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    model.eval()
    with torch.no_grad():
        got = model(batch).numpy()
        one = model(whole).numpy()
        emb = model(batch, return_graph_embedding=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(
        {"params": params}, jb)), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(emb, np.asarray(jmodel.apply(
        {"params": params}, jb, return_graph_embedding=True)),
        rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got, one, rtol=2e-4, atol=1e-5)


# ---------------------------------------------------------- gloo worlds

def _jax_weights():
    jmodel = JNet(JConfig(**TINY))
    b0 = jbatching.collate(jrandom_graphs(0, 4, **GRAPHS), max_nbr=4,
                           node_bucket=8)
    params = init_params_host(jmodel, b0, seed=0)
    return jmodel, params


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world of ``WORLDS`` takes one AdamW step on the first group of
    16 graphs from cgat_tpu's initial weights; all run at once."""
    tmp = str(tmp_path_factory.mktemp("worlds"))
    _, params = _jax_weights()
    sd_path = os.path.join(tmp, "weights.pt")
    torch.save(state_dict_from_jax(params, CGATConfig(**TINY)), sd_path)
    running = {}
    for n, S in WORLDS:
        spec = {"n_devices": n, "edge_shards": S, "state_dict": sd_path,
                "graphs": 16, "out": os.path.join(tmp, f"out-{n}-{S}.pt")}
        running[(n, S)] = (_start_world("step", spec, n, tmp), spec["out"])
    results = {}
    for key, (procs, out) in running.items():
        _join(procs)
        results[key] = torch.load(out)
    return params, results


def _one_process(params, dp: int, S: int):
    """One process on the concatenated group: the port's model on each
    replica's batch (the whole sharded layout under S > 1), the global
    masked-mean loss, its gradient and one AdamW step."""
    cfg = CGATConfig(**TINY)
    model = CGAtNet(cfg)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    group = next(iter(ParallelLoader(random_graphs(0, 16, **GRAPHS), 4, dp,
                                     max_nbr=4, node_bucket=8,
                                     num_comp_slots=8, edge_shards=S)))
    out = torch.stack([model(group.map(lambda t: t[d])) for d in range(dp)])
    crit = losses.make_loss("L1", False)
    loss = crit(out[..., 0], out[..., 1], (group.target - MEAN) / STD,
                group.graph_mask)
    loss.backward()
    loss = loss.detach().item()
    params_ = list(model.parameters())
    grad = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params_])
    opt = make_optimizer(TrainerConfig(optim="AdamW", learning_rate=1e-3),
                         params_)
    opt.apply()
    project_params(model)
    return loss, grad, model.state_dict(), group


@pytest.mark.parametrize("world", WORLDS, ids=[f"n{n}-edge{s}"
                                                for n, s in WORLDS])
def test_world_matches_one_process(worlds, world):
    params, results = worlds
    n, S = world
    got = results[world]
    loss, grad, state, _ = _one_process(params, n // S, S)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert float((got["grad"] - grad).norm()) <= 1e-5 * float(grad.norm())
    for k, v in state.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=1e-2, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("world", WORLDS, ids=[f"n{n}-edge{s}"
                                                for n, s in WORLDS])
def test_world_matches_cgat_tpu_mesh_step(worlds, world):
    """The same group through cgat_tpu's make_parallel_train_step on the
    conftest's CPU devices, from the same weights."""
    params, results = worlds
    n, S = world
    got = results[world]
    jmodel, _ = _jax_weights()
    tcfg = JTrainerConfig(optim="AdamW", learning_rate=1e-3)
    tx = jmake_optimizer(tcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       opt_state=tx.init(params))
    mesh = jmake_mesh(dp=n // S, edge=S)
    pstep, shard = make_parallel_train_step(
        jmodel, tx, jlosses.make_loss("L1", False), MEAN, STD, mesh,
        edge_sharded=S > 1, donate=False)
    group = next(iter(JParallelLoader(jrandom_graphs(0, 16, **GRAPHS), 4,
                                      n // S, max_nbr=4, node_bucket=8,
                                      num_comp_slots=8, edge_shards=S)))
    new_state, metrics = pstep(replicate(state, mesh), shard(group))
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                               rtol=1e-5)
    want = state_dict_from_jax(jax.tree.map(np.asarray, new_state.params),
                               CGATConfig(**TINY))
    for k, v in want.items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(),
                                   rtol=1e-2, atol=1e-3, err_msg=k)


def test_edge_sharded_dropout_step_sums_through_the_plans(tmp_path):
    """Two edge-sharded gloo ranks under ``dropout=0.1``: the halo layer's
    softmax and sums and the sharded crystal pool go through the gather
    plans (no ``index_add_`` outside the segment-sum kernel's plain
    version, no segment sum without a plan: on the card, no atomics), and
    give the loss and the summed gradient of the same step with every
    plan dropped, within the one-process tolerance above."""
    _, params = _jax_weights()
    sd_path = os.path.join(tmp_path, "weights.pt")
    torch.save(state_dict_from_jax(params, CGATConfig(**TINY)), sd_path)
    spec = {"edge_shards": 2, "state_dict": sd_path,
            "out": os.path.join(tmp_path, "spy.pt")}
    _join(_start_world("spy", spec, 2, str(tmp_path)))
    got = torch.load(spec["out"])
    planned, atomics = got["planned"], got["atomics"]
    assert planned["counts"] == {"index_add_": 0,
                                 "segment_sum_without_plan": 0}
    # the spy sees the path it guards against
    assert atomics["counts"]["index_add_"] > 0
    assert atomics["counts"]["segment_sum_without_plan"] > 0
    np.testing.assert_allclose(planned["loss"], atomics["loss"], rtol=1e-5)
    grad, want = planned["grad"], atomics["grad"]
    assert float(want.norm()) > 0
    assert float((grad - want).norm()) <= 1e-5 * float(want.norm())


def test_fit_on_two_ranks_writes_once_and_evaluates_across_them(tmp_path):
    """``fit`` with ``n_devices=2, edge_shards=2``: rank 0 alone writes
    metrics.jsonl and the checkpoints; both ranks see the same metrics,
    and the parallel evaluation and embeddings equal one process's on the
    trained weights."""
    ckpt = str(tmp_path)
    _join(_start_world("fit", {"n_devices": 2, "edge_shards": 2,
                               "ckpt_dir": ckpt}, 2, ckpt))
    run = os.path.join(ckpt, "runs", "r")
    assert sorted(os.listdir(run)) == ["checkpoints", "metrics.jsonl"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records if "train_loss" in r] == [0, 1]
    r0, r1 = (np.load(os.path.join(ckpt, f"rank{r}.npz")) for r in (0, 1))
    for k in ("val_mae", "train_loss", "emb"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert str(r0["test"]) == str(r1["test"])
    final = torch.load(os.path.join(ckpt, "final.pt"))
    one = Trainer(TrainerConfig(batch_size=4, max_nbr=4, node_bucket=8,
                                num_comp_slots=8),
                  CGATConfig(**TINY), random_graphs(0, 40, **GRAPHS),
                  device="cpu")
    one.init_state(final)
    want = one.evaluate_split(one.test_graphs)
    got = json.loads(str(r0["test"]))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(r0["emb"], one.embeddings(one.test_graphs),
                               rtol=1e-5, atol=1e-6)


def test_cli_train_on_two_gloo_ranks_with_two_edge_shards(tmp_path):
    d = tmp_path
    with gzip.open(d / "raw.pickle.gz", "wb") as f:
        pickle.dump(random_structures(0, 24), f)
    assert cli_prepare.main(["--file", "raw.pickle.gz", "--source-dir",
                             str(d), "--target-dir", str(d), "--target-file",
                             "p.pickle.gz", "--max-nbr", "6"]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "cgat_tpu_torch.cli.train", "--device", "cpu",
         "--devices", "2", "--edge-shards", "2", "--smoke-test",
         "--data-path", str(d / "p.pickle.gz"), "--target", "e_above_hull",
         "--ckpt-dir", str(d / "logs"), "--run-name", "r", "--max-nbr", "6",
         "--atom-fea-len", "8", "--n-graph", "1", "--nbr-embedding-size",
         "8", "--msg-heads", "2", "--n-graph-roost", "1", "--batch-size",
         "4", "--node-bucket", "8"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(d / "logs" / "runs" / "r" / "metrics.jsonl") as f:
        epochs = [json.loads(line)["epoch"] for line in f]
    assert sorted(set(epochs)) == [0, 1]


def test_cli_train_gp_on_two_gloo_ranks(tmp_path):
    """``cli.train_gp --devices 2`` as two gloo ranks: each rank's
    embeddings across the mesh equal one process's, every rank fits the
    same GP, and rank 0 alone writes the pickle, whose history and val
    MAE are one process's ``cli.train_gp``'s."""
    from cgat_tpu_torch.cli import train_gp as cli_train_gp
    from cgat_tpu_torch.data.dataset import load_dataset_dir
    from cgat_tpu_torch.training import load_trainer
    d = tmp_path
    with gzip.open(d / "raw.pickle.gz", "wb") as f:
        pickle.dump(random_structures(0, 30), f)
    assert cli_prepare.main(["--file", "raw.pickle.gz", "--source-dir",
                             str(d), "--target-dir", str(d), "--target-file",
                             "p.pickle.gz", "--max-nbr", "4"]) == 0
    data = str(d / "p.pickle.gz")
    t = Trainer(TrainerConfig(data_path=data, target="e_above_hull",
                              max_nbr=4, batch_size=4, node_bucket=8,
                              epochs=1, check_val_every_n_epoch=1,
                              ckpt_dir=str(d), run_name="r"),
                CGATConfig(**{**TINY, "orig_elem_fea_len": 200}),
                device="cpu")
    t.fit()
    run = str(d / "runs" / "r")
    argv = ["--cgat-model", run, "--inducing-points", "6", "--epochs", "3",
            "--batch-size", "8", "--device", "cpu"]
    world = d / "world"
    world.mkdir()
    outs = _join(_start_world("gp", {
        "argv": argv + ["--devices", "2", "--out", str(world / "gp.pkl.gz")],
        "run": run, "data": data, "out": str(world / "gp.pkl.gz")}, 2,
        str(d)))
    assert [sum(line.startswith("wrote ") for line in o.splitlines())
            for o in outs] == [1, 0]
    one_path = d / "one.pkl.gz"
    assert cli_train_gp.main(argv + ["--out", str(one_path)]) == 0
    one, _ = load_trainer(run, device="cpu")
    want = one.embeddings(load_dataset_dir(data, max_neighbor_number=4,
                                           target="e_above_hull"))
    for r in (0, 1):
        np.testing.assert_allclose(np.load(world / f"rank{r}.npz")["emb"],
                                   want, rtol=1e-5, atol=1e-6)
    with gzip.open(world / "gp.pkl.gz") as f:
        got = pickle.load(f)
    with gzip.open(one_path) as f:
        ref = pickle.load(f)
    np.testing.assert_allclose(got["history"], ref["history"], rtol=1e-4)
    np.testing.assert_allclose(got["val_mae"], ref["val_mae"], rtol=1e-4)


@pytest.mark.parametrize("n,shards", [(2, 1), (2, 2)])
def test_streaming_fit_on_two_ranks_matches_one_process(tmp_path, n, shards):
    """``fit`` with ``streaming=True`` on two gloo ranks (dp = 2, or one
    replica in two edge shards; every rank streams every shard and
    collates its own part): the ranks agree, and the train losses and the
    validation MAE equal one streaming process whose batches are the
    replicas' together (batch 4 x dp), to 1e-4 relative."""
    d = tmp_path
    for name, seed, count in (("shards", 0, 20), ("shards", 1, 20),
                              ("shards", 2, 20), ("val", 3, 8)):
        with gzip.open(d / f"raw{seed}.pickle.gz", "wb") as f:
            pickle.dump(random_structures(seed, count), f)
        (d / name).mkdir(exist_ok=True)
        assert cli_prepare.main([
            "--file", f"raw{seed}.pickle.gz", "--source-dir", str(d),
            "--target-dir", str(d / name), "--target-file",
            f"p{seed}.pickle.gz", "--max-nbr", "4"]) == 0
    stream = {"data_path": str(d / "shards"), "val_path": str(d / "val")}
    ckpt = str(d / "world")
    os.makedirs(ckpt)
    _join(_start_world("fit", {"n_devices": n, "edge_shards": shards,
                               "ckpt_dir": ckpt, "stream": stream}, n, ckpt))
    r0, r1 = (np.load(os.path.join(ckpt, f"rank{r}.npz")) for r in (0, 1))
    for k in ("val_mae", "train_loss"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    one = Trainer(TrainerConfig(batch_size=4 * n // shards, epochs=2,
                                check_val_every_n_epoch=1, max_nbr=4,
                                node_bucket=8, num_comp_slots=8,
                                ckpt_dir=str(d / "one"), streaming=True,
                                target="e_above_hull", **stream),
                  CGATConfig(**{**TINY, "orig_elem_fea_len": 200}),
                  device="cpu")
    history = one.fit()
    np.testing.assert_allclose(r0["train_loss"],
                               [h["train_loss"] for h in history], rtol=1e-4)
    np.testing.assert_allclose(r0["val_mae"], history[-1]["val_mae"],
                               rtol=1e-4)


# ------------------------------------------------------------ the raises

def test_a_world_that_is_not_dp_times_edge_raises(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 ranks; the world has 1"):
            make_mesh(2, 1)
        mesh = make_mesh(1, 1)
        assert mesh.shape == {"dp": 1, "edge": 1}
        assert (mesh.dp.index, mesh.edge.index) == (0, 0)
    finally:
        dist.destroy_process_group()


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="2 ranks on this host needs 2 "
                                           "cards, and 1 are visible"):
        rank_device(torch.device("cuda"), "nccl")
    # gloo shares the card
    assert rank_device(torch.device("cuda"), "gloo") == \
        torch.device("cuda", 0)


def test_an_edge_group_across_hosts_raises(monkeypatch):
    """Three ranks a host cannot hold whole edge groups of 2."""
    mesh = Mesh(world=None, dp=Axis(None, 0, 3), edge=Axis(None, 0, 2))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="straddle hosts"):
        local_dp_rows(mesh)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(dist, "get_rank", lambda: 5)
    assert local_dp_rows(mesh) == (2, 2)


def test_streaming_under_dp_and_bad_shards_raise():
    """Replicas that do not split over the processes, a streaming rank
    without a validation path, and bad mesh shapes raise."""
    with pytest.raises(ValueError, match="not divisible"):
        StreamingParallelLoader(None, 3, process_count=2)
    with pytest.raises(ValueError, match="streaming=True requires"):
        Trainer(TrainerConfig(streaming=True, n_devices=1, edge_shards=1),
                CGATConfig(**TINY), mean=0.0, std=1.0, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        Trainer(TrainerConfig(n_devices=3, edge_shards=2),
                CGATConfig(**TINY), mean=0.0, std=1.0, device="cpu")
    with pytest.raises(ValueError, match="asks for 2 ranks; the world has 1"):
        Trainer(TrainerConfig(n_devices=2), CGATConfig(**TINY), mean=0.0,
                std=1.0, device="cpu")
    p = common.add_trainer_args(common.add_device_arg(
        common.add_model_args(__import__("argparse").ArgumentParser())))
    with pytest.raises(ValueError, match="--edge-shards 3 does not divide "
                                         "--devices 2"):
        common.configs_from_args(p.parse_args(
            ["--devices", "2", "--edge-shards", "3", "--device", "cpu"]))
    args = p.parse_args(["--devices", "0", "--device", "cpu"])
    assert common.configs_from_args(args)[0].n_devices == 1
