"""The port's launch-count slice against cgat_tpu, on the CPU: the flat
optimizer (``training/flatten.py``) against the optimizer on the
parameters as they are and against ``cgat_tpu.training.flatten``; the
grouped loader against ``cgat_tpu.parallel.ParallelLoader``; a K-step
dispatch against ``make_multi_step``; ``fit`` with ``steps_per_dispatch``
against single steps, and a resume. On the card each step of a group is a
CUDA graph replay (``tests/test_torch_gpu.py``); here it is an eager step.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.parallel import ParallelLoader as JParallelLoader
from cgat_tpu.training import Trainer as JTrainer
from cgat_tpu.training import TrainerConfig as JTrainerConfig
from cgat_tpu.training.trainer import make_multi_step, make_train_step
from cgat_tpu.training.trainer import make_optimizer as jmake_optimizer
from cgat_tpu.training.trainer import set_learning_rate
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import CGATConfig, state_dict_from_jax
from cgat_tpu_torch.ops.attention import edge_softmax_aggregate
from cgat_tpu_torch.parallel import ParallelLoader, collate_group
from cgat_tpu_torch.training import (MultiSteps, Trainer, TrainerConfig,
                                     make_optimizer, resume_trainer)
from cgat_tpu_torch.training.flatten import DEFAULT_MAX_ELEMS, FlatOptimizer
from cgat_tpu_torch.training.optim import SGD, Adam, AdamW

# Start torch's CPU thread pool before JAX's runtime (see
# tests/test_torch_training.py).
torch.exp(torch.zeros(1 << 20))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test here on one torch thread: its ops are tiny, and beside
    the other test processes a thread pool a process only contends (the
    fits took ~70x longer on 6 workers than alone). Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TINY = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
            nbr_embedding_size=8, neighbor_number=6, msg_heads=2,
            n_graph_roost=1, out_hidden=(32, 32, 16))
GRAPHS = dict(n_atoms_range=(3, 7), max_nbr=6, orig_fea=16)
TRAIN = dict(batch_size=4, node_bucket=8, max_nbr=6, num_comp_slots=8,
             learning_rate=3e-3, check_val_every_n_epoch=1)
# two tensors above the flat optimizer's threshold, the rest below it
SHAPES = [(300, 256), (7, 5), (5,), (1,), (DEFAULT_MAX_ELEMS + 1,), (3,)]


def _params_and_grads(seed, n_steps):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(n_steps)]
    grads[1][2][:] = 0.0
    return params, grads


def _step(tp, opt, g):
    for i, (p, x) in enumerate(zip(tp, g)):
        # one parameter gets no gradient at all: updated as if it were 0
        p.grad = None if i == 3 else torch.from_numpy(x)
    opt.step()


OPTIMS = [("SGD", dict(weight_decay=0.01, momentum=0.5)),
          ("Adam", dict(weight_decay=0.01)),
          ("AdamW", dict(weight_decay=0.01)),
          ("AdamW", dict(weight_decay=0.01, moment_dtype="bfloat16"))]


def _plain_optimizer(optim, kw, params):
    """``make_optimizer``'s optimizer at lr 1e-2, on the parameters as
    they are (no flat layout)."""
    mu = dict(mu_dtype=getattr(torch, kw.get("moment_dtype", "float32")))
    if optim == "SGD":
        return SGD(params, 1e-2, momentum=kw["momentum"],
                   weight_decay=kw["weight_decay"])
    return {"Adam": Adam, "AdamW": AdamW}[optim](
        params, 1e-2, weight_decay=kw["weight_decay"], **mu)


@pytest.mark.parametrize("optim,kw", OPTIMS)
def test_flat_optimizer_is_bit_exact(optim, kw):
    """5 updates, the learning rate changed after 2: ``make_optimizer``'s
    flat optimizer gives the same bits as the plain one on the parameters
    as they are, its small parameters are views into one flat vector and
    its big ones untouched, and its state_dict has the plain one's
    per-parameter layout, which loads back either way and continues with
    the same bits."""
    init, grads = _params_and_grads(0, 7)
    runs = {}
    for flat in (False, True):
        tp = [torch.tensor(p, requires_grad=True) for p in init]
        opt = (make_optimizer(TrainerConfig(optim=optim, learning_rate=1e-2,
                                            **kw), tp)
               if flat else _plain_optimizer(optim, kw, tp))
        assert isinstance(opt, FlatOptimizer) == flat
        for i, g in enumerate(grads[:5]):
            opt.lr = 1e-2 if i < 2 else 3e-3
            _step(tp, opt, g)
        runs[flat] = tp, opt
    (tp, opt), (tf, fopt) = runs[False], runs[True]
    assert all(torch.equal(a, b) for a, b in zip(tp, tf))
    flat = fopt.layout.flat
    assert len(flat) == 1 and flat[0].numel() == sum(
        int(np.prod(s)) for s in SHAPES if np.prod(s) <= DEFAULT_MAX_ELEMS)
    base, end = flat[0].data_ptr(), flat[0].data_ptr() + 4 * flat[0].numel()
    assert [base <= p.data_ptr() < end for p in tf] == [
        np.prod(s) <= DEFAULT_MAX_ELEMS for s in SHAPES]
    state, fstate = opt.state_dict(), fopt.state_dict()
    assert state.keys() == fstate.keys() and state["step"] == fstate["step"]
    for name in state:
        if isinstance(state[name], list):
            assert all(torch.equal(a, b) and a.dtype == b.dtype
                       for a, b in zip(state[name], fstate[name],
                                       strict=True)), name
    # the plain run continues from the flat state and the flat from the
    # plain state
    opt.load_state_dict(fstate)
    fopt.load_state_dict(state)
    for g in grads[5:]:
        _step(tp, opt, g)
        _step(tf, fopt, g)
    assert all(torch.equal(a, b) for a, b in zip(tp, tf))


@pytest.mark.parametrize("optim,kw", OPTIMS)
def test_flat_optimizer_matches_cgat_tpu_flatten_small(optim, kw):
    """The flat optimizer against cgat_tpu's ``make_optimizer`` with
    ``flat_optimizer`` (``flatten_small``) on the same leaves and
    gradients: 5 updates, f32 to 1e-6 relative as the optimizers' own
    tests hold them."""
    init, grads = _params_and_grads(1, 5)
    jp = [jnp.asarray(p) for p in init]
    tx = jmake_optimizer(JTrainerConfig(optim=optim, learning_rate=1e-2,
                                        flat_optimizer=True, **kw), jp)
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in init]
    opt = make_optimizer(TrainerConfig(optim=optim, learning_rate=1e-2,
                                       **kw), tp)
    for i, g in enumerate(grads):
        lr = 1e-2 if i < 2 else 3e-3
        state = set_learning_rate(state, lr)
        jg = [jnp.zeros_like(x) if k == 3 else jnp.asarray(x)
              for k, x in enumerate(g)]
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.lr = lr
        _step(tp, opt, g)
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optim,kw", OPTIMS[:3])
def test_flat_optimizer_flag_has_no_effect(optim, kw):
    """``flat_optimizer`` is the JAX package's flag; the port flattens
    SGD, Adam and AdamW whatever it says: the same optimizer and the same
    bits either way."""
    init, grads = _params_and_grads(3, 3)
    runs = []
    for flag in (False, True):
        tp = [torch.tensor(p, requires_grad=True) for p in init]
        opt = make_optimizer(TrainerConfig(optim=optim, flat_optimizer=flag,
                                           **kw), tp)
        assert isinstance(opt, FlatOptimizer)
        for g in grads:
            _step(tp, opt, g)
        runs.append(tp)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_update_count_is_exact_past_f32_integers():
    """The update count is an int32 on the device, as optax keeps it: it
    goes on counting past 2**24, where an f32 count would stop, so a
    checkpoint's step stays right."""
    init, grads = _params_and_grads(4, 3)
    tp = [torch.tensor(p, requires_grad=True) for p in init]
    opt = make_optimizer(TrainerConfig(), tp)
    state = opt.state_dict()
    opt.load_state_dict({**state, "step": 2 ** 24})
    for g in grads:
        _step(tp, opt, g)
    assert opt.count == opt.state_dict()["step"] == 2 ** 24 + 3
    assert opt.inner._count.dtype == torch.int32


@pytest.mark.parametrize("kw", [dict(optim="LAMB"),
                                dict(optim="AdamW", only_residual=True)])
def test_flat_flag_leaves_lamb_and_only_residual_alone(kw):
    """As in cgat_tpu's ``make_optimizer``: LAMB's trust ratio is per
    tensor and ``only_residual`` passes a subset, so the flag does
    nothing there: the same optimizer, the parameters' own storage, the
    same bits."""
    init, grads = _params_and_grads(2, 3)
    runs = []
    for flat in (False, True):
        tp = [torch.tensor(p, requires_grad=True) for p in init]
        ptrs = [p.data_ptr() for p in tp]
        opt = make_optimizer(TrainerConfig(flat_optimizer=flat, **kw), tp)
        assert type(opt).__name__ == kw["optim"]
        assert [p.data_ptr() for p in tp] == ptrs
        for g in grads:
            _step(tp, opt, g)
        runs.append(tp)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("drop_last", [True, False])
def test_parallel_loader_equals_cgat_tpu(drop_last):
    """Groups of 3 batches padded to the group's largest node bucket,
    stacked: field for field cgat_tpu's ``ParallelLoader`` over two
    epochs, with the same lengths and real counts."""
    graphs = random_graphs(4, 29, **GRAPHS)
    jgraphs = jrandom_graphs(4, 29, **GRAPHS)
    kw = dict(shuffle=True, seed=3, max_nbr=6, node_bucket=8,
              drop_last=drop_last)
    port = ParallelLoader(graphs, 4, 3, **kw)
    ref = JParallelLoader(jgraphs, 4, 3, **kw)
    assert len(port) == len(ref) == (2 if drop_last else 3)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        n = 0
        for b, jb in zip(port, ref, strict=True):
            assert port.last_counts == ref.last_counts
            for name in b.__dataclass_fields__:
                want = np.asarray(getattr(jb, name))
                assert want.shape[0] == 3, name
                np.testing.assert_array_equal(getattr(b, name).numpy(),
                                              want, err_msg=name)
            n += 1
        assert n == len(port)


def test_grouping_across_shards_or_processes_raises():
    """Edge shards and process slicing group (slice 4); replicas that do
    not split over the processes raise."""
    graphs = random_graphs(0, 12, **GRAPHS)
    group = next(iter(ParallelLoader(graphs, 4, 2, edge_shards=2, max_nbr=6,
                                     node_bucket=8)))
    assert group.halo_send_idx.shape[:2] == (2, 4)
    with pytest.raises(ValueError, match="not divisible"):
        ParallelLoader(graphs, 4, 3, process_count=2)
    with pytest.raises(ValueError, match="do not split"):
        collate_group([graphs[:4], graphs[4:8], graphs[8:]], batch_size=4,
                      max_nbr=6, node_bucket=8, num_comp_slots=8,
                      process_count=2)


def _pair(tkw=None, mkw=None):
    """cgat_tpu's trainer and the port's (on the CPU) from the same weights
    on the same graphs."""
    tkw, mkw = tkw or {}, mkw or {}
    jt = JTrainer(JTrainerConfig(**TRAIN, **tkw), JConfig(**TINY, **mkw),
                  jrandom_graphs(0, 40, **GRAPHS))
    state = jt.init_state()
    cfg = CGATConfig(**TINY, **mkw)
    t = Trainer(TrainerConfig(**TRAIN, **tkw), cfg, random_graphs(0, 40,
                                                                 **GRAPHS),
                device="cpu")
    t.init_state(state_dict_from_jax(jax.tree.map(np.array, state.params),
                                     cfg))
    return jt, state, t


def test_dispatch_matches_cgat_tpu_multi_step():
    """Two dispatches of K = 3 steps (``train_group`` over the grouped
    loader) against cgat_tpu's ``make_multi_step`` on the same groups:
    the port's per-step losses against cgat_tpu's single steps, and each
    dispatch's mean metrics against make_multi_step's, to 1e-4 relative
    (the tolerance of ``test_trainer_variants_match_cgat_tpu``); the
    second dispatch starts from each side's state after the first."""
    jt, state, t = _pair(dict(steps_per_dispatch=3, flat_optimizer=True))
    multi = make_multi_step(jt.model, jt.tx, jt.criterion, jt.mean, jt.std,
                            donate=False)
    single = make_train_step(jt.model, jt.tx, jt.criterion, jt.mean, jt.std,
                             donate=False)
    groups = list(t.grouped_loader(t.train_graphs))
    jgroups = list(jt._grouped_loader(3))
    assert len(groups) == len(jgroups) == 2
    sstate = state
    for group, jgroup in zip(groups, jgroups):
        got = t.train_group(group)
        assert len(got) == 3 and t.step == int(sstate.step) + 3
        want = []
        for k in range(3):
            sstate, m = single(sstate, jax.tree.map(lambda x: x[k], jgroup))
            want.append(float(m["loss"]))
        np.testing.assert_allclose([float(m["loss"]) for m in got], want,
                                   rtol=1e-4)
        state, jm = multi(state, jgroup)
        for key in ("loss", "mae", "rmse"):
            np.testing.assert_allclose(
                float(torch.stack([m[key] for m in got]).mean()),
                float(jm[key]), rtol=1e-4, err_msg=key)


def _train_losses(run_dir):
    return [r["train_loss"] for r in map(
        json.loads, (run_dir / "metrics.jsonl").read_text().splitlines())
        if "train_loss" in r]


@pytest.mark.parametrize("tkw", [dict(), dict(acc_batches=2),
                                 dict(optim="Adam")])
def test_fit_with_steps_per_dispatch_matches_single_steps(tmp_path, tkw):
    """``fit`` over 3 epochs with K = 2 logs the train losses of K = 1 to
    1e-6 relative (the port's counterpart of cgat_tpu's
    ``test_fit_with_steps_per_dispatch``): the same batches in the same
    order, padded to a group's shape, and the same updates; under
    ``acc_batches`` 2 a group's steps are the two mini-steps of an
    update. An epoch of 8 batches trains 8 steps."""
    graphs = random_graphs(0, 40, **GRAPHS)
    runs = {}
    for k in (1, 2):
        t = Trainer(TrainerConfig(**TRAIN, **tkw, steps_per_dispatch=k,
                                  epochs=3, ckpt_dir=str(tmp_path),
                                  run_name=f"k{k}"),
                    CGATConfig(**TINY), graphs, device="cpu")
        hist = t.fit()
        assert t.step == 3 * 8 and len(hist) == 3
        runs[k] = _train_losses(tmp_path / "runs" / f"k{k}")
    np.testing.assert_allclose(runs[2], runs[1], rtol=1e-6)


def test_resume_of_a_flat_dispatch_run_is_exact(tmp_path):
    """A run with the flat optimizer and K = 2: 3 epochs straight, and 1
    then a resume to 3 (with ``flat_optimizer`` either way: no effect),
    log the same metrics; the checkpoint's optimizer state has the
    per-parameter layout and loads into AdamW on the parameters as they
    are."""
    graphs = random_graphs(0, 40, **GRAPHS)
    tkw = dict(TRAIN, ckpt_dir=str(tmp_path), steps_per_dispatch=2,
               moment_dtype="bfloat16")
    hist = {}
    for name, epochs in (("straight", 3), ("split", 1)):
        t = Trainer(TrainerConfig(**tkw, run_name=name, epochs=epochs),
                    CGATConfig(**TINY), graphs, device="cpu")
        hist[name] = t.fit()
    run = tmp_path / "runs" / "split"
    ckpt = torch.load(run / "checkpoints" / "last.pt", weights_only=True)
    params = list(t.model.parameters())
    assert [m.shape for m in ckpt["optimizer"]["mu"]] == [p.shape
                                                          for p in params]
    assert all(m.dtype == torch.bfloat16 for m in ckpt["optimizer"]["mu"])
    plain = AdamW([p.detach().clone() for p in params], 1e-3,
                  mu_dtype=torch.bfloat16)
    plain.load_state_dict(ckpt["optimizer"])
    assert plain.count == 8
    resumed = {}
    for flat in (True, False):
        t, meta = resume_trainer(str(run), graphs=graphs, device="cpu",
                                 flat_optimizer=flat, epochs=3,
                                 run_name=f"resumed_{flat}")
        assert isinstance(t.opt, FlatOptimizer) and t.step == 8
        resumed[flat] = hist["split"] + t.fit(
            start_epoch=meta["epoch"] + 1, best_val=meta["best_val"],
            plateau_state=meta["plateau"], last_val_mae=meta["val_mae"])
    keys = [k for k in hist["straight"][0] if k.startswith(("train_",
                                                            "val_"))]
    for flat in (True, False):
        for a, b in zip(resumed[flat], hist["straight"], strict=True):
            for k in keys:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6,
                                           err_msg=f"{flat} {k}")


def test_dropout_and_bad_counts_with_steps_per_dispatch_raise():
    """Dropout's masks come from the device step count, so dropout with
    K > 1 trains (its losses are K = 1's: ``tests/test_torch_dropout.py``)
    and no error names dropout; a bad count still raises."""
    graphs = random_graphs(0, 12, **GRAPHS)
    t = Trainer(TrainerConfig(**TRAIN, steps_per_dispatch=2),
                CGATConfig(**TINY, dropout=0.1), graphs, device="cpu")
    t.init_state()
    got = t.train_group(next(iter(t.grouped_loader(t.train_graphs))))
    assert len(got) == 2 and t.step == int(t.step_count) == 2
    assert all(np.isfinite(float(m["loss"])) for m in got)
    t = Trainer(TrainerConfig(**TRAIN, steps_per_dispatch=2, acc_batches=2),
                CGATConfig(**TINY), graphs, device="cpu")
    t.init_state()
    assert isinstance(t.opt, MultiSteps)
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        Trainer(TrainerConfig(steps_per_dispatch=0), CGATConfig(**TINY),
                graphs, device="cpu")


def test_edge_softmax_aggregate_without_a_mask_counts_every_row():
    """With no edge mask the real-row count is filled on the device (no
    host-to-device copy, which a graph capture refuses): the same output
    and gradients as an all-True mask."""
    rng = np.random.default_rng(5)
    dst = torch.from_numpy(np.sort(rng.integers(0, 9, 40)).astype(np.int32))
    alpha = torch.tensor(rng.standard_normal((40, 2, 3)), dtype=torch.float32,
                         requires_grad=True)
    m = torch.tensor(rng.standard_normal((40, 2, 3)), dtype=torch.float32,
                     requires_grad=True)
    outs, grads = [], []
    for mask in (None, torch.ones(40, dtype=torch.bool)):
        out = edge_softmax_aggregate(alpha, m, dst, 9, edge_mask=mask)
        outs.append(out)
        grads.append(torch.autograd.grad(out.square().sum(), (alpha, m)))
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
