"""The port's training slice against cgat_tpu's trainer, on the CPU: splits,
loader, losses, schedules, AdamW against optax, and the slice as a whole,
a 25-step loss curve of the same model, weights and batches."""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from cgat_tpu.data.dataset import GraphLoader as JGraphLoader
from cgat_tpu.data.dataset import split_dataset as jsplit_dataset
from cgat_tpu.data.synthetic import random_graphs as jrandom_graphs
from cgat_tpu.models import CGATConfig as JConfig
from cgat_tpu.training import Trainer as JTrainer
from cgat_tpu.training import TrainerConfig as JTrainerConfig
from cgat_tpu.training import losses as jlosses
from cgat_tpu.training import schedules as jschedules
from cgat_tpu.training.trainer import make_optimizer as jmake_optimizer
from cgat_tpu.training.trainer import make_train_step, set_learning_rate
from cgat_tpu_torch.data.dataset import GraphLoader, split_dataset
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import (CGATConfig, init_state_dict,
                                   state_dict_from_jax)
from cgat_tpu_torch.ops.kernels import (hyper_apply, mh_network,
                                        segment_attention, segment_sum)
from cgat_tpu_torch.training import (AdamW, MultiSteps, Trainer,
                                     TrainerConfig, make_optimizer,
                                     resume_trainer)
from cgat_tpu_torch.training import losses, schedules
from cgat_tpu_torch.training.flatten import FlatOptimizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# Start torch's CPU thread pool now: its first parallel kernel after JAX's
# CPU runtime has started can come out less exact (torch.exp off by ~1e-4
# relative, once), which the f32 comparisons below would see.
torch.exp(torch.zeros(1 << 20))

TINY = dict(orig_elem_fea_len=16, elem_fea_len=16, n_graph=2,
            nbr_embedding_size=8, neighbor_number=6, msg_heads=2,
            n_graph_roost=1, out_hidden=(32, 32, 16))
GRAPHS = dict(n_atoms_range=(3, 7), max_nbr=6, orig_fea=16)
TRAIN = dict(batch_size=4, node_bucket=8, max_nbr=6, num_comp_slots=8,
             learning_rate=3e-3, check_val_every_n_epoch=1)


@pytest.mark.parametrize("n,seed,pct", [(10, 0, 0.0), (37, 3, 0.0),
                                        (200, 7, 0.0), (120, 1, 0.5)])
def test_split_dataset_equals_cgat_tpu(n, seed, pct):
    kw = dict(seed=seed, val_size=0.1, test_size=0.1, train_percentage=pct)
    assert split_dataset(n, **kw) == tuple(
        list(map(int, s)) for s in jsplit_dataset(n, **kw))


def test_graph_loader_batches_equal_cgat_tpu():
    graphs = random_graphs(2, 23, **GRAPHS)
    jgraphs = jrandom_graphs(2, 23, **GRAPHS)
    kw = dict(shuffle=True, seed=5, max_nbr=6, node_bucket=8)
    for drop_last in (True, False):
        port = GraphLoader(graphs, 4, drop_last=drop_last, **kw)
        ref = JGraphLoader(jgraphs, 4, drop_last=drop_last, **kw)
        assert len(port) == len(ref) and port.max_degree == ref.max_degree
        for epoch in (0, 3):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            for b, jb in zip(port, ref, strict=True):
                for name in b.__dataclass_fields__:
                    np.testing.assert_array_equal(
                        getattr(b, name).numpy(),
                        np.asarray(getattr(jb, name)), err_msg=name)


def test_losses_and_schedules_equal_cgat_tpu():
    rng = np.random.default_rng(0)
    o, s, t = (rng.standard_normal(12).astype(np.float32) for _ in range(3))
    mask = np.arange(12) < 9
    for name in ("robust_l1", "robust_l2"):
        got = getattr(losses, name)(*(torch.from_numpy(a) for a in (o, s, t)),
                                    torch.from_numpy(mask))
        want = getattr(jlosses, name)(o, s, t, mask)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for name, robust in (("L1", False), ("L2", False), ("L1", True)):
        got = losses.make_loss(name, robust)(
            *(torch.from_numpy(a) for a in (o, s, t)), torch.from_numpy(mask))
        want = jlosses.make_loss(name, robust)(o, s, t, mask)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    clr = schedules.cyclical_lr(period=13, cycle_mul=0.1)
    jclr = jschedules.cyclical_lr(period=13, cycle_mul=0.1)
    assert [clr(e) for e in range(40)] == [jclr(e) for e in range(40)]
    plateau, jplateau = schedules.ReduceLROnPlateau(), \
        jschedules.ReduceLROnPlateau()
    metrics = [1.0, 0.9, 0.95] + [0.95] * 12 + [0.5] + [0.6] * 8
    assert [plateau.step(m) for m in metrics] == [jplateau.step(m)
                                                  for m in metrics]


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adamw_matches_optax(mu_dtype):
    """20 updates of the same parameters with the same gradients, with the
    learning rate changed half way. f32 to 1e-6 relative (the order of
    operations is optax's; division by a scalar may round differently)."""
    rng = np.random.default_rng(1)
    shapes = [(7, 5), (5,), (1,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(20)]
    grads[3][2][:] = 0.0
    jdt = jnp.bfloat16 if mu_dtype == "bfloat16" else jnp.float32
    tx = optax.inject_hyperparams(
        lambda learning_rate: optax.adamw(learning_rate, weight_decay=0.01,
                                          mu_dtype=jdt),
        hyperparam_dtype=jnp.float32)(learning_rate=1e-2)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = AdamW(tp, 1e-2, weight_decay=0.01,
                mu_dtype=getattr(torch, mu_dtype))
    for i, g in enumerate(grads):
        lr = 1e-2 if i < 10 else 3e-3
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.lr = lr
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
    mu = state.inner_state[0].mu
    assert all(m.dtype == getattr(torch, mu_dtype) for m in opt.mu)
    for m, w in zip(opt.mu, mu):
        np.testing.assert_allclose(m.float().numpy(), np.asarray(w, np.float32),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("optim,kw", [
    ("SGD", dict(weight_decay=0.0)),
    ("SGD", dict(weight_decay=0.01, momentum=0.5)),
    ("Adam", dict(weight_decay=0.01)),
    ("Adam", dict(weight_decay=0.01, moment_dtype="bfloat16")),
    ("LAMB", dict(weight_decay=0.01)),
    ("LAMB", dict(weight_decay=0.0)),
    ("LAMB", dict(weight_decay=0.01, acc_batches=2)),
    ("Adam", dict(weight_decay=0.01, acc_batches=3)),
])
def test_optimizers_match_optax(optim, kw):
    """SGD, Adam and LAMB against the JAX package's ``make_optimizer``
    (optax, and ``cgat_tpu.training.lamb``; ``optax.MultiSteps`` under
    ``acc_batches``): 20 updates of the same parameters with the same
    gradients, the learning rate changed half way as ``set_learning_rate``
    changes it (through MultiSteps to the inner optimizer). f32 to 1e-6
    relative. An all-zero parameter and a zero gradient take LAMB's 1.0
    trust fallbacks."""
    rng = np.random.default_rng(2)
    shapes = [(7, 5), (5,), (1,), (3,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params[3][:] = 0.0
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(20)]
    grads[3][2][:] = 0.0
    jp = [jnp.asarray(p) for p in params]
    tx = jmake_optimizer(JTrainerConfig(optim=optim, learning_rate=1e-2,
                                        **kw), jp)
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = make_optimizer(TrainerConfig(optim=optim, learning_rate=1e-2,
                                       **kw), tp)
    inner = opt.inner if kw.get("acc_batches", 1) > 1 else opt
    if optim != "LAMB":
        # SGD and Adam run over the small parameters flattened
        assert isinstance(inner, FlatOptimizer)
        inner = inner.inner
    assert type(inner).__name__ == optim
    for i, g in enumerate(grads):
        lr = 1e-2 if i < 10 else 3e-3
        state = set_learning_rate(state, lr)
        upd, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        opt.lr = lr
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
    if optim == "Adam":
        assert all(m.dtype == getattr(torch, kw.get("moment_dtype",
                                                    "float32"))
                   for m in inner.mu)


def test_multisteps_and_optimizer_state_round_trip():
    """MultiSteps leaves the parameters as they are on all but every k-th
    mini-step, and every optimizer's state_dict restores into a fresh one
    that then takes the same next step; state of another optimizer or
    dtype raises."""
    rng = np.random.default_rng(3)
    init = [rng.standard_normal(s).astype(np.float32) for s in [(4, 3), (3,)]]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in init]
             for _ in range(7)]

    def build(optim, acc):
        tp = [torch.tensor(p, requires_grad=True) for p in init]
        return tp, make_optimizer(TrainerConfig(optim=optim, acc_batches=acc,
                                                weight_decay=0.01), tp)

    def step(tp, opt, g):
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()

    for optim in ("SGD", "Adam", "AdamW", "LAMB"):
        tp, opt = build(optim, 3)
        assert isinstance(opt, MultiSteps)
        for i, g in enumerate(grads[:5]):
            before = [p.detach().clone() for p in tp]
            step(tp, opt, g)
            same = all(torch.equal(a, b) for a, b in zip(before, tp))
            assert same == (i % 3 != 2), (optim, i)
        tp2, opt2 = build(optim, 3)
        for p, q in zip(tp2, tp):
            p.data.copy_(q.data)
        opt2.load_state_dict(opt.state_dict())
        for g in grads[5:]:
            step(tp, opt, g)
            step(tp2, opt2, g)
        assert all(torch.equal(a, b) for a, b in zip(tp, tp2)), optim
    _, sgd = build("SGD", 1)
    _, lamb = build("LAMB", 1)
    with pytest.raises(ValueError, match="SGD"):
        lamb.load_state_dict(sgd.state_dict())
    _, acc = build("LAMB", 2)
    with pytest.raises(ValueError, match="acc-batches 2"):
        acc.load_state_dict(lamb.state_dict())
    state = lamb.state_dict()
    state["exp_avg"] = [t.to(torch.bfloat16) for t in state["exp_avg"]]
    with pytest.raises(ValueError, match="bfloat16"):
        lamb.load_state_dict(state)


@pytest.mark.parametrize("tkw", [dict(acc_batches=3),
                                 dict(only_residual=True),
                                 dict(optim="LAMB", acc_batches=2),
                                 dict(no_hyper=False),
                                 dict(update_edges=False)])
def test_trainer_variants_match_cgat_tpu(tkw):
    """9 steps of the f32 tiny model under gradient accumulation, with
    only the output head training, or as the hyper-edge or node-only
    model (``tkw``'s CGATConfig fields), from the same weights over the
    same batches as cgat_tpu's train step: the losses agree to 1e-4
    relative, a mini-step that emits no update leaves every parameter
    bit-identical, and under only_residual every parameter outside
    ``output_nn`` stays bit-identical to its initial value."""
    model_fields = {f.name for f in dataclasses.fields(CGATConfig)}
    mkw = {k: v for k, v in tkw.items() if k in model_fields}
    tkw = {k: v for k, v in tkw.items() if k not in model_fields}
    graphs = random_graphs(0, 40, **GRAPHS)
    jt = JTrainer(JTrainerConfig(**TRAIN, **tkw), JConfig(**TINY, **mkw),
                  jrandom_graphs(0, 40, **GRAPHS))
    state = jt.init_state()
    cfg = CGATConfig(**TINY, **mkw)
    t = Trainer(TrainerConfig(**TRAIN, **tkw), cfg, graphs, device="cpu")
    t.init_state(state_dict_from_jax(jax.tree.map(np.array, state.params),
                                     cfg))
    init = {k: v.clone() for k, v in t.model.state_dict().items()}
    step = make_train_step(jt.model, jt.tx, jt.criterion, jt.mean, jt.std,
                           donate=False)
    batches = list(t.loader(t.train_graphs, shuffle=True))
    jbatches = list(jt._loader(jt.train_graphs, shuffle=True))
    acc = tkw.get("acc_batches", 1)
    got, want = [], []
    for i in range(9):
        state, m = step(state, jbatches[i % len(jbatches)])
        want.append(float(m["loss"]))
        before = [p.detach().clone() for p in t.model.parameters()]
        got.append(float(t.train_step(batches[i % len(batches)])["loss"]))
        unchanged = all(torch.equal(a, b)
                        for a, b in zip(before, t.model.parameters()))
        assert unchanged == (i % acc != acc - 1), i
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if tkw.get("only_residual"):
        for k, v in t.model.state_dict().items():
            assert torch.equal(v, init[k]) != k.startswith("output_nn."), k
        assert all(not p.requires_grad
                   for n, p in t.model.named_parameters()
                   if not n.startswith("output_nn."))


def test_dropout_masks_replay_on_resume(tmp_path):
    """Model dropout in training: 3 epochs straight, and 1 epoch then a
    resume to 3, log the same metrics (the masks come from the seed and
    the step count, which the checkpoint keeps); the masks change the
    losses against a dropout-free run; evaluation runs without dropout."""
    graphs = random_graphs(0, 40, **GRAPHS)
    mcfg = CGATConfig(**TINY, dropout=0.2)
    tkw = dict(TRAIN, ckpt_dir=str(tmp_path), epochs=3, optim="LAMB",
               acc_batches=2, batch_size=10, learning_rate=1e-3)
    hist = {}
    for name, cfg, epochs in (("straight", mcfg, 3), ("split", mcfg, 1),
                              ("plain", CGATConfig(**TINY), 3)):
        t = Trainer(TrainerConfig(**tkw, run_name=name), cfg, graphs,
                    device="cpu")
        hist[name] = t.fit(epochs=epochs)
    run = tmp_path / "runs" / "split"
    t, meta = resume_trainer(str(run), graphs=graphs, device="cpu")
    assert isinstance(t.opt, MultiSteps) and t.opt.mini_step == 1
    hist["split"] += t.fit(start_epoch=meta["epoch"] + 1,
                           best_val=meta["best_val"],
                           plateau_state=meta["plateau"],
                           last_val_mae=meta["val_mae"])
    keys = [k for k in hist["straight"][0] if k.startswith(("train_",
                                                            "val_"))]
    for a, b in zip(hist["split"], hist["straight"], strict=True):
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
    assert hist["plain"][0]["train_loss"] != hist["straight"][0]["train_loss"]
    no_drop = Trainer(TrainerConfig(**tkw), CGATConfig(**TINY), graphs,
                      device="cpu")
    no_drop.init_state(t.model.state_dict())
    assert t.model.training
    assert t.evaluate_split(t.val_graphs) == no_drop.evaluate_split(
        no_drop.val_graphs)


def test_train_steps_match_cgat_tpu():
    """The slice as a whole: 25 steps of the f32 tiny model from the same
    weights over the same batches. The first loss agrees to 1e-5 relative;
    the curve is held at 1e-4 relative (measured: 9.5e-6 at most over the
    25 steps, summation order drifting through AdamW's updates)."""
    graphs = random_graphs(0, 40, **GRAPHS)
    jt = JTrainer(JTrainerConfig(**TRAIN), JConfig(**TINY),
                  jrandom_graphs(0, 40, **GRAPHS))
    state = jt.init_state()
    cfg = CGATConfig(**TINY)
    t = Trainer(TrainerConfig(**TRAIN), cfg, graphs, device="cpu")
    t.init_state(state_dict_from_jax(jax.tree.map(np.array, state.params),
                                     cfg))
    assert (t.mean, t.std) == (jt.mean, jt.std)
    step = make_train_step(jt.model, jt.tx, jt.criterion, jt.mean, jt.std,
                           donate=False)
    batches = list(t.loader(t.train_graphs, shuffle=True))
    jbatches = list(jt._loader(jt.train_graphs, shuffle=True))
    got, want = [], []
    for i in range(25):
        state, m = step(state, jbatches[i % len(jbatches)])
        want.append(float(m["loss"]))
        got.append(float(t.train_step(batches[i % len(batches)])["loss"]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    damping = [p for n, p in t.model.named_parameters()
               if n.endswith("damping")]
    assert damping and all(0 <= float(d.detach()[0]) <= 1 for d in damping)
    # evaluation and prediction on the trained weights
    params = state.params
    jval = jt.evaluate_split(params, jt.val_graphs)
    val = t.evaluate_split(t.val_graphs)
    for k in ("loss", "mae", "rmse"):
        np.testing.assert_allclose(val[k], jval[k], rtol=1e-3)
    np.testing.assert_allclose(t.predict(t.test_graphs),
                               jt.predict(params, jt.test_graphs),
                               rtol=1e-3, atol=1e-4)


def test_bf16_first_moment_tracks_f32_trajectory():
    """The port's counterpart of cgat_tpu's test of the same name, on its
    model, data, weights and batch: a bf16 first moment tracks the
    f32-moment loss curve over 25 steps (rtol 0.05, atol 0.02, as there)
    and still trains."""
    tiny = dict(orig_elem_fea_len=16, elem_fea_len=8, n_graph=2,
                nbr_embedding_size=8, neighbor_number=4, msg_heads=2,
                n_graph_roost=1, out_hidden=(16, 8))
    train = dict(batch_size=4, node_bucket=8, num_comp_slots=8, max_nbr=4,
                 learning_rate=3e-3)
    gkw = dict(n_atoms_range=(3, 6), max_nbr=4, orig_fea=16)
    jt = JTrainer(JTrainerConfig(**train), JConfig(**tiny),
                  jrandom_graphs(0, 24, **gkw))
    sd = state_dict_from_jax(jax.tree.map(np.array, jt.init_state().params),
                             CGATConfig(**tiny))
    curves = {}
    for md in ("float32", "bfloat16"):
        t = Trainer(TrainerConfig(**train, moment_dtype=md),
                    CGATConfig(**tiny), random_graphs(0, 24, **gkw),
                    device="cpu")
        t.init_state(sd)
        batch = next(iter(t.loader(t.train_graphs[:4], shuffle=False)))
        curves[md] = [float(t.train_step(batch)["loss"]) for _ in range(25)]
        assert all(m.dtype == getattr(torch, md)
                   for m in t.opt.state_dict()["mu"])
    f32, bf16 = np.asarray(curves["float32"]), np.asarray(curves["bfloat16"])
    assert bf16[-1] < f32[0] * 0.7
    np.testing.assert_allclose(bf16, f32, rtol=0.05, atol=0.02)


def test_bf16_train_step_runs_every_plain_backward(monkeypatch):
    """One bf16 CPU step of a 128-wide model: every autograd Function runs
    its plain forward and backward, the master grads are f32 and finite,
    and the first moment is bf16."""
    small = dict(orig_elem_fea_len=16, elem_fea_len=128, n_graph=2,
                 nbr_embedding_size=128, neighbor_number=16, msg_heads=5,
                 n_graph_roost=1, out_hidden=(16,), compute_dtype="bfloat16")
    graphs = random_graphs(0, 30, n_atoms_range=(5, 9), max_nbr=16,
                           orig_fea=16, full_degree=True)
    t = Trainer(TrainerConfig(batch_size=6, node_bucket=16, max_nbr=16,
                              moment_dtype="bfloat16"),
                CGATConfig(**small), graphs, device="cpu")
    t.init_state()
    calls = {}
    for mod in (mh_network, hyper_apply, segment_attention, segment_sum):
        for name in dir(mod):
            if name.endswith("_plain"):
                real = getattr(mod, name)

                def counted(*a, _real=real, _name=name, **k):
                    calls[_name] = calls.get(_name, 0) + 1
                    return _real(*a, **k)
                monkeypatch.setattr(mod, name, counted)
    batch = next(iter(t.loader(t.train_graphs, shuffle=True)))
    loss, _ = t.forward_loss(batch)
    t.backward(loss)
    n = small["n_graph"]
    assert calls == {"mh_network_plain": 2 * n,
                     "segment_attention_plain": n + 1,
                     "hyper_apply_plain": 4 * n,
                     "mh_network_bwd_plain": 2 * n,
                     "segment_attention_bwd_plain": n + 1,
                     "hyper_apply_bwd_dhdx_plain": 4 * n,
                     "hyper_apply_bwd_dk_plain": 4 * n,
                     "segment_sum_plain": 2 * n + 1}
    grads = [p.grad for p in t.model.parameters() if p.grad is not None]
    assert all(g.dtype == torch.float32 for g in grads)
    assert torch.isfinite(torch.stack(torch._foreach_norm(grads))).all()
    t.apply_update()
    assert all(m.dtype == torch.bfloat16 for m in t.opt.state_dict()["mu"])
    assert torch.isfinite(loss)


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """Nothing is left unported: ``profile_epoch`` traces its epoch (the
    fit below); what is refused is a config that cannot run."""
    from cgat_tpu_torch.utils.profiling import trace_files, trace_kernels

    graphs = random_graphs(0, 12, **GRAPHS)
    # streaming is ported: without a validation path it raises cgat_tpu's
    # error, before the training shards are read
    with pytest.raises(ValueError, match="streaming=True requires"):
        Trainer(TrainerConfig(streaming=True, data_path="no/such/dir"),
                CGATConfig(**TINY), graphs, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(TrainerConfig(), CGATConfig(**TINY), graphs)
    t = Trainer(TrainerConfig(**TRAIN, ckpt_dir=str(tmp_path),
                              profile_epoch=0),
                CGATConfig(**TINY), graphs, device="cpu")
    model = t.init_state()
    again = init_state_dict(model, seed=0)
    assert all(torch.equal(v, again[k]) for k, v in model.state_dict().items())
    history = t.fit(epochs=2)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) and "val_mae" in h
               for h in history)
    # epoch 0's steps, traced under the run's profile directory
    path, = trace_files(os.path.join(t.last_log_dir, "profile"))
    assert trace_kernels(path)["span:train_step"][1] == t.step // 2
