"""The port's device-side dropout (``ops/kernels/dropout.py``), on the CPU:
the plain Philox4x32-10 against Random123's published answers, the mask's
layout (element i takes word i % 4 of counter i // 4 at the step), the
keep rate and scale, the autograd Function's gradient, and the trainer
under dropout: K = 2 groups give K = 1's losses bit for bit, ``remat``
recomputes the same masks, a hyper-edge model trains, and a parallel
rank's sites keep their (dp, edge) place. The kernel against this plain
version, and replays drawing new masks, are ``tests/test_torch_gpu.py``'s.
"""
import numpy as np
import pytest
import torch

from cgat_tpu_torch.data import collate
from cgat_tpu_torch.data.synthetic import random_graphs
from cgat_tpu_torch.models import CGATConfig, CGAtNet, DropoutKey
from cgat_tpu_torch.models.init import init_state_dict
from cgat_tpu_torch.ops.kernels.dropout import (Dropout, dropout,
                                                dropout_plain, keep_mask,
                                                keep_scale, keep_threshold,
                                                philox4x32, site_key)
from cgat_tpu_torch.training import Trainer, TrainerConfig


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread a test (see ``tests/test_torch_dispatch.py``)."""
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

# Random123's known-answer tests of philox4x32_10 (counter, key, output)
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def _step(n):
    return torch.tensor(n, dtype=torch.int64)


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_plain_philox_gives_the_published_answers(ctr, key, want):
    got = philox4x32(torch.tensor(ctr, dtype=torch.int64), key)
    assert [int(v) for v in got] == list(want)


def test_mask_layout_counter_and_step():
    """Element i is kept by word i % 4 of Philox at counter (i // 4, 0,
    step's low and high words), its top 24 bits against the threshold; a
    step past 2**32 reaches the counter's fourth word."""
    key = site_key(0, 3)
    for step in (5, 2 ** 32 + 7):
        mask = keep_mask(22, key, _step(step), keep_threshold(0.4))
        for i in range(22):
            word = int(philox4x32(torch.tensor(
                [i // 4, 0, step & 0xffffffff, step >> 32],
                dtype=torch.int64), key)[i % 4])
            assert bool(mask[i]) == ((word >> 8) < round(0.6 * 2 ** 24))
    assert site_key(0, 3) != site_key(0, 4) != site_key(1, 3)
    assert all(0 <= k < 2 ** 32 for k in site_key(0, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_keep_rate_and_scale(dtype):
    """The kept share is 1 - rate within sampling noise; kept entries are
    x times the f32 scale rounded once to x's dtype; other steps draw
    other masks."""
    x = torch.randn(100_000, generator=torch.Generator().manual_seed(0)
                    ).to(dtype)
    y = dropout(x, 0.3, site_key(1, 2), _step(9))
    keep = keep_mask(x.numel(), site_key(1, 2), _step(9), keep_threshold(0.3))
    assert abs(float(keep.float().mean()) - 0.7) < 0.006
    assert torch.equal(y[keep], (x[keep].float() * keep_scale(0.3)).to(dtype))
    assert torch.equal(y[~keep], torch.zeros_like(y[~keep]))
    other = dropout(x, 0.3, site_key(1, 2), _step(10))
    assert not torch.equal(y, other)
    assert torch.equal(y, dropout_plain(x, 0.3, site_key(1, 2), _step(9)))


def test_gradient_is_the_same_mask_on_the_gradient():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((50, 3, 4)), dtype=torch.float32,
                     requires_grad=True)
    g = torch.tensor(rng.standard_normal((50, 3, 4)), dtype=torch.float32)
    key, step = site_key(4, 0), _step(3)
    y = Dropout.apply(x, 0.25, key, step)
    (gx,) = torch.autograd.grad(y, x, g)
    keep = keep_mask(x.numel(), key, step, keep_threshold(0.25)).view(x.shape)
    assert torch.equal(gx, torch.where(keep, g * keep_scale(0.25), 0.0))
    assert torch.equal(y.detach(), torch.where(keep, x.detach()
                                               * keep_scale(0.25), 0.0))


def _losses(k, mcfg, graphs, epochs=2):
    t = Trainer(TrainerConfig(**TRAIN, steps_per_dispatch=k), mcfg, graphs,
                device="cpu")
    t.init_state()
    loader = t.train_loader()
    losses = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        for b in loader:
            steps = t.train_group(b) if k > 1 else [t.train_step(b)]
            losses += [float(m["loss"]) for m in steps]
    assert t.step == int(t.step_count) == len(losses)
    return losses


def test_dispatch_groups_draw_single_steps_masks():
    """K = 2 groups (padded to a group's shapes) and K = 1 steps under
    dropout 0.2: the same losses bit for bit, every step of a group
    advancing the device step count; dropout changes them."""
    graphs = random_graphs(0, 40, **GRAPHS)
    drop = CGATConfig(**TINY, dropout=0.2)
    one = _losses(1, drop, graphs)
    assert len(one) == 16
    assert _losses(2, drop, graphs) == one
    assert _losses(1, CGATConfig(**TINY), graphs) != one


@pytest.mark.parametrize("mkw", [dict(remat=True), dict(hyper_remat=True)])
def test_remat_recomputes_the_same_masks(mkw):
    """Under dropout a rematerialised forward draws its layer's masks
    again in the backward: the loss and every gradient equal the plain
    forward's bit for bit."""
    graphs = random_graphs(1, 8, **GRAPHS)
    batch = collate(graphs, max_nbr=6, node_bucket=8, num_comp_slots=8)
    out = {}
    for name, kw in (("plain", {}), ("remat", mkw)):
        model = CGAtNet(CGATConfig(**TINY, dropout=0.3, **kw)).train()
        model.load_state_dict(init_state_dict(model, seed=0))
        loss = model(batch, dropout_key=DropoutKey((0,), _step(4)))[
            :, 0].square().sum()
        loss.backward()
        out[name] = (loss, {n: p.grad for n, p in model.named_parameters()})
    assert torch.equal(out["plain"][0], out["remat"][0])
    for n, g in out["plain"][1].items():
        assert (g is None) == (out["remat"][1][n] is None), n
        if g is not None:
            assert torch.equal(g, out["remat"][1][n]), n


def test_hyper_edge_dropout_step_trains():
    """``no_hyper=False`` with dropout: the edge layers' head weights are
    dropped too; steps train with finite losses that differ from the
    dropout-free model's."""
    graphs = random_graphs(2, 24, **GRAPHS)
    losses = {}
    for p in (0.0, 0.2):
        t = Trainer(TrainerConfig(**TRAIN), CGATConfig(
            **TINY, no_hyper=False, dropout=p), graphs, device="cpu")
        t.init_state()
        batches = list(t.loader(t.train_graphs, shuffle=True))[:3]
        losses[p] = [float(t.train_step(b)["loss"]) for b in batches]
        assert np.isfinite(losses[p]).all()
    assert losses[0.2] != losses[0.0]


def test_a_ranks_sites_keep_their_place_in_the_mesh():
    """A parallel rank's key path is (seed, dp_index, edge_index): every
    (dp, edge) place and the one-process path draw different masks at
    the same step and site."""
    step = _step(3)
    masks = [keep_mask(4096, site_key(*DropoutKey(path, step).site(2).path),
                       step, keep_threshold(0.1))
             for path in ((0,), (0, 0, 0), (0, 1, 0), (0, 0, 1))]
    assert all(not torch.equal(a, b)
               for i, a in enumerate(masks) for b in masks[i + 1:])
