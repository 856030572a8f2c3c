"""The fused AdamW pass's host side, on the CPU: its launch plan, its gate,
and CPU tensors taking the ``_foreach`` sequence.

The kernel itself (``csrc/adamw.cu``) runs only on a card: its bits
against the ``_foreach`` sequence are held in ``tests/test_torch_gpu.py``.
"""
import ctypes

import pytest
import torch

from cgat_tpu_torch.models import CGATConfig, CGAtNet
from cgat_tpu_torch.ops.kernels import adamw as fused
from cgat_tpu_torch.training import AdamW, MultiSteps
from cgat_tpu_torch.training.flatten import FlatLayout
from cgat_tpu_torch.training.optim import fused_stats


def _flat_numels(**kw):
    """The tensor lengths of a full-width model's flat layout (shapes
    from the meta device: nothing allocated)."""
    with torch.device("meta"):
        model = CGAtNet(CGATConfig(compute_dtype="bfloat16", **kw))
    layout = FlatLayout([p.detach() for p in model.parameters()])
    return [t.numel() for t in layout.inner]


@pytest.mark.parametrize("numels", [
    [], [0], [1], [3], [0, 5, 0], [fused.CHUNK], [fused.CHUNK + 1],
    [1, 3, 5, 7, 4095, 4097, 10001, 65537],
    [7] * fused.MAX_TENSORS, [7] * (fused.MAX_TENSORS + 1),
    [9, 0, 130] * 100, "default", "hyperedge"])
def test_launch_plan_covers_every_element_once(numels):
    """Every element of every tensor falls in exactly one chunk of exactly
    one launch, found as the kernel finds it (the last table entry whose
    first chunk is at or below the chunk), each chunk a whole multiple of
    4 elements from the tensor's start; no launch holds more tensors than
    its table, the table fits the 4 KB of kernel parameters, and empty
    tensors take no place. The default model's flat layout is one launch,
    the hyper-edge model's two."""
    named = numels if isinstance(numels, str) else None
    if numels == "default":
        numels = _flat_numels()
        assert sum(numels) == 62_293_836
    elif numels == "hyperedge":
        numels = _flat_numels(no_hyper=False)
        assert sum(numels) == 106_050_640
    launches = fused.plan(numels)
    assert ctypes.sizeof(fused.Table) <= fused.PARAM_BYTES
    assert fused.CHUNK % 4 == 0
    covered = {}
    for tensors, chunks in launches:
        assert 1 <= len(tensors) <= fused.MAX_TENSORS
        starts = [c0 for _, c0 in tensors]
        assert starts[0] == 0 and starts == sorted(set(starts))
        for c in range(chunks):
            k = max(j for j, c0 in enumerate(starts) if c0 <= c)
            i, c0 = tensors[k]
            start = (c - c0) * fused.CHUNK
            end = min(numels[i], start + fused.CHUNK)
            assert start < end
            covered.setdefault(i, []).append((start, end))
    assert sorted(covered) == [i for i, n in enumerate(numels) if n]
    for i, spans in covered.items():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == numels[i]
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert len(launches) == -(-len(covered) // fused.MAX_TENSORS)
    if named:
        assert len(launches) == {"default": 1, "hyperedge": 2}[named]


def _lists(mu_dtype=torch.float32):
    shapes = [(7, 5), (5,), (1,)]
    params = [torch.randn(s) for s in shapes]
    return (params, [torch.randn(s) for s in shapes],
            [torch.zeros(s, dtype=mu_dtype) for s in shapes],
            [torch.zeros(s) for s in shapes])


def _scalars():
    return torch.ones(()), torch.ones(()), torch.full((), -1e-3)


def _wrong(case, lists, scalars):
    params, grads, mu, nu = lists
    if case == "gradient_f64":
        grads[1] = grads[1].double()
    elif case == "mu_f16":
        mu[:] = [m.half() for m in mu]
    elif case == "mu_mixed":
        mu[2] = mu[2].bfloat16()
    elif case == "nu_strided":
        nu[0] = torch.zeros(5, 7).T
    elif case == "gradient_shape":
        grads[0] = grads[0].reshape(-1)
    elif case == "lengths":
        nu.pop()
    elif case == "lr_f64":
        scalars = (*scalars[:2], scalars[2].double())
    elif case == "bc_shape":
        scalars = (torch.ones(2), *scalars[1:])
    return (params, grads, mu, nu), scalars


@pytest.mark.parametrize("case", [
    "gradient_f64", "mu_f16", "mu_mixed", "nu_strided", "gradient_shape",
    "lengths", "lr_f64", "bc_shape"])
def test_gate_refuses_what_the_kernel_does_not_take(case):
    """The gate on the lists' metadata (here on the CPU, the device they
    lie on): lists it takes give None, and each kind it does not take an
    error that the wrapper raises before any launch."""
    cpu = torch.device("cpu")
    assert fused.refusal(cpu, *_lists(torch.bfloat16), _scalars()) is None
    lists, scalars = _wrong(case, _lists(), _scalars())
    err = fused.refusal(cpu, *lists, scalars)
    assert isinstance(err, (TypeError, ValueError))
    with pytest.raises(type(err), match="fused AdamW"):
        fused.adamw(*lists, *scalars, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=1e-4)
    # lists the gate takes but on no card: refused, nothing launched
    with pytest.raises(ValueError, match="CUDA card"):
        fused.adamw(*_lists(), *_scalars(), b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=1e-4)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("acc", [1, 2])
def test_cpu_adamw_takes_the_foreach_path(mu_dtype, acc):
    """AdamW over CPU tensors (under MultiSteps too) runs the ``_foreach``
    sequence, ``update_plain``: the same bits over 6 steps with the
    learning rate changed half way, and the fused pass's counter does not
    move."""
    torch.manual_seed(0)
    params, _, _, _ = _lists()
    pairs = []
    for plain in (False, True):
        ps = [p.clone().requires_grad_() for p in params]
        inner = AdamW(ps, 1e-2, weight_decay=0.01, mu_dtype=mu_dtype)
        if plain:
            inner.update = inner.update_plain
        pairs.append((ps, MultiSteps(inner, acc) if acc > 1 else inner))
    before = fused_stats()
    for i in range(6):
        grads = [torch.randn(p.shape) for p in params]
        for ps, opt in pairs:
            opt.lr = 1e-2 if i < 3 else 3e-3
            for p, g in zip(ps, grads):
                p.grad = g.clone()
            opt.step()
    assert fused_stats() == before
    (a, oa), (b, ob) = pairs
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    sa, sb = oa.state_dict(), ob.state_dict()
    if acc > 1:
        sa, sb = sa["inner"], sb["inner"]
    assert sa["step"] == sb["step"] == 6 // acc
    assert all(torch.equal(x, y) for name in ("mu", "nu")
               for x, y in zip(sa[name], sb[name]))


def test_fused_counts_live_in_the_counter_replays_keep(monkeypatch):
    """The fused pass's launches are ``build.run``'s count of its C entry
    ``cgat_adamw`` and its elements the ``utils.counters`` counter
    "adamw_fused": counters that ``StepGraphs`` adds on each replay, which
    ``fused_stats`` reads as they move."""
    from cgat_tpu_torch.ops.kernels import build
    from cgat_tpu_torch.utils import counters

    def cgat_adamw(*args):          # the C entry's name, as ctypes gives it
        return 0

    monkeypatch.setattr(build, "stream", lambda device: 0)
    start = fused_stats()
    assert build.run(cgat_adamw, torch.device("meta")) == 0
    assert fused_stats() == {"launches": start["launches"] + 1,
                             "elements": start["elements"]}
    counters.add({"cgat_adamw": (2,), "adamw_fused": (125,)})
    assert fused_stats() == {"launches": start["launches"] + 3,
                             "elements": start["elements"] + 125}
    counts = counters.snapshot()
    assert (counts["cgat_adamw"][0], counts["adamw_fused"][0]) == tuple(
        fused_stats().values())
    counters.add({"cgat_adamw": (-3,), "adamw_fused": (-125,)})
    assert fused_stats() == start
