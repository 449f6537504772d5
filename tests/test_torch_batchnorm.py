"""The port's train-mode BatchNorm takes its batch statistics once: the
running stats move from the normalisation's own fp32 mean and inverse std.

Held against the two-pass semantics it replaced, written out here: the
running stats from ``torch.var_mean`` of an fp32 copy of the input (biased
variance), the output from ``F.batch_norm(training=True)``.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from creamfl_tpu_torch.models.resnet import BatchNorm, ResNetBackbone
from creamfl_tpu_torch.utils import profiling
from torch_cpu_share import torch_cpu_share  # noqa: F401

C = 6
# At this eps a zero variance's invstd**-2 - eps rounds below 0 in fp32.
EPS = 3e-5


def _input(dtype, layout, gen):
    shape = (4, C) if layout == "2d" else (3, C, 5, 4)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    x[:, 0] = 1.25  # a constant channel: variance 0
    if layout == "channels_last":
        x = x.to(memory_format=torch.channels_last)
    return x.to(dtype)


def _two_pass(bn, x, w, b):
    """The replaced train step: stats from an fp32 copy, flax's update,
    then the normalisation."""
    with torch.no_grad():
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
        bn.running_mean.mul_(bn.momentum).add_(mean, alpha=1 - bn.momentum)
        bn.running_var.mul_(bn.momentum).add_(var, alpha=1 - bn.momentum)
        bn.num_batches_tracked.add_(1)
    return F.batch_norm(x, None, None, w, b, True, 0.0, bn.eps)


@pytest.mark.parametrize("frozen", [False, True], ids=["moves", "frozen"])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous", "2d"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_train_step_matches_two_pass(dtype, layout, frozen):
    gen = torch.Generator().manual_seed(7)
    bn = BatchNorm(C, eps=EPS)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=gen))
        bn.running_mean.copy_(torch.randn(C, generator=gen))
        # The constant channel's running variance starts at 0, so a
        # negative batch variance would show as a negative running one.
        bn.running_var.copy_(torch.rand(C, generator=gen))
        bn.running_var[0] = 0.0
    ref = BatchNorm(C, eps=EPS)
    ref.load_state_dict(bn.state_dict())
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    x = _input(dtype, layout, gen)
    dy = torch.randn(x.shape, generator=gen).to(dtype)

    xa = x.clone().requires_grad_()
    bn.frozen = frozen
    with profiling.recording() as snap:
        y = bn(xa)
    y.backward(dy)
    xb = x.clone().requires_grad_()
    want = _two_pass(ref, xb, ref.weight, ref.bias)
    want.backward(dy)

    assert y.dtype == dtype
    assert torch.equal(y, want)
    for got, exp in ((xa.grad, xb.grad), (bn.weight.grad, ref.weight.grad),
                     (bn.bias.grad, ref.bias.grad)):
        assert torch.equal(got, exp)
    if frozen:
        assert snap.counters.get("bn.single_pass", 0) == 0
        for k, v in bn.state_dict().items():
            if k not in ("weight", "bias"):
                assert torch.equal(v, before[k]), k
        return
    assert snap.counters["bn.single_pass"] == 1
    assert bn.num_batches_tracked.item() == before["num_batches_tracked"] + 1
    torch.testing.assert_close(bn.running_mean, ref.running_mean, rtol=0,
                               atol=1e-6)
    torch.testing.assert_close(bn.running_var, ref.running_var, rtol=1e-5,
                               atol=1e-6)
    assert (bn.running_var >= 0).all()


class _Ops(TorchDispatchMode):
    """Each op dispatched, with its first argument's dtype and shape and
    the dtype it casts to."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        a = args[0] if args else None
        self.seen.append((func.overloadpacket, getattr(a, "dtype", None),
                          tuple(getattr(a, "shape", ())),
                          kwargs.get("dtype")))
        return func(*args, **kwargs)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_trunk_takes_bn_statistics_once(train):
    """A bf16 train forward of a trunk: no Welford pass, no fp32 copy of a
    BatchNorm input, and one ``bn.single_pass`` a BatchNorm (none in eval
    mode)."""
    torch.manual_seed(0)
    net = ResNetBackbone("resnet10").train(train)
    n_bn = sum(isinstance(m, BatchNorm) for m in net.modules())
    images = torch.randn(2, 32, 32, 3)
    with profiling.recording() as snap, _Ops() as ops, \
            torch.autocast("cpu", dtype=torch.bfloat16):
        grid = net(images)
    assert grid.dtype == torch.bfloat16
    assert not [s for s in ops.seen if s[0] is torch.ops.aten.var_mean]
    upcasts = [s for s in ops.seen if s[0] is torch.ops.aten._to_copy
               and s[1] == torch.bfloat16 and s[3] == torch.float32]
    assert not upcasts, upcasts
    assert snap.counters.get("bn.single_pass", 0) == (n_bn if train else 0)
    assert n_bn == 12
