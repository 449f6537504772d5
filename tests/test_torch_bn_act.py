"""The trunk's train-mode BatchNorm with its epilogue
(``models/resnet.py:bn_act``) on the CPU, where it runs the unfused chain,
and K8's backward formula in torch (``ops/batchnorm.py:
bn_act_backward_reference``, what the card's kernel is held to).

Held against the chain written out here: ``F.batch_norm(training=True)``,
then ``+ residual``, then ``F.relu``, differentiated by autograd, with the
running stats from ``torch.var_mean`` of an fp32 copy (the two-pass
semantics that the single-pass statistics replaced). The entry point's
outputs and gradients are bit-equal to the chain's; K8's formula agrees
within a rounding of the activation's dtype (its sums run in another
order) and with float64. The kernel's own refusals and launch plan are
checked here before any launch.
"""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from creamfl_tpu_torch.models.resnet import BatchNorm, ResNetBackbone, bn_act
from creamfl_tpu_torch.ops import batchnorm as B
from creamfl_tpu_torch.utils import profiling
from torch_cpu_share import torch_cpu_share  # noqa: F401

C = 16
# At this eps a zero variance's invstd**-2 - eps rounds below 0 in fp32.
EPS = 3e-5
# Gradients: fp32 sums in another order; in bf16 dx is also rounded to
# bf16 (8 bits), and the x gradient of the chain is rounded once more.
GRAD_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
            torch.bfloat16: dict(rtol=2.0 ** -7, atol=2.0 ** -7)}


def _inputs(dtype, epilogue, gen):
    x = torch.randn(3, C, 5, 4, generator=gen) * 2 + 0.5
    x[:, 0] = 1.25  # a constant channel: variance 0
    res = torch.randn(x.shape, generator=gen) if epilogue == "add_relu" \
        else None
    dz = torch.randn(x.shape, generator=gen)

    def cl(t):
        return None if t is None else t.to(
            dtype, memory_format=torch.channels_last)

    return cl(x), cl(res), cl(dz)


def _module(gen):
    bn = BatchNorm(C, eps=EPS)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(C, generator=gen) + 0.5)
        bn.bias.copy_(torch.randn(C, generator=gen))
        bn.running_mean.copy_(torch.randn(C, generator=gen))
        # The constant channel's running variance starts at 0, so a
        # negative batch variance would show as a negative running one.
        bn.running_var.copy_(torch.rand(C, generator=gen))
        bn.running_var[0] = 0.0
    return bn


def _chain(bn, x, res, epilogue):
    """The unfused chain, with the running stats moved as the two-pass
    reference moves them."""
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
        bn.running_mean.mul_(bn.momentum).add_(mean, alpha=1 - bn.momentum)
        bn.running_var.mul_(bn.momentum).add_(var, alpha=1 - bn.momentum)
        bn.num_batches_tracked.add_(1)
    y = F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    if epilogue == "add_relu":
        y = y + res
    return y if epilogue == "none" else F.relu(y)


def _leaf(t):
    return None if t is None else t.clone().requires_grad_()


@pytest.mark.parametrize("frozen", [False, True], ids=["moves", "frozen"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("epilogue", B.EPILOGUES)
def test_plain_matches_unfused_chain(epilogue, dtype, frozen):
    gen = torch.Generator().manual_seed(11)
    bn = _module(gen)
    ref = BatchNorm(C, eps=EPS)
    ref.load_state_dict(bn.state_dict())
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    x, res, dz = _inputs(dtype, epilogue, gen)

    xa, ra = _leaf(x), _leaf(res)
    bn.frozen = frozen
    with profiling.recording() as snap:
        z = bn_act(bn, xa, epilogue, ra)
    z.backward(dz)
    xb, rb = _leaf(x), _leaf(res)
    want = _chain(ref, xb, rb, epilogue)
    want.backward(dz)

    assert z.dtype == dtype
    assert z.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(z, want)
    names = ("x", "weight", "bias", "residual")
    chain = (xb.grad, ref.weight.grad, ref.bias.grad,
             None if rb is None else rb.grad)
    for name, got, exp in zip(names, (xa.grad, bn.weight.grad, bn.bias.grad,
                                      None if ra is None else ra.grad),
                              chain):
        assert (got is None) == (exp is None), name
        assert got is None or torch.equal(got, exp), name
    # K8's formula, at the same statistics and output.
    _, stats = B.bn_act_reference(x, bn.weight, bn.bias, EPS, epilogue, res)
    dx, g, dw, db = B.bn_act_backward_reference(dz, x, z, bn.weight, bn.bias,
                                                stats, epilogue)
    for name, got, exp in zip(names, (dx, dw, db, g), chain):
        assert (got is None) == (exp is None), name
        if got is None:
            continue
        assert got.dtype == exp.dtype, name
        scale = max(1.0, float(exp.abs().max()))
        tol = GRAD_TOL[dtype] if name == "x" else GRAD_TOL[torch.float32]
        torch.testing.assert_close(got, exp, rtol=tol["rtol"],
                                   atol=tol["atol"] * scale, msg=name)
    if res is not None:
        # The residual's gradient is the epilogue's g, exactly.
        assert torch.equal(g, rb.grad)

    assert snap.counters[f"bn.fused.{epilogue}"] == 1
    assert sum(v for k, v in snap.counters.items()
               if k.startswith("bn.fused.")) == 1
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


@pytest.mark.parametrize("epilogue", B.EPILOGUES)
def test_plain_backward_against_float64(epilogue):
    """K8's backward formula (fp32) against autograd through the chain in
    float64: the residual's gradient equal, dx, dw and db within fp32
    rounding of sums over the batch."""
    gen = torch.Generator().manual_seed(5)
    x, res, dz = _inputs(torch.float32, epilogue, gen)
    w, b = torch.rand(C, generator=gen) + 0.5, torch.randn(C, generator=gen)
    z, stats = B.bn_act_reference(x, w, b, EPS, epilogue, res)
    dx, g, dw, db = B.bn_act_backward_reference(dz, x, z, w, b, stats,
                                                epilogue)
    leaves = [t.double().requires_grad_() for t in (x, w, b)]
    r64 = res.double().requires_grad_() if res is not None else None
    y = F.batch_norm(leaves[0], None, None, leaves[1], leaves[2], True, 0.0,
                     EPS)
    if r64 is not None:
        y = y + r64
    if epilogue != "none":
        y = F.relu(y)
    y.backward(dz.double())
    for name, got, exp in (("x", dx, leaves[0].grad), ("w", dw, leaves[1].grad),
                           ("b", db, leaves[2].grad)):
        scale = max(1.0, float(exp.abs().max()))
        torch.testing.assert_close(got.double(), exp, rtol=1e-5,
                                   atol=1e-5 * scale, msg=name)
    if r64 is not None:
        torch.testing.assert_close(g.double(), r64.grad, rtol=0, atol=0)
    else:
        assert g is None


# cnn -> BatchNorms by epilogue: the stem and each block's inner ones
# "relu", each block's last "add_relu", each projection "none".
TRUNK_KINDS = {"resnet10": {"relu": 5, "add_relu": 4, "none": 3},
               "resnet50": {"relu": 33, "add_relu": 16, "none": 4}}


@pytest.mark.parametrize("cnn", sorted(TRUNK_KINDS))
def test_trunk_step_counts_each_kind(cnn):
    """One train step of a trunk: every BatchNorm through the fused entry
    once, by kind, each moving its running stats once; eval mode takes
    the unfused route and counts nothing."""
    torch.manual_seed(0)
    net = ResNetBackbone(cnn).train()
    n_bn = sum(isinstance(m, BatchNorm) for m in net.modules())
    images = torch.randn(2, 32, 32, 3)
    with profiling.recording() as snap:
        net(images).float().square().mean().backward()
    fused = {k.removeprefix("bn.fused."): v for k, v in snap.counters.items()
             if k.startswith("bn.fused.")}
    assert fused == TRUNK_KINDS[cnn]
    assert sum(fused.values()) == n_bn == snap.counters["bn.single_pass"]
    assert all(int(m.num_batches_tracked) == 1 for m in net.modules()
               if isinstance(m, BatchNorm))
    assert all(p.grad is not None for p in net.parameters())
    net.eval()
    with profiling.recording() as snap, torch.no_grad():
        net(images)
    assert not [k for k in snap.counters if k.startswith("bn.")]


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).to(
        memory_format=torch.channels_last)


# What the kernel refuses, checked before any launch.
REFUSED = {
    "fp32 activation": (dict(x=_cl((2, 16, 3, 3), torch.float32)), TypeError),
    "NCHW contiguous": (dict(x=torch.zeros(2, 16, 3, 3,
                                           dtype=torch.bfloat16)),
                        ValueError),
    "2-D": (dict(x=torch.zeros(4, 16, dtype=torch.bfloat16)), ValueError),
    "C not a multiple of 8": (dict(x=_cl((2, 12, 3, 3)), w=torch.ones(12),
                                   b=torch.zeros(12)), ValueError),
    "bf16 weight": (dict(w=torch.ones(16, dtype=torch.bfloat16)),
                    ValueError),
    "residual NCHW": (dict(r=torch.zeros(2, 16, 3, 3, dtype=torch.bfloat16)),
                      ValueError),
    "residual fp32": (dict(r=_cl((2, 16, 3, 3), torch.float32)), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_kernel_refuses(case):
    args, error = REFUSED[case]
    x = args.get("x", _cl((2, 16, 3, 3)))
    with pytest.raises(error):
        B.check_inputs(x, args.get("w", torch.ones(x.shape[1])),
                       args.get("b", torch.zeros(x.shape[1])), args.get("r"))


def test_kernel_takes_the_trunk_layout():
    """The trunk's layout passes the checks; a residual goes with
    "add_relu" alone; the Function takes CUDA tensors only."""
    x = _cl((2, 16, 3, 3))
    w, b = torch.ones(16), torch.zeros(16)
    B.check_inputs(x, w, b, _cl((2, 16, 3, 3)))
    with pytest.raises(ValueError, match="residual"):
        B.BnAct.apply(x, w, b, x, EPS, "relu")
    with pytest.raises(ValueError, match="residual"):
        B.BnAct.apply(x, w, b, None, EPS, "add_relu")
    with pytest.raises(ValueError, match="CUDA"):
        B.BnAct.apply(x, w, b, None, EPS, "relu")


# (rows, channels) of ResNet-101's BatchNorms at batch 128 and 224²: the
# stem, layer 1's bn1 and bn3, layer 3's bn1 and bn3, layer 4's bn3.
TRUNK_SHAPES = [(1_605_632, 64), (401_408, 64), (401_408, 256),
                (25_088, 256), (25_088, 1024), (6_272, 2048), (7, 24)]


@pytest.mark.parametrize("m,c", TRUNK_SHAPES)
def test_plan_covers_the_rows(m, c):
    sms = 132
    chunks, rows, slabs = B.plan(m, c, sms)
    assert slabs == -(-c // B.SLAB)
    assert (chunks - 1) * rows < m <= chunks * rows
    assert chunks * slabs <= max(B.BLOCKS_PER_SM * sms, slabs)
    assert B.workspace_floats(chunks, slabs) <= B.workspace_floats(
        B.BLOCKS_PER_SM * sms + slabs, 1)
