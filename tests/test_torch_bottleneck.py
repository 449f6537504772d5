"""Port Bottleneck / FusedBottleneck vs the JAX package's blocks.

The same numpy input and the same weights (JAX init with perturbed running
stats, carried over by ``models.convert.flax_block_to_torch``) go through
the JAX block and the port's, in fp32, in train and eval mode: outputs,
running-stat updates and gradients (input and parameters). The JAX
FusedBottleneck runs both on its jnp reference path and on its Pallas
kernels in interpret mode, as the JAX package's own test does.

Tolerance: rtol 1e-4, atol 1e-5 of the largest reference entry (fp32
convolutions and sums in another order; the fused block's variance is
E[y^2] - E[y]^2, which cancels).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from creamfl_tpu.models.convert import torchvision_resnet_to_flax
from creamfl_tpu.models.resnet import Bottleneck as JBottleneck
from creamfl_tpu.models.resnet import FusedBottleneck as JFused
from creamfl_tpu.models.resnet import ResNetBackbone as JBackbone
from creamfl_tpu.ops import dispatch
from creamfl_tpu_torch.models.convert import flax_block_to_torch
from creamfl_tpu_torch.models.resnet import (Bottleneck, FusedBottleneck,
                                             ResNetBackbone)
from torch_cpu_share import torch_cpu_share  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
CIN, FILTERS, STRIDE = 16, 8, 2


@contextlib.contextmanager
def _jax_backend(name):
    try:
        if name == "pallas":
            with pltpu.force_tpu_interpret_mode():
                dispatch.set_backend("pallas")
                yield
        else:
            dispatch.set_backend(None)
            yield
    finally:
        dispatch.set_backend(None)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 16, 16, CIN)).astype(np.float32)
    variables = JBottleneck(filters=FILTERS, stride=STRIDE).init(
        jax.random.PRNGKey(3), jnp.asarray(x), False)
    stats = jax.tree.map(
        lambda a: (np.asarray(a) * rng.uniform(0.8, 1.25, a.shape)
                   + rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return x, _np(variables["params"]), stats


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=name)


# (JAX block, JAX backend for mm_bn_stats, port block)
PAIRS = {
    "standard": (JBottleneck, None, Bottleneck),
    "fused-reference": (JFused, None, FusedBottleneck),
    "fused-pallas": (JFused, "pallas", FusedBottleneck),
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_block_forward_stats_and_grads(setup, pair, train):
    x, params, stats = setup
    jcls, backend, tcls = PAIRS[pair]
    jblock = jcls(filters=FILTERS, stride=STRIDE)

    def j_loss(p, xx):
        out, upd = jblock.apply({"params": p, "batch_stats": stats}, xx,
                                train, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(out)), (out, upd["batch_stats"])

    with _jax_backend(backend):
        (_, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(
            j_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))

    tblock = tcls(CIN, FILTERS, STRIDE)
    tblock.load_state_dict(flax_block_to_torch(params, stats))
    tblock.train(train)
    tx = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_(True)
    tout = tblock(tx)
    torch.sin(tout).sum().backward()

    _close(tout.permute(0, 2, 3, 1), jout, "output")
    _close(tx.grad.permute(0, 2, 3, 1), jgx, "dx")
    want_stats = flax_block_to_torch(params, _np(jstats))
    got = tblock.state_dict()
    for key, val in want_stats.items():
        if "running_" in key:
            _close(got[key], val.numpy(), key)
    want_grads = flax_block_to_torch(_np(jgp), stats)
    for key, p in tblock.named_parameters():
        _close(p.grad, want_grads[key].numpy(), "grad " + key)


def test_fused_and_standard_blocks_share_state_dict_keys():
    for cin, stride in ((16, 2), (32, 1), (64, 1)):
        std = Bottleneck(cin, 8, stride).state_dict()
        fused = FusedBottleneck(cin, 8, stride).state_dict()
        assert list(std) == list(fused)
        assert all(std[k].shape == fused[k].shape for k in std)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cnn_type", ["resnet50", "resnet101"])
def test_bottleneck_trunk_shapes(cnn_type, fused):
    """ResNet-50/101 trunks at 32²: the JAX trunk's parameter tree and
    output shape."""
    x = np.zeros((2, 32, 32, 3), np.float32)
    want = jax.eval_shape(lambda: JBackbone(cnn_type, fused_bn=fused).init(
        jax.random.PRNGKey(0), jnp.asarray(x), False))
    trunk = ResNetBackbone(cnn_type, fused_bn=fused)
    sd = {k: v.numpy() for k, v in trunk.state_dict().items()}
    p, s = torchvision_resnet_to_flax(sd)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(p) == shapes(want["params"])
    assert shapes(s) == shapes(want["batch_stats"])
    with torch.no_grad():
        out = trunk(torch.tensor(x))
    assert tuple(out.shape) == (2, 1, 1, 2048)
    block_cls = type(trunk.layer3[0])
    assert block_cls is (FusedBottleneck if fused else Bottleneck)
