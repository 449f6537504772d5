"""Port client losses vs the JAX package: values and gradients, fp32.

Tolerances: values rtol 1e-5; gradients rtol 2e-4 atol 1e-6 (summation
order differs between XLA:CPU and torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.losses import classification as jcls
from creamfl_tpu.losses import contrast as jcon
from creamfl_tpu.ops.l2norm import l2_normalize as j_l2
from creamfl_tpu_torch.losses import classification as tcls
from creamfl_tpu_torch.losses import contrast as tcon
from creamfl_tpu_torch.ops.l2norm import l2_normalize as t_l2
from torch_cpu_share import torch_cpu_share  # noqa: F401

VAL = dict(rtol=1e-5, atol=1e-7)
GRAD = dict(rtol=2e-4, atol=1e-6)


def _torch_value_grad(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward()
    # A constant input gets no grad (None): count it as zeros.
    return float(out.detach()), [
        np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
        for t in ts]


def _jax_value_grad(fn, *arrays):
    val, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    return float(val), [np.asarray(g) for g in grads]


def _assert_same(t, j):
    np.testing.assert_allclose(t[0], j[0], **VAL)
    for gt, gj in zip(t[1], j[1]):
        np.testing.assert_allclose(gt, gj, **GRAD)


@pytest.mark.parametrize("with_valid", [False, True])
def test_margin_cross_entropy(rng, with_valid):
    logits = rng.normal(size=(6, 10)).astype(np.float32) * 3
    labels = rng.integers(0, 10, size=6)
    valid = np.array([1, 1, 1, 1, 0, 0], bool) if with_valid else None
    t = _torch_value_grad(
        lambda x: tcls.margin_softmax_loss(
            x, torch.tensor(labels), 4.0,
            None if valid is None else torch.tensor(valid)), logits)
    j = _jax_value_grad(
        lambda x: jcls.margin_softmax_loss(
            x, jnp.asarray(labels), 4.0,
            None if valid is None else jnp.asarray(valid)), logits)
    _assert_same(t, j)


def test_weight_orthogonality(rng):
    w = np.maximum(rng.normal(size=(10, 16)), 0).astype(np.float32)
    _assert_same(_torch_value_grad(tcls.weight_orthogonality_loss, w),
                 _jax_value_grad(jcls.weight_orthogonality_loss, w))


@pytest.mark.parametrize("blockwise", [False, True])
def test_inter_modal(rng, blockwise):
    f = rng.normal(size=(4, 16)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    g = rng.normal(size=(40, 16)).astype(np.float32)
    idx = np.array([3, 17, 0, 39])
    t = _torch_value_grad(lambda x: tcon.inter_modal_loss(
        x, torch.tensor(g), torch.tensor(idx), 0.5, blockwise), f)
    j = _jax_value_grad(lambda x: jcon.inter_modal_loss(
        x, jnp.asarray(g), jnp.asarray(idx), 0.5, blockwise), f)
    _assert_same(t, j)


def test_intra_modal_moon(rng):
    f, tgt, old = (rng.normal(size=(5, 16)).astype(np.float32)
                   for _ in range(3))
    # Gradients only to the live features: targets and old are constants.
    t = _torch_value_grad(tcon.intra_modal_moon_loss, f, tgt, old)
    j = _jax_value_grad(jcon.intra_modal_moon_loss, f, tgt, old)
    _assert_same(t, j)
    assert not t[1][1].any() and not t[1][2].any()


@pytest.mark.parametrize("loss_scale", [False, True])
def test_combine_inter_intra(loss_scale):
    a, b = np.float32(0.7), np.float32(2.3)
    t = _torch_value_grad(lambda x, y: tcon.combine_inter_intra(
        x, y, 0.5, loss_scale), a, b)
    j = _jax_value_grad(lambda x, y: jcon.combine_inter_intra(
        x, y, 0.5, loss_scale), a, b)
    _assert_same(t, j)


def test_l2_normalize_grad_at_tiny_norm(rng):
    x = rng.normal(size=(3, 8)).astype(np.float32)
    x[1] = 0.0  # the clamp inside the sqrt keeps this gradient finite
    x[2] *= 1e-14
    t = _torch_value_grad(lambda a: (t_l2(a) * torch.arange(8.0)).sum(), x)
    j = _jax_value_grad(lambda a: (j_l2(a) * jnp.arange(8.0)).sum(), x)
    _assert_same(t, j)
    assert np.isfinite(t[1][0]).all()
