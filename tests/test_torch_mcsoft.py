"""Port MCSoft contrastive loss (the PCME criterion) vs the JAX package.

The loss, its dict and its gradients (features and the learnable scalars),
with K = 1 and K > 1 samples, with and without a ``valid`` mask, for both
reductions; ``pairwise_l2`` and ``match_prob``. Same numpy inputs, fp32.

Tolerance: rtol 1e-5 on loss values (a sum of N^2 smooth terms),
rtol 1e-4 atol 1e-6 on gradients (another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.losses import mcsoft as jm
from creamfl_tpu_torch.losses import mcsoft as tm
from torch_cpu_share import torch_cpu_share  # noqa: F401

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _params(shift=15.0, scale=15.0):
    return {"shift": np.array([shift], np.float32),
            "negative_scale": np.array([scale], np.float32)}


@pytest.mark.parametrize("reduction", ["sum", "mean"])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_loss_and_grads(k, with_valid, reduction):
    rng = np.random.default_rng(k + 10 * with_valid)
    n, d = 6, 8
    shape = (n, d) if k == 1 else (n, k, d)
    img, txt = _unit(rng, *shape), _unit(rng, *shape)
    valid = np.array([1, 1, 1, 1, 0, 0], bool) if with_valid else None
    params = _params(14.0, 13.0)
    cfg = jm.MCSoftContrastiveConfig(reduction=reduction)
    tcfg = tm.MCSoftContrastiveConfig(reduction=reduction)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)

    def j_loss(p, a, b):
        return jm.mcsoft_contrastive_loss(
            p, a, b, cfg, valid=None if valid is None else jnp.asarray(valid))

    (jl, jd), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                      has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(img),
        jnp.asarray(txt))
    tp = {k_: torch.tensor(v, requires_grad=True)
          for k_, v in params.items()}
    ti = torch.tensor(img, requires_grad=True)
    tt = torch.tensor(txt, requires_grad=True)
    tl, td = tm.mcsoft_contrastive_loss(
        tp, ti, tt, tcfg, valid=None if valid is None else torch.tensor(valid))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), **VAL)
    for key in jd:
        np.testing.assert_allclose(td[key].item(), float(jd[key]),
                                   err_msg=key, **VAL)
    for got, want, name in ((ti.grad, jg[1], "d img"), (tt.grad, jg[2],
                                                        "d txt")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD)
    for key in params:
        np.testing.assert_allclose(tp[key].grad.numpy(),
                                   np.asarray(jg[0][key]), err_msg=key,
                                   **GRAD)


def test_criterion_module_and_match_prob():
    rng = np.random.default_rng(3)
    q, g = _unit(rng, 5, 8), _unit(rng, 7, 8)
    params = _params(12.0, 9.0)
    np.testing.assert_allclose(
        tm.pairwise_l2(torch.tensor(q), torch.tensor(g)).numpy(),
        np.asarray(jm.pairwise_l2(jnp.asarray(q), jnp.asarray(g))), **VAL)
    np.testing.assert_allclose(
        tm.match_prob({k: torch.tensor(v) for k, v in params.items()},
                      torch.tensor(q), torch.tensor(g)).numpy(),
        np.asarray(jm.match_prob(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(q), jnp.asarray(g))), **VAL)
    crit = tm.MCSoftCriterion()
    init = jm.init_mcsoft_params(jm.MCSoftContrastiveConfig())
    for name, p in crit.named_parameters():
        assert p.shape == (1,)
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(init[name]))
    loss, _ = crit(torch.tensor(q), torch.tensor(_unit(rng, 5, 8)))
    loss.backward()
    assert crit.shift.grad is not None and crit.negative_scale.grad is not None


def test_optional_terms():
    """Uniformity and VIB terms, off in every CreamFL config."""
    rng = np.random.default_rng(5)
    img, txt = _unit(rng, 4, 6), _unit(rng, 4, 6)
    ls_i = rng.normal(size=(4, 6)).astype(np.float32) * 0.1
    ls_t = rng.normal(size=(4, 6)).astype(np.float32) * 0.1
    cfg = jm.MCSoftContrastiveConfig(uniform_lambda=0.3, vib_beta=0.01)
    tcfg = tm.MCSoftContrastiveConfig(uniform_lambda=0.3, vib_beta=0.01)
    jl, _ = jm.mcsoft_contrastive_loss(
        jax.tree.map(jnp.asarray, _params()), jnp.asarray(img),
        jnp.asarray(txt), cfg, jnp.asarray(ls_i), jnp.asarray(ls_t))
    tl, _ = tm.mcsoft_contrastive_loss(
        {k: torch.tensor(v) for k, v in _params().items()},
        torch.tensor(img), torch.tensor(txt), tcfg, torch.tensor(ls_i),
        torch.tensor(ls_t))
    np.testing.assert_allclose(tl.item(), float(jl), **VAL)
