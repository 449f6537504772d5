"""Port con_w aggregation vs the JAX package, fp32: the port sums over the
K real clients, the JAX package over its bucket of K padded to a power of
two. Tolerance: rtol 1e-5 atol 1e-6 on the aggregate (a convex
combination of unit rows; summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.federation import aggregation as jagg
from creamfl_tpu_torch.federation import aggregation as tagg
from torch_cpu_share import torch_cpu_share  # noqa: F401

N, D = 70, 16


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture
def inputs(rng):
    return _unit(rng, 3, N, D), _unit(rng, N, D), _unit(rng, N, D)


def test_aggregate_modalities_matches_jax(inputs):
    reps, g_img, g_txt = inputs
    t_img, t_txt = tagg.aggregate_modalities(
        torch.tensor(reps), torch.tensor(reps[:2]), torch.tensor(g_img),
        torch.tensor(g_txt))
    j_img, j_txt = jagg.aggregate_modalities(
        jnp.asarray(reps), jnp.asarray(reps[:2]), jnp.asarray(g_img),
        jnp.asarray(g_txt))
    np.testing.assert_allclose(t_img.numpy(), np.asarray(j_img),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_txt.numpy(), np.asarray(j_txt),
                               rtol=1e-5, atol=1e-6)
    none_img, none_txt = tagg.aggregate_modalities(
        None, None, torch.tensor(g_img), torch.tensor(g_txt))
    assert none_img is None and none_txt is None


@pytest.mark.parametrize("k", [3, 5])
def test_padded_clients_get_no_weight(rng, k):
    """The port's con_w over the K real clients (a tensor and a list of
    slots) equals the JAX package's over its bucket of 4 / 8 slots, whose
    pad slots the mask gives no weight."""
    reps, g_txt = _unit(rng, k, N, D), _unit(rng, N, D)
    jpad, jmask = jagg._bucketed(jnp.asarray(reps))
    assert jpad.shape[0] == 1 << (k - 1).bit_length() > k
    want = np.asarray(jagg.con_w_aggregate(jpad, jnp.asarray(g_txt),
                                           k_mask=jmask))
    for slots in (torch.tensor(reps), list(torch.tensor(reps))):
        got = tagg.con_w_aggregate(slots, torch.tensor(g_txt))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
