"""Port con_w aggregation vs the JAX package, K = 3 clients (padded to a
bucket of 4), fp32. Tolerance: rtol 1e-5 atol 1e-6 on the aggregate
(a convex combination of unit rows; summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.federation import aggregation as jagg
from creamfl_tpu_torch.federation import aggregation as tagg

N, D = 70, 16


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture
def inputs(rng):
    return _unit(rng, 3, N, D), _unit(rng, N, D), _unit(rng, N, D)


def test_bucketed_pads_to_power_of_two(inputs):
    reps = torch.tensor(inputs[0])
    padded, mask = tagg._bucketed(reps)
    jpad, jmask = jagg._bucketed(jnp.asarray(inputs[0]))
    assert padded.shape == jpad.shape == (4, N, D)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpad))
    same, mask2 = tagg._bucketed(reps[:2])
    assert same.shape[0] == 2 and bool(mask2.all())


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


def test_padded_clients_get_no_weight(inputs):
    reps, _, g_txt = inputs
    padded, mask = tagg._bucketed(torch.tensor(reps))
    with_pad = tagg.con_w_aggregate(padded, torch.tensor(g_txt),
                                    k_mask=mask)
    without = tagg.con_w_aggregate(torch.tensor(reps), torch.tensor(g_txt))
    np.testing.assert_allclose(with_pad.numpy(), without.numpy(),
                               rtol=1e-6, atol=1e-7)
