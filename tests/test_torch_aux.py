"""The port's small modules vs the JAX package's.

* ``models/uncertainty.py``: ``UncertaintyModule`` with the JAX module's
  weights (``convert.flax_uncertainty_to_torch``), with and without a pad
  mask, within 1e-5; ``sample_gaussian_embeddings``' shape, its moments
  (mean within 0.05 and std within 5 % of mu and exp(logsigma) over 4 000
  samples) and its seeding.
* ``losses/factory.py``: ``create`` gives the port's CE, triplet and
  center losses, equal to the JAX package's within 1e-6 on the same
  inputs; the reference's dead names raise ``NotImplementedError`` and
  unknown names ``ValueError``, as in JAX.
* ``config.dump_config``: the bundled configs written as JSON and YAML,
  byte-equal to the JAX package's files, and read back equal.
* ``utils/helper.to_one_hot`` equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

from creamfl_tpu_torch import config
from creamfl_tpu_torch.losses import factory
from creamfl_tpu_torch.losses.classification import cross_entropy
from creamfl_tpu_torch.models.convert import flax_uncertainty_to_torch
from creamfl_tpu_torch.models.uncertainty import (UncertaintyModule,
                                                  init_uncertainty,
                                                  sample_gaussian_embeddings)
from creamfl_tpu_torch.utils.helper import to_one_hot
from torch_cpu_share import torch_cpu_share  # noqa: F401

B, L, D_IN, D_OUT, D_H = 4, 7, 24, 16, 12


@pytest.mark.parametrize("masked", [False, True])
def test_uncertainty_equal_jax(masked):
    import jax
    import jax.numpy as jnp

    from creamfl_tpu.models import uncertainty as J

    rng = np.random.default_rng(0)
    pooled = rng.standard_normal((B, D_IN)).astype(np.float32)
    tokens = rng.standard_normal((B, L, D_IN)).astype(np.float32)
    lengths = np.array([7, 3, 5, 1])
    pad = (np.arange(L)[None, :] >= lengths[:, None]) if masked else None
    jm = J.UncertaintyModule(d_out=D_OUT, d_hidden=D_H)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(pooled),
                        jnp.asarray(tokens))
    # Non-zero biases, so that the bias conversion is checked too.
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    for name in ("fc", "embed"):
        params[name]["bias"] = rng.standard_normal(D_OUT).astype(np.float32)
    want = np.asarray(jm.apply(
        {"params": params}, jnp.asarray(pooled), jnp.asarray(tokens),
        None if pad is None else jnp.asarray(pad)))

    tm = UncertaintyModule(D_IN, D_OUT, D_H)
    tm.load_state_dict(flax_uncertainty_to_torch(params), strict=True)
    got = tm(torch.tensor(pooled), torch.tensor(tokens),
             None if pad is None else torch.tensor(pad))
    assert got.shape == (B, D_OUT)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_uncertainty_init():
    m = UncertaintyModule(D_IN, D_OUT, D_H)
    init_uncertainty(m, torch.Generator().manual_seed(0))
    assert not m.fc.bias.any() and not m.embed.bias.any()
    bound = (6 / (D_IN + D_OUT)) ** 0.5
    assert m.embed.weight.abs().max() <= bound
    out = m(torch.zeros(2, D_IN), torch.ones(2, 3, D_IN))
    assert out.shape == (2, D_OUT)


def test_sample_gaussian_embeddings():
    mu = torch.tensor([[0.0, 1.0, -2.0], [3.0, 0.5, 0.0]])
    logsigma = torch.log(torch.tensor([[1.0, 0.5, 2.0], [0.1, 1.0, 3.0]]))
    k = 4000
    s = sample_gaussian_embeddings(mu, logsigma, k,
                                   torch.Generator().manual_seed(3))
    assert s.shape == (2, k, 3) and s.dtype == mu.dtype
    np.testing.assert_allclose(s.mean(1).numpy(), mu.numpy(), atol=0.05 *
                               logsigma.exp().numpy().max())
    np.testing.assert_allclose(s.std(1).numpy(), logsigma.exp().numpy(),
                               rtol=0.05)
    again = sample_gaussian_embeddings(mu, logsigma, k,
                                       torch.Generator().manual_seed(3))
    assert torch.equal(s, again)


def test_loss_factory_equal_jax():
    import jax.numpy as jnp

    from creamfl_tpu.losses import factory as J

    rng = np.random.default_rng(2)
    emb = rng.standard_normal((9, 6)).astype(np.float32)
    labels = np.array([0, 1, 0, 2, 1, 1, 0, 2, 3])
    centers = rng.standard_normal((4, 6)).astype(np.float32)
    logits = rng.standard_normal((9, 4)).astype(np.float32)
    assert factory.create("softmax") is cross_entropy
    assert factory.create("SOFTMAX") is cross_entropy
    cases = [("softmax", (logits, labels)), ("triplet", (emb, labels)),
             ("center", (emb, labels, centers))]
    for name, args in cases:
        want = float(J.create(name)(*map(jnp.asarray, args)))
        got = float(factory.create(name)(*map(torch.tensor, args)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    # A label with no negative (all one class): JAX's zero fill.
    one = np.zeros(5, np.int64)
    want = float(J.triplet_loss(jnp.asarray(emb[:5]), jnp.asarray(one), 0.3))
    got = float(factory.triplet_loss(torch.tensor(emb[:5]), torch.tensor(one),
                                     0.3))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["batchall", "center_triplet", "histogram"])
def test_loss_factory_dead_names_raise(name):
    from creamfl_tpu.losses import factory as J

    with pytest.raises(NotImplementedError):
        J.create(name)
    with pytest.raises(NotImplementedError, match="legacy dead code"):
        factory.create(name)


def test_loss_factory_unknown_raises():
    with pytest.raises(ValueError, match="unknown loss"):
        factory.create("arcface")


@pytest.mark.parametrize("ext", [".json", ".yaml"])
@pytest.mark.parametrize("name", ["coco", "f30k"])
def test_dump_config_equal_jax(tmp_path, name, ext):
    from creamfl_tpu import config as J

    cfg = config.parse_config(config.default_config_path(f"{name}.json"),
                              optimizer__learning_rate=3e-5)
    jcfg = J.parse_config(J.default_config_path(f"{name}.yaml"),
                          optimizer__learning_rate=3e-5)
    assert cfg.to_dict() == jcfg.to_dict()
    got, want = str(tmp_path / f"port{ext}"), str(tmp_path / f"jax{ext}")
    config.dump_config(cfg, got)
    J.dump_config(jcfg, want)
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()
    # Round trip: the port reads JSON back, PyYAML (the JAX package's
    # parse_config) the YAML file. (PyYAML would read JSON's 3e-05 as a
    # string: YAML 1.1 floats need a dot.)
    read = config.parse_config if ext == ".json" else J.parse_config
    assert read(got).to_dict() == cfg.to_dict()
    with pytest.raises(ValueError, match="unsupported config extension"):
        config.dump_config(cfg, str(tmp_path / "c.toml"))


def test_to_one_hot_equal_jax():
    from creamfl_tpu.utils.helper import to_one_hot as j_one_hot

    labels = np.array([[1, 0, 4], [2, 2, 7]])
    want = np.asarray(j_one_hot(labels, 5))
    got = to_one_hot(torch.tensor(labels), 5)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(to_one_hot([1, 0], 3).numpy(),
                                  [[0, 1, 0], [1, 0, 0]])
