"""``remat`` and ``stem="s2d"`` of the port's ResNet trunk
(``models/resnet.py``) and PCME, vs the port's own plain trunk and the JAX
package's.

* s2d vs the JAX package's s2d trunk with its weights carried over
  (``convert.flax_resnet_to_torch``; the stem kernel stays
  ``conv1.weight``): train-mode features and running stats within
  ``test_torch_models.py``'s tolerance (rtol 1e-4, atol 1e-5 of the
  largest entry); s2d vs the port's conv7 in float64: features and the
  stem kernel's gradient within 1e-10; an odd size takes conv7, bit for
  bit.
* ``remat="block"`` and ``"dots"`` vs ``"none"`` on the same weights and
  batch, on the standard trunk (resnet10) and the fused one (a two-stage
  Bottleneck trunk, K5/K6's plain versions on the CPU): loss and every
  gradient within 1e-6 (relative to the largest entry), running stats and
  ``num_batches_tracked`` exactly equal, moved once per step; through
  ``PCME(remat=...)`` too (which, as the JAX package's, takes no
  ``stem``). In eval mode and without gradients remat changes nothing.
* "dots" keeps the JAX policy's products (``mm``, ``addmm``) and
  recomputes convolutions.
* ``remat="block"`` and ``"dots"`` vs the JAX package's ``remat`` of the
  same name: features, gradients and running stats within
  ``test_torch_models.py``'s tolerance.
* A remat trunk on a mesh of two ranks raises (the synced BatchNorm would
  run its collectives again in the recompute).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.models import resnet as jresnet
from creamfl_tpu_torch.models import resnet as tresnet
from creamfl_tpu_torch.models.convert import flax_resnet_to_torch
from creamfl_tpu_torch.models.pcme import PCME, init_pcme
from creamfl_tpu_torch.models.resnet import (BatchNorm, ResNetBackbone,
                                             init_parameters,
                                             set_batchnorm_mesh)
from torch_cpu_share import torch_cpu_share  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
B, IMG = 4, 64
TRUNK_B = "resnet_b2"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: at these sizes more threads only contend with the
    other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def small_bottleneck_trunk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jresnet.RESNET_CONFIGS, TRUNK_B,
                   (jresnet.Bottleneck, (1, 1), 512))
        mp.setitem(tresnet.RESNET_CONFIGS, TRUNK_B,
                   (tresnet.Bottleneck, (1, 1), 512))
        yield


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(5).normal(
        size=(B, IMG, IMG, 3)).astype(np.float32)


def _close(got, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=tol["rtol"],
        atol=tol["atol"] * max(1.0, float(np.abs(want).max())),
        err_msg=name)


def _jax_trunk(cnn, images, **kw):
    jm = jresnet.ResNetBackbone(cnn, **kw)
    v = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(2),
                                           jnp.asarray(images), False)
    params = jax.tree.map(np.asarray, v["params"])
    stats = jax.tree.map(np.asarray, v["batch_stats"])
    return jm, params, stats


def _jax_train(jm, params, stats, images, probe):
    """Features, d(sum(grid * probe))/d params and the new batch stats of
    one train-mode call."""
    def loss(p):
        grid, mut = jm.apply({"params": p, "batch_stats": stats},
                             jnp.asarray(images), True,
                             mutable=["batch_stats"])
        return jnp.sum(grid * probe), (grid, mut["batch_stats"])

    (_, (grid, new_stats)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    return (np.asarray(grid), jax.tree.map(np.asarray, grads),
            jax.tree.map(np.asarray, new_stats))


def _port_trunk(cnn, params, stats, **kw):
    tm = ResNetBackbone(cnn, **kw)
    tm.load_state_dict(flax_resnet_to_torch(params, stats), strict=True)
    return tm.train()


def _port_train(tm, images, probe):
    tm.zero_grad()
    grid = tm(torch.tensor(images))
    (grid * torch.tensor(probe)).sum().backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    return grid.detach(), grads


def _grads_as_torch(jgrads, stats):
    """Flax grads -> the port's parameter names (through the converter,
    whose running-stat keys are dropped)."""
    sd = flax_resnet_to_torch(jgrads, stats)
    return {k: v for k, v in sd.items() if "running" not in k
            and "num_batches" not in k}


# ---------------------------------------------------------------------------
# s2d
# ---------------------------------------------------------------------------

def test_s2d_equal_jax_s2d(images):
    probe = np.random.default_rng(1).normal(
        size=(B, IMG // 32, IMG // 32, 512)).astype(np.float32)
    jm, params, stats = _jax_trunk("resnet10", images, stem="s2d")
    assert params["conv1"]["kernel"].shape == (7, 7, 3, 64)
    grid, jgrads, new_stats = _jax_train(jm, params, stats, images, probe)
    tm = _port_trunk("resnet10", params, stats, stem="s2d")
    got, grads = _port_train(tm, images, probe)
    _close(got.numpy(), grid, name="features")
    for k, want in _grads_as_torch(jgrads, new_stats).items():
        _close(grads[k].numpy(), want.numpy(), name=k)
    for k, want in flax_resnet_to_torch(params, new_stats).items():
        if "running" in k:
            _close(tm.state_dict()[k].numpy(), want.numpy(), name=k)


def test_s2d_equal_conv7_float64(images):
    torch.manual_seed(0)
    conv7 = ResNetBackbone("resnet10").double()
    init_parameters(conv7, torch.Generator().manual_seed(4))
    s2d = ResNetBackbone("resnet10", stem="s2d").double()
    s2d.load_state_dict(conv7.state_dict())
    x = torch.tensor(images, dtype=torch.float64)
    outs = []
    for m in (conv7, s2d):
        m.train()
        y = m(x)
        y.square().sum().backward()
        outs.append((y.detach(), m.conv1.weight.grad.clone()))
    (y7, g7), (ys, gs) = outs
    torch.testing.assert_close(ys, y7, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(gs, g7, rtol=1e-10, atol=1e-10)
    # The stem alone, at another even size: the same conv.
    stem = tresnet._s2d_stem(x[:, :30, :46], conv7.conv1.weight.detach())
    want = conv7.conv1(x[:, :30, :46].permute(0, 3, 1, 2))
    assert stem.shape == want.shape == (B, 64, 15, 23)
    torch.testing.assert_close(stem, want.detach(), rtol=1e-10, atol=1e-10)


def test_s2d_odd_size_takes_conv7(images):
    conv7 = ResNetBackbone("resnet10").eval()
    s2d = ResNetBackbone("resnet10", stem="s2d").eval()
    s2d.load_state_dict(conv7.state_dict())
    x = torch.tensor(images[:, :63])
    with torch.no_grad():
        assert torch.equal(s2d(x), conv7(x))


# ---------------------------------------------------------------------------
# remat against no remat
# ---------------------------------------------------------------------------

def _step(model, x, probe):
    """One train step's loss, gradients and buffers."""
    model.zero_grad()
    loss = (model(x) * probe).sum()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    bufs = {k: b.clone() for k, b in model.named_buffers()}
    return loss.detach(), grads, bufs


@pytest.mark.parametrize("remat", ["block", "dots"])
@pytest.mark.parametrize("cnn,fused", [("resnet10", False),
                                       (TRUNK_B, False), (TRUNK_B, True)])
def test_remat_equal_no_remat(images, remat, cnn, fused):
    base = ResNetBackbone(cnn, fused_bn=fused)
    init_parameters(base, torch.Generator().manual_seed(7))
    other = ResNetBackbone(cnn, fused_bn=fused, remat=remat)
    other.load_state_dict(base.state_dict())
    x = torch.tensor(images)
    with torch.no_grad():
        shape = base.eval()(x).shape
    probe = torch.randn(shape, generator=torch.Generator().manual_seed(8))
    for m in (base, other):
        m.train()
    for _ in range(2):  # the stats move once per step, twice in all
        l0, g0, b0 = _step(base, x, probe)
        l1, g1, b1 = _step(other, x, probe)
        torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
        for k in g0:
            scale = max(1.0, float(g0[k].abs().max()))
            torch.testing.assert_close(g1[k], g0[k], rtol=1e-6,
                                       atol=1e-6 * scale, msg=k)
        assert b1.keys() == b0.keys()
        for k in b0:
            assert torch.equal(b1[k], b0[k]), k
    assert int(other.bn1.num_batches_tracked) == 2
    assert all(int(m.num_batches_tracked) == 2 for m in other.modules()
               if isinstance(m, BatchNorm))
    # Eval mode and no_grad: no checkpoint, the same outputs.
    for m in (base, other):
        m.eval()
    with torch.no_grad():
        assert torch.equal(other(x), base(x))


def test_dots_policy_is_jax_rule():
    """"dots" keeps what ``checkpoint_dots_with_no_batch_dims`` keeps:
    matrix products without batch dimensions, not convolutions (so a
    trunk of convolutions recomputes as under "block") nor ``bmm``."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default):
        assert tresnet._dots_policy(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.convolution.default, aten._convolution.default,
               aten.cudnn_convolution.default, aten.bmm.default,
               aten.native_batch_norm.default, aten.relu.default):
        assert (tresnet._dots_policy(None, op)
                == CheckpointPolicy.PREFER_RECOMPUTE), op


def test_pcme_remat_and_stem(images):
    kw = dict(embed_dim=16, cnn_type="resnet10", vocab_size=50, word_dim=8)
    base = PCME(**kw)
    init_pcme(base, torch.Generator().manual_seed(3))
    other = PCME(remat="dots", **kw)
    other.load_state_dict(base.state_dict())
    assert other.img_enc.cnn.remat == "dots"
    x = torch.tensor(images)
    outs = []
    for m in (base, other):
        m.train()
        emb = m.image_forward(x)["embedding"]
        emb.square().sum().backward()
        outs.append((emb.detach(), m.img_enc.cnn.conv1.weight.grad.clone(),
                     m.img_enc.cnn.bn1.running_var.clone()))
    for a, b in zip(*outs):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        PCME(remat="full", **kw)
    # The stem is the trunk's alone, as in the JAX package.
    with pytest.raises(TypeError, match="stem"):
        PCME(stem="s2d", **kw)


# ---------------------------------------------------------------------------
# remat against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", ["block", "dots"])
def test_remat_equal_jax(images, remat):
    imgs = images
    probe = np.random.default_rng(2).normal(
        size=(B, IMG // 32, IMG // 32, 512)).astype(np.float32)
    jm, params, stats = _jax_trunk("resnet10", imgs, remat=remat)
    grid, jgrads, new_stats = _jax_train(jm, params, stats, imgs, probe)
    tm = _port_trunk("resnet10", params, stats, remat=remat)
    got, grads = _port_train(tm, imgs, probe)
    _close(got.numpy(), grid, name="features")
    for k, want in _grads_as_torch(jgrads, new_stats).items():
        _close(grads[k].numpy(), want.numpy(), name=k)
    for k, want in flax_resnet_to_torch(params, new_stats).items():
        if "running" in k:
            _close(tm.state_dict()[k].numpy(), want.numpy(), name=k)


def test_remat_on_a_mesh_raises():
    mesh = types.SimpleNamespace(world=2)
    set_batchnorm_mesh(ResNetBackbone("resnet10"), mesh)
    set_batchnorm_mesh(ResNetBackbone("resnet10", remat="block"), None)
    with pytest.raises(NotImplementedError, match="remat='none'"):
        set_batchnorm_mesh(ResNetBackbone("resnet10", remat="block"), mesh)
