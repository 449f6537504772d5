"""Port image-client model vs the JAX package, with JAX weights carried
over by the port's ``models.convert``.

Tolerance: rtol 1e-4 atol 1e-5 (fp32 convolutions summed in another
order). The logits carry the x128 feature scale (entries ~150), so their
atol is 1e-5 of the largest entry: an entry near zero is a difference of
terms that large, and fp32 rounds each at ~1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.models.clients import ImageClientNet as JNet
from creamfl_tpu.models.convert import torchvision_resnet_to_flax
from creamfl_tpu.models.resnet import ResNetBackbone as JBackbone
from creamfl_tpu_torch.models.clients import ImageClientNet, clamp_head_weights
from creamfl_tpu_torch.models.convert import flax_image_client_to_torch
from creamfl_tpu_torch.models.resnet import ResNetBackbone
from torch_cpu_share import torch_cpu_share  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
B, IMG, E, C = 4, 32, 16, 10


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def twins():
    rng = np.random.default_rng(3)
    images = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    jnet = JNet(cnn_type="resnet10", num_class=C, embed_dim=E)
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(images), False,
                          "train")
    params = _tree_np(variables["params"])
    # Non-trivial running stats (init has mean 0, var 1), so eval mode
    # tests them.
    stats = {"backbone": jax.tree.map(
        lambda x: (x * rng.uniform(0.8, 1.25, x.shape)
                   + rng.normal(0.0, 0.1, x.shape)).astype(np.float32),
        _tree_np(variables["batch_stats"]["backbone"]))}
    return jnet, params, stats, images


def _port(params, stats):
    tnet = ImageClientNet("resnet10", num_class=C, embed_dim=E)
    tnet.load_state_dict(flax_image_client_to_torch(params, stats))
    return tnet


def test_train_forward_and_bn_running_stats(twins):
    jnet, params, stats, images = twins
    tnet = _port(params, stats)
    (jx1, jx2, jw1, jw2), mut = jnet.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(images),
        True, "train", mutable=["batch_stats"])
    tnet.train()
    x1, x2, w1, w2 = tnet(torch.tensor(images), phase="train")
    for t, j in ((x1, jx1), (x2, jx2), (w1, jw1), (w2, jw2)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * max(1.0, np.abs(j).max()))
    # Running stats after one train-mode forward: flax's biased-variance
    # EMA. layer4 normalises a 1 x 1 grid over 4 images, where the
    # unbiased variance of nn.BatchNorm2d would be 4/3 larger.
    want = flax_image_client_to_torch(params, _tree_np(mut["batch_stats"]))
    got = tnet.state_dict()
    for key, val in want.items():
        if "running_" in key:
            np.testing.assert_allclose(got[key].numpy(), val.numpy(),
                                       err_msg=key, **TOL)


def test_eval_features_phase(twins):
    jnet, params, stats, images = twins
    tnet = _port(params, stats)
    jfeat = jnet.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(images), False, "features")
    tnet.eval()
    with torch.no_grad():
        feat = tnet(torch.tensor(images), phase="features")
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), **TOL)
    np.testing.assert_allclose(np.linalg.norm(feat.numpy(), axis=1), 1.0,
                               rtol=1e-6)


def test_clamp_head_weights_in_place():
    torch.manual_seed(0)
    net = ImageClientNet("resnet6", num_class=C, embed_dim=E)
    linear_before = net.linear.weight.detach().clone()
    clamp_head_weights(net)
    assert (net.class_fc.weight >= 0).all() and (net.class_fc_2.weight
                                                 >= 0).all()
    assert torch.equal(net.linear.weight, linear_before)


def test_convert_round_trip_torchvision_names(twins):
    """The port's backbone state_dict, read by the JAX package's
    torchvision converter, gives back the JAX trees: the port uses
    torchvision's key names."""
    _, params, stats, _ = twins
    tnet = _port(params, stats)
    sd = {k[len("backbone."):]: v.numpy()
          for k, v in tnet.state_dict().items() if k.startswith("backbone.")}
    p2, s2 = torchvision_resnet_to_flax(sd)
    jax.tree.map(np.testing.assert_array_equal, p2, params["backbone"])
    jax.tree.map(np.testing.assert_array_equal, s2, stats["backbone"])


@pytest.mark.parametrize("cnn_type", ["resnet6", "resnet18", "resnet34"])
def test_backbone_tree_matches_jax(cnn_type):
    """Same parameter tree and shapes as the JAX trunk (shapes only)."""
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    want = jax.eval_shape(lambda: JBackbone(cnn_type).init(
        jax.random.PRNGKey(0), x, False))
    sd = {k: v.numpy() for k, v in ResNetBackbone(cnn_type).state_dict()
          .items()}
    p, s = torchvision_resnet_to_flax(sd)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(p) == shapes(want["params"])
    assert shapes(s) == shapes(want["batch_stats"])


def test_bottleneck_trunks_not_ported_yet():
    # The Bottleneck trunks (resnet50/101/152) came with the server slice
    # (tests/test_torch_bottleneck.py); a trunk the JAX package lacks still
    # raises. The clients' --mlp_local head is ported (tests below).
    with pytest.raises(NotImplementedError):
        ResNetBackbone("resnet200")
    assert ImageClientNet("resnet6", mlp_local=True).head_proj is not None
    assert ImageClientNet("resnet6").head_proj is None


@pytest.fixture(scope="module")
def mlp_twins():
    """A JAX ImageClientNet with --mlp_local, its params from both phases'
    inits merged as the JAX client engine does (the features phase alone
    creates head_proj), with non-trivial running stats."""
    rng = np.random.default_rng(5)
    images = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    jnet = JNet(cnn_type="resnet10", num_class=C, embed_dim=E,
                mlp_local=True)
    key = jax.random.PRNGKey(2)
    train = jnet.init(key, jnp.asarray(images), False, "train")
    feats = jnet.init(key, jnp.asarray(images), False, "features")
    assert "head_proj" not in train["params"]
    assert "class_fc" not in feats["params"]
    params = _tree_np({**train["params"], **feats["params"]})
    stats = jax.tree.map(
        lambda x: (x * rng.uniform(0.8, 1.25, x.shape)
                   + rng.normal(0.0, 0.1, x.shape)).astype(np.float32),
        _tree_np({**train["batch_stats"], **feats["batch_stats"]}))
    return jnet, params, stats, images


def _port_mlp(params, stats):
    tnet = ImageClientNet("resnet10", num_class=C, embed_dim=E,
                          mlp_local=True)
    tnet.load_state_dict(flax_image_client_to_torch(params, stats))
    return tnet


def test_mlp_local_state_dict_matches_jax_tree(mlp_twins):
    """The port has exactly the JAX engine's parameters and BN stats:
    head_proj's fc1, bn (with running stats) and fc2, 512 wide, beside
    the train phase's heads."""
    _, params, stats, _ = mlp_twins
    want = flax_image_client_to_torch(params, stats)
    got = ImageClientNet("resnet10", num_class=C, embed_dim=E,
                         mlp_local=True).state_dict()
    assert set(got) == set(want)
    for key, val in want.items():
        assert tuple(got[key].shape) == tuple(val.shape), key
    assert tuple(got["head_proj.fc2.weight"].shape) == (512, 512)
    assert "head_proj.bn.running_var" in got


@pytest.mark.parametrize("train", [True, False])
def test_mlp_local_features_phase(mlp_twins, train):
    """Features phase with head_proj: train mode (batch stats, running
    stats moved as flax moves them, head_proj's BN included) and eval
    mode (running stats); unit rows 512 wide."""
    jnet, params, stats, images = mlp_twins
    tnet = _port_mlp(params, stats)
    variables = {"params": params, "batch_stats": stats}
    if train:
        jfeat, mut = jnet.apply(variables, jnp.asarray(images), True,
                                "features", mutable=["batch_stats"])
    else:
        jfeat = jnet.apply(variables, jnp.asarray(images), False, "features")
    tnet.train(train)
    with torch.no_grad():
        feat = tnet(torch.tensor(images), phase="features")
    assert feat.shape == (B, 512)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jfeat), **TOL)
    np.testing.assert_allclose(np.linalg.norm(feat.numpy(), axis=1), 1.0,
                               rtol=1e-6)
    if train:
        want = flax_image_client_to_torch(params,
                                          _tree_np(mut["batch_stats"]))
        got = tnet.state_dict()
        moved = [k for k in want if "running_" in k]
        assert "head_proj.bn.running_mean" in moved
        # head_proj's BN sees the x128-scaled features through fc1 (entries
        # ~10): atol 1e-5 of the largest entry, as for the logits above.
        for key in moved:
            w = want[key].numpy()
            np.testing.assert_allclose(
                got[key].numpy(), w, err_msg=key, rtol=TOL["rtol"],
                atol=TOL["atol"] * max(1.0, np.abs(w).max()))
