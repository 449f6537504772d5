"""Port PCME (BERT text branch) and its parts vs the JAX package.

PIENet (with a pad mask), ImageEncoder, TextEncoderBert and the whole PCME,
forward in train and eval mode and gradients, with the JAX weights carried
over by ``models.convert``. The image trunk is a two-stage Bottleneck trunk
registered in both packages' ``RESNET_CONFIGS`` for this module only
(ResNet-50 has the same blocks; its shapes are tested in
``test_torch_bottleneck.py``): at 64² it leaves an 8 x 8 grid, so train-mode
BatchNorm sees enough rows to be well conditioned, and the JAX side
compiles in seconds. BERT is tiny with dropout 0. fp32 on both sides.

Tolerance: rtol 1e-4, atol 1e-5 of the largest reference entry (fp32,
another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.models import resnet as jresnet
from creamfl_tpu.models.bert import BertConfig as JConfig
from creamfl_tpu.models.pcme import PCME as JPCME
from creamfl_tpu.models.pie import PIENet as JPIENet
from creamfl_tpu_torch.models import resnet as tresnet
from creamfl_tpu_torch.models.bert import BertConfig
from creamfl_tpu_torch.models.convert import (flax_pcme_to_torch,
                                              flax_pie_to_torch)
from creamfl_tpu_torch.models.pcme import PCME
from creamfl_tpu_torch.models.pie import PIENet
from torch_cpu_share import torch_cpu_share  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, IMG, L, E = 4, 64, 10, 16
TRUNK = "resnet_b2"


def _close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(scope="module", autouse=True)
def small_bottleneck_trunk():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jresnet.RESNET_CONFIGS, TRUNK,
                   (jresnet.Bottleneck, (1, 1), 512))
        mp.setitem(tresnet.RESNET_CONFIGS, TRUNK,
                   (tresnet.Bottleneck, (1, 1), 512))
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    images = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    ids = rng.integers(1, 512, size=(B, L)).astype(np.int32)
    lengths = np.array([L, 8, 5, 3], np.int32)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    return images, ids * mask, lengths, mask


def _models(fused, data):
    images, ids, lengths, mask = data
    bert = dataclasses.replace(JConfig.tiny(), dropout_rate=0.0)
    jm = JPCME(embed_dim=E, cnn_type=TRUNK, not_bert=False, bert_config=bert,
               fused_bn=fused)
    variables = jm.init(jax.random.PRNGKey(9), *map(
        jnp.asarray, (images, ids, lengths, mask)))
    params = jax.tree.map(np.asarray, variables["params"])
    rng = np.random.default_rng(4)
    stats = jax.tree.map(
        lambda a: (np.asarray(a) * rng.uniform(0.8, 1.25, a.shape)
                   + rng.normal(0.0, 0.1, a.shape)).astype(np.float32),
        variables["batch_stats"])
    tm = PCME(embed_dim=E, cnn_type=TRUNK, not_bert=False,
              bert_config=dataclasses.replace(BertConfig.tiny(),
                                              dropout_rate=0.0),
              fused_bn=fused)
    tm.load_state_dict(flax_pcme_to_torch(params, stats))
    return jm, params, stats, tm


def _torch_inputs(data):
    images, ids, lengths, mask = data
    return (torch.tensor(images), torch.tensor(ids).long(),
            torch.tensor(lengths), torch.tensor(mask))


def test_pie_net_with_pad_mask():
    rng = np.random.default_rng(2)
    out = rng.normal(size=(3, 12)).astype(np.float32)
    x = rng.normal(size=(3, 7, 20)).astype(np.float32)
    pad = np.arange(7)[None, :] >= np.array([7, 4, 2])[:, None]
    for n_embeds in (1, 2):
        jnet = JPIENet(n_embeds=n_embeds, d_out=12, d_hidden=10)
        params = jax.tree.map(np.asarray, jnet.init(
            jax.random.PRNGKey(n_embeds), out, x, pad)["params"])
        want = jnet.apply({"params": params}, out, x, pad)
        tnet = PIENet(n_embeds, 20, 12, 10)
        tnet.load_state_dict(flax_pie_to_torch(params, ""))
        got = tnet(torch.tensor(out), torch.tensor(x), torch.tensor(pad))
        for g, w, name in zip(got, want, ("out", "attn", "residual")):
            _close(g, w, f"{name} (n_embeds {n_embeds})")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_pcme_forward(data, fused, train):
    """Image and caption features, PIE attention and residual, and (train
    mode) the running-stat updates, standard and fused trunk."""
    jm, params, stats, tm = _models(fused, data)
    args = tuple(map(jnp.asarray, data))
    if train:
        want, upd = jm.apply({"params": params, "batch_stats": stats}, *args,
                             train=True, mutable=["batch_stats"])
    else:
        want = jm.apply({"params": params, "batch_stats": stats}, *args)
    tm.train(train)
    got = tm(*_torch_inputs(data))
    for key in ("image_features", "caption_features", "image_attentions",
                "image_residuals"):
        _close(got[key], want[key], key)
    if train:
        new = flax_pcme_to_torch(params, jax.tree.map(
            np.asarray, upd["batch_stats"]))
        sd = tm.state_dict()
        for key, val in new.items():
            if "running_" in key:
                _close(sd[key], val.numpy(), key)


@pytest.mark.parametrize("fused", [False, True])
def test_pcme_gradients(data, fused):
    """Train-mode gradients of every parameter under a loss on both
    features."""
    jm, params, stats, tm = _models(fused, data)
    args = tuple(map(jnp.asarray, data))
    w = np.random.default_rng(8).normal(size=(B, E)).astype(np.float32)

    def j_loss(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, *args,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(out["image_features"] * out["caption_features"]
                       ) + jnp.sum(w * out["image_features"])

    want = flax_pcme_to_torch(jax.tree.map(np.asarray,
                                           jax.grad(j_loss)(params)), stats)
    tm.train()
    out = tm(*_torch_inputs(data))
    (torch.sum(out["image_features"] * out["caption_features"])
     + torch.sum(torch.tensor(w) * out["image_features"])).backward()
    for key, p in tm.named_parameters():
        _close(p.grad, want[key].numpy(), "grad " + key)


def test_gru_text_branch_not_ported_yet():
    # The GRU text branch came with the round slice (its parity with the
    # JAX module is in tests/test_torch_gru.py): not_bert=True now builds
    # it instead of raising, and the BERT branch is unchanged.
    from creamfl_tpu_torch.models.pcme import TextEncoderGRU

    model = PCME(embed_dim=E, cnn_type=TRUNK, not_bert=True, vocab_size=50,
                 word_dim=12)
    assert isinstance(model.txt_enc, TextEncoderGRU)
    assert not hasattr(model.txt_enc, "bert")
