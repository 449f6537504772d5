"""Port BERT encoder vs the JAX package's, and vs HuggingFace's BertModel.

BERT tiny (2 layers, width 64, 2 heads) with a pad mask. The JAX params are
carried over by ``models.convert.flax_bert_to_torch`` (HF key names); the
HF model's own ``state_dict`` loads through
``BertEncoder.load_hf_state_dict``. Dropout is off (eval mode, or rate 0 for
the train-mode gradients), so both sides compute the same function.

Tolerance: rtol 1e-4, atol 1e-5 of the largest reference entry (fp32,
another summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.models.bert import BertConfig as JConfig
from creamfl_tpu.models.bert import BertEncoder as JBert
from creamfl_tpu_torch.models.bert import BertConfig, BertEncoder
from creamfl_tpu_torch.models.convert import flax_bert_to_torch
from torch_cpu_share import torch_cpu_share  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, L = 3, 12


def _close(got, want, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=ATOL * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    ids = rng.integers(1, 512, size=(B, L)).astype(np.int32)
    lengths = np.array([L, 7, 3])
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.fixture(scope="module")
def twins(inputs):
    ids, mask = inputs
    cfg = dataclasses.replace(JConfig.tiny(), dropout_rate=0.0)
    jbert = JBert(cfg)
    params = jax.tree.map(np.asarray, jbert.init(
        jax.random.PRNGKey(5), jnp.asarray(ids), jnp.asarray(mask))["params"])
    tbert = BertEncoder(dataclasses.replace(BertConfig.tiny(),
                                            dropout_rate=0.0))
    tbert.load_state_dict(flax_bert_to_torch(params))
    return jbert, params, tbert


def test_config_matches_jax():
    assert (dataclasses.asdict(BertConfig())
            == dataclasses.asdict(JConfig()))
    assert (dataclasses.asdict(BertConfig.tiny())
            == dataclasses.asdict(JConfig.tiny()))


def test_hidden_states_with_pad_mask(twins, inputs):
    jbert, params, tbert = twins
    ids, mask = inputs
    want = jbert.apply({"params": params}, jnp.asarray(ids),
                       jnp.asarray(mask))
    tbert.eval()
    got = tbert(torch.tensor(ids).long(), torch.tensor(mask))
    _close(got, want)


def test_gradients(twins, inputs):
    jbert, params, tbert = twins
    ids, mask = inputs

    def j_loss(p):
        h = jbert.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                        deterministic=False)
        return jnp.sum(jnp.sin(h[:, 0, :])) + 0.1 * jnp.sum(h * h)

    want = flax_bert_to_torch(jax.tree.map(np.asarray,
                                           jax.grad(j_loss)(params)))
    tbert.train()
    tbert.zero_grad()
    h = tbert(torch.tensor(ids).long(), torch.tensor(mask))
    (torch.sin(h[:, 0, :]).sum() + 0.1 * (h * h).sum()).backward()
    for key, p in tbert.named_parameters():
        _close(p.grad, want[key].numpy(), key)


def test_loads_huggingface_bert_model(inputs):
    transformers = pytest.importorskip("transformers")
    ids, mask = inputs
    tiny = BertConfig.tiny()
    hf_cfg = transformers.BertConfig(
        vocab_size=tiny.vocab_size, hidden_size=tiny.hidden_size,
        num_hidden_layers=tiny.num_layers,
        num_attention_heads=tiny.num_heads,
        intermediate_size=tiny.intermediate_size,
        max_position_embeddings=tiny.max_position,
        type_vocab_size=tiny.type_vocab_size,
        layer_norm_eps=tiny.layer_norm_eps, hidden_act="gelu",
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertModel(hf_cfg).eval()
    ours = BertEncoder(tiny).eval()
    ours.load_hf_state_dict(hf.state_dict())
    ids_t, mask_t = torch.tensor(ids).long(), torch.tensor(mask).long()
    with torch.no_grad():
        want = hf(input_ids=ids_t, attention_mask=mask_t).last_hidden_state
        got = ours(ids_t, mask_t)
    # HF masks with the dtype's minimum, the port with -1e9: both give
    # exactly zero probability to the pads in fp32.
    _close(got, want.numpy())
