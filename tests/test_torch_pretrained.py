"""Pretrained weights from local files: the port's loaders vs the JAX
package's.

No weights ship with the repository and none are fetched: the files are
written here with ``torch.save`` from random weights, under the key names
of their sources (a torchvision ResNet state dict with its ``fc.*``
classifier and random BatchNorm statistics; an HF ``BertModel`` state dict
under ``bert.``, as ``BertFor*`` saves it; a GloVe text file).

* Server: JAX's ``ServerEngine.load_pretrained`` and the port's, from the
  same start weights and files, give the same eval-mode server features
  within ``test_torch_server.py``'s tolerance before any update (rtol
  1e-4, atol 1e-5 of the largest entry); the port's trunk and BERT equal
  the files' tensors bit for bit.
* Client trunk (``--client_resnet_ckpt``): the port's ``MMFL`` loads the
  file into every image client, bit for bit, as the JAX package's
  ``_load_client_resnet`` does; a file of another architecture is skipped
  with the JAX package's log line, in both, and changes nothing.
* GloVe (``--glove_path``): the same matrix and the same miss count in
  both packages, the reference's hit-rate variants included; the port's
  server (GRU branch) and its text and mm clients take the matrix.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.config import default_config_path as j_config_path
from creamfl_tpu.config import parse_config as j_parse_config
from creamfl_tpu.engine.client_uni import UniClientEngine as JClientEngine
from creamfl_tpu.engine.server import ServerEngine as JServer
from creamfl_tpu.federation.rounds import MMFL as JMMFL
from creamfl_tpu.models.bert import BertConfig as JBertConfig
from creamfl_tpu.models.convert import \
    load_glove_embeddings as j_load_glove_embeddings
from creamfl_tpu.models.pcme import PCME as JPCME
from creamfl_tpu_torch.config import default_config_path, parse_config
from creamfl_tpu_torch.data.pipelines import build_synthetic_datasets
from creamfl_tpu_torch.data.vocab import Vocabulary
from creamfl_tpu_torch.engine.server import ServerEngine
from creamfl_tpu_torch.federation.rounds import MMFL
from creamfl_tpu_torch.main import build_configs
from creamfl_tpu_torch.models.bert import BertConfig
from creamfl_tpu_torch.models.convert import (flax_image_client_to_torch,
                                              flax_server_state_to_torch,
                                              load_glove_embeddings,
                                              load_state_dict)
from creamfl_tpu_torch.models.pcme import PCME
from creamfl_tpu_torch.models.resnet import ResNetBackbone, init_parameters
from test_torch_round import SIZES, _args, _configs, _Log
from torch_cpu_share import torch_cpu_share  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
B, IMG, L, E = 4, 32, 10, 16
TRUNK = "resnet10"
MISMATCH = "client trunk/ckpt architecture mismatch; skipping pretrained load"


def _close(got, want, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(
        got, want, rtol=RTOL, atol=ATOL * max(1.0, float(np.abs(want).max())),
        err_msg=name)


def _torchvision_file(path, cnn_type, seed):
    """A torchvision-keyed ResNet checkpoint from random weights: the
    port's trunk (torchvision's names), random BatchNorm statistics and a
    1000-way ``fc`` classifier."""
    gen = torch.Generator().manual_seed(seed)
    trunk = ResNetBackbone(cnn_type)
    init_parameters(trunk, gen)
    sd = trunk.state_dict()
    for key, val in sd.items():
        if key.endswith("running_mean"):
            sd[key] = 0.1 * torch.randn(val.shape, generator=gen)
        elif key.endswith("running_var"):
            sd[key] = 0.5 + torch.rand(val.shape, generator=gen)
        elif key.endswith(".bias") or key.endswith("bn1.weight"):
            sd[key] = val + 0.05 * torch.randn(val.shape, generator=gen)
    width = sd["layer4.0.conv1.weight"].shape[0] * (
        1 if "layer4.0.conv3.weight" not in sd else 4)
    sd["fc.weight"] = torch.randn(1000, width, generator=gen)
    sd["fc.bias"] = torch.randn(1000, generator=gen)
    torch.save(sd, path)
    return sd


def _hf_bert_file(path, tiny):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=tiny.vocab_size, hidden_size=tiny.hidden_size,
        num_hidden_layers=tiny.num_layers,
        num_attention_heads=tiny.num_heads,
        intermediate_size=tiny.intermediate_size,
        max_position_embeddings=tiny.max_position,
        type_vocab_size=tiny.type_vocab_size,
        layer_norm_eps=tiny.layer_norm_eps)
    torch.manual_seed(5)
    hf = transformers.BertModel(cfg)
    sd = {f"bert.{k}": v for k, v in hf.state_dict().items()}
    torch.save(sd, path)
    return sd


def _batch():
    rng = np.random.default_rng(3)
    lengths = rng.integers(3, L + 1, size=B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.integers(1, 512, size=(B, L)).astype(np.int32) * mask
    return (rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32), ids,
            mask.sum(-1).astype(np.int32), mask)


def test_server_load_pretrained_matches_jax(tmp_path):
    resnet_sd = _torchvision_file(tmp_path / "resnet.pth", TRUNK, 11)
    overrides = dict(model__embed_dim=E, model__cnn_type=TRUNK,
                     train__use_bf16=False)
    jbert = dataclasses.replace(JBertConfig.tiny(), dropout_rate=0.0)
    tbert = dataclasses.replace(BertConfig.tiny(), dropout_rate=0.0)
    bert_sd = _hf_bert_file(tmp_path / "bert.bin", tbert)
    images, ids, lengths, mask = _batch()

    jeng = JServer(j_parse_config(j_config_path("coco.yaml"), **overrides),
                   vocab_size=512, bert_config=jbert)
    jeng.model = JPCME(embed_dim=E, cnn_type=TRUNK, not_bert=False,
                       bert_config=jbert)
    jstate = jeng.init_state(jax.random.PRNGKey(0), {
        "images": images, "bert_ids": ids, "bert_mask": mask})
    teng = ServerEngine(parse_config(default_config_path("coco.json"),
                                     **overrides),
                        vocab_size=512, bert_config=tbert, device="cpu")
    teng.model = PCME(embed_dim=E, cnn_type=TRUNK, not_bert=False,
                      bert_config=tbert)
    tstate = teng.init_state(state_dict=flax_server_state_to_torch(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats)))
    before = teng.eval_step(tstate, images, ids, lengths, mask)

    jstate = jeng.load_pretrained(jstate, resnet_path=str(
        tmp_path / "resnet.pth"), bert_path=str(tmp_path / "bert.bin"))
    tstate = teng.load_pretrained(tstate, resnet_path=str(
        tmp_path / "resnet.pth"), bert_path=str(tmp_path / "bert.bin"))
    for key, val in tstate.model.img_enc.cnn.state_dict().items():
        assert torch.equal(val, resnet_sd[key]), key
    for key, val in tstate.model.txt_enc.bert.state_dict().items():
        assert torch.equal(val, bert_sd[f"bert.{key}"]), key
    ti, tt = teng.eval_step(tstate, images, ids, lengths, mask)
    ji, jt = jeng.eval_step(jstate, *map(jnp.asarray, (images, ids, lengths,
                                                       mask)))
    _close(ti, ji, "image features")
    _close(tt, jt, "caption features")
    # The load changed what the server computes.
    assert not torch.allclose(ti, before[0], atol=1e-3)
    assert not torch.allclose(tt, before[1], atol=1e-3)


def _vocab():
    vocab = Vocabulary.synthetic(6)
    for word in ("co-op", "u.s.", "don't", "and/or", "zebra"):
        vocab.add_word(word)
    return vocab


def _glove_file(path, dim):
    rng = np.random.default_rng(9)
    # Exact words, the hit-rate variants of four vocab words, and words
    # the vocabulary does not hold; "word5" and "zebra" stay misses.
    words = ["word0", "word1", "<unk>", "coop", "us", "dont", "and",
             "apple", "word4"]
    rows = {w: rng.normal(size=dim).astype(np.float32) for w in words}
    with open(path, "w", encoding="utf-8") as f:
        for w, v in rows.items():
            f.write(w + " " + " ".join(repr(float(x)) for x in v) + "\n")
    return rows


def test_glove_matrix_and_misses_match_jax(tmp_path):
    vocab, dim = _vocab(), 8
    _glove_file(tmp_path / "glove.txt", dim)
    init = np.random.default_rng(1).normal(
        size=(len(vocab), dim)).astype(np.float32)
    for start in (None, init):
        got, missing = load_glove_embeddings(str(tmp_path / "glove.txt"),
                                             vocab, dim, init=start)
        want, jmissing = j_load_glove_embeddings(
            str(tmp_path / "glove.txt"), vocab, dim, init=start)
        np.testing.assert_array_equal(got, want)
        assert missing == jmissing == len(vocab) - 8
    # Misses keep their initial rows.
    got, _ = load_glove_embeddings(str(tmp_path / "glove.txt"), vocab, dim,
                                   init=init)
    for word in ("word5", "zebra", "<pad>"):
        idx = vocab.word2idx[word]
        np.testing.assert_array_equal(got[idx], init[idx])


def test_round_loads_glove_into_server_and_clients(tmp_path):
    args = _args(tmp_path)
    ds = build_synthetic_datasets(args, **SIZES)
    # GloVe's width, which the text client's embedding always has.
    rows = _glove_file(tmp_path / "glove.txt", 300)
    args.glove_path = str(tmp_path / "glove.txt")
    server, mm, bert = _configs(build_configs, args)
    server.model.word_dim = mm.model.word_dim = 300
    log = _Log()
    algo = MMFL(args, ds, server, mm, bert_config=bert, logger=log,
                device="cpu")
    vocab = ds["vocab"]
    embeds = [algo.server_state.model.txt_enc.embed.weight]
    for c in algo.clients:
        if c.kind == "txt":
            embeds.append(c.state.model.embed.weight)
        elif c.kind == "mm":
            embeds.append(c.state.model.txt_enc.embed.weight)
    assert len(embeds) == 3
    for embed in embeds:
        for word in ("word0", "word1", "word4", "<unk>"):
            np.testing.assert_array_equal(
                embed[vocab.word2idx[word]].detach().numpy(), rows[word])
    assert "loaded pretrained weights into server" in log.lines
    assert f"glove: 4/{len(vocab)} hit" in log.lines


def _jax_clients(args, n):
    eng = JClientEngine("img", num_class=100, args=args)
    sample = {"images": np.zeros((2, IMG, IMG, 3), np.float32),
              "labels": np.zeros(2, np.int32)}
    return [types.SimpleNamespace(kind="img", state=eng.init_state(
        jax.random.PRNGKey(k), sample)) for k in range(n)]


def test_client_resnet_loads_like_jax(tmp_path):
    sd = _torchvision_file(tmp_path / "r10.pth", TRUNK, 21)
    other = _torchvision_file(tmp_path / "r18.pth", "resnet18", 22)
    args = _args(tmp_path, num_img_clients=2, num_txt_clients=0,
                 num_mm_clients=0, client_num_per_round=2)
    ds = build_synthetic_datasets(args, **SIZES)
    server, mm, bert = _configs(build_configs, args)

    # JAX: its MMFL method over two image clients of the same trunk.
    jself = types.SimpleNamespace(clients=_jax_clients(args, 2),
                                  logger=_Log())
    JMMFL._load_client_resnet(jself, str(tmp_path / "r10.pth"))
    for c in jself.clients:
        got = flax_image_client_to_torch(
            jax.tree.map(np.asarray, c.state.params),
            jax.tree.map(np.asarray, c.state.batch_stats))
        for key, val in sd.items():
            if not key.startswith("fc.") and "num_batches" not in key:
                assert torch.equal(got[f"backbone.{key}"], val), key
    # The port: --client_resnet_ckpt through MMFL's construction.
    args.client_resnet_ckpt = str(tmp_path / "r10.pth")
    algo = MMFL(args, ds, server, mm, bert_config=bert, logger=_Log(),
                device="cpu")
    assert [c.kind for c in algo.clients] == ["img", "img"]
    for c in algo.clients:
        for key, val in c.state.model.backbone.state_dict().items():
            assert torch.equal(val, sd[key]), key
    assert load_state_dict(str(tmp_path / "r10.pth")).keys() == sd.keys()

    # Another architecture: both log the line and load nothing.
    jself = types.SimpleNamespace(clients=_jax_clients(args, 1),
                                  logger=_Log())
    kept = jax.tree.map(np.asarray, jself.clients[0].state.params)
    JMMFL._load_client_resnet(jself, str(tmp_path / "r18.pth"))
    assert jself.logger.lines == [MISMATCH]
    jax.tree.map(np.testing.assert_array_equal, kept,
                 jax.tree.map(np.asarray, jself.clients[0].state.params))
    args.client_resnet_ckpt = str(tmp_path / "r18.pth")
    log = _Log()
    skipped = MMFL(args, ds, server, mm, bert_config=bert, logger=log,
                   device="cpu")
    assert log.lines.count(MISMATCH) == 1
    args.client_resnet_ckpt = None
    plain = MMFL(args, ds, server, mm, bert_config=bert, logger=_Log(),
                 device="cpu")
    for c, ref in zip(skipped.clients, plain.clients):
        for key, val in c.state.model.state_dict().items():
            assert torch.equal(val, ref.state.model.state_dict()[key]), key
    assert other["conv1.weight"].shape == sd["conv1.weight"].shape
