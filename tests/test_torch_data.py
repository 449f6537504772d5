"""The port's synthetic data layer vs the JAX package's: bit-equal.

Both packages are numpy here, so for one seed every batch of every loader
of ``build_synthetic_datasets`` (every field, over two rounds'
``set_round`` orders and a plain epoch before them), the partitions of
``data_partitioner`` and the ids of ``BertWordPieceTokenizer.synthetic``
must be equal, bit for bit. Tolerance: none (exact equality).
"""

import types

import numpy as np
import pytest

from creamfl_tpu.data import partition as jpartition
from creamfl_tpu.data import pipelines as jpipelines
from creamfl_tpu.data import tokenize as jtokenize
from creamfl_tpu.data.loaders import suffix_valid as j_suffix_valid
from creamfl_tpu_torch.data import partition, pipelines, tokenize
from creamfl_tpu_torch.data.loaders import (ArrayLoader, CachedDataset,
                                            PrefetchLoader, ProjectedLoader,
                                            suffix_valid)
from creamfl_tpu_torch.data.synthetic import SyntheticCaptionDataset
from creamfl_tpu_torch.data.vocab import Vocabulary
from torch_cpu_share import torch_cpu_share  # noqa: F401

SCALE = dict(pub_size=20, image_size=16, max_len=10, client_data_size=12,
             test_size=10, retrieval_test_size=14, batch_size=8,
             pub_batch_size=8, pub_eval_batch_size=12)


def _args(**kw):
    ns = types.SimpleNamespace(seed=5, batch_size=8, alpha=0.5,
                               num_img_clients=2, num_txt_clients=2,
                               num_mm_clients=2)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _loaders(ds):
    out = {}
    for key, val in ds.items():
        if isinstance(val, list):
            out.update({f"{key}[{i}]": v for i, v in enumerate(val)})
        elif hasattr(val, "__iter__") and hasattr(val, "batch_size") or (
                hasattr(val, "loader")):
            out[key] = val
    return out


def _assert_batches_equal(jl, tl, tag):
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == len(tl), tag
    for i, (j, t) in enumerate(zip(jb, tb)):
        assert sorted(j) == sorted(t), f"{tag} batch {i} fields"
        for k in j:
            a, b = np.asarray(j[k]), np.asarray(t[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (tag, i, k)
            np.testing.assert_array_equal(b, a, err_msg=f"{tag} {i} {k}")


@pytest.mark.parametrize("bert", [False, True], ids=["gru", "bert"])
def test_synthetic_bundle_bit_equal(bert):
    args = _args()
    jtok = jtokenize.BertWordPieceTokenizer.synthetic() if bert else None
    ttok = tokenize.BertWordPieceTokenizer.synthetic() if bert else None
    jds = jpipelines.build_synthetic_datasets(args, bert_tokenizer=jtok,
                                              **SCALE)
    tds = pipelines.build_synthetic_datasets(args, bert_tokenizer=ttok,
                                             **SCALE)
    scalars = {k: v for k, v in jds.items()
               if isinstance(v, (bool, int, float))}
    assert scalars == {k: tds[k] for k in scalars}
    assert len(tds["vocab"]) == len(jds["vocab"])
    jl, tl = _loaders(jds), _loaders(tds)
    assert sorted(jl) == sorted(tl) and len(tl) == 11
    for name in sorted(jl):
        # A plain epoch, then two rounds (two epochs in the first).
        _assert_batches_equal(jl[name], tl[name], f"{name} plain")
        for round_n, epochs in ((0, 2), (3, 1)):
            jl[name].set_round(round_n)
            tl[name].set_round(round_n)
            for e in range(epochs):
                _assert_batches_equal(jl[name], tl[name],
                                      f"{name} round {round_n} epoch {e}")
    if bert:
        batch = next(iter(tds["pub_train"]))
        assert batch["bert_ids"].shape == (8, 32)


def test_shuffled_rounds_differ():
    """set_round changes a shuffled loader's order (the check above is not
    vacuous), and pads stay a suffix."""
    tds = pipelines.build_synthetic_datasets(_args(), **SCALE)
    loader = tds["pub_train"]
    loader.set_round(0)
    first = np.concatenate([b["index"] for b in loader])
    loader.set_round(1)
    second = np.concatenate([b["index"] for b in loader])
    assert sorted(first) == sorted(second) == list(range(20))
    assert not np.array_equal(first, second)
    for b in tds["test"]:
        assert suffix_valid(b["valid"]) == j_suffix_valid(b["valid"])


@pytest.mark.parametrize("kind", ["homo", "hetero"])
@pytest.mark.parametrize("seed", [0, 2021])
def test_partitioner_bit_equal(kind, seed):
    y = (np.arange(400) * 31 + 7) % 10
    kw = dict(alpha=0.5, y_train=y, seed=seed)
    j = jpartition.data_partitioner("cifar100", 400, 6, kind, **kw)
    t = partition.data_partitioner("cifar100", 400, 6, kind, **kw)
    assert j == t and len(t) == 6


def test_partitioner_cache_write_waits_for_real_data(tmp_path):
    """The cache write waited for the real-data readers, which are ported:
    a regenerated partition is written, equals the JAX package's, and is
    read back (another seed does not regenerate it)."""
    import pickle

    got = partition.data_partitioner("cifar100", 40, 2, "homo",
                                     check_dir=str(tmp_path))
    want = jpartition.data_partitioner("cifar100", 40, 2, "homo")
    assert got == want
    with open(tmp_path / "client_cifar100_iid.pkl", "rb") as f:
        assert pickle.load(f) == want
    assert partition.data_partitioner("cifar100", 40, 2, "homo",
                                      check_dir=str(tmp_path),
                                      seed=7) == want


def test_bert_wordpiece_synthetic_ids_bit_equal():
    j = jtokenize.BertWordPieceTokenizer.synthetic()
    t = tokenize.BertWordPieceTokenizer.synthetic()
    texts = ["12 7 99 3", "a man riding a horse", "Héllo, WORLD!", "",
             "x" * 150, "tok1 tok2 ##3"]
    for text in texts:
        for max_len in (8, 32):
            assert t.encode(text, max_len) == j.encode(text, max_len)
    ids, mask = t.encode_batch(texts, 16)
    jids, jmask = j.encode_batch(texts, 16)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    vocab = Vocabulary.synthetic(10)
    for s in ("word1 word2 foo.", "A word9!"):
        assert (tokenize.caption_to_ids(s, vocab)
                == jtokenize.caption_to_ids(s, vocab))


def test_cached_prefetch_and_projected_loaders():
    ds = SyntheticCaptionDataset(n_captions=9, image_size=8, max_len=8)
    plain = list(ArrayLoader(ds, 4, pad_last=True))
    cached = list(ArrayLoader(CachedDataset(ds), 4, pad_last=True))
    prefetched = list(PrefetchLoader(ArrayLoader(ds, 4, pad_last=True)))
    for a, b, c in zip(plain, cached, prefetched):
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
            np.testing.assert_array_equal(c[k], a[k])
    proj = list(ProjectedLoader(ArrayLoader(ds, 4), ("captions", "valid")))
    assert all(sorted(b) == ["captions", "valid"] for b in proj)


def test_device_images_not_ported():
    """The on-device image branch is ported (it was refused before):
    with ``device_images`` the caption sets' images come from
    ``DeviceImageSynth`` on the device asked for, as torch tensors of the
    host images' shape, and every other field is the host bundle's."""
    import torch

    from creamfl_tpu_torch.data.device_synth import DeviceImageBatches

    host = pipelines.build_synthetic_datasets(_args(), **SCALE)
    dev = pipelines.build_synthetic_datasets(_args(), device_images=True,
                                             device="cpu", **SCALE)
    for key in ("pub_train", "pub_eval", "test"):
        assert isinstance(dev[key], DeviceImageBatches), key
        for hb, db in zip(host[key], dev[key]):
            assert sorted(hb) == sorted(db)
            assert isinstance(db["images"], torch.Tensor)
            assert tuple(db["images"].shape) == hb["images"].shape
            for k in hb:
                if k != "images":
                    np.testing.assert_array_equal(db[k], hb[k], err_msg=k)
