"""The port's text corpora (``data/agnews.py``: ``CORPORA``, ``Language``,
``IMDB``, ``text_cls``) and ``data/make_vocab.py`` vs the JAX package's.

Mirrors ``tests/test_text_corpora.py`` on the port, with every sample of
each corpus equal to the JAX package's; then the ``make_vocab`` CLI of
both packages on the COCO fixture annotations: the two vocabularies are
equal word for word and id for id, and the port's runs as ``python -m``.
Tolerance: none.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from creamfl_tpu.data import agnews as jagnews
from creamfl_tpu.data import make_vocab as jmake_vocab
from creamfl_tpu.data.vocab import Vocabulary as JVocabulary
from creamfl_tpu_torch.data import make_vocab
from creamfl_tpu_torch.data.agnews import CORPORA, IMDB, text_cls
from creamfl_tpu_torch.data.vocab import Vocabulary
from torch_cpu_share import torch_cpu_share  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANN = os.path.join(REPO, "tests", "fixtures", "coco", "annotations")
WORDS = ("<pad>", "<start>", "<end>", "<unk>", "good", "bad", "news",
         "sogou", "movie")


def _vocab(cls):
    v = cls()
    for t in WORDS:
        v.add_word(t)
    return v


@pytest.fixture
def vocab():
    return _vocab(Vocabulary)


def _write_csv(root, name, rows):
    d = root / name
    d.mkdir(parents=True)
    for split in ("train", "test"):
        with open(d / f"{split}.csv", "w", encoding="utf-8") as f:
            for label, text in rows:
                f.write(f'{label},"{text}"\n')


def _equal_to_jax(ds, name, root, **kw):
    jds, n_cls = jagnews.text_cls(name, root, vocab=_vocab(JVocabulary),
                                  **kw)
    assert n_cls == CORPORA[name] and len(ds) == len(jds)
    np.testing.assert_array_equal(ds.targets, jds.targets)
    for i in range(len(ds)):
        a, b = jds[i], ds[i]
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype


def test_registry_matches_reference_class_counts():
    assert CORPORA == jagnews.CORPORA == {
        "AG_NEWS": 4, "SogouNews": 5, "DBpedia": 14,
        "YelpReviewPolarity": 2, "YelpReviewFull": 5,
        "YahooAnswers": 10, "AmazonReviewPolarity": 2,
        "AmazonReviewFull": 5, "IMDB": 2}


@pytest.mark.parametrize("name", ["SogouNews", "DBpedia",
                                  "YelpReviewPolarity"])
def test_csv_corpora_read_by_name(tmp_path, vocab, name):
    _write_csv(tmp_path, name, [(1, "good news"), (2, "bad news"),
                                (1, "sogou news")])
    ds, n_cls = text_cls(name, str(tmp_path), train=True, vocab=vocab,
                         max_len=8)
    assert n_cls == CORPORA[name]
    assert len(ds) == 3
    item = ds[0]
    assert item["labels"] == 0  # 1-based CSV labels shift to 0-base
    assert ds[1]["labels"] == 1
    assert item["lengths"] == 4  # <start> good news <end>
    assert item["captions"][1] == vocab("good")
    _equal_to_jax(ds, name, str(tmp_path), train=True, max_len=8)
    sub, _ = text_cls(name, str(tmp_path), train=False, vocab=vocab,
                      indices=[2, 0])
    _equal_to_jax(sub, name, str(tmp_path), train=False, indices=[2, 0])


def test_imdb_folder_layout(tmp_path, vocab):
    for split in ("train", "test"):
        for sub in ("neg", "pos"):
            d = tmp_path / "IMDB" / "aclImdb" / split / sub
            d.mkdir(parents=True)
            (d / "0_1.txt").write_text(f"{sub} movie", encoding="utf-8")
            (d / "1_2.txt").write_text(f"good {sub} news",
                                       encoding="utf-8")
            (d / "notes.md").write_text("not a review", encoding="utf-8")
    ds, n_cls = text_cls("IMDB", str(tmp_path), train=True, vocab=vocab)
    assert isinstance(ds, IMDB)
    assert n_cls == 2 and len(ds) == 4
    assert sorted(np.asarray(ds.targets).tolist()) == [0, 0, 1, 1]
    # "<start> pos movie <end>": 'pos' is OOV -> <unk>, then 'movie'.
    assert ds[2]["captions"][2] == vocab("movie")
    _equal_to_jax(ds, "IMDB", str(tmp_path), train=True)
    sub, _ = text_cls("IMDB", str(tmp_path), train=False, vocab=vocab,
                      indices=[3, 1])
    _equal_to_jax(sub, "IMDB", str(tmp_path), train=False, indices=[3, 1])


def test_unknown_corpus_raises(tmp_path, vocab):
    with pytest.raises(KeyError):
        text_cls("SST2", str(tmp_path), vocab=vocab)


def test_missing_data_raises_filenotfound(tmp_path, vocab):
    with pytest.raises(FileNotFoundError):
        text_cls("SogouNews", str(tmp_path), vocab=vocab)
    with pytest.raises(FileNotFoundError):
        text_cls("IMDB", str(tmp_path), vocab=vocab)


@pytest.mark.parametrize("threshold", [1, 4])
def test_make_vocab_cli_equal_jax(tmp_path, monkeypatch, threshold):
    anns = [os.path.join(ANN, f) for f in ("captions_train2014.json",
                                           "captions_val2014.json")]
    argv = [a for ann in anns for a in ("--ann", ann)]
    argv += ["--threshold", str(threshold)]
    jout, tout = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    monkeypatch.setattr(sys, "argv", ["make_vocab"] + argv
                        + ["--out", jout])
    jmake_vocab.main()
    make_vocab.main(argv + ["--out", tout])
    want = JVocabulary().load_from_pickle(jout)
    got = Vocabulary().load_from_pickle(tout)
    assert len(got) > 4
    assert got.idx == want.idx
    assert got.word2idx == want.word2idx
    assert got.idx2word == want.idx2word


def test_make_vocab_module_cli(tmp_path):
    out = str(tmp_path / "vocab.pkl")
    proc = subprocess.run(
        [sys.executable, "-m", "creamfl_tpu_torch.data.make_vocab", "--ann",
         os.path.join(ANN, "captions_train2014.json"), "--threshold", "2",
         "--out", out], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    vocab = Vocabulary().load_from_pickle(out)
    assert f"vocab: {len(vocab)} words -> {out}" in proc.stdout
    assert vocab("<pad>") == 0 and vocab("<unk>") == 3
