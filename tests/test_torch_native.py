"""The port's native caption tokenizer (``data/native.py``,
``csrc/native.cpp``) against the JAX package's native library.

* **The ids.** The JAX side's library is built with g++ from the JAX
  package's own source into this test's temporary directory (its
  ``_lib_path`` patched there, its handle reset), so nothing is written
  beside that source and ``tests/test_native.py``'s build is not raced.
  Over more than 1 000 captions (the fixture datasets' captions and
  generated ones with punctuation, quotes, brackets and contractions),
  at ``caption_drop_prob`` 0 and 0.1, over several seeds and at a short
  ``max_len`` that cuts captions, the port's ids and lengths equal the
  JAX library's bit for bit (tolerance: none).
* **The bundle.** ``build_real_datasets`` on ``tests/fixtures/`` in both
  packages with both native tokenizers on: every COCO loader's batches
  equal the JAX package's over two epochs, caption drops included.
* **The build.** A source that does not compile raises with the
  compiler's output.
"""

import glob
import json
import os
import subprocess

import numpy as np
import pytest

from creamfl_tpu.data import native as jnative
from creamfl_tpu.data.pipelines import build_real_datasets as j_build
from creamfl_tpu.data.vocab import Vocabulary as JVocabulary
from creamfl_tpu_torch.data import frozen, native
from creamfl_tpu_torch.data.pipelines import build_real_datasets
from creamfl_tpu_torch.data.vocab import Vocabulary
from creamfl_tpu_torch.ops import build as builder
from test_torch_real_data import (FIX, ROOTS, _args, _as_numpy,
                                  _partition_dir)
from torch_cpu_share import torch_cpu_share  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COCO_LOADERS = ("pub_train", "pub_eval", "test", "val")
WORDS = ("a", "man", "dog", "riding", "bike", "street", "two", "cats",
         "sitting", "on", "the", "bench", "cannot", "gonna", "wanna",
         "don't", "it's", "they're", "we've", "you'll", "i'd", "i'm",
         "dog's", "can't", "'tis", "'twas", "gimme", "lemme", "more'n",
         "d'ye", "1,000", "3:30", "$5", "50%", "e-mail", "--", "...",
         "(", ")", "[", "]", "{", "}", "<", ">", "\"", "''", "``", ",",
         ";", ":", "!", "?", "&", "#", "@", "zebra", "ünïcode", "x-ray",
         "o'clock", "rock'n'roll", "U.S.", "etc.", "'", "`", "n't")


def _captions():
    texts = []
    for path in glob.glob(os.path.join(FIX, "**", "*.json"),
                          recursive=True):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and "annotations" in data:
            texts += [a["caption"] for a in data["annotations"]]
        elif isinstance(data, dict) and "images" in data:
            texts += [s["raw"] for im in data["images"]
                      for s in im.get("sentences", [])]
    rng = np.random.default_rng(0)
    while len(texts) < 1200:
        words = rng.choice(WORDS, size=int(rng.integers(0, 24)))
        text = " ".join(words)
        if rng.random() < 0.3:
            text = text.capitalize() + "."
        if rng.random() < 0.2:
            text = '"' + text + '"'
        texts.append(text)
    return texts


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native library, built from its source into a
    temporary directory and loaded there."""
    lib = tmp_path_factory.mktemp("jnative") / "libcreamfl_native.so"
    subprocess.run(["g++", *builder.GXX_FLAGS, "-o", str(lib),
                    os.path.join(REPO, "native", "creamfl_native.cpp")],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_lib_path", lambda: str(lib))
        mp.setattr(jnative, "_LIB", None)
        assert jnative.available()
        yield jnative


@pytest.fixture(scope="module")
def vocabs():
    path = frozen.coco_vocab_path()
    return JVocabulary().load_from_pickle(path), \
        Vocabulary().load_from_pickle(path)


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_ids_equal_jax_native(jax_native, vocabs, drop):
    jvocab, vocab = vocabs
    texts = _captions()
    assert len(texts) >= 1000
    jv, tv = jax_native.NativeVocab(jvocab), native.NativeVocab(vocab)
    for seed in (0, 1, 2021, 2 ** 62 + 12345):
        for max_len in (64, 12):
            want = jv.tokenize_batch(texts, max_len, drop, seed=seed)
            got = tv.tokenize_batch(texts, max_len, drop, seed=seed)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    # Per caption, as the readers call it, each with its own seed.
    rng = np.random.default_rng(5)
    for text in texts[:200]:
        seed = int(rng.integers(0, 2 ** 63))
        want = jv.tokenize_batch([text], 32, drop, seed=seed)
        got = tv.tokenize_batch([text], 32, drop, seed=seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=text)
    assert tv.lookup("dog") == vocab("dog")
    assert tv.lookup("no-such-word") == vocab("<unk>")


@pytest.fixture(scope="module")
def native_bundles(jax_native, tmp_path_factory):
    jtmp = tmp_path_factory.mktemp("jax_native")
    ttmp = tmp_path_factory.mktemp("port_native")
    jax_ds = j_build(_args(jtmp), None, partition_dir=_partition_dir(jtmp),
                     **ROOTS)
    port_ds = build_real_datasets(_args(ttmp), None,
                                  partition_dir=_partition_dir(ttmp),
                                  device="cpu", **ROOTS)
    return jax_ds, port_ds


def test_native_bundle_equals_jax(native_bundles):
    jax_ds, port_ds = native_bundles
    assert port_ds["pub_train"].base.dataset.dataset._native_vocab \
        is not None
    for key in COCO_LOADERS:
        for _ in range(2):  # two epochs: new orders and new drops
            jb, tb = list(jax_ds[key]), list(port_ds[key])
            assert len(jb) == len(tb) > 0
            for a, b in zip(jb, tb):
                assert sorted(a) == sorted(b)
                for field in a:
                    np.testing.assert_array_equal(
                        _as_numpy(b[field]), np.asarray(a[field]),
                        err_msg=f"{key}/{field}")


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( { return 0; }\n")
    monkeypatch.setattr(builder, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on bad.cpp"):
        builder.build(bad, compiler="g++", flags=builder.GXX_FLAGS)
    with pytest.raises(RuntimeError, match="cannot run"):
        builder.build(bad, compiler=str(tmp_path / "no-such-compiler"),
                      flags=builder.GXX_FLAGS)
