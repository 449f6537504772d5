"""The port's CUB reader (``data/cub.py``) vs the JAX package's, on
``tests/fixtures/cub``.

* The reader: length, ``n_images``, ``class_to_indices`` and
  ``iid_to_cls`` equal; over two epochs (new augmentation draws) every
  batch field equals the JAX package's, and the images, which the port
  makes from recipes through ``DeviceImages`` (PIL's decode on the CPU),
  equal the JAX package's PIL transforms bit for bit; train and test
  splits, and a train split with ``omit_ids``.
* ``CUBSampler``: the same class-balanced orders over three epochs.
* The retrieval evaluator in class mode (``iid_to_cls`` from the reader)
  over the CUB loader: the same scores as the JAX package's evaluator.

``image_ids`` is ``hash(rel) % 2**31`` in both packages: equal within this
one process. Tolerance: none.
"""

import os

import numpy as np
import pytest
import torch

from creamfl_tpu.data.cub import CUBCaption as JCUB
from creamfl_tpu.data.cub import CUBSampler as JSampler
from creamfl_tpu.data.loaders import ArrayLoader as JArrayLoader
from creamfl_tpu.data.vocab import Vocabulary as JVocabulary
from creamfl_tpu_torch.data import frozen
from creamfl_tpu_torch.data.cub import CUBCaption, CUBSampler
from creamfl_tpu_torch.data.device_images import DeviceImages, JpegFiles
from creamfl_tpu_torch.data.loaders import ArrayLoader
from creamfl_tpu_torch.data.vocab import Vocabulary
from torch_cpu_share import torch_cpu_share  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "fixtures", "cub")
SPLITS = {"train": ("trainvalclasses.txt", True),
          "test": ("testclasses.txt", False)}


def _pair(split, omit=None):
    classes, train = SPLITS[split]
    args = (os.path.join(ROOT, "images"), os.path.join(ROOT, "captions"),
            os.path.join(ROOT, classes))
    jv = JVocabulary().load_from_pickle(frozen.coco_vocab_path())
    tv = Vocabulary().load_from_pickle(frozen.coco_vocab_path())
    return (JCUB(*args, vocab=jv, train=train, omit_ids=omit),
            CUBCaption(*args, vocab=tv, train=train, omit_ids=omit))


def _loaders(jds, tds, bs=3):
    jl = JArrayLoader(jds, bs, shuffle=True, pad_last=True, seed=4)
    tl = DeviceImages(ArrayLoader(tds, bs, shuffle=True, pad_last=True,
                                  seed=4),
                      JpegFiles(tds.image_path), 224, device="cpu")
    return jl, tl


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("split,omit", [("train", False), ("test", False),
                                        ("train", True)])
def test_reader_equal_jax(split, omit, tmp_path):
    omit_file = None
    if omit:
        omit_file = str(tmp_path / "omit.txt")
        with open(omit_file, "w") as f:
            f.write(os.path.join("001.Black_footed_Albatross",
                                 "Black_footed_Albatross_0001.jpg") + "\n")
    jds, tds = _pair(split, omit_file)
    assert len(tds) == len(jds) > 0
    assert tds.n_images == jds.n_images
    assert tds.class_to_indices == jds.class_to_indices
    assert tds.iid_to_cls == jds.iid_to_cls
    if omit:
        assert len(tds) == len(_pair(split)[1]) - 2  # one image, 2 captions
    jl, tl = _loaders(jds, tds)
    for _ in range(2):
        jb, tb = list(jl), list(tl)
        assert len(jb) == len(tb) == len(tl)
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for field in a:
                np.testing.assert_array_equal(_np(b[field]),
                                              np.asarray(a[field]),
                                              err_msg=field)


def test_sampler_equal_jax():
    jds, tds = _pair("train")
    js, ts = JSampler(jds, seed=3), CUBSampler(tds, seed=3)
    for _ in range(3):
        order = list(ts.epoch_indices())
        assert order == list(js.epoch_indices())
        assert len({int(tds[i]["labels"]) for i in order}) == len(order) == 2


def test_evaluator_class_mode_equal_jax():
    import jax.numpy as jnp

    from creamfl_tpu.engine import evaluator as J
    from creamfl_tpu_torch.engine import evaluator as T

    jds, tds = _pair("train")
    rng = np.random.default_rng(6)
    # Multiples of 1/4: every product exact in fp32 in both frameworks.
    img = (rng.integers(-4, 5, (len(tds), 8)) / 4.0).astype(np.float32)
    cap = (rng.integers(-4, 5, (len(tds), 8)) / 4.0).astype(np.float32)

    def extract(to):
        def fn(batch):
            rows = np.asarray(batch["index"])
            return to(img[rows]), to(cap[rows])
        return fn

    kw = dict(n_crossfolds=0, n_images_per_crossfold=1,
              n_captions_per_crossfold=1, eval_batch_size=3,
              eval_method="matmul")
    jl, tl = _loaders(jds, tds)
    want = J.RetrievalEvaluator(iid_to_cls=jds.iid_to_cls, **kw).evaluate(
        jl, extract(jnp.asarray))
    got = T.RetrievalEvaluator(iid_to_cls=tds.iid_to_cls, **kw).evaluate(
        tl, extract(torch.tensor))
    assert got == want
    assert "n_fold" not in got
