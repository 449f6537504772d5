"""The port's real-data path vs the JAX package's, on ``tests/fixtures/``.

* **The bundle.** ``build_real_datasets`` on the fixtures in both packages
  with the arguments of ``tests/test_real_data.py``; for every loader,
  batch by batch over two epochs, every field is equal, images included:
  the port decodes with PIL on the CPU (the same pixels as the JAX
  package's) and transforms in torch, bit for bit (tolerance: none). Both
  sides run their Python tokenizers: the JAX side with
  ``native.available`` patched to False, the port's COCO readers with
  ``native=False`` (``tests/test_torch_native.py`` holds the two native
  tokenizers and the bundle with both on).
* **Frozen artifacts.** The port's copies are byte-equal to the JAX
  package's (sha256); the frozen loaders give the same arrays, the same
  regenerated subset and the same refusal at paper scale; partitions
  written to a cache read back the same in both packages.
* **A round** (``MMFL.train(0)``) on the fixture bundle, with the configs
  of ``test_two_round_mmfl_on_fixtures``: finite scores, (8, 16) global
  features.
* **The CLI.** ``main.run`` with ``--no-cuda --smoke`` and the fixture
  roots reaches its scores on a real (not synthetic) bundle.
"""

import functools
import hashlib
import os
import pickle
import shutil
import types

import numpy as np
import pytest
import torch

from creamfl_tpu.data import frozen as jfrozen
from creamfl_tpu.data import native as jnative
from creamfl_tpu.data import partition as jpartition
from creamfl_tpu.data.flickr30k import F30kCaptionsCap as JF30k
from creamfl_tpu.data.pipelines import build_real_datasets as j_build
from creamfl_tpu.data.vocab import Vocabulary as JVocabulary
from creamfl_tpu_torch.data import coco, frozen, partition
from creamfl_tpu_torch.data.flickr30k import F30kCaptionsCap
from creamfl_tpu_torch.data.pipelines import build_real_datasets
from creamfl_tpu_torch.data.vocab import Vocabulary
from torch_cpu_share import torch_cpu_share  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
ROOTS = dict(coco_root=os.path.join(FIX, "coco"),
             cifar_root=os.path.join(FIX, "cifar"),
             agnews_root=os.path.join(FIX, "agnews"),
             f30k_root=os.path.join(FIX, "f30k"))
LOADERS = ("pub_train", "pub_eval", "test", "val", "img_clients",
           "txt_clients", "mm_clients", "img_test", "txt_test")
ARTIFACTS = ("annotations/coco_train_ids.npy",
             "annotations/coco_restval_ids.npy",
             "annotations/coco_dev_ids.npy", "annotations/coco_test_ids.npy",
             "artifacts/coco_subset_idx_file", "vocabs/coco_vocab.pkl",
             "partitions/client_cifar100_noniid.pkl",
             "partitions/client_AG_NEWS_noniid.pkl",
             "partitions/client_noniid_flicker30k.pkl")


def _args(tmp, **kw):
    ns = types.SimpleNamespace(
        name="real", exp_dir=str(tmp), local_epochs=1, comm_rounds=2,
        img_model_local="resnet10", seed=11, num_img_clients=2,
        num_txt_clients=2, num_mm_clients=2, client_num_per_round=6,
        batch_size=8, alpha=0.5, server_lr=1e-4, disable_distill=False,
        agg_method="con_w", contrast_local_intra=True,
        contrast_local_inter=True, mlp_local=False, kd_weight=0.3,
        interintra_weight=0.5, loss_scale=False, save_client=False,
        pub_data_num=8, feature_dim=16, not_bert=True, smoke=True,
        synthetic=False, client_parallel=True, ckpt_dir=None, wandb=False,
        coco_subset_idx=os.path.join(FIX, "coco_subset_idx"),
        data_backend="array", num_workers=0, use_mesh=False)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def _partition_dir(tmp):
    """A fresh partition dir holding the fixture F30k partition (CIFAR's
    and AG_NEWS's regenerate there against the fixture sizes)."""
    pdir = os.path.join(str(tmp), "partition")
    os.makedirs(pdir, exist_ok=True)
    shutil.copy(os.path.join(FIX, "partitions",
                             "client_noniid_flicker30k.pkl"), pdir)
    return pdir


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(coco, "CocoCaptionsCap",
                   functools.partial(coco.CocoCaptionsCap, native=False))
        jtmp = tmp_path_factory.mktemp("jax")
        ttmp = tmp_path_factory.mktemp("port")
        jax_ds = j_build(_args(jtmp), None,
                         partition_dir=_partition_dir(jtmp), **ROOTS)
        port_ds = build_real_datasets(_args(ttmp), None,
                                      partition_dir=_partition_dir(ttmp),
                                      device="cpu", **ROOTS)
    return jax_ds, port_ds


def _as_numpy(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("key", LOADERS)
def test_bundle_bit_equal_to_jax(bundles, key):
    jax_ds, port_ds = bundles
    assert port_ds["synthetic"] is False
    for k in ("img_num_class", "txt_num_class", "n_crossfolds",
              "n_images_per_crossfold", "n_captions_per_crossfold"):
        assert port_ds[k] == jax_ds[k]
    jl, tl = jax_ds[key], port_ds[key]
    jl, tl = (jl, tl) if isinstance(jl, list) else ([jl], [tl])
    assert len(jl) == len(tl)
    images = 0
    for _ in range(2):  # two epochs: new orders and new draws
        for jloader, tloader in zip(jl, tl):
            jb, tb = list(jloader), list(tloader)
            assert len(jb) == len(tb) == len(tloader)
            for a, b in zip(jb, tb):
                assert sorted(a) == sorted(b)
                for field in a:
                    np.testing.assert_array_equal(
                        _as_numpy(b[field]), np.asarray(a[field]),
                        err_msg=f"{key}/{field}")
                if "images" in b:
                    assert b["images"].dtype == torch.float32
                    images += len(b["images"])
    if key not in ("txt_clients", "txt_test"):
        assert images > 0


def test_text_view_decodes_no_image(tmp_path):
    """A text family's view of the public loader (``ProjectedLoader``
    without ``images``) iterates the caption-only base loader: no JPEG is
    read or decoded."""
    from creamfl_tpu_torch.data import jpeg
    from creamfl_tpu_torch.data.loaders import ProjectedLoader

    port_ds = build_real_datasets(_args(tmp_path), None,
                                  partition_dir=_partition_dir(tmp_path),
                                  device="cpu", **ROOTS)
    before = dict(jpeg.decode_batch.images_by_route)
    fields = ("captions", "lengths", "index", "valid")
    batches = list(ProjectedLoader(port_ds["pub_eval"], fields))
    assert batches and all(sorted(b) == sorted(fields) for b in batches)
    assert jpeg.decode_batch.images_by_route == before
    images = list(ProjectedLoader(port_ds["pub_eval"], ("images",)))
    assert jpeg.decode_batch.images_by_route["pil"] > before["pil"]
    assert images[0]["images"].shape[1:] == (224, 224, 3)


@pytest.mark.parametrize("rel", ARTIFACTS)
def test_frozen_artifacts_byte_equal(rel):
    def digest(root):
        with open(os.path.join(root, rel), "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    assert digest(os.path.dirname(frozen.__file__)) == digest(
        os.path.dirname(jfrozen.__file__))


def test_frozen_loaders_same_arrays(tmp_path):
    assert frozen.partitions_dir() != jfrozen.partitions_dir()
    for split in ("train", "restval", "dev", "test"):
        np.testing.assert_array_equal(frozen.load_coco_ids(split),
                                      jfrozen.load_coco_ids(split))
    assert frozen.load_subset_idx() == jfrozen.load_subset_idx()
    assert len(frozen.load_subset_idx()) == frozen.PAPER_PUB_DATA_NUM
    port_vocab = Vocabulary().load_from_pickle(frozen.coco_vocab_path())
    jax_vocab = JVocabulary().load_from_pickle(jfrozen.coco_vocab_path())
    assert port_vocab.word2idx == jax_vocab.word2idx
    # Smoke-scale regeneration at a missing path: the same indices, written.
    paths = [str(tmp_path / "port_idx"), str(tmp_path / "jax_idx")]
    got = frozen.load_subset_idx(paths[0], pub_data_num=32, total=500)
    want = jfrozen.load_subset_idx(paths[1], pub_data_num=32, total=500)
    assert got == want and len(got) == 32
    with open(paths[0], "rb") as f:
        assert pickle.load(f) == want
    # Paper scale at a missing path: both refuse.
    for mod in (frozen, jfrozen):
        with pytest.raises(FileNotFoundError, match="paper-scale"):
            mod.load_subset_idx(str(tmp_path / "missing"))


def test_partition_caches_read_back_the_same(tmp_path):
    y = (np.arange(300) * 7 + 3) % 10
    for name, kind in (("cifar100", "hetero"), ("AG_NEWS", "homo")):
        dirs = [str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")]
        kw = dict(alpha=0.5, y_train=y, seed=5)
        got = partition.data_partitioner(name, 300, 4, kind,
                                         check_dir=dirs[0], **kw)
        want = jpartition.data_partitioner(name, 300, 4, kind,
                                           check_dir=dirs[1], **kw)
        assert got == want
        suffix = "_iid.pkl" if kind == "homo" else "_noniid.pkl"
        files = [os.path.join(d, f"client_{name}{suffix}") for d in dirs]
        for path in files:
            with open(path, "rb") as f:
                assert pickle.load(f) == want
        # Each package reads the other's cache (a fresh seed shows it is
        # read, not regenerated), and a smaller run takes its first
        # clients.
        assert partition.data_partitioner(name, 300, 4, kind,
                                          check_dir=dirs[1], seed=99,
                                          alpha=0.5, y_train=y) == want
        assert jpartition.data_partitioner(name, 300, 3, kind,
                                           check_dir=dirs[0], seed=99,
                                           alpha=0.5, y_train=y) == {
            i: want[i] for i in range(3)}
        with pytest.raises(ValueError, match="holds 4 clients"):
            partition.data_partitioner(name, 300, 6, kind,
                                       check_dir=dirs[0], **kw)
    # Never written into the packaged frozen artifacts.
    before = sorted(os.listdir(frozen.partitions_dir()))
    partition.data_partitioner("cifar100", 300, 4, "homo",
                               check_dir=frozen.partitions_dir(), seed=5)
    assert sorted(os.listdir(frozen.partitions_dir())) == before
    # F30k's regenerated shard partition is written back, the same draw.
    pickles = [str(tmp_path / "f30k_port.pkl"), str(tmp_path / "f30k_jax.pkl")]
    root = os.path.join(FIX, "f30k")
    np.random.seed(3)
    got = F30kCaptionsCap(root, client=1, partition_pickle=pickles[0]).pairs
    np.random.seed(3)
    want = JF30k(root, client=1, partition_pickle=pickles[1]).pairs
    assert got == want
    with open(pickles[0], "rb") as f, open(pickles[1], "rb") as g:
        a, b = pickle.load(f), pickle.load(g)
    assert a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)


def test_round_on_fixtures(tmp_path):
    from creamfl_tpu_torch.federation.rounds import MMFL
    from creamfl_tpu_torch.main import build_configs

    args = _args(tmp_path)
    ds = build_real_datasets(args, None, partition_dir=_partition_dir(
        tmp_path), device="cpu", **ROOTS)
    # Fixture-scale retrieval folds (build_real_datasets' 5 x 1000/5000
    # are full-COCO constants).
    ds["n_crossfolds"] = 2
    ds["n_images_per_crossfold"] = 2
    ds["n_captions_per_crossfold"] = 4
    server_cfg, mm_cfg, bert_cfg = build_configs(args)
    for cfg in (server_cfg, mm_cfg):
        cfg.model.cnn_type = "resnet10"
        cfg.model.word_dim = 8
    algo = MMFL(args, ds, server_cfg, mm_cfg, bert_config=bert_cfg,
                device="cpu")
    scores = algo.train(0)
    assert np.isfinite(scores["i2t"]["recall_1"])
    assert np.isfinite(scores["rsum"])
    assert algo.img_vec is not None and algo.txt_vec is not None
    assert tuple(algo.global_img_feature.shape) == (8, 16)
    assert torch.isfinite(algo.global_img_feature).all()


def test_cli_real_round_on_fixtures(tmp_path):
    from creamfl_tpu_torch import main

    args = main.parse_args([
        "--no-cuda", "--smoke", "--coco_root", ROOTS["coco_root"],
        "--cifar_root", ROOTS["cifar_root"], "--agnews_root",
        ROOTS["agnews_root"], "--f30k_root", ROOTS["f30k_root"],
        "--coco_subset_idx", os.path.join(FIX, "coco_subset_idx"),
        "--partition_dir", _partition_dir(tmp_path), "--pub_data_num", "8",
        "--comm_rounds", "1", "--local_epochs", "1", "--num_img_clients",
        "2", "--num_txt_clients", "2", "--num_mm_clients", "2",
        "--client_num_per_round", "6", "--batch_size", "8",
        "--feature_dim", "16", "--not_bert", "--agg_method", "con_w",
        "--contrast_local_inter", "--contrast_local_intra", "--seed", "11",
        "--exp_dir", str(tmp_path / "exp"), "--name", "fixtures"])
    algo = main.run(args)
    assert algo.datasets["synthetic"] is False
    assert algo.sampled == [1, 2, 3, 4, 5, 6]
    scores = algo.last_scores
    assert np.isfinite(scores["rsum"])
    assert 0.0 <= scores["i2t"]["recall_1"] <= 100.0
    assert tuple(algo.global_img_feature.shape) == (8, 16)
    assert os.path.exists(tmp_path / "exp" / "fixtures-last_model.ckpt")
