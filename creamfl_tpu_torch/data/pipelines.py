"""Dataset bundles for the federated round.

Port of the JAX package's ``data/pipelines.py`` (``build_synthetic_datasets``,
``build_real_datasets``, ``_family_batch_size``, ``_Subset``; reference
`src/utils/load_datasets.py` + `src/datasets/load_FL_datasets.py`).
Both builders return the loader bundle that ``federation.rounds.MMFL``
consumes:

  pub_train / pub_eval  the public caption set (train loader shuffled with
                        a ragged last batch, eval loader in order);
  test                  the retrieval test split (last batch padded);
  img_clients[i] / txt_clients[i] / mm_clients[i]  per-client loaders
                        (Dirichlet-hetero partitions of labelled sets);
  img_test / txt_test   shared local test sets;
  vocab, img_num_class, txt_num_class and the crossfold sizes.

Synthetic images are rendered on the host by the datasets and batched by
``ArrayLoader`` whatever ``--data_backend`` says, as in the JAX package;
for one seed the batches are bit-equal to the JAX package's. The
``--paper_scale`` knobs: ``cache`` pre-renders the caption sets into
contiguous host arrays, ``prefetch`` assembles batches on a background
thread, ``client_image_size`` gives the image clients their own (CIFAR)
resolution, ``mm_client_data_size`` the mm clients their own size, and
``device_images`` synthesizes the caption sets' images on ``device``
(``data/device_synth.py``) so that only caption fields live on the host.

``build_real_datasets`` reads MS-COCO, CIFAR-100, AG_NEWS and Flickr30k
from their published formats, with the frozen artifacts of
``data/frozen.py``; its image loaders are ``DeviceImages`` wrappers
(``data/device_images.py``) that decode and transform each batch's images
on ``device``. For one seed every caption, label and bookkeeping field is
bit-equal to the JAX package's bundle, and so is every image for the same
decoded pixels. Its loaders come from ``make_loader``
(``data/grain_loaders.py``): ``--data_backend grain --num_workers N``
assembles their batches in N worker processes.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from creamfl_tpu_torch.data.device_synth import (DeviceImageBatches,
                                                 DeviceImageSynth)
from creamfl_tpu_torch.data.grain_loaders import make_loader
from creamfl_tpu_torch.data.loaders import (ArrayLoader, CachedDataset,
                                            PrefetchLoader)
from creamfl_tpu_torch.data.partition import data_partitioner
from creamfl_tpu_torch.data.synthetic import (SyntheticCaptionDataset,
                                              SyntheticImageClassification,
                                              SyntheticTextClassification)
from creamfl_tpu_torch.data.vocab import Vocabulary


def build_synthetic_datasets(args, vocab: Optional[Vocabulary] = None,
                             pub_size: int = 256,
                             image_size: int = 64,
                             max_len: int = 16,
                             client_data_size: int = 128,
                             test_size: int = 64,
                             retrieval_test_size: int = 100,
                             batch_size: Optional[int] = None,
                             bert_tokenizer=None,
                             cache: bool = False,
                             client_image_size: Optional[int] = None,
                             prefetch: int = 0,
                             mm_client_data_size: Optional[int] = None,
                             device_images: bool = False,
                             pub_batch_size: Optional[int] = None,
                             pub_eval_batch_size: Optional[int] = None,
                             device="cuda") -> Dict:
    """Shape-faithful synthetic bundle (scaled down by default).

    ``device`` is where ``device_images`` synthesizes; nothing else reads
    it.
    """
    vocab = vocab or Vocabulary.synthetic(100)
    bs = batch_size or min(args.batch_size, pub_size)
    # Public loaders have their own batch sizes in the reference
    # (coco.yaml dataloader.batch_size=128 train, x2 eval subset;
    # load_datasets.py:59,82) independent of the clients' --batch_size.
    pub_bs = min(pub_batch_size or bs, pub_size)
    pub_ebs = min(pub_eval_batch_size or pub_bs, pub_size)
    client_image_size = client_image_size or image_size

    def _maybe_cache(ds):
        return CachedDataset(ds, verbose=True) if cache else ds

    def _caption_loader(base_ds, store, **kw):
        """Loader over a caption dataset; with ``device_images`` the images
        are synthesized on the device per batch, on the consumer's thread
        (after the prefetch thread)."""
        loader = ArrayLoader(store, **kw)
        if prefetch:
            loader = PrefetchLoader(loader, prefetch)
        if not device_images:
            return loader
        synth = DeviceImageSynth(base_ds.image_size, seed=base_ds.seed,
                                 n_concepts=base_ds.n_concepts,
                                 signal=base_ds.signal, device=device)
        return DeviceImageBatches(loader, synth, base_ds._concept)

    pub_ds = SyntheticCaptionDataset(
        n_captions=pub_size, image_size=image_size, max_len=max_len,
        vocab=vocab, seed=1, bert_tokenizer=bert_tokenizer,
        with_images=not device_images)
    test_ds = SyntheticCaptionDataset(
        n_captions=retrieval_test_size, image_size=image_size,
        max_len=max_len, vocab=vocab, seed=2, bert_tokenizer=bert_tokenizer,
        with_images=not device_images)
    pub, test = _maybe_cache(pub_ds), _maybe_cache(test_ds)

    datasets: Dict = {
        "vocab": vocab,
        "synthetic": True,
        # Keep the trailing partial public batch like the reference.
        "pub_train": _caption_loader(pub_ds, pub, batch_size=pub_bs,
                                     shuffle=True, drop_last=False,
                                     pad_last=False, seed=args.seed),
        "pub_eval": _caption_loader(pub_ds, pub, batch_size=pub_ebs,
                                    shuffle=False, pad_last=False),
        "test": _caption_loader(test_ds, test,
                                batch_size=min(bs, retrieval_test_size),
                                shuffle=False, pad_last=True),
        "img_num_class": 100,
        "txt_num_class": 4,
        # Synthetic retrieval test is small: shrink the crossfolds.
        "n_crossfolds": 2,
        "n_images_per_crossfold": max(1, retrieval_test_size // 10),
        "n_captions_per_crossfold": max(1, retrieval_test_size // 2 // 2),
    }

    # -- unimodal clients (Dirichlet hetero partition on labels) -------
    if args.num_img_clients > 0:
        full = SyntheticImageClassification(
            n=client_data_size * args.num_img_clients,
            image_size=client_image_size, num_classes=100, seed=3)
        parts = data_partitioner("cifar100", len(full),
                                 args.num_img_clients, "hetero",
                                 alpha=args.alpha,
                                 y_train=full.targets, seed=args.seed)
        img_bs = _family_batch_size(
            bs, *(len(parts[i]) for i in range(args.num_img_clients)))
        datasets["img_clients"] = [
            ArrayLoader(_Subset(full, parts[i]), img_bs, shuffle=True,
                        drop_last=False, pad_last=True, seed=args.seed)
            for i in range(args.num_img_clients)]
        datasets["img_test"] = ArrayLoader(
            SyntheticImageClassification(n=test_size,
                                         image_size=client_image_size,
                                         num_classes=100, seed=4),
            min(bs, test_size), pad_last=True)
    if args.num_txt_clients > 0:
        full = SyntheticTextClassification(
            n=client_data_size * args.num_txt_clients, num_classes=4,
            max_len=max_len, vocab=vocab, seed=5)
        parts = data_partitioner("AG_NEWS", len(full),
                                 args.num_txt_clients, "hetero",
                                 alpha=args.alpha,
                                 y_train=full.targets, seed=args.seed)
        txt_bs = _family_batch_size(
            bs, *(len(parts[i]) for i in range(args.num_txt_clients)))
        datasets["txt_clients"] = [
            ArrayLoader(_Subset(full, parts[i]), txt_bs, shuffle=True,
                        drop_last=False, pad_last=True, seed=args.seed)
            for i in range(args.num_txt_clients)]
        datasets["txt_test"] = ArrayLoader(
            SyntheticTextClassification(n=test_size, num_classes=4,
                                        max_len=max_len, vocab=vocab,
                                        seed=6),
            min(bs, test_size), pad_last=True)
    if args.num_mm_clients > 0:
        # mm shards are smaller than unimodal ones (the reference's F30k
        # k-split gives ~2k pairs a client vs CIFAR's 5k).
        mm_n = mm_client_data_size or client_data_size
        mm_datasets = [
            SyntheticCaptionDataset(n_captions=mm_n, image_size=image_size,
                                    max_len=max_len, vocab=vocab,
                                    seed=100 + i,
                                    with_images=not device_images)
            for i in range(args.num_mm_clients)]
        # pad_last + pair masking in local_step: reference DataLoaders
        # keep the trailing partial batch (drop_last=False).
        datasets["mm_clients"] = [
            _caption_loader(ds, _maybe_cache(ds), batch_size=min(bs, mm_n),
                            shuffle=True, drop_last=False, pad_last=True,
                            seed=args.seed)
            for ds in mm_datasets]
    return datasets


def _family_batch_size(cap: int, *sizes: int) -> int:
    """Family-uniform client batch size (the reference uses one fixed size
    for every client, MMFL.py:128), clamped to the largest shard so that
    miniature data does not pad every batch to the cap. Undersized shards
    pad with a valid mask."""
    return min(cap, max(1, max(sizes)))


class _Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)
        self.targets = np.asarray(dataset.targets)[self.indices] \
            if hasattr(dataset, "targets") else None

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def build_real_datasets(args, vocab_path: Optional[str], coco_root: str,
                        cifar_root: str, agnews_root: str, f30k_root: str,
                        bert_vocab: Optional[str] = None,
                        partition_dir: Optional[str] = None,
                        device="cuda") -> Dict:
    """Real-data bundle; mirrors prepare_coco_dataloaders +
    get_FL_trainloader. Raises FileNotFoundError on missing roots so the
    caller can fall back to synthetic. The frozen artifacts default to the
    packaged copies (``data/frozen.py``). Images are decoded and
    transformed on ``device``. Every loader comes from ``make_loader``
    (``data/grain_loaders.py``), as in the JAX package: ``--data_backend
    grain`` with ``--num_workers N`` assembles the batches in N worker
    processes, under the ``DeviceImages`` that decodes them in the main
    process; its batches equal the array backend's."""
    from creamfl_tpu_torch.data import frozen
    from creamfl_tpu_torch.data.agnews import Language
    from creamfl_tpu_torch.data.cifar import Cifar
    from creamfl_tpu_torch.data.coco import CocoCaptionsCap, SubsetDataset
    from creamfl_tpu_torch.data.device_images import (DeviceImages,
                                                      ImageArray, JpegFiles)
    from creamfl_tpu_torch.data.flickr30k import F30kCaptionsCap
    from creamfl_tpu_torch.data.tokenize import BertWordPieceTokenizer
    from creamfl_tpu_torch.data.transforms import (CIFAR100_MEAN,
                                                   CIFAR100_STD)
    from creamfl_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    backend = getattr(args, "data_backend", "array")
    workers = int(getattr(args, "num_workers", 0))

    def _loader(dataset, batch_size, **kw):
        return make_loader(dataset, batch_size, backend=backend,
                           num_workers=workers, **kw)

    def _jpeg_loader(dataset, base, batch_size, **kw):
        """A loader over a COCO or F30k dataset (``base`` the reader under
        any subset) with its images made on the device at 224²."""
        return DeviceImages(_loader(dataset, batch_size, **kw),
                            JpegFiles(base.image_path), 224, device=device)

    def _cifar_loader(dataset, base, source, batch_size, **kw):
        """A loader over a CIFAR set (``base`` the reader under any
        subset); the clients of one set share its ``source``, which puts
        the set on the device once."""
        return DeviceImages(_loader(dataset, batch_size, **kw), source,
                            base.out_size, CIFAR100_MEAN, CIFAR100_STD,
                            device=device)

    vocab = Vocabulary().load_from_pickle(vocab_path
                                          or frozen.coco_vocab_path())
    if partition_dir is None:
        partition_dir = frozen.partitions_dir()
    bert_tok = (BertWordPieceTokenizer.from_vocab_file(bert_vocab)
                if bert_vocab and os.path.exists(bert_vocab) else None)

    ann_dir = os.path.join(coco_root, "annotations")
    image_root = os.path.join(coco_root, "allimages")
    train_ann = os.path.join(ann_dir, "captions_train2014.json")
    val_ann = os.path.join(ann_dir, "captions_val2014.json")
    # Karpathy split ids are packaged artifacts; missing files are a loud
    # error (a silent None would fall back to ALL annotations).
    train_ids = frozen.load_coco_ids("train")
    restval_ids = frozen.load_coco_ids("restval")
    te_ids = frozen.load_coco_ids("test")

    # Miniature --smoke fixtures pair the full-COCO frozen id files with
    # subset annotation files, so missing ids are expected there; at real
    # scale a partial annotation file must fail loudly.
    allow_missing = bool(getattr(args, "smoke", False))

    def coco(train, ids=train_ids, extra=restval_ids):
        # Both pub splits keep caption-drop 0.1 + random-erasing 0.2: the
        # reference passes the train probs to train_subset_eval too
        # (load_datasets.py:80-89).
        return CocoCaptionsCap(
            image_root, train_ann, ids=ids, extra_ann_path=val_ann,
            extra_ids=extra, train=train, vocab=vocab,
            caption_drop_prob=0.1, random_erasing_prob=0.2,
            bert_tokenizer=bert_tok, allow_missing_ids=allow_missing)

    pub_num = getattr(args, "pub_data_num", 50000)
    coco_train, coco_eval = coco(True), coco(False)
    # total= matters only on the smoke-scale regeneration path.
    subset_idx = frozen.load_subset_idx(
        getattr(args, "coco_subset_idx", None), pub_data_num=pub_num,
        total=len(coco_train))
    # Honour --pub_data_num by slicing the frozen subset.
    subset_idx = subset_idx[:pub_num]
    coco_client = getattr(args, "coco_client", -1)
    if coco_client > -1:
        # Per-client COCO shard (reference load_datasets.py:164-166:
        # captions [100000 + 10000*client, 110000 + 10000*client)).
        subset_idx = list(range(100000 + coco_client * 10000,
                                110000 + coco_client * 10000))
    pub_train = SubsetDataset(coco_train, subset_idx)
    pub_eval = SubsetDataset(coco_eval, subset_idx)
    val_ids = frozen.load_coco_ids("dev")[:5000]
    test_set = CocoCaptionsCap(image_root, val_ann, ids=te_ids, train=False,
                               vocab=vocab, bert_tokenizer=bert_tok,
                               allow_missing_ids=allow_missing)

    # Public loaders use the server config's batch size (coco.yaml
    # dataloader.batch_size=128; eval subset x2), independent of the
    # clients' --batch_size.
    pub_bs = _family_batch_size(128, len(pub_train))
    datasets: Dict = {
        "vocab": vocab,
        "synthetic": False,
        # Reference DataLoaders keep the trailing partial public batch
        # (drop_last defaults False; the eval subset's last batch is bare,
        # not padded).
        "pub_train": _jpeg_loader(pub_train, coco_train, pub_bs,
                                  shuffle=True, drop_last=False,
                                  pad_last=False, seed=args.seed),
        "pub_eval": _jpeg_loader(pub_eval, coco_eval, pub_bs * 2,
                                 pad_last=False),
        "test": _jpeg_loader(test_set, test_set, 8, pad_last=True),
        "img_num_class": 100,
        "txt_num_class": 4,
        "n_crossfolds": 5,
        "n_images_per_crossfold": 1000,
        "n_captions_per_crossfold": 5000,
    }
    val_set = CocoCaptionsCap(image_root, val_ann, ids=val_ids, train=False,
                              vocab=vocab, bert_tokenizer=bert_tok,
                              allow_missing_ids=allow_missing)
    datasets["val"] = _jpeg_loader(val_set, val_set, 8, pad_last=True)

    if args.num_img_clients > 0:
        train = Cifar(cifar_root, "Cifar100", train=True)
        parts = data_partitioner("cifar100", len(train),
                                 args.num_img_clients, "hetero",
                                 check_dir=partition_dir, alpha=0.1,
                                 y_train=train.targets, seed=args.seed)
        img_bs = _family_batch_size(
            512, *(len(parts[i]) for i in range(args.num_img_clients)))
        source = ImageArray(train.data)
        datasets["img_clients"] = [
            _cifar_loader(_Subset(train, parts[i]), train, source, img_bs,
                          shuffle=True, pad_last=True, seed=args.seed)
            for i in range(args.num_img_clients)]
        test_img = Cifar(cifar_root, "Cifar100", train=False)
        datasets["img_test"] = _cifar_loader(
            test_img, test_img, ImageArray(test_img.data),
            _family_batch_size(512, len(test_img)), pad_last=True)
    if args.num_txt_clients > 0:
        train = Language(agnews_root, "AG_NEWS", train=True, vocab=vocab)
        parts = data_partitioner("AG_NEWS", len(train),
                                 args.num_txt_clients, "hetero",
                                 check_dir=partition_dir, alpha=0.1,
                                 y_train=train.targets, seed=args.seed)
        txt_bs = _family_batch_size(
            512, *(len(parts[i]) for i in range(args.num_txt_clients)))
        datasets["txt_clients"] = [
            _loader(_Subset(train, parts[i]), txt_bs, shuffle=True,
                    pad_last=True, seed=args.seed)
            for i in range(args.num_txt_clients)]
        test_txt = Language(agnews_root, "AG_NEWS", train=False,
                            vocab=vocab)
        datasets["txt_test"] = _loader(
            test_txt, _family_batch_size(512, len(test_txt)),
            pad_last=True)
    if args.num_mm_clients > 0:
        pp = os.path.join(partition_dir, "client_noniid_flicker30k.pkl")
        mm_sets = [
            F30kCaptionsCap(f30k_root, "train", train=True, vocab=vocab,
                            caption_drop_prob=0.1, random_erasing_prob=0.2,
                            client=i, partition_pickle=pp)
            for i in range(args.num_mm_clients)]
        mm_bs = _family_batch_size(128, *(len(d) for d in mm_sets))
        datasets["mm_clients"] = [
            # pad_last + MCSoft pair masking == the reference's bare
            # trailing partial batch (drop_last defaults False).
            _jpeg_loader(d, d, mm_bs, shuffle=True, drop_last=False,
                         pad_last=True, seed=args.seed)
            for d in mm_sets]
    return datasets
