"""Synthetic dataset bundle for the federated round.

Port of the synthetic half of the JAX package's ``data/pipelines.py``
(``build_synthetic_datasets``, ``_family_batch_size``, ``_Subset``;
reference `src/utils/load_datasets.py` + `src/datasets/load_FL_datasets.py`).
``build_synthetic_datasets(args, ...)`` returns the loader bundle that
``federation.rounds.MMFL`` consumes:

  pub_train / pub_eval  the public caption set (train loader shuffled with
                        a ragged last batch, eval loader in order);
  test                  the retrieval test split (last batch padded);
  img_clients[i] / txt_clients[i] / mm_clients[i]  per-client loaders
                        (Dirichlet-hetero partitions of labelled sets);
  img_test / txt_test   shared local test sets;
  vocab, img_num_class, txt_num_class and the crossfold sizes.

Images are rendered on the host by the datasets and batched by
``ArrayLoader`` (the JAX package's ``grain`` backend falls back to it);
for one seed the batches are bit-equal to the JAX package's. The
``--paper_scale`` knobs: ``cache`` pre-renders the caption sets into
contiguous host arrays, ``prefetch`` assembles batches on a background
thread, ``client_image_size`` gives the image clients their own (CIFAR)
resolution, ``mm_client_data_size`` the mm clients their own size, and
``device_images`` synthesizes the caption sets' images on ``device``
(``data/device_synth.py``) so that only caption fields live on the host.
The real-data readers are not ported.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from creamfl_tpu_torch.data.device_synth import (DeviceImageBatches,
                                                 DeviceImageSynth)
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
