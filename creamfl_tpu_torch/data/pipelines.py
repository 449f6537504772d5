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
real-data readers and the on-device image path (``device_images``) are
not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from creamfl_tpu_torch.data.loaders import ArrayLoader
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
                             device_images: bool = False,
                             pub_batch_size: Optional[int] = None,
                             pub_eval_batch_size: Optional[int] = None
                             ) -> Dict:
    """Shape-faithful synthetic bundle (scaled down by default).

    The JAX function's ``cache``, ``prefetch``, ``client_image_size`` and
    ``mm_client_data_size`` knobs serve only its ``--paper_scale`` branch
    and come with that slice (``loaders.CachedDataset`` and
    ``loaders.PrefetchLoader`` are ported already).
    """
    if device_images:
        raise NotImplementedError(
            "device_images (on-device image synthesis, --paper_scale) is "
            "not ported yet (ROADMAP queue 1 item 3)")
    vocab = vocab or Vocabulary.synthetic(100)
    bs = batch_size or min(args.batch_size, pub_size)
    # Public loaders have their own batch sizes in the reference
    # (coco.yaml dataloader.batch_size=128 train, x2 eval subset;
    # load_datasets.py:59,82) independent of the clients' --batch_size.
    pub_bs = min(pub_batch_size or bs, pub_size)
    pub_ebs = min(pub_eval_batch_size or pub_bs, pub_size)

    pub = SyntheticCaptionDataset(
        n_captions=pub_size, image_size=image_size, max_len=max_len,
        vocab=vocab, seed=1, bert_tokenizer=bert_tokenizer)
    test = SyntheticCaptionDataset(
        n_captions=retrieval_test_size, image_size=image_size,
        max_len=max_len, vocab=vocab, seed=2, bert_tokenizer=bert_tokenizer)

    datasets: Dict = {
        "vocab": vocab,
        "synthetic": True,
        # Keep the trailing partial public batch like the reference.
        "pub_train": ArrayLoader(pub, batch_size=pub_bs, shuffle=True,
                                 drop_last=False, pad_last=False,
                                 seed=args.seed),
        "pub_eval": ArrayLoader(pub, batch_size=pub_ebs, shuffle=False,
                                pad_last=False),
        "test": ArrayLoader(test, batch_size=min(bs, retrieval_test_size),
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
            image_size=image_size, num_classes=100, seed=3)
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
                                         image_size=image_size,
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
        # pad_last + pair masking in local_step: reference DataLoaders
        # keep the trailing partial batch (drop_last=False).
        datasets["mm_clients"] = [
            ArrayLoader(SyntheticCaptionDataset(
                n_captions=client_data_size, image_size=image_size,
                max_len=max_len, vocab=vocab, seed=100 + i),
                batch_size=min(bs, client_data_size), shuffle=True,
                drop_last=False, pad_last=True, seed=args.seed)
            for i in range(args.num_mm_clients)]
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
