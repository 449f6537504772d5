"""Cross-modal retrieval evaluator (reference `src/algorithms/eval_coco.py`).

Port of the JAX package's ``engine/evaluator.py`` (``RetrievalEvaluator``).
Metric contract: R@1/5/10, medr and meanr for i2t and t2i,
on n-fold crossfolds plus the full gallery; rsum = R@1 + R@5 + R@10 per
direction.

Ranks need no sort: the best positive's rank is ``#{j : s_j > s_p*}`` plus
the ties before it by gallery index, where ``p*`` is the highest-similarity
positive (ties to the lower index) -- a stable descending sort's position,
computed as a masked reduction over query blocks on the features' device.
Feature extraction keeps the reference's semantics: images deduped by
image_id in first-seen order, captions grouped by their image's position
(eval_coco.py:119-223), in chunks of batches where the caller gives a
chunk step. ``retrieve`` lists the top-k gallery items per query;
``evaluate_two_tower`` scores separate image and caption models.

On a mesh of ranks (``mesh``) the ranking shards its query rows over the
ranks, the gallery whole on every rank, and gathers the ranks in order
(``best_positive_ranks_sharded``); the caller's extraction gives every rank
the whole batch's features, so dedup and grouping see one order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from creamfl_tpu_torch.losses.mcsoft import match_prob
from creamfl_tpu_torch.parallel import mesh as M

# Batches per ``extract_chunk_fn`` call (the JAX package's chunk of 8).
EXTRACT_CHUNK = 8


@torch.no_grad()
def best_positive_ranks(q_features: torch.Tensor, g_features: torch.Tensor,
                        q_labels: torch.Tensor, g_labels: torch.Tensor,
                        block_size: int = 1024,
                        sims_fn: Optional[Callable] = None) -> torch.Tensor:
    """For each query, the 0-based rank of its best-ranked positive: a
    stable argsort of the gallery by descending similarity, the least
    position over items with ``g_label == q_label``. ``sims_fn(q_blk,
    gallery) -> [b, N]`` replaces the dot product (matching_prob)."""
    n_g = g_features.shape[0]
    g_idx = torch.arange(n_g, device=g_features.device)
    g32 = g_features.float()
    ranks = []
    for start in range(0, q_features.shape[0], block_size):
        q_blk = q_features[start:start + block_size]
        ql_blk = q_labels[start:start + block_size]
        if sims_fn is not None:
            sims = sims_fn(q_blk, g_features).float()
        else:
            sims = q_blk.float() @ g32.T  # [b, N]
        pos = ql_blk[:, None] == g_labels[None, :]
        pos_sims = torch.where(pos, sims, torch.full_like(sims, -np.inf))
        best = pos_sims.max(dim=1).values
        best_idx = torch.where(pos_sims == best[:, None], g_idx[None, :],
                               n_g).min(dim=1).values
        higher = (sims > best[:, None]).sum(dim=1)
        tied_before = ((sims == best[:, None])
                       & (g_idx[None, :] < best_idx[:, None])).sum(dim=1)
        ranks.append(higher + tied_before)
    return torch.cat(ranks)


@torch.no_grad()
def best_positive_ranks_sharded(q_features: torch.Tensor,
                                g_features: torch.Tensor,
                                q_labels: torch.Tensor,
                                g_labels: torch.Tensor, mesh,
                                block_size: int = 1024,
                                sims_fn: Optional[Callable] = None
                                ) -> torch.Tensor:
    """``best_positive_ranks`` with the query rows split over the mesh's
    ranks in contiguous blocks of ceil(n / world) (the last ones shorter or
    empty), the gallery whole on every rank, and the ranks gathered in rank
    order onto every rank. A query's rank depends on its own row alone, so
    the split changes no result; the JAX function's padding to world x
    block_size would change none either and is left out."""
    if not M.active(mesh):
        return best_positive_ranks(q_features, g_features, q_labels,
                                   g_labels, block_size, sims_fn)
    n = q_features.shape[0]
    per = -(-n // mesh.world)
    lo, hi = min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)
    ranks = (best_positive_ranks(q_features[lo:hi], g_features,
                                 q_labels[lo:hi], g_labels, block_size,
                                 sims_fn) if hi > lo
             else torch.zeros(0, dtype=torch.long,
                              device=q_features.device))
    return M.gather_ragged(mesh, ranks)


def _recall_scores(ranks: np.ndarray) -> Dict[str, float]:
    if len(ranks) == 0:
        raise ValueError("empty eval set: no valid query features "
                         "reached evaluate_recall")

    def recall_at(k):
        return 100.0 * float(np.sum(ranks < k)) / len(ranks)

    r1, r5, r10 = recall_at(1), recall_at(5), recall_at(10)
    return {
        "recall_1": r1,
        "recall_5": r5,
        "recall_10": r10,
        "rsum": r1 + r5 + r10,
        "medr": float(np.floor(np.median(ranks)) + 1),
        "meanr": float(np.mean(ranks) + 1),
    }


class RetrievalEvaluator:
    """Evaluator over an ``extract_fn(batch) -> (img_feats, cap_feats)``."""

    def __init__(self, n_crossfolds: int = 5,
                 n_images_per_crossfold: int = 1000,
                 n_captions_per_crossfold: int = 5000,
                 eval_batch_size: int = 1024,
                 eval_method: str = "matmul",
                 criterion_params: Optional[Dict[str, torch.Tensor]] = None,
                 iid_to_cls=None,
                 mesh=None,
                 logger=None):
        self.n_crossfolds = n_crossfolds
        # The ranks the ranking's query rows split over (None: one).
        self.mesh = mesh
        self.n_images_per_crossfold = n_images_per_crossfold
        self.n_captions_per_crossfold = n_captions_per_crossfold
        self.eval_batch_size = eval_batch_size
        self.logger = logger
        self.eval_method = eval_method
        # Optional image_id -> class remap (reference mm_eval.py:127-133):
        # galleries group by class instead of image identity; caption
        # regrouping and crossfolds are skipped because classes repeat.
        self.iid_to_cls = dict(iid_to_cls) if iid_to_cls else None
        self._sims_fn = None
        if eval_method == "matching_prob":
            if criterion_params is None:
                raise ValueError("matching_prob needs criterion_params")
            self.set_criterion_params(criterion_params)
        elif eval_method != "matmul":
            raise ValueError(f"unknown eval_method {eval_method!r}")

    def set_criterion_params(self, criterion_params: Dict[str, torch.Tensor]
                             ) -> None:
        """The matching_prob scorer (reference eval_coco.py:54-72) with the
        criterion's ``shift`` and ``negative_scale``."""
        params = {k: torch.as_tensor(v).detach()
                  for k, v in criterion_params.items()}

        def sims(q_blk, gallery):
            return match_prob({k: v.to(q_blk.device)
                               for k, v in params.items()}, q_blk, gallery)

        self._sims_fn = sims

    # -- feature extraction (dedup and alignment on the host) ----------
    def extract_features(self, loader, extract_fn: Callable,
                         extract_chunk_fn: Optional[Callable] = None
                         ) -> Dict:
        """Dedup images by image_id (first-seen order) and group captions
        by their image's position, vectorised (the reference keeps the
        same semantics with Python dicts, eval_coco.py:119-223). Features
        stay on their device; ids and labels are numpy.

        ``extract_chunk_fn(batches) -> (fi, fc)`` (flat [k * B, E]) takes
        runs of ``EXTRACT_CHUNK`` uniform batches at once (the server's
        ``eval_chunk``: one CUDA graph replay on the card); single and
        ragged batches take ``extract_fn``."""
        from creamfl_tpu_torch.federation.stacked import (_chunks,
                                                          _uniform_batches)

        fi_parts, fc_parts, id_parts, ann_parts, valids = ([], [], [], [],
                                                           [])

        def accumulate(fi, fc, batches):
            fi_parts.append(fi)
            fc_parts.append(fc)
            for batch in batches:
                n = len(np.asarray(batch["image_ids"]))
                valid = np.asarray(batch.get("valid", np.ones(n, bool))
                                   ).astype(bool)
                valids.append(valid)
                id_parts.append(np.asarray(batch["image_ids"])[valid])
                ann_parts.append(np.asarray(batch["ann_ids"])[valid])

        groups = (([b] for b in loader) if extract_chunk_fn is None
                  else _chunks(iter(loader), EXTRACT_CHUNK))
        for group in groups:
            if len(group) == 1 or not _uniform_batches(group):
                for batch in group:
                    accumulate(*extract_fn(batch), [batch])
            else:
                accumulate(*extract_chunk_fn(group), group)
        rows = torch.from_numpy(np.flatnonzero(np.concatenate(valids)))
        all_img = torch.cat(fi_parts)
        all_img = all_img[rows.to(all_img.device)]
        cap_feats = torch.cat(fc_parts)
        cap_feats = cap_feats[rows.to(cap_feats.device)]
        cap_img_ids = np.concatenate(id_parts).astype(np.int64)
        cap_ann_ids = np.concatenate(ann_parts).astype(np.int64)

        def take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
            return x[torch.from_numpy(np.asarray(idx, np.int64)).to(
                x.device)]

        if self.iid_to_cls is not None:
            # Class mode: dedup still by image_id, labels become classes,
            # no caption alignment (reference mm_eval.py:166-179).
            _, first_idx = np.unique(cap_img_ids, return_index=True)
            img_rows = first_idx[np.argsort(first_idx, kind="stable")]
            classes = np.asarray(
                [self.iid_to_cls.get(int(i), int(i)) for i in cap_img_ids],
                np.int64)
            return {
                "image_features": take(all_img, img_rows),
                "caption_features": cap_feats,
                "image_classes": classes[img_rows],
                "caption_classes": classes,
                "caption_ids": cap_ann_ids,
            }

        # First-seen image dedup: np.unique gives the first occurrence of
        # each sorted-unique id; sorting those restores first-seen order.
        _, first_idx, inverse = np.unique(cap_img_ids, return_index=True,
                                          return_inverse=True)
        seen_order = np.argsort(first_idx, kind="stable")
        img_rows = first_idx[seen_order]
        # Position of each caption's image in first-seen order.
        rank = np.empty_like(seen_order)
        rank[seen_order] = np.arange(len(seen_order))
        cap_pos = rank[inverse.reshape(-1)]
        # Captions grouped by image position, original order within groups
        # (reference eval_coco.py:196-208).
        order = np.argsort(cap_pos, kind="stable")
        return {
            "image_features": take(all_img, img_rows),
            "caption_features": take(cap_feats, order),
            "image_classes": cap_img_ids[img_rows],
            "caption_classes": cap_img_ids[order],
            "caption_ids": cap_ann_ids[order],
        }

    # -- scoring -------------------------------------------------------
    def evaluate_recall(self, q_features, g_features, q_labels,
                        g_labels) -> Dict[str, float]:
        q_features = torch.as_tensor(q_features)
        g_features = torch.as_tensor(g_features)
        dev = q_features.device
        block = min(self.eval_batch_size, max(1, len(q_features)))
        ranks = best_positive_ranks_sharded(
            q_features, g_features.to(dev),
            torch.as_tensor(np.asarray(q_labels), device=dev),
            torch.as_tensor(np.asarray(g_labels), device=dev), self.mesh,
            block_size=block, sims_fn=self._sims_fn)
        return _recall_scores(ranks.cpu().numpy())

    def evaluate_n_fold(self, feats: Dict) -> Dict:
        per_task = {"i2t": [], "t2i": []}
        ni, nc = self.n_images_per_crossfold, self.n_captions_per_crossfold
        for fold in range(self.n_crossfolds):
            i0, c0 = fold * ni, fold * nc
            img_f = feats["image_features"][i0:i0 + ni]
            img_c = feats["image_classes"][i0:i0 + ni]
            cap_f = feats["caption_features"][c0:c0 + nc]
            cap_c = feats["caption_classes"][c0:c0 + nc]
            per_task["i2t"].append(
                self.evaluate_recall(img_f, cap_f, img_c, cap_c))
            per_task["t2i"].append(
                self.evaluate_recall(cap_f, img_f, cap_c, img_c))
        return {task: {k: float(np.mean([f[k] for f in folds]))
                       for k in folds[0]}
                for task, folds in per_task.items()}

    def retrieve(self, q_features, g_features, q_ids, g_ids,
                 topk: int = 10):
        """Top-k retrieval lists per query (reference eval_coco.py:226-271):
        ({q_id: [g_id, ...]}, {q_id: [score, ...]}), the gallery in a
        stable descending order of similarity (dot product, or the
        matching_prob scorer)."""
        q = torch.as_tensor(q_features).float()
        g = torch.as_tensor(g_features).float().to(q.device)
        sims = (self._sims_fn(q, g) if self._sims_fn is not None
                else q @ g.T).cpu().numpy()
        order = np.argsort(-sims, axis=1, kind="stable")[:, :topk]
        g_ids = np.asarray(g_ids)
        q_ids = np.asarray(q_ids)
        items = {qid: g_ids[order[i]].tolist() for i, qid in enumerate(q_ids)}
        scores = {qid: sims[i, order[i]].tolist()
                  for i, qid in enumerate(q_ids)}
        return items, scores

    def evaluate_two_tower(self, loader, image_fn: Callable,
                           caption_fn: Callable,
                           n_crossfolds: Optional[int] = None) -> Dict:
        """Two-tower evaluation (reference ``mm_eval.COCOEvaluator``):
        separate image and caption models, ``image_fn(batch) -> [B, d]``
        and ``caption_fn(batch) -> [B, d]``; dedup, alignment or class
        grouping, crossfolds and recalls as in ``evaluate``."""

        def extract_fn(batch):
            return image_fn(batch), caption_fn(batch)

        return self.evaluate(loader, extract_fn, n_crossfolds)

    def evaluate(self, loader, extract_fn: Callable,
                 n_crossfolds: Optional[int] = None,
                 extract_chunk_fn: Optional[Callable] = None) -> Dict:
        feats = self.extract_features(loader, extract_fn,
                                      extract_chunk_fn=extract_chunk_fn)
        scores: Dict = {}
        n_crossfolds = (self.n_crossfolds if n_crossfolds is None
                        else n_crossfolds)
        n_img = len(feats["image_features"])
        # Class mode never runs crossfolds (mm_eval.py:372-373).
        if (self.iid_to_cls is None and n_crossfolds > 0 and
                n_img >= n_crossfolds * self.n_images_per_crossfold):
            scores["n_fold"] = self.evaluate_n_fold(feats)
        scores["i2t"] = self.evaluate_recall(
            feats["image_features"], feats["caption_features"],
            feats["image_classes"], feats["caption_classes"])
        scores["t2i"] = self.evaluate_recall(
            feats["caption_features"], feats["image_features"],
            feats["caption_classes"], feats["image_classes"])
        for key in ("rsum", "medr", "meanr"):
            scores[key] = scores["i2t"][key] + scores["t2i"][key]
        return scores
