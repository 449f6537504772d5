"""The port's RetrievalEvaluator vs the JAX package's, on the same features.

Features are multiples of 1/4 in [-1, 1] (8 dims), so every dot product and
squared distance is exact in fp32 in both frameworks, and ties are exact:
two images share a feature vector and so do two captions. The test loader
visits captions out of image order and pads its last batch (``valid``).
Ranks, R@k, medr and meanr must be equal -- tolerance none -- in both
``eval_method``s (matching_prob with shift 0.5 and negative_scale 1, where
the sigmoid's arguments stay far apart), with the n-fold split, in the
class mode (``iid_to_cls``), and for ``best_positive_ranks`` alone at
several block sizes. ``retrieve``'s top-k lists and scores and
``evaluate_two_tower``'s scores equal the JAX package's (tolerance none;
matching_prob's retrieval scores within float32 rounding, rtol 1e-6);
``extract_features`` through a chunk function (``extract_chunk_fn``, runs
of 8 uniform batches, single and ragged batches per batch) equals the
unchunked extraction and the JAX package's chunked one bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creamfl_tpu.engine import evaluator as J
from creamfl_tpu_torch.engine import evaluator as T
from torch_cpu_share import torch_cpu_share  # noqa: F401

N_IMG, CPI, D, BATCH = 12, 5, 8, 16


def _quantized(rng, *shape):
    return (rng.integers(-4, 5, size=shape) / 4.0).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(12)
    img = _quantized(rng, N_IMG, D)
    img[7] = img[2]  # tied images
    n_cap = N_IMG * CPI
    cap = _quantized(rng, n_cap, D)
    cap[11] = cap[40]  # tied captions
    order = rng.permutation(n_cap)  # captions out of image order
    image_ids = (order // CPI).astype(np.int64) + 100
    ann_ids = order.astype(np.int64) + 1000
    batches = []
    for s in range(0, n_cap, BATCH):
        rows = np.arange(s, min(s + BATCH, n_cap))
        n = len(rows)
        rows = np.concatenate([rows, rows[:BATCH - n]])  # repeat-pad
        batches.append({"image_ids": image_ids[rows],
                        "ann_ids": ann_ids[rows], "rows": rows,
                        "valid": np.arange(BATCH) < n})
    return img, cap, order, batches


def _extract(data, to):
    img, cap, order, _ = data

    def fn(batch):
        rows = batch["rows"]
        return to(img[order[rows] // CPI]), to(cap[order[rows]])

    return fn


CRIT = {"shift": np.array([0.5], np.float32),
        "negative_scale": np.array([1.0], np.float32)}


def _evaluators(method, iid_to_cls=None):
    kw = dict(n_crossfolds=2, n_images_per_crossfold=6,
              n_captions_per_crossfold=30, eval_batch_size=7,
              eval_method=method, iid_to_cls=iid_to_cls)
    jcrit = {k: jnp.asarray(v) for k, v in CRIT.items()}
    tcrit = {k: torch.tensor(v) for k, v in CRIT.items()}
    return (J.RetrievalEvaluator(criterion_params=jcrit, **kw),
            T.RetrievalEvaluator(criterion_params=tcrit, **kw))


@pytest.mark.parametrize("method", ["matmul", "matching_prob"])
def test_scores_equal(data, method):
    jev, tev = _evaluators(method)
    want = jev.evaluate(data[3], _extract(data, jnp.asarray))
    got = tev.evaluate(data[3], _extract(data, torch.tensor))
    assert "n_fold" in got
    assert got == want
    # Not a degenerate eval: some queries miss at rank 1, some hit.
    assert 0.0 < got["i2t"]["recall_1"] < 100.0


@pytest.mark.parametrize("method", ["matmul", "matching_prob"])
def test_class_mode_scores_equal(data, method):
    iid_to_cls = {100 + i: i % 4 for i in range(N_IMG)}
    jev, tev = _evaluators(method, iid_to_cls)
    want = jev.evaluate(data[3], _extract(data, jnp.asarray))
    got = tev.evaluate(data[3], _extract(data, torch.tensor))
    assert "n_fold" not in got
    assert got == want


def test_extracted_features_and_alignment_equal(data):
    jev, tev = _evaluators("matmul")
    want = jev.extract_features(data[3], _extract(data, jnp.asarray))
    got = tev.extract_features(data[3], _extract(data, torch.tensor))
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(val),
                                      err_msg=key)
    assert len(got["image_features"]) == N_IMG
    assert len(got["caption_features"]) == N_IMG * CPI


@pytest.mark.parametrize("block", [1, 7, 64])
def test_best_positive_ranks_equal_with_ties(data, block):
    img, cap, order, _ = data
    q_labels = (order // CPI).astype(np.int64)
    g_labels = np.arange(N_IMG, dtype=np.int64)
    want = np.asarray(J.best_positive_ranks(
        jnp.asarray(cap[order]), jnp.asarray(img), jnp.asarray(q_labels),
        jnp.asarray(g_labels), block_size=block))
    got = T.best_positive_ranks(
        torch.tensor(cap[order]), torch.tensor(img), torch.tensor(q_labels),
        torch.tensor(g_labels), block_size=block).numpy()
    np.testing.assert_array_equal(got, want)
    # Against a stable descending sort of the full similarity rows.
    sims = cap[order] @ img.T
    ref = [int(np.flatnonzero(q_labels[i] == g_labels[np.argsort(
        -sims[i], kind="stable")]).min()) for i in range(len(sims))]
    np.testing.assert_array_equal(got, ref)


def test_unknown_eval_method_raises():
    with pytest.raises(ValueError):
        T.RetrievalEvaluator(eval_method="cosine")
    with pytest.raises(ValueError):
        T.RetrievalEvaluator(eval_method="matching_prob")


@pytest.mark.parametrize("method", ["matmul", "matching_prob"])
def test_retrieve_equals_jax(data, method):
    img, cap, _, _ = data
    jev, tev = _evaluators(method)
    for q, g in ((img, cap), (cap, img[::-1].copy())):
        q_ids, g_ids = np.arange(len(q)) + 7, np.arange(len(g)) + 1000
        want = jev.retrieve(q, g, q_ids, g_ids, topk=5)
        got = tev.retrieve(torch.tensor(q), torch.tensor(g), q_ids, g_ids,
                           topk=5)
        assert got[0] == want[0]
        assert got[1].keys() == want[1].keys()
        for qid, scores in want[1].items():
            # Dot products are exact here; the sigmoid of matching_prob
            # rounds in each framework's own way (float32 ulps).
            np.testing.assert_allclose(got[1][qid], scores, atol=0,
                                       rtol=0 if method == "matmul" else 1e-6)


def test_two_tower_equals_jax(data):
    jev, tev = _evaluators("matmul")
    jfn, tfn = _extract(data, jnp.asarray), _extract(data, torch.tensor)
    want = jev.evaluate_two_tower(data[3], lambda b: jfn(b)[0],
                                  lambda b: jfn(b)[1])
    got = tev.evaluate_two_tower(data[3], lambda b: tfn(b)[0],
                                 lambda b: tfn(b)[1])
    assert got == want == tev.evaluate(data[3], tfn)


def test_chunked_extraction_equals_unchunked(data):
    img, cap, order, _ = data
    n_cap = len(order)
    batches = [{"image_ids": (order[s:s + 7] // CPI).astype(np.int64) + 100,
                "ann_ids": order[s:s + 7].astype(np.int64) + 1000,
                "rows": np.arange(s, min(s + 7, n_cap))}
               for s in range(0, n_cap, 7)]  # 8 of 7, then a ragged 4
    calls = []

    def chunk_fn(to, fn):
        def run(group):
            calls.append(len(group))
            parts = [fn(b) for b in group]
            cat = jnp.concatenate if to is jnp.asarray else torch.cat
            return cat([a for a, _ in parts]), cat([c for _, c in parts])
        return run

    jev, tev = _evaluators("matmul")
    jfn, tfn = _extract(data, jnp.asarray), _extract(data, torch.tensor)
    want = jev.extract_features(batches, jfn,
                                extract_chunk_fn=chunk_fn(jnp.asarray, jfn))
    plain = tev.extract_features(batches, tfn)
    calls.clear()
    got = tev.extract_features(batches, tfn,
                               extract_chunk_fn=chunk_fn(torch.tensor, tfn))
    assert calls == [8]  # the ragged last batch went per batch
    assert sorted(got) == sorted(want) == sorted(plain)
    for key, val in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(val),
                                      err_msg=key)
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(plain[key]), err_msg=key)
