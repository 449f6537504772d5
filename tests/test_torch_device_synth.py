"""On-device image synthesis (``data/device_synth.py``) against its
definition and against the JAX package's ``DeviceImageSynth``.

Run on the CPU here (the same torch ops run on the card in
``chip_smoke.py``'s paper phase). Checks:

* determinism: an image depends on ``(seed, image_id)`` alone, bit for
  bit, across batch orders, batch sizes and calls (the counterpart of
  ``tests/test_data.py::test_device_synth_deterministic_per_image_id``);
  other ids, or another seed, give other images;
* distribution: over 1024 images the residual (image minus its concept
  pattern) has |mean| < 1e-2 and a standard deviation within 1 +- 1e-2
  (standard-normal noise: the standard error of the mean over 786 432
  values is 1.1e-3, of the deviation 8e-4); the mean image of each concept
  over 256 images has cosine >= 0.98 with ``concept_pattern`` (noise in
  the mean: 1/16 per value against a pattern of rms ~0.46, expected cosine
  ~0.99);
* against JAX: the same patterns bit for bit, and JAX's images for the
  same ids meet the same bounds, concept by concept (the streams differ:
  the JAX package holds its device path to its host path by distribution
  too, ``creamfl_tpu/data/synthetic.py:23-29``);
* ``ProjectedLoader`` never calls the synth for a text view and does for
  an image view (the counterpart of
  ``tests/test_data.py::test_projected_loader_skips_images_and_filters_fields``).
"""

import numpy as np
import pytest
import torch

from creamfl_tpu.data.device_synth import DeviceImageSynth as JSynth
from creamfl_tpu.data.synthetic import concept_pattern as j_concept_pattern
from creamfl_tpu_torch.data.device_synth import (DeviceImageBatches,
                                                 DeviceImageSynth)
from creamfl_tpu_torch.data.loaders import ArrayLoader, ProjectedLoader
from creamfl_tpu_torch.data.synthetic import (SyntheticCaptionDataset,
                                              concept_pattern)
from torch_cpu_share import torch_cpu_share  # noqa: F401

SIZE, N_CONCEPTS, PER_CONCEPT = 16, 4, 256
MEAN_BOUND, STD_BOUND, COSINE = 1e-2, 1e-2, 0.98


def _synth(seed=3, size=SIZE, n_concepts=N_CONCEPTS):
    return DeviceImageSynth(size, seed=seed, n_concepts=n_concepts,
                            device="cpu")


def test_same_id_same_image_bit_for_bit():
    synth = _synth()
    ids = np.arange(500, 600)
    concepts = ids % N_CONCEPTS
    whole = synth(ids, concepts)
    assert whole.shape == (100, SIZE, SIZE, 3)
    assert whole.dtype == torch.float32 and whole.device.type == "cpu"
    # Reversed order, another call.
    rev = synth(ids[::-1].copy(), concepts[::-1].copy())
    assert torch.equal(rev.flip(0), whole)
    # Batch sizes 1, 7 and 33, each row in another place of its batch.
    for bs in (1, 7, 33):
        parts = torch.cat([synth(ids[i:i + bs], concepts[i:i + bs])
                           for i in range(0, len(ids), bs)])
        assert torch.equal(parts, whole), bs
    # Ids repeated within a batch (a padded last batch) repeat the row.
    rep = synth(np.array([503, 503, 577]), np.array([3, 3, 1]))
    assert torch.equal(rep[0], whole[3]) and torch.equal(rep[1], whole[3])
    assert torch.equal(rep[2], whole[77])
    # A fresh synth with the same seed: same images; another seed: not.
    assert torch.equal(_synth()(ids[:5], concepts[:5]), whole[:5])
    other = _synth(seed=4)(ids[:5], concepts[:5])
    assert not torch.equal(other, whole[:5])
    # Distinct ids, distinct noise.
    noise = synth.noise(torch.as_tensor(ids))
    assert len(torch.unique(noise[:, :8], dim=0)) == len(ids)


def test_large_ids_and_the_jax_contract():
    """Ids past 2^32 key their own images; the call takes numpy or torch
    ids and the concept of each row."""
    synth = _synth()
    ids = np.array([7, 7 + 2 ** 32, 2 ** 40 + 5], np.int64)
    out = synth(ids, np.zeros(3, np.int64))
    assert not torch.equal(out[0], out[1])
    assert not torch.equal(out[1], out[2])
    again = synth(torch.as_tensor(ids), torch.zeros(3, dtype=torch.long))
    assert torch.equal(again, out)


def _concept_stats(images: np.ndarray, concepts: np.ndarray, patterns):
    """(residual mean, residual std, per-concept cosine of the mean image
    with its pattern)."""
    residual = images - patterns[concepts]
    cos = []
    for c in range(len(patterns)):
        mean = images[concepts == c].mean(0).ravel().astype(np.float64)
        pat = patterns[c].ravel().astype(np.float64)
        cos.append(mean @ pat / (np.linalg.norm(mean) * np.linalg.norm(pat)))
    return float(residual.mean()), float(residual.std()), cos


def _ids():
    ids = np.arange(1000, 1000 + N_CONCEPTS * PER_CONCEPT)
    return ids, ids % N_CONCEPTS


def test_distribution_matches_concept_pattern():
    ids, concepts = _ids()
    synth = _synth()
    patterns = np.stack([concept_pattern(SIZE, c, 0.8)
                         for c in range(N_CONCEPTS)])
    np.testing.assert_array_equal(synth.patterns.numpy(), patterns)
    mean, std, cos = _concept_stats(synth(ids, concepts).numpy(), concepts,
                                    patterns)
    assert abs(mean) < MEAN_BOUND, mean
    assert abs(std - 1.0) < STD_BOUND, std
    assert min(cos) >= COSINE, cos


def test_distribution_matches_jax_device_synth():
    ids, concepts = _ids()
    patterns = np.stack([np.asarray(j_concept_pattern(SIZE, c, 0.8))
                         for c in range(N_CONCEPTS)])
    np.testing.assert_array_equal(_synth().patterns.numpy(), patterns)
    jimages = np.asarray(JSynth(SIZE, seed=3, n_concepts=N_CONCEPTS)(
        ids, concepts))
    timages = _synth()(ids, concepts).numpy()
    assert jimages.shape == timages.shape and jimages.dtype == np.float32
    for images in (jimages, timages):
        mean, std, cos = _concept_stats(images, concepts, patterns)
        assert abs(mean) < MEAN_BOUND and abs(std - 1.0) < STD_BOUND
        assert min(cos) >= COSINE, cos
    # The two packages' per-concept mean images lie as close to each other
    # as two independent noise draws allow: rms of the difference about
    # sqrt(2 / 256) = 0.088 per value.
    for c in range(N_CONCEPTS):
        diff = (jimages[concepts == c].mean(0)
                - timages[concepts == c].mean(0))
        rms = float(np.sqrt((diff ** 2).mean()))
        assert rms < 1.2 * np.sqrt(2 / PER_CONCEPT), (c, rms)


@pytest.mark.parametrize("view, synthesizes", [
    (("captions", "lengths", "index"), False),
    (("images", "index", "valid"), True),
])
def test_projected_loader_synthesizes_only_image_views(view, synthesizes):
    ds = SyntheticCaptionDataset(n_captions=12, image_size=SIZE, max_len=8,
                                 with_images=False)
    base = ArrayLoader(ds, batch_size=4, shuffle=False, pad_last=True)
    synth = DeviceImageSynth(SIZE, seed=ds.seed, n_concepts=ds.n_concepts,
                             signal=ds.signal, device="cpu")
    loader = DeviceImageBatches(base, synth, ds._concept)
    calls = []

    class Counting:
        def __call__(self, iids, concepts):
            calls.append(len(iids))
            return synth(iids, concepts)

    loader.synth = Counting()
    batches = list(ProjectedLoader(loader, view))
    assert len(batches) == len(loader) == 3
    assert all(set(b) == set(view) for b in batches)
    assert calls == ([4, 4, 4] if synthesizes else [])
    if synthesizes:
        b = batches[0]
        assert isinstance(b["images"], torch.Tensor)
        assert b["images"].shape == (4, SIZE, SIZE, 3)
        # Each row is its image id's, with the dataset's concept.
        iids = next(iter(base))["image_ids"]
        want = synth(iids, [ds._concept(int(i)) for i in iids])
        assert torch.equal(b["images"], want)
