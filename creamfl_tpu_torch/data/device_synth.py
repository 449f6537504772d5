"""On-device synthesis of the paper-scale synthetic image sets.

Port of the JAX package's ``data/device_synth.py``. At the paper's scale
(a 50 000-row public set at 224², a 25 000-caption retrieval test) the
host cannot render every image of every pass with numpy, so the small
per-caption fields (ids, lengths, bookkeeping) stay on the host and the
224² images are synthesized on the device from ``(seed, image_id)``: the
distribution of ``SyntheticCaptionDataset._image`` (standard-normal noise
plus the image's concept pattern, ``synthetic.concept_pattern``).

An image depends on ``(seed, image_id)`` alone, bit for bit: not on its
batch, its place in the batch, the batch size or the epoch, so that the
global-feature rows extracted over one loader line up with the images a
client sees in another. The JAX package gets this from threefry keys
folded with each id; here a counter-based hash in torch integer ops keys
every uniform by (image, element), and Box-Muller turns pairs of uniforms
into normals. The transform runs in float64 and rounds to float32 once,
so that the CPU's vector and scalar code paths (which may round a float32
``log`` or ``cos`` differently at different offsets) give the same bits.
The streams are not the JAX package's: the two are held to the same
distribution, as the JAX package holds its own device and host paths.

Used by ``data.pipelines`` under ``--paper_scale`` (``device_images``);
plain torch ops, no kernel of the port's.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator

import numpy as np
import torch

from creamfl_tpu_torch.data.loaders import outermost
from creamfl_tpu_torch.data.synthetic import concept_pattern
from creamfl_tpu_torch.utils.device import resolve_device

_MASK = 0xFFFFFFFF
# Multiplier of the 32-bit finaliser: below 2^31, so that a 32-bit value
# times it stays inside int64.
_MUL = 0x45D9F3B
_GOLDEN = 0x9E3779B1


def _mix32(x):
    """A 32-bit integer finaliser on a Python int or an int64 tensor
    holding values in [0, 2^32): two xor-shift-multiply rounds and a last
    xor-shift."""
    x = ((x >> 16) ^ x) * _MUL & _MASK
    x = ((x >> 16) ^ x) * _MUL & _MASK
    return (x >> 16) ^ x


class DeviceImageSynth:
    """``(image_ids, concepts) -> [B, s, s, 3]`` fp32 NHWC images on
    ``device``: noise keyed by ``(seed, image_id)`` plus
    ``concept_pattern(s, concept, signal)``."""

    def __init__(self, image_size: int, seed: int = 0, n_concepts: int = 10,
                 signal: float = 0.8, device="cuda"):
        self.device = resolve_device(device)
        self.image_size = s = image_size
        self.patterns = torch.from_numpy(np.stack([
            concept_pattern(s, c, signal) for c in range(n_concepts)
        ])).to(self.device)  # [C, s, s, 3]
        self.n = s * s * 3
        # Two uniforms per Box-Muller pair, one pair per two elements.
        n_uniform = 2 * (-(-self.n // 2))
        self._counter = (torch.arange(n_uniform, dtype=torch.int64,
                                      device=self.device)
                         * _GOLDEN)[None, :]
        self._seed_keys = (_mix32((seed & _MASK) ^ 0x243F6A88),
                           _mix32((seed & _MASK) ^ 0x85A308D3))

    def noise(self, image_ids: torch.Tensor) -> torch.Tensor:
        """[B, s * s * 3] standard normals, row b a function of
        ``(seed, image_ids[b])`` alone."""
        lo, hi = image_ids & _MASK, (image_ids >> 32) & _MASK
        ka, kb = (_mix32(_mix32(lo ^ k) ^ hi)[:, None]
                  for k in self._seed_keys)
        bits = _mix32(_mix32((self._counter + ka) & _MASK) ^ kb)
        scale = 2.0 ** -32
        u1 = (bits[:, 0::2] + 1).double() * scale  # (0, 1]
        theta = bits[:, 1::2].double() * (2 * math.pi * scale)
        r = torch.sqrt(-2.0 * torch.log(u1))
        z = torch.stack((r * torch.cos(theta), r * torch.sin(theta)), -1)
        return z.reshape(len(image_ids), -1)[:, :self.n].float()

    def __call__(self, image_ids, concepts) -> torch.Tensor:
        host = torch.from_numpy(np.stack([np.asarray(image_ids, np.int64),
                                          np.asarray(concepts, np.int64)]))
        if self.device.type == "cuda":
            # Pinned and asynchronous: a pageable copy would wait for the
            # device to finish the work queued before it.
            host = host.pin_memory()
        ids, cls = host.to(self.device, non_blocking=True)
        s = self.image_size
        return self.noise(ids).view(-1, s, s, 3) + self.patterns[cls]


class DeviceImageBatches:
    """Wrap a caption-only batch loader; attach device images.

    ``concept_fn(image_id) -> int`` is the dataset's concept hash
    (``SyntheticCaptionDataset._concept``, exact Python-int arithmetic on
    the host). Synthesis runs on the consumer's thread, after any
    ``PrefetchLoader`` under ``base``: no device work is launched from a
    prefetch thread."""

    def __init__(self, base_loader, synth: DeviceImageSynth,
                 concept_fn: Callable[[int], int]):
        self.base = base_loader
        self.synth = synth
        self.concept_fn = concept_fn

    def set_round(self, round_n: int) -> None:
        self.base.set_round(round_n)

    def skip_epoch(self) -> None:
        self.base.skip_epoch()

    def __len__(self) -> int:
        return len(self.base)

    def __iter__(self) -> Iterator[dict]:
        return outermost(self._batches())

    def _batches(self) -> Iterator[dict]:
        for batch in self.base:
            iids = np.asarray(batch["image_ids"])
            concepts = np.asarray([self.concept_fn(int(i)) for i in iids],
                                  np.int64)
            out = dict(batch)
            out["images"] = self.synth(iids, concepts)
            yield out
