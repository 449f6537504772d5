"""The operation counts that ``mfu`` reads, against hand sums."""

import os

import pytest

from benchlib import registry

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server():
    return (registry.load_module("configs", "pcme_r101_bertbase_flops"),
            registry.load_json("configs", "pcme_r101_bertbase")["model"])


def test_resnet18_by_hand(server):
    flops, model = server
    r18 = dict(model["image"], block="basic", stage_sizes=[2, 2, 2, 2])
    stem = 112 * 112 * 64 * 3 * 49
    layer1 = 4 * 56 * 56 * 64 * 64 * 9
    # Stages 2-4: a strided 3x3, three unstrided 3x3s and a 1x1
    # projection, each stage at half the size and twice the width.
    stage = (28 * 28 * 128 * 64 * 9 + 3 * 28 * 28 * 128 * 128 * 9
             + 28 * 28 * 128 * 64)
    assert flops.resnet_forward(r18) == 2 * (stem + layer1 + 3 * stage)
    assert 2 * (stem + layer1 + 3 * stage) == 2 * 1_813_561_344


def test_resnet101_and_bert_base(server):
    flops, model = server
    # 7.8 G multiply-adds is ResNet-101's published count at 224².
    assert flops.resnet_forward(model["image"]) == pytest.approx(
        2 * 7.8e9, rel=0.01)
    t = model["text"]
    l, d, f = 32, 768, 3072
    layer = 4 * 2 * l * d * d + 2 * 2 * l * d * f + 2 * 2 * l * l * d
    assert flops.bert_forward(t, 256) == 12 * layer + 2 * d * 256
    heads = (2 * 2048 * 256 + 2 * 49 * (2048 * 1024 + 1024)
             + 2 * 49 * 2048 + 2 * 2048 * 256)
    assert flops.image_heads_forward(model["image"], 256) == heads
    per = flops.per_sample(model)
    assert per["forward"] == (flops.resnet_forward(model["image"])
                              + heads + 12 * layer + 2 * d * 256)
    assert per["train"] == 3 * per["forward"]
