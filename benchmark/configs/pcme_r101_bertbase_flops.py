"""Model operations of one sample of the server's PCME (ResNet trunk +
BERT + the PIE and projection heads), counted from the configuration's
widths: a multiply-add is 2 operations; a backward is twice its forward.
Element-wise work (BatchNorm, activations, softmax, the loss) is left out,
as a model-FLOPs count leaves it out; recomputation is never counted."""

from __future__ import annotations

from typing import Dict


def _conv(h: int, w: int, cin: int, cout: int, k: int, stride: int):
    ho, wo = -(-h // stride), -(-w // stride)
    return 2 * ho * wo * cin * cout * k * k, ho, wo


def resnet_forward(image: Dict) -> float:
    """The trunk at ``image_size``: stem, every block's convolutions and
    projections."""
    s = image["image_size"]
    total, h, w = _conv(s, s, 3, 64, 7, 2)
    h, w = -(-h // 2), -(-w // 2)  # max pool
    cin = 64
    bottleneck = image["block"] == "bottleneck"
    for stage, n in enumerate(image["stage_sizes"]):
        f = 64 * 2 ** stage
        cout = f * 4 if bottleneck else f
        for b in range(n):
            stride = 2 if stage > 0 and b == 0 else 1
            if bottleneck:
                a, _, _ = _conv(h, w, cin, f, 1, 1)
                c2, ho, wo = _conv(h, w, f, f, 3, stride)
                c3, _, _ = _conv(ho, wo, f, cout, 1, 1)
                total += a + c2 + c3
            else:
                c1, ho, wo = _conv(h, w, cin, f, 3, stride)
                c2, _, _ = _conv(ho, wo, f, f, 3, 1)
                total += c1 + c2
            if stride != 1 or cin != cout:
                total += _conv(h, w, cin, cout, 1, stride)[0]
            h, w, cin = ho, wo, cout
    return float(total)


def trunk_grid(image: Dict):
    """(tokens, channels) of the trunk's output grid."""
    s = -(-image["image_size"] // 32)
    c = 64 * 2 ** (len(image["stage_sizes"]) - 1)
    return s * s, c * (4 if image["block"] == "bottleneck" else 1)


def image_heads_forward(image: Dict, embed: int) -> float:
    """fc after the pool, PIE's attention over the grid tokens and its fc."""
    tokens, c = trunk_grid(image)
    hidden = image["pie_hidden"]
    return float(2 * c * embed + 2 * tokens * (c * hidden + hidden)
                 + 2 * tokens * c + 2 * c * embed)


def bert_forward(text: Dict, embed: int) -> float:
    """Every layer's projections, its attention products and its FFN at
    ``max_len`` tokens, then the CLS projection."""
    length, d, ffn = text["max_len"], text["hidden_size"], \
        text["intermediate_size"]
    per_layer = (2 * length * d * d * 4 + 2 * length * d * ffn * 2
                 + 2 * 2 * length * length * d)
    return float(text["num_layers"] * per_layer + 2 * d * embed)


def forward(model: Dict) -> float:
    e = model["embed_dim"]
    return (resnet_forward(model["image"])
            + image_heads_forward(model["image"], e)
            + bert_forward(model["text"], e))


def per_sample(model: Dict) -> Dict[str, float]:
    """{'forward': ..., 'train': forward + backward} operations a sample."""
    f = forward(model)
    return {"forward": f, "train": 3.0 * f}
