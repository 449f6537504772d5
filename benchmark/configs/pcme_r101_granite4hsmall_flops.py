"""Model operations of one sample of the server's PCME with
Granite-4.0-H-Small as its text tower: the ResNet trunk and the image heads
as ``pcme_r101_bertbase_flops.py`` counts them, and the tower at
``max_len`` tokens. A multiply-add is 2 operations; a backward is twice its
forward. Element-wise work (norms, gates, activations, softmax, the
router's top-k and sort, the loss) is left out, and the embedding's lookup
is no product.

The tower a token, layer by layer:

- a Mamba-2 mixer: ``in_proj`` (d -> 2 x inner + 2 G N + H), the depthwise
  conv (K taps a channel of xBC), the SSD's products at ``L = max_len``
  in chunks of ``Q = min(mamba_chunk_size, L)`` (a chunk's ``C . B``
  over its Q tokens, and each head's weighted sum of its Q values; with
  more than one chunk, each token's share of its chunk's state, ``x B^T``,
  and its read of the state it entered with, ``C h``), and ``out_proj``;
- an attention layer: its four projections (GQA: k and v at the key-value
  heads' width) and its two products over ``max_len`` keys (every key
  counted, as the BERT count does);
- every layer's router (``num_local_experts`` outputs) and shared MLP
  (three products at ``shared_intermediate_size``).

Then the pooled state's projection to the embedding. The held experts are
not in the count a sample: how many pairs reach them depends on the
router, which drifts as the server trains; the cell's phase counts them
from the pairs the program tallied, ``pair_forward`` operations each
forward. Under even routing a token's 10 picks over 72 experts reach the
9 held here 1.25 times.
"""

from __future__ import annotations

import os
from typing import Dict

from benchlib import registry

_BERTBASE = registry.load_module(
    "configs", "pcme_r101_bertbase_flops",
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mamba_token(text: Dict) -> float:
    """A Mamba-2 mixer's operations a token at ``max_len``."""
    d, length = text["hidden_size"], text["max_len"]
    heads, p = text["mamba_n_heads"], text["mamba_d_head"]
    gn = text["mamba_n_groups"] * text["mamba_d_state"]
    inner = heads * p
    conv = inner + 2 * gn
    q = min(text["mamba_chunk_size"], length)
    ssd = 2 * q * gn + 2 * q * inner
    if length > q:
        ssd += 2 * 2 * inner * text["mamba_d_state"]
    return float(2 * d * (inner + conv + heads)
                 + 2 * text["mamba_d_conv"] * conv + ssd + 2 * inner * d)


def attention_token(text: Dict) -> float:
    d, length = text["hidden_size"], text["max_len"]
    heads, kv = text["num_attention_heads"], text["num_key_value_heads"]
    hd = d // heads
    return float(2 * d * d * 2 + 2 * 2 * d * kv * hd
                 + 2 * 2 * length * heads * hd)


def moe_token(text: Dict) -> float:
    """A layer's router and shared MLP a token (the held experts left
    out)."""
    d = text["hidden_size"]
    return float(2 * d * text["num_local_experts"]
                 + 3 * 2 * d * text["shared_intermediate_size"])


def tower_token(text: Dict) -> float:
    """The tower's operations a token, every layer, at ``max_len``."""
    kinds = text["layer_types"][:text["num_layers"]]
    mixers = sum(mamba_token(text) if k == "mamba" else attention_token(text)
                 for k in kinds)
    return mixers + len(kinds) * moe_token(text)


def pair_forward(text: Dict) -> float:
    """A held expert's operations on one token, forward."""
    return 3 * 2.0 * text["hidden_size"] * text["intermediate_size"]


def tower_forward(text: Dict, embed: int) -> float:
    return (text["max_len"] * tower_token(text)
            + 2.0 * text["hidden_size"] * embed)


def forward(model: Dict) -> float:
    e = model["embed_dim"]
    return (_BERTBASE.resnet_forward(model["image"])
            + _BERTBASE.image_heads_forward(model["image"], e)
            + tower_forward(model["text"], e))


def per_sample(model: Dict) -> Dict[str, float]:
    """{'forward': ..., 'train': forward + backward} operations a sample."""
    f = forward(model)
    return {"forward": f, "train": 3.0 * f}
