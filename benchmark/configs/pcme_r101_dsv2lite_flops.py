"""Model operations of one sample of the server's PCME with DeepSeek-V2-Lite
as its text tower: the ResNet trunk and the image heads as
``pcme_r101_bertbase_flops.py`` counts them, and the tower at ``max_len``
tokens. A multiply-add is 2 operations; a backward is twice its forward.
Element-wise work (norms, RoPE, activations, softmax, the router's top-k
and sort, the loss) is left out, and the embedding's lookup is no product.

The tower a token, layer by layer: MLA's four projections (``q_proj``,
``kv_a_proj_with_mqa``, ``kv_b_proj``, ``o_proj``) and its attention
products over ``max_len`` keys (the scores at the query-key width, the
values at the value width; every key counted, as the BERT count does);
layer 0's dense gated MLP (three products); each MoE layer's router (64
outputs) and its shared experts (three products at 2 x 1 408). Then the
pooled state's projection to the embedding.

The held experts are not in the count a sample: how many token-expert
pairs reach them depends on where the router sends the tokens, which
drifts as the server trains. The cell's phase counts them from the pairs
the program tallied, ``pair_forward`` operations each forward (three
products at 1 408). Under even routing a token's 6 picks over 64 experts
reach the 8 held here 0.75 times.
"""

from __future__ import annotations

import os
from typing import Dict

from benchlib import registry

_BERTBASE = registry.load_module(
    "configs", "pcme_r101_bertbase_flops",
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tower_token(text: Dict) -> float:
    """The tower's operations a token, every layer, at ``max_len``, the
    held experts left out."""
    d, heads, length = (text["hidden_size"], text["num_attention_heads"],
                        text["max_len"])
    nope, rope, vd = (text["qk_nope_head_dim"], text["qk_rope_head_dim"],
                      text["v_head_dim"])
    latent = text["kv_lora_rank"]
    attn = 2 * (d * heads * (nope + rope) + d * (latent + rope)
                + latent * heads * (nope + vd) + heads * vd * d)
    attn += 2 * length * heads * (nope + rope) + 2 * length * heads * vd
    dense = 3 * 2 * d * text["intermediate_size"]
    moe = (2 * d * text["n_routed_experts"]
           + 3 * 2 * d * text["moe_intermediate_size"]
           * text["n_shared_experts"])
    dense_layers = text["first_k_dense_replace"]
    return float(text["num_layers"] * attn + dense_layers * dense
                 + (text["num_layers"] - dense_layers) * moe)


def pair_forward(text: Dict) -> float:
    """A held expert's operations on one token, forward."""
    return 3 * 2.0 * text["hidden_size"] * text["moe_intermediate_size"]


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
