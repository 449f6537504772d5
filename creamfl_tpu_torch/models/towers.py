"""The server's text towers, in one table: ``--text_encoder``'s choices
(``main.py``), the text branch PCME builds and draws (``models/pcme.py``),
and what the server counts and refuses for it (``engine/server.py``).

A tower is BERT (pooled at CLS) or a decoder LM pooled at each caption's
last real token (``pcme.TextEncoderLM``), whose captions are the port's
synthetic LM ids (its own tokenizer is not in the repository), which runs
off a mesh only, and which may route tokens to held experts (``moe``) or
through Mamba mixers (``mixers``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch.nn as nn

from creamfl_tpu_torch.models.bert import BertConfig, init_bert
from creamfl_tpu_torch.models.deepseek_v2 import (DeepseekV2Config,
                                                  DeepseekV2Model,
                                                  init_deepseek_v2)
from creamfl_tpu_torch.models.granite_h import (GraniteHConfig,
                                                GraniteHModel,
                                                init_granite_h)


@dataclasses.dataclass(frozen=True)
class Tower:
    """``config``: the config class (``config()`` the published cut,
    ``config.tiny()`` the smoke size); ``model``: the decoder's class
    (None for BERT); ``init``: draws the text branch's weights from a
    generator; ``moe``: (MoE layers, experts per token) of a config, or
    None; ``mixers``: its Mamba mixers."""
    config: type
    model: Optional[Callable[..., nn.Module]]
    init: Callable
    moe: Callable[[object], Optional[Tuple[int, int]]] = lambda cfg: None
    mixers: Callable[[object], int] = lambda cfg: 0

    @property
    def decoder(self) -> bool:
        return self.model is not None


TOWERS = {
    "bert": Tower(BertConfig, None, lambda enc, g: init_bert(enc.bert, g)),
    "deepseek_v2_lite": Tower(
        DeepseekV2Config, DeepseekV2Model, init_deepseek_v2,
        moe=lambda cfg: (cfg.moe_layers, cfg.num_experts_per_tok)),
    "granite_4_0_h_small": Tower(
        GraniteHConfig, GraniteHModel, init_granite_h,
        moe=lambda cfg: (cfg.num_hidden_layers, cfg.num_experts_per_tok),
        mixers=lambda cfg: cfg.mamba_layers),
}


def name_of(config) -> str:
    """The ``--text_encoder`` name of a tower config."""
    for name, tower in TOWERS.items():
        if type(config) is tower.config:
            return name
    raise TypeError(f"no text tower takes a {type(config).__name__}")


def tower_of(config) -> Tower:
    return TOWERS[name_of(config)]
