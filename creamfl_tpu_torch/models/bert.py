"""BERT encoder (the server's text branch when ``not_bert`` is False).

Port of the JAX package's ``models/bert.py``: input ids + attention mask ->
last hidden states [B, L, H]; tokenisation happens in the data pipeline.
The port's own ``nn.Module`` (no ``transformers`` dependency) with
HuggingFace ``BertModel`` parameter names, so a ``bert-base-uncased``
``state_dict`` loads through ``BertEncoder.load_hf_state_dict``.

Semantics as in the JAX package: separate q/k/v projections, an additive
mask bias of -1e9 cast to the scores' dtype, softmax in fp32, exact GELU,
LayerNorm eps 1e-12, and dropout at the four places HF puts it (embeddings,
attention probabilities, attention output, FFN output). Dropout draws its
keep mask for the whole batch (``parallel/mesh.py:row_dropout``), so that a
rank of a mesh running its rows of a batch gets world 1's masks for them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dropout_rate: float = 0.1

    @classmethod
    def tiny(cls) -> "BertConfig":
        """Small config for tests / CPU smoke runs."""
        return cls(vocab_size=512, hidden_size=64, num_layers=2,
                   num_heads=2, intermediate_size=128, max_position=64)


class _RowDropout(nn.Module):
    """Inverted dropout at ``rate`` in train mode, its mask drawn for the
    whole batch (``row_dropout``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.p = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from creamfl_tpu_torch.parallel.mesh import row_dropout

        return row_dropout(x, self.p) if self.training else x


def _dropout(rate: float) -> Optional[_RowDropout]:
    return _RowDropout(rate) if rate else None


def _apply(drop: Optional[_RowDropout], x: torch.Tensor) -> torch.Tensor:
    return x if drop is None else drop(x)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _DenseLayerNorm(nn.Module):
    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.self = _SelfAttention(d)
        self.output = _DenseLayerNorm(d, d, cfg.layer_norm_eps)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.num_heads = cfg.num_heads
        self.attention = _Attention(cfg)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseLayerNorm(cfg.intermediate_size, cfg.hidden_size,
                                      cfg.layer_norm_eps)
        self.probs_dropout = _dropout(cfg.dropout_rate)
        self.attn_dropout = _dropout(cfg.dropout_rate)
        self.ffn_dropout = _dropout(cfg.dropout_rate)

    def forward(self, h: torch.Tensor, attn_bias: torch.Tensor
                ) -> torch.Tensor:
        b, l, d = h.shape
        nh = self.num_heads
        hd = d // nh
        sa = self.attention.self
        q = sa.query(h).view(b, l, nh, hd)
        k = sa.key(h).view(b, l, nh, hd)
        v = sa.value(h).view(b, l, nh, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / hd ** 0.5
        scores = scores + attn_bias.to(scores.dtype)  # [B, 1, 1, L]
        probs = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        probs = _apply(self.probs_dropout, probs)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, l, d)
        out = self.attention.output
        attn_out = _apply(self.attn_dropout, out.dense(ctx))
        h = out.LayerNorm(h + attn_out)
        ffn = F.gelu(self.intermediate.dense(h), approximate="none")
        ffn = _apply(self.ffn_dropout, self.output.dense(ffn))
        return self.output.LayerNorm(h + ffn)


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d)
        self.position_embeddings = nn.Embedding(cfg.max_position, d)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d)
        self.LayerNorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_layers))


class BertEncoder(nn.Module):
    """input ids [B, L] + attention mask [B, L] -> last hidden states
    [B, L, H]."""

    def __init__(self, config: BertConfig = BertConfig()):
        super().__init__()
        self.config = config
        self.embeddings = _Embeddings(config)
        self.encoder = _Encoder(config)
        self.dropout = _dropout(config.dropout_rate)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, l = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        e = self.embeddings
        pos = torch.arange(l, device=input_ids.device)[None, :].expand(b, l)
        h = (e.word_embeddings(input_ids) + e.position_embeddings(pos)
             + e.token_type_embeddings(token_type_ids))
        h = _apply(self.dropout, e.LayerNorm(h))
        attn_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                                -1e9)
        for layer in self.encoder.layer:
            h = layer(h, attn_bias)
        return h

    def load_hf_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a HuggingFace ``BertModel`` (or ``BertFor*``, with its
        ``bert.`` prefix) ``state_dict``; the pooler and any head are not
        part of this encoder and are skipped."""
        own = self.state_dict()
        picked: Dict[str, torch.Tensor] = {}
        for key, val in sd.items():
            key = key[len("bert."):] if key.startswith("bert.") else key
            if key in own:
                picked[key] = val
        self.load_state_dict(picked, strict=True)


def init_bert(module: nn.Module, generator: torch.Generator,
              std: float = 0.02) -> None:
    """HF BERT's init: normal(0, 0.02) weights and embeddings, zero biases,
    unit LayerNorms."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
