"""PCME joint-embedding model, the server's model (BERT text branch).

Port of the JAX package's ``models/pcme.py`` (reference
`src/networks/models/pcme.py`):

* image branch: ResNet trunk -> NHWC grid, cast to fp32; global average
  pool -> fc (xavier) -> PIENet over the grid tokens -> optional MLPHead
  -> L2 norm;
* text branch: BERT CLS -> fp32 -> linear -> L2 norm (the server), or
  (``not_bert=True``: the mm clients, and the server under ``--not_bert``)
  word embedding -> masked BiGRU -> PIENet over the word embeddings -> L2
  norm, with ``--mlp_local``'s head after the norm, or (``bert_config`` a
  decoder tower's config: the server under ``--text_encoder
  deepseek_v2_lite`` or ``granite_4_0_h_small``, ``models/towers.py``)
  the decoder tower pooled at each caption's last real token
  (``TextEncoderLM``).

``dtype=torch.bfloat16`` runs the trunk and the text tower under
``torch.autocast``
(bf16 matmuls and convolutions, fp32 params); heads, PIE, the GRU branch
and everything after them stay fp32, as in the JAX package. ``fused_bn``
and ``remat`` ("none", "block", "dots": activation recompute in the
backward) are passed to the trunk (``models/resnet.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from creamfl_tpu_torch.models.bert import BertConfig, BertEncoder
from creamfl_tpu_torch.models.gru import BiGRU, init_gru
from creamfl_tpu_torch.models.pie import PIENet, init_pie
from creamfl_tpu_torch.models.resnet import (BatchNorm, ResNetBackbone,
                                             global_avg_pool, init_parameters,
                                             resnet_feature_dim)
from creamfl_tpu_torch.models.towers import tower_of
from creamfl_tpu_torch.ops.l2norm import l2_normalize


def compute_dtype(dtype: torch.dtype, device: torch.device):
    """bf16 autocast on ``device`` for a bf16 module, else nothing. The
    weight casts are not cached: a CUDA graph of the server's steps
    (``engine/graphs.py``) replays them, and a cached cast would be read
    stale after an optimizer step (each weight is cast once a forward
    either way)."""
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=dtype,
                          cache_enabled=False)


class MLPHead(nn.Module):
    """Optional 512 -> 512 projection head (--mlp_local): fc1, BatchNorm
    (flax momentum 0.9), relu, fc2."""

    def __init__(self, d_in: int, width: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(d_in, width)
        self.bn = BatchNorm(width)
        self.fc2 = nn.Linear(width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.bn(self.fc1(x))))


class ImageEncoder(nn.Module):
    """ResNet grid -> pooled fc embedding fused with PIE attention."""

    def __init__(self, cnn_type: str = "resnet18", embed_dim: int = 256,
                 mlp_local: bool = False, dtype: torch.dtype = torch.float32,
                 fused_bn: bool = False, remat: str = "none"):
        super().__init__()
        cnn_dim = resnet_feature_dim(cnn_type)
        self.dtype = dtype
        self.cnn = ResNetBackbone(cnn_type, fused_bn=fused_bn, remat=remat)
        self.fc = nn.Linear(cnn_dim, embed_dim)
        self.pie_net = PIENet(1, cnn_dim, embed_dim, cnn_dim // 2)
        self.head_proj = MLPHead(embed_dim) if mlp_local else None

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        with compute_dtype(self.dtype, images.device):
            grid = self.cnn(images)
        b, h, w, c = grid.shape
        grid = grid.float()
        out = self.fc(global_avg_pool(grid))
        out, attn, residual = self.pie_net(out, grid.reshape(b, h * w, c))
        if self.head_proj is not None:
            out = self.head_proj(out)
        return {"embedding": l2_normalize(out), "attention": attn,
                "residual": residual}


def gru_pie_forward(module: nn.Module, captions: torch.Tensor,
                    lengths: torch.Tensor):
    """The GRU text branch shared by ``TextEncoderGRU`` and the text
    client: ``module.embed`` -> ``module.rnn`` (BiGRU) -> ``module.pie_net``
    over the word embeddings with the pads masked. Returns PIENet's (out,
    attention, residual)."""
    wemb = module.embed(captions)
    _, final = module.rnn(wemb, lengths)
    steps = torch.arange(captions.shape[1], device=captions.device)
    pad_mask = steps[None, :] >= lengths.to(captions.device)[:, None]
    return module.pie_net(final, wemb, pad_mask)


class TextEncoderGRU(nn.Module):
    """Word embedding + masked BiGRU + PIE over the word embeddings (the
    JAX package's ``TextEncoderGRU``). The reference applies ``mlp_local``'s
    head after the L2 norm (caption_encoder.py:109-113); so does this."""

    def __init__(self, vocab_size: int, embed_dim: int = 256,
                 word_dim: int = 300, mlp_local: bool = False):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, word_dim)
        self.rnn = BiGRU(word_dim, embed_dim // 2)
        self.pie_net = PIENet(1, word_dim, embed_dim, word_dim // 2)
        self.head_proj = MLPHead(embed_dim) if mlp_local else None

    def forward(self, captions: torch.Tensor, lengths: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        out, attn, residual = gru_pie_forward(self, captions, lengths)
        out = l2_normalize(out)
        if self.head_proj is not None:
            out = self.head_proj(out)
        return {"embedding": out, "attention": attn, "residual": residual}


class TextEncoderBert(nn.Module):
    """BERT CLS -> linear -> L2 norm (server text branch)."""

    def __init__(self, embed_dim: int = 256,
                 bert_config: BertConfig = BertConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bert = BertEncoder(bert_config)
        self.linear = nn.Linear(bert_config.hidden_size, embed_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        with compute_dtype(self.dtype, input_ids.device):
            hidden = self.bert(input_ids, attention_mask)
        cls = hidden[:, 0, :].float()
        return {"embedding": l2_normalize(self.linear(cls))}


class TextEncoderLM(nn.Module):
    """A decoder tower (DeepSeek-V2-Lite, ``models/deepseek_v2.py``, or
    Granite-4.0-H, ``models/granite_h.py``; ``config`` picks it) -> the
    final hidden state at each caption's last real token (its EOS) -> fp32
    -> linear -> L2 norm.

    A departure from PCME's BERT branch, which pools at position 0 (CLS):
    position 0 of a causal tower sees nothing but itself, so the pooled
    state is the last one, which has seen the whole caption (the pooling of
    decoder towers in image-text models: E5-V, LLM2CLIP). In training the
    output also carries the tower's balance loss (``aux_loss``)."""

    def __init__(self, embed_dim: int, config,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.model = tower_of(config).model(config)
        self.linear = nn.Linear(config.hidden_size, embed_dim)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        with compute_dtype(self.dtype, input_ids.device):
            hidden, aux = self.model(input_ids, attention_mask)
        last = attention_mask.sum(-1).long() - 1
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        pooled = hidden[rows, last].float()
        return {"embedding": l2_normalize(self.linear(pooled)),
                "aux_loss": aux}


# The DeepSeek-V2 tower's text branch, by its earlier name.
TextEncoderDeepseekV2 = TextEncoderLM


class PCME(nn.Module):
    """Joint embedding model; forward returns the reference's output dict.

    Fields mirror the JAX package's ``PCME``; ``not_bert=True`` takes the
    GRU text branch (``word_dim`` wide embeddings); otherwise
    ``bert_config`` is the text tower's config (``models/towers.py``): a
    ``BertConfig`` (BERT) or a decoder tower's (``TextEncoderLM``, whose
    balance loss the output carries as ``aux_loss``). ``remat`` goes to
    the image trunk (the JAX package's ``ImageEncoder.remat``)."""

    def __init__(self, embed_dim: int = 256, cnn_type: str = "resnet18",
                 vocab_size: int = 11755, word_dim: int = 300,
                 not_bert: bool = True, mlp_local: bool = False,
                 bert_config: BertConfig = BertConfig(),
                 dtype: torch.dtype = torch.float32, fused_bn: bool = False,
                 remat: str = "none"):
        super().__init__()
        self.not_bert = not_bert
        self.bert_config = bert_config
        self.img_enc = ImageEncoder(cnn_type, embed_dim, mlp_local,
                                    dtype=dtype, fused_bn=fused_bn,
                                    remat=remat)
        if not_bert:
            self.txt_enc = TextEncoderGRU(vocab_size, embed_dim, word_dim,
                                          mlp_local)
        elif tower_of(bert_config).decoder:
            self.txt_enc = TextEncoderLM(embed_dim, bert_config, dtype=dtype)
        else:
            self.txt_enc = TextEncoderBert(embed_dim, bert_config,
                                           dtype=dtype)

    def forward(self, images: torch.Tensor, captions: torch.Tensor,
                lengths: torch.Tensor,
                bert_mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        image_output = self.img_enc(images)
        caption_output = self.text_forward(captions, lengths, bert_mask)
        out = {
            "image_features": image_output["embedding"],
            "image_attentions": image_output["attention"],
            "image_residuals": image_output["residual"],
            "caption_features": caption_output["embedding"],
            "caption_attentions": caption_output.get("attention"),
            "caption_residuals": caption_output.get("residual"),
        }
        if "aux_loss" in caption_output:
            out["aux_loss"] = caption_output["aux_loss"]
        return out

    def image_forward(self, images: torch.Tensor):
        return self.img_enc(images)

    def text_forward(self, captions: torch.Tensor, lengths: torch.Tensor,
                     bert_mask: Optional[torch.Tensor] = None):
        if self.not_bert:
            return self.txt_enc(captions, lengths)
        if bert_mask is None:
            bert_mask = _length_mask(captions, lengths)
        return self.txt_enc(captions, bert_mask)


def _length_mask(captions: torch.Tensor, lengths: torch.Tensor
                 ) -> torch.Tensor:
    steps = torch.arange(captions.shape[1], device=captions.device)
    return (steps[None, :] < lengths.to(captions.device)[:, None]).to(
        torch.int32)


def init_pcme(model: PCME, generator: torch.Generator) -> None:
    """Seeded init: torchvision's for the trunk, xavier-uniform for the
    image fc and PIE (zero biases), the text tower's own
    (``models/towers.py``: HF BERT's for BERT); xavier-uniform embeddings
    and torch's GRU init for the GRU branch; torch's default for the
    remaining linear heads. A decoder tower's branch draws the image
    encoder's first (``init_parameters`` over it alone), then the tower's
    and its head's."""
    tower = None if model.not_bert else tower_of(model.bert_config)
    if tower is not None and tower.decoder:
        init_parameters(model.img_enc, generator)
    else:
        init_parameters(model, generator)
    img = model.img_enc
    nn.init.xavier_uniform_(img.fc.weight, generator=generator)
    nn.init.zeros_(img.fc.bias)
    init_pie(img.pie_net, generator)
    if tower is None:
        init_text_gru(model.txt_enc, generator)
    else:
        tower.init(model.txt_enc, generator)


def init_text_gru(module: nn.Module, generator: torch.Generator) -> None:
    """The GRU text branch's own init (the JAX package's initializers):
    xavier-uniform embedding, U(-1/sqrt(H), 1/sqrt(H)) GRU, PIE's."""
    nn.init.xavier_uniform_(module.embed.weight, generator=generator)
    init_gru(module.rnn, generator)
    init_pie(module.pie_net, generator)
