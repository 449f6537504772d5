"""Unimodal client networks (CIFAR image clients, AG_NEWS text clients).

Port of the JAX package's ``models/clients.py``. Image clients (reference
`src/networks/resnet_client.py:104-208`): a ResNet trunk, a ``scale`` (=
128) feature multiplier, an optional 512 -> embed_dim linear and two
classifier heads whose weights are ReLU-clamped inside the training
forward. Text clients (`src/networks/language_model.py:28-130`): word
embedding, masked BiGRU, PIENet over the word embeddings, ``scale``, ReLU,
then the same two heads. Feature mode returns the L2-normalised
representation; with ``mlp_local`` it first runs the 512-wide projection
head ``head_proj`` (``models.pcme.MLPHead``), and the image client
normalises twice, as the JAX package does. The features are then 512
wide.

The clamp is an explicit parameter transform (``clamp_head_weights``)
that the train step applies before the forward, as in the JAX package:
the clamped value both produces the logits and persists.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn

from creamfl_tpu_torch.models.gru import BiGRU, init_gru
from creamfl_tpu_torch.models.pcme import (MLPHead, compute_dtype,
                                           gru_pie_forward)
from creamfl_tpu_torch.models.pie import PIENet, init_pie
from creamfl_tpu_torch.models.resnet import (ResNetBackbone, global_avg_pool,
                                             init_parameters,
                                             resnet_feature_dim)
from creamfl_tpu_torch.ops.l2norm import l2_normalize

# Head modules whose weights are ReLU-clamped each train step.
CLAMPED_HEADS = ("class_fc", "class_fc_2")


@torch.no_grad()
def clamp_head_weights(model: nn.Module) -> None:
    """ReLU-clamp the classifier head weights in place (reference
    `resnet_client.py:192-197`)."""
    for head in CLAMPED_HEADS:
        getattr(model, head).weight.clamp_(min=0.0)


class ImageClientNet(nn.Module):
    """ResNet client: trunk -> avgpool -> *scale -> [linear] -> heads.

    ``phase="features"`` returns the L2-normalised public-set
    representation; ``phase="train"`` returns
    (logits_task, logits_aux80, class_weight, aux_weight), the weights as
    [out, in]. BatchNorm follows the module's train/eval mode.

    ``head_proj`` exists with ``mlp_local`` only, as in the JAX client
    engine's tree; the train phase leaves it out of its graph (no
    gradient, so SGD leaves it as the JAX engine's frozen copy does).

    ``dtype=torch.bfloat16`` (``--client_bf16``) runs the trunk under
    ``torch.autocast`` and casts its grid to fp32 before pooling;
    parameters, BatchNorm statistics and everything after the pool stay
    fp32, as in the JAX client.
    """

    def __init__(self, cnn_type: str = "resnet18", num_class: int = 100,
                 embed_dim: int = 256, scale: float = 128.0,
                 mlp_local: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale = scale
        self.dtype = dtype
        self.backbone = ResNetBackbone(cnn_type)
        width = resnet_feature_dim(cnn_type)
        self.linear = None
        if embed_dim != 512:
            self.linear = nn.Linear(width, embed_dim)
            width = embed_dim
        self.class_fc = nn.Linear(width, num_class)
        self.class_fc_2 = nn.Linear(width, 80)
        self.head_proj = MLPHead(width) if mlp_local else None

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        with compute_dtype(self.dtype, images.device):
            grid = self.backbone(images)
        x = global_avg_pool(grid.float()) * self.scale
        return x if self.linear is None else self.linear(x)

    def forward(self, images: torch.Tensor, phase: str = "train"
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        x = self.embed(images)
        if phase == "features":
            if self.head_proj is not None:
                x = l2_normalize(self.head_proj(x))
            return l2_normalize(x)
        return (self.class_fc(x), self.class_fc_2(x), self.class_fc.weight,
                self.class_fc_2.weight)


class TextClientNet(nn.Module):
    """GRU text client: embed -> BiGRU -> PIENet(final, word embeddings)
    -> *scale -> relu -> heads / features (the JAX package's
    ``TextClientNet``). ``forward(captions, lengths, phase)`` returns what
    ``ImageClientNet.forward`` does for the same phase; ``head_proj``
    exists with ``mlp_local`` only and is left out of the train phase."""

    def __init__(self, vocab_size: int, num_class: int = 4,
                 embed_dim: int = 256, word_dim: int = 300,
                 scale: float = 128.0, mlp_local: bool = False):
        super().__init__()
        self.scale = scale
        self.embed = nn.Embedding(vocab_size, word_dim)
        self.rnn = BiGRU(word_dim, embed_dim // 2)
        self.pie_net = PIENet(1, word_dim, embed_dim, word_dim // 2)
        self.class_fc = nn.Linear(embed_dim, num_class)
        self.class_fc_2 = nn.Linear(embed_dim, 80)
        self.head_proj = MLPHead(embed_dim) if mlp_local else None

    def forward(self, captions: torch.Tensor, lengths: torch.Tensor,
                phase: str = "train"
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        x = torch.relu(gru_pie_forward(self, captions, lengths)[0]
                       * self.scale)
        if phase == "features":
            if self.head_proj is not None:
                x = self.head_proj(x)
            return l2_normalize(x)
        return (self.class_fc(x), self.class_fc_2(x), self.class_fc.weight,
                self.class_fc_2.weight)


def init_text_client(model: TextClientNet, generator: torch.Generator
                     ) -> None:
    """Seeded init: torch's default for the linear heads, xavier-uniform
    for the embedding and PIE, torch's GRU init (the JAX module's
    initializers, drawn from ``generator``)."""
    init_parameters(model, generator)
    nn.init.xavier_uniform_(model.embed.weight, generator=generator)
    init_gru(model.rnn, generator)
    init_pie(model.pie_net, generator)
