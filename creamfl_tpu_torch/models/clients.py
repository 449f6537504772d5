"""Unimodal image client network (CIFAR image clients).

Reference (`src/networks/resnet_client.py:104-208`): a ResNet trunk, a
``scale`` (= 128) feature multiplier, an optional 512 -> embed_dim linear
and two classifier heads whose weights are ReLU-clamped inside the
training forward. Feature mode returns the L2-normalised representation.

The clamp is an explicit parameter transform (``clamp_head_weights``)
that the train step applies before the forward, as in the JAX package:
the clamped value both produces the logits and persists.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn as nn

from creamfl_tpu_torch.models.resnet import (ResNetBackbone, global_avg_pool,
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
    """

    def __init__(self, cnn_type: str = "resnet18", num_class: int = 100,
                 embed_dim: int = 256, scale: float = 128.0,
                 mlp_local: bool = False):
        super().__init__()
        if mlp_local:
            raise NotImplementedError(
                "--mlp_local (MLPHead) is ported with the server slice")
        self.scale = scale
        self.backbone = ResNetBackbone(cnn_type)
        width = resnet_feature_dim(cnn_type)
        self.linear = None
        if embed_dim != 512:
            self.linear = nn.Linear(width, embed_dim)
            width = embed_dim
        self.class_fc = nn.Linear(width, num_class)
        self.class_fc_2 = nn.Linear(width, 80)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        x = global_avg_pool(self.backbone(images).float()) * self.scale
        return x if self.linear is None else self.linear(x)

    def forward(self, images: torch.Tensor, phase: str = "train"
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
        x = self.embed(images)
        if phase == "features":
            return l2_normalize(x)
        return (self.class_fc(x), self.class_fc_2(x), self.class_fc.weight,
                self.class_fc_2.weight)
