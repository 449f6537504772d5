"""ResNet trunks with BasicBlocks (resnet6/10/18/34), torchvision names.

Public layout is the JAX package's: images in NHWC ``[B, H, W, 3]``, the
feature grid out as NHWC ``[B, H/32, W/32, C]``. Inside, the trunk runs
NCHW on a permuted view (channels-last strides, which cuDNN prefers).

BatchNorm follows the JAX package (flax ``nn.BatchNorm``, momentum 0.9):
in train mode the running stats move as ``0.9 * old + 0.1 * batch`` with
the BIASED batch variance. ``nn.BatchNorm2d`` would use the unbiased one,
a factor n/(n-1) apart (6.7 % at batch 4 on a 2 x 2 grid).

Bottleneck trunks (resnet50/101/152) come with the server slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


class BatchNorm(nn.Module):
    """BatchNorm2d with flax's running-stat update (biased variance).

    Parameter and buffer names are torchvision's (weight, bias,
    running_mean, running_var, num_batches_tracked), so its checkpoints
    load with ``strict=True``.
    """

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(self.momentum).add_(
                mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=1 - self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride),
                                            BatchNorm(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


# name -> (stage sizes, feature dim of the final grid). "resnet6" is the
# JAX package's test-scale trunk (stem + 2 blocks); the rest are
# torchvision's BasicBlock ResNets.
RESNET_CONFIGS = {
    "resnet6": ((1, 1), 128),
    "resnet10": ((1, 1, 1, 1), 512),
    "resnet18": ((2, 2, 2, 2), 512),
    "resnet34": ((3, 4, 6, 3), 512),
}


def resnet_feature_dim(cnn_type: str) -> int:
    return RESNET_CONFIGS[cnn_type][1]


class ResNetBackbone(nn.Module):
    """Stride-32 conv trunk: NHWC [B, H, W, 3] -> NHWC [B, H/32, W/32, C]."""

    def __init__(self, cnn_type: str = "resnet18"):
        super().__init__()
        if cnn_type not in RESNET_CONFIGS:
            raise NotImplementedError(
                f"{cnn_type}: only the BasicBlock trunks "
                f"{sorted(RESNET_CONFIGS)} are ported")
        stage_sizes, _ = RESNET_CONFIGS[cnn_type]
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(cin, filters, stride))
                cin = filters
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.permute(0, 2, 3, 1)


def global_avg_pool(grid: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, C] (AdaptiveAvgPool2d((1, 1)))."""
    return grid.mean(dim=(1, 2))


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init: torchvision's for convs and BN, torch's default for
    linear layers, all drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu",
                                    generator=generator)
        elif isinstance(m, nn.Linear):
            nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5,
                                     generator=generator)
            bound = m.in_features ** -0.5
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
