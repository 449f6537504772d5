"""Weights from the JAX package's trees to the port's ``state_dict``.

The inverse of the JAX package's ``torchvision_resnet_to_flax``: Flax
params and batch_stats (nested dicts of numpy arrays) become torch
tensors under torchvision's key names. Conv kernels HWIO -> OIHW, Dense
kernels [in, out] -> Linear weights [out, in], BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BLOCK = re.compile(r"^layer(\d+)_(\d+)$")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(p: Mapping) -> torch.Tensor:
    return _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _bn(out: Dict, key: str, p: Mapping, s: Mapping) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(s["mean"])
    out[f"{key}.running_var"] = _t(s["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _linear(out: Dict, key: str, p: Mapping) -> None:
    out[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    out[f"{key}.bias"] = _t(p["bias"])


def flax_resnet_to_torch(params: Mapping, batch_stats: Mapping
                         ) -> Dict[str, torch.Tensor]:
    """ResNetBackbone (Flax) params + batch_stats -> torchvision-named
    ``state_dict`` of ``models.resnet.ResNetBackbone``."""
    sd: Dict[str, torch.Tensor] = {"conv1.weight": _conv(params["conv1"])}
    _bn(sd, "bn1", params["bn1"], batch_stats["bn1"])
    for name, p in params.items():
        m = _BLOCK.match(name)
        if m is None:
            continue
        prefix = f"layer{m.group(1)}.{m.group(2)}"
        s = batch_stats[name]
        for i in (1, 2, 3):
            if f"conv{i}" in p:
                sd[f"{prefix}.conv{i}.weight"] = _conv(p[f"conv{i}"])
                _bn(sd, f"{prefix}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
        if "downsample_conv" in p:
            sd[f"{prefix}.downsample.0.weight"] = _conv(p["downsample_conv"])
            _bn(sd, f"{prefix}.downsample.1", p["downsample_bn"],
                s["downsample_bn"])
    return sd


def flax_image_client_to_torch(params: Mapping, batch_stats: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """ImageClientNet (Flax) -> ``state_dict`` of the port's
    ``models.clients.ImageClientNet``."""
    sd = {f"backbone.{k}": v for k, v in flax_resnet_to_torch(
        params["backbone"], batch_stats["backbone"]).items()}
    for head in ("linear", "class_fc", "class_fc_2"):
        if head in params:
            _linear(sd, head, params[head])
    return sd
