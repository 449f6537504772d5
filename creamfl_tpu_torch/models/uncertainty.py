"""PCME uncertainty (log-sigma) heads.

Port of the JAX package's ``models/uncertainty.py`` (reference
`src/networks/models/uncertainty_module.py`): attention-pooled log-sigma
estimators for probabilistic embeddings. The CreamFL pipeline never
instantiates them (the PCME configs run the deterministic path); they make
the probabilistic-embedding mode available, with
``sample_gaussian_embeddings`` drawing its samples.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from creamfl_tpu_torch.models.pie import MultiHeadSelfAttention


class UncertaintyModule(nn.Module):
    """Shared image/text shape: one-head attention over the tokens
    ([B, L, d_in]) through ``embed``, plus ``fc`` of the pooled vector
    ([B, d_in]) -> log-sigma [B, d_out]."""

    def __init__(self, d_in: int, d_out: int, d_hidden: int):
        super().__init__()
        self.attention = MultiHeadSelfAttention(1, d_in, d_hidden)
        self.fc = nn.Linear(d_in, d_out)
        self.embed = nn.Linear(d_in, d_out)

    def forward(self, pooled: torch.Tensor, tokens: torch.Tensor,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        residual, _ = self.attention(tokens, pad_mask)
        return self.embed(residual) + self.fc(pooled)  # logsigma


def init_uncertainty(module: UncertaintyModule,
                     generator: torch.Generator) -> None:
    """Xavier-uniform kernels and zero biases (the JAX module's
    initializers)."""
    for lin in (module.attention.w_1, module.attention.w_2, module.fc,
                module.embed):
        nn.init.xavier_uniform_(lin.weight, generator=generator)
    nn.init.zeros_(module.fc.bias)
    nn.init.zeros_(module.embed.bias)


def sample_gaussian_embeddings(mu: torch.Tensor, logsigma: torch.Tensor,
                               n_samples: int,
                               generator: Optional[torch.Generator] = None
                               ) -> torch.Tensor:
    """[B, d] mu/logsigma -> [B, K, d] samples mu + eps * exp(logsigma),
    eps ~ N(0, 1) from ``generator`` (reference
    tensor_utils.sample_gaussian_tensors)."""
    eps = torch.randn((mu.shape[0], n_samples, mu.shape[-1]),
                      generator=generator, dtype=mu.dtype, device=mu.device)
    return mu[:, None, :] + eps * torch.exp(logsigma)[:, None, :]
