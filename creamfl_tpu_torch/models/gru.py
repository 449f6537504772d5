"""Masked bidirectional GRU with PyTorch packed-sequence semantics.

Port of the JAX package's ``models/gru.py`` (reference
`src/networks/models/caption_encoder.py:87-101`,
`src/networks/language_model.py:95-107`). The reference runs
``pack_padded_sequence`` -> ``nn.GRU`` -> a gather of the last valid state;
so does this module, on ``torch.nn.GRU`` (cuDNN on the card):

* the forward direction never updates its hidden state on pad steps;
* the backward direction starts at the last valid token of each sequence;
* outputs at pad positions are zero; ``final[b] = outputs[b, len_b - 1]``.

The JAX package computes the same with a masked ``lax.scan`` whose gates
follow torch's (r, z, n order, ``n = tanh(x_n + r * (W_hn h + b_hn))``), so
its ``fwd_*`` / ``bwd_*`` params are torch's ``*_l0`` / ``*_l0_reverse``
weights transposed (``models.convert.flax_bigru_to_torch``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence


class BiGRU(nn.GRU):
    """One-layer bidirectional GRU over [B, L, D] with per-row lengths.
    ``forward(x, lengths)`` returns ([B, L, 2H] outputs, [B, 2H] final)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True,
                         bidirectional=True)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        steps = x.shape[1]
        # pack_padded_sequence takes its lengths on the host; an empty row
        # packs as one step and is zeroed below, as the JAX mask zeroes it.
        host_lengths = lengths.detach().to("cpu", torch.int64)
        packed = pack_padded_sequence(x, host_lengths.clamp(1, steps),
                                      batch_first=True, enforce_sorted=False)
        out, _ = super().forward(packed)
        outs, _ = pad_packed_sequence(out, batch_first=True,
                                      total_length=steps)
        lengths = lengths.to(x.device)
        valid = torch.arange(steps, device=x.device)[None, :] < lengths[:, None]
        outs = outs * valid[:, :, None].to(outs.dtype)
        return outs, gather_last_valid(outs, lengths)


def gather_last_valid(outs: torch.Tensor, lengths: torch.Tensor
                      ) -> torch.Tensor:
    """outs[b, lengths[b] - 1, :] (the reference's last-state gather)."""
    idx = torch.clamp(lengths.long() - 1, 0, outs.shape[1] - 1)
    return outs[torch.arange(outs.shape[0], device=outs.device), idx]


def init_gru(module: nn.GRU, generator: torch.Generator) -> None:
    """torch's GRU init, U(-1/sqrt(H), 1/sqrt(H)) for every weight and bias,
    drawn from ``generator``."""
    bound = module.hidden_size ** -0.5
    for p in module.parameters():
        nn.init.uniform_(p, -bound, bound, generator=generator)
