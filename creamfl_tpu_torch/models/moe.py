"""The held share of a routed mixture of experts, shared by the decoder
towers that have one (``models/deepseek_v2.py``, ``models/granite_h.py``);
each tower brings its own router.

A layer holds some of its experts (``HeldExperts``, keyed by their global
index) and routes over all of them: its routed part is what the held
experts give for the pairs routed to them, and the absent experts add
nothing (expert parallelism's share, without its exchange). Each expert is
a gated SiLU MLP that names its weights: ``in_weights()``, whose rows
stacked in order are ``[gate; up]`` ([2W, d]), and ``out_weight()``
([d, W]).

The routing never reads a count to the host: the token-expert pairs are
sorted by held expert (the absent ones last), the group ends come from
``searchsorted`` on the device, and one grouped product per projection
(``torch._grouped_mm``) computes the held groups. Every buffer is sized for
the worst case (all of a token's picks held), the rows past the held
groups are never computed, and ``torch.where`` keeps them out of the
results and the gradients. So a step can be captured in a CUDA graph and
replayed, and an eager step dispatches without a wait.

Under a bf16 autocast the grouped products run in bf16; ``Combine`` weighs
and sums each token's picks in float32, keeping the experts' outputs in
the compute dtype for its backward.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def compute_dtype(x: torch.Tensor) -> torch.dtype:
    """The autocast dtype where autocast is on for ``x``'s device, else
    ``x``'s own."""
    kind = x.device.type
    if torch.is_autocast_enabled(kind):
        return torch.get_autocast_dtype(kind)
    return x.dtype


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """``x`` [P, K] with rows grouped in order; ``w`` [G, N, K], a
    projection's weight per group; ``ends`` [G] int32, each group's end
    row. Rows from ``ends[-1]`` on are not computed: their values are
    undefined."""
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=ends)


class HeldExperts(nn.ModuleDict):
    """The experts ``held`` of ``n_experts`` routed ones, each made by
    ``make_expert()`` and kept as the child ``<e>`` (its global index), in
    index order. ``forward`` computes the held groups of a routing plan
    with three grouped products."""

    def __init__(self, held: Sequence[int],
                 make_expert: Callable[[], nn.Module], n_experts: int):
        held = sorted(held)
        if not held or len(set(held)) != len(held) or not all(
                0 <= e < n_experts for e in held):
            raise ValueError(f"held experts {held}: distinct indices below "
                             f"{n_experts}")
        super().__init__({str(e): make_expert() for e in held})
        local = torch.full((n_experts,), len(held), dtype=torch.long)
        local[torch.tensor(held, dtype=torch.long)] = torch.arange(len(held))
        self.register_buffer("local_of", local, persistent=False)

    def plan(self, idx: torch.Tensor):
        """The routing plan of ``idx`` [T, k], on the device: (the pair
        (``t * k + j``) in each sorted row [P], each held group's end [G]
        int32, the rows of held pairs [P] bool, each pair's sorted row
        [P]); P = T x k, held pairs first, grouped by expert, the absent
        experts' pairs last."""
        flat = self.local_of[idx.reshape(-1)]
        local, order = torch.sort(flat, stable=True)
        held = torch.arange(len(self), device=idx.device)
        ends = torch.searchsorted(local, held, right=True).to(torch.int32)
        rows = torch.arange(flat.numel(), device=idx.device)
        valid = rows < ends[-1]
        sorted_row = torch.empty_like(order).scatter_(0, order, rows)
        return order, ends, valid, sorted_row

    def forward(self, h: torch.Tensor, order: torch.Tensor,
                ends: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """h [T, d]; the plan's order, ends and valid -> [P, d] in the
        compute dtype: each held pair's expert output, 0 elsewhere. The
        tokens are repeated k times and permuted into the sorted rows (a
        gather with one source a row, so the gradient is summed without
        atomics, the same in every run)."""
        dtype = compute_dtype(h)
        experts = list(self.values())
        w_out = torch.stack([e.out_weight() for e in experts]).to(dtype)
        width = w_out.shape[-1]
        w_in = torch.stack([w for e in experts for w in e.in_weights()]).to(
            dtype).view(len(experts), 2 * width, -1)
        rows = valid[:, None]
        t, d = h.shape
        pairs = h.to(dtype).unsqueeze(1).expand(t, order.numel() // t, d)
        x = torch.where(rows, pairs.reshape(-1, d).index_select(0, order), 0)
        gate, up = grouped_mm(x, w_in, ends).split(width, dim=-1)
        y = grouped_mm(F.silu(gate) * up, w_out, ends)
        return torch.where(rows, y, 0)


class _Combine(torch.autograd.Function):
    """``sum_j w[t, j] * float(y[sorted_row[t * k + j]])``, saving the
    gathered pairs in the compute dtype ([P, d]) for the backward instead
    of the float32 [T, k, d] copy autograd would keep: the product with
    the gradient casts them as it reads them, exactly. Its operations are
    autograd's for the same expression, in the same order, so the
    gradients are the same to the bit."""

    @staticmethod
    def forward(ctx, y, sorted_row, weights):
        t, k = weights.shape
        pairs = y.index_select(0, sorted_row)
        ctx.save_for_backward(pairs, sorted_row, weights)
        return (pairs.view(t, k, -1).float()
                * weights.unsqueeze(-1)).sum(dim=1)

    @staticmethod
    def backward(ctx, grad):
        pairs, sorted_row, weights = ctx.saved_tensors
        t, k = weights.shape
        grad = grad.unsqueeze(1).expand(t, k, grad.shape[-1])
        g_y = g_w = None
        if ctx.needs_input_grad[0]:
            g_pairs = (grad * weights.unsqueeze(-1)).to(pairs.dtype)
            g_y = torch.zeros_like(pairs).index_add_(
                0, sorted_row, g_pairs.view(t * k, -1))
        if ctx.needs_input_grad[2]:
            g_w = (grad * pairs.view(t, k, -1)).sum(-1)
        return g_y, None, g_w


class Combine(nn.Module):
    """Each token's routed output: its pairs' expert outputs (in sorted
    rows) weighted by the router and summed, in float32."""

    def forward(self, y: torch.Tensor, sorted_row: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
        return _Combine.apply(y, sorted_row, weights)
