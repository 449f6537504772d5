"""Granite-4.0-H-Small as a text tower: Mamba-2 mixers, attention without
positions (GQA) and a routed mixture of experts, of which this process
holds a share.

The published model (huggingface.co/ibm-granite/granite-4.0-h-small,
``config.json``; the layer equations of ``transformers``'
``modeling_granitemoehybrid.py``, which this module does not import), with
its parameter names (``model.embed_tokens``, ``model.layers.<i>.mamba
.in_proj``, ``...self_attn.q_proj``, ``...block_sparse_moe.router.layer``,
``...shared_mlp.input_linear``, ``model.norm``), so that a slice of the
published checkpoint loads by name. The experts are the exception: the
published ``block_sparse_moe.input_linear.weight`` [72, 1536, 4096] and
``output_linear.weight`` [72, 4096, 768] are kept one held expert a leaf,
``block_sparse_moe.experts.<e>.input_linear.weight`` [1536, 4096] (gate
rows, then up rows) and ``...experts.<e>.output_linear.weight``
[4096, 768], so that AdamP projects each expert on its own.

The embedding is multiplied by ``embedding_multiplier`` (12). A layer is

    x += r * Mixer(RMSNorm(x));  x += r * (MoE(h) + SharedMLP(h)),
    h = RMSNorm(x)

with ``r = residual_multiplier`` (0.22), the mixer a Mamba-2 layer or an
attention layer as ``layer_types`` says (the published order; the tower
holds its first ``num_hidden_layers``), RMSNorm in float32 (eps 1e-5). A
final RMSNorm closes the tower. The pads are zeroed on entering each Mamba
mixer and after its convolution (as published), and masked as keys in
attention; the tower is causal.

Mamba-2 mixer (``MambaMixer``; 128 heads of 64, state 128, one group):
``in_proj h = [z 8192 | xBC 8448 | dt 128]``; xBC through a causal
depthwise conv1d (kernel 4, with bias) and SiLU, split ``[x 8192 | B 128 |
C 128]``; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)`` per head;
the SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
``y_t = h_t C_t + D x_t``, computed in chunks (``ssd``); then
``out_proj RMSNorm(y * silu(z))`` over all 8192 channels (the gated norm).

Attention (32 query heads, 8 key-value heads, head 128, no positions):
``softmax(q k^T * attention_multiplier)`` with the multiplier 1/128, the
softmax in float32, then ``o_proj``.

MoE (72 experts of width 768, top 10): the router's float32 logits over
every expert, the top 10 of them, a softmax over those 10; each held
expert a gated SiLU MLP (``models/moe.py``'s ``HeldExperts`` and
``Combine``, shared with the DeepSeek-V2 tower); the shared MLP is one of
width 1536. In training the Switch-style balance loss of ``transformers``'
``load_balancing_loss_func`` over every layer's router and the real
tokens, ``coef * E * sum_e f_e P_e`` (``f_e`` the share of the picks,
``P_e`` the mean probability, both pooled over the layers), comes back
beside the hidden states; the server adds it to its loss.

Compute dtype: the weights are float32; under the PCME encoder's bf16
autocast the projections, the convolution and the grouped products run in
bf16; the scan (its state and its products), the router, the norms and the
softmax in float32.

Spans (``utils/profiling.py``): ``creamfl.mamba.proj`` (``in_proj`` and
``out_proj``), ``creamfl.mamba.conv``, ``creamfl.mamba.scan`` and
``creamfl.mamba.norm``; the MoE's ``creamfl.moe.{route,experts,combine}``
and the device tally ``moe.held_pairs`` as in the DeepSeek-V2 tower.

Weights: ``init_granite_h`` draws them; the modules allocate them
uninitialised.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from creamfl_tpu_torch.models.deepseek_v2 import RMSNorm, _Embedding, _Linear
from creamfl_tpu_torch.models.moe import Combine, HeldExperts
from creamfl_tpu_torch.utils import profiling

PUBLISHED_LAYER_TYPES = tuple(
    "attention" if i % 10 == 5 else "mamba" for i in range(40))


@dataclasses.dataclass(frozen=True)
class GraniteHConfig:
    """The published widths, and the cut held here: the first 10 of the 40
    layers (one period: Mamba at 0-4 and 6-9, attention at 5) and experts
    0-8 of each layer's 72 (one card of eight-way expert parallelism)."""
    vocab_size: int = 100352
    hidden_size: int = 4096
    intermediate_size: int = 768  # an expert's width
    shared_intermediate_size: int = 1536
    num_hidden_layers: int = 10
    layer_types: Tuple[str, ...] = PUBLISHED_LAYER_TYPES
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attention_multiplier: float = 0.0078125
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk_size: int = 256
    mamba_conv_bias: bool = True
    num_local_experts: int = 72
    experts_held: Tuple[int, ...] = tuple(range(9))
    num_experts_per_tok: int = 10
    rms_norm_eps: float = 1e-5
    router_aux_loss_coef: float = 0.001
    initializer_range: float = 0.02
    bos_token_id: int = 100257
    eos_token_id: int = 100257

    @classmethod
    def tiny(cls) -> "GraniteHConfig":
        """Small config for tests / CPU smoke runs: Mamba, attention,
        Mamba; 8 SSM heads of 16, state 8, chunk 8; 4 query and 2
        key-value heads; 6 of 12 experts held, top-3. The weights are drawn
        at std 0.3, not 0.02: at width 64 the scan's term would otherwise
        be a millionth of the skip term's, and nothing would read it."""
        return cls(vocab_size=512, hidden_size=64, intermediate_size=32,
                   shared_intermediate_size=48, num_hidden_layers=3,
                   layer_types=("mamba", "attention", "mamba"),
                   num_attention_heads=4, num_key_value_heads=2,
                   attention_multiplier=1 / 16, mamba_n_heads=8,
                   mamba_d_head=16, mamba_d_state=8, mamba_chunk_size=8,
                   num_local_experts=12, experts_held=tuple(range(6)),
                   num_experts_per_tok=3, initializer_range=0.3,
                   bos_token_id=500, eos_token_id=500)

    @property
    def kinds(self) -> Tuple[str, ...]:
        """The held layers' kinds, in order."""
        return tuple(self.layer_types[:self.num_hidden_layers])

    @property
    def mamba_layers(self) -> int:
        return self.kinds.count("mamba")


# -- the chunked scan -----------------------------------------------------
def segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., Q] -> [..., Q, Q]: ``sum_{s < j <= l} a_j`` at (l, s) for
    l >= s, -inf above the diagonal; summed from the terms themselves, not
    as a difference of running sums (which cancels)."""
    q = a.shape[-1]
    x = a[..., None].expand(*a.shape, q)
    below = torch.ones(q, q, dtype=torch.bool, device=a.device).tril(-1)
    seg = x.masked_fill(~below, 0).cumsum(dim=-2)
    keep = torch.ones(q, q, dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~keep, -math.inf)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD recurrence without its skip term, in chunks of
    ``min(chunk, L)`` tokens: x [B, L, H, P], dt [B, L, H], a [H] (< 0),
    b and c [B, L, G, N], all float32 -> y [B, L, H, P].

    Within a chunk ``y_l = sum_{s<=l} exp(A sum_{s<j<=l} dt_j)
    (C_l . B_s) dt_s x_s`` as one product over the chunk's tokens; across
    chunks each chunk's own state ``sum_s exp(...) dt_s x_s B_s^T`` runs
    through the chunk recurrence, and each token reads the state it
    entered with, decayed to it. The chunk length changes only the order
    of the sums."""
    bsz, length, heads, p = x.shape
    groups, n = b.shape[2:]
    q = min(chunk, length)
    nc = -(-length // q)
    pad = nc * q - length
    if pad:
        x, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, b, c))
    hg = heads // groups
    # [B, c, G, Hg, Q(, P)]: the chunk's tokens last but one
    xs = (x * dt[..., None]).view(bsz, nc, q, groups, hg, p).permute(
        0, 1, 3, 4, 2, 5)
    ad = (dt * a).view(bsz, nc, q, groups, hg).permute(0, 1, 3, 4, 2)
    bc = b.view(bsz, nc, q, groups, n).transpose(2, 3)  # [B, c, G, Q, N]
    cc = c.view(bsz, nc, q, groups, n).transpose(2, 3)
    decay = torch.exp(segsum(ad))  # [B, c, G, Hg, Q, Q]
    cb = cc @ bc.transpose(-1, -2)  # [B, c, G, Q, Q]
    y = (decay * cb[:, :, :, None]) @ xs  # [B, c, G, Hg, Q, P]
    if nc > 1:
        own = (xs * decay[..., -1, :, None]).transpose(-1, -2) \
            @ bc[:, :, :, None]  # [B, c, G, Hg, P, N]
        through = torch.exp(ad.sum(-1))[..., None, None]
        state = torch.zeros_like(own[:, 0])
        entered = [state]
        for i in range(1, nc):
            state = through[:, i - 1] * state + own[:, i - 1]
            entered.append(state)
        entered = torch.stack(entered, 1)
        y = y + (cc[:, :, :, None] @ entered.transpose(-1, -2)) \
            * torch.exp(ad.cumsum(-1))[..., None]
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(bsz, nc * q, heads, p)
    return y[:, :length]


# -- modules ---------------------------------------------------------------
class ChunkedScan(nn.Module):
    """``ssd`` as a module of its own (it holds no weights), so that a
    profile can mark the scan with module hooks."""

    def __init__(self, chunk: int):
        super().__init__()
        self.chunk = chunk

    def forward(self, x, dt, a, b, c) -> torch.Tensor:
        return ssd(x, dt, a, b, c, self.chunk)


class _Conv1d(nn.Conv1d):
    def reset_parameters(self) -> None:
        pass


class _GatedRMSNorm(torch.autograd.Function):
    """``weight * RMSNorm(y * silu(z))`` in float32, saving ``y``, ``z``
    and the inverse RMS for the backward, which computes the gate and the
    normalised rows again (autograd would keep five float32 copies of a
    row block: ``z``, its SiLU, the product, the normalised rows)."""

    @staticmethod
    def forward(ctx, y, z, weight, eps):
        h = y.float() * F.silu(z.float())
        inv = torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(y, z, weight, inv)
        return weight * (h * inv).to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        y, z, weight, inv = ctx.saved_tensors
        zf = z.float()
        sig = torch.sigmoid(zf)
        gate = zf * sig
        h = y.float() * gate
        g_w = (grad * (h * inv)).reshape(-1, grad.shape[-1]).sum(0)
        g_n = (grad * weight).float()
        g_h = inv * (g_n - h * (inv * inv) * (g_n * h).mean(-1, keepdim=True))
        g_y = (g_h * gate).to(y.dtype)
        g_z = (g_h * y.float() * sig * (1 + zf * (1 - sig))).to(z.dtype)
        return g_y, g_z, g_w, None


class GatedRMSNorm(nn.Module):
    """``weight * RMSNorm(y * silu(z))`` over the last dimension, in
    float32."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return _GatedRMSNorm.apply(y, z, self.weight, self.eps)


class MambaMixer(nn.Module):
    """The Mamba-2 mixer (module docstring)."""

    def __init__(self, cfg: GraniteHConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads, self.head_dim = cfg.mamba_n_heads, cfg.mamba_d_head
        self.inner = self.heads * self.head_dim
        if self.inner != cfg.mamba_expand * d:
            raise ValueError(f"{self.heads} heads of {self.head_dim} are not "
                             f"{cfg.mamba_expand} x {d} channels")
        self.groups, self.state = cfg.mamba_n_groups, cfg.mamba_d_state
        self.conv_dim = self.inner + 2 * self.groups * self.state
        k = cfg.mamba_d_conv
        self.in_proj = _Linear(d, self.inner + self.conv_dim + self.heads)
        self.conv1d = _Conv1d(self.conv_dim, self.conv_dim, k,
                              groups=self.conv_dim, padding=k - 1,
                              bias=cfg.mamba_conv_bias)
        self.dt_bias = nn.Parameter(torch.ones(self.heads))
        self.A_log = nn.Parameter(torch.zeros(self.heads))
        self.D = nn.Parameter(torch.ones(self.heads))
        self.scan = ChunkedScan(cfg.mamba_chunk_size)
        self.norm = GatedRMSNorm(self.inner, cfg.rms_norm_eps)
        self.out_proj = _Linear(self.inner, d)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """h [B, L, d], mask [B, L] (1 for a real token) -> [B, L, d]."""
        bsz, length, _ = h.shape
        keep = mask[:, :, None]
        with profiling.span("creamfl.mamba.proj"):
            z, xbc, dt = self.in_proj(h * keep.to(h.dtype)).split(
                [self.inner, self.conv_dim, self.heads], dim=-1)
        with profiling.span("creamfl.mamba.conv"):
            xbc = F.silu(self.conv1d(xbc.transpose(1, 2))[..., :length]
                         .transpose(1, 2))
            xbc = xbc * keep.to(xbc.dtype)
        with profiling.span("creamfl.mamba.scan"), torch.autocast(
                device_type=h.device.type, enabled=False):
            x, b, c = xbc.float().split(
                [self.inner, self.groups * self.state,
                 self.groups * self.state], dim=-1)
            x = x.reshape(bsz, length, self.heads, self.head_dim)
            dt = F.softplus(dt.float() + self.dt_bias)
            y = self.scan(x, dt, -torch.exp(self.A_log.float()),
                          b.reshape(bsz, length, self.groups, self.state),
                          c.reshape(bsz, length, self.groups, self.state))
            y = (y + x * self.D[:, None]).reshape(bsz, length, self.inner)
        with profiling.span("creamfl.mamba.norm"):
            y = self.norm(y, z)
        with profiling.span("creamfl.mamba.proj"):
            return self.out_proj(y)


class Attention(nn.Module):
    """Grouped-query attention with no positions (module docstring)."""

    def __init__(self, cfg: GraniteHConfig):
        super().__init__()
        d, heads = cfg.hidden_size, cfg.num_attention_heads
        self.heads, self.kv_heads = heads, cfg.num_key_value_heads
        self.head_dim = d // heads
        self.q_proj = _Linear(d, heads * self.head_dim)
        self.k_proj = _Linear(d, self.kv_heads * self.head_dim)
        self.v_proj = _Linear(d, self.kv_heads * self.head_dim)
        self.o_proj = _Linear(heads * self.head_dim, d)
        self.scale = cfg.attention_multiplier

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """h [B, L, d], bias [B, 1, L, L] (0 or -1e9) -> [B, L, d]. Query
        head ``g * rep + r`` reads key-value head ``g``."""
        b, l, _ = h.shape
        g, hd = self.kv_heads, self.head_dim
        q = self.q_proj(h).view(b, l, g, self.heads // g, hd)
        k = self.k_proj(h).view(b, l, g, hd)
        v = self.v_proj(h).view(b, l, g, hd)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", q, k) * self.scale
        probs = torch.softmax(scores.float() + bias[:, :, None], dim=-1)
        ctx = torch.einsum("bgrqk,bkgd->bqgrd", probs.to(v.dtype), v)
        return self.o_proj(ctx.reshape(b, l, self.heads * hd))


class GatedMLP(nn.Module):
    """``output_linear(silu(gate) * up)``, ``[gate | up] = input_linear
    h``: the shared MLP, and each held expert."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.input_linear = _Linear(d, 2 * width)
        self.output_linear = _Linear(width, d)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        gate, up = self.input_linear(h).chunk(2, dim=-1)
        return self.output_linear(F.silu(gate) * up)

    def in_weights(self):
        """As a held expert (``models/moe.py``): [gate; up]'s rows."""
        return (self.input_linear.weight,)

    def out_weight(self) -> torch.Tensor:
        return self.output_linear.weight


class TopKRouter(nn.Module):
    """float32 logits over every expert, the top k, a softmax over them."""

    def __init__(self, cfg: GraniteHConfig):
        super().__init__()
        self.top_k = cfg.num_experts_per_tok
        self.layer = _Linear(cfg.hidden_size, cfg.num_local_experts)

    def forward(self, h: torch.Tensor):
        """h [T, d] -> (weights [T, k] float32, experts [T, k], logits
        [T, E] float32)."""
        with torch.autocast(device_type=h.device.type, enabled=False):
            logits = F.linear(h.float(), self.layer.weight.float())
        top, idx = torch.topk(logits, k=self.top_k, dim=-1)
        return torch.softmax(top, dim=-1), idx, logits


class MoE(nn.Module):
    """The held experts' part of the routed output (``block_sparse_moe``),
    and in training each expert's picks and summed probability over the
    real tokens, for the balance loss."""

    def __init__(self, cfg: GraniteHConfig):
        super().__init__()
        self.experts = HeldExperts(
            cfg.experts_held,
            lambda: GatedMLP(cfg.hidden_size, cfg.intermediate_size),
            cfg.num_local_experts)
        self.router = TopKRouter(cfg)
        self.combine = Combine()

    def forward(self, flat: torch.Tensor, keep: torch.Tensor):
        """flat [T, d], keep [T] (1 for a real token) -> (float32 [T, d],
        (picks [E], probabilities [E]) or None)."""
        with profiling.span("creamfl.moe.route"):
            weights, idx, logits = self.router(flat)
            order, ends, valid, sorted_row = self.experts.plan(idx)
            profiling.tally("moe.held_pairs", ends[-1])
            stats = None
            if self.training and torch.is_grad_enabled():
                w = keep.float()
                picks = torch.zeros_like(logits[0]).scatter_add(
                    0, idx.reshape(-1), w[:, None].expand_as(idx).reshape(-1))
                probs = (logits.softmax(dim=-1) * w[:, None]).sum(0)
                stats = (picks, probs)
        with profiling.span("creamfl.moe.experts"):
            y = self.experts(flat, order, ends, valid)
        with profiling.span("creamfl.moe.combine"):
            return self.combine(y, sorted_row, weights), stats


class DecoderLayer(nn.Module):
    def __init__(self, cfg: GraniteHConfig, kind: str):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(d, eps)
        self.post_attention_layernorm = RMSNorm(d, eps)
        if kind == "mamba":
            self.mamba = MambaMixer(cfg)
        elif kind == "attention":
            self.self_attn = Attention(cfg)
        else:
            raise ValueError(f"layer type {kind!r}: mamba or attention")
        self.block_sparse_moe = MoE(cfg)
        self.shared_mlp = GatedMLP(d, cfg.shared_intermediate_size)
        self.residual = cfg.residual_multiplier

    def forward(self, x, mask, bias):
        h = self.input_layernorm(x)
        if hasattr(self, "mamba"):
            h = self.mamba(h, mask)
        else:
            h = self.self_attn(h, bias)
        x = x + h * self.residual
        h = self.post_attention_layernorm(x)
        b, l, d = h.shape
        flat = h.reshape(b * l, d)
        out, stats = self.block_sparse_moe(flat, mask.reshape(-1))
        with profiling.span("creamfl.moe.combine"):
            out = out + self.shared_mlp(flat)
        return x + out.view(b, l, d) * self.residual, stats


class GraniteHModel(nn.Module):
    """ids [B, L] + mask [B, L] -> (final hidden states [B, L, d] float32,
    the balance loss, or None outside training)."""

    def __init__(self, cfg: GraniteHConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = _Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, k) for k in cfg.kinds)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        cfg = self.config
        b, l = ids.shape
        h = self.embed_tokens(ids) * cfg.embedding_multiplier
        causal = torch.ones(l, l, dtype=torch.bool, device=ids.device).tril()
        allowed = causal[None] & (mask[:, None, :] > 0)
        bias = torch.where(allowed, 0.0, -1e9)[:, None]  # [B, 1, Lq, Lk]
        picks = probs = None
        for layer in self.layers:
            h, stats = layer(h, mask, bias)
            if stats is not None:
                picks = stats[0] if picks is None else picks + stats[0]
                probs = stats[1] if probs is None else probs + stats[1]
        return self.norm(h), balance_loss(cfg, picks, probs, mask)


def balance_loss(cfg: GraniteHConfig, picks: Optional[torch.Tensor],
                 probs: Optional[torch.Tensor], mask: torch.Tensor):
    """``coef * E * sum_e f_e P_e`` of the picks and probabilities summed
    over the layers and the real tokens (None without them)."""
    if picks is None:
        return None
    n = mask.sum().float() * len(cfg.kinds)
    return (cfg.router_aux_loss_coef * cfg.num_local_experts
            * (picks / n * (probs / n)).sum())


def init_granite_h(module: nn.Module, generator: torch.Generator) -> None:
    """Weights in module order from ``generator``: normal(0,
    ``initializer_range``) for the projections, the convolutions and the
    embedding (zero biases), ones for the norms; each mixer's ``dt_bias``
    and ``D`` ones and ``A_log`` ``log(1..heads)``, as ``transformers``'
    ``_init_weights`` sets them."""
    std = next((m.config.initializer_range for m in module.modules()
                if isinstance(m, GraniteHModel)), 0.02)
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, nn.Conv1d)):
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (RMSNorm, GatedRMSNorm)):
            nn.init.ones_(m.weight)
        elif isinstance(m, MambaMixer):
            with torch.no_grad():
                m.dt_bias.fill_(1.0)
                m.D.fill_(1.0)
                m.A_log.copy_(torch.log(torch.arange(
                    1, m.heads + 1, dtype=torch.float32)))
