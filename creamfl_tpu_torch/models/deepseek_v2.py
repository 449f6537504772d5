"""DeepSeek-V2-Lite as a text tower: latent attention (MLA) and a routed
mixture of experts, of which this process holds a share.

The published model (huggingface.co/deepseek-ai/DeepSeek-V2-Lite,
``config.json`` and ``modeling_deepseek.py``), with HuggingFace's parameter
names (``model.embed_tokens``, ``model.layers.<i>.self_attn.q_proj``,
``model.layers.<i>.mlp.experts.<e>.gate_proj``, ``...mlp.gate.weight``,
``...mlp.shared_experts``, ``model.norm``), so that a slice of the published
checkpoint loads by name. A layer is

    x += MLA(RMSNorm(x));  x += FFN(RMSNorm(x))

RMSNorm in float32 (eps 1e-6). Layer 0's FFN is dense, a gated SiLU MLP
``down(silu(gate h) * up h)`` of width 10 944; the layers after it are MoE.
A final RMSNorm closes the tower. The tower is causal, as published, and
the pad keys are masked as well.

MLA (no query compression, 16 heads): ``q = q_proj h`` gives each head
``[q_nope 128 | q_pe 64]``; ``kv_a_proj_with_mqa h = [c_kv 512 | k_pe 64]``,
``k_pe`` one head shared by all; ``kv_b_proj RMSNorm(c_kv)`` gives each head
``[k_nope 128 | v 128]``. RoPE rotates ``q_pe`` and ``k_pe`` after the
published pair permutation (``view(..., 32, 2).transpose(-1, -2)``, then
rotate-half), with YaRN's frequencies (``yarn_inv_freq``). The scores are
``[q_nope|q_pe] . [k_nope|k_pe]`` times ``192^-0.5 * mscale^2``, the softmax
in float32, then ``o_proj``.

MoE (``MoE``): the router's logits in float32 over all 64 experts, softmax,
greedy top-6 (weights not renormalised, scale 1); the output is
``sum_k w_k Expert_{idx_k}(h) + Shared(h)``, each expert a gated SiLU MLP of
width 1 408, ``Shared`` one of width 2 x 1 408. The sequence-level balance
loss (``seq_aux``) is computed in training and returned beside the hidden
states; the server adds it to its loss.

The layer holds the experts ``experts_held`` of the config and routes over
all of them (``models/moe.py``'s ``HeldExperts`` and ``Combine``, which the
Granite-4.0-H tower shares): its routed part is what the held experts give
for the pairs routed to them, and the absent experts add nothing. The
routing plan is made on the device, with no count read to the host, and
one grouped product a projection computes the held groups.

Compute dtype: the weights are float32; under the PCME encoder's bf16
autocast the projections and the grouped products run in bf16, the router,
the norms, the softmax and the combination of the experts in float32.

Spans (``utils/profiling.py``): ``creamfl.mla.attend`` (the scores, the
softmax and the values), ``creamfl.moe.route`` (router, top-k, sort and
group ends), ``creamfl.moe.experts`` (the held experts' products) and
``creamfl.moe.combine`` (the weighted combination and the shared experts).
While the recorder is on, each MoE layer adds its held pairs to the device
tally ``moe.held_pairs`` (read when the recording closes).

Weights: ``init_deepseek_v2`` draws them (normal(0, 0.02) for the
projections and the embedding, ones for the norms, the router as published:
kaiming-uniform); the modules allocate them uninitialised.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from creamfl_tpu_torch.models.moe import Combine, HeldExperts
from creamfl_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The published widths, and the cut held here: 14 of the 27 layers
    (the first pipeline stage of two) and experts 0-7 of each layer's 64
    (one card of eight-way expert parallelism)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 14
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    n_routed_experts: int = 64
    experts_held: Tuple[int, ...] = tuple(range(8))
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    aux_loss_alpha: float = 0.001
    initializer_range: float = 0.02
    bos_token_id: int = 100000
    eos_token_id: int = 100001

    @classmethod
    def tiny(cls) -> "DeepseekV2Config":
        """Small config for tests / CPU smoke runs: 1 dense + 2 MoE layers,
        8 of 16 experts held, top-4."""
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   moe_intermediate_size=48, num_hidden_layers=3,
                   num_attention_heads=4, kv_lora_rank=32,
                   qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
                   n_routed_experts=16, num_experts_per_tok=4,
                   bos_token_id=500, eos_token_id=501)

    @property
    def moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace


# -- YaRN ------------------------------------------------------------------
def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_range(cfg: DeepseekV2Config) -> Tuple[int, int]:
    """(low, high): the rotary dimensions from which the frequencies are
    interpolated, and up to which they are ramped."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def at(rotations: float) -> float:
        return (dim * math.log(cfg.rope_original_max_position
                               / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = math.floor(at(cfg.rope_beta_fast))
    high = math.ceil(at(cfg.rope_beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_inv_freq(cfg: DeepseekV2Config) -> torch.Tensor:
    """[dim / 2] float32: ``f_inter * ramp + f_extra * (1 - ramp)``."""
    dim = cfg.qk_rope_head_dim
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (cfg.rope_theta ** exps)
    inter = 1.0 / (cfg.rope_factor * cfg.rope_theta ** exps)
    low, high = yarn_correction_range(cfg)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """``q_head_dim^-0.5 * mscale(factor, mscale_all_dim)^2``."""
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def rotary(inv_freq: torch.Tensor, length: int, cfg: DeepseekV2Config):
    """(cos, sin) [length, dim] float32 of positions 0..length-1, scaled
    by ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``."""
    t = torch.arange(length, dtype=torch.float32, device=inv_freq.device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return emb.cos() * m, emb.sin() * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [B, L, n, d]: the published pair permutation, then rotate-half
    with cos / sin [L, d] (cast to x's dtype)."""
    b, l, n, d = x.shape
    x = x.view(b, l, n, d // 2, 2).transpose(-1, -2).reshape(b, l, n, d)
    c, s = cos[:, None, :].to(x.dtype), sin[:, None, :].to(x.dtype)
    rot = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * c + rot * s


# -- modules ---------------------------------------------------------------
class _Linear(nn.Linear):
    """A projection without bias whose weight ``init_deepseek_v2`` draws
    (none is drawn at construction: the tower has 1.6 B weights)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(d_in, d_out, bias=False)

    def reset_parameters(self) -> None:
        pass


class _Embedding(nn.Embedding):
    def reset_parameters(self) -> None:
        pass


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


class MLP(nn.Module):
    """``down_proj(silu(gate_proj h) * up_proj h)``."""

    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = _Linear(d, width)
        self.up_proj = _Linear(d, width)
        self.down_proj = _Linear(width, d)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))

    def in_weights(self):
        """As a held expert (``models/moe.py``): [gate; up]'s rows."""
        return self.gate_proj.weight, self.up_proj.weight

    def out_weight(self) -> torch.Tensor:
        return self.down_proj.weight


class Attention(nn.Module):
    """MLA without query compression (module docstring)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        d, heads = cfg.hidden_size, cfg.num_attention_heads
        self.heads = heads
        self.nope, self.rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.v_dim, self.latent = cfg.v_head_dim, cfg.kv_lora_rank
        self.q_proj = _Linear(d, heads * (self.nope + self.rope))
        self.kv_a_proj_with_mqa = _Linear(d, self.latent + self.rope)
        self.kv_a_layernorm = RMSNorm(self.latent, cfg.rms_norm_eps)
        self.kv_b_proj = _Linear(self.latent, heads * (self.nope + self.v_dim))
        self.o_proj = _Linear(heads * self.v_dim, d)
        self.scale = softmax_scale(cfg)

    def forward(self, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
        b, l, _ = h.shape
        nh = self.heads
        q = self.q_proj(h).view(b, l, nh, self.nope + self.rope)
        q_nope, q_pe = q.split([self.nope, self.rope], dim=-1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(h).split(
            [self.latent, self.rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(
            b, l, nh, self.nope + self.v_dim)
        k_nope, v = kv.split([self.nope, self.v_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe.reshape(b, l, 1, self.rope), cos, sin)
        q = torch.cat((q_nope, q_pe), dim=-1)
        k = torch.cat((k_nope, k_pe.expand(b, l, nh, self.rope)), dim=-1)
        with profiling.span("creamfl.mla.attend"):
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale
            probs = torch.softmax(scores.float() + bias, dim=-1).to(v.dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.o_proj(ctx.reshape(b, l, nh * self.v_dim))


class MoEGate(nn.Module):
    """The router: float32 logits over every expert, softmax, greedy
    top-k; in training, the sequence-level balance loss."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.top_k = cfg.num_experts_per_tok
        self.n_experts = cfg.n_routed_experts
        self.alpha = cfg.aux_loss_alpha
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts,
                                               cfg.hidden_size))

    def forward(self, h: torch.Tensor, batch: int):
        """h [T, d] (T = batch x length) -> (weights [T, k] float32,
        experts [T, k], the balance loss or None)."""
        with torch.autocast(device_type=h.device.type, enabled=False):
            logits = F.linear(h.float(), self.weight.float())
        scores = logits.softmax(dim=-1, dtype=torch.float32)
        weights, idx = torch.topk(scores, k=self.top_k, dim=-1, sorted=False)
        aux = None
        if self.training and self.alpha > 0 and torch.is_grad_enabled():
            length = h.shape[0] // batch
            picks = length * self.top_k
            ce = torch.zeros(batch, self.n_experts, device=h.device)
            ce.scatter_add_(1, idx.view(batch, picks),
                            torch.ones(batch, picks, device=h.device))
            ce = ce / (picks / self.n_experts)
            mean_p = scores.view(batch, length, -1).mean(dim=1)
            aux = (ce * mean_p).sum(dim=1).mean() * self.alpha
        return weights, idx, aux


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.experts = HeldExperts(
            cfg.experts_held,
            lambda: MLP(cfg.hidden_size, cfg.moe_intermediate_size),
            cfg.n_routed_experts)
        self.gate = MoEGate(cfg)
        self.shared_experts = MLP(cfg.hidden_size, cfg.moe_intermediate_size
                                  * cfg.n_shared_experts)
        self.combine = Combine()

    def forward(self, h: torch.Tensor):
        """h [B, L, d] -> (float32 [B, L, d], balance loss or None)."""
        b, l, d = h.shape
        flat = h.reshape(b * l, d)
        with profiling.span("creamfl.moe.route"):
            weights, idx, aux = self.gate(flat, b)
            order, ends, valid, sorted_row = self.experts.plan(idx)
            profiling.tally("moe.held_pairs", ends[-1])
        with profiling.span("creamfl.moe.experts"):
            y = self.experts(flat, order, ends, valid)
        with profiling.span("creamfl.moe.combine"):
            out = self.combine(y, sorted_row, weights)
            out = out + self.shared_experts(flat)
        return out.view(b, l, d), aux


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, index: int):
        super().__init__()
        self.self_attn = Attention(cfg)
        self.mlp = (MLP(cfg.hidden_size, cfg.intermediate_size)
                    if index < cfg.first_k_dense_replace else MoE(cfg))
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)

    def forward(self, x, cos, sin, bias):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, bias)
        out = self.mlp(self.post_attention_layernorm(x))
        aux = None
        if isinstance(out, tuple):
            out, aux = out
        return x + out, aux


class DeepseekV2Model(nn.Module):
    """ids [B, L] + mask [B, L] -> (final hidden states [B, L, d] float32,
    the layers' balance losses summed, or None outside training)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.config = cfg
        self.embed_tokens = _Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.register_buffer("inv_freq", yarn_inv_freq(cfg), persistent=False)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        b, l = ids.shape
        h = self.embed_tokens(ids)
        causal = torch.ones(l, l, dtype=torch.bool, device=ids.device).tril()
        allowed = causal[None] & (mask[:, None, :] > 0)
        bias = torch.where(allowed, 0.0, -1e9)[:, None]  # [B, 1, Lq, Lk]
        cos, sin = rotary(self.inv_freq, l, self.config)
        aux = None
        for layer in self.layers:
            h, a = layer(h, cos, sin, bias)
            if a is not None:
                aux = a if aux is None else aux + a
        return self.norm(h), aux


def init_deepseek_v2(module: nn.Module, generator: torch.Generator) -> None:
    """Weights in module order from ``generator``: normal(0,
    ``initializer_range``) for the projections and the embedding (zero
    biases), ones for the norms, the routers kaiming-uniform as published
    (``MoEGate.reset_parameters``)."""
    std = next((m.config.initializer_range for m in module.modules()
                if isinstance(m, DeepseekV2Model)), 0.02)
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.normal_(m.weight, 0.0, std, generator=generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, RMSNorm):
            nn.init.ones_(m.weight)
        elif isinstance(m, MoEGate):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)

