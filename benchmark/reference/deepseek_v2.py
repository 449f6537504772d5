"""DeepSeek-V2-Lite as the server's text tower, in plain PyTorch (float32,
TF32 off): the published model (huggingface.co/deepseek-ai/DeepSeek-V2-Lite,
``config.json`` and ``modeling_deepseek.py``) with no kernel, no cache and
no batching of the experts. It imports nothing of the port; its module
names, the order modules are made in and the initializers are the port's
(``models/deepseek_v2.py``, ``models/pcme.py``), so the same seed gives the
same weights and a leaf is compared with the port's leaf of the same name.

Two oracles share this file: the benchmark's check, and the port's CPU tests
(``tests/test_torch_deepseek_v2.py`` imports it, with ``reference.models``'
``Quant`` and ``reference.train``'s ``AdamP``, through ``sys.path``). An
edit here changes what both hold the port to.

A layer is ``x += MLA(RMSNorm(x)); x += FFN(RMSNorm(x))``: RMSNorm in
float32 (eps ``rms_norm_eps``); layer 0's FFN a dense gated SiLU MLP, the
others MoE; a final RMSNorm; causal attention with the pad keys masked.
MLA: ``q_proj`` -> per head ``[q_nope | q_pe]``; ``kv_a_proj_with_mqa`` ->
``[c_kv | k_pe]`` (``k_pe`` one head for all); ``kv_b_proj(RMSNorm(c_kv))``
-> per head ``[k_nope | v]``; RoPE on ``q_pe`` and ``k_pe`` after the pair
permutation, YaRN frequencies; scores times ``q_head_dim^-0.5 mscale^2``,
softmax, ``o_proj``. MoE: float32 router logits over all experts, softmax,
greedy top-k (weights unnormalised); each held expert's gated SiLU MLP on
the tokens routed to it (found on the host), weighted and summed, plus the
shared experts; the sequence-level balance loss ``alpha * mean_b sum_e
ce[b, e] * mean_t p[b, t, e]`` over every position, pads included.

Departures from the published model, each also the port's:

- pooling: the final hidden state at each caption's last real token (its
  EOS) -> float32 -> linear -> L2 norm (position 0 of a causal tower sees
  nothing; PCME's BERT pools there);
- the held share: each MoE layer holds the experts ``experts_held`` and
  routes over all of them; the absent experts add nothing;
- the depth: ``num_layers`` of the published 27 (the first pipeline stage).

``fault`` (what the check must catch): "no_routed" leaves the routed
experts' output out; "held_topk" takes the top-k over the held experts
only. ``Quant`` on (the control): the projections, the attention's
products and the experts' products in float8 (``reference.models``), the
router in float32 as configured.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init

from reference.models import Conv2d, Linear, Quant, _compute, l2_normalize


def _linear(d_in: int, d_out: int) -> Linear:
    return skip_init(Linear, d_in, d_out, bias=False)


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_range(cfg: Dict):
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rs = cfg["rope_scaling"]

    def at(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi)) / (2 * math.log(base)))

    return (max(math.floor(at(rs["beta_fast"])), 0),
            min(math.ceil(at(rs["beta_slow"])), dim - 1))


def yarn_inv_freq(cfg: Dict) -> torch.Tensor:
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    factor = cfg["rope_scaling"]["factor"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (factor * base ** exps)
    low, high = yarn_range(cfg)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    return inter * ramp + extra * (1 - ramp)


def softmax_scale(cfg: Dict) -> float:
    rs = cfg["rope_scaling"]
    m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B, L, n, d]: pairs (2i, 2i+1) to halves, then rotate-half."""
    b, l, n, d = x.shape
    x = x.view(b, l, n, d // 2, 2).transpose(-1, -2).reshape(b, l, n, d)
    c, s = cos[:, None, :].to(x.dtype), sin[:, None, :].to(x.dtype)
    rot = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * c + rot * s


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


class MLP(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = _linear(d, width)
        self.up_proj = _linear(d, width)
        self.down_proj = _linear(width, d)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class Attention(nn.Module):
    def __init__(self, cfg: Dict, quant: Quant):
        super().__init__()
        d, nh = cfg["hidden_size"], cfg["num_attention_heads"]
        self.nh, self.quant = nh, quant
        self.nope, self.rope = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        self.vd, self.latent = cfg["v_head_dim"], cfg["kv_lora_rank"]
        self.q_proj = _linear(d, nh * (self.nope + self.rope))
        self.kv_a_proj_with_mqa = _linear(d, self.latent + self.rope)
        self.kv_a_layernorm = RMSNorm(self.latent, cfg["rms_norm_eps"])
        self.kv_b_proj = _linear(self.latent, nh * (self.nope + self.vd))
        self.o_proj = _linear(nh * self.vd, d)
        self.scale = softmax_scale(cfg)

    def forward(self, h, cos, sin, bias):
        b, l, _ = h.shape
        nh, q8 = self.nh, self.quant
        q_nope, q_pe = self.q_proj(h).view(b, l, nh, -1).split(
            [self.nope, self.rope], dim=-1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(h).split(
            [self.latent, self.rope], dim=-1)
        k_nope, v = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(
            b, l, nh, -1).split([self.nope, self.vd], dim=-1)
        q = torch.cat((q_nope, rope(q_pe, cos, sin)), dim=-1)
        k_pe = rope(k_pe.reshape(b, l, 1, self.rope), cos, sin)
        k = torch.cat((k_nope, k_pe.expand(b, l, nh, self.rope)), dim=-1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q8(q), q8(k)) * self.scale
        probs = torch.softmax(scores.float() + bias, dim=-1).to(v.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", q8(probs), q8(v))
        return self.o_proj(ctx.reshape(b, l, nh * self.vd))


class MoEGate(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg["n_routed_experts"],
                                               cfg["hidden_size"]))


class MoE(nn.Module):
    """The held experts' part of the routed output plus the shared
    experts', and the balance loss (training)."""

    def __init__(self, cfg: Dict, held, fault: Optional[str] = None):
        super().__init__()
        self.held = sorted(held)
        self.experts = nn.ModuleDict({
            str(e): MLP(cfg["hidden_size"], cfg["moe_intermediate_size"])
            for e in self.held})
        self.gate = MoEGate(cfg)
        self.shared_experts = MLP(cfg["hidden_size"],
                                  cfg["moe_intermediate_size"]
                                  * cfg["n_shared_experts"])
        self.top_k = cfg["num_experts_per_tok"]
        self.alpha = cfg["aux_loss_alpha"]
        self.fault = fault

    def forward(self, h):
        b, l, d = h.shape
        flat = h.reshape(b * l, d)
        with torch.autocast(device_type=h.device.type, enabled=False):
            logits = flat.float() @ self.gate.weight.float().T
        scores = torch.softmax(logits, dim=-1)
        if self.fault == "held_topk":
            held = torch.zeros(scores.shape[-1], dtype=torch.bool,
                               device=h.device)
            held[self.held] = True
            idx = torch.topk(scores.masked_fill(~held, -1.0), self.top_k,
                             dim=-1).indices
            weights = scores.gather(1, idx)
        else:
            weights, idx = torch.topk(scores, self.top_k, dim=-1)
        aux = None
        if self.training and torch.is_grad_enabled():
            n = scores.shape[-1]
            ce = torch.zeros(b, n, device=h.device).scatter_add_(
                1, idx.view(b, -1), torch.ones(b, l * self.top_k,
                                               device=h.device))
            ce = ce / (l * self.top_k / n)
            aux = (ce * scores.view(b, l, n).mean(1)).sum(1).mean() \
                * self.alpha
        routed = torch.zeros(b * l, d, device=h.device)
        if self.fault != "no_routed":
            for e in self.held:
                rows, slot = (idx == e).nonzero(as_tuple=True)
                if rows.numel():
                    out = self.experts[str(e)](flat[rows]).float()
                    routed = routed.index_add(
                        0, rows, out * weights[rows, slot, None])
        out = routed + self.shared_experts(flat)
        return out.view(b, l, d), aux


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Dict, index: int, quant: Quant,
                 fault: Optional[str]):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.self_attn = Attention(cfg, quant)
        self.mlp = (MLP(d, cfg["intermediate_size"])
                    if index < cfg["first_k_dense_replace"]
                    else MoE(cfg, cfg["experts_held"], fault))
        self.input_layernorm = RMSNorm(d, eps)
        self.post_attention_layernorm = RMSNorm(d, eps)

    def forward(self, x, cos, sin, bias):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, bias)
        out = self.mlp(self.post_attention_layernorm(x))
        aux = None
        if isinstance(out, tuple):
            out, aux = out
        return x + out, aux


class DeepseekV2Model(nn.Module):
    def __init__(self, cfg: Dict, quant: Quant, fault: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = skip_init(nn.Embedding, cfg["vocab_size"],
                                      cfg["hidden_size"])
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, i, quant, fault)
            for i in range(cfg["num_layers"]))
        self.norm = RMSNorm(cfg["hidden_size"], cfg["rms_norm_eps"])
        self.register_buffer("inv_freq", yarn_inv_freq(cfg),
                             persistent=False)

    def forward(self, ids, mask):
        b, l = ids.shape
        h = self.embed_tokens(ids)
        causal = torch.ones(l, l, dtype=torch.bool, device=ids.device).tril()
        bias = torch.where(causal[None] & (mask[:, None, :] > 0), 0.0,
                           -1e9)[:, None]
        t = torch.arange(l, dtype=torch.float32, device=ids.device)
        emb = torch.outer(t, self.inv_freq)
        emb = torch.cat((emb, emb), dim=-1)
        rs = self.cfg["rope_scaling"]
        m = (yarn_mscale(rs["factor"], rs["mscale"])
             / yarn_mscale(rs["factor"], rs["mscale_all_dim"]))
        cos, sin = emb.cos() * m, emb.sin() * m
        aux = None
        for layer in self.layers:
            h, a = layer(h, cos, sin, bias)
            if a is not None:
                aux = a if aux is None else aux + a
        return self.norm(h), aux


class TextEncoderDeepseekV2(nn.Module):
    low = False  # the control: the tower under bf16 autocast, as the port

    def __init__(self, embed_dim: int, cfg: Dict, quant: Quant,
                 fault: Optional[str] = None):
        super().__init__()
        self.model = DeepseekV2Model(cfg, quant, fault)
        self.linear = nn.Linear(cfg["hidden_size"], embed_dim)

    def forward(self, ids, mask):
        """-> (L2-normed embedding [B, E], the balance loss or None)."""
        with _compute(self.low, ids.device):
            hidden, aux = self.model(ids, mask)
        last = mask.sum(-1).long() - 1
        pooled = hidden[torch.arange(ids.shape[0], device=ids.device),
                        last].float()
        return l2_normalize(self.linear(pooled)), aux


def quantize(module: nn.Module, quant: Quant) -> None:
    """The control's rounding on every convolution and projection of
    ``module``."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.quant = quant


def init_deepseek_v2(module: nn.Module, g: torch.Generator,
                     std: float = 0.02) -> None:
    """The port's ``init_deepseek_v2``, frozen."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.normal_(m.weight, 0.0, std, generator=g)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, RMSNorm):
            nn.init.ones_(m.weight)
        elif isinstance(m, MoEGate):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=g)
