"""Granite-4.0-H-Small as the server's text tower, in plain PyTorch (float32,
TF32 off): the published model (huggingface.co/ibm-granite/
granite-4.0-h-small, ``config.json``; the layer equations of
``transformers``' ``modeling_granitemoehybrid.py``) with no kernel, no
cache and no batching of the experts. It imports nothing of the port; its
module names, the order modules are made in and the initializers are the
port's (``models/granite_h.py``, ``models/pcme.py``), so the same seed
gives the same weights and a leaf is compared with the port's leaf of the
same name.

Two oracles share this file: the benchmark's check, and the port's CPU tests
(``tests/test_torch_granite_h.py`` imports it through ``sys.path``). An
edit here changes what both hold the port to.

The embedding times ``embedding_multiplier``; a layer is ``x += r *
Mixer(RMSNorm(x)); x += r * (MoE(h) + SharedMLP(h))`` with ``h =
RMSNorm(x)`` and ``r = residual_multiplier``, the mixer Mamba-2 or
attention as ``layer_types`` says; a final RMSNorm. RMSNorm in float32.

Mamba-2: ``in_proj -> [z | xBC | dt]``; xBC through the causal depthwise
conv1d and SiLU, the pads zeroed before the mixer and after the conv;
``[x | B | C]``; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the
state **token by token**, ``h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T``,
``y_t = h_t C_t + D x_t`` (``ssm_tokens``: another algorithm than the
port's chunked one); ``out_proj(RMSNorm(y * silu(z)))`` over all channels.
Attention: every query head against its key-value head, explicit scores
``q k^T * attention_multiplier``, causal with the pad keys masked, softmax,
values, ``o_proj``. MoE: float32 router logits, the top k, a softmax over
them; each held expert's gated SiLU MLP on the tokens routed to it (found
on the host), weighted and added with ``index_add``; the shared MLP; the
Switch-style balance loss of ``load_balancing_loss_func`` over every
layer's router and the real tokens, times ``router_aux_loss_coef``.

Departures from the published model, each also the port's:

- pooling: the final hidden state at each caption's last real token (its
  EOS) -> float32 -> linear -> L2 norm (no LM head, so neither
  ``logits_scaling`` nor the tied embedding is used);
- the held share: each layer holds the experts ``experts_held`` and routes
  over all ``num_local_experts``; the absent experts add nothing;
- the depth: the first ``num_layers`` of the published ``layer_types``;
- the experts' weights one leaf an expert and a projection (the published
  ``input_linear`` / ``output_linear`` hold all 72 in one tensor each);
- the router's gates (the softmax over the top k) stay float32 (the
  published code casts them to the hidden states' dtype).

Memory, not arithmetic: each decoder layer, and the scan of each block of
``SCAN_ROWS`` captions, is recomputed in the backward
(``torch.utils.checkpoint``), so that the token-by-token states of a
4 096-token batch fit beside the trunk; the recomputation repeats the same
operations.

``fault`` (what the check must catch): "dt_unbiased" leaves ``dt_bias``
out of the step size; "norm_ungated" leaves the ``silu(z)`` gate out of
the mixer's norm. ``Quant`` on (the float8 control): the projections, the
attention's products and the experts' products in float8; ``scan`` "bf16"
(a control): the token-by-token state and its products in bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.nn.utils import skip_init
from torch.utils.checkpoint import checkpoint

from reference.models import Linear, Quant, _compute, l2_normalize

SCAN_ROWS = 16


def _linear(d_in: int, d_out: int) -> Linear:
    return skip_init(Linear, d_in, d_out, bias=False)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


class GatedRMSNorm(RMSNorm):
    def forward(self, y, z=None):
        h = y.float()
        if z is not None:
            h = h * F.silu(z.float())
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(y.dtype)


def ssm_tokens(x, dt, a, b, c, dtype=torch.float32):
    """The recurrence one token at a time: x [B, L, H, P], dt [B, L, H],
    a [H], b and c [B, L, H, N] -> y [B, L, H, P] (float32) without the
    skip term; the state and its products in ``dtype``."""
    x, dt, b, c = (t.to(dtype) for t in (x, dt, b, c))
    bsz, length, heads, p = x.shape
    h = torch.zeros(bsz, heads, p, b.shape[-1], dtype=dtype,
                    device=x.device)
    ys = []
    for t in range(length):
        decay = torch.exp(dt[:, t] * a.to(dtype))  # [B, H]
        h = (decay[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * b[:, t, :, None])
        ys.append((h @ c[:, t, :, :, None])[..., 0])
    return torch.stack(ys, 1).float()


def _scan_rows(x, dt, a, b, c, dtype):
    """``ssm_tokens`` over blocks of ``SCAN_ROWS`` captions, each block's
    states recomputed in the backward."""
    out = []
    for r in range(0, x.shape[0], SCAN_ROWS):
        rows = slice(r, r + SCAN_ROWS)
        out.append(checkpoint(ssm_tokens, x[rows], dt[rows], a, b[rows],
                              c[rows], dtype, use_reentrant=False))
    return torch.cat(out, 0)


class Mamba(nn.Module):
    def __init__(self, cfg: Dict, fault: Optional[str], scan: str):
        super().__init__()
        d = cfg["hidden_size"]
        self.heads, self.head_dim = cfg["mamba_n_heads"], cfg["mamba_d_head"]
        self.inner = self.heads * self.head_dim
        self.groups, self.state = cfg["mamba_n_groups"], cfg["mamba_d_state"]
        self.conv_dim = self.inner + 2 * self.groups * self.state
        k = cfg["mamba_d_conv"]
        self.in_proj = _linear(d, self.inner + self.conv_dim + self.heads)
        self.conv1d = skip_init(nn.Conv1d, self.conv_dim, self.conv_dim, k,
                                groups=self.conv_dim, padding=k - 1,
                                bias=cfg["mamba_conv_bias"])
        self.dt_bias = nn.Parameter(torch.ones(self.heads))
        self.A_log = nn.Parameter(torch.zeros(self.heads))
        self.D = nn.Parameter(torch.ones(self.heads))
        self.norm = GatedRMSNorm(self.inner, cfg["rms_norm_eps"])
        self.out_proj = _linear(self.inner, d)
        self.fault = fault
        self.scan_dtype = torch.bfloat16 if scan == "bf16" else torch.float32

    def forward(self, h, mask):
        bsz, length, _ = h.shape
        keep = mask[:, :, None].to(h.dtype)
        z, xbc, dt = self.in_proj(h * keep).split(
            [self.inner, self.conv_dim, self.heads], dim=-1)
        xbc = F.silu(self.conv1d(xbc.transpose(1, 2))[..., :length]
                     .transpose(1, 2))
        xbc = xbc * keep.to(xbc.dtype)
        with torch.autocast(device_type=h.device.type, enabled=False):
            x, b, c = xbc.float().split(
                [self.inner, self.groups * self.state,
                 self.groups * self.state], dim=-1)
            x = x.reshape(bsz, length, self.heads, self.head_dim)
            rep = self.heads // self.groups
            b, c = (t.reshape(bsz, length, self.groups, self.state)
                    .repeat_interleave(rep, dim=2) for t in (b, c))
            dt = dt.float()
            if self.fault != "dt_unbiased":
                dt = dt + self.dt_bias
            dt = F.softplus(dt)
            y = _scan_rows(x, dt, -torch.exp(self.A_log.float()), b, c,
                           self.scan_dtype)
            y = (y + x * self.D[:, None]).reshape(bsz, length, self.inner)
        y = self.norm(y, None if self.fault == "norm_ungated" else z)
        return self.out_proj(y)


class Attention(nn.Module):
    def __init__(self, cfg: Dict, quant: Quant):
        super().__init__()
        d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        self.heads, self.kv = heads, cfg["num_key_value_heads"]
        self.hd = d // heads
        self.q_proj = _linear(d, heads * self.hd)
        self.k_proj = _linear(d, self.kv * self.hd)
        self.v_proj = _linear(d, self.kv * self.hd)
        self.o_proj = _linear(heads * self.hd, d)
        self.scale = cfg["attention_multiplier"]
        self.quant = quant

    def forward(self, h, allowed):
        b, l, _ = h.shape
        q8 = self.quant
        q = self.q_proj(h).view(b, l, self.heads, self.hd).transpose(1, 2)
        k = self.k_proj(h).view(b, l, self.kv, self.hd).transpose(1, 2)
        v = self.v_proj(h).view(b, l, self.kv, self.hd).transpose(1, 2)
        rep = self.heads // self.kv
        k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
        scores = (q8(q) @ q8(k).transpose(-1, -2)) * self.scale
        scores = scores.float().masked_fill(~allowed[:, None], -math.inf)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        ctx = (q8(probs) @ q8(v)).transpose(1, 2)
        return self.o_proj(ctx.reshape(b, l, self.heads * self.hd))


class GatedMLP(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.input_linear = _linear(d, 2 * width)
        self.output_linear = _linear(width, d)

    def forward(self, h):
        gate, up = self.input_linear(h).chunk(2, dim=-1)
        return self.output_linear(F.silu(gate) * up)


class Router(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        self.layer = _linear(cfg["hidden_size"], cfg["num_local_experts"])


class MoE(nn.Module):
    """The held experts' part of the routed output, and each expert's
    picks and summed probability over the real tokens (training)."""

    def __init__(self, cfg: Dict, held):
        super().__init__()
        self.held = sorted(held)
        self.experts = nn.ModuleDict({
            str(e): GatedMLP(cfg["hidden_size"], cfg["intermediate_size"])
            for e in self.held})
        self.router = Router(cfg)
        self.top_k = cfg["num_experts_per_tok"]

    def forward(self, flat, keep):
        with torch.autocast(device_type=flat.device.type, enabled=False):
            logits = flat.float() @ self.router.layer.weight.float().T
        top, idx = torch.topk(logits, self.top_k, dim=-1)
        weights = torch.softmax(top, dim=-1)
        routed = torch.zeros(flat.shape, device=flat.device)
        for e in self.held:
            rows, slot = (idx == e).nonzero(as_tuple=True)
            if rows.numel():
                out = self.experts[str(e)](flat[rows]).float()
                routed = routed.index_add(0, rows,
                                          out * weights[rows, slot, None])
        w = keep.float()
        onehot = F.one_hot(idx, logits.shape[-1]).float().sum(1)
        picks = (onehot * w[:, None]).sum(0)
        probs = (torch.softmax(logits, dim=-1) * w[:, None]).sum(0)
        return routed, picks, probs


class DecoderLayer(nn.Module):
    def __init__(self, cfg: Dict, kind: str, quant: Quant,
                 fault: Optional[str], scan: str):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["rms_norm_eps"]
        self.input_layernorm = RMSNorm(d, eps)
        self.post_attention_layernorm = RMSNorm(d, eps)
        if kind == "mamba":
            self.mamba = Mamba(cfg, fault, scan)
        else:
            self.self_attn = Attention(cfg, quant)
        self.block_sparse_moe = MoE(cfg, cfg["experts_held"])
        self.shared_mlp = GatedMLP(d, cfg["shared_intermediate_size"])
        self.r = cfg["residual_multiplier"]

    def forward(self, x, mask, allowed):
        h = self.input_layernorm(x)
        h = (self.mamba(h, mask) if hasattr(self, "mamba")
             else self.self_attn(h, allowed))
        x = x + h * self.r
        h = self.post_attention_layernorm(x)
        b, l, d = h.shape
        flat = h.reshape(b * l, d)
        routed, picks, probs = self.block_sparse_moe(flat, mask.reshape(-1))
        out = routed + self.shared_mlp(flat)
        return x + out.view(b, l, d) * self.r, picks, probs


class GraniteHModel(nn.Module):
    def __init__(self, cfg: Dict, quant: Quant, fault: Optional[str] = None,
                 scan: str = "fp32"):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = skip_init(nn.Embedding, cfg["vocab_size"],
                                      cfg["hidden_size"])
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, quant, fault, scan)
            for kind in cfg["layer_types"][:cfg["num_layers"]])
        self.norm = RMSNorm(cfg["hidden_size"], cfg["rms_norm_eps"])

    def forward(self, ids, mask):
        """-> (final hidden states, the balance loss)."""
        cfg = self.cfg
        b, l = ids.shape
        h = self.embed_tokens(ids) * cfg["embedding_multiplier"]
        causal = torch.ones(l, l, dtype=torch.bool, device=ids.device).tril()
        allowed = causal[None] & (mask[:, None, :] > 0)
        picks = probs = 0.0
        for layer in self.layers:
            h, p, q = checkpoint(layer, h, mask, allowed,
                                 use_reentrant=False)
            picks, probs = picks + p, probs + q
        n = mask.sum().float() * len(self.layers)
        aux = (cfg["router_aux_loss_coef"] * cfg["num_local_experts"]
               * ((picks / n) * (probs / n)).sum())
        return self.norm(h), aux


class TextEncoderGraniteH(nn.Module):
    low = False  # the controls: the tower under bf16 autocast, as the port

    def __init__(self, embed_dim: int, cfg: Dict, quant: Quant,
                 fault: Optional[str] = None, scan: str = "fp32"):
        super().__init__()
        self.model = GraniteHModel(cfg, quant, fault, scan)
        self.linear = nn.Linear(cfg["hidden_size"], embed_dim)

    def forward(self, ids, mask):
        """-> (L2-normed embedding [B, E], the balance loss)."""
        with _compute(self.low, ids.device):
            hidden, aux = self.model(ids, mask)
        last = mask.sum(-1).long() - 1
        pooled = hidden[torch.arange(ids.shape[0], device=ids.device),
                        last].float()
        return l2_normalize(self.linear(pooled)), aux


def init_granite_h(module: nn.Module, g: torch.Generator,
                   std: float = 0.02) -> None:
    """The port's ``init_granite_h``, frozen."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding, nn.Conv1d)):
            nn.init.normal_(m.weight, 0.0, std, generator=g)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, RMSNorm):
            nn.init.ones_(m.weight)
        elif isinstance(m, Mamba):
            with torch.no_grad():
                m.dt_bias.fill_(1.0)
                m.D.fill_(1.0)
                m.A_log.copy_(torch.log(torch.arange(
                    1, m.heads + 1, dtype=torch.float32)))
