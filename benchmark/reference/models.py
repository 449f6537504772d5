"""PCME in plain PyTorch: the ResNet trunk, BERT, the PIE heads and the
joint model, with the port's initializers (frozen copies of the port's
``models/resnet.py``, ``models/bert.py``, ``models/pie.py`` and
``models/pcme.py``; its kernels and bf16 autocast left out).

Module and parameter names, and the order modules are made in, are the
port's: the initializers walk ``modules()`` and draw from one generator,
so the same seed gives the same weights, and a leaf is compared with the
port's leaf of the same name.

Dropout draws its keep mask with ``torch.rand`` of the whole tensor's
shape from the default generator of the tensor's device, in the forward's
order, as the port's ``row_dropout`` does: a reference seeded as the port's
round is seeded draws the port's masks.

``fp8``: the control (package docstring): the trunk and BERT run as the
port runs them, under bf16 autocast, and their convolutions and matrix
products as an fp8 training path runs them, each operand rounded to float8
e4m3 and each output gradient to e5m2, with a per-tensor scale.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` at the per-tensor scale that maps its
    largest magnitude to the format's largest, back in ``x``'s dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.detach().float() * scale).to(dtype).float() / scale).to(
        x.dtype)


def e4m3(x):
    return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)


def e5m2(x):
    return _fp8(x, torch.float8_e5m2, E5M2_MAX)


class _Fp8Linear(torch.autograd.Function):
    """``x @ w.T + b`` as an fp8 training path computes it: the forward on
    e4m3 operands, the backward's two products on the e5m2 output gradient
    and the same e4m3 operands (accumulated in float32)."""

    @staticmethod
    def forward(ctx, x, w, b):
        xq, wq = e4m3(x), e4m3(w)
        ctx.save_for_backward(xq, wq)
        ctx.has_bias = b is not None
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        g = e5m2(gy).float()
        gx = (g @ wq.float()).to(xq.dtype)
        gw = (g.reshape(-1, g.shape[-1]).T
              @ xq.float().reshape(-1, xq.shape[-1])).to(wq.dtype)
        gb = (gy.float().reshape(-1, gy.shape[-1]).sum(0)
              if ctx.has_bias else None)
        return gx, gw, gb


class _Fp8Conv(torch.autograd.Function):
    """A convolution as an fp8 training path computes it (as
    ``_Fp8Linear``)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        xq, wq = e4m3(x), e4m3(w)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding)
        return F.conv2d(xq, wq, None, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        stride, padding = ctx.conf
        g, x32, w32 = e5m2(gy).float(), xq.float(), wq.float()
        gx = torch.nn.grad.conv2d_input(x32.shape, w32, g, stride, padding)
        gw = torch.nn.grad.conv2d_weight(x32, w32.shape, g, stride, padding)
        return gx.to(xq.dtype), gw.to(wq.dtype), None, None


class _Fp8Round(torch.autograd.Function):
    """e4m3 rounding of an operand in the forward, e5m2 of its gradient in
    the backward (the attention's products)."""

    @staticmethod
    def forward(ctx, x):
        return e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return e5m2(g)


class Quant:
    """Where the control rounds: off for the reference."""

    def __init__(self, on: bool = False):
        self.on = on

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8Round.apply(x) if self.on else x


class Conv2d(nn.Conv2d):
    quant = Quant()

    def forward(self, x):
        if self.quant.on:
            return _Fp8Conv.apply(x, self.weight, self.stride, self.padding)
        return super().forward(x)


class Linear(nn.Linear):
    quant = Quant()

    def forward(self, x):
        if self.quant.on:
            return _Fp8Linear.apply(x, self.weight, self.bias)
        return super().forward(x)


class BatchNorm(nn.Module):
    """BatchNorm with the port's (flax's) running statistics: in train mode
    the batch's mean and biased variance normalise and move the running
    ones as ``0.9 * old + 0.1 * batch``; eval mode normalises with the
    running ones."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            dims = (0,) if x.dim() == 2 else (0, 2, 3)
            var, mean = torch.var_mean(x.float(), dim=dims, correction=0)
            self.running_mean.mul_(self.momentum).add_(
                mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=1 - self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def _conv(cin, cout, k, stride=1):
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, filters, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, filters, 3, stride)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3)
        self.bn2 = BatchNorm(filters)
        self.downsample = None
        if stride != 1 or cin != filters:
            self.downsample = nn.Sequential(_conv(cin, filters, 1, stride),
                                            BatchNorm(filters))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, filters, stride=1):
        super().__init__()
        cout = filters * 4
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters)
        self.conv3 = _conv(filters, cout, 1)
        self.bn3 = BatchNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            BatchNorm(cout))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return F.relu(y + r)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class ResNet(nn.Module):
    """NHWC [B, H, W, 3] -> NHWC grid [B, H/32, W/32, C]."""

    def __init__(self, block: str, stage_sizes: Sequence[int]):
        super().__init__()
        cls = BLOCKS[block]
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, n in enumerate(stage_sizes):
            blocks = []
            for b in range(n):
                blocks.append(cls(cin, 64 * 2 ** stage,
                                  2 if stage > 0 and b == 0 else 1))
                cin = 64 * 2 ** stage * cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.out_dim = cin

    def forward(self, images):
        x = self.conv1(images.permute(0, 3, 1, 2))
        x = self.maxpool(F.relu(self.bn1(x)))
        for s in range(self.n_stages):
            x = getattr(self, f"layer{s + 1}")(x)
        return x.permute(0, 2, 3, 1)


def _compute(low: bool, device):
    """The control's compute: bf16 autocast, as the port's bf16 encoders
    (``models/pcme.py:compute_dtype``); float32 for the reference."""
    import contextlib

    if not low:
        return contextlib.nullcontext()
    return torch.autocast(device_type=device.type, dtype=torch.bfloat16,
                          cache_enabled=False)


def l2_normalize(x, eps=1e-12):
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, n_head, d_in, d_hidden):
        super().__init__()
        self.n_head = n_head
        self.w_1 = nn.Linear(d_in, d_hidden, bias=False)
        self.w_2 = nn.Linear(d_hidden, n_head, bias=False)

    def forward(self, x, pad_mask=None):
        attn = self.w_2(torch.tanh(self.w_1(x)))
        if pad_mask is not None:
            attn = attn.masked_fill(pad_mask[:, :, None], -1e9)
        attn = torch.softmax(attn, dim=1)
        out = torch.einsum("blh,bld->bhd", attn, x)
        return out[:, 0, :], attn


class PIENet(nn.Module):
    def __init__(self, d_in, d_out, d_hidden):
        super().__init__()
        self.attention = MultiHeadSelfAttention(1, d_in, d_hidden)
        self.fc = nn.Linear(d_in, d_out)
        self.layer_norm = nn.LayerNorm(d_out, eps=1e-5)

    def forward(self, out, x, pad_mask=None):
        residual, _ = self.attention(x, pad_mask)
        residual = torch.sigmoid(self.fc(residual))
        return self.layer_norm(out + residual)


class ImageEncoder(nn.Module):
    def __init__(self, block, stage_sizes, embed_dim):
        super().__init__()
        self.cnn = ResNet(block, stage_sizes)
        d = self.cnn.out_dim
        self.fc = nn.Linear(d, embed_dim)
        self.pie_net = PIENet(d, embed_dim, d // 2)

    low = False  # the control: the trunk under bf16 autocast, as the port

    def forward(self, images):
        with _compute(self.low, images.device):
            grid = self.cnn(images)
        grid = grid.float()
        b, h, w, c = grid.shape
        out = self.fc(grid.mean(dim=(1, 2)))
        return l2_normalize(self.pie_net(out, grid.reshape(b, h * w, c)))


def row_dropout(x, p):
    keep = torch.rand(tuple(x.shape), device=x.device)
    return x * ((keep >= p).to(x.dtype) / (1.0 - p))


class _Holder(nn.Module):
    """A named level of BERT's module tree (HuggingFace's names)."""


class BertLayer(nn.Module):
    def __init__(self, d, heads, ffn, eps, quant):
        super().__init__()
        self.heads, self.quant = heads, quant
        self.attention = _Holder()
        self.attention.self = _Holder()
        for n in ("query", "key", "value"):
            setattr(self.attention.self, n, Linear(d, d))
        self.attention.output = _Holder()
        self.attention.output.dense = Linear(d, d)
        self.attention.output.LayerNorm = nn.LayerNorm(d, eps=eps)
        self.intermediate = _Holder()
        self.intermediate.dense = Linear(d, ffn)
        self.output = _Holder()
        self.output.dense = Linear(ffn, d)
        self.output.LayerNorm = nn.LayerNorm(d, eps=eps)

    def forward(self, h, bias, p):
        b, l, d = h.shape
        nh, hd = self.heads, d // self.heads
        sa, q8 = self.attention.self, self.quant
        q = sa.query(h).view(b, l, nh, hd)
        k = sa.key(h).view(b, l, nh, hd)
        v = sa.value(h).view(b, l, nh, hd)
        scores = torch.einsum("bqhd,bkhd->bhqk", q8(q), q8(k)) / hd ** 0.5
        probs = torch.softmax(scores + bias, dim=-1)
        if p:
            probs = row_dropout(probs, p)
        ctx = torch.einsum("bhqk,bkhd->bqhd", q8(probs), q8(v)).reshape(b, l,
                                                                        d)
        out = self.attention.output.dense(ctx)
        if p:
            out = row_dropout(out, p)
        h = self.attention.output.LayerNorm(h + out)
        ffn = self.output.dense(F.gelu(self.intermediate.dense(h)))
        if p:
            ffn = row_dropout(ffn, p)
        return self.output.LayerNorm(h + ffn)


class Bert(nn.Module):
    def __init__(self, cfg: Dict, quant: Quant):
        super().__init__()
        d, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.dropout_rate = cfg["dropout_rate"]
        self.embeddings = _Holder()
        self.embeddings.word_embeddings = nn.Embedding(cfg["vocab_size"], d)
        self.embeddings.position_embeddings = nn.Embedding(
            cfg["max_position"], d)
        self.embeddings.token_type_embeddings = nn.Embedding(
            cfg["type_vocab_size"], d)
        self.embeddings.LayerNorm = nn.LayerNorm(d, eps=eps)
        self.encoder = _Holder()
        self.encoder.layer = nn.ModuleList(
            BertLayer(d, cfg["num_heads"], cfg["intermediate_size"], eps,
                      quant) for _ in range(cfg["num_layers"]))

    def forward(self, ids, mask):
        b, l = ids.shape
        e = self.embeddings
        pos = torch.arange(l, device=ids.device)[None, :].expand(b, l)
        h = (e.word_embeddings(ids) + e.position_embeddings(pos)
             + e.token_type_embeddings(torch.zeros_like(ids)))
        h = e.LayerNorm(h)
        p = self.dropout_rate if self.training else 0.0
        if p:
            h = row_dropout(h, p)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        for layer in self.encoder.layer:
            h = layer(h, bias, p)
        return h


class TextEncoderBert(nn.Module):
    def __init__(self, embed_dim, bert_cfg, quant):
        super().__init__()
        self.bert = Bert(bert_cfg, quant)
        self.linear = nn.Linear(bert_cfg["hidden_size"], embed_dim)

    low = False  # the control: BERT under bf16 autocast, as the port

    def forward(self, ids, mask):
        with _compute(self.low, ids.device):
            hidden = self.bert(ids, mask)
        return l2_normalize(self.linear(hidden[:, 0, :].float()))


class PCME(nn.Module):
    """The server's PCME (BERT text branch) from a configuration file's
    ``model`` block."""

    def __init__(self, model_cfg: Dict, fp8: bool = False):
        super().__init__()
        quant = Quant(fp8)
        img, txt = model_cfg["image"], model_cfg["text"]
        self.img_enc = ImageEncoder(img["block"], img["stage_sizes"],
                                    model_cfg["embed_dim"])
        self.txt_enc = TextEncoderBert(model_cfg["embed_dim"], txt, quant)
        for m in (*self.img_enc.cnn.modules(), *self.txt_enc.bert.modules()):
            if isinstance(m, (Conv2d, Linear)):
                m.quant = quant
        self.img_enc.low = self.txt_enc.low = fp8

    def forward(self, images, ids, mask):
        return self.img_enc(images), self.txt_enc(ids, mask)


# -- the port's initializers (models/resnet.py, models/pie.py, models/bert.py,
# models/pcme.py), frozen --------------------------------------------------
def init_parameters(module: nn.Module, g: torch.Generator) -> None:
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu", generator=g)
        elif isinstance(m, nn.Linear):
            nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=g)
            if m.bias is not None:
                bound = m.in_features ** -0.5
                nn.init.uniform_(m.bias, -bound, bound, generator=g)


def init_pie(module: PIENet, g: torch.Generator) -> None:
    for lin in (module.attention.w_1, module.attention.w_2, module.fc):
        nn.init.xavier_uniform_(lin.weight, generator=g)
    nn.init.zeros_(module.fc.bias)


def init_bert(module: nn.Module, g: torch.Generator, std=0.02) -> None:
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.normal_(m.weight, 0.0, std, generator=g)
            if isinstance(m, nn.Linear):
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def init_pcme(model: nn.Module, seed: int) -> None:
    """The port's ``init_pcme`` with ``torch.Generator().manual_seed(seed)``
    on the BERT branch (``PCME``)."""
    g = torch.Generator().manual_seed(seed)
    init_parameters(model, g)
    nn.init.xavier_uniform_(model.img_enc.fc.weight, generator=g)
    nn.init.zeros_(model.img_enc.fc.bias)
    init_pie(model.img_enc.pie_net, g)
    init_bert(model.txt_enc.bert, g)


def leaves(model: nn.Module, criterion: Optional[nn.Module] = None
           ) -> Dict[str, torch.Tensor]:
    """Parameters by the port's names: ``model.<name>``, ``criterion.<name>``."""
    out = {f"model.{k}": p for k, p in model.named_parameters()}
    if criterion is not None:
        out.update({f"criterion.{k}": p
                    for k, p in criterion.named_parameters()})
    return out
