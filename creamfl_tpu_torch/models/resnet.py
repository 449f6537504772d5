"""ResNet trunks, torchvision names: BasicBlock (resnet6/10/18/34) and
Bottleneck (resnet50/101/152) blocks, the latter optionally fused.

Public layout is the JAX package's: images in NHWC ``[B, H, W, 3]``, the
feature grid out as NHWC ``[B, H/32, W/32, C]``. Inside, the trunk runs
NCHW on a permuted view (channels-last strides, which cuDNN prefers).

BatchNorm follows the JAX package (flax ``nn.BatchNorm``, momentum 0.9):
in train mode the running stats move as ``0.9 * old + 0.1 * batch`` with
the BIASED batch variance. ``nn.BatchNorm2d`` would use the unbiased one,
a factor n/(n-1) apart (6.7 % at batch 4 on a 2 x 2 grid). The train-mode
statistics are taken once, by the normalisation itself: its fp32 batch
mean and inverse std move the running stats, the biased variance
recovered as ``invstd**-2 - eps``. No fp32 copy of a bf16 activation is
made and no second reduction runs. In the blocks and the stem a train-mode
BatchNorm runs with what follows it (nothing, a ReLU, or the residual add
and a ReLU) through one entry point, ``bn_act``: one hand-written pass
each way on a bf16 activation on the card (K8, ``ops/batchnorm.py``).

Under a mesh of ranks (``set_batchnorm_mesh``) a BatchNorm in train mode
takes its statistics over the whole batch, every rank's rows, as XLA
partitions the JAX package's BatchNorm over a batch sharded on its mesh:
the per-channel sum and the count all-reduced in fp32, then the sum of
squares about that mean (two passes, as cuDNN's statistics: E[x^2] -
E[x]^2 in fp32 loses a relative 1e-7 * mean^2 / var of the variance,
which the backward of a deep trunk magnifies); in its backward the sums
of dy and dy * x_hat. The running stats come out identical on every rank.
Without a mesh it is unchanged.

``ResNetBackbone(fused_bn=True)`` runs each Bottleneck as a
``FusedBottleneck``: its 1x1 convs and their BatchNorms go through
``ops.fused_bn_mm.mm_bn_stats`` (kernels K5/K6 on the card). Both blocks
have the same ``state_dict`` keys, so weights interchange.

Compute dtype: the trunk runs in the input's dtype, or in bf16 under
``torch.autocast`` (the PCME image encoder turns it on for bf16).

``ResNetBackbone(remat=...)`` recomputes activations in the backward, as
the JAX package's ``nn.remat`` of each block: "block" saves only each
residual block's input (``torch.utils.checkpoint``, non-reentrant) and
runs the block again in the backward; "dots" is the JAX policy
``checkpoint_dots_with_no_batch_dims`` as a selective-checkpoint policy:
it keeps only the outputs of matrix products without batch dimensions
(``mm``, ``addmm``) and recomputes the rest. Convolutions are not such
products, so on a trunk of convolutions "dots" recomputes as much as
"block", as it does in the JAX package.
The recompute moves no running statistic: a BatchNorm moves its running
stats and ``num_batches_tracked`` once a step, in the first forward, on
the standard and the fused trunk. A mesh's synced BatchNorm is not
recomputed: ``set_batchnorm_mesh`` raises for a remat trunk on more than
one rank. ``stem="s2d"`` runs the 7x7/2 stem as the JAX package's
space-to-depth stem: 2x2 pixel cells regrouped into 12 channels and a
4x4 VALID conv on the zero-padded ``conv1.weight`` (the same weight, so
checkpoints and ``models/convert.py`` are unchanged); odd sizes take the
7x7 conv.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from creamfl_tpu_torch.ops import batchnorm as bn_ops
from creamfl_tpu_torch.utils import profiling


class BatchNorm(nn.Module):
    """BatchNorm2d (or 1d on [B, C]) with flax's running-stat update
    (biased variance, batch stats in fp32). In train mode without a mesh
    the running stats move from the statistics the normalisation took
    (its fp32 mean and inverse std, the variance ``invstd**-2 - eps``): one
    pass over the batch, counted in ``bn.single_pass``.

    Parameter and buffer names are torchvision's (weight, bias,
    running_mean, running_var, num_batches_tracked), so its checkpoints
    load with ``strict=True``. ``mesh`` (``set_batchnorm_mesh``): the ranks
    whose rows share one batch's statistics; None for this rank's alone.
    """

    mesh = None
    # True while a remat trunk recomputes the block: the running stats
    # moved in the first forward.
    frozen = False

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
        if self.mesh is not None and self.mesh.world > 1:
            return self._synced(x)
        # F.batch_norm's own entry point (the same backend for each dtype
        # and device), which also hands back the batch mean and inverse std
        # it normalised with, in fp32 for a bf16 activation.
        F._verify_batch_size(x.size())
        out, mean, invstd = torch._batch_norm_impl_index(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps,
            torch.backends.cudnn.enabled)[:3]
        self.move_running(mean, invstd)
        return out

    def move_running(self, mean: torch.Tensor, invstd: torch.Tensor) -> None:
        """Move the running stats from the batch's fp32 mean and inverse
        std (counted in ``bn.single_pass``), unless a remat recompute froze
        them."""
        if self.frozen:
            return
        profiling.count("bn.single_pass")
        # The biased variance, rounding kept off the negative side.
        var = invstd.detach().pow(-2).sub_(self.eps).clamp_min_(0)
        _update_running(self, mean, var)

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the mesh's batch: the mean from the all-reduced
        sums and count, then the biased variance from the all-reduced sums
        of squares about it."""
        from creamfl_tpu_torch.parallel.mesh import all_reduce_sum

        with torch.no_grad():
            dims = (0,) if x.dim() == 2 else (0, 2, 3)
            c = x.shape[1]
            xf = x.float()
            sums = all_reduce_sum(self.mesh, torch.cat([
                xf.sum(dims), xf.new_full((1,), x.numel() / c)]))
            n = sums[-1]
            mean = sums[:c] / n
            d = xf - _channel_view(mean, x)
            var = all_reduce_sum(self.mesh, (d * d).sum(dims)) / n
            del xf, d
            self.running_mean.mul_(self.momentum).add_(
                mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(
                var, alpha=1 - self.momentum)
            self.num_batches_tracked.add_(1)
        return _SyncedNorm.apply(x, self.weight, self.bias, mean, var,
                                 self.eps, self.mesh)


def _channel_view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over ``x`` ([B, C] or
    [B, C, H, W])."""
    return v.view(1, -1) if x.dim() == 2 else v.view(1, -1, 1, 1)


class _SyncedNorm(torch.autograd.Function):
    """y = (x - mean) * rsqrt(var + eps) * weight + bias with the mesh's
    batch statistics. Backward: dx from the mesh-wide sums of dy and
    dy * x_hat (all-reduced); the weight and bias gradients are this rank's
    sums, which the server's gradient all-reduce adds up."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, var, eps, mesh):
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh = mesh
        return F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)

    @staticmethod
    def backward(ctx, dy):
        from creamfl_tpu_torch.parallel.mesh import all_reduce_sum

        x, weight, mean, invstd = ctx.saved_tensors
        dims = (0,) if x.dim() == 2 else (0, 2, 3)
        c = x.shape[1]
        dyf = dy.float()
        xhat = (x.float() - _channel_view(mean, x)) * _channel_view(invstd,
                                                                    x)
        local = torch.cat([dyf.sum(dims), (dyf * xhat).sum(dims)])
        total = all_reduce_sum(ctx.mesh, local.clone())
        n = x.numel() / c * ctx.mesh.world
        dx = _channel_view(weight.float() * invstd, x) * (
            dyf - _channel_view(total[:c] / n, x)
            - xhat * _channel_view(total[c:] / n, x))
        return (dx.to(x.dtype), local[c:].to(weight.dtype),
                local[:c].to(weight.dtype), None, None, None, None)


def bn_act(bn: BatchNorm, x: torch.Tensor, epilogue: str,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bn(x)`` and what follows it in the trunk: nothing ("none"), a ReLU
    ("relu"), or the residual add and a ReLU ("add_relu":
    ``relu(bn(x) + residual)``). The route follows the inputs alone:

    * train mode off a mesh on a bf16 CUDA activation: K8
      (``ops.batchnorm.BnAct``, which raises for an activation it cannot
      take), one pass each way; the running stats move from its fp32 mean
      and inverse std as in ``BatchNorm.forward``;
    * otherwise (the CPU, eval mode, a mesh of more than one rank, another
      CUDA dtype): ``bn(x)``, then ``+ residual`` and ``F.relu``.

    Each train-mode call off a mesh on the CPU or on K8 counts in
    ``bn.fused.<epilogue>``.
    """
    if (bn.training and (bn.mesh is None or bn.mesh.world == 1)
            and (not x.is_cuda or x.dtype == torch.bfloat16)):
        profiling.count(f"bn.fused.{epilogue}")
        if x.is_cuda:
            F._verify_batch_size(x.size())
            z, stats = bn_ops.BnAct.apply(x, bn.weight, bn.bias, residual,
                                          bn.eps, epilogue)
            bn.move_running(stats[0], stats[1])
            return z
    y = bn(x)
    if epilogue == "add_relu":
        y = y + residual
    return y if epilogue == "none" else F.relu(y)


def set_batchnorm_mesh(module: nn.Module, mesh) -> None:
    """Give every BatchNorm under ``module`` the mesh its train-mode
    statistics span (None: each rank's rows alone). The fused trunk takes
    its BatchNorm statistics inside K5 and has no mesh variant, and a remat
    trunk would run the synced BatchNorm's collectives again in its
    recompute: both raise under a mesh of more than one rank."""
    for m in module.modules():
        if mesh is None or mesh.world <= 1:
            pass
        elif isinstance(m, FusedBottleneck):
            raise NotImplementedError(
                "the fused trunk (fused_bn=True) takes its BatchNorm "
                "statistics inside K5 and has no mesh variant (ROADMAP "
                "queue 1); run the standard trunk on a mesh")
        elif isinstance(m, ResNetBackbone) and m.remat != "none":
            raise NotImplementedError(
                f"remat={m.remat!r} would recompute the synced BatchNorm "
                "and its collectives in the backward; run remat='none' on "
                "a mesh")
        if isinstance(m, BatchNorm):
            m.mesh = mesh


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
        y = self.conv2(bn_act(self.bn1, self.conv1(x), "relu"))
        return bn_act(self.bn2, y, "add_relu", _shortcut(self, x))


class Bottleneck(nn.Module):
    """torchvision v1 Bottleneck: 1x1 -> 3x3 (carries the stride) -> 1x1
    (x4 channels), each followed by BatchNorm; projection on the identity
    path when the stride or the width changes."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        cout = filters * self.expansion
        self.conv1 = _conv(cin, filters, 1)
        self.bn1 = BatchNorm(filters)
        self.conv2 = _conv(filters, filters, 3, stride)
        self.bn2 = BatchNorm(filters)
        self.conv3 = _conv(filters, cout, 1)
        self.bn3 = BatchNorm(cout)
        self.stride = stride
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride),
                                            BatchNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = bn_act(self.bn1, self.conv1(x), "relu")
        y = self.conv3(bn_act(self.bn2, self.conv2(y), "relu"))
        return bn_act(self.bn3, y, "add_relu", _shortcut(self, x))


def _shortcut(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A block's identity path: ``x``, or its projection (the 1x1 conv and
    its BatchNorm)."""
    if block.downsample is None:
        return x
    conv, bn = block.downsample
    return bn_act(bn, conv(x), "none")


def _fold(bn: BatchNorm, mean: torch.Tensor, var: torch.Tensor):
    """BatchNorm as an affine: (inv, beta) with y_norm = y * inv + beta."""
    inv = bn.weight * torch.rsqrt(var + bn.eps)
    return inv, bn.bias - mean * inv


def _update_running(bn: BatchNorm, mean: torch.Tensor,
                    var: torch.Tensor) -> None:
    """Move ``bn``'s running stats (flax's momentum update), unless a remat
    recompute froze them."""
    if bn.frozen:
        return
    with torch.no_grad():
        bn.running_mean.mul_(bn.momentum).add_(mean.detach(),
                                               alpha=1 - bn.momentum)
        bn.running_var.mul_(bn.momentum).add_(var.detach(),
                                              alpha=1 - bn.momentum)
        bn.num_batches_tracked.add_(1)


class FusedBottleneck(Bottleneck):
    """Bottleneck with its 1x1 convs and BatchNorms on ``mm_bn_stats``.

    Same parameters and buffers as ``Bottleneck`` (it is one); the forward
    follows the JAX package's ``FusedBottleneck`` step for step:

    * conv1 runs on the identity variant (the block input is already a
      relu output); its column stats give bn1's batch mean and biased
      variance, and bn1 + relu are applied by plain fp32 ops;
    * conv2 (3x3, strided) runs on cuDNN; bn2's stats are taken from its
      output in fp32 as E[y^2] - E[y]^2, and bn2 + relu fold into conv3's
      prologue (the affine variant with relu);
    * the projection, where there is one, is conv1's identity variant on
      ``x[:, ::s, ::s]`` -- a strided view, copied to contiguous rows;
    * the normalise arithmetic is fp32 throughout (the standard block does
      it in the compute dtype); outputs are in the block input's dtype.

    Train mode normalises with the batch stats and moves the running stats;
    eval mode folds the running stats. The block takes and returns NCHW
    views of channels-last memory, so ``[B, H, W, C] -> [B*H*W, C]`` is a
    view.
    """

    def _stats(self, bn: BatchNorm, ssum, ssq, n: int):
        if not self.training:
            return bn.running_mean, bn.running_var
        mean = ssum / n
        var = ssq / n - mean * mean
        _update_running(bn, mean, var)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from creamfl_tpu_torch.ops.fused_bn_mm import mm_bn_stats

        b, cin, h, w0 = x.shape
        f, cout, dtype = self.conv1.out_channels, self.conv3.out_channels, \
            x.dtype
        x_nhwc = x.permute(0, 2, 3, 1)
        x2d = x_nhwc.reshape(-1, cin)

        y1, ss1, sq1 = mm_bn_stats(x2d, self.conv1.weight.view(f, cin).t())
        inv1, beta1 = _fold(self.bn1, *self._stats(self.bn1, ss1, sq1,
                                                   y1.shape[0]))
        a1 = torch.relu(y1.float() * inv1 + beta1).to(dtype)
        a1 = a1.view(b, h, w0, f).permute(0, 3, 1, 2)

        y2 = F.conv2d(a1, self.conv2.weight.to(dtype), stride=self.stride,
                      padding=1)
        h2, w2 = y2.shape[2], y2.shape[3]
        y2_2d = y2.permute(0, 2, 3, 1).reshape(-1, f)
        if self.training:
            y2f = y2_2d.float()
            m2 = y2f.mean(0)
            v2 = (y2f * y2f).mean(0) - m2 * m2
            _update_running(self.bn2, m2, v2)
        else:
            m2, v2 = self.bn2.running_mean, self.bn2.running_var
        inv2, beta2 = _fold(self.bn2, m2, v2)

        y3, ss3, sq3 = mm_bn_stats(y2_2d, self.conv3.weight.view(cout, f).t(),
                                   inv2, beta2, relu=True)
        n2 = y3.shape[0]
        inv3, beta3 = _fold(self.bn3, *self._stats(self.bn3, ss3, sq3, n2))

        if self.downsample is not None:
            s = self.stride
            xs = x_nhwc[:, ::s, ::s, :].reshape(-1, cin)
            conv, bn = self.downsample[0], self.downsample[1]
            r, ssr, sqr = mm_bn_stats(xs, conv.weight.view(cout, cin).t())
            invr, betar = _fold(bn, *self._stats(bn, ssr, sqr, n2))
            res = r.float() * invr + betar
        else:
            res = x2d.float()
        out = torch.relu(y3.float() * inv3 + beta3 + res).to(dtype)
        return out.view(b, h2, w2, cout).permute(0, 3, 1, 2)


# name -> (block, stage sizes, feature dim of the final grid). "resnet6"
# is the JAX package's test-scale trunk (stem + 2 blocks); the rest are
# torchvision's ResNets.
RESNET_CONFIGS = {
    "resnet6": (BasicBlock, (1, 1), 128),
    "resnet10": (BasicBlock, (1, 1, 1, 1), 512),
    "resnet18": (BasicBlock, (2, 2, 2, 2), 512),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 512),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 2048),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 2048),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 2048),
}


def resnet_feature_dim(cnn_type: str) -> int:
    return RESNET_CONFIGS[cnn_type][2]


#: Ops whose outputs remat="dots" keeps: matrix products without batch
#: dimensions, the JAX policy's ``dot_general`` outputs (not convolutions,
#: nor ``bmm``).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
REMAT_POLICIES = ("none", "block", "dots")
STEMS = ("conv7", "s2d")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


@contextlib.contextmanager
def _frozen_stats(block: nn.Module):
    bns = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.frozen = True
    try:
        yield
    finally:
        for bn in bns:
            bn.frozen = False


def _remat_block(block: nn.Module, x: torch.Tensor, remat: str
                 ) -> torch.Tensor:
    """``block(x)`` under ``torch.utils.checkpoint``: its first run moves
    the running stats, the backward's recompute does not. No RNG state is
    kept (the blocks draw none; reading the CUDA RNG state is illegal while
    a CUDA graph is captured)."""
    from torch.utils.checkpoint import checkpoint

    runs = []

    def run(inp):
        runs.append(1)
        if len(runs) == 1:
            return block(inp)
        with _frozen_stats(block):
            return block(inp)

    kw = {"context_fn": _dots_context} if remat == "dots" else {}
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      **kw)


def _s2d_stem(images: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 7x7/2/p3 stem conv as a 4x4/1 VALID conv over 2x2 pixel cells
    regrouped into 12 channels: NHWC [B, H, W, 3] (H, W even) and OIHW
    [64, 3, 7, 7] -> NCHW [B, 64, H/2, W/2] (a channels-last view). The
    kernel is zero-padded to 8x8 and regrouped each call, so gradients
    reach ``weight`` as through the 7x7 conv (the JAX package's
    ``_s2d_stem``)."""
    b, h, w, c = images.shape
    x = F.pad(images, (0, 0, 3, 3, 3, 3))
    hc, wc = (h + 6) // 2, (w + 6) // 2
    x = x.reshape(b, hc, 2, wc, 2, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hc, wc, 4 * c).permute(0, 3, 1, 2)
    w8 = F.pad(weight, (0, 1, 0, 1))  # [O, 3, 8, 8]
    o = weight.shape[0]
    w4 = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return F.conv2d(x, w4.reshape(o, 4 * c, 4, 4))


class ResNetBackbone(nn.Module):
    """Stride-32 conv trunk: NHWC [B, H, W, 3] -> NHWC [B, H/32, W/32, C].

    ``fused_bn=True`` swaps ``FusedBottleneck`` in for ``Bottleneck``
    (BasicBlock trunks are unaffected), as the JAX package does.
    ``remat`` ("none", "block", "dots") and ``stem`` ("conv7", "s2d") are
    the JAX package's (module docstring).
    """

    def __init__(self, cnn_type: str = "resnet18", fused_bn: bool = False,
                 remat: str = "none", stem: str = "conv7"):
        super().__init__()
        if cnn_type not in RESNET_CONFIGS:
            raise NotImplementedError(
                f"{cnn_type}: the ported trunks are {sorted(RESNET_CONFIGS)}")
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat {remat!r}: one of {REMAT_POLICIES}")
        if stem not in STEMS:
            raise ValueError(f"stem {stem!r}: one of {STEMS}")
        self.remat, self.stem = remat, stem
        block_cls, stage_sizes, _ = RESNET_CONFIGS[cnn_type]
        if fused_bn and block_cls is Bottleneck:
            block_cls = FusedBottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            filters = 64 * 2 ** stage
            blocks = []
            for block in range(n_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(block_cls(cin, filters, stride))
                cin = filters * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if (self.stem == "s2d" and images.shape[1] % 2 == 0
                and images.shape[2] % 2 == 0):
            x = _s2d_stem(images, self.conv1.weight)
        else:
            x = self.conv1(images.permute(0, 3, 1, 2))
        x = self.maxpool(bn_act(self.bn1, x, "relu"))
        remat = self.remat != "none" and torch.is_grad_enabled()
        for stage in range(self.n_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = (_remat_block(block, x, self.remat) if remat
                     else block(x))
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
            if m.bias is not None:
                bound = m.in_features ** -0.5
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
