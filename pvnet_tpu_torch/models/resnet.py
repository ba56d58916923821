"""Dilated ResNet backbone (PyTorch, NCHW).

Port of pvnet_tpu/models/resnet.py (``BasicBlock``, ``Bottleneck``,
``ResNetBackbone``, ``resnet18/34/50_backbone``), itself a
re-implementation of the reference's
torchvision-derived dilated ResNet (ref lib/networks/resnet.py): strides
turn into dilations once the requested output stride is reached, 3x3
convs pad by their dilation, and the forward pass returns every
intermediate feature map for the decoder's skip connections.

Module and parameter names follow the reference (conv1/bn1,
layer{1..4}.{i}.conv{1,2[,3]}/bn{1,2[,3]}/downsample.{0,1}), which are
also torchvision's, so a reference or an ImageNet state_dict loads by
name (utils/weights.py). ``quant_stages`` runs the listed
stages' convolutions in int8 at inference (ops/quant_conv.py), as the JAX
module's of the same name. ``stem='packed4'`` is the JAX module's packed
stem: the 7x7/2 stem convolution folded exactly into a 4x4/1 one over the
space-to-depth-packed 12-channel image (:func:`fold_conv7_to_packed4`),
which also takes an image packed upstream (the serving path packs and
normalizes uint8 images on the device, pipeline.normalize_packed_u8). The
JAX module's channel-major input conv and space-to-batch are TPU layout
choices and are not ported.

Training follows the JAX module: convolutions start He fan-out
truncated-normal (:func:`init_weights`), and BatchNorm keeps flax's running
statistics (:class:`BatchNorm2d`).
"""
from __future__ import annotations

from functools import partial
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pvnet_tpu_torch.ops.quant_conv import QuantConv2d
from pvnet_tpu_torch.utils.torchvision_manifest import ARCHS

_BN_EPS = 1e-5
# stddev of a standard normal truncated to [-2, 2] (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance tracks the *biased* batch
    variance, as flax.linen.BatchNorm(momentum=0.9) does; PyTorch's own
    tracks the unbiased one, larger by n/(n-1) for n values per channel.
    Normalization itself uses the biased variance in both."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # PyTorch updates a copy to (1-m)*old + m*unbiased; taking
        # unbiased/n of the m*unbiased term away leaves m*biased. The copy,
        # not the buffer, is what autograd saves, so the buffer may change.
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_(
                var - (var - (1 - self.momentum) * self.running_var) / n)
        return y


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[b, h, w, c] -> [b, h/2, w/2, 4c] (NHWC, as the JAX function),
    packed channel (a*2+b)*c + ch for row phase a, column phase b."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth2`."""
    b, h2, w2, c4 = x.shape
    c = c4 // 4
    x = x.reshape(b, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h2, 2 * w2, c)


def space_to_depth2_cm(x: torch.Tensor) -> torch.Tensor:
    """:func:`space_to_depth2` of a channel-major tensor: [b, c, h, w] ->
    [b, 4c, h/2, w/2], the same channel order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space2_cm(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth2_cm`."""
    b, c4, h2, w2 = x.shape
    c = c4 // 4
    x = x.reshape(b, 2, 2, c, h2, w2).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c, 2 * h2, 2 * w2)


def fold_conv7_to_packed4(w7: torch.Tensor) -> torch.Tensor:
    """Fold a 7x7/stride-2/pad-3 conv kernel [cout, cin, 7, 7] (OIHW) into
    the equivalent 4x4/stride-1 kernel [cout, 4*cin, 4, 4] over the
    space_to_depth2-packed input, padded (2, 1) on each axis: the JAX
    function's fold (pvnet_tpu/models/resnet.py:73) in PyTorch's layout,
    channel (a*2+b)*cin + c.

    Output pixel (oy, ox) of the stride-2 conv reads input rows
    2oy + dy - 3; on the packed lattice that row is cell oy + ky - 2,
    phase a, with dy = 2ky + a - 1, so each full-resolution tap has exactly
    one packed slot (the packed kernel carries 2 zero taps per axis) and
    the two convolutions compute the same sums."""
    cout, cin, kh, kw = w7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"a 7x7 kernel is required, got {tuple(w7.shape)}")
    w4 = w7.new_zeros((cout, 4 * cin, 4, 4))
    for ky in range(4):
        for a in range(2):
            dy = 2 * ky + a - 1
            if not 0 <= dy < 7:
                continue
            for kx in range(4):
                for b in range(2):
                    dx = 2 * kx + b - 1
                    if 0 <= dx < 7:
                        ch = (a * 2 + b) * cin
                        w4[:, ch:ch + cin, ky, kx] = w7[:, :, dy, dx]
    return w4


class PadConv2d(nn.Conv2d):
    """``nn.Conv2d`` (no padding of its own) behind an explicit zero pad
    ``pad`` = (left, right, top, bottom): the packed4 stem's asymmetric
    (2, 1) padding held by the convolution module, where a row-sharded
    copy of the model (parallel/spatial.py) reads it like any other
    convolution's. Its parameters are ``nn.Conv2d``'s."""

    def __init__(self, *args, pad=(0, 0, 0, 0), **kwargs):
        super().__init__(*args, **kwargs)
        if self.padding != (0, 0):
            raise ValueError("PadConv2d pads through ``pad`` only")
        self.pad = tuple(pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(x, self.pad))


def init_weights(model: nn.Module, generator: torch.Generator = None
                 ) -> nn.Module:
    """Initialize as the JAX models do: every conv kernel He fan-out
    truncated-normal (flax ``variance_scaling(2.0, 'fan_out',
    'truncated_normal')``, ref resnet.py:159-162), conv biases zero,
    BatchNorm scale 1 and bias 0, running statistics (0, 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                std = (2.0 / fan_out) ** 0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (ref resnet.py:41-70). ``conv``
    builds all three convolutions (nn.Conv2d, or QuantConv2d for an int8
    stage)."""
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, conv=nn.Conv2d):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride=stride,
                          padding=dilation, dilation=dilation, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=_BN_EPS)
        self.conv2 = conv(planes, planes, 3, padding=dilation,
                          dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=_BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                conv(inplanes, planes, 1, stride=stride, bias=False),
                BatchNorm2d(planes, eps=_BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (strided, dilated) -> 1x1 x4 with a projection shortcut
    where the shapes differ (ref resnet.py:73-113, the JAX ``Bottleneck``).
    ``conv`` builds all four convolutions, as in :class:`BasicBlock`."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, conv=nn.Conv2d):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=_BN_EPS)
        self.conv2 = conv(planes, planes, 3, stride=stride,
                          padding=dilation, dilation=dilation, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=_BN_EPS)
        self.conv3 = conv(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out, eps=_BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                conv(inplanes, out, 1, stride=stride, bias=False),
                BatchNorm2d(out, eps=_BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class ResNetBackbone(nn.Module):
    """Dilated ResNet trunk returning all skip features.

    forward(x [b, 3, h, w]) -> (x2s, x4s, x8s, x16s, x32s): feature maps at
    strides 2/4/8/8/8 for output_stride=8 (ref resnet.py:200-220).

    block: BasicBlock or Bottleneck; each stage's width is planes x
    block.expansion, and the next stage's input follows it.

    quant_stages: 0-based stages (0 = layer1) whose convolutions, the 1x1
    downsample included, are QuantConv2d in ``quant_mode``: int8 in eval
    mode, float in training. The stem stays float.
    stem: 'conv7' (the reference's 7x7/2 convolution) or 'packed4' (a 4x4
    convolution over 12 channels, padding (2, 1) (:class:`PadConv2d`), on
    the packed image;
    forward then also takes a packed [b, 12, h/2, w/2] input).
    """

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 output_stride: int = 8, block=BasicBlock,
                 quant_stages: Sequence[int] = (),
                 quant_mode: str = "dynamic", stem: str = "conv7"):
        super().__init__()
        if stem not in ("conv7", "packed4"):
            raise ValueError(f"stem must be 'conv7' or 'packed4', got "
                             f"{stem!r}")
        self.stem = stem
        if stem == "packed4":
            self.conv1 = PadConv2d(12, 64, 4, bias=False, pad=(2, 1, 2, 1))
        else:
            self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=_BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        # stride/dilation schedule (ref resnet.py:167-198): current_stride
        # starts at 4 (conv1 + maxpool); each stage's stride becomes a
        # dilation multiplier once output_stride is reached
        current_stride, dilation, inplanes = 4, 1, 64
        for stage, (n_blocks, planes, stride) in enumerate(
                zip(stage_sizes, (64, 128, 256, 512), (1, 2, 2, 2))):
            if stride != 1:
                if current_stride == output_stride:
                    dilation *= stride
                    stride = 1
                else:
                    current_stride *= stride
            conv = (partial(QuantConv2d, mode=quant_mode)
                    if stage in quant_stages else nn.Conv2d)
            blocks = []
            for i in range(n_blocks):
                blocks.append(block(inplanes, planes,
                                    stride=stride if i == 0 else 1,
                                    dilation=dilation, conv=conv))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.inplanes = inplanes

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if self.stem == "packed4":
            if x.shape[1] != 12:
                x = space_to_depth2_cm(x)
        x2s = self.relu(self.bn1(self.conv1(x)))
        x4s = self.layer1(self.maxpool(x2s))
        x8s = self.layer2(x4s)
        x16s = self.layer3(x8s)
        x32s = self.layer4(x16s)
        return x2s, x4s, x8s, x16s, x32s


def arch_layout(arch: str):
    """(block class, stage_sizes) of 'resnet18', 'resnet34' or 'resnet50'
    (the architectures of utils/torchvision_manifest.ARCHS)."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; expected one of "
                         f"{sorted(ARCHS)}")
    stage_sizes, bottleneck = ARCHS[arch]
    return (Bottleneck if bottleneck else BasicBlock), tuple(stage_sizes)


def arch_name(block, stage_sizes: Sequence[int]) -> str:
    """The inverse of :func:`arch_layout`."""
    for arch in ARCHS:
        if arch_layout(arch) == (block, tuple(stage_sizes)):
            return arch
    raise ValueError(f"no arch has {block.__name__} x {tuple(stage_sizes)}")


def resnet_backbone(arch: str, **kw) -> ResNetBackbone:
    block, stage_sizes = arch_layout(arch)
    return ResNetBackbone(stage_sizes=stage_sizes, block=block, **kw)


def resnet18_backbone(**kw) -> ResNetBackbone:
    return resnet_backbone("resnet18", **kw)


def resnet34_backbone(**kw) -> ResNetBackbone:
    return resnet_backbone("resnet34", **kw)


def resnet50_backbone(**kw) -> ResNetBackbone:
    return resnet_backbone("resnet50", **kw)
