"""Dilated ResNet backbone (PyTorch, NCHW).

Port of pvnet_tpu/models/resnet.py (``BasicBlock``, ``ResNetBackbone``,
``resnet18_backbone``), itself a re-implementation of the reference's
torchvision-derived dilated ResNet (ref lib/networks/resnet.py): strides
turn into dilations once the requested output stride is reached, 3x3
convs pad by their dilation, and the forward pass returns every
intermediate feature map for the decoder's skip connections.

Module and parameter names follow the reference (conv1/bn1,
layer{1..4}.{i}.conv{1,2}/bn{1,2}/downsample.{0,1}), so a reference
state_dict loads without a converter. ``quant_stages`` runs the listed
stages' convolutions in int8 at inference (ops/quant_conv.py), as the JAX
module's of the same name. The TPU layout machinery of the JAX module
(packed4 stem, channel-major input conv, space-to-batch) is not ported.

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


class ResNetBackbone(nn.Module):
    """Dilated ResNet trunk returning all skip features.

    forward(x [b, 3, h, w]) -> (x2s, x4s, x8s, x16s, x32s): feature maps at
    strides 2/4/8/8/8 for output_stride=8 (ref resnet.py:200-220).

    quant_stages: 0-based stages (0 = layer1) whose convolutions, the 1x1
    downsample included, are QuantConv2d in ``quant_mode``: int8 in eval
    mode, float in training. The stem stays float.
    """

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 output_stride: int = 8, quant_stages: Sequence[int] = (),
                 quant_mode: str = "dynamic"):
        super().__init__()
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
                blocks.append(BasicBlock(inplanes, planes,
                                         stride=stride if i == 0 else 1,
                                         dilation=dilation, conv=conv))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.inplanes = inplanes

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x2s = self.relu(self.bn1(self.conv1(x)))
        x4s = self.layer1(self.maxpool(x2s))
        x8s = self.layer2(x4s)
        x16s = self.layer3(x8s)
        x32s = self.layer4(x16s)
        return x2s, x4s, x8s, x16s, x32s


def resnet18_backbone(**kw) -> ResNetBackbone:
    return ResNetBackbone(stage_sizes=(2, 2, 2, 2), **kw)
