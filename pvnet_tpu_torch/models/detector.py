"""Single-channel detector heads (ref model_repository.py:302-331), the
port of pvnet_tpu/models/detector.py.

Experimental heatmap-detector variants the reference keeps beside the
production FCN: a stride-8 1-channel head on the full dilated ResNet18
(``Detector``, ref Resnet18_8s_detector) and a truncated trunk that stops
at the stride-8 features of layer2 (``DetectorV2``, ref
Resnet18_8s_detector_v2). Channel-major: forward(x [b, 3, h, w]) ->
logits [b, 1, h/8, w/8]. Module names follow models/resnet.py; the head
is ``fc``.
"""
from __future__ import annotations

import torch
from torch import nn

from pvnet_tpu_torch.models.resnet import (_BN_EPS, BasicBlock,
                                          BatchNorm2d, resnet18_backbone)


class Detector(nn.Module):
    """Stride-8 single-channel detection head on the full backbone
    (ref :302-315): a 3x3 convolution with bias on layer4's features."""

    def __init__(self):
        super().__init__()
        backbone = resnet18_backbone(output_stride=8)
        backbone.fc = nn.Conv2d(backbone.inplanes, 1, 3, padding=1)
        self.resnet18_8s = backbone

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnet18_8s.fc(self.resnet18_8s(x)[-1])


class DetectorV2(nn.Module):
    """Truncated trunk: the stem, layer1 and layer2 (undilated), then a
    1-channel 3x3 head (ref :318-331)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=_BN_EPS)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        self.layer1 = nn.Sequential(BasicBlock(64, 64), BasicBlock(64, 64))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, stride=2),
                                    BasicBlock(128, 128))
        self.fc = nn.Conv2d(128, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        return self.fc(self.layer2(self.layer1(x)))
