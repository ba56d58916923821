"""Legacy VGG16 segmentation + vertex network (PoseCNN-style), the port of
pvnet_tpu/models/vgg.py (ref lib/networks/vgg.py,
lib/networks/vgg16_convs.py:21-52).

A VGG16-D backbone exposes conv4_3 (stride 8) and conv5_3 (stride 16);
two dual-branch heads reduce both with 1x1 convolutions, fuse them by
upsampled addition at stride 8 and upsample to full resolution (bilinear,
align_corners=False, as the reference's F.interpolate). ``VGG16Convs``
returns (seg_score, seg_pred, vertex_pred) like the reference;
:func:`as_pvnet_outputs` adapts that to the (seg, ver) pair of
``PVNet``, so the model drops into pipeline.estimate_poses. Channel-major;
module names are the JAX module's (``backbone.conv{b}_{c}``,
``{seg,vertex}_branch{1,2}``, ``seg``, ``vertex``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# torchvision cfg['D'] (ref lib/networks/vgg.py:81): channel widths per
# block; a 2x2 max pool between blocks
VGG16_CFG: Tuple[Tuple[int, ...], ...] = (
    (64, 64), (128, 128), (256, 256, 256), (512, 512, 512), (512, 512, 512))


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


class VGG16Backbone(nn.Module):
    """VGG16-D features: forward(x) -> (conv4_3 [b, 512, h/8, w/8],
    conv5_3 [b, 512, h/16, w/16]) (ref vgg16_convs.py:26-27)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for bi, widths in enumerate(VGG16_CFG):
            for ci, width in enumerate(widths):
                setattr(self, f"conv{bi + 1}_{ci + 1}",
                        nn.Conv2d(cin, width, 3, padding=1))
                cin = width

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = []
        for bi, widths in enumerate(VGG16_CFG):
            if bi > 0:
                x = F.max_pool2d(x, 2)
            for ci in range(len(widths)):
                x = F.relu(getattr(self, f"conv{bi + 1}_{ci + 1}")(x))
            feats.append(x)
        return feats[3], feats[4]


class VGG16Convs(nn.Module):
    """Dual-branch seg + vertex FCN on VGG16 (ref vgg16_convs.py:21-52):
    seg branches 64 channels (ReLU) -> seg_dim logits, vertex branches 128
    channels (linear) -> ver_dim. forward(x [b, 3, h, w]) -> (seg_score,
    its softmax seg_pred, vertex_pred), each [b, *, h, w]."""

    def __init__(self, ver_dim: int = 16, seg_dim: int = 2):
        super().__init__()
        self.ver_dim, self.seg_dim = ver_dim, seg_dim
        self.backbone = VGG16Backbone()
        for name, width, cout in (("seg", 64, seg_dim),
                                  ("vertex", 128, ver_dim)):
            setattr(self, f"{name}_branch1", nn.Conv2d(512, width, 1))
            setattr(self, f"{name}_branch2", nn.Conv2d(512, width, 1))
            setattr(self, name, nn.Conv2d(width, cout, 1))

    def _branch(self, name: str, conv4_3, conv5_3, h: int, w: int,
                relu: bool) -> torch.Tensor:
        b1 = getattr(self, f"{name}_branch1")(conv4_3)
        b2 = getattr(self, f"{name}_branch2")(conv5_3)
        if relu:
            b1, b2 = F.relu(b1), F.relu(b2)
        fused = b1 + _resize(b2, *b1.shape[2:])
        return getattr(self, name)(_resize(fused, h, w))

    def forward(self, x: torch.Tensor):
        h, w = x.shape[2:]
        conv4_3, conv5_3 = self.backbone(x)
        seg_score = self._branch("seg", conv4_3, conv5_3, h, w, relu=True)
        vertex_pred = self._branch("vertex", conv4_3, conv5_3, h, w,
                                   relu=False)
        return seg_score, torch.softmax(seg_score, dim=1), vertex_pred


def vgg16_convs(ver_dim: int = 16, seg_dim: int = 2) -> VGG16Convs:
    """Factory mirroring the reference constructor (BB8 voting: 8
    keypoints x 2 = 16)."""
    return VGG16Convs(ver_dim=ver_dim, seg_dim=seg_dim)


def as_pvnet_outputs(outputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """VGG16Convs' 3-tuple -> the (seg logits, vertex) pair of PVNet."""
    seg_score, _, vertex_pred = outputs
    return seg_score, vertex_pred
