"""PVNet: fully-convolutional segmentation + vector-field network (PyTorch).

Port of pvnet_tpu/models/pvnet.py (``PVNet``, ``pvnet_resnet18``,
``build_model``), the reference's ``Resnet18_8s``
(ref lib/networks/model_repository.py:7-80): a dilated ResNet18 backbone at
output stride 8, a 3x3-conv "fc" head, and a skip-connected decoder that
upsamples 8s -> 4s -> 2s -> full resolution (bilinear, align_corners=True)
and emits ``seg_dim + ver_dim`` channels through a 1x1 head.

Outputs are channel-major — seg [b, seg_dim, h, w], ver [b, ver_dim, h, w]
— which is the JAX model's head_layout='NCHW' emission and PyTorch's
native layout. Module names follow the reference (resnet18_8s.fc,
conv8s, conv4s, conv2s, convraw), so a reference state_dict loads as is.
The feature-return flags of the JAX model feed the packed inference tail
(ops/packed_tail.py). ``quant_stages``, ``quant_mode`` and
``quant_decoder`` are the JAX model's int8 options (ops/quant_conv.py):
they change no parameter, so the same checkpoint loads either way. The
TPU-only pieces (channel-major head conv, packed4 stem, PVNet2o) are not
ported.

For training, the JAX model's ``dtype=bfloat16`` with float32 parameters
is the caller's ``torch.autocast(dtype=torch.bfloat16)`` around the
forward pass (train/trainer.py); the model itself stays float32. A new
model holds PyTorch's default initialization: a trainer starting from
scratch applies the JAX model's with ``models.resnet.init_weights``
(train/loop.py), a caller with a checkpoint loads it instead.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from pvnet_tpu_torch.models.resnet import (_BN_EPS, BatchNorm2d,
                                          resnet18_backbone)
from pvnet_tpu_torch.ops.quant_conv import QuantConv2d


def _conv_bn_lrelu(cin: int, cout: int, conv=nn.Conv2d) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, 3, padding=1, bias=False),
                         BatchNorm2d(cout, eps=_BN_EPS),
                         nn.LeakyReLU(0.1, inplace=True))


def _upsample(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class PVNet(nn.Module):
    """FCN emitting segmentation logits + keypoint vector field.

    Args mirror the reference constructor (ref model_repository.py:8):
      ver_dim: vector-field channels (2 * keypoint count).
      seg_dim: segmentation classes (2 for a single object).
      fcdim/s8dim/s4dim/s2dim/raw_dim: decoder widths.
      quant_stages, quant_mode: backbone stages run in int8 at inference
        (models/resnet.ResNetBackbone).
      quant_decoder: the fc head's and the 8s stage's convolutions in int8
        at inference, in ``quant_mode`` (JAX models/pvnet.py:114-123).
    """

    def __init__(self, ver_dim: int, seg_dim: int = 2, fcdim: int = 256,
                 s8dim: int = 128, s4dim: int = 64, s2dim: int = 32,
                 raw_dim: int = 32, quant_stages=(),
                 quant_mode: str = "dynamic", quant_decoder: bool = False):
        super().__init__()
        self.ver_dim, self.seg_dim = ver_dim, seg_dim
        backbone = resnet18_backbone(output_stride=8,
                                     quant_stages=tuple(quant_stages),
                                     quant_mode=quant_mode)
        dconv = (partial(QuantConv2d, mode=quant_mode) if quant_decoder
                 else nn.Conv2d)
        # the fc head lives under the backbone module, as in the reference
        # (ref model_repository.py:21-26)
        backbone.fc = nn.Sequential(
            dconv(backbone.inplanes, fcdim, 3, padding=1, bias=False),
            BatchNorm2d(fcdim, eps=_BN_EPS),
            nn.ReLU(inplace=True))
        self.resnet18_8s = backbone
        self.conv8s = _conv_bn_lrelu(128 + fcdim, s8dim, dconv)
        self.conv4s = _conv_bn_lrelu(64 + s8dim, s4dim)
        self.conv2s = _conv_bn_lrelu(64 + s4dim, s2dim)
        self.convraw = nn.Sequential(
            nn.Conv2d(3 + s2dim, raw_dim, 3, padding=1, bias=False),
            BatchNorm2d(raw_dim, eps=_BN_EPS),
            nn.LeakyReLU(0.1, inplace=True),
            nn.Conv2d(raw_dim, seg_dim + ver_dim, 1))

    def forward(self, x: torch.Tensor, return_2s_features: bool = False,
                return_4s_features: bool = False,
                return_8s_features: bool = False):
        """x: [b, 3, h, w] ImageNet-normalized image.

        Returns (seg [b, seg_dim, h, w] logits, ver [b, ver_dim, h, w]).
        The feature flags stop the decoder early and return the inputs of
        the packed inference tail (ops/packed_tail.py), as the JAX model's
        flags of the same names do, channel-major:
        return_8s_features -> (fm8 [b, s8dim, h/8, w/8], x4s, x2s), the 8s
        stage's activation before its upsample and the backbone skips;
        return_4s_features -> (fm4 [b, s4dim, h/4, w/4], x2s);
        return_2s_features -> fm2 [b, s2dim, h/2, w/2]."""
        h, w = x.shape[2:]
        x2s, x4s, x8s, _, x32s = self.resnet18_8s(x)
        xfc = self.resnet18_8s.fc(x32s)
        fm = self.conv8s(torch.cat([xfc, x8s], 1))
        if return_8s_features:
            return fm, x4s, x2s
        fm = _upsample(fm, *x4s.shape[2:])
        fm = self.conv4s(torch.cat([fm, x4s], 1))
        if return_4s_features:
            return fm, x2s
        fm = _upsample(fm, *x2s.shape[2:])
        fm = self.conv2s(torch.cat([fm, x2s], 1))
        if return_2s_features:
            return fm
        fm = _upsample(fm, h, w)
        out = self.convraw(torch.cat([fm, x], 1))
        return out[:, :self.seg_dim], out[:, self.seg_dim:]


def pvnet_resnet18(ver_dim: int, seg_dim: int = 2, **kw) -> PVNet:
    """Resnet18_8s equivalent — the production model
    (ref model_repository.py:7-80, train_linemod.py:256)."""
    return PVNet(ver_dim=ver_dim, seg_dim=seg_dim, **kw)


def build_model(network: str, ver_dim: int, seg_dim: int = 2,
                **kw) -> PVNet:
    """Factory keyed by the recipe's ``network`` field; ``kw`` (decoder
    widths, the quant options) goes to the model. Only 'resnet18_8s' is
    ported so far."""
    factories = {"resnet18_8s": pvnet_resnet18}
    if network not in factories:
        raise ValueError(f"unknown network '{network}'; "
                         f"expected one of {sorted(factories)}")
    return factories[network](ver_dim, seg_dim, **kw)
