"""PVNet: fully-convolutional segmentation + vector-field network (PyTorch).

Port of pvnet_tpu/models/pvnet.py (``PVNet``, ``PVNet2o``,
``pvnet_resnet18/34/50``, ``pvnet_resnet50_2o``, ``build_model``), the
reference's ``Resnet18_8s`` family (ref lib/networks/model_repository.py:
7-300): a dilated ResNet backbone (18, 34 or 50 layers) at output stride 8,
a 3x3-conv "fc" head, and a skip-connected decoder that upsamples 8s -> 4s
-> 2s -> full resolution (bilinear, align_corners=True) and emits
``seg_dim + ver_dim`` channels through a 1x1 head. ``PVNet2o`` stops at
half resolution.

Outputs are channel-major — seg [b, seg_dim, h, w], ver [b, ver_dim, h, w]
— which is the JAX model's head_layout='NCHW' emission and PyTorch's
native layout. Module names follow the reference (resnet18_8s.fc,
conv8s, conv4s, conv2s, convraw; the backbone is ``resnet34_8s`` or
``resnet50_8s`` at the other depths), so a reference state_dict loads as
is.
The feature-return flags of the JAX model feed the packed inference tail
(ops/packed_tail.py). ``quant_stages``, ``quant_mode`` and
``quant_decoder`` are the JAX model's int8 options (ops/quant_conv.py):
they change no parameter, so the same checkpoint loads either way.
``stem='packed4'`` is the JAX model's packed stem (models/resnet.py): the
model then also takes a space-to-depth-packed image [b, 12, h/2, w/2], and
unpacks it for the raw head's image term. A conv7 checkpoint loads into it
through utils/weights.load_weights, which folds the stem's kernel. The
TPU-only layout switches (channel-major head conv, NCHW stem input) are
not ported: the port is channel-major throughout.

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

from pvnet_tpu_torch.models.resnet import (_BN_EPS, BasicBlock,
                                          BatchNorm2d, Bottleneck,
                                          ResNetBackbone, arch_layout,
                                          arch_name, depth_to_space2_cm)
from pvnet_tpu_torch.ops.quant_conv import QuantConv2d


def _conv_bn_lrelu(cin: int, cout: int, conv=nn.Conv2d) -> nn.Sequential:
    return nn.Sequential(conv(cin, cout, 3, padding=1, bias=False),
                         BatchNorm2d(cout, eps=_BN_EPS),
                         nn.LeakyReLU(0.1, inplace=True))


def _upsample(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def _fc_head(backbone: ResNetBackbone, fcdim: int, conv=nn.Conv2d) -> None:
    """The fc head lives under the backbone module, as in the reference
    (ref model_repository.py:21-26)."""
    backbone.fc = nn.Sequential(
        conv(backbone.inplanes, fcdim, 3, padding=1, bias=False),
        BatchNorm2d(fcdim, eps=_BN_EPS),
        nn.ReLU(inplace=True))


class _Backbone:
    """The backbone module of a model that names it after its depth
    (``resnet18_8s``, ``resnet34_8s``, ``resnet50_8s``), as the
    reference's state_dicts do, and the decoder's upsample."""

    @property
    def backbone(self) -> ResNetBackbone:
        return getattr(self, f"{self.arch}_8s")

    def upsample(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """The decoder's bilinear align-corners upsample to [h, w]: a
        method, so that a row-sharded copy of the model
        (parallel/spatial.py) can compute it from the global heights."""
        return _upsample(x, h, w)


class PVNet(_Backbone, nn.Module):
    """FCN emitting segmentation logits + keypoint vector field.

    Args mirror the reference constructor (ref model_repository.py:8):
      ver_dim: vector-field channels (2 * keypoint count).
      seg_dim: segmentation classes (2 for a single object).
      block, stage_sizes: the backbone's (BasicBlock (2, 2, 2, 2) is
        ResNet18, (3, 4, 6, 3) ResNet34; Bottleneck (3, 4, 6, 3) ResNet50).
      fcdim/s8dim/s4dim/s2dim/raw_dim: decoder widths.
      quant_stages, quant_mode: backbone stages run in int8 at inference
        (models/resnet.ResNetBackbone).
      quant_decoder: the fc head's and the 8s stage's convolutions in int8
        at inference, in ``quant_mode`` (JAX models/pvnet.py:114-123).
      stem: 'conv7' or 'packed4' (models/resnet.ResNetBackbone).
    """

    def __init__(self, ver_dim: int, seg_dim: int = 2, block=BasicBlock,
                 stage_sizes=(2, 2, 2, 2), fcdim: int = 256,
                 s8dim: int = 128, s4dim: int = 64, s2dim: int = 32,
                 raw_dim: int = 32, quant_stages=(),
                 quant_mode: str = "dynamic", quant_decoder: bool = False,
                 stem: str = "conv7"):
        super().__init__()
        self.ver_dim, self.seg_dim = ver_dim, seg_dim
        self.arch = arch_name(block, stage_sizes)
        backbone = ResNetBackbone(stage_sizes=tuple(stage_sizes),
                                  output_stride=8, block=block,
                                  quant_stages=tuple(quant_stages),
                                  quant_mode=quant_mode, stem=stem)
        dconv = (partial(QuantConv2d, mode=quant_mode) if quant_decoder
                 else nn.Conv2d)
        _fc_head(backbone, fcdim, dconv)
        setattr(self, f"{self.arch}_8s", backbone)
        # the skips' widths: x8s is layer2's, x4s layer1's
        e = block.expansion
        self.conv8s = _conv_bn_lrelu(128 * e + fcdim, s8dim, dconv)
        self.conv4s = _conv_bn_lrelu(64 * e + s8dim, s4dim)
        self.conv2s = _conv_bn_lrelu(64 + s4dim, s2dim)
        self.convraw = nn.Sequential(
            nn.Conv2d(3 + s2dim, raw_dim, 3, padding=1, bias=False),
            BatchNorm2d(raw_dim, eps=_BN_EPS),
            nn.LeakyReLU(0.1, inplace=True),
            nn.Conv2d(raw_dim, seg_dim + ver_dim, 1))

    def forward(self, x: torch.Tensor, return_2s_features: bool = False,
                return_4s_features: bool = False,
                return_8s_features: bool = False):
        """x: [b, 3, h, w] ImageNet-normalized image, or with the packed4
        stem its packed form [b, 12, h/2, w/2] (models/resnet.py).

        Returns (seg [b, seg_dim, h, w] logits, ver [b, ver_dim, h, w]).
        The feature flags stop the decoder early and return the inputs of
        the packed inference tail (ops/packed_tail.py), as the JAX model's
        flags of the same names do, channel-major:
        return_8s_features -> (fm8 [b, s8dim, h/8, w/8], x4s, x2s), the 8s
        stage's activation before its upsample and the backbone skips;
        return_4s_features -> (fm4 [b, s4dim, h/4, w/4], x2s);
        return_2s_features -> fm2 [b, s2dim, h/2, w/2]."""
        x2s, x4s, x8s, _, x32s = self.backbone(x)
        xfc = self.backbone.fc(x32s)
        fm = self.conv8s(torch.cat([xfc, x8s], 1))
        if return_8s_features:
            return fm, x4s, x2s
        fm = self.upsample(fm, *x4s.shape[2:])
        fm = self.conv4s(torch.cat([fm, x4s], 1))
        if return_4s_features:
            return fm, x2s
        fm = self.upsample(fm, *x2s.shape[2:])
        fm = self.conv2s(torch.cat([fm, x2s], 1))
        if return_2s_features:
            return fm
        if x.shape[1] == 12:                    # packed image (packed4)
            x = depth_to_space2_cm(x)
        fm = self.upsample(fm, *x.shape[2:])
        out = self.convraw(torch.cat([fm, x], 1))
        return out[:, :self.seg_dim], out[:, self.seg_dim:]


def downsample_bilinear_half(x: torch.Tensor) -> torch.Tensor:
    """[b, c, h, w] -> [b, c, h/2, w/2] (h, w even): the JAX function's 0.5x
    bilinear downsample with half-pixel sampling (torch F.interpolate(
    scale_factor=0.5, mode='bilinear', align_corners=False)), which samples
    each output between two input pixels: the mean of every 2x2 block."""
    return F.avg_pool2d(x, 2)


class PVNet2o(_Backbone, nn.Module):
    """Half-resolution-output PVNet (ref Resnet50_8s_2o,
    model_repository.py:158-224; the JAX ``PVNet2o``).

    The decoder stops at stride 2: conv8s -> up -> conv4s -> up -> a 2s
    stage whose input concatenates the decoder features, the backbone's
    x2s skip and a 0.5x bilinear copy of the input image (ref :219-220),
    then a 1x1 head (``conv2s.3``) emits seg_dim + ver_dim channels at
    h/2 x w/2. forward(x [b, 3, h, w], h and w even) -> (seg [b, seg_dim,
    h/2, w/2], ver [b, ver_dim, h/2, w/2])."""

    def __init__(self, ver_dim: int, seg_dim: int = 2, block=Bottleneck,
                 stage_sizes=(3, 4, 6, 3), fcdim: int = 384,
                 s8dim: int = 256, s4dim: int = 128, s2dim: int = 64,
                 quant_stages=(), quant_mode: str = "dynamic"):
        super().__init__()
        self.ver_dim, self.seg_dim = ver_dim, seg_dim
        self.arch = arch_name(block, stage_sizes)
        backbone = ResNetBackbone(stage_sizes=tuple(stage_sizes),
                                  output_stride=8, block=block,
                                  quant_stages=tuple(quant_stages),
                                  quant_mode=quant_mode)
        _fc_head(backbone, fcdim)
        setattr(self, f"{self.arch}_8s", backbone)
        e = block.expansion
        self.conv8s = _conv_bn_lrelu(128 * e + fcdim, s8dim)
        self.conv4s = _conv_bn_lrelu(64 * e + s8dim, s4dim)
        self.conv2s = _conv_bn_lrelu(s4dim + 64 + 3, s2dim)
        self.conv2s.append(nn.Conv2d(s2dim, seg_dim + ver_dim, 1))

    def forward(self, x: torch.Tensor):
        x2s, x4s, x8s, _, x32s = self.backbone(x)
        xfc = self.backbone.fc(x32s)
        fm = self.conv8s(torch.cat([xfc, x8s], 1))
        fm = self.upsample(fm, *x4s.shape[2:])
        fm = self.conv4s(torch.cat([fm, x4s], 1))
        fm = self.upsample(fm, *x2s.shape[2:])
        out = self.conv2s(torch.cat([fm, x2s, downsample_bilinear_half(x)],
                                    1))
        return out[:, :self.seg_dim], out[:, self.seg_dim:]


def pvnet_resnet18(ver_dim: int, seg_dim: int = 2, **kw) -> PVNet:
    """Resnet18_8s equivalent — the production model
    (ref model_repository.py:7-80, train_linemod.py:256)."""
    return PVNet(ver_dim, seg_dim, *arch_layout("resnet18"), **kw)


def pvnet_resnet34(ver_dim: int, seg_dim: int = 2, **kw) -> PVNet:
    """Resnet34_8s equivalent (ref model_repository.py:226-300)."""
    return PVNet(ver_dim, seg_dim, *arch_layout("resnet34"), **kw)


def pvnet_resnet50(ver_dim: int, seg_dim: int = 2, **kw) -> PVNet:
    """Resnet50_8s equivalent (ref model_repository.py:82-156), with its
    wider decoder."""
    kw = {"fcdim": 384, "s8dim": 256, "s4dim": 128, "s2dim": 64,
          "raw_dim": 64, **kw}
    return PVNet(ver_dim, seg_dim, *arch_layout("resnet50"), **kw)


def pvnet_resnet50_2o(ver_dim: int, seg_dim: int = 2, **kw) -> PVNet2o:
    """Resnet50_8s_2o equivalent — half-resolution output
    (ref model_repository.py:158-224)."""
    return PVNet2o(ver_dim, seg_dim, **kw)


def build_model(network: str, ver_dim: int, seg_dim: int = 2,
                **kw) -> nn.Module:
    """Factory keyed by the recipe's ``network`` field; ``kw`` (decoder
    widths, the quant options) goes to the model."""
    factories = {"resnet18_8s": pvnet_resnet18,
                 "resnet34_8s": pvnet_resnet34,
                 "resnet50_8s": pvnet_resnet50,
                 "resnet50_8s_2o": pvnet_resnet50_2o}
    if network not in factories:
        raise ValueError(f"unknown network '{network}'; "
                         f"expected one of {sorted(factories)}")
    return factories[network](ver_dim, seg_dim, **kw)
