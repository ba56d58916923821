"""PVNet's Resnet18_8s forward pass in plain PyTorch, float32.

The published network (PVNet, lib/networks/model_repository.py
``Resnet18_8s``): a torchvision ResNet18 whose strides become dilations
once the output stride reaches 8 (layer3 dilation 2, layer4 dilation 4,
each 3x3 convolution padded by its dilation), a 3x3 "fc" head of 256
channels on the stride-8 features, and a decoder with skips: conv8s (128)
on [fc, layer2], bilinear (align_corners) up to stride 4, conv4s (64) on
[., layer1], up to stride 2, conv2s (32) on [., stem], up to full size,
convraw (32) on [., image], then a 1x1 head of seg_dim + ver_dim channels.
Every 3x3 convolution of the decoder is followed by BatchNorm and
LeakyReLU(0.1); the backbone's by BatchNorm and ReLU.

Parameters are a flat dict under the published PyTorch names
(``resnet18_8s.layer1.0.conv1.weight``, ``conv8s.0.weight``, ...; conv
kernels OIHW). :func:`params_from_flax` builds that dict from a flax
msgpack checkpoint tree on its own. ``conv`` is the convolution every
layer calls, so that a control can run the same network in a lower
precision (reference/lowp.py).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BACKBONE = "resnet18_8s"
STAGE_SIZES = (2, 2, 2, 2)
STAGE_WIDTHS = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 2, 2)
DECODER = (("conv8s", 128), ("conv4s", 64), ("conv2s", 32), ("convraw", 32))

Params = Dict[str, torch.Tensor]


def blocks(output_stride: int = 8) -> List[dict]:
    """The backbone's BasicBlocks in order: name, planes in and out,
    stride, dilation and whether a 1x1 projection shortcut exists."""
    out, current, dilation, inplanes = [], 4, 1, 64
    for stage, (n, planes, stride) in enumerate(
            zip(STAGE_SIZES, STAGE_WIDTHS, STAGE_STRIDES)):
        if stride != 1:
            if current == output_stride:
                dilation *= stride
                stride = 1
            else:
                current *= stride
        for i in range(n):
            s = stride if i == 0 else 1
            out.append({"name": f"{BACKBONE}.layer{stage + 1}.{i}",
                        "cin": inplanes, "cout": planes, "stride": s,
                        "dilation": dilation,
                        "project": s != 1 or inplanes != planes})
            inplanes = planes
    return out


def conv_shapes(seg_dim: int = 2, ver_dim: int = 18,
                fcdim: int = 256) -> Dict[str, Tuple[int, ...]]:
    """Every convolution weight's OIHW shape (and the head's bias), by
    name."""
    shapes = {f"{BACKBONE}.conv1.weight": (64, 3, 7, 7)}
    for blk in blocks():
        n, ci, co = blk["name"], blk["cin"], blk["cout"]
        shapes[f"{n}.conv1.weight"] = (co, ci, 3, 3)
        shapes[f"{n}.conv2.weight"] = (co, co, 3, 3)
        if blk["project"]:
            shapes[f"{n}.downsample.0.weight"] = (co, ci, 1, 1)
    shapes[f"{BACKBONE}.fc.0.weight"] = (fcdim, 512, 3, 3)
    cin = (fcdim + 128, 128 + 64, 64 + 64, 32 + 3)
    for (name, width), ci in zip(DECODER, cin):
        shapes[f"{name}.0.weight"] = (width, ci, 3, 3)
    shapes["convraw.3.weight"] = (seg_dim + ver_dim, 32, 1, 1)
    shapes["convraw.3.bias"] = (seg_dim + ver_dim,)
    return shapes


def bn_names() -> List[Tuple[str, int]]:
    """Every BatchNorm module's name and width."""
    names = [(f"{BACKBONE}.bn1", 64)]
    for blk in blocks():
        names += [(f"{blk['name']}.bn1", blk["cout"]),
                  (f"{blk['name']}.bn2", blk["cout"])]
        if blk["project"]:
            names.append((f"{blk['name']}.downsample.1", blk["cout"]))
    names.append((f"{BACKBONE}.fc.1", 256))
    names += [(f"{name}.1", width) for name, width in DECODER]
    return names


def params_from_flax(tree: dict, device) -> Params:
    """A flax PVNet variables tree ({'params', 'batch_stats'}, HWIO
    kernels) -> the flat float32 dict of this module. Flax names its
    modules by class and creation order: the trunk is ResNetBackbone_0
    (Conv_0 / BatchNorm_0 the stem, BasicBlock_i with Conv_0, Conv_1 and,
    for a projection, Conv_2, with their BatchNorm_j), the decoder is the
    top level's Conv_0..Conv_4 (fc, conv8s, conv4s, conv2s, convraw) with
    BatchNorm_0..4, and Conv_5 the head."""
    prm, st = tree["params"], tree.get("batch_stats", {})

    def walk(d, path):
        for k in path.split("/"):
            d = d[k]
        return d

    def kernel(path):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(walk(prm, path + "/kernel"),
                       np.float32).transpose(3, 2, 0, 1)))

    out: Params = {}

    def bn(name, path):
        out[f"{name}.weight"] = torch.from_numpy(
            np.asarray(walk(prm, path + "/scale"), np.float32))
        out[f"{name}.bias"] = torch.from_numpy(
            np.asarray(walk(prm, path + "/bias"), np.float32))
        out[f"{name}.running_mean"] = torch.from_numpy(
            np.asarray(walk(st, path + "/mean"), np.float32))
        out[f"{name}.running_var"] = torch.from_numpy(
            np.asarray(walk(st, path + "/var"), np.float32))

    trunk = "ResNetBackbone_0"
    out[f"{BACKBONE}.conv1.weight"] = kernel(f"{trunk}/Conv_0")
    bn(f"{BACKBONE}.bn1", f"{trunk}/BatchNorm_0")
    for i, blk in enumerate(blocks()):
        n, fb = blk["name"], f"{trunk}/BasicBlock_{i}"
        out[f"{n}.conv1.weight"] = kernel(f"{fb}/Conv_0")
        out[f"{n}.conv2.weight"] = kernel(f"{fb}/Conv_1")
        bn(f"{n}.bn1", f"{fb}/BatchNorm_0")
        bn(f"{n}.bn2", f"{fb}/BatchNorm_1")
        if blk["project"]:
            out[f"{n}.downsample.0.weight"] = kernel(f"{fb}/Conv_2")
            bn(f"{n}.downsample.1", f"{fb}/BatchNorm_2")
    heads = [f"{BACKBONE}.fc"] + [name for name, _ in DECODER]
    for i, name in enumerate(heads):
        out[f"{name}.0.weight"] = kernel(f"Conv_{i}")
        bn(f"{name}.1", f"BatchNorm_{i}")
    out["convraw.3.weight"] = kernel("Conv_5")
    out["convraw.3.bias"] = torch.from_numpy(
        np.asarray(walk(prm, "Conv_5/bias"), np.float32))
    return {k: v.to(device) for k, v in out.items()}


def _bn(p: Params, name: str, x: torch.Tensor, train: bool) -> torch.Tensor:
    """Eval: the running statistics. Train: the batch's mean and biased
    variance (what normalizes in both PyTorch and flax); the running
    statistics are not touched."""
    if train:
        return F.batch_norm(x, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], training=True, eps=BN_EPS)
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], training=False, eps=BN_EPS)


def _up(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def forward(p: Params, x: torch.Tensor, train: bool = False,
            conv: Callable = F.conv2d, seg_dim: int = 2
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, 3, h, w] ImageNet-normalized float32 -> (seg [b, seg_dim, h,
    w] logits, ver [b, ver_dim, h, w]). ``train`` normalizes with the
    batch's statistics."""
    relu, lrelu = F.relu, lambda t: F.leaky_relu(t, 0.1)
    b0 = BACKBONE
    x2s = relu(_bn(p, f"{b0}.bn1", conv(x, p[f"{b0}.conv1.weight"], None,
                                        2, 3), train))
    y = F.max_pool2d(x2s, 3, 2, 1)
    feats = {}
    for blk in blocks():
        n, d = blk["name"], blk["dilation"]
        res = y
        if blk["project"]:
            res = _bn(p, f"{n}.downsample.1",
                      conv(y, p[f"{n}.downsample.0.weight"], None,
                           blk["stride"]), train)
        z = relu(_bn(p, f"{n}.bn1", conv(y, p[f"{n}.conv1.weight"], None,
                                          blk["stride"], d, d), train))
        z = _bn(p, f"{n}.bn2", conv(z, p[f"{n}.conv2.weight"], None, 1, d,
                                     d), train)
        y = relu(z + res)
        feats[n.split(".")[1]] = y
    x4s, x8s, x32s = feats["layer1"], feats["layer2"], feats["layer4"]
    fc = relu(_bn(p, f"{b0}.fc.1", conv(x32s, p[f"{b0}.fc.0.weight"], None,
                                         1, 1), train))

    def stage(name, t):
        return lrelu(_bn(p, f"{name}.1", conv(t, p[f"{name}.0.weight"],
                                              None, 1, 1), train))

    fm = stage("conv8s", torch.cat([fc, x8s], 1))
    fm = stage("conv4s", torch.cat([_up(fm, x4s.shape[2:]), x4s], 1))
    fm = stage("conv2s", torch.cat([_up(fm, x2s.shape[2:]), x2s], 1))
    fm = stage("convraw", torch.cat([_up(fm, x.shape[2:]), x], 1))
    out = conv(fm, p["convraw.3.weight"], p["convraw.3.bias"])
    return out[:, :seg_dim], out[:, seg_dim:]
