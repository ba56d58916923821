"""PVNet's *_8s networks' forward pass in plain PyTorch, float32, built
from a configuration's own description of its network.

The published networks (PVNet, lib/networks/model_repository.py
``Resnet18_8s``, ``Resnet34_8s``, ``Resnet50_8s``): a torchvision ResNet
whose strides become dilations once the output stride reaches 8 (layer3
dilation 2, layer4 dilation 4, each 3x3 convolution padded by its
dilation), a 3x3 "fc" head of ``fcdim`` channels on the stride-8
features, and a decoder with skips: conv8s (``s8dim``) on [fc, layer2],
bilinear (align_corners) up to stride 4, conv4s (``s4dim``) on [.,
layer1], up to stride 2, conv2s (``s2dim``) on [., stem], up to full size,
convraw (``raw_dim``) on [., image], then a 1x1 head of seg_dim + ver_dim
channels. Every 3x3 convolution of the decoder is followed by BatchNorm
and LeakyReLU(0.1); the backbone's by BatchNorm and ReLU.

A configuration (``pvbench/configs/<name>.json``) describes its network
by these keys, which every function here reads:

- ``network``: the backbone's module name (``resnet18_8s``,
  ``resnet34_8s``, ``resnet50_8s``), the prefix of its weights' names;
- ``block``: ``BasicBlock`` (two 3x3 convolutions) or ``Bottleneck``
  (1x1, 3x3 carrying the stride and the dilation, 1x1 to 4x the width;
  PVNet's lib/networks/resnet.py:73-113), with a 1x1 projection shortcut
  wherever the stride or the width changes;
- ``stage_sizes``: the blocks of layer1..layer4 (planes 64, 128, 256,
  512, times 4 out of a Bottleneck), ``output_stride``: 8;
- ``fcdim``, ``s8dim``, ``s4dim``, ``s2dim``, ``raw_dim``: the head's and
  the decoder's widths, whose inputs follow the skips (layer2's and
  layer1's outputs, 4x as wide for a Bottleneck);
- ``seg_dim``, ``ver_dim``: the output channels.

Parameters are a flat dict under the published PyTorch names
(``resnet50_8s.layer3.0.conv3.weight``, ``...downsample.0.weight``,
``conv8s.0.weight``, ...; conv kernels OIHW). :func:`params_from_flax`
builds that dict from a flax msgpack checkpoint of a BasicBlock network
on its own; :func:`calibrate` sets seeded weights' BatchNorm statistics.
``conv`` is the convolution every layer calls, so that a control can run
the same network in a lower precision (reference/lowp.py).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
STAGE_WIDTHS = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 2, 2)
EXPANSION = {"BasicBlock": 1, "Bottleneck": 4}

Params = Dict[str, torch.Tensor]


def expansion(cfg: dict) -> int:
    if cfg["block"] not in EXPANSION:
        raise ValueError(f"block {cfg['block']!r} is not one of "
                         f"{sorted(EXPANSION)}")
    return EXPANSION[cfg["block"]]


def decoder(cfg: dict) -> List[Tuple[str, int, int]]:
    """The decoder's 3x3 stages in order: name, input and output width."""
    e = expansion(cfg)
    return [("conv8s", cfg["fcdim"] + 128 * e, cfg["s8dim"]),
            ("conv4s", cfg["s8dim"] + 64 * e, cfg["s4dim"]),
            ("conv2s", cfg["s4dim"] + 64, cfg["s2dim"]),
            ("convraw", cfg["s2dim"] + 3, cfg["raw_dim"])]


def blocks(cfg: dict) -> List[dict]:
    """The backbone's blocks in order: name, layer, planes in, inner and
    out, stride, dilation and whether a 1x1 projection shortcut exists."""
    e = expansion(cfg)
    out, current, dilation, inplanes = [], 4, 1, 64
    for stage, (n, planes, stride) in enumerate(
            zip(cfg["stage_sizes"], STAGE_WIDTHS, STAGE_STRIDES)):
        if stride != 1:
            if current == cfg["output_stride"]:
                dilation *= stride
                stride = 1
            else:
                current *= stride
        for i in range(n):
            s = stride if i == 0 else 1
            out.append({"name": f"{cfg['network']}.layer{stage + 1}.{i}",
                        "layer": f"layer{stage + 1}", "cin": inplanes,
                        "planes": planes, "cout": planes * e, "stride": s,
                        "dilation": dilation,
                        "project": s != 1 or inplanes != planes * e})
            inplanes = planes * e
    return out


def block_convs(cfg: dict, blk: dict) -> List[Tuple[str, int, int, int,
                                                      int, int]]:
    """A block's convolutions in order: name (under the block), c_in,
    c_out, kernel size, stride and dilation (a 3x3 one pads by its
    dilation, a 1x1 one not at all); the shortcut's last."""
    ci, pl, co = blk["cin"], blk["planes"], blk["cout"]
    s, d = blk["stride"], blk["dilation"]
    if cfg["block"] == "Bottleneck":
        convs = [("conv1", ci, pl, 1, 1, 1), ("conv2", pl, pl, 3, s, d),
                 ("conv3", pl, co, 1, 1, 1)]
    else:
        convs = [("conv1", ci, co, 3, s, d), ("conv2", co, co, 3, 1, d)]
    if blk["project"]:
        convs.append(("downsample.0", ci, co, 1, s, 1))
    return convs


def conv_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every convolution weight's OIHW shape (and the head's bias), by
    name, in the order of the forward pass."""
    b0 = cfg["network"]
    shapes = {f"{b0}.conv1.weight": (64, 3, 7, 7)}
    for blk in blocks(cfg):
        for name, ci, co, k, _, _ in block_convs(cfg, blk):
            shapes[f"{blk['name']}.{name}.weight"] = (co, ci, k, k)
    shapes[f"{b0}.fc.0.weight"] = (cfg["fcdim"], blocks(cfg)[-1]["cout"],
                                   3, 3)
    for name, ci, co in decoder(cfg):
        shapes[f"{name}.0.weight"] = (co, ci, 3, 3)
    heads = cfg["seg_dim"] + cfg["ver_dim"]
    shapes["convraw.3.weight"] = (heads, cfg["raw_dim"], 1, 1)
    shapes["convraw.3.bias"] = (heads,)
    return shapes


def bn_names(cfg: dict) -> List[Tuple[str, int]]:
    """Every BatchNorm module's name and width."""
    b0 = cfg["network"]
    names = [(f"{b0}.bn1", 64)]
    for blk in blocks(cfg):
        for name, _, co, _, _, _ in block_convs(cfg, blk):
            bn = (f"{blk['name']}.downsample.1" if name == "downsample.0"
                  else f"{blk['name']}.bn{name[-1]}")
            names.append((bn, co))
    names.append((f"{b0}.fc.1", cfg["fcdim"]))
    names += [(f"{name}.1", co) for name, _, co in decoder(cfg)]
    return names


def params_from_flax(tree: dict, device, cfg: dict) -> Params:
    """A flax PVNet variables tree ({'params', 'batch_stats'}, HWIO
    kernels) of a BasicBlock network -> the flat float32 dict of this
    module. Flax names its modules by class and creation order: the trunk
    is ResNetBackbone_0 (Conv_0 / BatchNorm_0 the stem, BasicBlock_i with
    Conv_0, Conv_1 and, for a projection, Conv_2, with their
    BatchNorm_j), the decoder is the top level's Conv_0..Conv_4 (fc,
    conv8s, conv4s, conv2s, convraw) with BatchNorm_0..4, and Conv_5 the
    head."""
    if cfg["block"] != "BasicBlock":
        raise ValueError(f"params_from_flax reads BasicBlock checkpoints; "
                         f"{cfg['network']} has {cfg['block']} blocks "
                         f"(give it \"weights\": \"seeded\")")
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

    trunk, b0 = "ResNetBackbone_0", cfg["network"]
    out[f"{b0}.conv1.weight"] = kernel(f"{trunk}/Conv_0")
    bn(f"{b0}.bn1", f"{trunk}/BatchNorm_0")
    for i, blk in enumerate(blocks(cfg)):
        n, fb = blk["name"], f"{trunk}/BasicBlock_{i}"
        out[f"{n}.conv1.weight"] = kernel(f"{fb}/Conv_0")
        out[f"{n}.conv2.weight"] = kernel(f"{fb}/Conv_1")
        bn(f"{n}.bn1", f"{fb}/BatchNorm_0")
        bn(f"{n}.bn2", f"{fb}/BatchNorm_1")
        if blk["project"]:
            out[f"{n}.downsample.0.weight"] = kernel(f"{fb}/Conv_2")
            bn(f"{n}.downsample.1", f"{fb}/BatchNorm_2")
    heads = [f"{b0}.fc"] + [name for name, _, _ in decoder(cfg)]
    for i, name in enumerate(heads):
        out[f"{name}.0.weight"] = kernel(f"Conv_{i}")
        bn(f"{name}.1", f"BatchNorm_{i}")
    out["convraw.3.weight"] = kernel("Conv_5")
    out["convraw.3.bias"] = torch.from_numpy(
        np.asarray(walk(prm, "Conv_5/bias"), np.float32))
    return {k: v.to(device) for k, v in out.items()}


def _bn(p: Params, name: str, x: torch.Tensor, train: bool,
        stats: Optional[dict]) -> torch.Tensor:
    """Eval: the running statistics. Train: the batch's mean and biased
    variance (what normalizes in both PyTorch and flax); the running
    statistics are not touched, and ``stats``, where given, keeps the
    batch's (mean, biased variance) under ``name``."""
    if train:
        if stats is not None:
            stats[name] = (x.mean((0, 2, 3)),
                           x.var((0, 2, 3), unbiased=False))
        return F.batch_norm(x, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], training=True, eps=BN_EPS)
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], training=False, eps=BN_EPS)


def _up(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def forward(p: Params, x: torch.Tensor, cfg: dict, train: bool = False,
            conv: Callable = F.conv2d, stats: Optional[dict] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b, 3, h, w] ImageNet-normalized float32 -> (seg [b, seg_dim, h,
    w] logits, ver [b, ver_dim, h, w]) of the network ``cfg`` describes.
    ``train`` normalizes with the batch's statistics (and keeps them in
    ``stats``, where given)."""
    relu, lrelu = F.relu, lambda t: F.leaky_relu(t, 0.1)
    b0 = cfg["network"]

    def bn(name, t):
        return _bn(p, name, t, train, stats)

    x2s = relu(bn(f"{b0}.bn1", conv(x, p[f"{b0}.conv1.weight"], None, 2,
                                    3)))
    y = F.max_pool2d(x2s, 3, 2, 1)
    feats = {}
    for blk in blocks(cfg):
        n = blk["name"]
        convs = block_convs(cfg, blk)
        res = y
        if blk["project"]:
            _, _, _, _, s, _ = convs.pop()
            res = bn(f"{n}.downsample.1",
                     conv(y, p[f"{n}.downsample.0.weight"], None, s))
        z = y
        for i, (name, _, _, k, s, d) in enumerate(convs):
            pad = d if k == 3 else 0
            z = bn(f"{n}.bn{i + 1}", conv(z, p[f"{n}.{name}.weight"], None,
                                          s, pad, d))
            if i < len(convs) - 1:
                z = relu(z)
        y = relu(z + res)
        feats[blk["layer"]] = y
    x4s, x8s, x32s = feats["layer1"], feats["layer2"], feats["layer4"]
    fc = relu(bn(f"{b0}.fc.1", conv(x32s, p[f"{b0}.fc.0.weight"], None, 1,
                                    1)))

    def stage(name, t):
        return lrelu(bn(f"{name}.1", conv(t, p[f"{name}.0.weight"], None, 1,
                                          1)))

    fm = stage("conv8s", torch.cat([fc, x8s], 1))
    fm = stage("conv4s", torch.cat([_up(fm, x4s.shape[2:]), x4s], 1))
    fm = stage("conv2s", torch.cat([_up(fm, x2s.shape[2:]), x2s], 1))
    fm = stage("convraw", torch.cat([_up(fm, x.shape[2:]), x], 1))
    out = conv(fm, p["convraw.3.weight"], p["convraw.3.bias"])
    seg_dim = cfg["seg_dim"]
    return out[:, :seg_dim], out[:, seg_dim:]


@torch.no_grad()
def calibrate(p: Params, x: torch.Tensor, cfg: dict) -> Params:
    """Seeded weights' BatchNorm statistics: one float32 train-mode pass
    over ``x``, each layer's batch mean and biased variance made its
    running statistics (in place; returns ``p``). Identity statistics
    would let the activations grow with the depth; these keep them at a
    trained network's scale, where the eval-mode network on ``x`` equals
    the train-mode one."""
    stats: dict = {}
    forward(p, x, cfg, train=True, stats=stats)
    for name, (mean, var) in stats.items():
        p[f"{name}.running_mean"] = mean
        p[f"{name}.running_var"] = var
    return p
