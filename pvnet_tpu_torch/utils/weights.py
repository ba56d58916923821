"""Map a flax PVNet variables tree onto the port's ``state_dict``, and
back.

:func:`state_dict_from_flax` is the inverse of
pvnet_tpu/utils/torch_convert.py (``_backbone_mapping``,
``convert_state_dict``): conv kernels HWIO -> OIHW, BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var. The model is
read off the tree: ``PVNet`` at every depth (``BasicBlock_i`` or
``Bottleneck_i`` blocks, the stages found by their projection shortcuts),
``PVNet2o``, ``Detector``, ``DetectorV2`` and ``VGG16Convs``. The port's
module names are the reference's (``resnet18_8s``, ``resnet34_8s``,
``resnet50_8s``), so the result is also the reference's own state_dict
layout. :func:`flax_from_state_dict` maps the other way, to numpy trees.

Strict both ways: every leaf of the flax tree must be used, and
``load_state_dict`` must find every tensor the model has.

:func:`load_imagenet_backbone` (the JAX ``load_imagenet_backbone``) loads a
torchvision ImageNet checkpoint into a model's backbone, and
:func:`load_reference_checkpoint` (the JAX ``load_torch_checkpoint``) a
reference ``.pth`` into the whole model, both strictly.

:func:`quant_from_flax` and :func:`flax_quant_from_model` carry the int8
models' calibrated activation scales (the flax ``quant`` collection, the
port's QuantConv2d ``act_absmax`` buffers) across, strictly as well.

:func:`fold_stem_state_dict` (the JAX ``fold_stem_params``) carries a
conv7-stem state_dict onto a ``stem='packed4'`` model; :func:`load_weights`
applies it when the model has the packed stem.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.utils import flax_msgpack


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


_BLOCKS = {"BasicBlock": (2, 1), "Bottleneck": (3, 4)}   # convs, expansion
_BACKBONE_NAMES = {("BasicBlock", (2, 2, 2, 2)): "resnet18_8s",
                   ("BasicBlock", (3, 4, 6, 3)): "resnet34_8s",
                   ("Bottleneck", (3, 4, 6, 3)): "resnet50_8s"}


def _join(prefix: str, name: str) -> str:
    return f"{prefix}/{name}" if prefix else name


def _backbone_pairs(bp: str, fb: str, kind: str, stage_sizes
                    ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """(conv pairs, BatchNorm pairs) of (torch prefix, flax module path) of
    a ResNet trunk: torch module prefix ``bp`` (with its dot), flax module
    ``fb`` ('' at the top level), blocks ``kind``. Mirrors
    torch_convert._backbone_mapping."""
    n_conv, expansion = _BLOCKS[kind]
    convs = [(f"{bp}conv1", _join(fb, "Conv_0"))]
    bns = [(f"{bp}bn1", _join(fb, "BatchNorm_0"))]
    idx, inplanes = 0, 64
    for stage, (n, planes, stride) in enumerate(
            zip(stage_sizes, (64, 128, 256, 512), (1, 2, 2, 2))):
        for i in range(n):
            name = _join(fb, f"{kind}_{idx}")
            tp = f"{bp}layer{stage + 1}.{i}"
            for ci in range(n_conv):
                convs.append((f"{tp}.conv{ci + 1}", f"{name}/Conv_{ci}"))
                bns.append((f"{tp}.bn{ci + 1}", f"{name}/BatchNorm_{ci}"))
            if i == 0 and (stride != 1 or inplanes != planes * expansion):
                convs.append((f"{tp}.downsample.0", f"{name}/Conv_{n_conv}"))
                bns.append((f"{tp}.downsample.1",
                            f"{name}/BatchNorm_{n_conv}"))
            idx += 1
        inplanes = planes * expansion
    return convs, bns


def _pairs(layout) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """(conv pairs, BatchNorm pairs) of (torch prefix, flax module path), in
    construction order, of a model ``layout`` = (family, block kind,
    stage_sizes) from :func:`_layout_of_flax` / :func:`_layout_of_torch`."""
    family, kind, stage_sizes = layout
    if family == "vgg":
        convs = [(f"backbone.conv{b}_{c}", f"VGG16Backbone_0/conv{b}_{c}")
                 for b, n in enumerate((2, 2, 3, 3, 3), 1)
                 for c in range(1, n + 1)]
        convs += [(n, n) for n in ("seg_branch1", "seg_branch2", "seg",
                                   "vertex_branch1", "vertex_branch2",
                                   "vertex")]
        return convs, []
    if family == "detector_v2":
        convs, bns = _backbone_pairs("", "", kind, stage_sizes)
        return convs + [("fc", "Conv_1")], bns
    bp = _BACKBONE_NAMES[(kind, tuple(stage_sizes))] + "."
    convs, bns = _backbone_pairs(bp, "ResNetBackbone_0", kind, stage_sizes)
    if family == "detector":
        return convs + [(f"{bp}fc", "Conv_0")], bns
    # decoder heads (ref model_repository.py:22-58); PVNet2o ends at conv2s
    heads = [f"{bp}fc", "conv8s", "conv4s", "conv2s"]
    if family == "pvnet":
        heads.append("convraw")
    for i, t in enumerate(heads):
        convs.append((f"{t}.0", f"Conv_{i}"))
        bns.append((f"{t}.1", f"BatchNorm_{i}"))
    convs.append((f"{heads[-1]}.3", f"Conv_{len(heads)}"))
    return convs, bns


def _layout_of_flax(params: Dict[str, np.ndarray]):
    """(family, block kind, stage_sizes) of a flattened flax param tree:
    'pvnet', 'pvnet2o', 'detector' (ResNetBackbone_0 and its heads),
    'detector_v2' (a top-level trunk) or 'vgg'. A stage starts at block 0
    and at every block with a projection shortcut."""
    if any(k.startswith("VGG16Backbone_0/") for k in params):
        return "vgg", None, None
    fb = "ResNetBackbone_0" if any(k.startswith("ResNetBackbone_0/")
                                   for k in params) else ""
    blocks = {}
    for k in params:
        if fb and not k.startswith(fb + "/"):
            continue
        kind, _, idx = k.split("/")[1 if fb else 0].rpartition("_")
        if kind in _BLOCKS:
            blocks.setdefault(kind, set()).add(int(idx))
    if len(blocks) != 1:
        raise KeyError(f"no ResNet or VGG16 trunk in the tree "
                       f"({sorted(blocks)})")
    (kind, idx), = blocks.items()
    n_conv = _BLOCKS[kind][0]
    starts = sorted({0} | {i for i in idx if _join(
        fb, f"{kind}_{i}/Conv_{n_conv}/kernel") in params}) + [len(idx)]
    stage_sizes = tuple(b - a for a, b in zip(starts, starts[1:]))
    if not fb:
        family = "detector_v2"
    elif "Conv_5/kernel" in params:
        family = "pvnet"
    elif "BatchNorm_0/scale" not in params:
        family = "detector"
    else:
        family = "pvnet2o"
    return family, kind, stage_sizes


def _layout_of_torch(keys) -> Tuple[str, str, tuple]:
    """:func:`_layout_of_flax` of a state_dict's keys."""
    keys = set(keys)
    if "backbone.conv1_1.weight" in keys:
        return "vgg", None, None
    bp = next((k[:-len("layer1.0.conv1.weight")] for k in keys
               if k.endswith("layer1.0.conv1.weight")), None)
    if bp is None:
        raise KeyError("no ResNet or VGG16 trunk in the state_dict")
    kind = "Bottleneck" if f"{bp}layer1.0.conv3.weight" in keys \
        else "BasicBlock"
    stage_sizes = tuple(
        len({k[len(bp):].split(".")[1] for k in keys
             if k.startswith(f"{bp}layer{s}.")}) for s in (1, 2, 3, 4))
    if not bp:
        family = "detector_v2"
        stage_sizes = tuple(n for n in stage_sizes if n)
    elif "convraw.3.weight" in keys:
        family = "pvnet"
    elif "conv2s.3.weight" in keys:
        family = "pvnet2o"
    else:
        family = "detector"
    return family, kind, stage_sizes


def state_dict_from_flax(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """flax {'params': ..., 'batch_stats': ...} -> the port's float32
    state_dict. Raises if any flax leaf is left unused."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    used = set()

    def take(tree, key, where):
        if key not in tree:
            raise KeyError(f"checkpoint has no {where} leaf {key}")
        used.add((where, key))
        return torch.from_numpy(np.ascontiguousarray(tree[key],
                                                     dtype=np.float32))

    sd = OrderedDict()
    convs, bns = _pairs(_layout_of_flax(params))
    for tp, fp in convs:
        sd[f"{tp}.weight"] = take(params, f"{fp}/kernel",
                                  "params").permute(3, 2, 0, 1).contiguous()
        if f"{fp}/bias" in params:
            sd[f"{tp}.bias"] = take(params, f"{fp}/bias", "params")
    for tp, fp in bns:
        sd[f"{tp}.weight"] = take(params, f"{fp}/scale", "params")
        sd[f"{tp}.bias"] = take(params, f"{fp}/bias", "params")
        sd[f"{tp}.running_mean"] = take(stats, f"{fp}/mean", "batch_stats")
        sd[f"{tp}.running_var"] = take(stats, f"{fp}/var", "batch_stats")
        sd[f"{tp}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    unused = ({("params", k) for k in params}
              | {("batch_stats", k) for k in stats}) - used
    if unused:
        raise KeyError(f"{len(unused)} checkpoint leaves unused: "
                       f"{sorted(unused)[:8]}")
    return sd


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flax_from_state_dict(sd) -> dict:
    """The inverse of :func:`state_dict_from_flax`: the port's state_dict
    (or any dict with its keys, e.g. of gradients) -> flax
    {'params': ..., 'batch_stats': ...} trees of float32 numpy arrays, conv
    kernels OIHW -> HWIO. Raises if a tensor of ``sd`` is left unused
    (``num_batches_tracked`` has no flax counterpart and is skipped)."""
    params, stats = {}, {}
    used = set()

    def take(key):
        if key not in sd:
            raise KeyError(f"state_dict has no {key}")
        used.add(key)
        return np.ascontiguousarray(
            sd[key].detach().to(torch.float32).cpu().numpy())

    convs, bns = _pairs(_layout_of_torch(sd.keys()))
    for tp, fp in convs:
        params[f"{fp}/kernel"] = np.ascontiguousarray(
            take(f"{tp}.weight").transpose(2, 3, 1, 0))
        if f"{tp}.bias" in sd:
            params[f"{fp}/bias"] = take(f"{tp}.bias")
    for tp, fp in bns:
        params[f"{fp}/scale"] = take(f"{tp}.weight")
        params[f"{fp}/bias"] = take(f"{tp}.bias")
        stats[f"{fp}/mean"] = take(f"{tp}.running_mean")
        stats[f"{fp}/var"] = take(f"{tp}.running_var")
        used.add(f"{tp}.num_batches_tracked")
    unused = set(sd) - used
    if unused:
        raise KeyError(f"{len(unused)} state_dict entries unused: "
                       f"{sorted(unused)[:8]}")
    return {"params": _nest(params), "batch_stats": _nest(stats)}


def fold_stem_state_dict(sd) -> "OrderedDict[str, torch.Tensor]":
    """Map a conv7-stem state_dict onto the packed4-stem model (the JAX
    ``fold_stem_params``, pvnet_tpu/models/resnet.py:106): every
    [cout, 3, 7, 7] kernel (only the stem's has that shape) is folded by
    models.resnet.fold_conv7_to_packed4; every other tensor is shared
    unchanged, so an already folded state_dict is returned as it is."""
    from pvnet_tpu_torch.models.resnet import fold_conv7_to_packed4
    return OrderedDict(
        (k, fold_conv7_to_packed4(v) if k.endswith("weight")
         and tuple(v.shape[1:]) == (3, 7, 7) else v) for k, v in sd.items())


def _load(model: torch.nn.Module, sd) -> None:
    """load_state_dict (strict), the stem folded for a packed4 model."""
    if any(getattr(m, "stem", None) == "packed4" for m in model.modules()):
        sd = fold_stem_state_dict(sd)
    model.load_state_dict(sd, strict=True)


def load_pvnet_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a flax msgpack PVNet checkpoint into ``model`` (strict; a
    packed4-stem model takes a conv7 checkpoint's stem folded)."""
    _load(model, state_dict_from_flax(flax_msgpack.load(path)))


def load_weights(model: torch.nn.Module, path: str) -> None:
    """Load network weights into ``model`` (strict) from a flax msgpack
    checkpoint or from a port ``.pth`` checkpoint ({net, optim, epoch},
    train/checkpoint.py). A packed4-stem model takes a conv7 checkpoint
    with its stem folded (:func:`fold_stem_state_dict`)."""
    if path.endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        _load(model, ckpt["net"])
    else:
        load_pvnet_checkpoint(model, path)


def _tensors(sd) -> Dict[str, torch.Tensor]:
    return {k: v if isinstance(v, torch.Tensor)
            else torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def load_imagenet_backbone(model: torch.nn.Module, path_or_sd,
                           arch: str = "resnet18") -> None:
    """Overwrite every backbone tensor of ``model`` with a torchvision
    ImageNet checkpoint's; the heads (the fc head under the backbone
    included) keep their weights. The reference's standard training init
    (ref resnet.py:223-280), as the JAX ``load_imagenet_backbone``
    (pvnet_tpu/utils/torch_convert.py:178).

    ``path_or_sd``: a ``.pth`` path (its ``net`` entry if it has one) or a
    ``{key: tensor or ndarray}`` state_dict in torchvision's layout
    (utils/torchvision_manifest.state_dict_manifest). The backbone's module
    names are torchvision's, so keys map one to one. Strict both ways: the
    classifier ``fc.weight``/``fc.bias`` and the ``num_batches_tracked``
    counters are discarded, and any other tensor left over or missing
    raises KeyError; a shape mismatch raises ValueError (a packed4 stem
    takes the 7x7 stem folded). ``arch`` must be the model's."""
    backbone = getattr(model, f"{arch}_8s", None)
    if backbone is None:
        raise ValueError(f"model has no {arch} backbone ({arch}_8s)")
    if isinstance(path_or_sd, str):
        payload = torch.load(path_or_sd, map_location="cpu",
                             weights_only=True)
        path_or_sd = payload.get("net", payload)
    sd = {k: v for k, v in _tensors(path_or_sd).items()
          if k not in ("fc.weight", "fc.bias")
          and not k.endswith("num_batches_tracked")}
    if getattr(backbone, "stem", None) == "packed4":
        sd = fold_stem_state_dict(sd)
    own = {k: v for k, v in backbone.state_dict(keep_vars=True).items()
           if not k.startswith("fc.") and not k.endswith(
               "num_batches_tracked")}
    leftover, missing = sorted(set(sd) - set(own)), sorted(set(own) - set(sd))
    if leftover or missing:
        raise KeyError(f"{arch} checkpoint: unconsumed {leftover[:8]}, "
                       f"missing {missing[:8]}")
    with torch.no_grad():
        for k, v in own.items():
            if tuple(v.shape) != tuple(sd[k].shape):
                raise ValueError(f"shape mismatch at {k}: model "
                                 f"{tuple(v.shape)} vs checkpoint "
                                 f"{tuple(sd[k].shape)}")
            v.copy_(sd[k])


def load_reference_checkpoint(model: torch.nn.Module, path: str) -> None:
    """Load a reference ``.pth`` ({'net': state_dict, 'optim', 'epoch'},
    ref lib/utils/net_utils.py:124-130, or a bare state_dict) into
    ``model``, key for key, as the JAX ``load_torch_checkpoint``
    (torch_convert.py:250) reads ``payload.get('net', payload)``. The
    port's module names are the reference's. Strict: a tensor left over or
    missing raises KeyError, except the ``num_batches_tracked`` counters,
    which checkpoints of older PyTorch versions lack; a packed4 model takes
    the stem folded."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = _tensors(payload.get("net", payload))
    own = model.state_dict()
    leftover = sorted(set(sd) - set(own))
    missing = sorted(k for k in set(own) - set(sd)
                     if not k.endswith("num_batches_tracked"))
    if leftover or missing:
        raise KeyError(f"reference checkpoint: unconsumed {leftover[:8]}, "
                       f"missing {missing[:8]}")
    _load(model, OrderedDict((k, sd.get(k, v)) for k, v in own.items()))


def _quant_modules(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """{flax module path: QuantConv2d} of a model's int8 convolutions."""
    from pvnet_tpu_torch.ops.quant_conv import quant_convs
    convs = quant_convs(model)
    paths = {tp: fp for tp, fp in
             _pairs(_layout_of_torch(model.state_dict().keys()))[0]}
    unknown = sorted(set(convs) - set(paths))
    if unknown:
        raise KeyError(f"no flax path for {unknown[:8]}")
    return {paths[n]: m for n, m in convs.items()}


def quant_from_flax(model: torch.nn.Module, quant: dict) -> None:
    """Set the ``act_absmax`` of every QuantConv2d of ``model`` from a flax
    ``quant`` collection ({.../Conv_k: {'act_absmax': x}}, numpy or
    arrays). Raises if a module gets no value or a leaf is left unused."""
    flat = _flatten(quant)
    used = set()
    for fp, m in _quant_modules(model).items():
        key = f"{fp}/act_absmax"
        if key not in flat:
            raise KeyError(f"quant collection has no {key}")
        used.add(key)
        m.act_absmax = torch.tensor(float(np.asarray(flat[key])),
                                    dtype=torch.float32,
                                    device=m.weight.device)
    unused = set(flat) - used
    if unused:
        raise KeyError(f"{len(unused)} quant leaves unused: "
                       f"{sorted(unused)[:8]}")


def flax_quant_from_model(model: torch.nn.Module) -> dict:
    """The inverse of :func:`quant_from_flax`: the flax ``quant``
    collection (float32 numpy scalars) of a calibrated model. Raises if a
    QuantConv2d has no calibrated value."""
    flat = {}
    for fp, m in _quant_modules(model).items():
        if m.act_absmax is None:
            raise ValueError(f"{fp} is not calibrated")
        flat[f"{fp}/act_absmax"] = np.asarray(
            m.act_absmax.detach().float().cpu().numpy())
    return _nest(flat)
