"""Map a flax PVNet variables tree onto the port's ``state_dict``, and
back.

:func:`state_dict_from_flax` is the inverse of
pvnet_tpu/utils/torch_convert.py (``_backbone_mapping``,
``convert_state_dict``): conv kernels HWIO -> OIHW, BatchNorm
scale/bias/mean/var -> weight/bias/running_mean/running_var. The port's
module names are the reference ``Resnet18_8s``'s, so the result is also
the reference's own state_dict layout. :func:`flax_from_state_dict` maps
the other way, to numpy trees.

Strict both ways: every leaf of the flax tree must be used, and
``load_state_dict`` must find every tensor the model has.

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


def _pairs(stage_sizes=(2, 2, 2, 2)
           ) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """(conv pairs, BatchNorm pairs) of (torch prefix, flax module path),
    in construction order. Mirrors torch_convert._backbone_mapping for the
    BasicBlock ResNets."""
    bp, fb = "resnet18_8s.", "ResNetBackbone_0"
    convs = [(f"{bp}conv1", f"{fb}/Conv_0")]
    bns = [(f"{bp}bn1", f"{fb}/BatchNorm_0")]
    idx, inplanes = 0, 64
    for stage, (n, planes, stride) in enumerate(
            zip(stage_sizes, (64, 128, 256, 512), (1, 2, 2, 2))):
        for i in range(n):
            name, tp = f"{fb}/BasicBlock_{idx}", f"{bp}layer{stage + 1}.{i}"
            for ci in range(2):
                convs.append((f"{tp}.conv{ci + 1}", f"{name}/Conv_{ci}"))
                bns.append((f"{tp}.bn{ci + 1}", f"{name}/BatchNorm_{ci}"))
            if i == 0 and (stride != 1 or inplanes != planes):
                convs.append((f"{tp}.downsample.0", f"{name}/Conv_2"))
                bns.append((f"{tp}.downsample.1", f"{name}/BatchNorm_2"))
            idx += 1
        inplanes = planes
    # decoder heads (ref model_repository.py:22-58)
    for i, t in enumerate([f"{bp}fc", "conv8s", "conv4s", "conv2s",
                           "convraw"]):
        convs.append((f"{t}.0", f"Conv_{i}"))
        bns.append((f"{t}.1", f"BatchNorm_{i}"))
    convs.append(("convraw.3", "Conv_5"))
    return convs, bns


def state_dict_from_flax(variables: dict) -> "OrderedDict[str, torch.Tensor]":
    """flax {'params': ..., 'batch_stats': ...} -> the port's float32
    state_dict. Raises if any flax leaf is left unused."""
    params = _flatten(variables["params"])
    stats = _flatten(variables["batch_stats"])
    used = set()

    def take(tree, key, where):
        if key not in tree:
            raise KeyError(f"checkpoint has no {where} leaf {key}")
        used.add((where, key))
        return torch.from_numpy(np.ascontiguousarray(tree[key],
                                                     dtype=np.float32))

    sd = OrderedDict()
    convs, bns = _pairs()
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

    convs, bns = _pairs()
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


def _quant_modules(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """{flax module path: QuantConv2d} of a model's int8 convolutions."""
    from pvnet_tpu_torch.ops.quant_conv import quant_convs
    convs = quant_convs(model)
    paths = {tp: fp for tp, fp in _pairs()[0]}
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
