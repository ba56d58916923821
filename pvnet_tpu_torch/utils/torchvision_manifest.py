"""torchvision's ResNet checkpoint layout (key -> shape), numpy only.

The port's copy of pvnet_tpu/utils/torchvision_manifest.py
(``state_dict_manifest``, ``synthesize_state_dict``), with the ``ARCHS``
and checkpoint-file tables of pvnet_tpu/utils/imagenet_manifest.py. The
reference starts every training run from torchvision's ImageNet weights
(ref lib/networks/resnet.py:223-232). A checkpoint's keys and shapes follow
from the architecture alone, so this module writes them out, and
:func:`synthesize_state_dict` makes a stand-in checkpoint with exactly that
layout for tests and for ``chip_smoke.py``; the real files are not in the
repository.

Expected files (torchvision's names carry the first 8 hex digits of the
file's SHA-256; check with ``sha256sum <file> | cut -c1-8``):
``resnet18-f37072fd.pth``, ``resnet34-b627a593.pth``,
``resnet50-0676ba61.pth`` (:data:`CHECKPOINT_FILES`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# arch -> (stage_sizes, bottleneck), as torchvision's resnet.py builds them
ARCHS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
}

CHECKPOINT_FILES = {
    "resnet18": "resnet18-f37072fd.pth",
    "resnet34": "resnet34-b627a593.pth",
    "resnet50": "resnet50-0676ba61.pth",
}

_PLANES = (64, 128, 256, 512)
_STRIDES = (1, 2, 2, 2)


def _bn_entries(prefix: str, c: int, out: Dict[str, Tuple[int, ...]]):
    """BatchNorm2d state_dict tensors, in torch's emission order."""
    out[f"{prefix}.weight"] = (c,)
    out[f"{prefix}.bias"] = (c,)
    out[f"{prefix}.running_mean"] = (c,)
    out[f"{prefix}.running_var"] = (c,)
    out[f"{prefix}.num_batches_tracked"] = ()


def state_dict_manifest(arch: str = "resnet18") -> Dict[str, Tuple[int, ...]]:
    """Exact ``{key: shape}`` of ``torchvision.models.<arch>().state_dict()``,
    in its order: conv weights OIHW, the classifier ``fc.*`` and the BN
    ``num_batches_tracked`` counters included."""
    stage_sizes, bottleneck = ARCHS[arch]
    expansion = 4 if bottleneck else 1
    m: Dict[str, Tuple[int, ...]] = {}

    m["conv1.weight"] = (64, 3, 7, 7)
    _bn_entries("bn1", 64, m)

    inplanes = 64
    for stage, (n, planes, stride) in enumerate(
            zip(stage_sizes, _PLANES, _STRIDES)):
        for i in range(n):
            p = f"layer{stage + 1}.{i}"
            if bottleneck:
                m[f"{p}.conv1.weight"] = (planes, inplanes, 1, 1)
                _bn_entries(f"{p}.bn1", planes, m)
                m[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
                _bn_entries(f"{p}.bn2", planes, m)
                m[f"{p}.conv3.weight"] = (planes * 4, planes, 1, 1)
                _bn_entries(f"{p}.bn3", planes * 4, m)
            else:
                m[f"{p}.conv1.weight"] = (planes, inplanes, 3, 3)
                _bn_entries(f"{p}.bn1", planes, m)
                m[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
                _bn_entries(f"{p}.bn2", planes, m)
            if i == 0 and (stride != 1 or inplanes != planes * expansion):
                m[f"{p}.downsample.0.weight"] = (
                    planes * expansion, inplanes, 1, 1)
                _bn_entries(f"{p}.downsample.1", planes * expansion, m)
            inplanes = planes * expansion

    m["fc.weight"] = (1000, 512 * expansion)
    m["fc.bias"] = (1000,)
    return m


def synthesize_state_dict(arch: str = "resnet18", seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """A numpy state_dict with exactly the manifest's keys and shapes, drawn
    from ``np.random.RandomState(seed)`` in the JAX function's order (so it
    equals that function's for the same seed)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, shape in state_dict_manifest(arch).items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.asarray(1000, dtype=np.int64)
        elif k.endswith("running_var"):
            sd[k] = rng.rand(*shape).astype(np.float32) + 0.5
        else:
            sd[k] = rng.randn(*shape).astype(np.float32) * 0.05
    return sd
