"""Static dataset facts and the training recipe, copied from
pvnet_tpu/config.py (not imported: the port never imports the JAX package).

:class:`AugConfig` and :class:`TrainConfig` keep the JAX package's field
names and defaults, which are the reference's ``linemod_train.json`` schema,
so the same recipe files load in both packages.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

# LINEMOD camera intrinsics (ref lib/utils/config.py:61-70).
LINEMOD_K = np.array(
    [[572.41140, 0.0, 325.26110],
     [0.0, 573.57043, 242.04899],
     [0.0, 0.0, 1.0]], dtype=np.float32)

BLENDER_K = np.array(
    [[700.0, 0.0, 320.0],
     [0.0, 700.0, 240.0],
     [0.0, 0.0, 1.0]], dtype=np.float32)

PASCAL_K = np.array(
    [[-3000.0, 0.0, 0.0],
     [0.0, 3000.0, 0.0],
     [0.0, 0.0, 1.0]], dtype=np.float32)

INTRINSIC_MATRICES = {
    "linemod": LINEMOD_K,
    "blender": BLENDER_K,
    "pascal": PASCAL_K,
}

LINEMOD_CLS_NAMES = [
    "ape", "cam", "cat", "duck", "glue", "iron", "phone",
    "benchvise", "can", "driller", "eggbox", "holepuncher", "lamp",
]
OCC_LINEMOD_CLS_NAMES = [
    "ape", "can", "cat", "driller", "duck", "eggbox", "glue", "holepuncher",
]
# classes evaluated with ADD-S (ref lib/utils/config.py:70)
SYMMETRIC_CLS_NAMES = ["glue", "eggbox"]

# ImageNet normalization used by the input transform
# (ref lib/datasets/linemod_dataset.py:185-195).
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class PathConfig:
    """Filesystem layout (ref lib/utils/config.py:11-37): the LINEMOD,
    LINEMOD_ORIG and OCCLUSION_LINEMOD trees under one data root."""
    data_dir: str = field(default_factory=lambda: os.path.join(repo_root(),
                                                               "data"))

    @property
    def linemod_dir(self) -> str:
        return os.path.join(self.data_dir, "LINEMOD")

    @property
    def linemod_orig_dir(self) -> str:
        return os.path.join(self.data_dir, "LINEMOD_ORIG")

    @property
    def occlusion_linemod_dir(self) -> str:
        return os.path.join(self.data_dir, "OCCLUSION_LINEMOD")

    @property
    def model_dir(self) -> str:
        return os.path.join(self.data_dir, "model")

    @property
    def record_dir(self) -> str:
        return os.path.join(self.data_dir, "record")


@dataclass
class AugConfig:
    """Augmentation recipe; field names mirror the reference aug_cfg JSON
    (ref configs/linemod_train.json:38-77)."""
    mask: bool = False
    min_mask: float = 0.1
    max_mask: float = 0.4

    rotation: bool = True
    rot_ang_min: float = -30.0
    rot_ang_max: float = 30.0

    crop: bool = True
    use_old: bool = True
    resize_ratio_min: float = 0.8
    resize_ratio_max: float = 1.2

    overlap_ratio: float = 0.8
    resize_hmin: int = 20
    resize_hmax: int = 130
    resize_wmin: int = 20
    resize_wmax: int = 130

    flip: bool = False
    blur: bool = True

    jitter: bool = True
    brightness: float = 0.1
    contrast: float = 0.1
    saturation: float = 0.05
    hue: float = 0.05

    # batch image-size sampling range (ref linemod_dataset.py:306-317)
    wmax: int = 640
    wmin: int = 256
    hmax: int = 480
    hmin: int = 256
    size_int: int = 8

    ignore_fuse_ms_vertex: bool = False
    use_mask_out: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "AugConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class TrainConfig:
    """Training recipe, JSON-compatible with ref configs/linemod_train.json.

    ``device_aug`` / ``device_data`` pick the training route as in the
    JAX package (train/loop.py); ``cache_images`` keeps the host route's
    decoded frames. The port trains channel-major (PyTorch's own layout),
    so ``head_layout``, ``input_layout`` and the TPU knob ``mesh_shape``
    are kept so that the JAX package's recipes load unchanged, and are not
    read. The ``quant_*`` fields build the int8 inference model
    (:func:`model_kwargs`); ``quant_tail`` is the packed tail's int8
    branch."""
    model_name: str = "linemod_train"
    network: str = "resnet18_8s"
    head_layout: str = "NHWC"
    input_layout: str = "NHWC"
    quant_stages: tuple = ()
    quant_decoder: bool = False
    quant_tail: bool = False
    quant_mode: str = "dynamic"

    lr: float = 1e-3
    lr_decay_rate: float = 0.5
    lr_decay_epoch: int = 20
    lr_min: float = 1e-5            # floor (ref net_utils.py:272-281)
    train_batch_size: int = 32
    test_batch_size: int = 1
    motion_model: bool = False

    resume: bool = True
    epoch_num: int = 200

    use_real_train: bool = True
    use_fuse: bool = True

    loss_rec_step: int = 80
    img_rec_step: int = 160

    eval_epoch: bool = False
    eval_inter: int = 5
    eval_epoch_begin: int = 80
    val_inter: int = 1

    vote_type: str = "Farthest"
    vertex_loss_ratio: float = 1.0

    aug_cfg: AugConfig = field(default_factory=AugConfig)

    seed: int = 0
    mesh_shape: Optional[Tuple[int, ...]] = None
    bf16: bool = False              # run the FCN under bfloat16 autocast
    checkpoint_keep: int = 10
    device_aug: bool = False
    device_data: bool = False
    cache_images: bool = False

    # Keys the source recipe JSON pinned (set by from_dict; a class-level
    # non-field default, so a bare TrainConfig() reads as "nothing pinned"
    # and dataclasses.asdict never serializes it).
    recipe_keys = frozenset()

    @classmethod
    def from_json(cls, path: str) -> "TrainConfig":
        with open(path, "r") as f:
            d = json.load(f)
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        d = dict(d)
        aug = d.pop("aug_cfg", None)
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in names}
        if aug is not None:
            kwargs["aug_cfg"] = AugConfig.from_dict(aug)
        cfg = cls(**kwargs)
        cfg.recipe_keys = frozenset(d) | ({"aug_cfg"} if aug is not None
                                          else frozenset())
        return cfg

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def model_kwargs(cfg: TrainConfig) -> dict:
    """``build_model`` keyword arguments of a recipe's int8 options (the
    JAX TrainLoop's model_kw, pvnet_tpu/train/loop.py:66-70)."""
    return {"quant_stages": tuple(cfg.quant_stages),
            "quant_mode": cfg.quant_mode,
            "quant_decoder": bool(cfg.quant_decoder)}


# vote_type -> number of voted keypoints (ref tools/train_linemod.py:38-59)
VOTE_TYPE_TO_NUM = {
    "BB8": 8,
    "BB8C": 9,
    "BB8S": 9,
    "Farthest": 9,
    "Farthest4": 5,
    "Farthest12": 13,
    "Farthest16": 17,
    "Farthest20": 21,
}
