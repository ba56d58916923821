"""A LINEMOD tree written by the JAX package at 120x160, shared by the
LINEMOD read-path tests (tests/test_torch_linemod.py,
tests/test_torch_train_linemod.py)."""
import contextlib
import os
import pickle
import shutil

import numpy as np
from PIL import Image

from pvnet_tpu.config import LINEMOD_K as J_LINEMOD_K
from pvnet_tpu.config import PathConfig as JPathConfig
from pvnet_tpu.data.pose_transforms import PoseTransformer as JPoseTransformer
from tools.make_torch_linemod_fixture import write_tree

HW = (120, 160)
N_IMAGES = 10


@contextlib.contextmanager
def own_jax_caches():
    """JAX's PoseTransformer caches translations by class name for the
    whole process (ROADMAP D3): within the block it has empty caches of
    its own, and the process's come back after, so that these trees never
    leak into another test's."""
    saved = (JPoseTransformer._translation_cache,
             JPoseTransformer._occ_translation_cache)
    JPoseTransformer._translation_cache = {}
    JPoseTransformer._occ_translation_cache = {}
    try:
        yield
    finally:
        (JPoseTransformer._translation_cache,
         JPoseTransformer._occ_translation_cache) = saved


def write_fuse(root: str, cls_idx: int = 3) -> None:
    """A 2-image fuse set (LineModImageDB.collect_fuse_info's layout): a
    frame of the tree, a label mask holding the class (index + 1) and
    another, the (begins, poses) info pickle."""
    paths = JPathConfig(data_dir=root)
    fuse = os.path.join(paths.linemod_dir, "fuse")
    os.makedirs(fuse, exist_ok=True)
    rng = np.random.RandomState(7)
    for k in range(2):
        shutil.copy(os.path.join(paths.linemod_dir, "duck", "JPEGImages",
                                 f"{k:06}.jpg"),
                    os.path.join(fuse, f"{k}_rgb.jpg"))
        label = np.zeros(HW, np.uint8)
        label[20:60, 30:80] = cls_idx + 1
        label[70:100, 90:140] = 1
        Image.fromarray(label).save(os.path.join(fuse, f"{k}_mask.png"))
        begins = rng.randint(0, 40, (13, 2))
        poses = np.zeros((13, 3, 4), np.float32)
        poses[:, :, :3] = np.eye(3)
        poses[:, 2, 3] = 0.5 + 0.1 * rng.rand(13)
        with open(os.path.join(fuse, f"{k}_info.pkl"), "wb") as f:
            pickle.dump((begins, poses), f)


def make_tree(root: str) -> None:
    """The JAX package's LINEMOD, Occlusion and Truncation layouts at
    120x160 (frames rendered with LINEMOD_K scaled to the frame, 64x64
    crops) and a fuse set."""
    K = J_LINEMOD_K.copy()
    K[:2] /= 4
    with own_jax_caches():
        write_tree(root, N_IMAGES, HW, trunc_size=64, render_K=K)
    write_fuse(root)
