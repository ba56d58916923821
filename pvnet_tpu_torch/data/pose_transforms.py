"""Pose files and frames of the LINEMOD distribution, and projections,
ported from pvnet_tpu/data/pose_transforms.py (ref
lib/utils/base_utils.py:27-294): ``read_pose`` (:35), ``PoseTransformer``
(:42; LINEMOD_ORIG -> blender and Occlusion LINEMOD -> blender frames),
``PrinterAligner`` (:126; 3D-printed-object scans into the world frame),
``project_np`` and ``project_h_np`` (:164).

One departure (ROADMAP D3): the JAX class caches each class's translation
transform in a class attribute keyed by the class name, so a process that
reads two trees of one class gets the first tree's transform for both.
The port keys its cache by the model files the transform is computed from.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from pvnet_tpu_torch.data.ply import load_ply

# (ref base_utils.py:34-36,148-150)
ROTATION_TRANSFORM = np.array([[1.0, 0.0, 0.0],
                               [0.0, -1.0, 0.0],
                               [0.0, 0.0, -1.0]])

# Occlusion LINEMOD xyz-model frame permutation (ref base_utils.py:213-215)
OCC_XYZ_ROTATION = np.array([[0.0, 0.0, 1.0],
                             [1.0, 0.0, 0.0],
                             [0.0, 1.0, 0.0]])

# class -> occlusion model number (ref base_utils.py:152-161)
CLASS_TYPE_TO_NUMBER = {
    "ape": "001", "can": "004", "cat": "005", "driller": "006",
    "duck": "007", "eggbox": "008", "glue": "009", "holepuncher": "010",
}


def read_pose(rot_path: str, tra_path: str) -> np.ndarray:
    """LINEMOD_ORIG .rot/.tra files -> [3, 4] (ref base_utils.py:27-30)."""
    rot = np.loadtxt(rot_path, skiprows=1)
    tra = np.loadtxt(tra_path, skiprows=1) / 100.0
    return np.concatenate([rot, np.reshape(tra, [3, 1])], axis=-1)


class PoseTransformer:
    """Per-class pose frame converter (ref base_utils.py:147-236).

    Args:
      class_type: LINEMOD class name.
      linemod_dir / linemod_orig_dir / occlusion_dir: dataset roots.
    """

    # (blender model path, the other model's path) -> translation
    _translation_cache: Dict[Tuple[str, str], np.ndarray] = {}
    _occ_translation_cache: Dict[Tuple[str, str], np.ndarray] = {}

    def __init__(self, class_type: str, linemod_dir: str,
                 linemod_orig_dir: str = "", occlusion_dir: str = ""):
        self.class_type = class_type
        self.linemod_dir = linemod_dir
        self.linemod_orig_dir = linemod_orig_dir
        self.occlusion_dir = occlusion_dir
        self.blender_model_path = os.path.join(
            linemod_dir, class_type, f"{class_type}.ply")

    # -- orig -> blender (ref ModelAligner + base_utils.py:171-175) -------
    def _orig_dir(self) -> str:
        return os.path.join(self.linemod_orig_dir, self.class_type)

    def _load_orig_model(self) -> np.ndarray:
        orig = os.path.join(self._orig_dir(), "mesh.ply")
        if os.path.exists(orig):
            return load_ply(orig).vertices / 1000.0
        old = os.path.join(self._orig_dir(), "OLDmesh.ply")
        transform_dat = np.loadtxt(
            os.path.join(self._orig_dir(), "transform.dat"), skiprows=1)[:, 1]
        transform = np.reshape(transform_dat, [3, 4])
        old_model = load_ply(old).vertices / 1000.0
        return old_model @ transform[:, :3].T + transform[:, 3]

    def orig_translation_transform(self) -> np.ndarray:
        """(ref base_utils.py:110-120)"""
        key = (os.path.abspath(self.blender_model_path),
               os.path.abspath(self._orig_dir()))
        if key in self._translation_cache:
            return self._translation_cache[key]
        blender_model = load_ply(self.blender_model_path).vertices
        orig_model = self._load_orig_model()
        blender_model = blender_model @ ROTATION_TRANSFORM.T
        trans = np.mean(orig_model, axis=0) - np.mean(blender_model, axis=0)
        self._translation_cache[key] = trans
        return trans

    def orig_pose_to_blender_pose(self, pose: np.ndarray) -> np.ndarray:
        """(ref base_utils.py:171-175)"""
        rot, tra = pose[:, :3], pose[:, 3]
        tra = tra + rot @ self.orig_translation_transform()
        rot = rot @ ROTATION_TRANSFORM
        return np.concatenate([rot, np.reshape(tra, [3, 1])], axis=-1)

    # -- occlusion -> blender (ref base_utils.py:206-236) ----------------
    def occ_translation_transform(self) -> np.ndarray:
        xyz_path = os.path.join(
            self.occlusion_dir, "models", self.class_type.title(),
            f"{CLASS_TYPE_TO_NUMBER[self.class_type]}.xyz")
        key = (os.path.abspath(self.blender_model_path),
               os.path.abspath(xyz_path))
        if key in self._occ_translation_cache:
            return self._occ_translation_cache[key]
        model = load_ply(self.blender_model_path).vertices
        xyz = np.loadtxt(xyz_path)
        xyz = xyz @ OCC_XYZ_ROTATION.T
        trans = np.mean(xyz, axis=0) - np.mean(model, axis=0)
        self._occ_translation_cache[key] = trans
        return trans

    def occlusion_pose_to_blender_pose(self, pose: np.ndarray) -> np.ndarray:
        """(ref base_utils.py:222-236)"""
        rot, tra = pose[:, :3].copy(), pose[:, 3].copy()
        rotation = np.array([[0.0, 1.0, 0.0],
                             [0.0, 0.0, 1.0],
                             [1.0, 0.0, 0.0]])
        rot = rot @ rotation
        tra[1:] *= -1
        translation_transform = rot @ self.occ_translation_transform()
        rot[1:] *= -1
        translation_transform[1:] *= -1
        tra += translation_transform
        return np.concatenate([rot, np.reshape(tra, [3, 1])], axis=-1)


class PrinterAligner:
    """3D-printed-object pose alignment (ref ModelAligner,
    base_utils.py:33-85): maps printer-scan camera poses into the world
    frame via the calibration transforms the reference hard-codes."""

    # (ref base_utils.py:62-79)
    _TRANSFORM1 = np.array(
        [[0.161513626575, -0.827108919621, 0.538334608078, -0.245206743479],
         [-0.986692547798, -0.124983474612, 0.104004733264, -0.050683632493],
         [-0.018740313128, -0.547968924046, -0.836288750172, 0.387638419867]])
    _TRANSFORM2 = np.array(
        [[0.976471602917, 0.201606079936, -0.076541729271, -0.000718327821],
         [-0.196746662259, 0.978194475174, 0.066531419754, 0.000077120210],
         [0.088285841048, -0.049906700850, 0.994844079018, -0.001409600372]])

    def __init__(self):
        R1, t1 = self._TRANSFORM1[:, :3], self._TRANSFORM1[:, 3]
        R2, t2 = self._TRANSFORM2[:, :3], self._TRANSFORM2[:, 3]
        self.t_p2w = R2 @ t1 + t2
        self.R_p2w = R2 @ R1
        self.s_p2w = 0.85

    def pose_p2w(self, RT: np.ndarray) -> np.ndarray:
        """A printer-frame pose [3, 4] in the world frame
        (ref base_utils.py:81-85)."""
        t, R = RT[:, 3], RT[:, :3]
        R_w2c = R @ self.R_p2w.T
        t_w2c = -(R_w2c @ self.t_p2w) + self.s_p2w * t
        return np.concatenate([R_w2c, t_w2c[:, None]], 1)


def project_np(pts_3d: np.ndarray, RT: np.ndarray, K: np.ndarray
               ) -> np.ndarray:
    """Host projection (ref base_utils.py:project_K :289-294).
    pts_3d [n, 3], RT [3, 4], K [3, 3] -> [n, 2]."""
    pts_2d = pts_3d @ RT[:, :3].T + RT[:, 3:].T
    pts_2d = pts_2d @ K.T
    return pts_2d[:, :2] / pts_2d[:, 2:]


def project_h_np(pts_3dh: np.ndarray, RT: np.ndarray, K: np.ndarray
                 ) -> np.ndarray:
    """Homogeneous projection for vanishing points
    (ref base_utils.py:258-267)."""
    return pts_3dh @ RT.T @ K.T
