"""Synthetic render-set generation, ported from pvnet_tpu/data/render.py
(ref lib/utils/render_utils.py).

The reference's render set comes from a Blender binary driven by a script
(ref render_utils.py:243-260). The JAX package adds a Blender-free
renderer on its numpy z-buffer; the port keeps both and writes the same
files without PIL:

- :func:`mat2euler_szxz`, :func:`blender_pose_to_blender_euler`,
  :func:`sample_sphere` — the pose helpers (ref base_utils.py:177-182,
  render_utils.py:90-108);
- :class:`DataStatistics` — Euler and translation statistics of the real
  training poses and scipy's KDE resampling of them (ref
  render_utils.py:22-120), driven by the same ``RandomState``;
- :class:`PythonRenderer` — renders poses into renders/{cls}/ as
  {k}.jpg (data/image_io.write_jpeg: PIL's bytes), {k}_depth.png (depth in
  millimetres as 16-bit gray, data/image_io.write_png) and {k}_RT.pkl;
- :class:`BlenderRenderer` — the external-binary driver, which raises
  when the binary is absent;
- :func:`generate_occlusion_masks` — per-class visible masks by z-buffer
  compositing of every object of an image (ref data_utils.py:788-860).
"""
from __future__ import annotations

import os
import pickle
import subprocess
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pvnet_tpu_torch.config import BLENDER_K, LINEMOD_K, PathConfig
from pvnet_tpu_torch.data.image_io import write_jpeg, write_png
from pvnet_tpu_torch.data.linemod import LineModModelDB
from pvnet_tpu_torch.data.ply import PlyMesh
from pvnet_tpu_torch.data.synthetic import render_synthetic_view
from pvnet_tpu_torch.ops.rasterize import render_mesh_depth


def mat2euler_szxz(R: np.ndarray) -> Tuple[float, float, float]:
    """Euler angles (radians) of the 'szxz' convention,
    R = Rz(a1) @ Rx(a2) @ Rz(a3): the convention of the reference's
    blender pose statistics (ref base_utils.py:177-182 via transforms3d)."""
    sy = np.sqrt(R[0, 2] ** 2 + R[1, 2] ** 2)
    if sy > 1e-8:
        a1 = np.arctan2(R[0, 2], -R[1, 2])
        a2 = np.arctan2(sy, R[2, 2])
        a3 = np.arctan2(R[2, 0], R[2, 1])
    else:
        a1 = np.arctan2(-R[1, 0], R[0, 0])
        a2 = 0.0 if R[2, 2] > 0 else np.pi
        a3 = 0.0
    return a1, a2, a3


def blender_pose_to_blender_euler(pose: np.ndarray) -> np.ndarray:
    """(ref base_utils.py:177-182): degrees with the reference's offsets."""
    euler = [r / np.pi * 180 for r in mat2euler_szxz(pose[:, :3])]
    euler[0] = -(euler[0] + 90) % 360
    euler[1] = euler[1] - 90
    return np.array(euler)


def sample_sphere(num_samples: int, begin_elevation: float = 0.0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Evenly distributed azimuths/elevations via the fibonacci sphere
    (ref render_utils.py:90-108). Returns (azimuths, elevations) in
    degrees."""
    ratio = (begin_elevation + 90) / 180
    num_points = int(num_samples // (1 - ratio))
    phi = (np.sqrt(5) - 1) / 2
    azimuths, elevations = [], []
    for n in range(num_points - num_samples, num_points):
        z = 2.0 * n / num_points + 1.0 / num_points - 1.0
        azimuths.append(np.rad2deg(2 * np.pi * n * phi % (2 * np.pi)))
        elevations.append(np.rad2deg(np.arcsin(np.clip(z, -1, 1))))
    return np.array(azimuths), np.array(elevations)


class DataStatistics:
    """Real-pose statistics and KDE sampling (ref render_utils.py:22-120).

    Args:
      poses: [3, 4] blender-frame poses of the real training list.
    """

    def __init__(self, poses: Sequence[np.ndarray]):
        self.eulers = np.array([blender_pose_to_blender_euler(p)
                                for p in poses])
        self.translations = np.array([p[:, 3] for p in poses])

    def sample_poses(self, num: int, seed: int = 0) -> np.ndarray:
        """KDE-sampled (azimuth, elevation, theta, tx, ty, tz) [num, 6]
        (ref render_utils.py:110-120)."""
        from scipy import stats
        rng = np.random.RandomState(seed)
        data = np.concatenate([self.eulers, self.translations],
                              axis=1).T       # [6, n]
        # a degenerate dimension (e.g. a fixed-height camera rig) makes
        # the KDE covariance singular: jitter at 1e-6 of the overall scale
        std = data.std(axis=1, keepdims=True)
        scale = max(float(std.max()), 1e-3)
        flat = std[:, 0] < 1e-9 * scale
        if flat.any():
            data = data + rng.randn(*data.shape) * (1e-6 * scale)
        kde = stats.gaussian_kde(data)
        return kde.resample(num, seed=rng).T


class PythonRenderer:
    """Blender-free render-set generator on the numpy z-buffer.

    Writes what LineModImageDB.collect_render_set_info reads (ref
    data_utils.py:232-254) under renders/{cls}/: {k}.jpg, {k}_depth.png
    and {k}_RT.pkl. JPEGs are encoded on ``device`` (data/image_io: the C
    encoder on a CUDA device, the plain one on the CPU).
    """

    def __init__(self, cls_name: str, paths: Optional[PathConfig] = None,
                 K: np.ndarray = BLENDER_K, hw: Tuple[int, int] = (480, 640),
                 device="cpu"):
        self.cls_name = cls_name
        self.paths = paths or PathConfig()
        self.K = K
        self.hw = hw
        self.device = device
        self.modeldb = LineModModelDB(self.paths)

    def render_pose(self, pose: np.ndarray, rng=None):
        """(rgb uint8, depth float32, mask uint8) of one pose."""
        verts, faces = self.modeldb.get_ply_mesh(self.cls_name)
        h, w = self.hw
        depth = render_mesh_depth(pose, self.K, verts, faces, h, w)
        mask = (depth > 0).astype(np.uint8)
        rgb, _ = render_synthetic_view(PlyMesh(vertices=verts, faces=faces),
                                       pose, self.K, h, w, rng)
        return rgb, depth, mask

    def run(self, poses: Sequence[np.ndarray], out_dir: Optional[str] = None
            ) -> str:
        out_dir = out_dir or os.path.join(self.paths.linemod_dir, "renders",
                                          self.cls_name)
        os.makedirs(out_dir, exist_ok=True)
        rng = np.random.RandomState(0)
        for k, pose in enumerate(poses):
            rgb, depth, _ = self.render_pose(pose, rng)
            write_jpeg(os.path.join(out_dir, f"{k}.jpg"), rgb, self.device)
            d16 = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
            write_png(os.path.join(out_dir, f"{k}_depth.png"), d16)
            with open(os.path.join(out_dir, f"{k}_RT.pkl"), "wb") as f:
                pickle.dump({"RT": np.asarray(pose, np.float32), "K": self.K},
                            f)
        return out_dir


class BlenderRenderer:
    """External Blender driver (ref render_utils.py:243-260), for users
    with the reference's rendering setup; raises when the binary is
    absent."""

    def __init__(self, blender_path: str, backend_script: str):
        self.blender_path = blender_path
        self.backend_script = backend_script

    def available(self) -> bool:
        return os.path.exists(self.blender_path)

    def run(self, obj_path: str, output_dir: str, num_syn: int,
            extra_args: Sequence[str] = ()) -> None:
        if not self.available():
            raise RuntimeError(
                f"Blender binary not found at {self.blender_path}; use "
                f"PythonRenderer for a self-contained render set")
        cmd = [self.blender_path, "--background", "--python",
               self.backend_script, "--", obj_path, output_dir,
               str(num_syn), *extra_args]
        subprocess.run(cmd, check=True)


def generate_occlusion_masks(cls_names: Sequence[str],
                             image_records: Dict[str, Sequence[dict]],
                             paths: Optional[PathConfig] = None,
                             hw: Tuple[int, int] = (480, 640),
                             K: np.ndarray = LINEMOD_K):
    """Per-class occlusion-aware masks by z-buffer compositing of every
    object of an image (ref OcclusionLineModDB.get_mask_of_all_objects +
    get_masks, data_utils.py:788-860).

    Args:
      image_records: class -> records with 'RT', one per image index (all
        classes over the same image list).
    Yields:
      (image index, {cls: visible mask uint8 [h, w]}).
    """
    paths = paths or PathConfig()
    modeldb = LineModModelDB(paths)
    h, w = hw
    n_images = min(len(v) for v in image_records.values())
    for idx in range(n_images):
        depths = []
        for cls in cls_names:
            verts, faces = modeldb.get_ply_mesh(cls)
            depth = render_mesh_depth(image_records[cls][idx]["RT"], K,
                                      verts, faces, h, w)
            depth[depth == 0] = np.inf
            depths.append(depth)
        stack = np.stack(depths)                          # [c, h, w]
        winner = np.argmin(stack, axis=0)
        visible = np.isfinite(stack.min(axis=0))
        yield idx, {cls: ((winner == ci) & visible).astype(np.uint8)
                    for ci, cls in enumerate(cls_names)}
