"""Side-experiment datasets (port of pvnet_tpu/data/experimental.py, the
same names; ref lib/utils/data_utils.py:520-537, 907-1031).

These are off the LINEMOD production path in the reference too (YCB pose
validation and crop statistics, a 3D-printed-object capture aligned to
the world frame). Paths are configurable, as in the JAX module. Images
are read and written by data/image_io (JPEG and PNG without PIL: on a
CUDA ``device`` through the C decoder and the pixel kernel, on the CPU
their plain versions), the point-splat masks drawn by
utils/viz.img_pts_to_pts_img.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from pvnet_tpu_torch.config import BLENDER_K, PathConfig
from pvnet_tpu_torch.data.image_io import read_mask, read_rgb, write_png
from pvnet_tpu_torch.data.linemod import LineModModelDB
from pvnet_tpu_torch.data.pose_transforms import PrinterAligner, project_np
from pvnet_tpu_torch.utils.viz import img_pts_to_pts_img

# YCB symmetric classes / class count (ref config.py:83-86)
YCB_SYM_CLS = [21, 20, 19, 16, 13]
YCB_CLASS_NUM = 21


def _rt(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return pickle.load(f)["RT"]


class YCBDB:
    """YCB helpers (ref data_utils.py:907-951)."""

    def __init__(self, class_type: str, ycb_dir: Optional[str] = None):
        self.class_type = class_type
        self.ycb_dir = ycb_dir or os.path.join(PathConfig().data_dir, "YCB")
        self.data_dir_path = os.path.join(self.ycb_dir, "data")
        self.rgb_pattern = os.path.join(self.data_dir_path,
                                        "{:04}/{:06}-color.png")

    def validate_pose(self, render_idx: int = 0, device="cpu"):
        """Project the model into a rendered view with its stored pose;
        returns (rgb [h, w, 3] uint8, model_2d [n, 2]) for inspection
        (ref :914-926)."""
        base = os.path.join(self.ycb_dir, "renders", self.class_type)
        rgb = read_rgb(os.path.join(base, f"{render_idx}.jpg"),
                       device).cpu().numpy()
        pose = _rt(os.path.join(base, f"{render_idx}_RT.pkl"))
        model_3d = np.loadtxt(os.path.join(
            self.ycb_dir, "models", self.class_type, "points.xyz"))
        return rgb, project_np(model_3d, pose, BLENDER_K)

    @staticmethod
    def crop_size_statistics(mask_paths: List[str], device="cpu"):
        """Instance bbox size stats over depth masks (ref :928-951).
        Returns dict with min/max width/height."""
        widths, heights = [], []
        for p in mask_paths:
            rc = np.argwhere(read_mask(p, device) == 1)
            if rc.size == 0:
                continue
            heights.append(int(rc[:, 0].max() - rc[:, 0].min()))
            widths.append(int(rc[:, 1].max() - rc[:, 1].min()))
        widths, heights = np.array(widths), np.array(heights)
        return {
            "min_width": int(widths.min()), "max_width": int(widths.max()),
            "min_height": int(heights.min()),
            "max_height": int(heights.max()),
        }


def special_render_dataset(cls_name: str = "duck", num: int = 10,
                           subdir: str = "special",
                           paths: Optional[PathConfig] = None) -> List[dict]:
    """Records for a small special render set (ref SpecialDuckDataset,
    data_utils.py:520-537): {subdir}/{cls}/{k}.jpg + _depth.png + _RT.pkl
    with center targets under blender intrinsics."""
    paths = paths or PathConfig()
    modeldb = LineModModelDB(paths)
    dataset = []
    for k in range(num):
        rt_pkl = os.path.join(paths.linemod_dir, subdir, cls_name,
                              f"{k}_RT.pkl")
        if not os.path.exists(rt_pkl):
            continue
        RT = _rt(rt_pkl)
        dataset.append({
            "rgb_pth": f"{subdir}/{cls_name}/{k}.jpg",
            "dpt_pth": f"{subdir}/{cls_name}/{k}_depth.png",
            "RT": RT,
            "rnd_typ": "render",
            "center": project_np(
                modeldb.get_centers_3d(cls_name)[None, :], RT, BLENDER_K),
        })
    return dataset


class PrinterModelDB:
    """3D-printed capture dataset (ref data_utils.py:954-1031)."""

    K = {"cat": np.asarray([[551.701, 0.0, 325.622],
                            [0.0, 552.732, 239.996],
                            [0.0, 0.0, 1.0]], np.float32)}

    def __init__(self, cls_name: str = "cat",
                 paths: Optional[PathConfig] = None):
        self.paths = paths or PathConfig()
        self.cls_name = cls_name
        self.root_dir = os.path.join(self.paths.data_dir,
                                     f"{cls_name}_print")
        self.image_dir = os.path.join(self.root_dir, "images")
        self.image_pattern = os.path.join(self.image_dir,
                                          "{:06}_color.png")
        self.mask_pattern = os.path.join(self.image_dir, "{:06}_mask.png")
        self.printer_model_pts = np.loadtxt(
            os.path.join(self.root_dir, "point_cloud.txt"))[:, :3]
        self.model_pts = LineModModelDB(self.paths).get_ply_model(cls_name)
        self.poses = self.parse_poses()
        self.image_num = len(self.poses)
        self.aligned_poses = self.align_poses()

    def parse_poses(self) -> List[np.ndarray]:
        """camera-to-world blocks -> world-to-camera [3, 4]
        (ref :968-987)."""
        RTs = []
        with open(os.path.join(self.root_dir,
                               "new_camera_poses_ascii.txt")) as f:
            lines = f.readlines()
        for k in range(len(lines) // 5):
            vals = []
            for line in lines[k * 5 + 1:k * 5 + 4]:
                vals += [float(v) for v in line.split()]
            RT = np.asarray(vals).reshape([3, 4])
            R = RT[:, :3].T
            t = -(R @ RT[:, 3])
            RTs.append(np.concatenate([R, t[:, None]], 1))
        return RTs

    def align_poses(self) -> List[np.ndarray]:
        """(ref :1023-1031)"""
        aligner = PrinterAligner()
        return [aligner.pose_p2w(p) for p in self.poses]

    def generate_mask_images(self) -> None:
        """Point-splat masks from the printer point cloud, 0/1 8-bit gray
        PNGs of 484x648 (ref :1008-1013)."""
        for k in range(self.image_num):
            img_pts = project_np(self.printer_model_pts.copy(),
                                 self.poses[k], self.K[self.cls_name])
            pts_img = img_pts_to_pts_img(img_pts, 484, 648)
            write_png(self.mask_pattern.format(k + 1),
                      pts_img.astype(np.uint8))
