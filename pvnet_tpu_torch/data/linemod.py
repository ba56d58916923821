"""LINEMOD dataset databases, ported from pvnet_tpu/data/linemod.py (ref
lib/utils/data_utils.py).

Mesh/metadata cache (:class:`LineModModelDB`, ref :37-160), per-image record
builders for the real / render / fuse sets with pickle caching in
``posedb/`` (:class:`LineModImageDB`, ref :162-518), Occlusion LINEMOD
(ref :539-638) and Truncation LINEMOD (ref :640-682) databases, plus the
truncated-set generator (:func:`make_truncated_linemod_dataset`, ref
:396-518).

The record schema is the JAX package's (and the reference's), so the
``posedb/*.pkl`` caches of either package load in the other:
    {rgb_pth, dpt_pth, RT, cls_typ, rnd_typ, corners, farthest{,4,12,16,20},
     center, small_bbox, van_pts[, K]}

Images and masks are decoded and written by data/image_io (no PIL or
cv2); the generator's files equal the JAX package's (JPEG bytes, PNG
pixels, the pickled pose and K).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from pvnet_tpu_torch.config import (BLENDER_K, LINEMOD_CLS_NAMES, LINEMOD_K,
                                    PathConfig)
from pvnet_tpu_torch.data.image_io import (read_mask, read_rgb, write_jpeg,
                                           write_png)
from pvnet_tpu_torch.data.ply import load_ply
from pvnet_tpu_torch.data.pose_transforms import (PoseTransformer,
                                                  project_h_np, project_np,
                                                  read_pose)
from pvnet_tpu_torch.ops.fps import farthest_point_sampling


def read_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(data, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)


class LineModModelDB:
    """Mesh metadata cache (ref data_utils.py:37-160)."""

    def __init__(self, paths: Optional[PathConfig] = None):
        self.paths = paths or PathConfig()
        self._corners: Dict[str, np.ndarray] = {}
        self._models: Dict[str, np.ndarray] = {}
        self._meshes: Dict[str, tuple] = {}
        self._diameters: Dict[str, float] = {}
        self._centers: Dict[str, np.ndarray] = {}
        self._farthest: Dict[str, Dict[str, np.ndarray]] = {
            k: {} for k in ("4", "8", "12", "16", "20")}
        self._small_bbox: Dict[str, np.ndarray] = {}

    def _ply_path(self, cls: str) -> str:
        return os.path.join(self.paths.linemod_dir, cls, f"{cls}.ply")

    def get_corners_3d(self, cls: str) -> np.ndarray:
        """Axis-aligned 3D bbox corners, cached to corners.txt
        (ref :53-85; corner ordering preserved)."""
        if cls in self._corners:
            return self._corners[cls]
        corner_pth = os.path.join(self.paths.linemod_dir, cls, "corners.txt")
        if os.path.exists(corner_pth):
            self._corners[cls] = np.loadtxt(corner_pth)
            return self._corners[cls]
        v = load_ply(self._ply_path(cls)).vertices
        mn, mx = v.min(0), v.max(0)
        corners = np.array([
            [mn[0], mn[1], mn[2]], [mn[0], mn[1], mx[2]],
            [mn[0], mx[1], mn[2]], [mn[0], mx[1], mx[2]],
            [mx[0], mn[1], mn[2]], [mx[0], mn[1], mx[2]],
            [mx[0], mx[1], mn[2]], [mx[0], mx[1], mx[2]],
        ])
        self._corners[cls] = corners
        np.savetxt(corner_pth, corners)
        return corners

    def get_small_bbox(self, cls: str) -> np.ndarray:
        """2/3-scaled bbox (ref :87-96)."""
        if cls in self._small_bbox:
            return self._small_bbox[cls]
        corners = self.get_corners_3d(cls)
        center = np.mean(corners, 0)
        small = (corners - center[None]) * 2.0 / 3.0 + center[None]
        self._small_bbox[cls] = small
        return small

    def get_ply_model(self, cls: str) -> np.ndarray:
        if cls in self._models:
            return self._models[cls]
        self._models[cls] = load_ply(self._ply_path(cls)).vertices
        return self._models[cls]

    def get_ply_mesh(self, cls: str):
        """(vertices, faces) (ref :154-160)."""
        if cls in self._meshes:
            return self._meshes[cls]
        mesh = load_ply(self._ply_path(cls))
        self._meshes[cls] = (mesh.vertices, mesh.faces)
        return self._meshes[cls]

    def get_diameter(self, cls: str) -> float:
        """From LINEMOD_ORIG distance.txt, cm -> m (ref :111-118)."""
        if cls in self._diameters:
            return self._diameters[cls]
        path = os.path.join(self.paths.linemod_orig_dir, cls, "distance.txt")
        if os.path.exists(path):
            d = float(np.loadtxt(path)) / 100.0
        else:
            # fall back to the mesh extent when LINEMOD_ORIG is absent
            v = self.get_ply_model(cls)
            d = float(np.linalg.norm(v.max(0) - v.min(0)))
        self._diameters[cls] = d
        return d

    def get_centers_3d(self, cls: str) -> np.ndarray:
        if cls in self._centers:
            return self._centers[cls]
        c3d = self.get_corners_3d(cls)
        self._centers[cls] = (np.max(c3d, 0) + np.min(c3d, 0)) / 2
        return self._centers[cls]

    def get_farthest_3d(self, cls: str, num: int = 8) -> np.ndarray:
        """FPS keypoints from farthest{num}.txt (ref :128-138); computed on
        demand from the mesh if the file is absent."""
        key = str(num)
        if cls in self._farthest[key]:
            return self._farthest[key][cls]
        suffix = "" if num == 8 else str(num)
        path = os.path.join(self.paths.linemod_dir, cls,
                            f"farthest{suffix}.txt")
        if os.path.exists(path):
            pts = np.loadtxt(path)
        else:
            pts = self.compute_farthest_surface_point_3d(cls, num)
        self._farthest[key][cls] = pts
        return pts

    def compute_farthest_surface_point_3d(self, cls: str, num: int = 8
                                          ) -> np.ndarray:
        """FPS keypoint generation (ref :140-152 + __main__ :1034-1039).
        Prefers dense_pts.txt like the reference, else the mesh vertices."""
        dense = os.path.join(self.paths.linemod_dir, cls, "dense_pts.txt")
        if os.path.exists(dense):
            pts = np.loadtxt(dense)[:, :3]
        else:
            pts = self.get_ply_model(cls)
        spts = farthest_point_sampling(pts, num, init_center=True)
        suffix = "" if num == 8 else str(num)
        out = os.path.join(self.paths.linemod_dir, cls,
                           f"farthest{suffix}.txt")
        try:
            np.savetxt(out, spts)
        except OSError:
            pass
        return spts


def _project_record(data: dict, modeldb: LineModModelDB, cls: str,
                    K: np.ndarray, with_van: bool = True,
                    van_K: Optional[np.ndarray] = None) -> None:
    """Fill the 2D keypoint fields of an image record."""
    RT = data["RT"]
    data["corners"] = project_np(modeldb.get_corners_3d(cls), RT, K)
    data["farthest"] = project_np(modeldb.get_farthest_3d(cls), RT, K)
    for num in (4, 12, 16, 20):
        data[f"farthest{num}"] = project_np(
            modeldb.get_farthest_3d(cls, num), RT, K)
    data["center"] = project_np(
        modeldb.get_centers_3d(cls)[None, :], RT, K)
    data["small_bbox"] = project_np(modeldb.get_small_bbox(cls), RT, K)
    if with_van:
        axis_direct = np.concatenate(
            [np.identity(3), np.zeros([3, 1])], 1).astype(np.float32)
        data["van_pts"] = project_h_np(axis_direct, RT,
                                       van_K if van_K is not None else K)


class LineModImageDB:
    """Per-image records for one class (ref data_utils.py:162-334)."""

    def __init__(self, cls_name: str, render_num: int = 10000,
                 fuse_num: int = 10000, has_render_set: bool = True,
                 has_fuse_set: bool = True,
                 paths: Optional[PathConfig] = None, device="cpu"):
        self.cls_name = cls_name
        self.device = device     # where the fuse set's masks are decoded
        self.paths = paths or PathConfig()
        self.linemod_dir = self.paths.linemod_dir
        self.render_dir = f"renders/{cls_name}"
        self.rgb_dir = f"{cls_name}/JPEGImages"
        self.mask_dir = f"{cls_name}/mask"
        self.rt_dir = os.path.join(self.paths.linemod_orig_dir, cls_name,
                                   "data")
        self.render_num = render_num
        self.fuse_num = fuse_num
        self.fuse_dir = "fuse"
        self.cls_idx = LINEMOD_CLS_NAMES.index(cls_name)
        self.modeldb = LineModModelDB(self.paths)

        posedb = os.path.join(self.linemod_dir, "posedb")
        if has_render_set:
            pkl = os.path.join(posedb, f"{cls_name}_render.pkl")
            self.render_set = (read_pickle(pkl) if os.path.exists(pkl)
                               else self.collect_render_set_info(pkl))
        else:
            self.render_set = []

        pkl = os.path.join(posedb, f"{cls_name}_real.pkl")
        self.real_set = (read_pickle(pkl) if os.path.exists(pkl)
                         else self.collect_real_set_info(pkl))

        self.train_real_set: List[dict] = []
        self.test_real_set: List[dict] = []
        self.val_real_set: List[dict] = []
        self.collect_train_val_test_info()

        if has_fuse_set:
            pkl = os.path.join(posedb, f"{cls_name}_fuse.pkl")
            self.fuse_set = (read_pickle(pkl) if os.path.exists(pkl)
                             else self.collect_fuse_info(pkl))
        else:
            self.fuse_set = []

    # -- builders (each caches to posedb pickle) --------------------------
    def collect_render_set_info(self, pkl_file: str, fmt: str = "jpg"
                                ) -> List[dict]:
        """Synthetic blender renders; blender intrinsics (ref :232-254)."""
        database = []
        for k in range(self.render_num):
            rt_pkl = os.path.join(self.linemod_dir, self.render_dir,
                                  f"{k}_RT.pkl")
            if not os.path.exists(rt_pkl):
                break
            data = {
                "rgb_pth": os.path.join(self.render_dir, f"{k}.{fmt}"),
                "dpt_pth": os.path.join(self.render_dir, f"{k}_depth.png"),
                "RT": read_pickle(rt_pkl)["RT"],
                "cls_typ": self.cls_name,
                "rnd_typ": "render",
            }
            _project_record(data, self.modeldb, self.cls_name, BLENDER_K)
            database.append(data)
        save_pickle(database, pkl_file)
        return database

    def collect_real_set_info(self, pkl_file: str) -> List[dict]:
        """Real images; pose from .rot/.tra converted to blender frame
        (ref :256-282)."""
        database = []
        rgb_root = os.path.join(self.linemod_dir, self.rgb_dir)
        if not os.path.exists(rgb_root):
            save_pickle(database, pkl_file)
            return database
        img_num = len(os.listdir(rgb_root))
        transformer = PoseTransformer(
            self.cls_name, self.linemod_dir, self.paths.linemod_orig_dir,
            self.paths.occlusion_linemod_dir)
        for k in range(img_num):
            pose = read_pose(
                os.path.join(self.rt_dir, f"rot{k}.rot"),
                os.path.join(self.rt_dir, f"tra{k}.tra"))
            data = {
                "rgb_pth": os.path.join(self.rgb_dir, f"{k:06}.jpg"),
                "dpt_pth": os.path.join(self.mask_dir, f"{k:04}.png"),
                "RT": transformer.orig_pose_to_blender_pose(
                    pose).astype(np.float32),
                "cls_typ": self.cls_name,
                "rnd_typ": "real",
            }
            _project_record(data, self.modeldb, self.cls_name, LINEMOD_K)
            database.append(data)
        save_pickle(database, pkl_file)
        return database

    def collect_train_val_test_info(self) -> None:
        """Split by train/val/test txt files (ref :284-302)."""
        def read_fns(fn):
            path = os.path.join(self.linemod_dir, f"{self.cls_name}/{fn}")
            if not os.path.exists(path):
                return []
            with open(path) as f:
                return [line.strip().split("/")[-1] for line in f]

        test_fns = read_fns("test.txt")
        train_fns = read_fns("train.txt")
        val_fns = read_fns("val.txt")
        for data in self.real_set:
            fn = data["rgb_pth"].split("/")[-1]
            if fn in test_fns:
                if fn in val_fns:
                    self.val_real_set.append(data)
                else:
                    self.test_real_set.append(data)
            if fn in train_fns:
                self.train_real_set.append(data)

    def collect_fuse_info(self, pkl_file: str) -> List[dict]:
        """Multi-object composite ('fuse') set with shifted principal point
        (ref :304-334)."""
        database = []
        fuse_root = os.path.join(self.linemod_dir, self.fuse_dir)
        if not os.path.exists(fuse_root):
            save_pickle(database, pkl_file)
            return database
        for k in range(self.fuse_num):
            info_pkl = os.path.join(fuse_root, f"{k}_info.pkl")
            if not os.path.exists(info_pkl):
                continue
            dpt_pth = os.path.join(self.fuse_dir, f"{k}_mask.png")
            mask = read_mask(os.path.join(self.linemod_dir, dpt_pth),
                             self.device)
            if np.sum(mask == (self.cls_idx + 1)) < 400:
                continue
            begins, poses = read_pickle(info_pkl)
            K = LINEMOD_K.copy()
            K[0, 2] += begins[self.cls_idx, 1]
            K[1, 2] += begins[self.cls_idx, 0]
            data = {
                "rgb_pth": os.path.join(self.fuse_dir, f"{k}_rgb.jpg"),
                "dpt_pth": dpt_pth,
                "RT": poses[self.cls_idx],
                "cls_typ": self.cls_name,
                "rnd_typ": "fuse",
                "K": K,
            }
            _project_record(data, self.modeldb, self.cls_name, K,
                            with_van=False)
            database.append(data)
        save_pickle(database, pkl_file)
        return database


class OcclusionLineModImageDB:
    """Occlusion LINEMOD records (ref data_utils.py:539-638)."""

    def __init__(self, cls_name: str, paths: Optional[PathConfig] = None):
        self.cls_name = cls_name
        self.paths = paths or PathConfig()
        self.linemod_dir = self.paths.occlusion_linemod_dir
        self.rgb_dir = "RGB-D/rgb_noseg"
        self.mask_dir = f"masks/{cls_name}"
        self.rt_dir = os.path.join(
            self.linemod_dir, f"poses/{cls_name[0].upper()}{cls_name[1:]}")
        self.modeldb = LineModModelDB(self.paths)

        pkl = os.path.join(self.linemod_dir, "posedb",
                           f"{cls_name}_real.pkl")
        self.real_set = (read_pickle(pkl) if os.path.exists(pkl)
                         else self.collect_real_set_info(pkl))
        self.test_real_set: List[dict] = []
        self.train_real_set: List[dict] = []
        self.get_train_test_split()

    @staticmethod
    def read_occ_pose(pose_path: str) -> np.ndarray:
        """info_{:05}.txt parser (ref :620-629)."""
        with open(pose_path) as f:
            lines = [line.rstrip("\n") for line in f.readlines()]
        if "rotation:" not in lines:
            return np.array([])
        row = lines.index("rotation:") + 1
        rotation = np.loadtxt(lines[row:row + 3])
        translation = np.loadtxt(lines[row + 4:row + 5])
        return np.concatenate([rotation, np.reshape(translation, [3, 1])],
                              axis=-1)

    def collect_real_set_info(self, pkl_file: str) -> List[dict]:
        database = []
        rgb_root = os.path.join(self.linemod_dir, self.rgb_dir)
        if not os.path.exists(rgb_root):
            save_pickle(database, pkl_file)
            return database
        transformer = PoseTransformer(
            self.cls_name, self.paths.linemod_dir,
            self.paths.linemod_orig_dir, self.linemod_dir)
        img_num = len(os.listdir(rgb_root))
        for k in range(img_num):
            pose = self.read_occ_pose(
                os.path.join(self.rt_dir, f"info_{k:05}.txt"))
            if len(pose) == 0:
                continue
            data = {
                "rgb_pth": os.path.join(self.rgb_dir, f"color_{k:05}.png"),
                "dpt_pth": os.path.join(self.mask_dir, f"{k}.png"),
                "RT": transformer.occlusion_pose_to_blender_pose(pose),
                "cls_typ": self.cls_name,
                "rnd_typ": "real",
            }
            _project_record(data, self.modeldb, self.cls_name, LINEMOD_K,
                            van_K=BLENDER_K)
            database.append(data)
        save_pickle(database, pkl_file)
        return database

    def get_train_test_split(self) -> None:
        """Split via LINEMOD/{cls}/test_occlusion.txt (ref :561-574)."""
        split_path = os.path.join(self.paths.linemod_dir, self.cls_name,
                                  "test_occlusion.txt")
        test_fns = []
        if os.path.exists(split_path):
            with open(split_path) as f:
                for line in f:
                    test_id = int(line.strip().split("/")[-1].split(".")[0])
                    test_fns.append(f"color_{test_id:05}.png")
        for data in self.real_set:
            fn = data["rgb_pth"].split("/")[-1]
            if fn in test_fns:
                self.test_real_set.append(data)
            else:
                self.train_real_set.append(data)


class TruncatedLineModImageDB:
    """Truncation LINEMOD records with per-image K (ref :640-682)."""

    def __init__(self, cls_name: str, paths: Optional[PathConfig] = None):
        self.cls_name = cls_name
        self.paths = paths or PathConfig()
        self.linemod_dir = self.paths.linemod_dir
        self.modeldb = LineModModelDB(self.paths)
        pkl = os.path.join(self.linemod_dir, "posedb",
                           f"{cls_name}_truncated.pkl")
        self.set = (read_pickle(pkl) if os.path.exists(pkl)
                    else self.collect_truncated_set_info(pkl))

    def collect_truncated_set_info(self, pkl_file: str) -> List[dict]:
        database = []
        trunc_root = os.path.join(self.linemod_dir, "truncated",
                                  self.cls_name)
        if not os.path.exists(trunc_root):
            save_pickle(database, pkl_file)
            return database
        img_num = len(os.listdir(
            os.path.join(self.linemod_dir, self.cls_name, "JPEGImages")))
        for k in range(img_num):
            info = os.path.join(trunc_root, f"{k:06}_info.pkl")
            if not os.path.exists(info):
                continue
            pose, K = read_pickle(info)
            data = {
                "rgb_pth": os.path.join("truncated", self.cls_name,
                                        f"{k:06}_rgb.jpg"),
                "dpt_pth": os.path.join("truncated", self.cls_name,
                                        f"{k:04}_msk.png"),
                "RT": pose,
                "cls_typ": self.cls_name,
                "rnd_typ": "truncated",
                "K": K,
            }
            _project_record(data, self.modeldb, self.cls_name, K,
                            with_van=False)
            database.append(data)
        save_pickle(database, pkl_file)
        return database


def crop_instance(rgb: np.ndarray, msk: np.ndarray, size: int = 256,
                  rng: Optional[np.random.RandomState] = None):
    """Random instance-truncating crop (ref data_utils.py:396-473), drawing
    from ``rng`` in the JAX function's order. Returns (rgb, mask, hbeg,
    wbeg) where (hbeg, wbeg) shift the principal point."""
    rng = rng or np.random
    h, w, _ = rgb.shape
    hs, ws = np.nonzero(msk)
    hmin, hmax = np.min(hs), np.max(hs)
    wmin, wmax = np.min(ws), np.max(ws)
    hlen, wlen = hmax - hmin, wmax - wmin

    def rand_span(lo, hi):
        lo, hi = int(lo), int(hi)
        if hi <= lo:
            return lo
        return rng.randint(lo, hi)

    def split(pt):
        return (pt - size, pt) if rng.rand() < 0.5 else (pt, pt + size)

    t = rng.rand()
    if t <= 0.4:
        x_pt = int(wlen * rng.uniform(0.4, 0.6)) + wmin
        wbeg, wend = split(x_pt)
        hbeg = rand_span(hmax - size, hmin if hlen < size else hmin + size)
        hend = hbeg + size
    elif t <= 0.8:
        y_pt = int(hlen * rng.uniform(0.4, 0.6)) + hmin
        hbeg, hend = split(y_pt)
        wbeg = rand_span(wmax - size, wmin if wlen < size else wmin + size)
        wend = wbeg + size
    else:
        y_pt = int(hlen * rng.uniform(0.4, 0.6)) + hmin
        hbeg, hend = split(y_pt)
        x_pt = int(wlen * rng.uniform(0.4, 0.6)) + wmin
        wbeg, wend = split(x_pt)

    hpad_bfr, hpad_aft = max(0, -hbeg), max(0, hend - h)
    wpad_bfr, wpad_aft = max(0, -wbeg), max(0, wend - w)
    hb, he = max(hbeg, 0), min(hend, h)
    wb, we = max(wbeg, 0), min(wend, w)
    rgb_new = np.pad(rgb[hb:he, wb:we],
                     ((hpad_bfr, hpad_aft), (wpad_bfr, wpad_aft), (0, 0)),
                     mode="constant")
    msk_new = np.pad(msk[hb:he, wb:we],
                     ((hpad_bfr, hpad_aft), (wpad_bfr, wpad_aft)),
                     mode="constant")
    return rgb_new, msk_new, -hb + hpad_bfr, -wb + wpad_bfr


def make_truncated_linemod_dataset(cls_names=None,
                                   paths: Optional[PathConfig] = None,
                                   size: int = 256,
                                   min_remaining: float = 0.2,
                                   seed: int = 0, device="cpu") -> None:
    """Offline generator of the truncation benchmark (ref
    data_utils.py:475-518): for every frame of a class, random crops until
    one keeps >= ``min_remaining`` of the instance (or 51 tries), written
    to LINEMOD/truncated/{cls}/ as {k:06}_rgb.jpg, {k:04}_msk.png and
    {k:06}_info.pkl ([pose, K] with the principal point shifted). One
    ``RandomState(seed)`` over all classes, as the JAX function. Frames
    are decoded and JPEGs encoded on ``device`` (data/image_io)."""
    paths = paths or PathConfig()
    cls_names = cls_names or LINEMOD_CLS_NAMES
    rng = np.random.RandomState(seed)
    for cls_name in cls_names:
        linemod_dir = paths.linemod_dir
        rgb_dir = f"{cls_name}/JPEGImages"
        rt_dir = os.path.join(paths.linemod_orig_dir, cls_name, "data")
        out_dir = os.path.join(linemod_dir, "truncated", cls_name)
        os.makedirs(out_dir, exist_ok=True)
        rgb_root = os.path.join(linemod_dir, rgb_dir)
        if not os.path.exists(rgb_root):
            continue
        transformer = PoseTransformer(cls_name, linemod_dir,
                                      paths.linemod_orig_dir,
                                      paths.occlusion_linemod_dir)
        img_num = len(os.listdir(rgb_root))
        for k in range(img_num):
            rgb = read_rgb(os.path.join(linemod_dir, rgb_dir, f"{k:06}.jpg"),
                           device).cpu().numpy()
            msk = read_mask(os.path.join(linemod_dir, cls_name, "mask",
                                         f"{k:04}.png"), device)
            if msk.ndim == 3:
                msk = (np.sum(msk, 2) > 0).astype(np.uint8)
            before = np.sum(msk)
            count = 0
            while True:
                rgb_new, msk_new, hbeg, wbeg = crop_instance(
                    rgb, msk, size, rng)
                count += 1
                if np.sum(msk_new) / max(before, 1) >= min_remaining \
                        or count > 50:
                    rgb, msk = rgb_new, msk_new
                    break
            write_jpeg(os.path.join(out_dir, f"{k:06}_rgb.jpg"), rgb, device)
            write_png(os.path.join(out_dir, f"{k:04}_msk.png"),
                      (msk * 255).astype(np.uint8))
            pose = read_pose(os.path.join(rt_dir, f"rot{k}.rot"),
                             os.path.join(rt_dir, f"tra{k}.tra"))
            pose = transformer.orig_pose_to_blender_pose(pose).astype(
                np.float32)
            K = LINEMOD_K.copy()
            K[0, 2] += wbeg
            K[1, 2] += hbeg
            save_pickle([pose, K],
                        os.path.join(out_dir, f"{k:06}_info.pkl"))
