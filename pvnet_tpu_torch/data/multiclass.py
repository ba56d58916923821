"""Fuse-style multi-class scenes: the data half of the JAX package's
multi-class study (tools/multiclass_study.py), numpy only.

Three object classes (duck = asymmetric, box = 90-degree rotation
symmetric in shape, scored with ADD-S; cylinder = axially symmetric shape
with a painted stripe) are posed into every frame, laterally separated so
each is mostly visible, and rendered with class-labelled masks
(data/synthetic.render_multiclass_view). The draws are the study's, in its
order, from one ``np.random.RandomState``, so a split equals the one the
JAX study generates for the same seed.

  classes = build_class_set()
  metas = [class_meta(*c) for c in classes]
  images, masks, hcoords, poses = generate_split(classes, metas, n, K, h, w,
                                                 seed)
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pvnet_tpu_torch.data.ply import PlyMesh
from pvnet_tpu_torch.data.pose_transforms import project_np
from pvnet_tpu_torch.data.synthetic import (make_box_mesh, make_cylinder_mesh,
                                            make_duck_mesh,
                                            render_multiclass_view,
                                            sample_object_pose)
from pvnet_tpu_torch.eval.evaluator import ObjectMeta
from pvnet_tpu_torch.ops.fps import farthest_point_sampling

# lateral (x, y) offset in metres of each slot of a scene
_SLOT_OFFSETS = [(-0.11, -0.05), (0.11, -0.02), (0.0, 0.09)]


def build_class_set() -> List[Tuple[str, PlyMesh, bool]]:
    """[(name, mesh, symmetric)]; class c is index c - 1, label c in the
    masks."""
    return [("duck", make_duck_mesh(), False),
            ("box", make_box_mesh(), True),
            ("cyl", make_cylinder_mesh(), False)]


def class_meta(name: str, mesh: PlyMesh, symmetric: bool) -> ObjectMeta:
    """Evaluation metadata: 8 FPS keypoints plus the centre, and the exact
    largest pairwise distance of the vertices as the diameter (ref
    data_utils.py:111-118)."""
    kps = farthest_point_sampling(mesh.vertices, 8, init_center=True)
    pts3d = np.concatenate([kps, mesh.vertices.mean(0, keepdims=True)], 0)
    v = mesh.vertices
    d2 = ((v[None] - v[:, None]) ** 2).sum(-1)
    return ObjectMeta(points_3d=pts3d.astype(np.float32),
                      model_pts=v.astype(np.float32),
                      diameter=float(np.sqrt(d2.max())),
                      symmetric=symmetric, name=name)


def sample_scene(classes, rng: np.random.RandomState, K: np.ndarray,
                 h: int, w: int) -> List[Tuple[PlyMesh, np.ndarray]]:
    """Pose every class into one frame, each in its own lateral slot (the
    slots shuffled): [(mesh, pose [3, 4])] in class order."""
    order = rng.permutation(len(classes))
    poses = [None] * len(classes)
    for slot, ci in enumerate(order):
        pose = sample_object_pose(rng, z_range=(0.55, 0.85))
        ox, oy = _SLOT_OFFSETS[slot]
        pose[:, 3] = [ox + rng.uniform(-0.02, 0.02),
                      oy + rng.uniform(-0.02, 0.02),
                      pose[2, 3]]
        poses[ci] = pose
    return [(classes[ci][1], poses[ci]) for ci in range(len(classes))]


def generate_split(classes, metas: List[ObjectMeta], n: int, K: np.ndarray,
                   h: int, w: int, seed: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """n scenes: (images uint8 [n, h, w, 3], masks uint8 [n, h, w] with
    labels 0..C, hcoords float32 [n, C, k, 3] (each class's projected
    keypoints, homogeneous), poses float32 [n, C, 3, 4])."""
    rng = np.random.RandomState(seed)
    C, k = len(classes), metas[0].points_3d.shape[0]
    images = np.empty((n, h, w, 3), np.uint8)
    masks = np.empty((n, h, w), np.uint8)
    hcoords = np.empty((n, C, k, 3), np.float32)
    poses = np.empty((n, C, 3, 4), np.float32)
    for i in range(n):
        mp = sample_scene(classes, rng, K, h, w)
        images[i], masks[i] = render_multiclass_view(mp, K, h, w, rng)
        for c, (_, pose) in enumerate(mp):
            p2d = project_np(metas[c].points_3d, pose, K)
            hcoords[i, c] = np.concatenate(
                [p2d, np.ones((k, 1), np.float32)], axis=1)
            poses[i, c] = pose
    return images, masks, hcoords, poses
