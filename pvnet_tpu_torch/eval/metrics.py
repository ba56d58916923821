"""Pose-quality metrics, batched over leading dimensions.

PyTorch port of pvnet_tpu/eval/metrics.py; formulas and thresholds are the
reference's (ref lib/utils/evaluation_utils.py):
- ADD:   mean 3D distance of the transformed model points; correct below
         0.1 * diameter (ref :91-117).
- ADD-S: the nearest-neighbour variant for the symmetric classes glue and
         eggbox (ref :119-130, selection :155-158).
- 2D-projection: mean reprojection distance below 5 px (ref :75-89).
- 5cm5deg: translation below 5 cm and geodesic rotation below 5 deg
         (ref :132-141).
"""
from __future__ import annotations

from typing import Tuple

import torch

from pvnet_tpu_torch.ops.geometry import (find_nearest_point_distance,
                                          project, rotation_angle_deg,
                                          transform_points)


def add_error(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
              model_pts: torch.Tensor) -> torch.Tensor:
    """Mean distance between corresponding transformed model points, in
    the model's units (metres). Poses [..., 3, 4], model_pts [n, 3]."""
    p = transform_points(model_pts, pose_pred)
    g = transform_points(model_pts, pose_gt)
    return torch.linalg.norm(p - g, dim=-1).mean(-1)


def add_error_sym(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                  model_pts: torch.Tensor, tile: int = 4096) -> torch.Tensor:
    """ADD-S: mean nearest-neighbour distance (symmetric objects)."""
    p = transform_points(model_pts, pose_pred)
    g = transform_points(model_pts, pose_gt)
    return find_nearest_point_distance(p, g, tile=tile).mean(-1)


def projection_error(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                     model_pts: torch.Tensor, K: torch.Tensor
                     ) -> torch.Tensor:
    """Mean 2D reprojection distance in pixels; K [..., 3, 3]."""
    p = project(model_pts, pose_pred, K)
    g = project(model_pts, pose_gt, K)
    return torch.linalg.norm(p - g, dim=-1).mean(-1)


def projection_error_sym(pose_pred: torch.Tensor, pose_gt: torch.Tensor,
                         model_pts: torch.Tensor, K: torch.Tensor,
                         tile: int = 4096) -> torch.Tensor:
    """Symmetric 2D projection error via nearest neighbour (ref :83-89)."""
    p = project(model_pts, pose_pred, K)
    g = project(model_pts, pose_gt, K)
    return find_nearest_point_distance(p, g, tile=tile).mean(-1)


def cm_degree_errors(pose_pred: torch.Tensor, pose_gt: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(translation error in cm, rotation error in degrees)."""
    trans_cm = torch.linalg.norm(pose_pred[..., :3, 3] - pose_gt[..., :3, 3],
                                 dim=-1) * 100.0
    rot_deg = rotation_angle_deg(pose_pred[..., :3, :3],
                                 pose_gt[..., :3, :3])
    return trans_cm, rot_deg
