"""Keypoint projection, copied from pvnet_tpu/data/pose_transforms.py
(``project_np``) — the one piece the trainer needs to turn a pose, the
object's 3D keypoints and the intrinsics into 2D keypoint targets."""
from __future__ import annotations

import numpy as np


def project_np(pts_3d: np.ndarray, RT: np.ndarray, K: np.ndarray
               ) -> np.ndarray:
    """Host projection (ref base_utils.py:project_K :289-294).
    pts_3d [n, 3], RT [3, 4], K [3, 3] -> [n, 2]."""
    pts_2d = pts_3d @ RT[:, :3].T + RT[:, 3:].T
    pts_2d = pts_2d @ K.T
    return pts_2d[:, :2] / pts_2d[:, 2:]
