"""Farthest point sampling (offline keypoint generation), numpy only.

Port of the numpy path of pvnet_tpu/ops/fps.py, the reference's CFFI C++
FPS (ref lib/utils/extend_utils/src/farthest_point_sampling.cpp:77-160):
the same O(KN) algorithm and the same init-center variant, which seeds
from the bbox centre and never emits it; it makes the farthest{N}.txt
keypoints (ref data_utils.py:140-152).
"""
from __future__ import annotations

import numpy as np


def farthest_point_sampling(pts: np.ndarray, sn: int,
                            init_center: bool = False) -> np.ndarray:
    """Sample sn farthest points from pts [n, 3]. Returns [sn, 3] float32."""
    pts = np.ascontiguousarray(pts[:, :3], np.float32)
    if init_center:
        # min_dist seeded from the bbox centre, first pick = farthest from
        # it (ref fps.cpp:122-160); the centre itself is never emitted
        center = (pts.min(0) + pts.max(0)) / 2.0
        dist = np.sum((pts - center) ** 2, axis=1)
        idxs = []
    else:
        # the reference seeds from a random point (srand(time)); index 0
        # keeps the output reproducible
        dist = np.sum((pts - pts[0]) ** 2, axis=1)
        idxs = [0]
    while len(idxs) < sn:
        nxt = int(np.argmax(dist))
        idxs.append(nxt)
        dist = np.minimum(dist, np.sum((pts - pts[nxt]) ** 2, axis=1))
    return pts[np.asarray(idxs, np.int64)]
