"""CPU mesh rasterization (offline data prep), numpy only.

Port of the numpy path of pvnet_tpu/ops/rasterize.py, which replaces the
reference's C++ rasterizer (ref
lib/utils/extend_utils/src/mesh_rasterization.cpp:43-71, binary mask) and
the depth / colour renderers of its OpenGL backend (ref
lib/utils/opengl_render_backend.py): barycentric point-in-triangle tests
over each triangle's bounding box and a z-buffer. The synthetic data
generator renders with it; the JAX module's dispatch to its native C++
library is not ported.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def mesh_binary_rasterization(triangles_2d: np.ndarray, h: int, w: int
                              ) -> np.ndarray:
    """Binary coverage mask of 2D triangles (ref mesh_rasterization.cpp:
    43-71 semantics). triangles_2d: [tn, 3, 2] pixel coords. Returns
    [h, w] uint8."""
    mask = np.zeros((h, w), np.uint8)
    _rasterize(triangles_2d, None, h, w, mask_out=mask)
    return mask


def render_mesh_depth(RT: np.ndarray, K: np.ndarray, vert: np.ndarray,
                      face: np.ndarray, h: int, w: int) -> np.ndarray:
    """Z-buffer depth render (eye-space z; 0 = background), the same output
    the reference's OpenGL depth path produces for occlusion mask
    generation (ref data_utils.py:788-826, opengl_render_backend.py)."""
    cam = vert @ RT[:, :3].T + RT[:, 3]
    uvw = cam @ K.T
    z = cam[:, 2]
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-9)
    tri2d = uv[face]                        # [tn, 3, 2]
    triz = z[face]                          # [tn, 3]
    depth = np.full((h, w), np.inf, np.float32)
    _rasterize(tri2d, triz, h, w, depth_out=depth)
    depth[np.isinf(depth)] = 0.0
    return depth


def render_mesh_attributes(RT: np.ndarray, K: np.ndarray, vert: np.ndarray,
                           face: np.ndarray, attrs: np.ndarray, h: int,
                           w: int) -> Tuple[np.ndarray, np.ndarray]:
    """Z-buffered render of per-vertex attributes (e.g. colors).

    The working replacement for the reference's commented-out
    render_rgb_cffi path (ref extend_utils/src/utils_python_binding.h:44-63)
    and the OpenGL color renderer (ref opengl_render_backend.py).

    Args:
      attrs: [n_vert, c] per-vertex attributes, barycentrically
        interpolated.
    Returns:
      (attr image [h, w, c] float32 — zeros at background, depth [h, w]).
    """
    cam = vert @ RT[:, :3].T + RT[:, 3]
    uvw = cam @ K.T
    z = cam[:, 2]
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-9)
    tri2d = uv[face]
    triz = z[face]
    triattr = attrs[face]                   # [tn, 3, c]
    depth = np.full((h, w), np.inf, np.float32)
    attr_img = np.zeros((h, w, attrs.shape[1]), np.float32)
    _rasterize(tri2d, triz, h, w, depth_out=depth, triattr=triattr,
               attr_out=attr_img)
    depth[np.isinf(depth)] = 0.0
    return attr_img, depth


def _rasterize(tri2d: np.ndarray, triz: Optional[np.ndarray], h: int, w: int,
               mask_out: Optional[np.ndarray] = None,
               depth_out: Optional[np.ndarray] = None,
               triattr: Optional[np.ndarray] = None,
               attr_out: Optional[np.ndarray] = None) -> None:
    """Shared barycentric scanline over per-triangle bboxes."""
    tn = tri2d.shape[0]
    for t in range(tn):
        p0, p1, p2 = tri2d[t]
        xmin = max(int(np.floor(min(p0[0], p1[0], p2[0]))), 0)
        xmax = min(int(np.ceil(max(p0[0], p1[0], p2[0]))), w - 1)
        ymin = max(int(np.floor(min(p0[1], p1[1], p2[1]))), 0)
        ymax = min(int(np.ceil(max(p0[1], p1[1], p2[1]))), h - 1)
        if xmax < xmin or ymax < ymin:
            continue
        xs = np.arange(xmin, xmax + 1)
        ys = np.arange(ymin, ymax + 1)
        gx, gy = np.meshgrid(xs, ys)
        d = ((p1[1] - p2[1]) * (p0[0] - p2[0])
             + (p2[0] - p1[0]) * (p0[1] - p2[1]))
        if abs(d) < 1e-12:
            continue
        l0 = ((p1[1] - p2[1]) * (gx - p2[0])
              + (p2[0] - p1[0]) * (gy - p2[1])) / d
        l1 = ((p2[1] - p0[1]) * (gx - p2[0])
              + (p0[0] - p2[0]) * (gy - p2[1])) / d
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        if mask_out is not None:
            sub = mask_out[ymin:ymax + 1, xmin:xmax + 1]
            sub[inside] = 1
        if depth_out is not None and triz is not None:
            zvals = (l0 * triz[t, 0] + l1 * triz[t, 1] + l2 * triz[t, 2])
            sub = depth_out[ymin:ymax + 1, xmin:xmax + 1]
            upd = inside & (zvals < sub)
            sub[upd] = zvals[upd].astype(np.float32)
            if attr_out is not None and triattr is not None:
                avals = (l0[..., None] * triattr[t, 0]
                         + l1[..., None] * triattr[t, 1]
                         + l2[..., None] * triattr[t, 2])
                asub = attr_out[ymin:ymax + 1, xmin:xmax + 1]
                asub[upd] = avals[upd].astype(np.float32)
