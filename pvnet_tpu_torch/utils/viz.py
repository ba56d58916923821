"""Visualization helpers (ref lib/utils/draw_utils.py semantics).

Port of pvnet_tpu/utils/viz.py, with its function names and arguments.
Everything here is host numpy code, as in the JAX module.

The colorize, grid, splat, projection and point-file helpers give the JAX
module's arrays and bytes exactly. ``colorize_vertex_field`` and the
hypothesis scatter map values through a literal copy of matplotlib's
``viridis`` table (utils/colormap.py).

The overlays (bounding box, mask, hypotheses, ellipses, points,
keypoints, multi-class masks, vanishing points) are drawn by the JAX
module with matplotlib, which the GPU host does not have. Here each is
rasterized into a uint8 [h, w, 3] copy of its image, at the image's own
size, by utils/draw.py (ROADMAP departure D5): the geometry equals the
JAX module's (the same corners, points, ellipse axes and angles, arrows
and colours at the same call sites), the pixels are not matplotlib's.
With ``save_path`` each writes a PNG through data/image_io.write_png and
returns the path, as the JAX module does (the per-image functions format
``save_path`` with the batch index); without, it returns the uint8 array
where the JAX module returns a matplotlib Figure.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from pvnet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu_torch.data.image_io import write_png
from pvnet_tpu_torch.utils import draw
from pvnet_tpu_torch.utils.colormap import viridis

# Cityscapes-style label palette (ref net_utils.py:152-171)
_COLORS = np.array([
    [0, 0, 0], [128, 64, 128], [244, 35, 232], [70, 70, 70],
    [102, 102, 156], [190, 153, 153], [153, 153, 153], [250, 170, 30],
    [220, 220, 0], [107, 142, 35], [152, 251, 152], [0, 130, 180],
    [220, 20, 60], [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
    [0, 80, 100], [0, 0, 230], [119, 11, 32]], np.uint8)

# Edges of an axis-aligned 3D box given the reference's corner ordering
# (ref draw_utils.py:visualize_bounding_box :9-46 draws these quads)
_BOX_EDGES = [(0, 1), (0, 2), (1, 3), (2, 3),
              (4, 5), (4, 6), (5, 7), (6, 7),
              (0, 4), (1, 5), (2, 6), (3, 7)]

# marker half-widths in px, for matplotlib's s=40 ('x') and the default
# line marker size ('*', 'o')
_MARKER = 3.0


def _out(img: np.ndarray, save_path: Optional[str]):
    if save_path:
        write_png(save_path, img)
        return save_path
    return img


def imagenet_to_uint8(img: np.ndarray) -> np.ndarray:
    """Undo ImageNet normalization; [h, w, 3] float -> uint8
    (ref draw_utils.py:279-296, NHWC here)."""
    out = (img * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def colorize_segmentation(labels: np.ndarray) -> np.ndarray:
    """[b, h, w] int labels -> [b, h, w, 3] uint8 palette image."""
    return _COLORS[np.clip(labels, 0, len(_COLORS) - 1)]


def colorize_vertex_field(ver: np.ndarray, weights: np.ndarray
                          ) -> np.ndarray:
    """First (x, y) channel pair of an NHWC field [b, h, w, 2vn] ->
    colormapped [2b, h, w, 3] uint8, image i's x channel then its y
    channel (ref net_utils.py:rec_vertex :229-239)."""
    v = (ver[..., :2] * weights + 1.0) / 2.0            # [b, h, w, 2]
    v = np.moveaxis(v, -1, 1).reshape(-1, *v.shape[1:3])
    mapped = viridis(np.clip(v, 0, 1))
    return (mapped * 255).astype(np.uint8)


def make_grid(imgs: np.ndarray, nrow: int = 5, pad: int = 2) -> np.ndarray:
    """Tile [n, h, w, 3] uint8 into one grid image."""
    n, h, w, c = imgs.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.zeros((nrows * (h + pad) - pad, ncol * (w + pad) - pad, c),
                    imgs.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * (h + pad):r * (h + pad) + h,
             col * (w + pad):col * (w + pad) + w] = imgs[i]
    return grid


def img_pts_to_pts_img(img_pts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Splat 2D points into a binary [h, w] image
    (ref draw_utils.py:309-320)."""
    out = np.zeros((h, w), np.uint8)
    xs = np.round(img_pts[:, 0]).astype(np.int64)
    ys = np.round(img_pts[:, 1]).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    out[ys[keep], xs[keep]] = 1
    return out


def draw_bbox_edges(img: np.ndarray, corners_2d: np.ndarray,
                    color="g") -> None:
    """Draw the 12 edges of a projected 3D box into ``img`` [h, w, 3] in
    place (the JAX module draws them on a matplotlib axis)."""
    c = draw.as_color(color)
    for a, b in _BOX_EDGES:
        draw.draw_segment(img, corners_2d[a], corners_2d[b], c)


def visualize_bounding_box(rgb: np.ndarray, corners_pred: np.ndarray,
                           corners_targets: Optional[np.ndarray] = None,
                           save_path: Optional[str] = None):
    """Projected 3D bbox overlay (ref draw_utils.py:9-46): predicted in
    blue, targets in green (drawn over it).

    Args:
      rgb: [h, w, 3] uint8; corners_pred/targets: [8, 2].
    """
    img = draw.to_rgb_u8(rgb)
    draw_bbox_edges(img, corners_pred, "b")
    if corners_targets is not None:
        draw_bbox_edges(img, corners_targets, "g")
    return _out(img, save_path)


def visualize_mask(mask: np.ndarray, save_path: Optional[str] = None):
    """Binary/label mask display (ref draw_utils.py:48-66): the palette
    image of the labels."""
    return _out(colorize_segmentation(mask[None])[0], save_path)


def hypothesis_colors(counts: np.ndarray) -> np.ndarray:
    """uint8 [n, 3] viridis colours of inlier counts normalized from their
    min to their max, as matplotlib's scatter(c=counts) maps them (all at
    the low end when the counts are equal)."""
    c = np.asarray(counts, np.float64)
    if c.size == 0:
        return np.zeros((0, 3), np.uint8)
    lo, hi = c.min(), c.max()
    x = (c - lo) / (hi - lo) if hi > lo else np.zeros_like(c)
    return np.round(viridis(x) * 255).astype(np.uint8)


def visualize_hypothesis(rgb: np.ndarray, hyp_pts: np.ndarray,
                         hyp_counts: np.ndarray,
                         keypoints: Optional[np.ndarray] = None,
                         save_path: Optional[str] = None):
    """Hypothesis scatter colored by inlier count (ref draw_utils.py:139-174):
    one pixel per hypothesis inside the image, the counts normalized over
    those inside; keypoints as red crosses.

    Args:
      hyp_pts: [hn, vn, 2]; hyp_counts: [hn, vn].
    """
    img = draw.to_rgb_u8(rgb)
    h, w = img.shape[:2]
    pts = hyp_pts.reshape(-1, 2)
    cts = hyp_counts.reshape(-1).astype(np.float64)
    inside = ((pts[:, 0] >= 0) & (pts[:, 0] < w)
              & (pts[:, 1] >= 0) & (pts[:, 1] < h))
    draw.draw_dots(img, pts[inside], hypothesis_colors(cts[inside]))
    if keypoints is not None:
        for p in keypoints:
            draw.draw_marker(img, p, "x", draw.NAMED["r"], _MARKER)
    return _out(img, save_path)


def ellipse_params(cov: np.ndarray, n_std: float = 3.0):
    """(width, height, angle in degrees) of the n_std ellipse of a 2x2
    covariance, as visualize_voting_ellipse computes them (ref
    draw_utils.py:176-205): the axes from eigh's eigenvalues, the angle of
    the larger one's eigenvector."""
    lam, vec = np.linalg.eigh(cov)
    lam = np.maximum(lam, 0)
    ang = np.degrees(np.arctan2(vec[1, 1], vec[0, 1]))
    return 2 * n_std * np.sqrt(lam[1]), 2 * n_std * np.sqrt(lam[0]), ang


def visualize_voting_ellipse(rgb: np.ndarray, mean: np.ndarray,
                             cov: np.ndarray,
                             keypoints_gt: Optional[np.ndarray] = None,
                             n_std: float = 3.0,
                             save_path: Optional[str] = None):
    """Covariance ellipses around voted keypoints (ref draw_utils.py:176-205):
    blue outlines and centres, the GT keypoints as green crosses.

    Args:
      mean: [vn, 2]; cov: [vn, 2, 2].
    """
    img = draw.to_rgb_u8(rgb)
    blue = draw.NAMED["b"]
    for vi in range(mean.shape[0]):
        width, height, ang = ellipse_params(cov[vi], n_std)
        draw.draw_ellipse(img, mean[vi], width, height, ang, blue)
        draw.draw_dots(img, mean[vi][None], blue)
    if keypoints_gt is not None:
        for p in keypoints_gt:
            draw.draw_marker(img, p, "x", draw.NAMED["g"], _MARKER)
    return _out(img, save_path)


def pts_to_img_pts(pts: np.ndarray, R: np.ndarray, T: np.ndarray,
                   K: np.ndarray):
    """Project camera/world points; returns (pixels [n, 2], depths [n])
    (ref draw_utils.py:338-342)."""
    cam = pts @ R.T + T[None, :]
    img = cam @ K.T
    return img[:, :2] / img[:, 2:], img[:, 2]


def img_pts_to_pts_img_colors(img: np.ndarray, img_pts: np.ndarray,
                              rgbs: np.ndarray) -> np.ndarray:
    """Splat per-point colors into a copy of ``img``
    (ref draw_utils.py:325-336)."""
    out = img.copy()
    h, w = img.shape[:2]
    xs = np.clip(np.round(img_pts[:, 0]).astype(np.int64), 0, w - 1)
    ys = np.clip(np.round(img_pts[:, 1]).astype(np.int64), 0, h - 1)
    out[ys, xs] = rgbs
    return out


def write_points(filename: str, pts: np.ndarray,
                 colors: Optional[np.ndarray] = None) -> None:
    """Write an xyz[rgb] text point file (ref draw_utils.py:297-311);
    produces the farthest{N}.txt keypoint files (ref data_utils.py:145-152).
    """
    pts = np.asarray(pts)
    has_color = pts.shape[1] >= 6
    with open(filename, "w") as f:
        for i, pt in enumerate(pts):
            if colors is not None:
                c = colors[i] if colors.shape[0] == pts.shape[0] else colors
                f.write(f"{pt[0]} {pt[1]} {pt[2]} "
                        f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
            elif has_color:
                f.write(f"{pt[0]} {pt[1]} {pt[2]} "
                        f"{int(pt[3])} {int(pt[4])} {int(pt[5])}\n")
            else:
                f.write(f"{pt[0]} {pt[1]} {pt[2]}\n")


def _per_image(imgs, save_path):
    """The per-image functions' result: the written paths (``save_path``
    formatted with the batch index) or the arrays."""
    outs = []
    for bi, img in enumerate(imgs):
        outs.append(_out(img, save_path.format(bi) if save_path else None))
    return outs


def visualize_points(rgb: np.ndarray, pts_target: np.ndarray,
                     pts_pred: Optional[np.ndarray] = None,
                     save_path: Optional[str] = None):
    """2D keypoint overlay, one image per batch element
    (ref draw_utils.py:235-260): targets as green stars, predictions as
    blue ones. rgb [b, h, w, 3] uint8 NHWC; pts [b, pn, 2]."""
    rgb = rgb.astype(np.uint8)
    imgs = []
    for bi in range(pts_target.shape[0]):
        img = draw.to_rgb_u8(rgb[bi])
        for p in pts_target[bi]:
            draw.draw_marker(img, p, "*", draw.NAMED["g"], _MARKER)
        if pts_pred is not None:
            for p in pts_pred[bi]:
                draw.draw_marker(img, p, "*", draw.NAMED["b"], _MARKER)
        imgs.append(img)
    return _per_image(imgs, save_path)


def keypoint_colors(n: int) -> np.ndarray:
    """uint8 [n, 3] colours of keypoint indices 0..n-1, as scatter(c=idx)
    maps them through viridis."""
    return hypothesis_colors(np.arange(n))


def visualize_keypoints(rgb: np.ndarray, pts_target: np.ndarray,
                        pts_pred: Optional[np.ndarray] = None,
                        save_path: Optional[str] = None):
    """Like visualize_points but colors points by keypoint index so
    correspondences are visible (ref draw_utils.py:262-277): targets as
    circles, predictions as crosses."""
    rgb = rgb.astype(np.uint8)
    cols = keypoint_colors(pts_target.shape[1])
    imgs = []
    for bi in range(pts_target.shape[0]):
        img = draw.to_rgb_u8(rgb[bi])
        for p, c in zip(pts_target[bi], cols):
            draw.draw_marker(img, p, "o", c, _MARKER)
        if pts_pred is not None:
            for p, c in zip(pts_pred[bi], cols):
                draw.draw_marker(img, p, "x", c, _MARKER)
        imgs.append(img)
    return _per_image(imgs, save_path)


def visualize_overlap_mask(img: np.ndarray, mask: np.ndarray,
                           save_path: Optional[str] = None) -> np.ndarray:
    """Tint masked pixels green, in place per the reference
    (ref draw_utils.py:68-73). img [b, h, w, 3] uint8; mask [b, h, w].
    Returns the tinted batch; with save_path ('{}'-formatted) writes PNGs."""
    img = img.copy()
    sel = mask > 0
    img[sel] = img[sel] // 2 + np.array([0, 128, 0], np.uint8)
    if save_path:
        for bi in range(img.shape[0]):
            write_png(save_path.format(bi), img[bi])
    return img


def visualize_mask_multi_class(mask_pred: np.ndarray, mask_gt: np.ndarray,
                               colors: Optional[np.ndarray] = None,
                               save_path: Optional[str] = None):
    """Side-by-side pred/GT label masks under a shared palette
    (ref draw_utils.py:110-137), 2 black columns between them."""
    palette = _COLORS if colors is None else np.asarray(colors, np.uint8)
    imgs = []
    for bi in range(mask_pred.shape[0]):
        pred = palette[np.clip(mask_pred[bi], 0, len(palette) - 1)]
        gt = palette[np.clip(mask_gt[bi], 0, len(palette) - 1)]
        imgs.append(draw.side_by_side([pred, gt]))
    return _per_image(imgs, save_path)


def vanishing_arrows(van_cens: np.ndarray) -> np.ndarray:
    """[b, 3, 2, 2] (start, delta) of the arrows of
    visualize_vanishing_points: from the object centre, 20 px towards each
    vanishing point."""
    cen = van_cens[:, 3, :].copy()
    cen /= cen[:, 2:]
    out = np.zeros((van_cens.shape[0], 3, 2, 2))
    for bi in range(van_cens.shape[0]):
        for di in range(3):
            d = (van_cens[bi, di, :] - cen[bi] * van_cens[bi, di, 2])[:2]
            d = d / (np.linalg.norm(d) + 1e-12) * 20
            out[bi, di] = (cen[bi, :2], d)
    return out


def visualize_vanishing_points(rgb: np.ndarray, van_cens: np.ndarray,
                               save_path: Optional[str] = None):
    """Arrows from the object center toward its 3 vanishing points
    (ref draw_utils.py:209-233), in red, green and blue. van_cens
    [b, 4, 3]: rows 0-2 homogeneous vanishing points, row 3 the center."""
    arrows = vanishing_arrows(van_cens)
    imgs = []
    for bi in range(rgb.shape[0]):
        img = draw.to_rgb_u8(rgb[bi].astype(np.uint8))
        for di, color in zip(range(3), "rgb"):
            start, d = arrows[bi, di]
            draw.draw_arrow(img, start, d, draw.NAMED[color])
        imgs.append(img)
    return _per_image(imgs, save_path)


def visualize_points_3d(pts1: np.ndarray, pts2: np.ndarray, K: np.ndarray,
                        h: int = 480, w: int = 640):
    """Two-view point-cloud overlap images: green = both, yellow = pred
    only, red = target only (ref draw_utils.py:75-107). The second view is
    the cloud rotated 90 degrees about its centroid."""
    def _pts_img(pts, R, T):
        img_pts, _ = pts_to_img_pts(pts, np.identity(3), np.zeros(3), K)
        a = img_pts_to_pts_img(img_pts, h, w)
        trans = (pts - T) @ R.T + T
        t_pts, _ = pts_to_img_pts(trans, np.identity(3), np.zeros(3), K)
        return a, img_pts_to_pts_img(t_pts, h, w)

    def _overlay(a, b):
        img = np.zeros([h, w, 3], np.uint8)
        img[(a > 0) & (b > 0)] = (0, 255, 0)
        img[(a > 0) & (b == 0)] = (255, 255, 0)
        img[(a == 0) & (b > 0)] = (255, 0, 0)
        return img

    T = np.mean(np.concatenate([pts1, pts2], 0), 0)[None, :]
    # rotate 90deg about the y axis through the centroid
    R = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])
    a1, t1 = _pts_img(pts1, R, T)
    a2, t2 = _pts_img(pts2, R, T)
    return _overlay(a1, a2), _overlay(t1, t2)
