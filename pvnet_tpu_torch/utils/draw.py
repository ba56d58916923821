"""Plain-numpy drawing into uint8 [h, w, 3] images, for the overlays of
utils/viz.py.

The JAX package draws its overlays with matplotlib, which the GPU host
does not have. The port rasterizes them itself, at the image's own size:
1-px segments, markers made of segments or circles, ellipse outlines and
arrows. Pixel centres lie at integer coordinates, and pixel (y, x) covers
[x - 0.5, x + 0.5) x [y - 0.5, y + 0.5). A segment colours every pixel
whose square it passes through (a supercover line), so every point of the
segment lies on a coloured pixel and every coloured pixel's centre lies
within sqrt(2) / 2 px of the segment. Curves are drawn as polylines whose
chords stay within 1e-4 px of the curve. Whatever falls outside the image
is clipped."""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np

Color = Tuple[int, int, int]

# matplotlib's single-letter colours at the call sites of utils/viz.py
NAMED = {"b": (0, 0, 255), "g": (0, 128, 0), "r": (255, 0, 0)}

# the sagitta that a curve's polyline may leave, in px
_CURVE_TOL = 1e-4


def _clip_segment(p0: np.ndarray, p1: np.ndarray, h: int, w: int):
    """The part of segment p0-p1 within the image's squares widened by one
    pixel (Liang-Barsky), or None."""
    lo = np.array([-1.5, -1.5])
    hi = np.array([w + 0.5, h + 0.5])
    d = p1 - p0
    t0, t1 = 0.0, 1.0
    for k in range(2):
        if d[k] == 0:
            if not lo[k] <= p0[k] <= hi[k]:
                return None
            continue
        ta, tb = (lo[k] - p0[k]) / d[k], (hi[k] - p0[k]) / d[k]
        t0, t1 = max(t0, min(ta, tb)), min(t1, max(ta, tb))
        if t0 > t1:
            return None
    return p0 + t0 * d, p0 + t1 * d


def segment_pixels(p0, p1, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ys, xs) of the pixels of an [h, w] image whose squares the segment
    p0-p1 ((x, y) each) passes through."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    if not (np.isfinite(p0).all() and np.isfinite(p1).all()):
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    seg = _clip_segment(p0, p1, h, w)
    if seg is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    a, b = seg
    d = b - a
    ts = [np.array([0.0, 1.0])]
    for k in range(2):
        if d[k] != 0:
            lo, hi = sorted((a[k], b[k]))
            edges = np.arange(math.ceil(lo - 0.5), math.floor(hi - 0.5) + 1
                              ) + 0.5
            ts.append((edges - a[k]) / d[k])
    t = np.unique(np.clip(np.concatenate(ts), 0.0, 1.0))
    # one point inside each stretch between crossings, and both ends
    t = np.concatenate([t, (t[:-1] + t[1:]) / 2])
    pts = a[None] + t[:, None] * d[None]
    xs = np.floor(pts[:, 0] + 0.5).astype(np.int64)
    ys = np.floor(pts[:, 1] + 0.5).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    return ys[keep], xs[keep]


def draw_segment(img: np.ndarray, p0, p1, color: Color) -> None:
    """Colour the segment p0-p1 into ``img`` [h, w, 3] in place."""
    ys, xs = segment_pixels(p0, p1, *img.shape[:2])
    img[ys, xs] = color


def curve_vertices(radius: float) -> int:
    """Vertices of a closed polyline whose chords leave at most
    ``_CURVE_TOL`` px from a curve of largest radius ``radius``."""
    if radius <= _CURVE_TOL:
        return 4
    half = math.acos(max(-1.0, 1.0 - _CURVE_TOL / radius))
    return max(8, int(math.ceil(math.pi / half)))


def ellipse_points(center, width: float, height: float, angle_deg: float,
                   n: int = 0) -> np.ndarray:
    """[n, 2] points of the ellipse that matplotlib.patches.Ellipse(center,
    width, height, angle) outlines: axes ``width`` and ``height`` (full
    lengths), the first along the direction ``angle_deg`` from +x
    (counter-clockwise in matplotlib's frame, which on an image's y-down
    axis turns towards +y). ``n`` 0 picks :func:`curve_vertices`."""
    a, b = width / 2.0, height / 2.0
    if n <= 0:
        n = curve_vertices(max(a, b))
    th = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    ang = math.radians(angle_deg)
    c, s = math.cos(ang), math.sin(ang)
    ex, ey = a * np.cos(th), b * np.sin(th)
    return np.stack([center[0] + c * ex - s * ey,
                     center[1] + s * ex + c * ey], -1)


def draw_ellipse(img: np.ndarray, center, width: float, height: float,
                 angle_deg: float, color: Color) -> None:
    """Outline :func:`ellipse_points`' ellipse (a closed polyline)."""
    pts = ellipse_points(center, width, height, angle_deg)
    for a, b in zip(pts, np.roll(pts, -1, 0)):
        draw_segment(img, a, b, color)


def marker_segments(center, kind: str, size: float) -> np.ndarray:
    """The segments [m, 2, 2] of marker ``kind`` ('x': a cross of two
    diagonals, '*': an asterisk of four strokes) of half-width ``size``
    at ``center``."""
    cx, cy = float(center[0]), float(center[1])
    r = float(size)
    d = r / math.sqrt(2.0)
    diag = [((cx - d, cy - d), (cx + d, cy + d)),
            ((cx - d, cy + d), (cx + d, cy - d))]
    if kind == "x":
        segs = diag
    elif kind == "*":
        segs = diag + [((cx - r, cy), (cx + r, cy)),
                       ((cx, cy - r), (cx, cy + r))]
    else:
        raise ValueError(f"marker must be 'x', '*' or 'o', got {kind!r}")
    return np.asarray(segs, np.float64)


def draw_marker(img: np.ndarray, center, kind: str, color: Color,
                size: float = 3.0) -> None:
    """A marker at ``center``: 'x' and '*' (:func:`marker_segments`) or
    'o' (a circle of radius ``size``). A centre that is not finite draws
    nothing."""
    if not np.isfinite(np.asarray(center, np.float64)).all():
        return
    if kind == "o":
        draw_ellipse(img, center, 2 * size, 2 * size, 0.0, color)
        return
    for a, b in marker_segments(center, kind, size):
        draw_segment(img, a, b, color)


def arrow_segments(start, delta) -> np.ndarray:
    """The segments [3, 2, 2] of an arrow from ``start`` along ``delta``:
    the shaft and two head strokes of a quarter of its length at 150
    degrees from it."""
    p0 = np.asarray(start, np.float64)
    d = np.asarray(delta, np.float64)
    tip = p0 + d
    segs = [(p0, tip)]
    for sgn in (1.0, -1.0):
        ang = sgn * math.radians(150.0)
        c, s = math.cos(ang), math.sin(ang)
        back = np.array([c * d[0] - s * d[1], s * d[0] + c * d[1]]) * 0.25
        segs.append((tip, tip + back))
    return np.asarray(segs, np.float64)


def draw_arrow(img: np.ndarray, start, delta, color: Color) -> None:
    """An arrow from ``start`` along ``delta`` (:func:`arrow_segments`)."""
    for a, b in arrow_segments(start, delta):
        draw_segment(img, a, b, color)


def draw_dots(img: np.ndarray, pts: np.ndarray, colors) -> None:
    """Colour the pixel under each point of ``pts`` [n, 2] with its colour
    (``colors`` [n, 3] or one colour); points outside the image or not
    finite are skipped."""
    pts = np.asarray(pts, np.float64).reshape(-1, 2)
    h, w = img.shape[:2]
    ok = np.isfinite(pts).all(-1)
    xs = np.floor(np.where(ok, pts[:, 0], -1.0) + 0.5)
    ys = np.floor(np.where(ok, pts[:, 1], -1.0) + 0.5)
    keep = ok & (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    cols = np.broadcast_to(np.asarray(colors, np.uint8), (len(pts), 3))
    img[ys[keep].astype(np.int64), xs[keep].astype(np.int64)] = cols[keep]


def as_color(c) -> Color:
    """A matplotlib single-letter colour ('b', 'g', 'r') or an RGB triple."""
    if isinstance(c, str):
        return NAMED[c]
    return tuple(int(v) for v in c)


def to_rgb_u8(img: np.ndarray) -> np.ndarray:
    """A uint8 [h, w, 3] copy of an RGB or gray image to draw on."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, -1)
    return np.ascontiguousarray(a[..., :3]).astype(np.uint8, copy=True)


def side_by_side(images: Sequence[np.ndarray], pad: int = 2) -> np.ndarray:
    """uint8 images of one height side by side, ``pad`` black columns
    between them."""
    h = images[0].shape[0]
    gap = np.zeros((h, pad, 3), np.uint8)
    parts = []
    for i, im in enumerate(images):
        if i:
            parts.append(gap)
        parts.append(im)
    return np.concatenate(parts, 1)
