"""The OpenCV calls of the JAX package's host augmentation
(pvnet_tpu/data/augment.py), with OpenCV's own arithmetic, on tensors of
any device: the same dtypes, borders and rounding, so that a frame warped,
resized, blurred or colour-shifted here equals OpenCV's result byte for
byte. No OpenCV is imported; tests/test_torch_host_augment.py holds each
function against it.

The arithmetic is the one OpenCV 5.0's x86 build runs, found by probing
it (its AVX-512 dispatch; the SIMD width shows where a row's vector part
ends and its scalar tail begins):

- ``warp_affine``: the matrix is inverted in double. uint8 sources map
  each output pixel in float32, ``sx = fma(x, M00, fl(y*M01) + M02)`` in
  the vector part of a row (``WARP_LANES`` pixels a vector) and
  ``sx = fl(fma(x, M00, fl(y*M01)) + M02)`` in its tail; INTER_LINEAR
  blends the four taps with three fused multiply-adds (a tap outside the
  frame is 0) and rounds half to even, INTER_NEAREST rounds the
  coordinate half to even. int32 sources take OpenCV's older fixed-point
  map (10 fractional bits, the rounding delta added before the shift).
- ``resize``: INTER_LINEAR on uint8 is 11-bit fixed point, rows exact,
  columns by the vector formula ``((S0>>4)*b0>>16) + ((S1>>4)*b1>>16)``,
  then ``(v+2)>>2``, for every pixel; INTER_NEAREST takes
  ``floor(x / (w/W))``.
- ``gaussian_blur``: the bit-exact 8-bit path (kernels in 1/256,
  separable, rounded once at 16 fractional bits, BORDER_REFLECT_101).
- ``rgb_to_gray``: 15-bit fixed point. ``rgb_to_hsv``: OpenCV's 12-bit
  division tables, hue 0..179. ``hsv_to_rgb``: float32 with fused
  multiply-adds, truncated in the vector part of a row (``HSV_BLOCK``
  pixels a block) and rounded in its tail.
- ``filter2d``: the correlation in float64, rounded half to even; exact
  wherever the true sum lies off a rounding midpoint, as it does for
  add_noise's line kernels (1/size, odd sizes).

A fused multiply-add is emulated in float64 (the product of two float32
values is exact there, the sum is rounded once to float64 and once to
float32), the same way on every device.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

INTER_NEAREST = 0
INTER_LINEAR = 1

WARP_LANES = 16      # float32 lanes of warpAffine's vector loop
HSV_BLOCK = 32       # pixels of HSV2RGB's vector loop


def get_rotation_matrix_2d(center: Sequence[float], angle: float,
                           scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: [2, 3] float64; the center is taken as
    float32, as OpenCV's Point2f holds it."""
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M: np.ndarray) -> np.ndarray:
    """The inverse of a 2x3 affine map as warpAffine computes it (double;
    a singular map gives zeros)."""
    M = np.asarray(M, np.float64).copy()
    D = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    D = 1.0 / D if D != 0 else 0.0
    A11, A22 = M[1, 1] * D, M[0, 0] * D
    M[0, 0], M[1, 1] = A11, A22
    M[0, 1] *= -D
    M[1, 0] *= -D
    b1 = -M[0, 0] * M[0, 2] - M[0, 1] * M[1, 2]
    b2 = -M[1, 0] * M[0, 2] - M[1, 1] * M[1, 2]
    M[0, 2], M[1, 2] = b1, b2
    return M


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fma(a, b, c), emulated in float64."""
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    return (a.double() * b + c).float()


def _f32(x) -> float:
    return float(np.float32(x))


def _map_coords(M: np.ndarray, dsize: Tuple[int, int], device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sx, sy) float32 [h, w]: the source point of each output pixel of a
    uint8 warp (the module docstring)."""
    w, h = dsize
    m = invert_affine(M).astype(np.float32)
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    start = w - w % WARP_LANES
    out = []
    for r in range(2):
        m0, m1, m2 = (_f32(v) for v in m[r])
        row = ys * m1                                  # fl(y*M1)
        vec = _fma(xs, m0, row + m2)
        tail = _fma(xs, m0, row) + m2
        out.append(torch.cat([vec[:, :start], tail[:, start:]], 1)
                   if start < w else vec.expand(h, w).clone())
    return out[0], out[1]


def _taps(src: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor
          ) -> torch.Tensor:
    """src [H, W, C] at (iy, ix) [h, w], 0 outside the frame; [h, w, C]."""
    H, W = src.shape[:2]
    inside = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    flat = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(-1)
    v = src.reshape(H * W, -1)[flat].reshape(iy.shape + (-1,))
    return torch.where(inside[..., None], v, torch.zeros((), dtype=v.dtype,
                                                         device=v.device))


def warp_affine(src: torch.Tensor, M: np.ndarray, dsize: Tuple[int, int],
                interpolation: int = INTER_LINEAR) -> torch.Tensor:
    """cv2.warpAffine(src, M, dsize, flags=interpolation,
    borderMode=BORDER_CONSTANT, borderValue=0) of a uint8 [H, W] or
    [H, W, C] source (INTER_LINEAR or INTER_NEAREST) or an int32 [H, W]
    one (INTER_NEAREST); ``M`` maps source to output; ``dsize`` is
    (width, height)."""
    w, h = dsize
    gray = src.dim() == 2
    x = src[..., None] if gray else src
    if src.dtype == torch.int32:
        if interpolation != INTER_NEAREST:
            raise ValueError("int32 sources warp with INTER_NEAREST only")
        out = _taps(x, *_fixed_nearest_map(M, dsize, src.device))
    elif src.dtype == torch.uint8:
        sx, sy = _map_coords(M, dsize, src.device)
        if interpolation == INTER_NEAREST:
            out = _taps(x, torch.round(sy).long(), torch.round(sx).long())
        elif interpolation == INTER_LINEAR:
            fx0, fy0 = torch.floor(sx), torch.floor(sy)
            fx, fy = (sx - fx0)[..., None], (sy - fy0)[..., None]
            ix, iy = fx0.long(), fy0.long()
            p00, p01, p10, p11 = (_taps(x, iy + a, ix + b).float()
                                  for a, b in ((0, 0), (0, 1), (1, 0),
                                               (1, 1)))
            v0 = _fma(fx, p01 - p00, p00)
            v1 = _fma(fx, p11 - p10, p10)
            v = _fma(fy, v1 - v0, v0)
            out = torch.round(v).clamp(0, 255).to(torch.uint8)
        else:
            raise ValueError(f"interpolation {interpolation}")
    else:
        raise ValueError(f"warp_affine takes uint8 or int32, got {src.dtype}")
    return out[..., 0] if gray else out


def _fixed_nearest_map(M: np.ndarray, dsize: Tuple[int, int], device
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(iy, ix) int64 [h, w] of OpenCV's fixed-point nearest map."""
    w, h = dsize
    m = torch.from_numpy(invert_affine(M)).to(device)
    xs = torch.arange(w, dtype=torch.float64, device=device)
    ys = torch.arange(h, dtype=torch.float64, device=device)
    ab = 1024.0
    out = []
    for r in range(2):
        delta = torch.round(m[r, 0] * xs * ab).long()
        base = torch.round((m[r, 1] * ys + m[r, 2]) * ab).long() + 512
        out.append(torch.div(base[:, None] + delta[None, :], 1024,
                             rounding_mode="floor"))
    return out[1], out[0]


def _linear_coefs(n_src: int, n_dst: int) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """(first source index, its weight, the next one's) of each output
    position of an INTER_LINEAR resize, weights in 1/2048, unclamped."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(
        np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    c0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64)
    c1 = np.rint(f * np.float32(2048)).astype(np.int64)
    return s, c0, c1


def resize(src: torch.Tensor, dsize: Tuple[int, int],
           interpolation: int = INTER_LINEAR) -> torch.Tensor:
    """cv2.resize(src, dsize, interpolation=...): INTER_LINEAR of a uint8
    [H, W] or [H, W, C] image, INTER_NEAREST of any dtype; ``dsize`` is
    (width, height)."""
    w, h = dsize
    H, W = src.shape[:2]
    dev = src.device
    if interpolation == INTER_NEAREST:
        sx = np.minimum(np.floor(np.arange(w) * (1.0 / (w / W))).astype(
            np.int64), W - 1)
        sy = np.minimum(np.floor(np.arange(h) * (1.0 / (h / H))).astype(
            np.int64), H - 1)
        return src[torch.from_numpy(sy).to(dev)][:, torch.from_numpy(sx)
                                                   .to(dev)]
    if interpolation != INTER_LINEAR or src.dtype != torch.uint8:
        raise ValueError("resize: INTER_LINEAR takes uint8 images")
    gray = src.dim() == 2
    x = (src[..., None] if gray else src).to(torch.int32)
    sx, a0, a1 = _linear_coefs(W, w)
    low, high = sx < 0, sx >= W - 1
    a0[low | high], a1[low | high] = 2048, 0
    sx = np.clip(sx, 0, W - 1)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rows = (x[:, t(sx)] * t(a0).int()[None, :, None]
            + x[:, t(np.minimum(sx + 1, W - 1))] * t(a1).int()[None, :, None])
    sy, b0, b1 = _linear_coefs(H, h)
    r0, r1 = t(np.clip(sy, 0, H - 1)), t(np.clip(sy + 1, 0, H - 1))
    b0, b1 = t(b0).int()[:, None, None], t(b1).int()[:, None, None]
    v = (((rows[r0] >> 4) * b0) >> 16) + (((rows[r1] >> 4) * b1) >> 16)
    out = ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)
    return out[..., 0] if gray else out


def _reflect101(n: int, r: int) -> np.ndarray:
    """Indices -r..n+r-1 folded into 0..n-1 by BORDER_REFLECT_101."""
    i = np.arange(-r, n + r)
    if n == 1:
        return np.zeros_like(i)
    while (i < 0).any() or (i >= n).any():
        i = np.where(i < 0, -i, i)
        i = np.where(i >= n, 2 * (n - 1) - i, i)
    return i


# the 8-bit Gaussian kernels of sigma 0, in 1/256 (OpenCV's fixed tables
# for 3, 5 and 7; 9 from its bit-exact kernel of sigma 1.7 with its error
# diffusion to 8 fractional bits)
GAUSS_KERNELS = {3: (64, 128, 64), 5: (16, 64, 96, 64, 16),
                 7: (8, 28, 56, 72, 56, 28, 8),
                 9: (4, 13, 30, 51, 60, 51, 30, 13, 4)}


def gaussian_blur(src: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.GaussianBlur(src, (ksize, ksize), 0) of a uint8 [H, W(, C)]
    image, ksize 3, 5, 7 or 9."""
    k = torch.tensor(GAUSS_KERNELS[ksize], dtype=torch.int32,
                     device=src.device)
    r = ksize // 2
    gray = src.dim() == 2
    x = (src[..., None] if gray else src).to(torch.int32)
    H, W = x.shape[:2]
    xp = x[:, torch.from_numpy(_reflect101(W, r)).to(src.device)]
    rows = sum(k[j] * xp[:, j:j + W] for j in range(ksize))
    rp = rows[torch.from_numpy(_reflect101(H, r)).to(src.device)]
    cols = sum(k[i] * rp[i:i + H] for i in range(ksize))
    out = ((cols + 32768) >> 16).clamp(0, 255).to(torch.uint8)
    return out[..., 0] if gray else out


def rgb_to_gray(src: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(src, COLOR_RGB2GRAY): uint8 [H, W, 3] -> [H, W]."""
    x = src.to(torch.int32)
    g = (x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735
         + 16384) >> 15
    return g.to(torch.uint8)


def _hsv_tables(device) -> Tuple[torch.Tensor, torch.Tensor]:
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << 12) / i)
    hdiv[1:] = np.rint((180 << 12) / (6.0 * i))
    return (torch.from_numpy(sdiv).to(device),
            torch.from_numpy(hdiv).to(device))


def rgb_to_hsv(src: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(src, COLOR_RGB2HSV): uint8 [H, W, 3] -> uint8 H, S, V
    with hue 0..179."""
    x = src.to(torch.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    sdiv, hdiv = _hsv_tables(src.device)
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    s = (diff * sdiv[v] + 2048) >> 12
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + 2048) >> 12
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], -1).to(torch.uint8)


_SECTORS = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def hsv_to_rgb(src: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(src, COLOR_HSV2RGB): uint8 H (0..179), S, V
    [H, W, 3] -> uint8 RGB."""
    x = src.to(torch.float32)
    h = x[..., 0] * _f32(np.float32(6.0) / np.float32(180))
    s = x[..., 1] * _f32(1 / 255.0)
    v = x[..., 2] * _f32(1 / 255.0)
    sector = torch.floor(h)
    h = h - sector
    sector = sector.long() % 6
    one = torch.ones((), dtype=torch.float32, device=src.device)
    tab = torch.stack([v, v * (one - s), v * _fma(-s, h, one),
                       v * _fma(-s, one - h, one)], 0)
    sel = torch.tensor(_SECTORS, device=src.device)[sector]   # [H, W, 3]
    bgr = torch.gather(tab, 0, sel.permute(2, 0, 1))           # [3, H, W]
    rgb = bgr.flip(0).permute(1, 2, 0) * 255.0
    W = src.shape[1]
    cut = W - W % HSV_BLOCK
    out = torch.cat([torch.trunc(rgb[:, :cut]), torch.round(rgb[:, cut:])],
                    1)
    return out.clamp(0, 255).to(torch.uint8)


def filter2d(src: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.filter2D(src, -1, kernel) of a uint8 [H, W(, C)] image with a
    float64 kernel (odd sides, anchor at the center, BORDER_REFLECT_101),
    computed in float64 and rounded half to even (the module docstring)."""
    kernel = np.asarray(kernel, np.float64)
    kh, kw = kernel.shape
    gray = src.dim() == 2
    x = (src[..., None] if gray else src).to(torch.float64)
    H, W = x.shape[:2]
    dev = src.device
    xp = x[torch.from_numpy(_reflect101(H, kh // 2)).to(dev)][
        :, torch.from_numpy(_reflect101(W, kw // 2)).to(dev)]
    acc = torch.zeros_like(x)
    for i, j in zip(*np.nonzero(kernel)):
        acc = acc + xp[i:i + H, j:j + W] * float(kernel[i, j])
    out = torch.round(acc).clamp(0, 255).to(torch.uint8)
    return out[..., 0] if gray else out
