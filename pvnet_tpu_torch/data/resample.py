"""PIL's bilinear resize without PIL (``Image.resize(size, Image.BILINEAR)``).

PIL resamples with a separable triangle filter whose support widens by the
scale factor when it shrinks an axis, so every input pixel under the
widened triangle contributes (cv2's LINEAR, data/cv_ops.resize, reads two
pixels whatever the scale). Both passes follow Pillow's
``libImaging/Resample.c``:

- the coefficients (``precompute_coeffs``): for output pixel ``xx`` the
  center ``(xx + 0.5) * scale``, the window ``[int(center - support +
  0.5), int(center + support + 0.5))`` clipped to the input, the triangle
  at ``(x - center + 0.5) / filterscale``, normalized by their sum;
- the horizontal pass first (on the rows the vertical pass reads), then the
  vertical one, each only where that axis changes size;
- uint8 (``normalize_coeffs_8bpc``): coefficients rounded to 22 fraction
  bits, a rounding half added, the sum shifted down and clipped to 0..255
  after each pass;
- float32 (mode "F"): coefficients and sums in float64, each pass's result
  stored as float32.

The uint8 sums are integers below 2**30, so a float64 matrix product
gives them exactly in any order.
"""
from __future__ import annotations

import numpy as np

_PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] float64 weights of one axis (PIL's
    precompute_coeffs for the bilinear filter, support 1)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ss = 1.0 / filterscale
    k = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        w = [max(1.0 - abs((x - center + 0.5) * ss), 0.0)
             for x in range(xmin, xmax)]
        total = 0.0
        for v in w:                     # PIL's order of summation
            total += v
        if total != 0.0:
            w = [v / total for v in w]
        k[xx, xmin:xmax] = w
    return k


def _fixed_point(k: np.ndarray) -> np.ndarray:
    """PIL's 8-bit coefficients: each weight times 2**22, rounded half away
    from zero, as float64 integers."""
    scaled = k * (1 << _PRECISION_BITS)
    return np.where(k < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))


def _pass_u8(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (0 rows, 1 columns) of [h, w, c]."""
    kk = _fixed_point(k)
    xf = x.astype(np.float64)
    if axis == 1:
        acc = np.einsum("hwc,ow->hoc", xf, kk, optimize=True)
    else:
        acc = np.einsum("hwc,oh->owc", xf, kk, optimize=True)
    acc = acc.astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass_f(x: np.ndarray, k: np.ndarray, axis: int) -> np.ndarray:
    xf = x.astype(np.float64)
    if axis == 1:
        out = np.einsum("hwc,ow->hoc", xf, k, optimize=True)
    else:
        out = np.einsum("hwc,oh->owc", xf, k, optimize=True)
    return out.astype(np.float32)


def resize_bilinear(image: np.ndarray, height: int, width: int
                    ) -> np.ndarray:
    """``image`` [h, w] or [h, w, c] resized to (height, width) as PIL's
    BILINEAR resize of an "RGB"/"L" image (uint8) or of one "F" image per
    channel (any float dtype, computed as float32). Returns uint8 or
    float32 of the new size."""
    arr = np.asarray(image)
    flat = arr.ndim == 2
    if flat:
        arr = arr[:, :, None]
    if arr.ndim != 3 or height < 1 or width < 1 or 0 in arr.shape[:2]:
        raise ValueError(f"cannot resize an image of shape {image.shape} "
                         f"to {(height, width)}")
    if np.issubdtype(arr.dtype, np.floating):
        arr, one_pass = arr.astype(np.float32), _pass_f
    elif arr.dtype == np.uint8:
        one_pass = _pass_u8
    else:
        raise TypeError(f"uint8 or float images only, got {arr.dtype}")
    h, w = arr.shape[:2]
    out = arr.copy()
    if (height, width) != (h, w):
        kv = _coefficients(h, height)
        if width != w:
            # only the rows the vertical pass reads (PIL's ybox)
            rows = np.flatnonzero(kv.any(0)) if height != h else np.arange(h)
            first, last = int(rows[0]), int(rows[-1]) + 1
            out = one_pass(out[first:last], _coefficients(w, width), 1)
            kv = kv[:, first:last]
        if height != h:
            out = one_pass(out, kv, 0)
    return out[:, :, 0] if flat else out
