"""Host augmentation of one sample, ported from pvnet_tpu/data/augment.py
(ref lib/datasets/augmentation.py): instance-centered rotation, crop-resize
keeping a minimum instance overlap, fixed-size crop-or-pad, random
occluder mask-out, blur, flip, colour jitter, the one-warp fused path and
noise. Every function has the JAX package's name and arguments.

The random draws and the geometry run on the host in numpy, line for line
as the JAX package's, so that one ``np.random.RandomState`` gives its
draws in its order (none of them depends on pixels, only on the mask).
The pixel work runs in torch on the image's device through data/cv_ops
(OpenCV's arithmetic without OpenCV): ``img`` is a uint8 [h, w, 3]
tensor, ``mask`` a numpy [h, w] array (int32 in PoseDataset; its warps
run on the CPU), ``hcoords`` numpy [k, 3]. Images come back as tensors
on their device, masks and hcoords as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from pvnet_tpu_torch.data import cv_ops


def _mask_op(fn, mask: np.ndarray, *args) -> np.ndarray:
    """A cv_ops call on a host mask, through a CPU tensor."""
    return fn(torch.from_numpy(np.ascontiguousarray(mask)), *args).numpy()


def rotate_instance(img, mask, hcoords, rot_ang_min, rot_ang_max, rng):
    """Rotate around the instance centroid (ref augmentation.py:55-64)."""
    h, w = img.shape[0], img.shape[1]
    degree = rng.uniform(rot_ang_min, rot_ang_max)
    hs, ws = np.nonzero(mask)
    R = cv_ops.get_rotation_matrix_2d((float(np.mean(ws)),
                                       float(np.mean(hs))), degree, 1)
    mask = _mask_op(cv_ops.warp_affine, mask, R, (w, h),
                    cv_ops.INTER_NEAREST)
    img = cv_ops.warp_affine(img, R, (w, h), cv_ops.INTER_LINEAR)
    last_row = np.asarray([[0, 0, 1]], np.float32)
    hcoords = np.matmul(hcoords,
                        np.concatenate([R, last_row], 0).transpose())
    return img, mask, hcoords


def flip(img, mask, hcoords):
    """Horizontal flip (ref augmentation.py:66-73)."""
    img = torch.flip(img, [1])
    mask = np.flip(mask, 1)
    w = img.shape[1]
    hcoords = hcoords.copy()
    hcoords[:, 0] -= w / 2 * hcoords[:, 2]
    hcoords[:, 0] = -hcoords[:, 0]
    hcoords[:, 0] += w / 2 * hcoords[:, 2]
    return img, mask, hcoords


def _pad_to(img: torch.Tensor, mask: np.ndarray, th: int, tw: int,
            hoff: int, woff: int):
    """The crop placed at (hoff, woff) on zero canvases of [th, tw]."""
    nh, nw = img.shape[0], img.shape[1]
    new_img = torch.zeros((th, tw, 3), dtype=img.dtype, device=img.device)
    new_mask = np.zeros([th, tw], dtype=mask.dtype)
    new_img[hoff:hoff + nh, woff:woff + nw] = img
    new_mask[hoff:hoff + nh, woff:woff + nw] = mask
    return new_img, new_mask


def crop_or_padding_to_fixed_size_instance(img, mask, hcoords, th, tw,
                                           overlap_ratio, rng):
    """Fixed-size crop keeping >= overlap_ratio of the instance bbox inside
    (ref augmentation.py:118-158)."""
    h, w = img.shape[0], img.shape[1]
    hs, ws = np.nonzero(mask)
    hmin, hmax = np.min(hs), np.max(hs)
    wmin, wmax = np.min(ws), np.max(ws)
    box_h, box_w = hmax - hmin, wmax - wmin
    hpad, wpad = th >= h, tw >= w

    row_beg_hi = int(min(hmin + overlap_ratio * box_h, h - th))
    row_beg_lo = int(max(hmin + overlap_ratio * box_h - th, 0))
    col_beg_hi = int(min(wmin + overlap_ratio * box_w, w - tw))
    col_beg_lo = int(max(wmin + overlap_ratio * box_w - tw, 0))

    hbeg = 0 if hpad else rng.randint(row_beg_lo,
                                      max(row_beg_hi, row_beg_lo + 1))
    wbeg = 0 if wpad else rng.randint(col_beg_lo,
                                      max(col_beg_hi, col_beg_lo + 1))

    img = img[hbeg:hbeg + th, wbeg:wbeg + tw]
    mask = mask[hbeg:hbeg + th, wbeg:wbeg + tw]
    hcoords = hcoords.copy()
    hcoords[:, 0] -= wbeg * hcoords[:, 2]
    hcoords[:, 1] -= hbeg * hcoords[:, 2]

    if hpad or wpad:
        hoff = 0 if not hpad else (th - h) // 2
        woff = 0 if not wpad else (tw - w) // 2
        img, mask = _pad_to(img, mask, th, tw, hoff, woff)
        hcoords[:, 0] += woff * hcoords[:, 2]
        hcoords[:, 1] += hoff * hcoords[:, 2]
    return img, mask, hcoords


def crop_or_padding_to_fixed_size(img, mask, th, tw, rng):
    """Background-only fixed-size crop/pad (ref augmentation.py:160-185)."""
    h, w = img.shape[0], img.shape[1]
    hpad, wpad = th >= h, tw >= w
    hbeg = 0 if hpad else rng.randint(0, h - th)
    wbeg = 0 if wpad else rng.randint(0, w - tw)
    img = img[hbeg:hbeg + th, wbeg:wbeg + tw]
    mask = mask[hbeg:hbeg + th, wbeg:wbeg + tw]
    if hpad or wpad:
        hoff = 0 if not hpad else (th - h) // 2
        woff = 0 if not wpad else (tw - w) // 2
        img, mask = _pad_to(img, mask, th, tw, hoff, woff)
    return img, mask


def crop_resize_instance_v1(img, mask, hcoords, imheight, imwidth,
                            overlap_ratio, ratio_min, ratio_max, rng):
    """Crop a region of [imheight, imwidth] * ratio containing the instance,
    then resize to [imheight, imwidth] (ref augmentation.py:250-279)."""
    resize_ratio = rng.uniform(ratio_min, ratio_max)
    th = int(imheight * resize_ratio)
    tw = int(imwidth * resize_ratio)
    img, mask, hcoords = crop_or_padding_to_fixed_size_instance(
        img, mask, hcoords, th, tw, overlap_ratio, rng)
    img = cv_ops.resize(img, (imwidth, imheight), cv_ops.INTER_LINEAR)
    mask = _mask_op(cv_ops.resize, mask, (imwidth, imheight),
                    cv_ops.INTER_NEAREST)
    hcoords = hcoords.copy()
    hcoords[:, 0] = hcoords[:, 0] / resize_ratio
    hcoords[:, 1] = hcoords[:, 1] / resize_ratio
    return img, mask, hcoords


def compute_resize_range(mask, hmin, hmax, wmin, wmax):
    """(ref augmentation.py:235-247)"""
    ys, xs = np.nonzero(mask)
    xlen = max(int(np.max(xs) - np.min(xs)), 1)
    ylen = max(int(np.max(ys) - np.min(ys)), 1)
    rmin, rmax = wmin / xlen, wmax / xlen
    rmax = min(rmax, hmax / ylen)
    rmin = max(rmin, hmin / ylen)
    return rmin, rmax


def crop_resize_instance_v2(img, mask, hcoords, imheight, imwidth,
                            overlap_ratio, hmin, hmax, wmin, wmax, rng):
    """80%-probability instance-size-normalizing resize, then fixed-size
    instance crop (ref augmentation.py:281-313)."""
    if rng.random() < 0.8:
        rmin, rmax = compute_resize_range(mask, hmin, hmax, wmin, wmax)
        if rmax > rmin:
            resize_ratio = rng.uniform(rmin, rmax)
        else:
            resize_ratio = rmin
        h, w = mask.shape
        th, tw = int(h * resize_ratio), int(w * resize_ratio)
        img = cv_ops.resize(img, (tw, th), cv_ops.INTER_LINEAR)
        mask = _mask_op(cv_ops.resize, mask, (tw, th), cv_ops.INTER_NEAREST)
        hcoords = hcoords.copy()
        hcoords[:, 0] = hcoords[:, 0] * resize_ratio
        hcoords[:, 1] = hcoords[:, 1] * resize_ratio
    return crop_or_padding_to_fixed_size_instance(
        img, mask, hcoords, imheight, imwidth, overlap_ratio, rng)


def mask_out_instance(img, mask, min_side, max_side, rng):
    """Random occluder rectangle over the instance
    (ref augmentation.py:187-202). The rectangle follows numpy's slicing,
    a negative start counting from the end as there."""
    ys, xs = np.nonzero(mask)
    xmin, xmax = np.min(xs), np.max(xs)
    ymin, ymax = np.min(ys), np.max(ys)
    xlen, ylen = xmax - xmin, ymax - ymin
    x_side = int(xlen * rng.uniform(min_side, max_side) / 2)
    y_side = int(ylen * rng.uniform(min_side, max_side) / 2)
    x_loc = rng.randint(xmin, max(xmax, xmin + 1))
    y_loc = rng.randint(ymin, max(ymax, ymin + 1))
    img = img.clone()
    mask = mask.copy()
    rows = slice(y_loc - y_side, y_loc + y_side)
    cols = slice(x_loc - x_side, x_loc + x_side)
    r0, r1, _ = rows.indices(img.shape[0])
    c0, c1, _ = cols.indices(img.shape[1])
    shape = (max(0, r1 - r0), max(0, c1 - c0), img.shape[2])
    fill = rng.randint(0, 255, shape)
    if shape[0] and shape[1]:
        img[r0:r1, c0:c1] = torch.from_numpy(fill.astype(np.uint8)).to(
            img.device)
    mask[rows, cols] = 0
    return img, mask


def blur_image(img, sigma):
    """Gaussian blur with a sigma-sized kernel (ref augmentation.py:204-205;
    the caller draws the size)."""
    return cv_ops.gaussian_blur(img, sigma)


def color_jitter(img, brightness: float, contrast: float,
                 saturation: float, hue: float, rng) -> torch.Tensor:
    """The JAX package's ColorJitter equivalent (ref linemod_dataset.py:
    185-190): brightness, contrast and saturation factors from [1-x, 1+x]
    folded into one multiply-add in float32, truncated to uint8; then the
    hue shift in OpenCV's HSV, whose uint8 sum wraps at 256 before the
    modulo 180 as the JAX package's does (ROADMAP F9)."""
    fb = rng.uniform(max(0, 1 - brightness), 1 + brightness) \
        if brightness > 0 else 1.0
    fc = rng.uniform(max(0, 1 - contrast), 1 + contrast) \
        if contrast > 0 else 1.0
    fs = rng.uniform(max(0, 1 - saturation), 1 + saturation) \
        if saturation > 0 else 1.0
    f_hue = rng.uniform(-hue, hue) if hue > 0 else 0.0

    gray = cv_ops.rgb_to_gray(img)
    a = fb * fc * fs
    bcoef = fb * fc * (1.0 - fs)
    # numpy's mean of uint8: the exact sum over the count, in float64
    ccoef = fb * (1.0 - fc) * (int(gray.sum(dtype=torch.int64))
                               / gray.numel())
    # a Python float with a float32 array computes in float32
    out = (img.float() * float(np.float32(a))
           + gray.float()[..., None] * float(np.float32(bcoef))) \
        + float(np.float32(ccoef))
    out = out.clamp(0, 255).to(torch.uint8)

    if f_hue != 0.0:
        hsv = cv_ops.rgb_to_hsv(out)
        hshift = int(f_hue * 180.0) % 180
        h = ((hsv[..., 0].to(torch.int32) + hshift) & 255) % 180
        hsv = torch.cat([h.to(torch.uint8)[..., None], hsv[..., 1:]], -1)
        out = cv_ops.hsv_to_rgb(hsv)
    return out


def fused_rotate_crop_resize(img, mask, hcoords, imheight, imwidth,
                             rot_ang_min, rot_ang_max, overlap_ratio,
                             ratio_min, ratio_max, rng):
    """One-warp equivalent of rotate_instance + crop_or_padding_to_
    fixed_size_instance + resize (JAX's default path, use_old=true): one
    affine map sampled directly at the target size, the crop range from
    the rotated bbox corners (pvnet_tpu/data/augment.py:227-301)."""
    h, w = img.shape[0], img.shape[1]
    hs, ws = np.nonzero(mask)
    cx, cy = float(np.mean(ws)), float(np.mean(hs))

    degree = rng.uniform(rot_ang_min, rot_ang_max)
    R = cv_ops.get_rotation_matrix_2d((cx, cy), degree, 1)

    corners = np.array([[ws.min(), hs.min(), 1], [ws.min(), hs.max(), 1],
                        [ws.max(), hs.min(), 1], [ws.max(), hs.max(), 1]],
                       np.float64)
    rc = corners @ R.T
    wmin, wmax = rc[:, 0].min(), rc[:, 0].max()
    hmin, hmax = rc[:, 1].min(), rc[:, 1].max()
    box_h, box_w = hmax - hmin, wmax - wmin

    resize_ratio = rng.uniform(ratio_min, ratio_max)
    th = int(imheight * resize_ratio)
    tw = int(imwidth * resize_ratio)

    hpad, wpad = th >= h, tw >= w
    row_beg_hi = int(min(hmin + overlap_ratio * box_h, h - th))
    row_beg_lo = int(max(hmin + overlap_ratio * box_h - th, 0))
    col_beg_hi = int(min(wmin + overlap_ratio * box_w, w - tw))
    col_beg_lo = int(max(wmin + overlap_ratio * box_w - tw, 0))
    if hpad:
        hbeg = -((th - h) // 2)
    else:
        hbeg = rng.randint(row_beg_lo, max(row_beg_hi, row_beg_lo + 1))
    if wpad:
        wbeg = -((tw - w) // 2)
    else:
        wbeg = rng.randint(col_beg_lo, max(col_beg_hi, col_beg_lo + 1))

    # full map: resize(1/ratio) o translate(-beg) o rotate
    s = 1.0 / resize_ratio
    M = R.copy()
    M[0] = (R[0] - np.array([0, 0, wbeg])) * s
    M[1] = (R[1] - np.array([0, 0, hbeg])) * s

    img = cv_ops.warp_affine(img, M, (imwidth, imheight),
                             cv_ops.INTER_LINEAR)
    mask = _mask_op(cv_ops.warp_affine, mask, M, (imwidth, imheight),
                    cv_ops.INTER_NEAREST)
    last_row = np.asarray([[0, 0, 1]], np.float32)
    hcoords = np.matmul(hcoords,
                        np.concatenate([M, last_row], 0).transpose())
    return img, mask, hcoords


def add_noise(image, rng):
    """Gaussian noise (90%) or motion blur (10%) (ref augmentation.py:
    207-233); the noise is drawn on the host in float64."""
    if rng.rand() < 0.9:
        row, col, ch = image.shape
        var = rng.rand() * 0.3 * 256
        sigma = var ** 0.5
        gauss = torch.from_numpy(sigma * rng.randn(row, col)).to(
            image.device)
        noisy = (image.double() + gauss[:, :, None]).clamp(0, 255).to(
            torch.uint8)
    else:
        sizes = [3, 5, 7, 9, 11, 15]
        size = sizes[rng.randint(len(sizes))]
        kernel = np.zeros((size, size))
        if rng.rand() < 0.5:
            kernel[(size - 1) // 2, :] = 1.0
        else:
            kernel[:, (size - 1) // 2] = 1.0
        kernel /= size
        noisy = cv_ops.filter2d(image, kernel)
    return noisy
