"""PVNet's training augmentation in plain PyTorch, with the draws handed in
(the recipe's aug_cfg: rotation, crop and resize composed into one
affine, blur, colour jitter; PVNet lib/datasets/augmentation.py and
linemod_dataset.py).

Per image, from its draws (``deg``, ``ratio``, ``u_h``, ``u_w``, ``flip``,
``blur``, ``blur_size``, ``brightness``, ``contrast``, ``saturation``,
``hue``):

1. The mask's foreground centroid (cx, cy) and box; the rotation by
   ``deg`` about the centroid in OpenCV's getRotationMatrix2D convention.
2. A crop of floor(out * ratio) pixels per side, placed so that it keeps
   ``overlap_ratio`` of the rotated box: start floor(lo + u * (hi - lo))
   with lo = floor(max(edge + overlap * extent - size, 0)) and hi =
   max(floor(min(edge + overlap * extent, full - size)), lo + 1), or
   centred when the crop is larger than the frame; then a resize by
   1 / ratio. The three compose into one forward affine M.
3. The warp runs as two 1-D passes (the design of the program's
   augmentation, which is what the recipe on the device computes): the
   inverse map xs = a x + b y + c, ys = d x + e y + f is resampled first
   down each source column at ys' = (e - d b / a) y + (d / a) x1 +
   (f - d c / a), then along each row at xs = a x + b y + c. Each pass is
   linear between the two neighbouring samples, zero outside the source;
   the mask takes the nearer of the two samples and is rounded at the end.
   The keypoints move by M.
4. Horizontal flip where drawn (off in the recipe).
5. Where ``blur`` is drawn, a separable Gaussian of size 3, 5, 7 or 9
   (OpenCV's getGaussianKernel with sigma 0: its fixed tables up to 7,
   sigma = 0.3 ((k - 1) / 2 - 1) + 0.8 above), reflected borders without
   the edge pixel.
6. Colour jitter in sequence: brightness (scale by b), contrast (blend
   with the mean gray level by c), saturation (blend with each pixel's
   gray level by s), clipped to [0, 255]; then the hue turned by ``hue``
   in HSV.
7. ImageNet normalization.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
BLUR_SIZES = (3, 5, 7, 9)
_TABLES = {3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
           7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
               0.03125]}


def gaussian(k: int) -> torch.Tensor:
    if k in _TABLES:
        return torch.tensor(_TABLES[k], dtype=torch.float64)
    sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
    x = torch.arange(k, dtype=torch.float64) - k // 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return g / g.sum()


def forward_affine(mask: torch.Tensor, d: dict, out_h: int, out_w: int,
                   cfg: dict) -> torch.Tensor:
    """[b, 2, 3] source -> output affines (steps 1 and 2)."""
    b, h, w = mask.shape
    dev = mask.device
    fg = mask != 0
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    n = fg.sum((1, 2))
    has = n > 0
    nf = n.clamp(min=1).float()
    cx = torch.where(has, (fg * xs).sum((1, 2)) / nf, (w - 1) / 2.0)
    cy = torch.where(has, (fg * ys).sum((1, 2)) / nf, (h - 1) / 2.0)
    big = torch.tensor(1e9, device=dev)
    xmin = torch.where(has, torch.where(fg, xs, big).amin((1, 2)), 0.0)
    xmax = torch.where(has, torch.where(fg, xs, -big).amax((1, 2)), w - 1.0)
    ymin = torch.where(has, torch.where(fg, ys, big).amin((1, 2)), 0.0)
    ymax = torch.where(has, torch.where(fg, ys, -big).amax((1, 2)), h - 1.0)
    ang = d["deg"] * (math.pi / 180.0)
    ca, sa = torch.cos(ang), torch.sin(ang)
    rot = torch.stack([torch.stack([ca, sa, (1 - ca) * cx - sa * cy], -1),
                       torch.stack([-sa, ca, sa * cx + (1 - ca) * cy], -1)],
                      1)                                    # [b, 2, 3]
    corners = torch.stack([torch.stack([xmin, ymin], -1),
                           torch.stack([xmin, ymax], -1),
                           torch.stack([xmax, ymin], -1),
                           torch.stack([xmax, ymax], -1)], 1)  # [b, 4, 2]
    rc = corners @ rot[:, :, :2].transpose(1, 2) + rot[:, None, :, 2]
    x_lo, x_hi = rc[..., 0].amin(1), rc[..., 0].amax(1)
    y_lo, y_hi = rc[..., 1].amin(1), rc[..., 1].amax(1)
    th = torch.floor(out_h * d["ratio"])
    tw = torch.floor(out_w * d["ratio"])
    ov = cfg["overlap_ratio"]

    def start(u, edge, extent, size, full):
        keep = edge + ov * extent
        lo = torch.floor(torch.clamp(keep - size, min=0.0))
        hi = torch.maximum(torch.floor(torch.minimum(keep, full - size)),
                           lo + 1)
        return torch.where(size >= full, -torch.floor((size - full) / 2.0),
                           torch.floor(lo + u * (hi - lo)))

    hb = start(d["u_h"], y_lo, y_hi - y_lo, th, float(h))
    wb = start(d["u_w"], x_lo, x_hi - x_lo, tw, float(w))
    shift = torch.zeros_like(rot)
    shift[:, 0, 2], shift[:, 1, 2] = wb, hb
    return (rot - shift) / d["ratio"][:, None, None]


def _inverse(M: torch.Tensor) -> torch.Tensor:
    A = M[:, :, :2]
    Ai = torch.linalg.inv(A)
    return torch.cat([Ai, -(Ai @ M[:, :, 2:])], 2)


def _resample(X: torch.Tensor, pos: torch.Tensor, nearest_last: bool
              ) -> torch.Tensor:
    """X [b, ch, R, C] sampled along C at pos [b, R, n] -> [b, ch, R, n]:
    linear between neighbours, zero outside [0, C - 1]; with
    ``nearest_last`` the last channel takes the nearer neighbour."""
    b, ch, R, C = X.shape
    lo = torch.floor(pos)
    u = (pos - lo)[:, None]
    lo = lo.to(torch.int64)

    def tap(i):
        ok = ((i >= 0) & (i <= C - 1))[:, None]
        v = torch.gather(X, 3, i.clamp(0, C - 1)[:, None].expand(
            b, ch, R, i.shape[-1]))
        return v * ok

    v0, v1 = tap(lo), tap(lo + 1)
    out = (1 - u) * v0 + u * v1
    if nearest_last:
        out[:, -1] = torch.where(u[:, 0] >= 0.5, v1[:, -1], v0[:, -1])
    return out


def warp(image: torch.Tensor, mask: torch.Tensor, M: torch.Tensor,
         out_h: int, out_w: int):
    """Step 3: image [b, H, W, 3] (0..255), mask [b, H, W] -> (float32
    [b, 3, out_h, out_w], int mask [b, out_h, out_w])."""
    b, H, W = mask.shape
    dev = mask.device
    inv = _inverse(M)
    a, b_, c = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    d, e, f = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    # planes [b, 4, W, H]: each source column as a row
    planes = torch.cat([image.float().permute(0, 3, 2, 1),
                        mask.float().permute(0, 2, 1)[:, None]], 1)
    y = torch.arange(out_h, device=dev, dtype=torch.float32)
    x1 = torch.arange(W, device=dev, dtype=torch.float32)
    pos_v = ((e - d * b_ / a)[:, None, None] * y[None, None, :]
             + ((d / a)[:, None] * x1[None, :]
                + (f - d * c / a)[:, None])[..., None])     # [b, W, out_h]
    mid = _resample(planes, pos_v, True)                    # [b,4,W,out_h]
    mid = mid.transpose(2, 3)                               # [b,4,out_h,W]
    x = torch.arange(out_w, device=dev, dtype=torch.float32)
    pos_h = (a[:, None, None] * x[None, None, :]
             + (b_[:, None] * y[None, :] + c[:, None])[..., None])
    out = _resample(mid, pos_h, True)                       # [b,4,oh,ow]
    return out[:, :3], torch.round(out[:, 3]).to(torch.int32)


def blur(img: torch.Tensor, size_idx: torch.Tensor) -> torch.Tensor:
    """Step 5 on channel-major [b, 3, h, w], each image its own kernel."""
    outs = []
    for i in range(img.shape[0]):
        k = BLUR_SIZES[int(size_idx[i])]
        g = gaussian(k).to(img.device, torch.float32)
        x = F.pad(img[i:i + 1], (k // 2, k // 2, k // 2, k // 2),
                  mode="reflect")
        x = F.conv2d(x, g.view(1, 1, k, 1).expand(3, 1, k, 1), groups=3)
        x = F.conv2d(x, g.view(1, 1, 1, k).expand(3, 1, 1, k), groups=3)
        outs.append(x)
    return torch.cat(outs)


def _gray(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2]


def jitter(img: torch.Tensor, d: dict, hue_on: bool) -> torch.Tensor:
    """Step 6 on channel-major [b, 3, h, w] in 0..255."""
    def per(v):
        return v[:, None, None, None]

    x = img * per(d["brightness"])
    x = per(d["contrast"]) * x + (1 - per(d["contrast"])) * per(
        _gray(x).mean((1, 2)))
    x = per(d["saturation"]) * x + (1 - per(d["saturation"])) * _gray(
        x)[:, None]
    x = x.clamp(0.0, 255.0)
    if not hue_on:
        return x
    rgb = x / 255.0
    mx, _ = rgb.max(1)
    mn, _ = rgb.min(1)
    delta = mx - mn
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    dz = torch.where(delta > 0, delta, torch.ones_like(delta))
    hr = torch.remainder((g - b) / dz, 6.0)
    hg = (b - r) / dz + 2.0
    hb = (r - g) / dz + 4.0
    hh = torch.where(mx == r, hr, torch.where(mx == g, hg, hb)) / 6.0
    hh = torch.where(delta > 0, hh, torch.zeros_like(hh))
    s = torch.where(mx > 0, delta / torch.where(mx > 0, mx, 1.0), 0.0)
    hh = torch.remainder(hh + d["hue"][:, None, None], 1.0)
    # HSV -> RGB: channel n takes v - v s max(0, min(k, 4 - k, 1)),
    # k = (n + 6 h) mod 6 with n = 5, 3, 1
    def chan(n):
        k = torch.remainder(n + hh * 6.0, 6.0)
        return mx - mx * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], 1) * 255.0


def augment(image, mask, hcoords, d: dict, out_hw, cfg: dict):
    """Raw uint8 frames [b, H, W, 3], masks [b, H, W], keypoints [b, k, 3]
    -> (normalized float32 [b, 3, h, w], int mask [b, h, w], keypoints
    [b, k, 3])."""
    out_h, out_w = out_hw
    M = forward_affine(mask, d, out_h, out_w, cfg)
    img, m = warp(image, mask, M, out_h, out_w)
    T = torch.cat([M, torch.tensor([0.0, 0.0, 1.0], device=M.device).expand(
        M.shape[0], 1, 3)], 1)
    hc = hcoords.float() @ T.transpose(1, 2)
    if cfg.get("flip"):
        fl = d["flip"]
        img = torch.where(fl[:, None, None, None], img.flip(3), img)
        m = torch.where(fl[:, None, None], m.flip(2), m)
        hc = hc.clone()
        hc[..., 0] = torch.where(fl[:, None], out_w * hc[..., 2] - hc[..., 0],
                                 hc[..., 0])
    if cfg.get("blur"):
        img = torch.where(d["blur"][:, None, None, None],
                          blur(img, d["blur_size"]), img)
    if cfg.get("jitter"):
        img = jitter(img, d, cfg.get("hue", 0) > 0)
    mean = torch.tensor(MEAN, device=img.device)[:, None, None]
    std = torch.tensor(STD, device=img.device)[:, None, None]
    return (img / 255.0 - mean) / std, m, hc
