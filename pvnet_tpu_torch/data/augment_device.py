"""On-device training augmentation (channel-major, batched).

Port of pvnet_tpu/data/augment_device.py on the path the training step
runs (``augment_batch(..., out_layout='NCHW')`` with |rotation| < 75 deg):
per image, an instance-centred rotation + overlap-constrained crop +
resize composed into one affine warp, applied as a two-pass separable
resample; then horizontal flip (p=0.5), separable Gaussian blur (p=0.5,
kernel in {3, 5, 7, 9}), fused colour jitter with an HSV hue rotation, and
ImageNet normalization (ref lib/datasets/augmentation.py,
linemod_dataset.py:221-240).

Every random value comes from :class:`AugDraws`: :func:`sample_draws`
takes them from a ``torch.Generator``, and a caller may hand its own (the
tests hand the JAX package's draws, rebuilt from its key splits).

Where the recipe's rotation reaches 75 deg the separable factorization
degenerates (its pass V divides by cos(rotation)), and the warp is the
JAX module's one-pass gather instead: :func:`_warp_image` (float input:
four bilinear taps of the image, one nearest tap of the mask) or
:func:`_warp_image_u32` (uint8 input: rgb and mask packed in one 32-bit
word plane, four gathers serving both outputs). Both are plain
``torch.gather`` code, as the JAX module computes them with ``jnp.take``
outside any kernel.

Separable warp (see the design note in the JAX module): the dst->src map
xs = a x + b y + c, ys = d x + e y + f factors into a vertical resample of
each source column at ys' = (d/a) x1 + (e - d b/a) y + (f - d c/a), then a
horizontal resample of each intermediate row at xs = a x + (b y + c). Each
1-D resample splits its offset into floor + fraction: the floor is a
per-row circular shift (kernel K4, ops/row_shift.shift_lanes), the
fraction is a blend of two taps picked at a per-column base shared by all
rows. The JAX module picks the taps with 0/1 selection matmuls so that the
TPU's matrix unit does the gather; here they are picked with
``torch.gather`` (the same values, exactly: each output reads one element).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pvnet_tpu_torch.config import AugConfig, IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu_torch.ops import row_shift

_BLUR_SIZES = (3, 5, 7, 9)
_MAX_K = 9
_DEG2RAD = np.float32(np.pi / 180)


class AugDraws(NamedTuple):
    """Every per-image random value of :func:`augment_batch`, each [b]."""
    deg: torch.Tensor          # rotation, degrees
    ratio: torch.Tensor        # resize ratio
    u_h: torch.Tensor          # crop placement uniforms in [0, 1)
    u_w: torch.Tensor
    flip: torch.Tensor         # bool
    blur_size: torch.Tensor    # int64 index into (3, 5, 7, 9)
    blur: torch.Tensor         # bool
    brightness: torch.Tensor   # jitter factors
    contrast: torch.Tensor
    saturation: torch.Tensor
    hue: torch.Tensor          # hue shift in [-hue, hue]


def sample_draws(b: int, cfg: AugConfig, generator: torch.Generator,
                 device) -> AugDraws:
    """Draw :class:`AugDraws` for a batch of ``b`` from ``generator``
    (which must live on ``device``), with the JAX module's distributions."""
    def uniform(lo, hi):
        u = torch.rand((b,), generator=generator, device=device)
        return lo + u * (hi - lo)

    def factor(amount):
        if amount <= 0:
            return torch.ones((b,), device=device)
        return uniform(max(0.0, 1 - amount), 1 + amount)

    return AugDraws(
        deg=uniform(cfg.rot_ang_min, cfg.rot_ang_max),
        ratio=uniform(cfg.resize_ratio_min, cfg.resize_ratio_max),
        u_h=uniform(0.0, 1.0), u_w=uniform(0.0, 1.0),
        flip=uniform(0.0, 1.0) < 0.5,
        blur_size=torch.randint(0, len(_BLUR_SIZES), (b,),
                                generator=generator, device=device),
        blur=uniform(0.0, 1.0) < 0.5,
        brightness=factor(cfg.brightness), contrast=factor(cfg.contrast),
        saturation=factor(cfg.saturation),
        hue=(uniform(-cfg.hue, cfg.hue) if cfg.hue > 0
             else torch.zeros((b,), device=device)))


# ---------------------------------------------------------------------------
# Instance statistics and warp sampling
# ---------------------------------------------------------------------------

def _instance_stats(mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Foreground centroid + bbox of each [H, W] mask of [b, H, W], with the
    image centre / full frame for an empty mask. Each result is [b]."""
    _, h, w = mask.shape
    fg = mask != 0
    dev = mask.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    cnt = fg.sum((1, 2))
    has = cnt > 0
    safe = torch.clamp(cnt, min=1).to(torch.float32)
    fgf = fg.to(torch.float32)
    cx = torch.where(has, (fgf * xs).sum((1, 2)) / safe, (w - 1) / 2.0)
    cy = torch.where(has, (fgf * ys).sum((1, 2)) / safe, (h - 1) / 2.0)

    def extreme(coord, reduce, fill, default):
        vals = torch.where(fg, coord, fill).flatten(1)
        return torch.where(has, reduce(vals, dim=1).values, default)

    xmin = extreme(xs, torch.min, 1e9, 0.0)
    xmax = extreme(xs, torch.max, -1e9, w - 1.0)
    ymin = extreme(ys, torch.min, 1e9, 0.0)
    ymax = extreme(ys, torch.max, -1e9, h - 1.0)
    return cx, cy, xmin, xmax, ymin, ymax


def _sample_warp(mask: torch.Tensor, draws: AugDraws, out_h: int,
                 out_w: int, cfg: AugConfig) -> torch.Tensor:
    """The composed rotate+crop+resize forward affines [b, 2, 3]
    (src -> dst) of masks [b, H, W], from the draws' deg, ratio, u_h and
    u_w (the host fused_rotate_crop_resize math)."""
    b, h, w = mask.shape
    dev = mask.device
    cx, cy, xmin, xmax, ymin, ymax = _instance_stats(mask)
    ang = draws.deg * float(_DEG2RAD)
    a, s_ = torch.cos(ang), torch.sin(ang)
    # cv2.getRotationMatrix2D convention (y-down image frame)
    R = torch.stack([
        torch.stack([a, s_, (1 - a) * cx - s_ * cy], -1),
        torch.stack([-s_, a, s_ * cx + (1 - a) * cy], -1),
    ], 1)                                                   # [b, 2, 3]
    one = torch.ones_like(xmin)
    corners = torch.stack([
        torch.stack([xmin, ymin, one], -1),
        torch.stack([xmin, ymax, one], -1),
        torch.stack([xmax, ymin, one], -1),
        torch.stack([xmax, ymax, one], -1),
    ], 1)                                                   # [b, 4, 3]
    rc = corners @ R.transpose(1, 2)                        # [b, 4, 2]
    wmin_r, wmax_r = rc[..., 0].min(1).values, rc[..., 0].max(1).values
    hmin_r, hmax_r = rc[..., 1].min(1).values, rc[..., 1].max(1).values
    fh, fw = hmax_r - hmin_r, wmax_r - wmin_r

    ratio = draws.ratio
    th = torch.floor(out_h * ratio)
    tw = torch.floor(out_w * ratio)

    def beg(u, lo_edge, extent, tsize, full):
        pad = tsize >= full
        rmax = torch.floor(torch.minimum(lo_edge + cfg.overlap_ratio * extent,
                                         full - tsize))
        rmin = torch.floor(torch.clamp(lo_edge + cfg.overlap_ratio * extent
                                       - tsize, min=0.0))
        hi = torch.maximum(rmax, rmin + 1)
        rand = torch.floor(rmin + u * (hi - rmin))
        return torch.where(pad, -torch.floor((tsize - full) / 2.0), rand)

    hbeg = beg(draws.u_h, hmin_r, fh, th, float(h))
    wbeg = beg(draws.u_w, wmin_r, fw, tw, float(w))

    s = 1.0 / ratio
    e3 = _constants(dev)["e3"]
    return torch.stack([
        (R[:, 0] - e3 * wbeg[:, None]) * s[:, None],
        (R[:, 1] - e3 * hbeg[:, None]) * s[:, None],
    ], 1)


def _invert_affine(M: torch.Tensor) -> torch.Tensor:
    """Invert affines [b, 2, 3] (dst -> src sampling maps)."""
    A = M[:, :, :2]
    t = M[:, :, 2]
    det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    Ainv = torch.stack([
        torch.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
        torch.stack([-A[:, 1, 0], A[:, 0, 0]], -1),
    ], 1) / det[:, None, None]
    tinv = (-Ainv @ t[..., None])[..., 0]
    return torch.cat([Ainv, tinv[..., None]], 2)


# ---------------------------------------------------------------------------
# One-pass gather warps (|rotation| >= 75 deg)
# ---------------------------------------------------------------------------

def _sample_grid(Ms: torch.Tensor, out_h: int, out_w: int):
    """The source position of every output pixel of forward affines
    Ms [b, 2, 3]: (x0, y0) int64 floors and (wx, wy) fractions, each
    [b, out_h, out_w], computed as the JAX module's warps do (float32,
    the same order)."""
    dev = Ms.device
    Minv = _invert_affine(Ms)
    xo = torch.arange(out_w, dtype=torch.float32, device=dev)[None, None, :]
    yo = torch.arange(out_h, dtype=torch.float32, device=dev)[None, :, None]
    m = [[Minv[:, i, j][:, None, None] for j in range(3)] for i in range(2)]
    xs = m[0][0] * xo + m[0][1] * yo + m[0][2]
    ys = m[1][0] * xo + m[1][1] * yo + m[1][2]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    return (x0.to(torch.int64), y0.to(torch.int64), xs - x0, ys - y0,
            xs, ys)


def _tap_index(xi: torch.Tensor, yi: torch.Tensor, h: int, w: int):
    """(flat index into an [h*w] plane, inside mask) of integer taps, the
    index clamped into the image as the JAX module clamps it."""
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    return idx.flatten(1), inside


def _warp_image(img: torch.Tensor, mask: torch.Tensor, Ms: torch.Tensor,
                out_h: int, out_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear (image) / nearest (mask) affine warp with zero border
    (cv2.warpAffine BORDER_CONSTANT semantics), the JAX module's
    ``_warp_image`` per image of a batch.

    img [b, H, W, 3] float32, mask [b, H, W] integer, Ms [b, 2, 3] forward
    affines. Returns (image float32 [b, out_h, out_w, 3], mask
    [b, out_h, out_w] of the mask's dtype)."""
    b, h, w = mask.shape
    x0, y0, wx, wy, xs, ys = _sample_grid(Ms, out_h, out_w)
    flat_img = img.reshape(b, h * w, -1)
    c = flat_img.shape[-1]

    def fetch(xi, yi):
        idx, inside = _tap_index(xi, yi, h, w)
        vals = torch.gather(flat_img, 1, idx[..., None].expand(-1, -1, c))
        return vals.reshape(b, out_h, out_w, c) * inside[..., None]

    v00 = fetch(x0, y0)
    v01 = fetch(x0 + 1, y0)
    v10 = fetch(x0, y0 + 1)
    v11 = fetch(x0 + 1, y0 + 1)
    wx, wy = wx[..., None], wy[..., None]
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))

    xn = torch.floor(xs + 0.5).to(torch.int64)
    yn = torch.floor(ys + 0.5).to(torch.int64)
    idx, inside = _tap_index(xn, yn, h, w)
    out_mask = torch.gather(mask.reshape(b, h * w), 1, idx)
    out_mask = out_mask.reshape(b, out_h, out_w) * inside
    return out, out_mask


def _warp_image_u32(img: torch.Tensor, mask: torch.Tensor, Ms: torch.Tensor,
                    out_h: int, out_w: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed-word form of :func:`_warp_image` for uint8 input (the
    JAX module's ``_warp_image_u32``): r | g << 8 | b << 16 | m << 24 in
    one [b, H*W] word plane (int64 here: PyTorch has no uint32 gather),
    four gathers for the bilinear corners, and the mask's nearest tap is
    the corner that rounding each fraction picks.

    img [b, H, W, 3] uint8, mask [b, H, W] (values 0..255). Returns (image
    float32 [b, out_h, out_w, 3], mask int32 [b, out_h, out_w])."""
    b, h, w = mask.shape
    i = img.to(torch.int64)
    word = (i[..., 0] | (i[..., 1] << 8) | (i[..., 2] << 16)
            | (mask.to(torch.int64) << 24)).reshape(b, h * w)
    x0, y0, wx, wy, _, _ = _sample_grid(Ms, out_h, out_w)

    def tap(xi, yi):
        idx, inside = _tap_index(xi, yi, h, w)
        return torch.gather(word, 1, idx).reshape(b, out_h, out_w), inside

    w00, in00 = tap(x0, y0)
    w01, in01 = tap(x0 + 1, y0)
    w10, in10 = tap(x0, y0 + 1)
    w11, in11 = tap(x0 + 1, y0 + 1)

    def chan(shift):
        c00 = ((w00 >> shift) & 0xFF).to(torch.float32) * in00
        c01 = ((w01 >> shift) & 0xFF).to(torch.float32) * in01
        c10 = ((w10 >> shift) & 0xFF).to(torch.float32) * in10
        c11 = ((w11 >> shift) & 0xFF).to(torch.float32) * in11
        return ((1 - wy) * ((1 - wx) * c00 + wx * c01)
                + wy * ((1 - wx) * c10 + wx * c11))

    out = torch.stack([chan(0), chan(8), chan(16)], -1)

    # nearest tap = the bilinear corner selected by rounding each frac
    right = wx >= 0.5
    down = wy >= 0.5
    wn = torch.where(down, torch.where(right, w11, w10),
                     torch.where(right, w01, w00))
    inn = torch.where(down, torch.where(right, in11, in10),
                      torch.where(right, in01, in00))
    out_mask = ((wn >> 24) & 0xFF).to(torch.int32) * inn
    return out, out_mask


# ---------------------------------------------------------------------------
# Separable (two-pass) affine warp
# ---------------------------------------------------------------------------

def _sep_pass_cm(X: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
                 c_out: int) -> torch.Tensor:
    """One 1-D resample of channel-major X [b, ch, R, C] along its minor
    C axis: out[b, ch, r, x] = lerp(X[b, ch, r, :] at position
    scale[b]*x + offset[b, r]), zero outside [0, C-1]. Channel 3 (if
    present) takes the nearest tap (mask semantics); others blend.

    X must be float32. Returns [b, ch, R, c_out] float32."""
    b, ch, R, C = X.shape
    dev = X.device

    i_r = torch.floor(offset)                               # [b, R]
    g_r = offset - i_r                                      # frac in [0,1)

    # per-row circular shift by floor(offset), the same for every channel
    starts = (i_r.to(torch.int32)[:, None, :].expand(b, ch, R)
              .reshape(b * ch, R))
    Xs = row_shift.shift_lanes(X.reshape(b * ch, R, C), starts)
    Xs = Xs.reshape(b, ch, R, C)

    x = torch.arange(c_out, dtype=torch.float32, device=dev)
    sx = scale[:, None] * x[None, :]                        # [b, c_out]
    base = torch.floor(sx)
    r_x = sx - base                                         # frac(s*x)
    base_i = base.to(torch.int64)

    # true sample position p = s*x + g_r + i_r; validity from p directly
    p = sx[:, None, :] + g_r[..., None] + i_r[..., None]    # [b, R, c_out]
    u_all = r_x[:, None, :] + g_r[..., None]                # [b, R, c_out]
    carry = u_all >= 1.0
    u = u_all - carry.to(torch.float32)                     # frac(p)
    lo = torch.floor(p)
    v_lo = ((lo >= 0) & (lo <= C - 1))[:, None]             # [b,1,R,c_out]
    v_hi = ((lo + 1 >= 0) & (lo + 1 <= C - 1))[:, None]

    # the low and high taps of the shifted row: columns base(x) + carry
    # and base(x) + carry + 1 (mod C: wrapped taps land on invalid,
    # zeroed outputs only), one index for every channel
    tap = base_i[:, None, :] + carry.to(torch.int64)        # [b, R, c_out]
    shape = (b, ch, R, c_out)
    A = torch.gather(Xs, 3, torch.remainder(tap, C)[:, None].expand(shape))
    Bt = torch.gather(Xs, 3,
                      torch.remainder(tap + 1, C)[:, None].expand(shape))
    A = A * v_lo
    Bt = Bt * v_hi
    u_c = u[:, None]
    out = (1.0 - u_c) * A + u_c * Bt                        # [b,ch,R,c_out]

    if ch == 4:                                             # nearest mask
        # nearest tap = raw tap value selected by round(frac); A/Bt are
        # already validity-zeroed, so out-of-range rounds to 0 (border)
        mask_out = torch.where(u >= 0.5, Bt[:, 3], A[:, 3])
        out = torch.cat([out[:, :3], mask_out[:, None]], 1)
    return out


def _warp_batch_sep(img: torch.Tensor, mask: torch.Tensor, Ms: torch.Tensor,
                    out_h: int, out_w: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched two-pass affine warp (see the module note).

    img [b, H, W, 3] (uint8 or float), mask [b, H, W], Ms [b, 2, 3]
    forward affines. Returns (img f32 channel-major [b, 3, out_h, out_w],
    mask int32 [b, out_h, out_w])."""
    _, H, W = mask.shape
    dev = mask.device
    A = _invert_affine(Ms)                                  # [b, 2, 3]
    a, b_, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    p = d / a
    q = e - d * b_ / a
    r = f - d * c / a

    # channel-major planes with H minor for pass V: [b, 4, W, H]
    planes = torch.cat(
        [img.permute(0, 3, 2, 1).to(torch.float32),
         mask.permute(0, 2, 1).to(torch.float32)[:, None]],
        1).contiguous()

    # pass V: resample along y at ys' = q*y + (p*x1 + r), per source column
    x1 = torch.arange(W, dtype=torch.float32, device=dev)
    oV = p[:, None] * x1[None, :] + r[:, None]              # [b, W]
    I1 = _sep_pass_cm(planes, q, oV, out_h)                 # [b, 4, W, out_h]

    # pass H: resample along x at xs = a*x + (b_*y + c), per output row
    I1t = I1.transpose(2, 3).contiguous()                   # [b,4,out_h,W]
    y = torch.arange(out_h, dtype=torch.float32, device=dev)
    oH = b_[:, None] * y[None, :] + c[:, None]              # [b, out_h]
    O = _sep_pass_cm(I1t, a, oH, out_w)                     # [b,4,out_h,out_w]

    return O[:, :3], torch.round(O[:, 3]).to(torch.int32)


# ---------------------------------------------------------------------------
# Photometric
# ---------------------------------------------------------------------------

def _gauss_weights_bank() -> torch.Tensor:
    """[4, 9] zero-padded 1D Gaussian kernels for sizes 3/5/7/9, matching
    cv2.GaussianBlur(sigma=0): OpenCV uses fixed small-kernel tables for
    ksize <= 7 and the sigma = 0.3*((k-1)*0.5 - 1) + 0.8 formula above."""
    fixed = {
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
            0.03125],
    }
    bank = np.zeros((len(_BLUR_SIZES), _MAX_K), np.float32)
    for i, k in enumerate(_BLUR_SIZES):
        if k in fixed:
            g = np.asarray(fixed[k], np.float64)
        else:
            sigma = 0.3 * ((k - 1) * 0.5 - 1) + 0.8
            half = k // 2
            x = np.arange(-half, half + 1, dtype=np.float64)
            g = np.exp(-(x * x) / (2 * sigma * sigma))
            g /= g.sum()
        off = (_MAX_K - k) // 2
        bank[i, off:off + k] = g
    return torch.from_numpy(bank)


_CONSTANTS = {}


def _constants(dev: torch.device) -> dict:
    """The augmentation's constant tensors on ``dev``, copied there once:
    a copy from the host waits for the device's queue, so a step must not
    make one."""
    if dev not in _CONSTANTS:
        _CONSTANTS[dev] = {
            "e3": torch.tensor([0.0, 0.0, 1.0], device=dev),
            "blur": _gauss_weights_bank().to(dev),
            "mean": torch.as_tensor(IMAGENET_MEAN, device=dev)[:, None, None],
            "std": torch.as_tensor(IMAGENET_STD, device=dev)[:, None, None]}
    return _CONSTANTS[dev]


def _separable_blur(img: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
    """Apply a per-image separable kernel to channel-major img
    [b, 3, h, w] via shifted weighted sums; wts [b, 9]. Reflect-101 border
    like OpenCV."""
    half = _MAX_K // 2

    def pass_axis(x, axis):
        pad = (0, 0, half, half) if axis == 2 else (half, half, 0, 0)
        xp = F.pad(x, pad, mode="reflect")
        acc = torch.zeros_like(x)
        for i in range(_MAX_K):
            acc = acc + (wts[:, i, None, None, None]
                         * xp.narrow(axis, i, x.shape[axis]))
        return acc

    return pass_axis(pass_axis(img, 2), 3)


def _rgb_to_hsv(rgb: torch.Tensor):
    """Channel-major [b, 3, h, w] in [0, 1] -> (h, s, v), each [b, h, w]."""
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    # branch on direct channel comparisons, not on mx == r (the JAX
    # module's note: a recomputed max may equal no channel under fusion)
    is_r = (r >= g) & (r >= b)
    is_g = (~is_r) & (g >= b)
    h = torch.where(is_r, torch.remainder((g - b) / safe_d, 6.0),
                    torch.where(is_g, (b - r) / safe_d + 2.0,
                                (r - g) / safe_d + 4.0)) / 6.0
    h = torch.where(d == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return h, s, mx


def _hsv_to_rgb(h: torch.Tensor, s: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """(h, s, v) each [b, h, w] -> channel-major [b, 3, h, w]."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    sector = (i.to(torch.int32) % 6).to(torch.int64)[None]   # [1, b, h, w]

    def pick(*vals):
        return torch.gather(torch.stack(vals), 0, sector)[0]

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], 1)


def _color_jitter(img: torch.Tensor, draws: AugDraws,
                  cfg: AugConfig) -> torch.Tensor:
    """Fused brightness/contrast/saturation FMA + HSV hue rotation on
    channel-major img [b, 3, h, w] in 0..255."""
    fb, fc, fs = draws.brightness, draws.contrast, draws.saturation
    r, g, bl = img[:, 0], img[:, 1], img[:, 2]
    gray = 0.299 * r + 0.587 * g + 0.114 * bl               # [b, h, w]
    gmean = gray.mean((1, 2))
    a = (fb * fc * fs)[:, None, None, None]
    bco = (fb * fc * (1 - fs))[:, None, None, None]
    cco = (fb * (1 - fc) * gmean)[:, None, None, None]
    out = a * img + bco * gray[:, None] + cco
    out = torch.clamp(out, 0.0, 255.0)

    if cfg.hue > 0:
        h, s, v = _rgb_to_hsv(out / 255.0)
        h = torch.remainder(h + draws.hue[:, None, None], 1.0)
        out = _hsv_to_rgb(h, s, v) * 255.0
    return out


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def augment_batch(image: torch.Tensor, mask: torch.Tensor,
                  hcoords: torch.Tensor, out_hw: Tuple[int, int],
                  cfg: AugConfig, draws: Optional[AugDraws] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched augmentation on the input's device.

    Args:
      image:   [b, H, W, 3] uint8 or float (raw 0..255 pixels).
      mask:    [b, H, W] integer.
      hcoords: [b, k, 3] homogeneous keypoint targets.
      out_hw:  output (height, width).
      cfg:     the recipe's aug_cfg.
      draws:   the per-image random values; drawn from ``generator`` with
        :func:`sample_draws` when None.

    Returns:
      (image float32 [b, 3, out_h, out_w] channel-major and ImageNet-
       normalized, mask int32
       [b, out_h, out_w], hcoords [b, k, 3]).
    """
    b = image.shape[0]
    out_h, out_w = out_hw
    dev = image.device
    if draws is None:
        draws = sample_draws(b, cfg, generator, dev)

    # --- geometric: one composed affine per image --------------------------
    if cfg.rotation or cfg.crop:
        rot_max = max(abs(cfg.rot_ang_min), abs(cfg.rot_ang_max))
        Ms = _sample_warp(mask, draws, out_h, out_w, cfg)    # [b, 2, 3]
        if rot_max < 75.0:
            image, mask = _warp_batch_sep(image, mask, Ms, out_h, out_w)
        else:
            # the gather warps for rotation ranges where the separable
            # factorization's cos(rotation) nears 0 (JAX :598-604)
            if image.dtype == torch.uint8:
                image, mask = _warp_image_u32(image, mask, Ms, out_h, out_w)
            else:
                image, mask = _warp_image(image.to(torch.float32), mask, Ms,
                                          out_h, out_w)
            image = image.permute(0, 3, 1, 2)
        last = _constants(dev)["e3"].expand(b, 1, 3)
        T = torch.cat([Ms, last], 1)                         # [b, 3, 3]
        hcoords = torch.einsum("bkj,bij->bki", hcoords, T)
    else:
        image = (image[:, :out_h, :out_w].to(torch.float32)
                 .permute(0, 3, 1, 2))
        mask = mask[:, :out_h, :out_w]

    # --- horizontal flip, p=0.5 per image ----------------------------------
    if cfg.flip:
        do = draws.flip
        image = torch.where(do[:, None, None, None], image.flip(3), image)
        mask = torch.where(do[:, None, None], mask.flip(2), mask)
        hx = hcoords[..., 0]
        hx_f = out_w * hcoords[..., 2] - hx
        hcoords = torch.cat([torch.where(do[:, None], hx_f, hx)[..., None],
                             hcoords[..., 1:]], -1)

    # --- blur, p=0.5, kernel size uniform over {3,5,7,9} -------------------
    if cfg.blur:
        wts = _constants(dev)["blur"][draws.blur_size]       # [b, 9]
        blurred = _separable_blur(image, wts)
        image = torch.where(draws.blur[:, None, None, None], blurred, image)

    # --- color jitter -------------------------------------------------------
    if cfg.jitter:
        image = _color_jitter(image, draws, cfg)

    consts = _constants(dev)
    image = (image / 255.0 - consts["mean"]) / consts["std"]
    return image, mask.to(torch.int32), hcoords
