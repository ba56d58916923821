"""Packed inference tail: the decoder's last stages on a half-resolution,
channel-packed lattice.

PyTorch port of the default path (float convolutions, dense upsample
matmuls) of pvnet_tpu/ops/packed_tail.py. A decoder stage is a 2x bilinear
align-corners upsample, a 3x3 SAME convolution over concat([upsampled
features, backbone skip or rgb]), BatchNorm and LeakyReLU; the raw stage
adds the 1x1 head. Here each stage is rewritten exactly (the same
products, summed in another order) on a space-to-depth lattice whose cell
(I, J) holds the 2x2 full-resolution pixels (2I+p, 2J+q) in channel
(p*2+q)*c + ch:

1. **Shifted phase upsample** (:func:`phase_upsample_packed`): slicing
   the rows of the two interpolation matrices by output parity yields the
   upsampled features directly packed, on a lattice shifted by -1 pixel
   ([b, 4c, h/2+1, w/2+1], cell (K, L) phase (a, b) = pixel
   (2K-1+a, 2L-1+b)), so that step 2 is a VALID 2x2 convolution.
2. **Packed convolution**: the full-resolution 3x3 convolution of the
   features is a 2x2 convolution between the shifted lattice and the
   output lattice with weights scattered into [4cout, 4cin, 2, 2]
   (:func:`_pack_conv_weights`); the skip (or rgb) term is a stride-2 4x4
   convolution straight from the unpacked skip (:func:`_fold_conv_direct`).
3. **BatchNorm, LeakyReLU** as a phase-tiled affine and, in the raw stage,
   the 1x1 head as a block-diagonal matmul.

A packed stage's output feeds the next stage's upsample as is
(:func:`phase_upsample_from_packed`), and the raw stage emits the packed
head field [b, h/2, w/2, 4*(seg_dim+ver_dim)] and each cell's foreground
count, which voting.sample_foreground_packed selects from through kernel
K2. The full-resolution seg/ver tensors never exist.

Layouts: functions take and return channel-major (NCHW) tensors, as the
port's model does; the stage tensors are kept in ``torch.channels_last``
memory, whose NHWC view is the JAX package's layout, so the head matmul
reads them without a copy and emits the NHWC field contiguous. The
upsample is two plain 2-D matrix products over a [h, b, c, w] arrangement
of its input (built by one copy of the small pre-upsample tensor) and one
copy into the packed order. Folded weights are OIHW; the JAX package's
are HWIO.

``quant=True`` is the JAX package's int8 branch (ops/quant_conv.py,
per-image dynamic activation scales only, as there): a packed stage runs
both its convolutions in int8, the raw stage its feature term (the rgb
term stays float, accumulated in float32); the stage then computes in
float32 and emits ``dtype``.

Not ported: the opt-in blocked banded upsample (``PVNET_BLOCKED_UPSAMPLE``)
and the packed-stem image refold (``_fold_direct_to_packed3``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pvnet_tpu_torch.ops.quant_conv import conv2d_int8

# ---------------------------------------------------------------------------
# Constant matrices (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _align_corners_matrix(out_size: int, in_size: int) -> np.ndarray:
    """[out, in] bilinear interpolation matrix with align_corners=True
    (copy of pvnet_tpu/models/pvnet.py: _align_corners_matrix)."""
    A = np.zeros((out_size, in_size), np.float32)
    if out_size == 1 or in_size == 1:
        A[:, 0] = 1.0
        return A
    pos = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    lo = np.floor(pos).astype(np.int64)
    lo = np.minimum(lo, in_size - 2)
    w = (pos - lo).astype(np.float32)
    A[np.arange(out_size), lo] = 1.0 - w
    A[np.arange(out_size), lo + 1] += w
    return A


def _shifted_phase_matrices(out_size: int, in_size: int) -> np.ndarray:
    """[2, out_size//2 + 1, in_size]: row r of matrix a is row (2r - 1 + a)
    of the align-corners interpolation matrix (zero rows out of range)."""
    A = _align_corners_matrix(out_size, in_size)            # [out, in]
    n = out_size // 2 + 1
    out = np.zeros((2, n, in_size), np.float32)
    for a in range(2):
        for r in range(n):
            src = 2 * r - 1 + a
            if 0 <= src < out_size:
                out[a, r] = A[src]
    return out


def _pack_scatter_tensor() -> np.ndarray:
    """Constant [3, 3, 2, 2, 4, 4] scatter: T[dy, dx, ky, kx, ab, pq] = 1
    iff full-res tap (dy, dx) of output phase pq = (p*2+q) lands on lattice
    offset (ky, kx) input phase ab = (a*2+b):  2ky + a = p + dy,
    2kx + b = q + dx."""
    T = np.zeros((3, 3, 2, 2, 4, 4), np.float32)
    for p in range(2):
        for q in range(2):
            for dy in range(3):
                for dx in range(3):
                    ky, a = divmod(p + dy, 2)
                    kx, b = divmod(q + dx, 2)
                    T[dy, dx, ky, kx, a * 2 + b, p * 2 + q] = 1.0
    return T


def _direct_scatter_tensor() -> np.ndarray:
    """Constant [3, 3, 4, 4, 4] scatter: T[dy, dx, ry, rx, pq] = 1 iff
    full-res tap (dy, dx) of output phase pq = (p*2+q) reads input pixel
    row/col offset (ry, rx) = (p + dy, q + dx) of the 4x4 stride-2 window
    anchored at (2I - 1, 2J - 1)."""
    T = np.zeros((3, 3, 4, 4, 4), np.float32)
    for p in range(2):
        for q in range(2):
            for dy in range(3):
                for dx in range(3):
                    T[dy, dx, p + dy, q + dx, p * 2 + q] = 1.0
    return T


@functools.lru_cache(maxsize=None)
def _constant(make, args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)``, a numpy constant, as a tensor on ``device``; built
    and copied to the device once (a copy from pageable host memory per
    request would make the host wait for the device's queue). The tensor
    is shared by every caller: read it, never write it."""
    return torch.as_tensor(make(*args), device=device)


# ---------------------------------------------------------------------------
# Weight folding
# ---------------------------------------------------------------------------

def _pack_conv_weights(w: torch.Tensor) -> torch.Tensor:
    """[cout, cin, 3, 3] full-res conv -> [4cout, 4cin, 2, 2] lattice conv
    (OIHW, channels_last).

    Output cell (I, J) phase (p, q) is full-res pixel (2I+p, 2J+q); its tap
    (dy, dx) reads full-res (2I+p+dy-1, 2J+q+dx-1), which lives on the
    shifted input lattice at cell (I+ky, J+kx) phase (a, b) with
    2ky + a = p + dy, 2kx + b = q + dx. The einsum is the JAX package's,
    on the HWIO view of the weights."""
    cout, cin = w.shape[:2]
    T = _constant(_pack_scatter_tensor, (), w.device)
    wp = torch.einsum("yxio,yxkluv->kluivo",
                      w.float().permute(2, 3, 1, 0), T)
    wp = wp.reshape(2, 2, 4 * cin, 4 * cout).permute(3, 2, 0, 1)
    return wp.contiguous(memory_format=torch.channels_last)


def _fold_conv_direct(w: torch.Tensor) -> torch.Tensor:
    """[cout, cin, 3, 3] full-res conv -> [4cout, cin, 4, 4] stride-2 conv
    over the UNPACKED input, padded by 1 (OIHW, channels_last): the
    packed-lattice term conv2x2(pack(x), packed w) equals
    conv4x4_stride2(pad(x, 1), direct w), so the packed operand is never
    built."""
    cout, cin = w.shape[:2]
    T = _constant(_direct_scatter_tensor, (), w.device)
    wd = torch.einsum("yxio,yxrsv->rsivo", w.float().permute(2, 3, 1, 0), T)
    wd = wd.reshape(4, 4, cin, 4 * cout).permute(3, 2, 0, 1)
    return wd.contiguous(memory_format=torch.channels_last)


def _bn_fold(scale, bias, mean, var, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as y * s + t, phase-tiled to [4cout]."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    t = bias.float() - mean.float() * s
    return s.repeat(4), t.repeat(4)


class PackedStageParams(NamedTuple):
    """Folded inference parameters of one packed decoder stage."""
    ah: torch.Tensor      # [2, h/2+1, h/2] shifted-phase h-interp matrices
    aw: torch.Tensor      # [2, w/2+1, w/2] shifted-phase w-interp matrices
    w_fm: torch.Tensor    # [4cout, 4c_fm, 2, 2] packed conv (decoder fm)
    w_skip: torch.Tensor  # [4cout, c_skip, 4, 4] direct stride-2 conv
    scale4: torch.Tensor  # [4cout] phase-tiled BN scale
    bias4: torch.Tensor   # [4cout] phase-tiled BN bias


class PackedTailParams(NamedTuple):
    """Folded inference parameters of the packed raw stage and head."""
    ah: torch.Tensor       # [2, H/2+1, h2] shifted-phase h-interp matrices
    aw: torch.Tensor       # [2, W/2+1, w2] shifted-phase w-interp matrices
    w_fm: torch.Tensor     # [4cout, 4cin_fm, 2, 2] packed conv (features)
    w_im: torch.Tensor     # [4cout, 3, 4, 4] direct stride-2 conv (rgb)
    scale4: torch.Tensor   # [4cout] phase-tiled BN scale
    bias4: torch.Tensor    # [4cout] phase-tiled BN bias
    w_head4: torch.Tensor  # [4cout, 4hout] block-diagonal head
    b_head4: torch.Tensor  # [4hout]


def fold_packed_stage(w, bn_scale, bn_bias, bn_mean, bn_var, c_fm: int,
                      h: int, w_: int, eps: float = 1e-5
                      ) -> PackedStageParams:
    """Fold one decoder stage (ref model_repository.py:38-51; the 4s stage
    conv4s and the 2s stage conv2s) into packed-lattice parameters.

    w: [cout, c_fm + c_skip, 3, 3] with the model's concat order (decoder
    features first, then the skip). (h, w_): THIS stage's output
    resolution, 2x the incoming features'."""
    dev = w.device
    scale4, bias4 = _bn_fold(bn_scale, bn_bias, bn_mean, bn_var, eps)
    return PackedStageParams(
        ah=_constant(_shifted_phase_matrices, (h, h // 2), dev),
        aw=_constant(_shifted_phase_matrices, (w_, w_ // 2), dev),
        w_fm=_pack_conv_weights(w[:, :c_fm]),
        w_skip=_fold_conv_direct(w[:, c_fm:]),
        scale4=scale4, bias4=bias4)


def fold_packed_tail(w_raw, bn_scale, bn_bias, bn_mean, bn_var, w_head,
                     b_head, h: int, w: int, h2: int, w2: int,
                     eps: float = 1e-5) -> PackedTailParams:
    """Fold the raw stage and the head (ref model_repository.py:53-58,
    :76-79) into packed-tail parameters.

    w_raw: [cout, cin_fm + 3, 3, 3] (decoder features, then rgb); w_head
    [hout, cout, 1, 1] and its bias (or None); (h, w) the full resolution,
    (h2, w2) the 2s stage's."""
    dev = w_raw.device
    cin_fm = w_raw.shape[1] - 3
    scale4, bias4 = _bn_fold(bn_scale, bn_bias, bn_mean, bn_var, eps)
    wh = w_head.float()[:, :, 0, 0].t().contiguous()        # [cout, hout]
    bh = (torch.zeros(wh.shape[1], device=dev) if b_head is None
          else b_head.float())
    return PackedTailParams(
        ah=_constant(_shifted_phase_matrices, (h, h2), dev),
        aw=_constant(_shifted_phase_matrices, (w, w2), dev),
        w_fm=_pack_conv_weights(w_raw[:, :cin_fm]),
        w_im=_fold_conv_direct(w_raw[:, cin_fm:]),
        scale4=scale4, bias4=bias4,
        w_head4=torch.kron(torch.eye(4, device=dev), wh),
        b_head4=bh.repeat(4))


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def _phase_upsample_rows(x: torch.Tensor, ah: torch.Tensor,
                         aw: torch.Tensor, dtype) -> torch.Tensor:
    """x [h, b, c, w] -> the shifted-lattice packed upsample [b, 4c, n, m]
    (channels_last, channel (a*2+B)*c + ch): the W pass
    [(h,b,c), w] @ [w, (B,p)], then the H pass [(a,o), h] @ [h, (b,c,B,p)],
    then one copy into the packed order."""
    h, b, c, w = x.shape
    n, m = ah.shape[1], aw.shape[1]
    t = x.to(dtype).reshape(h * b * c, w) @ aw.to(dtype).reshape(2 * m, w).t()
    up = ah.to(dtype).reshape(2 * n, h) @ t.reshape(h, b * c * 2 * m)
    up = up.reshape(2, n, b, c, 2, m).permute(2, 1, 5, 0, 4, 3)
    return up.reshape(b, n, m, 4 * c).permute(0, 3, 1, 2)


def phase_upsample_packed(fm: torch.Tensor, ah: torch.Tensor,
                          aw: torch.Tensor, dtype=torch.bfloat16
                          ) -> torch.Tensor:
    """[b, c, h2, w2] -> shifted-lattice packed upsample
    [b, 4c, h2+1, w2+1] (channels_last, phase order (a*2+b)c)."""
    return _phase_upsample_rows(fm.permute(2, 0, 1, 3), ah, aw, dtype)


def phase_upsample_from_packed(fmp: torch.Tensor, ah: torch.Tensor,
                               aw: torch.Tensor, dtype=torch.bfloat16
                               ) -> torch.Tensor:
    """:func:`phase_upsample_packed` of a packed input: fmp
    [b, 4c, h4, w4] is the packed form (plain-grid phases, channel
    (py*2+px)*c + ch) of a [b, c, 2*h4, 2*w4] tensor, as
    :func:`run_packed_stage` emits it. Its rows and columns are read in
    unpacked order by the one copy the upsample makes of its input."""
    b, c4, h4, w4 = fmp.shape
    c = c4 // 4
    x = fmp.reshape(b, 2, 2, c, h4, w4).permute(4, 1, 0, 3, 5, 2)
    return _phase_upsample_rows(x.reshape(2 * h4, b, c, 2 * w4), ah, aw,
                                dtype)


def _conv_skip_direct(x: torch.Tensor, w_direct: torch.Tensor,
                      dtype) -> torch.Tensor:
    """The skip/image term of a packed stage, a stride-2 4x4 convolution
    of the unpacked tensor (see _fold_conv_direct)."""
    return F.conv2d(x.to(dtype), w_direct.to(dtype), stride=2, padding=1)


def _bn_lrelu(y: torch.Tensor, scale4: torch.Tensor, bias4: torch.Tensor,
              alpha: float) -> torch.Tensor:
    """Phase-tiled BatchNorm affine and LeakyReLU in y's dtype (the slope
    rounded to that dtype, as ``jnp.asarray(alpha, acc_t)``)."""
    y = y * scale4.to(y.dtype)[:, None, None] \
        + bias4.to(y.dtype)[:, None, None]
    slope = float(torch.tensor(alpha, dtype=y.dtype))
    return torch.where(y > 0, y, y * slope)


def run_packed_stage(fm: torch.Tensor, skip: torch.Tensor,
                     cp: PackedStageParams, alpha: float = 0.1,
                     dtype=torch.bfloat16, fm_packed: bool = False,
                     quant: bool = False) -> torch.Tensor:
    """One packed decoder stage.

    Args:
      fm:   [b, c_fm, hc, wc] incoming decoder activation (pre-upsample),
            or, with fm_packed=True, its packed form [b, 4c_fm, hc/2, wc/2]
            as a previous run_packed_stage emits it.
      skip: [b, c_skip, 2hc, 2wc] backbone skip at this stage's resolution.
      quant: both convolutions in int8 (per-image scales), then float32.
    Returns the packed stage activation [b, 4cout, hc, wc] (channels_last,
    plain-grid phases, channel (p*2+q)*cout + ch) in ``dtype``."""
    up = (phase_upsample_from_packed if fm_packed
          else phase_upsample_packed)(fm, cp.ah, cp.aw, dtype)
    if quant:
        y = conv2d_int8(up, cp.w_fm) + conv2d_int8(skip, cp.w_skip,
                                                   stride=2, padding=1)
        return _bn_lrelu(y, cp.scale4, cp.bias4, alpha).to(dtype)
    y = F.conv2d(up, cp.w_fm.to(dtype))
    y = y + _conv_skip_direct(skip, cp.w_skip, dtype)
    return _bn_lrelu(y, cp.scale4, cp.bias4, alpha)


def run_packed_tail(fm: torch.Tensor, image: torch.Tensor,
                    tp: PackedTailParams, alpha: float = 0.1,
                    dtype=torch.bfloat16, out_dtype=torch.float32,
                    fm_packed: bool = False, quant: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed raw stage and head.

    Args:
      fm:    [b, s2dim, h2, w2] 2s-stage activation (pre-upsample), or,
             with fm_packed=True, its packed form [b, 4*s2dim, h2/2, w2/2].
      image: [b, 3, h, w] normalized input (h = 2*h2, w = 2*w2).
      quant: the feature term in int8 (per-image scales), the rgb term in
             float32 from ``dtype`` inputs, BatchNorm and LeakyReLU in
             float32; the head in ``dtype`` as without.
    Returns:
      packed: [b, h2, w2, 4*hout] packed head field (NHWC, contiguous),
              sub-pixel (p, q) at channels (p*2+q)*hout, in ``out_dtype``.
      fgcnt:  [b, h2, w2] float32 foreground sub-pixel count per cell.
    """
    up = (phase_upsample_from_packed if fm_packed
          else phase_upsample_packed)(fm, tp.ah, tp.aw, dtype)
    if quant:
        y = conv2d_int8(up, tp.w_fm) + F.conv2d(
            image.to(dtype).float(), tp.w_im.to(dtype).float(), stride=2,
            padding=1)
        y = _bn_lrelu(y, tp.scale4, tp.bias4, alpha).to(dtype)
    else:
        y = F.conv2d(up, tp.w_fm.to(dtype))
        y = y + _conv_skip_direct(image, tp.w_im, dtype)
        y = _bn_lrelu(y, tp.scale4, tp.bias4, alpha)
    # the head in the compute dtype, its bias added in float32
    packed = (y.permute(0, 2, 3, 1) @ tp.w_head4.to(dtype)).float() \
        + tp.b_head4                                        # [b,h2,w2,4h]
    hout = tp.b_head4.shape[0] // 4
    rows = packed.reshape(*packed.shape[:3], 4, hout)
    fgcnt = (rows[..., 1] > rows[..., 0]).sum(-1).to(torch.float32)
    return packed.to(out_dtype), fgcnt


# ---------------------------------------------------------------------------
# By depth: fold the port's PVNet modules and run
# ---------------------------------------------------------------------------

def _fold_stage(block: torch.nn.Sequential, c_fm: int, h: int,
                w: int) -> PackedStageParams:
    conv, bn = block[0], block[1]
    return fold_packed_stage(conv.weight.detach(), bn.weight.detach(),
                             bn.bias.detach(), bn.running_mean,
                             bn.running_var, c_fm, h, w, eps=bn.eps)


def _fold_tail(model, h: int, w: int, h2: int, w2: int) -> PackedTailParams:
    conv, bn, head = model.convraw[0], model.convraw[1], model.convraw[3]
    return fold_packed_tail(
        conv.weight.detach(), bn.weight.detach(), bn.bias.detach(),
        bn.running_mean, bn.running_var, head.weight.detach(),
        None if head.bias is None else head.bias.detach(),
        h, w, h2, w2, eps=bn.eps)


def packed_tail_from_model(model, fm: torch.Tensor, image: torch.Tensor,
                           alpha: float = 0.1, dtype=torch.bfloat16,
                           out_dtype: Optional[torch.dtype] = None,
                           quant: bool = False):
    """Depth 1: fold the raw stage (convraw) and run the 2s features fm
    (``model(x, return_2s_features=True)``) to the packed head field.
    Returns (packed, fgcnt) as :func:`run_packed_tail`; ``out_dtype``
    defaults to ``dtype``; ``quant`` as there (and in every stage of the
    deeper drivers)."""
    tp = _fold_tail(model, *image.shape[2:], *fm.shape[2:])
    return run_packed_tail(fm, image, tp, alpha, dtype, out_dtype or dtype,
                           quant=quant)


def packed_tail_deep_from_model(model, fm4: torch.Tensor, x2s: torch.Tensor,
                                image: torch.Tensor, alpha: float = 0.1,
                                dtype=torch.bfloat16,
                                out_dtype: Optional[torch.dtype] = None,
                                quant: bool = False):
    """Depth 2: also the 2s stage (conv2s) on the lattice, from
    ``model(x, return_4s_features=True)``."""
    h2, w2 = x2s.shape[2:]
    cp = _fold_stage(model.conv2s, fm4.shape[1], h2, w2)
    fm2p = run_packed_stage(fm4, x2s, cp, alpha, dtype, quant=quant)
    tp = _fold_tail(model, *image.shape[2:], h2, w2)
    return run_packed_tail(fm2p, image, tp, alpha, dtype, out_dtype or dtype,
                           fm_packed=True, quant=quant)


def packed_tail_deep3_from_model(model, fm8: torch.Tensor, x4s: torch.Tensor,
                                 x2s: torch.Tensor, image: torch.Tensor,
                                 alpha: float = 0.1, dtype=torch.bfloat16,
                                 out_dtype: Optional[torch.dtype] = None,
                                 quant: bool = False):
    """Depth 3: the 4s stage (conv4s), the 2s stage (conv2s) and the raw
    stage on lattices, from ``model(x, return_8s_features=True)``: every
    decoder tensor below the 8s stage."""
    cp4 = _fold_stage(model.conv4s, fm8.shape[1], *x4s.shape[2:])
    fm4p = run_packed_stage(fm8, x4s, cp4, alpha, dtype, quant=quant)
    h2, w2 = x2s.shape[2:]
    cp2 = _fold_stage(model.conv2s, model.conv4s[0].out_channels, h2, w2)
    fm2p = run_packed_stage(fm4p, x2s, cp2, alpha, dtype, fm_packed=True,
                            quant=quant)
    tp = _fold_tail(model, *image.shape[2:], h2, w2)
    return run_packed_tail(fm2p, image, tp, alpha, dtype, out_dtype or dtype,
                           fm_packed=True, quant=quant)
