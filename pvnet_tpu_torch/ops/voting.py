"""Batched, fixed-shape RANSAC keypoint voting.

PyTorch port of pvnet_tpu/ops/voting.py:

1. Foreground selection (:func:`sample_foreground`). ``method=
   'stratified'`` (the default): one random foreground pixel per spatial
   phase bucket, through kernel K1 (channel-major field) or K2 (NHWC
   field) of ops/select_kernel.py, then a stable compaction of the valid
   slots into a prefix. ``method='topk'``: the best ``tn`` of 2*fg + noise,
   the form JAX's ``method='auto'`` picks off the TPU. The port never
   chooses by device: stratified unless the caller asks.
   :func:`sample_foreground_packed` selects the stratified way, through
   K2, on the packed tail's half-resolution field.
2. Hypothesis generation (:func:`generate_hypotheses`): one pixel pair
   per hypothesis shared by every keypoint, or per keypoint.
3. Inlier counting (:func:`count_inliers`) in the multiplication-only form
   ``dot > 0 and dot^2 > t^2 |d|^2 |n|^2`` through kernel K3
   (csrc/count_inliers.cu); the [hn, vn, tn] inlier tensor never exists.
   ``impl='bf16'`` counts in bfloat16 instead, through K3's bf16 mode
   (:func:`count_inliers_bf16`, JAX's ``count_inliers_xla_bf16``).
4. Winner argmax + weighted-least-squares refine
   (:func:`vote_argmax_refine`).
5. For the uncertainty path, the hypothesis covariance about the voted
   keypoints (:func:`estimate_voting_distribution_from_fg`, K3 again).

On these pieces stand the voting layers of the JAX module: v3 (the
production layer), v2 (re-vote and refit rounds), v4 (the fit's residual
variance), v5 (a confidence vote), the hypothesis distribution without a
mean, the hypotheses with their counts, multi-class voting, center voting
and motion voting, all through K1/K2 and K3; and the vanishing-point
layer, whose homogeneous inlier test is plain tensor code, as in JAX.

Every function whose JAX twin draws random numbers takes the draws as
optional tensors — ``noise`` for selection ([b, h, w], [b, h*w] for
'topk', or [b, HP, WP] on the packed lattice) and ``pair_u`` ([b, hn, 2],
or [b, hn, vn, 2] for per-keypoint pairs) for hypothesis pairs — so a test
can feed in JAX's draws and demand exact integer agreement. Without them
the draws come from ``torch.rand`` with the given ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pvnet_tpu_torch.ops import kernel_lib
from pvnet_tpu_torch.ops.geometry import solve_2x2
from pvnet_tpu_torch.ops.select_kernel import (stratified_select,
                                               stratified_select_cmajor)
from pvnet_tpu_torch.ops.smalllinalg import eigh_small
from pvnet_tpu_torch.utils.profiling import annotate

# Guard constants matching the CUDA kernels
# (ref ransac_voting_kernel.cu:42,121).
_DEGENERATE_EPS = 1e-6
_NORM_EPS_SQ = 1e-12
_VANISH_CHUNK = 64      # hypotheses a vanishing_counts step tests


class ForegroundSample(NamedTuple):
    """Fixed-shape foreground pixel sample of a segmentation mask.

    Invariant: valid slots form a contiguous prefix — slot i is valid iff
    i < count (pair sampling draws slot indices from [0, count))."""
    coords: torch.Tensor   # [b, tn, 2] float32 (x, y) pixel coordinates
    dirs: torch.Tensor     # [b, tn, vn, 2] predicted unit-vector field
    valid: torch.Tensor    # [b, tn] bool; False entries never vote
    count: torch.Tensor    # [b] int32 number of valid entries
    total: torch.Tensor    # [b] int32 foreground pixels before sampling


def uniform(shape, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """Uniform [0, 1) float32 draws from ``generator`` (on its own device),
    moved to ``device``."""
    gen_dev = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=gen_dev)
    return u.to(device)


def _compact_valid_prefix(coords, dirs, valid):
    """Permute sample slots so valid entries form a contiguous prefix
    (stable, so valid slots keep their phase order)."""
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    b, tn, vn, _ = dirs.shape
    coords = torch.gather(coords, 1, order[..., None].expand(b, tn, 2))
    dirs = torch.gather(dirs, 1, order[..., None, None].expand(b, tn, vn, 2))
    valid = torch.gather(valid, 1, order)
    return coords, dirs, valid


def _phase_grid(tn: int) -> Tuple[int, int]:
    """Factor the pixel budget tn = a * b with a <= b, a maximal <=
    sqrt(tn): the phase grid of the stratified sampler."""
    a = int(tn ** 0.5)
    while tn % a:
        a -= 1
    return a, tn // a


def _phase_offsets(a: int, bb: int, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Row and column phase [a*bb] of each slot of an (a, bb) grid."""
    return (torch.arange(a, device=device).repeat_interleave(bb),
            torch.arange(bb, device=device).repeat(a))


def sample_foreground(mask: torch.Tensor, vertex: torch.Tensor, tn: int,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      method: str = "stratified",
                      exact_topk: bool = False) -> ForegroundSample:
    """Select up to ``tn`` foreground pixels with a fixed output shape.

    ``method='stratified'``: partition pixels into tn buckets by phase
    (y mod a, x mod bb), a*bb = tn, and keep in each bucket the foreground
    pixel with the highest uniform-noise score (a uniform pick among that
    bucket's foreground), through kernel K1 or K2. Port of
    ``_sample_foreground_stratified``. ``method='topk'``: the ``tn`` best
    scores 2*fg + noise over the whole image (:func:`_sample_foreground_topk`,
    the JAX function's top-k branch). ``exact_topk`` is accepted for the
    JAX signature and changes nothing: the port has no approximate top-k.

    Args:
      mask:   [b, h, w] segmentation (nonzero = foreground).
      vertex: [b, vn*2, h, w] channel-major direction field (selected by
        kernel K1), or [b, h, w, vn, 2] NHWC (kernel K2).
      tn:     fixed pixel budget.
      noise:  optional uniform draws, [b, h, w] or [b, h*w] (the same
        values in either shape); drawn from ``generator`` when absent.
    """
    if method == "topk":
        return _sample_foreground_topk(mask, vertex, tn, noise, generator)
    if method != "stratified":
        raise ValueError(f"method must be 'stratified' or 'topk', got "
                         f"{method!r}")
    b, h, w = mask.shape
    cmajor = vertex.dim() == 4
    vn = vertex.shape[1] // 2 if cmajor else vertex.shape[3]
    a, bb = _phase_grid(tn)
    pad_h, pad_w = (-h) % a, (-w) % bb
    fg = mask != 0
    total = fg.reshape(b, h * w).sum(1).to(torch.int32)

    if noise is None:
        noise = uniform((b, h, w), generator, mask.device)
    score = fg.to(torch.float32) * 2.0 + noise.reshape(b, h, w)
    vertex = vertex.to(torch.float32)
    if not cmajor:
        vertex = vertex.reshape(b, h, w, 2 * vn)
    if pad_h or pad_w:
        score = F.pad(score, (0, pad_w, 0, pad_h), value=-1.0)
        vertex = F.pad(vertex, (0, pad_w, 0, pad_h) if cmajor
                       else (0, 0, 0, pad_w, 0, pad_h))
    tx_n = (w + pad_w) // bb

    select = stratified_select_cmajor if cmajor else stratified_select
    best, idx, dirs = select(score.contiguous(), vertex.contiguous(), a, bb)

    valid = (best >= 2.0).reshape(b, tn)
    ty = (idx // tx_n).reshape(b, tn)
    tx = (idx % tx_n).reshape(b, tn)
    dirs = dirs.reshape(b, tn, vn, 2) * valid[:, :, None, None].to(
        torch.float32)

    phase_y, phase_x = _phase_offsets(a, bb, mask.device)   # [tn]
    ys = (ty * a + phase_y[None, :]).to(torch.float32)
    xs = (tx * bb + phase_x[None, :]).to(torch.float32)
    coords = torch.stack([xs, ys], dim=-1)                  # [b, tn, 2]

    coords, dirs, valid = _compact_valid_prefix(coords, dirs, valid)
    count = valid.sum(1).to(torch.int32)
    return ForegroundSample(coords, dirs, valid, count, total)


def _sample_foreground_topk(mask: torch.Tensor, vertex: torch.Tensor,
                            tn: int, noise: Optional[torch.Tensor],
                            generator: Optional[torch.Generator]
                            ) -> ForegroundSample:
    """The ``tn`` best scores 2*fg + noise over each image (the JAX
    ``sample_foreground`` top-k branch): a uniform random subsample of the
    foreground, the reference's own subsampling above its cap. Valid slots
    (score >= 2) come first, so they form a prefix.

    ``lax.top_k`` puts the lower index first among equal scores, and
    ``jax.random.uniform`` gives multiples of 2^-23, so equal scores are
    common; ``torch.topk`` leaves their order unspecified. A stable
    descending sort keeps the lower index first, on every device."""
    b, h, w = mask.shape
    cmajor = vertex.dim() == 4
    vn = vertex.shape[1] // 2 if cmajor else vertex.shape[3]
    flat_fg = (mask != 0).reshape(b, h * w)
    total = flat_fg.sum(1).to(torch.int32)
    if noise is None:
        noise = uniform((b, h * w), generator, mask.device)
    score = flat_fg.to(torch.float32) * 2.0 + noise.reshape(b, h * w)
    top_scores, top_idx = torch.sort(score, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :tn], top_idx[:, :tn]
    valid = top_scores >= 2.0

    xs = (top_idx % w).to(torch.float32)
    ys = (top_idx // w).to(torch.float32)
    coords = torch.stack([xs, ys], dim=-1)                  # [b, tn, 2]
    if cmajor:                                              # [b, 2vn, h*w]
        rows = torch.gather(vertex.reshape(b, 2 * vn, h * w), 2,
                            top_idx[:, None, :].expand(b, 2 * vn, tn))
        rows = rows.transpose(1, 2)
    else:                                                   # [b, h*w, 2vn]
        rows = torch.gather(vertex.reshape(b, h * w, 2 * vn), 1,
                            top_idx[:, :, None].expand(b, tn, 2 * vn))
    dirs = rows.to(torch.float32).reshape(b, tn, vn, 2) \
        * valid[:, :, None, None].to(torch.float32)
    count = valid.sum(1).to(torch.int32)
    return ForegroundSample(coords, dirs, valid, count, total)


def sample_foreground_packed(packed: torch.Tensor, fgcnt: torch.Tensor,
                             tn: int, noise: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None,
                             seg_dim: int = 2) -> ForegroundSample:
    """Stratified foreground sampling directly on a packed head field.

    Consumes the packed inference tail's outputs (ops/packed_tail.py):
    ``packed`` [b, HP, WP, 4*hout] holds the seg+ver head values of each
    2x2 full-resolution cell in depth (sub-pixel (p, q) at channels
    (p*2+q)*hout), ``fgcnt`` [b, HP, WP] its foreground pixel count.
    Selection picks tn//4 cells on a phase grid over the half-resolution
    lattice through kernel K2 and expands each winner into its 4
    sub-pixels, valid where their seg logits say foreground. The
    full-resolution fields never exist. Port of
    ``voting.sample_foreground_packed``.

    Args:
      tn: pixel budget, a multiple of 4 (tn//4 cells).
      noise: optional [b, HP, WP] uniform draws; drawn from ``generator``
        when absent.
    Returns a ForegroundSample with tn slots; ``total`` is the exact
    full-resolution foreground pixel count.
    """
    b, HP, WP, h4 = packed.shape
    hout = h4 // 4
    if seg_dim != 2:
        # the sub-pixel test compares seg logits 1 vs 0
        # (ref train_linemod.py:99-102)
        raise ValueError(f"seg_dim must be 2, got {seg_dim}")
    if tn % 4:
        raise ValueError(f"tn must be a multiple of 4, got {tn}")
    vn = (hout - seg_dim) // 2
    blocks = tn // 4
    a, bb = _phase_grid(blocks)
    pad_h, pad_w = (-HP) % a, (-WP) % bb
    total = fgcnt.reshape(b, HP * WP).sum(1).to(torch.int32)

    if noise is None:
        noise = uniform((b, HP, WP), generator, packed.device)
    score = (fgcnt > 0).to(torch.float32) * 2.0 + noise
    if pad_h or pad_w:
        score = F.pad(score, (0, pad_w, 0, pad_h), value=-1.0)
        packed = F.pad(packed, (0, 0, 0, pad_w, 0, pad_h))
    tx_n = (WP + pad_w) // bb

    best, idx, rows = stratified_select(score.contiguous(),
                                        packed.contiguous(), a, bb)

    block_valid = (best >= 2.0).reshape(b, blocks)
    phase_y, phase_x = _phase_offsets(a, bb, packed.device)
    cell_y = (idx // tx_n).reshape(b, blocks) * a + phase_y[None, :]
    cell_x = (idx % tx_n).reshape(b, blocks) * bb + phase_x[None, :]

    rows = rows.reshape(b, blocks, 4, hout).to(torch.float32)
    sub_fg = rows[..., 1] > rows[..., 0]                    # [b, blocks, 4]
    sub_valid = sub_fg & block_valid[..., None]
    dirs = rows[..., seg_dim:].reshape(b, blocks, 4, vn, 2) \
        * sub_valid[..., None, None].to(torch.float32)

    par = torch.arange(4, device=packed.device)             # sub-pixel p*2+q
    ys = 2 * cell_y[:, :, None] + (par // 2)[None, None, :]
    xs = 2 * cell_x[:, :, None] + (par % 2)[None, None, :]
    coords = torch.stack([xs, ys], dim=-1).to(torch.float32)

    coords, dirs, valid = _compact_valid_prefix(
        coords.reshape(b, tn, 2), dirs.reshape(b, tn, vn, 2),
        sub_valid.reshape(b, tn))
    count = valid.sum(1).to(torch.int32)
    return ForegroundSample(coords, dirs, valid, count, total)


def _shared_pairs(fg: ForegroundSample, hn: int,
                  pair_u: Optional[torch.Tensor],
                  generator: Optional[torch.Generator]):
    """One pixel pair per hypothesis, shared by every keypoint: slots from
    ``pair_u`` [b, hn, 2] (drawn when None) scaled by the foreground count.
    Returns the pair's (coords0, dir0, coords1, dir1), each
    [b, hn, vn, 2]."""
    b, tn, vn, _ = fg.dirs.shape
    count = fg.count.clamp(min=1)[:, None, None]            # [b, 1, 1]
    if pair_u is None:
        pair_u = uniform((b, hn, 2), generator, fg.dirs.device)
    idx = torch.minimum((pair_u * count).to(torch.int32), count - 1)

    feats = torch.cat([fg.dirs, fg.coords[:, :, None, :].expand_as(fg.dirs)],
                      dim=-1).reshape(b, tn, vn * 4)        # (dir, coords)

    def gather_pair(i):                                     # i: [b, hn]
        f = torch.gather(feats, 1, i.long()[..., None].expand(b, hn, vn * 4))
        f = f.reshape(b, hn, vn, 4)
        return f[..., 2:4], f[..., 0:2]                     # coords, dir

    return (*gather_pair(idx[..., 0]), *gather_pair(idx[..., 1]))


def _per_keypoint_pairs(fg: ForegroundSample, hn: int,
                        pair_u: Optional[torch.Tensor],
                        generator: Optional[torch.Generator]):
    """One pixel pair per (hypothesis, keypoint), the reference CUDA
    kernel's sampling scheme: slots from ``pair_u`` [b, hn, vn, 2] (drawn
    when None) scaled by the foreground count. Returns the pair's
    (coords0, dir0, coords1, dir1), each [b, hn, vn, 2]."""
    b, tn, vn, _ = fg.dirs.shape
    if pair_u is None:
        pair_u = uniform((b, hn, vn, 2), generator, fg.dirs.device)
    count = fg.count.clamp(min=1)[:, None, None, None]      # [b, 1, 1, 1]
    idx = torch.minimum((pair_u * count).to(torch.int32), count - 1).long()
    feats = torch.cat([fg.dirs, fg.coords[:, :, None, :].expand_as(fg.dirs)],
                      dim=-1)                               # (dir, coords)

    def gather_pair(i):                                     # i: [b, hn, vn]
        f = torch.gather(feats, 1, i[..., None].expand(b, hn, vn, 4))
        return f[..., 2:4], f[..., 0:2]                     # coords, dir

    return (*gather_pair(idx[..., 0]), *gather_pair(idx[..., 1]))


def generate_hypotheses(fg: ForegroundSample, hn: int,
                        pair_u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None,
                        shared_pairs: bool = True) -> torch.Tensor:
    """Sample pixel pairs and intersect their voting rays in closed form.

    With ``shared_pairs`` (the default) one pixel pair per hypothesis is
    shared by every keypoint; without, each (hypothesis, keypoint) draws its
    own pair, the reference CUDA kernel's sampling scheme. Degenerate
    (near-parallel) pairs give the (0, 0) hypothesis, like the reference
    kernel's early return.

    Args:
      pair_u: optional uniform draws picking the pairs' slots, [b, hn, 2]
        (shared) or [b, hn, vn, 2].
    Returns:
      [b, hn, vn, 2] hypothesis points.
    """
    pairs = _shared_pairs if shared_pairs else _per_keypoint_pairs
    c0, d0, c1, d1 = pairs(fg, hn, pair_u, generator)

    nx0, ny0 = d0[..., 1], -d0[..., 0]
    nx1, ny1 = d1[..., 1], -d1[..., 0]
    r0 = nx0 * c0[..., 0] + ny0 * c0[..., 1]
    r1 = nx1 * c1[..., 0] + ny1 * c1[..., 1]

    denom = nx1 * ny0 - nx0 * ny1
    ok = denom.abs() >= _DEGENERATE_EPS
    safe = torch.where(ok, denom, torch.ones_like(denom))
    y = (nx1 * r0 - nx0 * r1) / safe
    x = -(ny1 * r0 - ny0 * r1) / safe
    hyp = torch.stack([x, y], dim=-1)
    return torch.where(ok[..., None], hyp, torch.zeros_like(hyp))


# ---------------------------------------------------------------------------
# Inlier counting — the O(hn * vn * tn) hot loop
# ---------------------------------------------------------------------------

def _pixel_features(fg: ForegroundSample) -> torch.Tensor:
    """Per-(image, keypoint, pixel) features of the multiplication-only
    inlier test, [b, vn, tn, 8]:
    (nx, ny, c.n, cx, cy, |c|^2, |n|^2, valid)."""
    nx = fg.dirs[..., 0]                                    # [b, tn, vn]
    ny = fg.dirs[..., 1]
    cx = fg.coords[..., 0:1]                                # [b, tn, 1]
    cy = fg.coords[..., 1:2]
    cn = cx * nx + cy * ny
    c2 = (cx * cx + cy * cy).expand_as(nx)
    n2 = nx * nx + ny * ny
    vmask = fg.valid[..., None].to(torch.float32).expand_as(nx)
    feats = torch.stack([nx, ny, cn, cx.expand_as(nx), cy.expand_as(nx),
                         c2, n2, vmask], dim=-1)            # [b, tn, vn, 8]
    return feats.permute(0, 2, 1, 3).contiguous()           # [b, vn, tn, 8]


def _inlier_terms(pix: torch.Tensor, hyp: torch.Tensor,
                  thresh: float) -> torch.Tensor:
    """pix [..., 8] broadcast against hyp [..., >=3] -> bool inlier mask.

    pix supplies (nx, ny, cn, cx, cy, c2, n2, valid); hyp (hx, hy, h2).
    The operation order is the one K3 spells out with explicit rounding."""
    nx, ny, cn = pix[..., 0], pix[..., 1], pix[..., 2]
    cx, cy, c2 = pix[..., 3], pix[..., 4], pix[..., 5]
    n2, vmask = pix[..., 6], pix[..., 7]
    hx, hy, h2 = hyp[..., 0], hyp[..., 1], hyp[..., 2]

    dot = hx * nx + hy * ny - cn
    d2 = h2 - 2.0 * (hx * cx + hy * cy) + c2
    t2 = thresh * thresh
    return ((dot > 0)
            & (dot * dot > t2 * d2 * n2)
            & (d2 > _NORM_EPS_SQ)
            & (n2 > _NORM_EPS_SQ)
            & (vmask > 0.5))


def _hyp_features(hyps: torch.Tensor) -> torch.Tensor:
    """[..., 2] hypotheses -> [..., 3] (hx, hy, hx^2 + hy^2)."""
    hx, hy = hyps[..., 0], hyps[..., 1]
    return torch.stack([hx, hy, hx * hx + hy * hy], dim=-1)


def count_inliers_plain(fg: ForegroundSample, hyps: torch.Tensor,
                        thresh: float, chunk: int = 64) -> torch.Tensor:
    """Plain PyTorch inlier count (port of ``count_inliers_xla``), chunked
    over hypotheses. Runs on any device. Returns [b, hn, vn] int32."""
    if thresh <= 0.0:
        raise ValueError(f"thresh must be > 0, got {thresh}")
    pix = _pixel_features(fg)[:, None]                      # [b,1,vn,tn,8]
    out = []
    for s in range(0, hyps.shape[1], chunk):
        hf = _hyp_features(hyps[:, s:s + chunk])            # [b,c,vn,3]
        inl = _inlier_terms(pix, hf[:, :, :, None, :], thresh)
        out.append(inl.sum(-1).to(torch.int32))            # [b, c, vn]
    return torch.cat(out, dim=1)


def _count_kernel_args(fg: ForegroundSample, hyps: torch.Tensor):
    """Validate the tensors of a K3 launch; return (coords, dirs, valid,
    hyps), each contiguous (copied only if it is not)."""
    if hyps.dim() != 4 or hyps.shape[3] != 2:
        raise ValueError(f"hyps must be [b, hn, vn, 2], got "
                         f"{tuple(hyps.shape)}")
    b, _, vn, _ = hyps.shape
    tn = fg.coords.shape[1] if fg.coords.dim() == 3 else -1
    if (fg.coords.shape != (b, tn, 2) or fg.dirs.shape != (b, tn, vn, 2)
            or fg.valid.shape != (b, tn)):
        raise ValueError(f"hyps {tuple(hyps.shape)} does not match sample "
                         f"coords {tuple(fg.coords.shape)}, dirs "
                         f"{tuple(fg.dirs.shape)}, valid "
                         f"{tuple(fg.valid.shape)}")
    dtypes = (hyps.dtype, fg.dirs.dtype, fg.coords.dtype)
    if any(d != torch.float32 for d in dtypes) or fg.valid.dtype != torch.bool:
        raise TypeError(f"float32 hyps, dirs and coords and bool valid "
                        f"required; got {dtypes}, {fg.valid.dtype}")
    tensors = (fg.coords, fg.dirs, fg.valid, hyps)
    if any(t.device != hyps.device for t in tensors):
        raise ValueError(f"sample on {fg.coords.device}, {fg.dirs.device}, "
                         f"{fg.valid.device}, hyps on {hyps.device}")
    return tuple(t.contiguous() for t in tensors)


def _count_outputs(hyps: torch.Tensor) -> torch.Tensor:
    b, hn, vn, _ = hyps.shape
    return hyps.new_empty((b, hn, vn), dtype=torch.int32)


# The registered operators of K3's two modes: the CPU implementation is the
# plain version, the CUDA one launches the kernel (counted on the wrapper's
# ``.launches``) or raises, the fake one gives export's tracer the shape.

@torch.library.custom_op(f"{kernel_lib.NAMESPACE}::count_inliers",
                         mutates_args=(), device_types="cpu")
def _count_op(coords: torch.Tensor, dirs: torch.Tensor, valid: torch.Tensor,
              hyps: torch.Tensor, thresh: float) -> torch.Tensor:
    return count_inliers_plain(
        ForegroundSample(coords, dirs, valid, None, None), hyps, thresh)


@_count_op.register_kernel("cuda")
def _count_cuda(coords, dirs, valid, hyps, thresh):
    b, hn, vn, _ = hyps.shape
    tn = coords.shape[1]
    counts = _count_outputs(hyps)
    if counts.numel() == 0:
        return counts
    if tn == 0:
        return counts.zero_()
    kernel_lib.launch("pvnet_count_inliers", hyps.device, coords.data_ptr(),
                      dirs.data_ptr(), valid.data_ptr(), hyps.data_ptr(),
                      counts.data_ptr(), b, vn, tn, hn,
                      float(thresh * thresh), 0)
    count_inliers.launches += 1
    return counts


@_count_op.register_fake
def _count_fake(coords, dirs, valid, hyps, thresh):
    return _count_outputs(hyps)


def count_inliers(fg: ForegroundSample, hyps: torch.Tensor,
                  thresh: float, impl: Optional[str] = None) -> torch.Tensor:
    """Inlier counts [b, hn, vn] int32 of each hypothesis (kernel K3).

    Semantics of the reference's voting_for_hypothesis_kernel
    (ref ransac_voting_kernel.cu:88-126). ``impl`` None counts in float32;
    'bf16' in bfloat16 (:func:`count_inliers_bf16`), as the JAX
    ``count_inliers`` dispatches. Calls the operator
    ``pvnet_torch::count_inliers``: a CPU tensor runs
    :func:`count_inliers_plain`; a CUDA tensor launches the kernel (and
    counts the launch in ``.launches``) or raises. The kernel reads the
    sample's coords, dirs and valid itself."""
    if impl == "bf16":
        return count_inliers_bf16(fg, hyps, thresh)
    if impl is not None:
        raise ValueError(f"impl must be None or 'bf16', got {impl!r}")
    if thresh <= 0.0:
        raise ValueError(f"thresh must be > 0, got {thresh}")
    kernel_lib.check_device(hyps)
    return torch.ops.pvnet_torch.count_inliers(
        *_count_kernel_args(fg, hyps), float(thresh))


count_inliers.launches = 0


def _centroid(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[b, 2] float32 mean of each image's valid coordinates (0 with
    none): the sum over the slot axis, then one division. Exact for pixel
    coordinates, whose sums stay below 2^24."""
    vf = valid.to(torch.float32)
    denom = vf.sum(1).clamp(min=1.0)
    return (coords * vf[..., None]).sum(1) / denom[:, None]


def _bf16_constants(thresh: float, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """(t^2, 1e-12) as bfloat16 scalars, rounded from float64 once."""
    return (torch.tensor(thresh * thresh, dtype=torch.bfloat16,
                         device=device),
            torch.tensor(_NORM_EPS_SQ, dtype=torch.bfloat16, device=device))


def _bf16_floats(thresh: float) -> Tuple[float, float]:
    """:func:`_bf16_constants` as Python floats (exact)."""
    return tuple(float(c) for c in _bf16_constants(thresh, "cpu"))


def _count_bf16_plain(coords: torch.Tensor, dirs: torch.Tensor,
                      valid: torch.Tensor, hyps: torch.Tensor,
                      ctr: torch.Tensor, t2: float, eps2: float,
                      chunk: int = 64) -> torch.Tensor:
    """The bf16 count about the centroid ``ctr`` [b, 2] with the constants
    t2 and eps2 (floats that bfloat16 holds exactly): every operation an
    eager bf16 one (so rounded), in K3's bf16 order."""
    bf = torch.bfloat16
    t2, eps2 = (torch.tensor(c, dtype=bf, device=hyps.device)
                for c in (t2, eps2))
    coords = (coords - ctr[:, None, :]).to(bf)              # [b, tn, 2]
    hc = (hyps - ctr[:, None, None, :]).to(bf)              # [b,hn,vn,2]
    dirs = dirs.to(bf)
    nx = dirs[..., 0].transpose(1, 2)[:, None]              # [b,1,vn,tn]
    ny = dirs[..., 1].transpose(1, 2)[:, None]
    n2 = nx * nx + ny * ny
    cx = coords[..., 0][:, None, None, :]                   # [b,1,1,tn]
    cy = coords[..., 1][:, None, None, :]
    keep = valid[:, None, None, :] & (n2 > eps2)
    out = []
    for s in range(0, hyps.shape[1], chunk):
        hx = hc[:, s:s + chunk, :, 0, None]                 # [b,c,vn,1]
        hy = hc[:, s:s + chunk, :, 1, None]
        dx = hx - cx
        dy = hy - cy
        dot = dx * nx + dy * ny
        d2 = dx * dx + dy * dy
        inl = (dot > 0) & (dot * dot > t2 * d2 * n2) & (d2 > eps2) & keep
        out.append(inl.sum(-1).to(torch.int32))
    return torch.cat(out, dim=1)


def count_inliers_plain_bf16(fg: ForegroundSample, hyps: torch.Tensor,
                             thresh: float, chunk: int = 64
                             ) -> torch.Tensor:
    """Plain version of :func:`count_inliers_bf16` (JAX's
    ``count_inliers_xla_bf16``): coordinates recentred in float32 on each
    image's foreground centroid, then bfloat16 throughout in the difference
    form, every operation an eager bf16 one (so rounded), in K3's bf16
    order. Runs on any device. Returns [b, hn, vn] int32."""
    if thresh <= 0.0:
        raise ValueError(f"thresh must be > 0, got {thresh}")
    return _count_bf16_plain(fg.coords, fg.dirs, fg.valid, hyps,
                             _centroid(fg.coords, fg.valid),
                             *_bf16_floats(thresh), chunk)


@torch.library.custom_op(f"{kernel_lib.NAMESPACE}::count_inliers_bf16",
                         mutates_args=(), device_types="cpu")
def _count_bf16_op(coords: torch.Tensor, dirs: torch.Tensor,
                   valid: torch.Tensor, hyps: torch.Tensor,
                   ctr: torch.Tensor, t2: float, eps2: float
                   ) -> torch.Tensor:
    return _count_bf16_plain(coords, dirs, valid, hyps, ctr, t2, eps2)


@_count_bf16_op.register_kernel("cuda")
def _count_bf16_cuda(coords, dirs, valid, hyps, ctr, t2, eps2):
    b, hn, vn, _ = hyps.shape
    tn = coords.shape[1]
    counts = _count_outputs(hyps)
    if counts.numel() == 0:
        return counts
    if tn == 0:
        return counts.zero_()
    kernel_lib.launch("pvnet_count_inliers_bf16", hyps.device,
                      coords.data_ptr(), dirs.data_ptr(), valid.data_ptr(),
                      hyps.data_ptr(), ctr.contiguous().data_ptr(),
                      counts.data_ptr(), b, vn, tn, hn, t2, eps2, 0)
    count_inliers_bf16.launches += 1
    return counts


@_count_bf16_op.register_fake
def _count_bf16_fake(coords, dirs, valid, hyps, ctr, t2, eps2):
    return _count_outputs(hyps)


def count_inliers_bf16(fg: ForegroundSample, hyps: torch.Tensor,
                       thresh: float) -> torch.Tensor:
    """Inlier counts [b, hn, vn] int32 in bfloat16 (K3's bf16 mode): what
    JAX's ``count_inliers_xla_bf16`` computes. The centroid is computed
    here, by :func:`_centroid`, on the sample's device; then the operator
    ``pvnet_torch::count_inliers_bf16`` (the C entry
    ``pvnet_count_inliers_bf16``): a CPU tensor runs the plain version
    (:func:`count_inliers_plain_bf16`'s arithmetic), a CUDA tensor launches
    the kernel (counted in ``.launches``) or raises."""
    if thresh <= 0.0:
        raise ValueError(f"thresh must be > 0, got {thresh}")
    kernel_lib.check_device(hyps)
    coords, dirs, valid, hyps = _count_kernel_args(fg, hyps)
    return torch.ops.pvnet_torch.count_inliers_bf16(
        coords, dirs, valid, hyps, _centroid(coords, valid),
        *_bf16_floats(thresh))


count_inliers_bf16.launches = 0


def inliers_for_points(fg: ForegroundSample, pts: torch.Tensor,
                       thresh: float) -> torch.Tensor:
    """Inlier mask of every pixel w.r.t. one point per keypoint.
    pts [b, vn, 2] -> bool [b, vn, tn]."""
    pix = _pixel_features(fg)                               # [b, vn, tn, 8]
    return _inlier_terms(pix, _hyp_features(pts)[:, :, None, :], thresh)


# ---------------------------------------------------------------------------
# Voting layer
# ---------------------------------------------------------------------------

def _wls_refine(fg: ForegroundSample, win_pts: torch.Tensor, thresh: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted least-squares ray intersection over the winner's inliers
    (normal equations of argmin_p sum_t (n_t . p - n_t . c_t)^2, ref
    ransac_voting_gpu.py:578-595). Singular systems keep the winner.

    Returns (refined [b, vn, 2], inlier mask [b, vn, tn])."""
    inl = inliers_for_points(fg, win_pts, thresh)           # [b, vn, tn]
    w = inl.to(torch.float32)
    normal = torch.stack([fg.dirs[..., 1], -fg.dirs[..., 0]], dim=-1)
    nm = normal.permute(0, 2, 1, 3) * w[..., None]          # [b, vn, tn, 2]
    bscal = (nm * fg.coords[:, None, :, :]).sum(-1)         # [b, vn, tn]
    n0, n1 = nm[..., 0], nm[..., 1]
    a00 = (n0 * n0).sum(-1)
    a01 = (n0 * n1).sum(-1)
    a11 = (n1 * n1).sum(-1)
    ata = torch.stack([torch.stack([a00, a01], -1),
                       torch.stack([a01, a11], -1)], -2)    # [b, vn, 2, 2]
    atb = (nm * bscal[..., None]).sum(2)                    # [b, vn, 2]
    det = a00 * a11 - a01 * a01
    sol = solve_2x2(ata, atb)
    refined = torch.where((det.abs() > 1e-8)[..., None], sol, win_pts)
    return refined, inl


def vote_argmax_refine(fg: ForegroundSample, hyps: torch.Tensor,
                       counts: torch.Tensor, inlier_thresh: float,
                       min_num: int = 5) -> torch.Tensor:
    """Winner argmax over counts [b, hn, vn] (first maximum wins), WLS
    refine over its inliers, zeros for images below ``min_num`` foreground
    pixels. Returns [b, vn, 2]."""
    refined, _ = _wls_refine(fg, _winner_points(hyps, counts),
                             inlier_thresh)
    return _zero_below(fg, min_num, refined)


def _winner_points(hyps: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The hypothesis with the most inliers per keypoint (the first such),
    hyps [b, hn, vn, d] with counts [b, hn, vn] -> [b, vn, d]."""
    b, _, vn, d = hyps.shape
    win_idx = torch.argmax(counts, dim=1)                   # [b, vn]
    return torch.gather(hyps, 1, win_idx[:, None, :, None].expand(
        b, 1, vn, d))[:, 0]


def _zero_below(fg: ForegroundSample, min_num: int, x: torch.Tensor,
                fill: float = 0.0) -> torch.Tensor:
    """``x`` [b, ...] with ``fill`` for images of fewer than ``min_num``
    foreground pixels."""
    ok = (fg.total >= min_num).reshape(-1, *([1] * (x.dim() - 1)))
    return torch.where(ok, x, torch.full_like(x, fill))


def ransac_voting_v3_from_fg(fg: ForegroundSample, hyp_num: int = 1024,
                             inlier_thresh: float = 0.99, min_num: int = 5,
                             pair_u: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None,
                             impl: Optional[str] = None) -> torch.Tensor:
    """v3 voting from a built foreground sample. [b, vn, 2]. ``impl``
    selects the count (:func:`count_inliers`); the refine is float32
    either way."""
    with annotate("voting"):
        return _vote_v3(fg, hyp_num, inlier_thresh, min_num, pair_u,
                        generator, impl)


def _vote_v3(fg: ForegroundSample, hyp_num: int, inlier_thresh: float,
             min_num: int, pair_u: Optional[torch.Tensor],
             generator: Optional[torch.Generator],
             impl: Optional[str]) -> torch.Tensor:
    hyps = generate_hypotheses(fg, hyp_num, pair_u, generator)
    counts = count_inliers(fg, hyps, inlier_thresh, impl)   # [b, hn, vn]
    return vote_argmax_refine(fg, hyps, counts, inlier_thresh, min_num)


def ransac_voting_v3(mask: torch.Tensor, vertex: torch.Tensor,
                     hyp_num: int = 1024, inlier_thresh: float = 0.99,
                     max_num: int = 1024, min_num: int = 5,
                     noise: Optional[torch.Tensor] = None,
                     pair_u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     impl: Optional[str] = None,
                     select_method: str = "stratified") -> torch.Tensor:
    """Production inference voting (ref ransac_voting_gpu.py:514-598).

    Args:
      mask:   [b, h, w] predicted segmentation (nonzero = object).
      vertex: [b, vn*2, h, w] channel-major direction field.
      hyp_num: hypotheses per keypoint, in one pass.
      inlier_thresh: cosine threshold.
      max_num: fixed foreground budget.
      min_num: below this foreground count the output is zeros.
      noise, pair_u: optional draws (see module docstring).
      impl: the count's mode (:func:`count_inliers`).
      select_method: :func:`sample_foreground`'s ``method``.

    Returns:
      [b, vn, 2] voted keypoint locations.
    """
    with annotate("voting"):
        fg = sample_foreground(mask, vertex, max_num, noise, generator,
                               select_method)
        return _vote_v3(fg, hyp_num, inlier_thresh, min_num, pair_u,
                        generator, impl)


# ---------------------------------------------------------------------------
# Hypothesis covariance (the uncertainty path)
# ---------------------------------------------------------------------------

def estimate_voting_distribution_from_fg(
        fg: ForegroundSample, mean: torch.Tensor, hyp_num: int = 4096,
        inlier_thresh: float = 0.99, pair_u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial covariance of the hypothesis distribution about ``mean``
    [b, vn, 2], from a built foreground sample (ref
    ransac_voting_gpu.py:333-406): ``hyp_num`` hypotheses counted through
    K3 (``impl`` as :func:`count_inliers`; bf16 counts weigh the scatter
    too), each weighted by its inlier ratio, weights below (max ratio -
    0.1) zeroed, and the weighted 2x2 scatter about the mean.

    Args:
      pair_u: optional [b, hyp_num, 2] uniform draws for the pairs.
    Returns (mean passed through, cov [b, vn, 2, 2])."""
    hyps = generate_hypotheses(fg, hyp_num, pair_u, generator)
    counts = count_inliers(fg, hyps, inlier_thresh, impl)   # [b, hn, vn]

    denom = fg.count.clamp(min=1).to(torch.float32)[:, None, None]
    ratio = counts.to(torch.float32) / denom
    thresh = ratio.amax(dim=1, keepdim=True) - 0.1
    w = torch.where(ratio < thresh, 0.0, ratio)             # [b, hn, vn]

    diff = hyps - mean[:, None, :, :]                       # [b, hn, vn, 2]
    cov = torch.einsum("bhvi,bhvj->bvij", diff, diff * w[..., None])
    cov = cov / (w.sum(1)[..., None, None] + 1e-3)
    return mean, cov


def estimate_voting_distribution_with_mean(
        mask: torch.Tensor, vertex: torch.Tensor, mean: torch.Tensor,
        hyp_num: int = 4096, inlier_thresh: float = 0.99,
        max_num: int = 1024, noise: Optional[torch.Tensor] = None,
        pair_u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        impl: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`estimate_voting_distribution_from_fg` on a fresh foreground
    sample of (mask, vertex) drawn with ``noise``."""
    fg = sample_foreground(mask, vertex, max_num, noise, generator)
    return estimate_voting_distribution_from_fg(
        fg, mean, hyp_num, inlier_thresh, pair_u, generator, impl)


# ---------------------------------------------------------------------------
# The other voting layers (v2, v4, v5, the distribution without a mean,
# hypotheses with counts, multi-class, vanishing point, center, motion)
# ---------------------------------------------------------------------------

def _vote(mask, vertex, hyp_num, inlier_thresh, max_num, noise, pair_u,
          generator, impl, select_method):
    """Sample, hypotheses and their counts: the common front of the
    layers below. Returns (fg, hyps [b, hn, vn, 2], counts [b, hn, vn])."""
    fg = sample_foreground(mask, vertex, max_num, noise, generator,
                           select_method)
    hyps = generate_hypotheses(fg, hyp_num, pair_u, generator)
    return fg, hyps, count_inliers(fg, hyps, inlier_thresh, impl)


def ransac_voting_v2(mask: torch.Tensor, vertex: torch.Tensor,
                     hyp_num: int = 1024, inlier_thresh: float = 0.999,
                     max_num: int = 1024, min_num: int = 5,
                     refine_iter_num: int = 1,
                     noise: Optional[torch.Tensor] = None,
                     pair_u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     impl: Optional[str] = None,
                     select_method: str = "stratified") -> torch.Tensor:
    """v2 voting: the RANSAC winner, then ``refine_iter_num`` rounds of
    re-vote and least-squares refit over the current point's inliers (ref
    ransac_voting_gpu.py:99-215; singular systems keep the previous
    point). With refine_iter_num=1 this is v3. The reference's threshold
    here is 0.999. Arguments as :func:`ransac_voting_v3`. [b, vn, 2]."""
    fg, hyps, counts = _vote(mask, vertex, hyp_num, inlier_thresh, max_num,
                             noise, pair_u, generator, impl, select_method)
    pts = _winner_points(hyps, counts)
    for _ in range(refine_iter_num):
        pts, _ = _wls_refine(fg, pts, inlier_thresh)
    return _zero_below(fg, min_num, pts)


def estimate_voting_distribution(
        mask: torch.Tensor, vertex: torch.Tensor, round_hyp_num: int = 256,
        min_hyp_num: int = 4096, topk: int = 128,
        inlier_thresh: float = 0.99, min_num: int = 5, max_num: int = 1024,
        noise: Optional[torch.Tensor] = None,
        pair_u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        impl: Optional[str] = None, select_method: str = "stratified"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hypothesis-distribution mean and covariance, no mean given (ref
    ransac_voting_gpu.py:263-331): ceil(min_hyp_num / round_hyp_num) *
    round_hyp_num hypotheses in one pass (4096 by default), each weighted
    by its inlier ratio, only the per-keypoint top ``topk`` weights kept
    (a threshold at the k-th ratio, so ties at it keep more), then the
    weighted mean and the weighted 2x2 scatter about it. Images with fewer
    than ``min_num`` foreground pixels give zeros.

    Returns (mean [b, vn, 2], cov [b, vn, 2, 2])."""
    hn = -(-min_hyp_num // round_hyp_num) * round_hyp_num
    fg, hyps, counts = _vote(mask, vertex, hn, inlier_thresh, max_num,
                             noise, pair_u, generator, impl, select_method)
    denom = fg.count.clamp(min=1).to(torch.float32)[:, None, None]
    ratio = counts.to(torch.float32) / denom                # [b, hn, vn]
    kth = torch.topk(ratio, topk, dim=1).values[:, -1:]     # [b, 1, vn]
    w = torch.where(ratio >= kth, ratio, 0.0)
    wsum = w.sum(1) + 1e-12                                 # [b, vn]
    mean = (hyps * w[..., None]).sum(1) / wsum[..., None]
    diff = hyps - mean[:, None]                             # [b, hn, vn, 2]
    cov = torch.einsum("bhvi,bhvj->bvij", diff, diff * w[..., None])
    cov = cov / wsum[..., None, None]
    return _zero_below(fg, min_num, mean), _zero_below(fg, min_num, cov)


def ransac_voting_v5(mask: torch.Tensor, vertex: torch.Tensor,
                     hyp_num: int = 1024, inlier_thresh: float = 0.99,
                     max_num: int = 1024, min_num: int = 5,
                     conf_thresh: float = 0.999,
                     noise: Optional[torch.Tensor] = None,
                     pair_u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     impl: Optional[str] = None,
                     select_method: str = "stratified"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v3 plus each keypoint's confidence: the share of the sample's valid
    pixels that vote for the refined point at ``conf_thresh`` (ref
    ransac_voting_gpu.py:763-858, 0.999 whatever ``inlier_thresh``).

    Returns ([b, vn, 2] keypoints, [b, vn] confidence in [0, 1])."""
    fg, hyps, counts = _vote(mask, vertex, hyp_num, inlier_thresh, max_num,
                             noise, pair_u, generator, impl, select_method)
    refined, _ = _wls_refine(fg, _winner_points(hyps, counts),
                             inlier_thresh)
    conf_inl = inliers_for_points(fg, refined, conf_thresh)
    denom = fg.count.clamp(min=1).to(torch.float32)[:, None]
    conf = conf_inl.sum(-1).to(torch.float32) / denom
    return _zero_below(fg, min_num, refined), _zero_below(fg, min_num, conf)


def ransac_voting_v4(mask: torch.Tensor, vertex: torch.Tensor,
                     hyp_num: int = 1024, inlier_thresh: float = 0.99,
                     max_num: int = 1024, min_num: int = 5,
                     noise: Optional[torch.Tensor] = None,
                     pair_u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     impl: Optional[str] = None,
                     select_method: str = "stratified"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v3 plus each keypoint's residual variance of the WLS fit over the
    winner's inliers, sum(residual^2) / n_inliers with residual = N p - b
    (ref ransac_voting_gpu.py:669-760); images below ``min_num`` give
    variance 1, as the reference's ones-fill.

    Returns ([b, vn, 2] keypoints, [b, vn] residual variance)."""
    fg, hyps, counts = _vote(mask, vertex, hyp_num, inlier_thresh, max_num,
                             noise, pair_u, generator, impl, select_method)
    refined, inl = _wls_refine(fg, _winner_points(hyps, counts),
                               inlier_thresh)
    w = inl.to(torch.float32)                               # [b, vn, tn]
    normal = torch.stack([fg.dirs[..., 1], -fg.dirs[..., 0]], dim=-1)
    normal = normal.permute(0, 2, 1, 3) * w[..., None]      # [b, vn, tn, 2]
    bscal = (normal * fg.coords[:, None, :, :]).sum(-1)
    residual = (normal * refined[:, :, None, :]).sum(-1) - bscal
    var = (residual * residual).sum(-1) / w.sum(-1).clamp(min=1.0)
    return (_zero_below(fg, min_num, refined),
            _zero_below(fg, min_num, var, fill=1.0))


def ransac_voting_multiclass(mask: torch.Tensor, vertex: torch.Tensor,
                             class_num: int, hyp_num: int = 1024,
                             inlier_thresh: Optional[float] = None,
                             max_num: int = 1024, min_num: int = 5,
                             refine_iter_num: Optional[int] = None,
                             impl: Optional[str] = None,
                             noise: Optional[torch.Tensor] = None,
                             pair_u: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None,
                             select_method: str = "stratified"
                             ) -> torch.Tensor:
    """Multi-class voting: for each class c in 1..class_num-1, vote the
    keypoints of the shared field on the pixels labelled c (ref
    ransac_voting_gpu.py:10-215; a loop over classes of the batched layer,
    one K1 (or K2) and one K3 launch per class).

    Args:
      mask:   [b, h, w] integer labels, 0 = background.
      vertex: [b, vn*2, h, w] channel-major (or [b, h, w, vn, 2] NHWC)
        field shared by the classes; made float32 and contiguous once here.
      refine_iter_num: None votes with v3; an integer with v2 and that many
        refit rounds.
      inlier_thresh: None takes each form's reference default, 0.99 for v3
        and 0.999 for v2.
      noise, pair_u: optional per-class draws [class_num-1, ...] of
        :func:`ransac_voting_v3`'s shapes; else drawn from ``generator``.
      select_method: 'stratified' (kernel K1/K2), or 'topk' (what JAX's
        'auto' picks off the TPU).
    Returns:
      [b, class_num - 1, vn, 2].
    """
    if inlier_thresh is None:
        inlier_thresh = 0.99 if refine_iter_num is None else 0.999
    vertex = vertex.to(torch.float32).contiguous()
    outs = []
    for c in range(1, class_num):
        cls_mask = mask == c
        nz = None if noise is None else noise[c - 1]
        pu = None if pair_u is None else pair_u[c - 1]
        if refine_iter_num is None:
            outs.append(ransac_voting_v3(
                cls_mask, vertex, hyp_num, inlier_thresh, max_num, min_num,
                nz, pu, generator, impl, select_method))
        else:
            outs.append(ransac_voting_v2(
                cls_mask, vertex, hyp_num, inlier_thresh, max_num, min_num,
                refine_iter_num, nz, pu, generator, impl, select_method))
    return torch.stack(outs, dim=1)


def generate_hypotheses_with_counts(
        mask: torch.Tensor, vertex: torch.Tensor, hyp_num: int = 512,
        inlier_thresh: float = 0.99, max_num: int = 1024,
        noise: Optional[torch.Tensor] = None,
        pair_u: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        impl: Optional[str] = None, select_method: str = "stratified"
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw hypotheses and their inlier counts, for the hypothesis scatter
    of a visualization (ref generate_hypothesis,
    ransac_voting_gpu.py:983-1034).

    Returns ([b, hn, vn, 2] hypotheses, [b, hn, vn] int32 counts)."""
    _, hyps, counts = _vote(mask, vertex, hyp_num, inlier_thresh, max_num,
                            noise, pair_u, generator, impl, select_method)
    return hyps, counts


def generate_vanishing_hypotheses(fg: ForegroundSample, hn: int,
                                  pair_u: Optional[torch.Tensor] = None,
                                  generator: Optional[torch.Generator] = None
                                  ) -> torch.Tensor:
    """Homogeneous vanishing-point hypotheses from per-keypoint pixel pairs
    (ref ransac_voting_kernel.cu:170-229): lines l_i = (dy, -dx,
    cy*dx - cx*dy), intersection cross(l0, l1), the sign flipped where
    both rays point away from it, zero where they disagree.

    Args:
      pair_u: optional [b, hn, vn, 2] uniform draws for the pairs.
    Returns [b, hn, vn, 3]."""
    c0, d0, c1, d1 = _per_keypoint_pairs(fg, hn, pair_u, generator)
    dx0, dy0, dx1, dy1 = d0[..., 0], d0[..., 1], d1[..., 0], d1[..., 1]
    cx0, cy0, cx1, cy1 = c0[..., 0], c0[..., 1], c1[..., 0], c1[..., 1]

    lx0, ly0, lz0 = dy0, -dx0, cy0 * dx0 - cx0 * dy0
    lx1, ly1, lz1 = dy1, -dx1, cy1 * dx1 - cx1 * dy1
    x = ly0 * lz1 - lz0 * ly1
    y = lz0 * lx1 - lx0 * lz1
    z = lx0 * ly1 - ly0 * lx1

    val_x0 = dx0 * (x - z * cx0)
    val_x1 = dx1 * (x - z * cx1)
    val_y0 = dy0 * (y - z * cy0)
    val_y1 = dy1 * (y - z * cy1)
    flip = (val_x0 < 0) & (val_x1 < 0) & (val_y0 < 0) & (val_y1 < 0)
    sign = torch.where(flip, -1.0, 1.0)
    bad = (val_x0 * val_x1 < 0) | (val_y0 * val_y1 < 0)
    hyp = torch.stack([x, y, z], dim=-1) * sign[..., None]
    return torch.where(bad[..., None], 0.0, hyp)


def vanishing_inliers_for_points(fg: ForegroundSample, pts: torch.Tensor,
                                 thresh: float) -> torch.Tensor:
    """Inlier mask of the sample's pixels w.r.t. homogeneous points (ref
    ransac_voting_kernel.cu:268-310): diff = (hx - cx*hz, hy - cy*hz);
    both per-axis products with the pixel's direction >= 0 and |cos| >
    thresh. pts [b, hn, vn, 3] -> bool [b, hn, vn, tn]; pts [b, vn, 3] ->
    [b, vn, tn]."""
    squeeze = pts.dim() == 3
    if squeeze:
        pts = pts[:, None]
    cx = fg.coords[:, None, None, :, 0]                     # [b, 1, 1, tn]
    cy = fg.coords[:, None, None, :, 1]
    dx = fg.dirs[..., 0].transpose(1, 2)[:, None]           # [b, 1, vn, tn]
    dy = fg.dirs[..., 1].transpose(1, 2)[:, None]
    hx, hy, hz = (pts[..., i, None] for i in range(3))      # [b, hn, vn, 1]
    diff_x = hx - cx * hz
    diff_y = hy - cy * hz
    n1sq = dx * dx + dy * dy
    n2sq = diff_x * diff_x + diff_y * diff_y
    dot = dx * diff_x + dy * diff_y
    t2 = thresh * thresh
    ok = ((dot * dot > t2 * n1sq * n2sq)
          & (diff_x * dx >= 0) & (diff_y * dy >= 0)
          & (n1sq > _NORM_EPS_SQ) & (n2sq > _NORM_EPS_SQ)
          & fg.valid[:, None, None, :])
    return ok[:, 0] if squeeze else ok


def vanishing_counts(fg: ForegroundSample, hyps: torch.Tensor,
                     thresh: float) -> torch.Tensor:
    """Inlier counts [b, hn, vn] int32 of homogeneous hypotheses
    [b, hn, vn, 3]: :func:`vanishing_inliers_for_points` summed over the
    pixels, _VANISH_CHUNK hypotheses at a time."""
    return torch.cat([
        vanishing_inliers_for_points(fg, hyps[:, s:s + _VANISH_CHUNK], thresh)
        .sum(-1).to(torch.int32)
        for s in range(0, hyps.shape[1], _VANISH_CHUNK)], dim=1)


def ransac_voting_vanish_point(mask: torch.Tensor, vertex: torch.Tensor,
                               hyp_num: int = 1024,
                               inlier_thresh: float = 0.999,
                               max_num: int = 1024, min_num: int = 5,
                               noise: Optional[torch.Tensor] = None,
                               pair_u: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None,
                               select_method: str = "stratified"
                               ) -> torch.Tensor:
    """Vanishing-point RANSAC with a least-squares refine (ref
    ransac_voting_gpu.py:408-501, single class, batched): homogeneous
    hypotheses, their counts by :func:`vanishing_counts`, the winner (unit
    norm), then the smallest eigenvector of H^T H over its inliers, H =
    [-n | n.c] with n = (dy, -dx), by :func:`eigh_small` as in JAX,
    oriented along the inliers' directions. Fewer than 2 inliers keep the
    winner. ``pair_u`` is [b, hyp_num, vn, 2].

    Returns [b, vn, 3] unit homogeneous vanishing points."""
    fg = sample_foreground(mask, vertex, max_num, noise, generator,
                           select_method)
    hyps = generate_vanishing_hypotheses(fg, hyp_num, pair_u, generator)
    counts = vanishing_counts(fg, hyps, inlier_thresh)      # [b, hn, vn]
    hyps = hyps / torch.linalg.vector_norm(
        hyps, dim=-1, keepdim=True).clamp(min=1e-12)
    win = _winner_points(hyps, counts)                      # [b, vn, 3]

    w = vanishing_inliers_for_points(fg, win, inlier_thresh).to(
        torch.float32)                                      # [b, vn, tn]
    nx = fg.dirs[..., 1].transpose(1, 2)                    # n = (dy, -dx)
    ny = -fg.dirs[..., 0].transpose(1, 2)
    nc = nx * fg.coords[:, None, :, 0] + ny * fg.coords[:, None, :, 1]
    Hm = torch.stack([-nx, -ny, nc], dim=-1) * w[..., None]  # [b, vn, tn, 3]
    _, evec = eigh_small(torch.einsum("bvti,bvtj->bvij", Hm, Hm))
    refined = evec[..., 0]                                  # [b, vn, 3]

    # orient along the consensus pixel directions (the reference checks
    # its first inlier's sign, ref :486-487)
    dxs = fg.dirs[..., 0].transpose(1, 2)
    score = (w * dxs * (refined[..., 0:1] - refined[..., 2:3]
                        * fg.coords[:, None, :, 0])).sum(-1)
    refined = refined * torch.where(score < 0, -1.0, 1.0)[..., None]
    out = torch.where((w.sum(-1) >= 2)[..., None], refined, win)
    return _zero_below(fg, min_num, out)


def ransac_voting_center(mask: torch.Tensor, vertex: torch.Tensor,
                         hyp_num: int = 512, inlier_thresh: float = 0.99,
                         max_num: int = 4096, min_num: int = 100,
                         noise: Optional[torch.Tensor] = None,
                         pair_u: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         impl: Optional[str] = None,
                         select_method: str = "stratified"
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Instance-center voting (ref ransac_voting_gpu.py:600-667, as the
    JAX function completes it): vote one center (vn = 1) from a
    center-direction field, then mark the sampled pixels whose rays
    support it, scattered back to the grid by a max.

    Args:
      mask:   [b, h, w] segmentation (nonzero = any instance).
      vertex: [b, 2, h, w] channel-major center-direction field (K1), or
        NHWC [b, h, w, 1, 2] (K2; JAX's [b, h, w, 2] with a keypoint axis).
      min_num: images with fewer foreground pixels give zeros (ref
        :617-622).
    Returns (center [b, 2], instance_mask [b, h, w] float32, win_ratio [b]
    the winner's inlier ratio)."""
    b, h, w = mask.shape
    fg, hyps, counts = _vote(mask, vertex, hyp_num, inlier_thresh, max_num,
                             noise, pair_u, generator, impl, select_method)
    win_pts = _winner_points(hyps, counts)                  # [b, 1, 2]
    win_ratio = counts.amax(dim=1)[:, 0].to(torch.float32) \
        / fg.count.clamp(min=1).to(torch.float32)

    inl = inliers_for_points(fg, win_pts, inlier_thresh)[:, 0]  # [b, tn]
    support = (inl & fg.valid).to(torch.float32)
    flat = (fg.coords[..., 1] * w + fg.coords[..., 0]).to(torch.int64)
    # invalid slots may sit in the selection's padding, outside the grid:
    # send them to pixel 0 with support 0, which a max leaves unchanged
    # (JAX drops out-of-range updates)
    flat = torch.where(fg.valid, flat, 0)
    grid = torch.zeros((b, h * w), dtype=torch.float32, device=mask.device)
    grid = grid.scatter_reduce(1, flat, support, "amax")
    return (_zero_below(fg, min_num, win_pts[:, 0]),
            _zero_below(fg, min_num, grid.reshape(b, h, w)),
            _zero_below(fg, min_num, win_ratio))


def ransac_motion_voting(mask: torch.Tensor, vertex: torch.Tensor,
                         max_num: int = 4096,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None,
                         select_method: str = "stratified") -> torch.Tensor:
    """Offset-field voting without RANSAC: the mean of pixel + offset over
    the sampled foreground (ref ransac_voting_gpu.py:960-981, for a vertex
    field of pixel offsets rather than unit directions). [b, vn, 2]."""
    fg = sample_foreground(mask, vertex, max_num, noise, generator,
                           select_method)
    pts = fg.dirs + fg.coords[:, :, None, :]                # [b, tn, vn, 2]
    wt = fg.valid[:, :, None, None].to(torch.float32)
    denom = fg.count.clamp(min=1).to(torch.float32)[:, None, None]
    return _zero_below(fg, 1, (pts * wt).sum(1) / denom)
