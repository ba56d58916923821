"""Batched, fixed-shape RANSAC keypoint voting (the inference main path).

PyTorch port of the v3 path of pvnet_tpu/ops/voting.py:

1. Stratified foreground selection (:func:`sample_foreground`): one random
   foreground pixel per spatial phase bucket, through kernel K1
   (channel-major field) or K2 (NHWC field) of ops/select_kernel.py, then
   a stable compaction of the valid slots into a prefix. Selection is
   stratified on every device (the JAX ``method='auto'`` picks top-k off
   the TPU; the port does not). :func:`sample_foreground_packed` selects
   the same way, through K2, on the packed tail's half-resolution field.
2. Shared-pair hypothesis generation (:func:`generate_hypotheses`).
3. Inlier counting (:func:`count_inliers`) in the multiplication-only form
   ``dot > 0 and dot^2 > t^2 |d|^2 |n|^2`` through kernel K3
   (csrc/count_inliers.cu); the [hn, vn, tn] inlier tensor never exists.
   ``impl='bf16'`` counts in bfloat16 instead, through K3's bf16 mode
   (:func:`count_inliers_bf16`, JAX's ``count_inliers_xla_bf16``).
4. Winner argmax + weighted-least-squares refine
   (:func:`vote_argmax_refine`).
5. For the uncertainty path, the hypothesis covariance about the voted
   keypoints (:func:`estimate_voting_distribution_from_fg`, K3 again).

Every function whose JAX twin draws random numbers takes the draws as
optional tensors — ``noise`` for selection ([b, h, w], or [b, HP, WP] on
the packed lattice) and ``pair_u`` [b, hn, 2] for hypothesis pairs — so a
test can feed in JAX's draws and demand exact integer agreement. Without
them the draws come from ``torch.rand`` with the given
``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from pvnet_tpu_torch.ops import kernel_lib
from pvnet_tpu_torch.ops.geometry import solve_2x2
from pvnet_tpu_torch.ops.select_kernel import (stratified_select,
                                               stratified_select_cmajor)

# Guard constants matching the CUDA kernels
# (ref ransac_voting_kernel.cu:42,121).
_DEGENERATE_EPS = 1e-6
_NORM_EPS_SQ = 1e-12


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
                      generator: Optional[torch.Generator] = None
                      ) -> ForegroundSample:
    """Stratified phase-grid selection of up to ``tn`` foreground pixels.

    Partition pixels into tn buckets by phase (y mod a, x mod bb), a*bb =
    tn, and keep in each bucket the foreground pixel with the highest
    uniform-noise score (a uniform pick among that bucket's foreground).
    Port of ``_sample_foreground_stratified``.

    Args:
      mask:   [b, h, w] segmentation (nonzero = foreground).
      vertex: [b, vn*2, h, w] channel-major direction field (selected by
        kernel K1), or [b, h, w, vn, 2] NHWC (kernel K2).
      tn:     fixed pixel budget.
      noise:  optional [b, h, w] uniform draws; drawn from ``generator``
        when absent.
    """
    b, h, w = mask.shape
    cmajor = vertex.dim() == 4
    vn = vertex.shape[1] // 2 if cmajor else vertex.shape[3]
    a, bb = _phase_grid(tn)
    pad_h, pad_w = (-h) % a, (-w) % bb
    fg = mask != 0
    total = fg.reshape(b, h * w).sum(1).to(torch.int32)

    if noise is None:
        noise = uniform((b, h, w), generator, mask.device)
    score = fg.to(torch.float32) * 2.0 + noise
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


def generate_hypotheses(fg: ForegroundSample, hn: int,
                        pair_u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Sample pixel pairs and intersect their voting rays in closed form.

    One pixel pair per hypothesis, shared by every keypoint (the JAX
    ``shared_pairs=True`` form). Degenerate (near-parallel) pairs give the
    (0, 0) hypothesis, like the reference CUDA kernel's early return.

    Args:
      pair_u: optional [b, hn, 2] uniform draws picking the pair's slots.
    Returns:
      [b, hn, vn, 2] hypothesis points.
    """
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

    c0, d0 = gather_pair(idx[..., 0])
    c1, d1 = gather_pair(idx[..., 1])

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
    b, hn, vn, _ = hyps.shape
    win_idx = torch.argmax(counts, dim=1)                   # [b, vn]
    win_pts = torch.gather(hyps, 1, win_idx[:, None, :, None].expand(
        b, 1, vn, 2))[:, 0]                                 # [b, vn, 2]
    refined, _ = _wls_refine(fg, win_pts, inlier_thresh)
    ok = (fg.total >= min_num)[:, None, None]
    return torch.where(ok, refined, torch.zeros_like(refined))


def ransac_voting_v3_from_fg(fg: ForegroundSample, hyp_num: int = 1024,
                             inlier_thresh: float = 0.99, min_num: int = 5,
                             pair_u: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None,
                             impl: Optional[str] = None) -> torch.Tensor:
    """v3 voting from a built foreground sample. [b, vn, 2]. ``impl``
    selects the count (:func:`count_inliers`); the refine is float32
    either way."""
    hyps = generate_hypotheses(fg, hyp_num, pair_u, generator)
    counts = count_inliers(fg, hyps, inlier_thresh, impl)   # [b, hn, vn]
    return vote_argmax_refine(fg, hyps, counts, inlier_thresh, min_num)


def ransac_voting_v3(mask: torch.Tensor, vertex: torch.Tensor,
                     hyp_num: int = 1024, inlier_thresh: float = 0.99,
                     max_num: int = 1024, min_num: int = 5,
                     noise: Optional[torch.Tensor] = None,
                     pair_u: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     impl: Optional[str] = None) -> torch.Tensor:
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

    Returns:
      [b, vn, 2] voted keypoint locations.
    """
    fg = sample_foreground(mask, vertex, max_num, noise, generator)
    return ransac_voting_v3_from_fg(fg, hyp_num, inlier_thresh, min_num,
                                    pair_u, generator, impl)


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
