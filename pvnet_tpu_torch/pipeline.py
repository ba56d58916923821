"""End-to-end inference: image -> FCN -> voting -> PnP.

Port of pvnet_tpu/pipeline.py's ``make_pose_pipeline``: the plain ``run``
path (the full-resolution FCN, selection through K1) and the packed-tail
``run_fused`` path (the decoder's last stages on the half-resolution
packed lattice of ops/packed_tail.py, selection through K2), each with or
without the uncertainty variant (hypothesis covariance, then
uncertainty-weighted PnP). Where the JAX pipeline compiles the whole path
into one XLA program, the port runs it eagerly on one device: the FCN
through PyTorch/cuDNN convolutions, selection and inlier counting through
the port's CUDA kernels, the rest as PyTorch tensor code.

The JAX pipeline's ``impl`` (the inlier count's mode: None float32, 'bf16'
through K3's bf16 mode), ``tail_quant`` (the packed tail's int8 branch) and
``raw_uint8`` (uint8 images, packed and normalized on the device by
:func:`normalize_packed_u8`, for a model with the packed4 stem) are
arguments of the same names here; the model's own int8 stages come with the
model (models/pvnet.build_model's quant options).

Multi-object inference (``make_multiclass_pose_pipeline``): one forward of
a model with seg_dim = C+1, per-class voting over the labelled argmax mask
(ops/voting.ransac_voting_multiclass: K1 and K3 once per class), and one
PnP call over every (image, class) pair.

Data-parallel inference (``make_sharded_pose_pipeline``): over a
parallel.Mesh each rank runs its rows of the global batch through the plain
(K1, K3) or packed (K2, K3) path with its rows of the global batch's draws;
the result is all-gathered, the only collective, as the JAX docstring has
it (voting and PnP are per image).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu_torch.models.resnet import space_to_depth2
from pvnet_tpu_torch.ops import packed_tail
from pvnet_tpu_torch.ops import pnp as pnp_mod
from pvnet_tpu_torch.ops import voting
from pvnet_tpu_torch.ops.geometry import inv_sqrtm_2x2
from pvnet_tpu_torch.parallel.mesh import Mesh, all_gather_rows
from pvnet_tpu_torch.utils.profiling import annotate


class VoteParams(NamedTuple):
    """Voting envelope; the defaults of pvnet_tpu.pipeline.VoteParams
    (512 hypotheses, a 512-pixel foreground budget, 1024 hypotheses for
    the uncertainty path's covariance)."""
    hyp_num: int = 512
    inlier_thresh: float = 0.99
    max_num: int = 512
    min_num: int = 5
    uncertainty_hyp_num: int = 1024


class PoseEstimate(NamedTuple):
    pose: torch.Tensor        # [b, 3, 4]
    kps: torch.Tensor         # [b, vn, 2]
    fg_pixels: torch.Tensor   # [b] int32 foreground pixels of the mask


def _no_grad(fn):
    """``torch.no_grad()`` around ``fn`` where autograd is on; where it is
    already off, no context at all (torch.export would trace the idle
    grad-mode switch into the program, and splitting the graph around it
    costs much of the tracing time)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        with torch.no_grad():
            return fn(*args, **kwargs)
    return wrapper


def _bf16_autocast(device_type: str, enabled: bool):
    """bfloat16 autocast where ``enabled``, else no context at all (an
    idle autocast region would still be traced into an exported
    program)."""
    return (torch.autocast(device_type, dtype=torch.bfloat16) if enabled
            else contextlib.nullcontext())


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """[b, h, w, 3] uint8 -> ImageNet-normalized float32 [b, h, w, 3], on
    the input's device."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.as_tensor(IMAGENET_STD, device=images_u8.device)
    return (images_u8.to(torch.float32) / 255.0 - mean) / std


def normalize_packed_u8(image_u8: torch.Tensor,
                        dtype=torch.float32) -> torch.Tensor:
    """[b, h, w, 3] uint8 -> [b, h/2, w/2, 12] ImageNet-normalized, for
    models built with stem='packed4' (JAX pipeline.normalize_packed_u8).

    The space-to-depth runs on the uint8 image, a quarter of the bytes of
    packing the normalized float image, and the per-channel normalization
    commutes with it exactly (mean and std tiled 4x): the result is
    ``space_to_depth2(normalize_images(image_u8))`` bit for bit. An already
    packed [b, h/2, w/2, 12] input is only normalized."""
    xp = image_u8 if image_u8.shape[-1] == 12 else space_to_depth2(image_u8)
    mean12 = torch.as_tensor(IMAGENET_MEAN, device=xp.device).repeat(4)
    std12 = torch.as_tensor(IMAGENET_STD, device=xp.device).repeat(4)
    return (xp.to(dtype) / 255.0 - mean12.to(dtype)) / std12.to(dtype)


def predict_fields(model: torch.nn.Module, image: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FCN forward: normalized [b, h, w, 3] (or, for a packed4-stem model,
    packed [b, h/2, w/2, 12]) -> (argmax mask [b, h, w], channel-major
    vertex field [b, vn*2, h, w]) (ref train_linemod.py:99-102)."""
    with annotate("fcn"):
        seg, ver = model(image.permute(0, 3, 1, 2).contiguous())
        return torch.argmax(seg, dim=1), ver


def keypoints_from_fields(mask: torch.Tensor, vertex: torch.Tensor,
                          params: VoteParams = VoteParams(),
                          noise: Optional[torch.Tensor] = None,
                          pair_u: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          impl: Optional[str] = None) -> torch.Tensor:
    """v3 voting (ref EvalWrapper :94-106). [b, vn, 2]."""
    return voting.ransac_voting_v3(
        mask, vertex, hyp_num=params.hyp_num,
        inlier_thresh=params.inlier_thresh, max_num=params.max_num,
        min_num=params.min_num, noise=noise, pair_u=pair_u,
        generator=generator, impl=impl)


def keypoints_with_covariance(mask: torch.Tensor, vertex: torch.Tensor,
                              params: VoteParams = VoteParams(),
                              noise: Optional[torch.Tensor] = None,
                              pair_u: Optional[torch.Tensor] = None,
                              cov_noise: Optional[torch.Tensor] = None,
                              cov_pair_u: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None,
                              impl: Optional[str] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uncertainty path: v3 voting, then the hypothesis covariance about
    its keypoints on a second foreground sample (ref
    UncertaintyEvalWrapper :119-130). ``noise``/``pair_u`` are the
    voting's draws, ``cov_noise``/``cov_pair_u`` the covariance pass's.
    Returns (mean [b, vn, 2], cov [b, vn, 2, 2])."""
    mean = keypoints_from_fields(mask, vertex, params, noise, pair_u,
                                 generator, impl)
    return voting.estimate_voting_distribution_with_mean(
        mask, vertex, mean, hyp_num=params.uncertainty_hyp_num,
        inlier_thresh=params.inlier_thresh, max_num=params.max_num,
        noise=cov_noise, pair_u=cov_pair_u, generator=generator, impl=impl)


def poses_from_keypoints(points_3d: torch.Tensor, kps_2d: torch.Tensor,
                         K: torch.Tensor,
                         covar: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Batched pose solve: points_3d [vn, 3], kps_2d [b, vn, 2], K [3, 3]
    or one per image [b, 3, 3] -> [b, 3, 4]. ``covar`` [b, vn, 2, 2]
    selects the uncertainty-weighted solver, weighting each keypoint by
    covar^{-1/2}; keypoints whose covariance is degenerate (var_x < 1e-6)
    or NaN get weight 0."""
    with annotate("pnp"):
        if covar is None:
            return pnp_mod.pnp_batch(points_3d, kps_2d, K)
        W = inv_sqrtm_2x2(covar)
        bad = (covar[..., 0, 0] < 1e-6) \
            | torch.isnan(covar).flatten(-2).any(-1)
        W = torch.where(bad[..., None, None], 0.0, W)
        w3 = torch.stack([W[..., 0, 0], W[..., 0, 1], W[..., 1, 1]], dim=-1)
        return pnp_mod.uncertainty_pnp_batch(kps_2d, w3, points_3d, K)


def fused_tail_foreground(model: torch.nn.Module, image: torch.Tensor,
                          max_num: int, noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None,
                          dtype=torch.bfloat16, tail_depth: int = 1,
                          fcn_bf16: bool = False, tail_quant: bool = False
                          ) -> voting.ForegroundSample:
    """Foreground sample through the packed inference tail.

    Runs the FCN on normalized [b, h, w, 3] images (h, w even; or packed
    [b, h/2, w/2, 12] for a packed4-stem model) to the 2s
    stage (tail_depth=1), the 4s stage (2) or the 8s stage (3), computes
    the rest of the decoder on half-resolution packed lattices
    (ops/packed_tail.py) and samples the packed field directly through
    kernel K2; the full-resolution seg/ver tensors never exist.
    ``noise`` [b, h/2, w/2] is the selection's optional draw. fcn_bf16=True
    runs the FCN stages before the tail under bfloat16 autocast (a bf16
    recipe's model); the tail computes in ``dtype``, with int8 stage
    convolutions when ``tail_quant`` (ops/packed_tail.py)."""
    if tail_depth not in (1, 2, 3):
        raise ValueError(f"tail_depth must be 1, 2 or 3; got {tail_depth}")
    with annotate("fcn"):
        x = image.permute(0, 3, 1, 2).contiguous()
        features = {3: "return_8s_features", 2: "return_4s_features",
                    1: "return_2s_features"}[tail_depth]
        with _bf16_autocast(x.device.type, fcn_bf16):
            fm = model(x, **{features: True})
        if tail_depth == 3:
            fm8, x4s, x2s = fm
            packed, fgcnt = packed_tail.packed_tail_deep3_from_model(
                model, fm8, x4s, x2s, x, dtype=dtype, quant=tail_quant)
        elif tail_depth == 2:
            fm4, x2s = fm
            packed, fgcnt = packed_tail.packed_tail_deep_from_model(
                model, fm4, x2s, x, dtype=dtype, quant=tail_quant)
        else:
            packed, fgcnt = packed_tail.packed_tail_from_model(
                model, fm, x, dtype=dtype, quant=tail_quant)
        return voting.sample_foreground_packed(packed, fgcnt, max_num,
                                               noise, generator)


@_no_grad
def estimate_keypoints(model: torch.nn.Module, images: torch.Tensor,
                       params: VoteParams = VoteParams(),
                       noise: Optional[torch.Tensor] = None,
                       pair_u: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None,
                       uncertainty: bool = False, fused_tail: bool = False,
                       tail_depth: int = 1, tail_dtype=torch.bfloat16,
                       cov_pair_u: Optional[torch.Tensor] = None,
                       cov_noise: Optional[torch.Tensor] = None,
                       fcn_bf16: bool = False, impl: Optional[str] = None,
                       tail_quant: bool = False, raw_uint8: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """Normalized images [b, h, w, 3] (uint8 with raw_uint8) ->
    (keypoints [b, vn, 2], their covariance [b, vn, 2, 2] or None,
    foreground pixels [b] int32): the fields (or the packed tail), voting
    and, with uncertainty, the hypothesis covariance. See
    :func:`estimate_poses` for the options and draws; fcn_bf16=True runs
    the FCN under bfloat16 autocast (a bf16 recipe's model) and votes on
    its output in float32."""
    if raw_uint8:
        images = normalize_packed_u8(images)
    if fused_tail:
        fg = fused_tail_foreground(model, images, params.max_num, noise,
                                   generator, tail_dtype, tail_depth,
                                   fcn_bf16, tail_quant)
        kps = voting.ransac_voting_v3_from_fg(
            fg, params.hyp_num, params.inlier_thresh, params.min_num,
            pair_u, generator, impl)
        cov = None
        if uncertainty:
            _, cov = voting.estimate_voting_distribution_from_fg(
                fg, kps, params.uncertainty_hyp_num, params.inlier_thresh,
                cov_pair_u, generator, impl)
        fg_pixels = fg.total
    else:
        with _bf16_autocast(images.device.type, fcn_bf16):
            mask, vertex = predict_fields(model, images)
        vertex = vertex.float()
        if uncertainty:
            kps, cov = keypoints_with_covariance(
                mask, vertex, params, noise, pair_u, cov_noise, cov_pair_u,
                generator, impl)
        else:
            kps = keypoints_from_fields(mask, vertex, params, noise, pair_u,
                                        generator, impl)
            cov = None
        fg_pixels = (mask != 0).flatten(1).sum(1).to(torch.int32)
    return kps, cov, fg_pixels


@_no_grad
def estimate_poses(model: torch.nn.Module, images: torch.Tensor,
                   points_3d: torch.Tensor, K: torch.Tensor,
                   params: VoteParams = VoteParams(),
                   noise: Optional[torch.Tensor] = None,
                   pair_u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   uncertainty: bool = False, fused_tail: bool = False,
                   tail_depth: int = 1, tail_dtype=torch.bfloat16,
                   cov_pair_u: Optional[torch.Tensor] = None,
                   cov_noise: Optional[torch.Tensor] = None,
                   fcn_bf16: bool = False, impl: Optional[str] = None,
                   tail_quant: bool = False,
                   raw_uint8: bool = False) -> PoseEstimate:
    """The whole slice on normalized images [b, h, w, 3]: fields (or the
    packed tail), voting, optionally the covariance, PnP, plus each
    image's foreground pixel count.

    raw_uint8=True takes uint8 images [b, h, w, 3] (or packed
    [b, h/2, w/2, 12]) for a packed4-stem model and packs and normalizes
    them on their device (:func:`normalize_packed_u8`), as the JAX
    pipeline's option of that name.

    fused_tail=True takes the packed-tail path (``run_fused`` of the JAX
    pipeline) at ``tail_depth`` in {1, 2, 3} and ``tail_dtype``, its stage
    convolutions in int8 with ``tail_quant``; its ``fg_pixels`` is the
    sample's exact full-resolution count. fcn_bf16=True runs the FCN under
    bfloat16 autocast; ``impl`` is the count's mode (None float32, 'bf16').
    Draws, all optional (see ops/voting.py): ``noise`` and ``pair_u`` for
    the voting, ``cov_pair_u`` for the covariance pass, and on the plain
    path, which samples the foreground a second time for it,
    ``cov_noise``."""
    with annotate("estimate"):
        kps, cov, fg_pixels = estimate_keypoints(
            model, images, params, noise, pair_u, generator, uncertainty,
            fused_tail, tail_depth, tail_dtype, cov_pair_u, cov_noise,
            fcn_bf16, impl, tail_quant, raw_uint8)
        pose = poses_from_keypoints(points_3d, kps, K, covar=cov)
        return PoseEstimate(pose, kps, fg_pixels)


def draw_shapes(batch: int, height: int, width: int,
                params: VoteParams, uncertainty: bool,
                fused_tail: bool) -> Dict[str, List[int]]:
    """The random draws of :func:`estimate_poses`, by name, in the order in
    which it takes them from a generator (so also an exported program's
    argument order): the selection noise (on the packed lattice with the
    fused tail), the hypothesis pairs and, with uncertainty, the
    covariance pass's pairs (and, on the plain path, which samples the
    foreground again for it, its noise)."""
    grid = ([batch, height // 2, width // 2] if fused_tail
            else [batch, height, width])
    shapes = {"noise": grid, "pair_u": [batch, params.hyp_num, 2]}
    if uncertainty:
        if not fused_tail:
            shapes["cov_noise"] = grid
        shapes["cov_pair_u"] = [batch, params.uncertainty_hyp_num, 2]
    return shapes


def draw_votes(shapes: Dict[str, List[int]],
               generator: Optional[torch.Generator] = None,
               rows: Optional[int] = None, device=None
               ) -> Dict[str, torch.Tensor]:
    """Uniform float32 draws of :func:`draw_shapes`' ``shapes``, taken from
    ``generator`` in their order as :func:`estimate_poses` takes them, on
    the generator's device (else ``device``); with ``rows`` each is padded
    with zeros to that many rows (a batch padded to a multiple of the
    ranks)."""
    dev = generator.device if generator is not None else device
    out = {}
    for k, s in shapes.items():
        d = torch.rand(s, generator=generator, dtype=torch.float32,
                       device=dev)
        if rows is not None and rows > s[0]:
            d = torch.cat([d, d.new_zeros([rows - s[0]] + list(s[1:]))])
        out[k] = d
    return out


def make_pose_pipeline(model: torch.nn.Module, points_3d, K,
                       params: VoteParams = VoteParams(),
                       uncertainty: bool = False, impl: Optional[str] = None,
                       fused_tail: bool = False, tail_depth: int = 1,
                       tail_dtype=torch.bfloat16, tail_quant: bool = False,
                       raw_uint8: bool = False, fcn_bf16: bool = False,
                       device=None):
    """Build the image -> pose function (the JAX ``run`` closure, or
    ``run_fused`` with fused_tail=True; see :func:`estimate_poses`). The
    JAX function's arguments keep their names and order; fcn_bf16 stands
    for its model dtype, the port's model being float32 under autocast.

    Returns run(images [b, h, w, 3] normalized float32 (uint8 with
    raw_uint8) on the model's device, generator=None) -> (pose [b, 3, 4],
    kps [b, vn, 2]).
    ``generator`` supplies every random draw. The keypoints and K go to
    ``device``, by default the model's."""
    if device is None:
        device = next(model.parameters()).device
    points_3d = torch.as_tensor(np.asarray(points_3d, np.float32),
                                device=device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)

    def run(images: torch.Tensor,
            generator: Optional[torch.Generator] = None):
        est = estimate_poses(model, images, points_3d, K, params,
                             generator=generator, uncertainty=uncertainty,
                             fused_tail=fused_tail, tail_depth=tail_depth,
                             tail_dtype=tail_dtype, fcn_bf16=fcn_bf16,
                             impl=impl, tail_quant=tail_quant,
                             raw_uint8=raw_uint8)
        return est.pose, est.kps

    return run


def estimate_poses_sharded(mesh: Mesh, model: torch.nn.Module,
                           images: torch.Tensor, points_3d: torch.Tensor,
                           K: torch.Tensor,
                           params: VoteParams = VoteParams(),
                           generator: Optional[torch.Generator] = None,
                           draws: Optional[Dict[str, torch.Tensor]] = None,
                           **options) -> PoseEstimate:
    """This rank's share of a global batch: ``images`` are its rows
    [n, h, w, 3] (uint8 or packed with raw_uint8) of a global batch of
    n * mesh.size. The draws are the global batch's, ``draws`` by the
    names of :func:`draw_shapes` or drawn in its order from ``generator``
    (seeded alike on every rank), so that each rank poses its images with
    the draws one process on the whole batch would give them; this rank
    keeps its rows. ``options`` are :func:`estimate_poses`' (uncertainty,
    fused_tail, tail_depth, ...). Returns this rank's rows."""
    n = images.shape[0]
    b = n * mesh.size
    h, w = images.shape[1:3]
    if options.get("raw_uint8") and images.shape[-1] == 12:
        h, w = 2 * h, 2 * w
    shapes = draw_shapes(b, h, w, params, options.get("uncertainty", False),
                         options.get("fused_tail", False))
    if draws is None:
        draws = draw_votes(shapes, generator, device=images.device)
    rows = mesh.rows(b)
    mine = {k: draws[k][rows].to(images.device) for k in shapes}
    return estimate_poses(model, images, points_3d, K, params, **mine,
                          **options)


def make_sharded_pose_pipeline(mesh: Mesh, model: torch.nn.Module,
                               points_3d, K,
                               params: VoteParams = VoteParams(),
                               uncertainty: bool = False,
                               impl: Optional[str] = None,
                               fused_tail: bool = False,
                               tail_depth: int = 1,
                               tail_dtype=torch.bfloat16,
                               tail_quant: bool = False,
                               raw_uint8: bool = False,
                               fcn_bf16: bool = False):
    """Data-parallel :func:`make_pose_pipeline` over ``mesh`` (JAX
    ``make_sharded_pose_pipeline``, the same options): the model replicated
    on each rank's device (parallel.replicate), images split by rows.

    Returns run(images, generator=None, draws=None) -> (pose [B, 3, 4],
    kps [B, vn, 2]) of the whole global batch on every rank: ``images``
    the global batch [B, ...], of which each rank takes its rows; the
    draws as in :func:`estimate_poses_sharded`. Each rank's result is its
    rows of what the unsharded pipeline gives on the whole batch with the
    same draws."""
    device = mesh.device
    points_3d = torch.as_tensor(np.asarray(points_3d, np.float32),
                                device=device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    options = dict(uncertainty=uncertainty, fused_tail=fused_tail,
                   tail_depth=tail_depth, tail_dtype=tail_dtype,
                   fcn_bf16=fcn_bf16, impl=impl, tail_quant=tail_quant,
                   raw_uint8=raw_uint8)

    def run(images: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Dict[str, torch.Tensor]] = None):
        images = torch.as_tensor(images)
        images = images[mesh.rows(images.shape[0])]
        est = estimate_poses_sharded(mesh, model, images.to(device),
                                     points_3d, K, params, generator, draws,
                                     **options)
        return (all_gather_rows(est.pose, mesh),
                all_gather_rows(est.kps, mesh))

    return run


def multiclass_poses_from_keypoints(points_3d_per_class: torch.Tensor,
                                    kps: torch.Tensor,
                                    K: torch.Tensor) -> torch.Tensor:
    """One batched PnP over every (image, class): points_3d_per_class
    [C, vn, 3], kps [b, C, vn, 2], K [3, 3] or one per image [b, 3, 3] ->
    poses [b, C, 3, 4]. (The JAX pipeline stacks C calls of ``pnp_batch``;
    a PnP call costs about as many host-issued operations whatever its
    batch, so one call over b*C problems costs about a C-th.)"""
    b, C, vn, _ = kps.shape
    pts = points_3d_per_class.expand(b, C, vn, 3).reshape(b * C, vn, 3)
    if K.dim() == 3:
        K = K.repeat_interleave(C, dim=0)
    return pnp_mod.pnp(pts, kps.reshape(b * C, vn, 2), K).reshape(
        b, C, 3, 4)


@_no_grad
def estimate_multiclass_poses(model: torch.nn.Module, images: torch.Tensor,
                              points_3d_per_class: torch.Tensor,
                              K: torch.Tensor,
                              params: VoteParams = VoteParams(),
                              refine_iter_num: Optional[int] = None,
                              impl: Optional[str] = None,
                              select_method: str = "stratified",
                              noise: Optional[torch.Tensor] = None,
                              pair_u: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized images [b, h, w, 3] -> (poses [b, C, 3, 4], kps
    [b, C, vn, 2]): :func:`predict_fields` once (labels 0..C), then
    voting.ransac_voting_multiclass (v3 with ``params.inlier_thresh``, or
    v2 with ``refine_iter_num`` rounds at its own 0.999), then
    :func:`multiclass_poses_from_keypoints`. ``noise`` [C, b, ...] and
    ``pair_u`` [C, b, hn, 2] are optional per-class draws."""
    C = points_3d_per_class.shape[0]
    labels, vertex = predict_fields(model, images)
    kps = voting.ransac_voting_multiclass(
        labels, vertex, C + 1, hyp_num=params.hyp_num,
        inlier_thresh=(None if refine_iter_num is not None
                       else params.inlier_thresh),
        max_num=params.max_num, min_num=params.min_num,
        refine_iter_num=refine_iter_num, impl=impl, noise=noise,
        pair_u=pair_u, generator=generator, select_method=select_method)
    return multiclass_poses_from_keypoints(points_3d_per_class, kps, K), kps


def make_multiclass_pose_pipeline(model: torch.nn.Module,
                                  points_3d_per_class, K,
                                  params: VoteParams = VoteParams(),
                                  refine_iter_num: Optional[int] = None,
                                  impl: Optional[str] = None,
                                  select_method: str = "stratified",
                                  device=None):
    """Build the multi-object image -> poses function (the JAX
    ``make_multiclass_pose_pipeline``, its arguments in their order, then
    ``select_method``: 'stratified' through K1, or 'topk', which JAX's
    'auto' picks off the TPU).

    ``model`` emits seg_dim = C+1 logits and one shared vn*2 field
    (data/vertex.compute_vertex_targets_multiclass);
    ``points_3d_per_class`` [C, vn, 3] are the canonical keypoints, class c
    being label c+1. Returns run(images [b, h, w, 3] normalized float32 on
    the model's device, generator=None) -> (poses [b, C, 3, 4], kps
    [b, C, vn, 2]); see :func:`estimate_multiclass_poses`. The keypoints
    and K go to ``device``, by default the model's."""
    if device is None:
        device = next(model.parameters()).device
    pts = torch.as_tensor(np.asarray(points_3d_per_class, np.float32),
                          device=device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)

    def run(images: torch.Tensor,
            generator: Optional[torch.Generator] = None):
        return estimate_multiclass_poses(
            model, images, pts, K, params, refine_iter_num, impl,
            select_method, generator=generator)

    return run
