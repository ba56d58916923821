"""End-to-end single-object inference: image -> FCN -> voting -> PnP.

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
through K3's bf16 mode) and ``tail_quant`` (the packed tail's int8 branch)
are arguments of the same names here; the model's own int8 stages come
with the model (models/pvnet.build_model's quant options).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu_torch.ops import packed_tail
from pvnet_tpu_torch.ops import pnp as pnp_mod
from pvnet_tpu_torch.ops import voting
from pvnet_tpu_torch.ops.geometry import inv_sqrtm_2x2


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


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    """[b, h, w, 3] uint8 -> ImageNet-normalized float32 [b, h, w, 3], on
    the input's device."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.as_tensor(IMAGENET_STD, device=images_u8.device)
    return (images_u8.to(torch.float32) / 255.0 - mean) / std


def predict_fields(model: torch.nn.Module, image: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FCN forward: normalized [b, h, w, 3] -> (argmax mask [b, h, w],
    channel-major vertex field [b, vn*2, h, w])
    (ref train_linemod.py:99-102)."""
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
    if covar is None:
        return pnp_mod.pnp_batch(points_3d, kps_2d, K)
    W = inv_sqrtm_2x2(covar)
    bad = (covar[..., 0, 0] < 1e-6) | torch.isnan(covar).flatten(-2).any(-1)
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

    Runs the FCN on normalized [b, h, w, 3] images (h, w even) to the 2s
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
    x = image.permute(0, 3, 1, 2).contiguous()
    features = {3: "return_8s_features", 2: "return_4s_features",
                1: "return_2s_features"}[tail_depth]
    with torch.autocast(x.device.type, dtype=torch.bfloat16,
                        enabled=fcn_bf16):
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
    return voting.sample_foreground_packed(packed, fgcnt, max_num, noise,
                                           generator)


@torch.no_grad()
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
                       tail_quant: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  torch.Tensor]:
    """Normalized images [b, h, w, 3] -> (keypoints [b, vn, 2], their
    covariance [b, vn, 2, 2] or None, foreground pixels [b] int32): the
    fields (or the packed tail), voting and, with uncertainty, the
    hypothesis covariance. See :func:`estimate_poses` for the options and
    draws; fcn_bf16=True runs the FCN under bfloat16 autocast (a bf16
    recipe's model) and votes on its output in float32."""
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
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=fcn_bf16):
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


@torch.no_grad()
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
                   tail_quant: bool = False) -> PoseEstimate:
    """The whole slice on normalized images [b, h, w, 3]: fields (or the
    packed tail), voting, optionally the covariance, PnP, plus each
    image's foreground pixel count.

    fused_tail=True takes the packed-tail path (``run_fused`` of the JAX
    pipeline) at ``tail_depth`` in {1, 2, 3} and ``tail_dtype``, its stage
    convolutions in int8 with ``tail_quant``; its ``fg_pixels`` is the
    sample's exact full-resolution count. fcn_bf16=True runs the FCN under
    bfloat16 autocast; ``impl`` is the count's mode (None float32, 'bf16').
    Draws, all optional (see ops/voting.py): ``noise`` and ``pair_u`` for
    the voting, ``cov_pair_u`` for the covariance pass, and on the plain
    path, which samples the foreground a second time for it,
    ``cov_noise``."""
    kps, cov, fg_pixels = estimate_keypoints(
        model, images, params, noise, pair_u, generator, uncertainty,
        fused_tail, tail_depth, tail_dtype, cov_pair_u, cov_noise, fcn_bf16,
        impl, tail_quant)
    pose = poses_from_keypoints(points_3d, kps, K, covar=cov)
    return PoseEstimate(pose, kps, fg_pixels)


def make_pose_pipeline(model: torch.nn.Module, points_3d, K,
                       params: VoteParams = VoteParams(),
                       uncertainty: bool = False, impl: Optional[str] = None,
                       fused_tail: bool = False, tail_depth: int = 1,
                       tail_dtype=torch.bfloat16, tail_quant: bool = False,
                       fcn_bf16: bool = False, device=None):
    """Build the image -> pose function (the JAX ``run`` closure, or
    ``run_fused`` with fused_tail=True; see :func:`estimate_poses`). The
    JAX function's arguments keep their names and order; fcn_bf16 stands
    for its model dtype, the port's model being float32 under autocast.

    Returns run(images [b, h, w, 3] normalized float32 on the model's
    device, generator=None) -> (pose [b, 3, 4], kps [b, vn, 2]).
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
                             impl=impl, tail_quant=tail_quant)
        return est.pose, est.kps

    return run
