"""Perspective-n-Point: EPnP initialization + Levenberg-Marquardt refine.

PyTorch port of the plain and the uncertainty-weighted PnP of
pvnet_tpu/ops/pnp.py (the functional equivalents of the reference's
``cv2.solvePnP(..., SOLVEPNP_ITERATIVE)``, ref
lib/utils/evaluation_utils.py:19-52, and of its Ceres
``uncertainty_pnp``, ref extend_utils.py:63-114, with 2x2 weight rows or,
``uncertainty_pnp_v2``, covariances, ref :116-177). Every
function takes a leading batch dimension written out where the JAX code
uses ``vmap``; all solvers run in float32 on conditioned (centred /
normalized) points. K is one [3, 3] matrix for the whole batch or one per
problem, [N, 3, 3] (the JAX package's ``*_batch_K`` forms, for per-image
intrinsics), broadcast through the same code.

The LM residual matches the reference's Ceres cost
(ref uncertainty_pnp.cpp:25-31): r = [wxx*dx + wxy*dy, wxy*dx + wyy*dy].
Its Jacobian with respect to (angle-axis, t) is written out in closed form
(:func:`_residuals_and_jacobian`): what ``jax.jacfwd`` computes in the
reference, in plain tensor operations, so that ``torch.export`` traces it.

EPnP and the multi-start LM are each one registered operator of the
``pvnet_torch`` namespace (``pnp_epnp``, ``pnp_lm``): a CPU tensor runs the
plain functions :func:`epnp_plain` and :func:`lm_multi_start_plain`, a CUDA
tensor launches the hand-written kernel of csrc/pnp.cu (one launch per
operator and call, counted in :func:`epnp`'s and :func:`lm_multi_start`'s
``.launches``, no host synchronization) or raises. Every entry point below
goes through the two operators.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pvnet_tpu_torch.ops import kernel_lib
from pvnet_tpu_torch.ops.geometry import (inverse_rodrigues, pose_from_Rt,
                                          project, rodrigues,
                                          rodrigues_derivative,
                                          solve_spd_small)
from pvnet_tpu_torch.ops.smalllinalg import eigh, inv3x3, so3_project
from pvnet_tpu_torch.utils.profiling import annotate

_PAIR_A = (0, 0, 0, 1, 1, 2)
_PAIR_B = (1, 2, 3, 2, 3, 3)


def _wsum_mean(x: torch.Tensor, w: torch.Tensor, wsum: torch.Tensor):
    """Weighted mean over the point axis: x [N, n, d], w [N, n]."""
    return (x * w[..., None]).sum(-2) / wsum[..., None]


def _repeat(x: torch.Tensor, k: int) -> torch.Tensor:
    """[N, ...] -> [N*k, ...], each problem repeated k times in a row."""
    return x[:, None].expand(x.shape[0], k, *x.shape[1:]).reshape(
        x.shape[0] * k, *x.shape[1:])


def _intrinsics(K: torch.Tensor):
    """(fx, fy, px, py) of K [3, 3] or [N, 3, 3], each shaped to broadcast
    against per-point tensors [N, n]."""
    return (K[..., 0, 0, None], K[..., 1, 1, None], K[..., 0, 2, None],
            K[..., 1, 2, None])


# ---------------------------------------------------------------------------
# EPnP
# ---------------------------------------------------------------------------

def _control_points(pts3d: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Four control points per problem: weighted centroid + principal
    axes. pts3d [N, n, 3], w [N, n] -> [N, 4, 3]."""
    wsum = w.sum(-1) + 1e-9
    c0 = _wsum_mean(pts3d, w, wsum)                         # [N, 3]
    centered = pts3d - c0[:, None]
    cov = (centered * w[..., None]).transpose(-1, -2) @ centered \
        / wsum[:, None, None]
    lam, vec = eigh(cov)                                    # ascending
    # floor eigenvalues relative to the cloud extent so planar / degenerate
    # configurations keep a well-conditioned 4th control point
    lam_floor = 1e-4 * lam.amax(-1, keepdim=True) + 1e-10
    sigma = torch.sqrt(torch.maximum(lam, lam_floor))
    ctrl = c0[:, None] + (vec * sigma[:, None, :]).transpose(-1, -2)
    return torch.cat([c0[:, None], ctrl], dim=1)


def _barycentric(pts3d: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates [N, n, 4] of each point w.r.t. the control
    points [N, 4, 3]."""
    C = torch.cat([ctrl.transpose(-1, -2),
                   torch.ones_like(ctrl[:, None, :, 0])], dim=1)   # [N,4,4]
    X = torch.cat([pts3d.transpose(-1, -2),
                   torch.ones_like(pts3d[:, None, :, 0])], dim=1)  # [N,4,n]
    return torch.linalg.solve(C, X).transpose(-1, -2)


def _pairwise_dists(x: torch.Tensor) -> torch.Tensor:
    """6 pairwise distances between 4 points [..., 4, 3] -> [..., 6]."""
    d = x[..., _PAIR_A, :] - x[..., _PAIR_B, :]
    return torch.sqrt((d * d).sum(-1) + 1e-12)


def _betas_gauss_newton(V: torch.Tensor, dist_w: torch.Tensor,
                        beta0: torch.Tensor, iters: int = 8
                        ) -> torch.Tensor:
    """Refine betas so camera control-point distances match world ones.

    V [N, 12, 4] null-space basis (camera control points = V @ beta),
    dist_w [N, 6], beta0 [N, 4]. Damped, accept-gated Gauss-Newton: on
    near-planar configurations the plain iteration diverges, so rejected
    steps keep the iterate and raise the damping, as in lm_refine."""
    N = V.shape[0]
    Vr = V.transpose(-1, -2).reshape(N, 4, 4, 3)            # [N,basis,ctrl,3]
    dV = Vr[:, :, _PAIR_A, :] - Vr[:, :, _PAIR_B, :]        # [N, 4, 6, 3]
    target = dist_w * dist_w                                # [N, 6]
    eye = torch.eye(4, dtype=V.dtype, device=V.device)

    def residual(beta):
        dc = (beta[:, :, None, None] * dV).sum(1)           # [N, 6, 3]
        return dc, (dc * dc).sum(-1) - target

    beta = beta0
    _, r = residual(beta)
    cost = (r * r).sum(-1)
    lam = torch.full_like(cost, 1e-6)
    for _ in range(iters):
        dc, r = residual(beta)
        J = 2.0 * (dc[:, None] * dV).sum(-1).transpose(-1, -2)  # [N, 6, 4]
        H = J.transpose(-1, -2) @ J
        g = (J.transpose(-1, -2) @ r[..., None])[..., 0]
        dH = torch.diagonal(H, dim1=-2, dim2=-1).clamp(min=1e-12)
        damped = H + lam[:, None, None] * torch.diag_embed(dH) + 1e-12 * eye
        beta_new = beta - solve_spd_small(damped, g)
        _, r_new = residual(beta_new)
        cost_new = (r_new * r_new).sum(-1)
        accept = cost_new < cost                            # False for NaN
        beta = torch.where(accept[:, None], beta_new, beta)
        cost = torch.where(accept, cost_new, cost)
        # near-zero initial damping = pure GN on well-behaved instances;
        # escalate fast once a step diverges
        lam = torch.where(accept, lam * 0.1, lam * 100.0).clamp(1e-12, 1e12)
    return beta


def _procrustes(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rigid (R [N, 3, 3], t [N, 3]) minimizing sum w |R src + t - dst|^2
    (reflection-corrected Kabsch)."""
    wsum = w.sum(-1) + 1e-9
    mu_s = _wsum_mean(src, w, wsum)
    mu_d = _wsum_mean(dst, w, wsum)
    H = ((src - mu_s[:, None]) * w[..., None]).transpose(-1, -2) \
        @ (dst - mu_d[:, None])
    R = so3_project(H.transpose(-1, -2))
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return R, t


def _homography_init(pts3d: torch.Tensor, pts2d: torch.Tensor,
                     K: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Closed-form pose [N, 3, 4] from a plane-to-image homography
    (IPPE-style), for (near-)planar keypoint sets where EPnP degrades.

    Fit the best plane through the points (PCA), estimate the
    plane->pixel homography with a Hartley-normalized weighted DLT and
    decompose K^-1 H into [r1 r2 | t]. On non-planar data the result is
    poor; epnp picks between candidates by reprojection cost."""
    wsum = w.sum(-1) + 1e-9
    c = _wsum_mean(pts3d, w, wsum)                          # [N, 3]
    X0 = pts3d - c[:, None]
    cov = (X0 * w[..., None]).transpose(-1, -2) @ X0
    _, evec = eigh(cov)                                     # ascending
    e2, e1 = evec[..., :, 2], evec[..., :, 1]
    B = torch.stack([e2, e1, torch.linalg.cross(e2, e1)], dim=-1)  # [N,3,3]
    uv = X0 @ B[..., :, :2]                                 # plane coords

    def norm_T(p):
        mu = _wsum_mean(p, w, wsum)
        d = torch.sqrt(((p - mu[:, None]) ** 2).sum(-1) + 1e-12)
        s = math.sqrt(2.0) / ((d * w).sum(-1) / wsum + 1e-12)
        return (p - mu[:, None]) * s[:, None, None], mu, s

    uvn, mu_p, s_p = norm_T(uv)
    imn, mu_i, s_i = norm_T(pts2d)
    x, y = uvn[..., 0], uvn[..., 1]
    u, v = imn[..., 0], imn[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    ru = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    rv = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    sw = torch.sqrt(w)[..., None]
    A = torch.cat([ru * sw, rv * sw], dim=1)                # [N, 2n, 9]
    _, avec = eigh(A.transpose(-1, -2) @ A)
    Hn = avec[..., :, 0].reshape(-1, 3, 3)

    # denormalize: p_img = T_i^-1 Hn T_p, with T(p) = s (p - mu)
    zs, os_ = torch.zeros_like(s_i), torch.ones_like(s_i)
    Ti_inv = torch.stack([
        torch.stack([1.0 / s_i, zs, mu_i[:, 0]], -1),
        torch.stack([zs, 1.0 / s_i, mu_i[:, 1]], -1),
        torch.stack([zs, zs, os_], -1)], dim=-2)
    Tp = torch.stack([
        torch.stack([s_p, zs, -s_p * mu_p[:, 0]], -1),
        torch.stack([zs, s_p, -s_p * mu_p[:, 1]], -1),
        torch.stack([zs, zs, os_], -1)], dim=-2)
    H = Ti_inv @ Hn @ Tp

    M = inv3x3(K).expand_as(H) @ H                          # ~ [r1 r2 | t']
    lam = 1.0 / (torch.sqrt((M[..., :, 0] ** 2).sum(-1)) + 1e-12)
    # cheirality: points must sit in front of the camera (z of t' > 0)
    lam = lam * torch.where(M[..., 2, 2] < 0, -1.0, 1.0)
    r1 = M[..., :, 0] * lam[:, None]
    r2 = M[..., :, 1] * lam[:, None]
    t_pl = M[..., :, 2] * lam[:, None]
    P = so3_project(torch.stack([r1, r2, torch.linalg.cross(r1, r2)], -1))
    R = P @ B.transpose(-1, -2)
    t = t_pl - (R @ c[..., None])[..., 0]
    return pose_from_Rt(R, t)


def epnp_plain(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EPnP closed-form pose estimate, batched, in plain tensor operations
    (any device; :func:`epnp` takes it for CPU tensors).

    Args:
      pts3d: [N, n, 3] world points.
      pts2d: [N, n, 2] pixel observations.
      K:     [3, 3] or [N, 3, 3] intrinsics.
      weights: optional [N, n] non-negative per-point weights.

    Returns:
      [N, 3, 4] pose [R | t].
    """
    N, n, _ = pts2d.shape
    w = torch.ones_like(pts2d[..., 0]) if weights is None else weights
    w = w / (w.amax(-1, keepdim=True) + 1e-12)

    ctrl_w = _control_points(pts3d, w)                      # [N, 4, 3]
    alphas = _barycentric(pts3d, ctrl_w)                    # [N, n, 4]

    fx, fy, px, py = _intrinsics(K)
    u, v = pts2d[..., 0], pts2d[..., 1]
    zero = torch.zeros_like(u)
    # [N, n, 3]
    row_u = torch.stack([fx.expand_as(u), zero, px - u], dim=-1)
    row_v = torch.stack([zero, fy.expand_as(v), py - v], dim=-1)
    sw = torch.sqrt(w)[..., None]
    Mu = (alphas[..., :, None] * row_u[..., None, :]).reshape(N, n, 12)
    Mv = (alphas[..., :, None] * row_v[..., None, :]).reshape(N, n, 12)
    M = torch.cat([Mu * sw, Mv * sw], dim=1)                # [N, 2n, 12]
    _, evec = eigh(M.transpose(-1, -2) @ M)                 # ascending
    V = evec[..., :4]                                       # null basis

    dist_w = _pairwise_dists(ctrl_w)                        # [N, 6]

    # One closed-form beta seed per null-basis vector, plus a mixed one:
    # at n = 4/5 the whole 4-dim basis is near-null and which vector the
    # eigendecomposition puts first is arbitrary, and the beta
    # Gauss-Newton's basin depends on it. The reprojection argmin below
    # arbitrates.
    dv = _pairwise_dists(                                   # [N, 4, 6]
        V.transpose(-1, -2).reshape(N, 4, 4, 3))
    b1 = (dv * dist_w[:, None]).sum(-1) / ((dv * dv).sum(-1) + 1e-12)
    seeds = torch.diag_embed(b1)                            # [N, 4, 4]
    mixed = torch.stack(
        [b1[:, 0]] + [torch.full_like(b1[:, 0], 1e-2)] * 3, dim=-1)
    seeds = torch.cat([seeds, mixed[:, None]], dim=1)       # [N, 5, 4]
    S = seeds.shape[1]

    Vs, dws, als, ws = (_repeat(x, S) for x in (V, dist_w, alphas, w))
    beta = _betas_gauss_newton(Vs, dws, seeds.reshape(N * S, 4))
    ctrl_c = (Vs @ beta[..., None]).reshape(N * S, 4, 3)
    # enforce the rigid scale explicitly: Procrustes below is rotation +
    # translation only, so a residual scale error would corrupt t
    dc = _pairwise_dists(ctrl_c)
    scale = (dc * dws).sum(-1) / ((dc * dc).sum(-1) + 1e-12)
    ctrl_c = ctrl_c * scale[:, None, None]
    # cheirality: weighted mean depth of the reconstructed points
    depths = als @ ctrl_c[..., 2:3]                         # [N*S, n, 1]
    sign = torch.where((depths[..., 0] * ws).sum(-1) < 0, -1.0, 1.0)
    ctrl_c = ctrl_c * sign[:, None, None]
    pts_cam = als @ ctrl_c                                  # [N*S, n, 3]
    R, t = _procrustes(_repeat(pts3d, S), pts_cam, ws)
    pose_seeds = pose_from_Rt(R, t).reshape(N, S, 3, 4)

    pose_h = _homography_init(pts3d, pts2d, K, w)
    cands = torch.cat([pose_seeds, pose_h[:, None]], dim=1)  # [N, 6, 3, 4]
    err = project(pts3d[:, None], cands,
                  K if K.ndim == 2 else K[:, None]) - pts2d[:, None]
    costs = (w[:, None] * (err * err).sum(-1)).sum(-1)      # [N, 6]
    costs = torch.where(torch.isnan(costs), torch.inf, costs)
    best = torch.argmin(costs, dim=1)
    return cands[torch.arange(N, device=cands.device), best]


# ---------------------------------------------------------------------------
# Levenberg-Marquardt refinement
# ---------------------------------------------------------------------------

_Z_MIN = 1e-5


def _weighted(dx: torch.Tensor, dy: torch.Tensor,
              w3: torch.Tensor) -> torch.Tensor:
    """[wxx*dx + wxy*dy, wxy*dx + wyy*dy] over the point axis: [..., 2n]."""
    return torch.cat([w3[..., 0] * dx + w3[..., 1] * dy,
                      w3[..., 1] * dx + w3[..., 2] * dy], dim=-1)


def _residuals(pose6: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
               K: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """Weighted reprojection residuals [N, 2n] of pose6 [N, 6] = (angle-
    axis, t), matching the Ceres cost (ref uncertainty_pnp.cpp:17-33)."""
    R = rodrigues(pose6[:, :3])
    cam = pts3d @ R.transpose(-1, -2) + pose6[:, None, 3:]
    z = cam[..., 2].clamp(min=_Z_MIN)
    fx, fy, px, py = _intrinsics(K)
    proj_x = fx * cam[..., 0] / z + px
    proj_y = fy * cam[..., 1] / z + py
    return _weighted(proj_x - pts2d[..., 0], proj_y - pts2d[..., 1], w3)


def _residuals_and_jacobian(pose6: torch.Tensor, pts3d: torch.Tensor,
                            pts2d: torch.Tensor, K: torch.Tensor,
                            w3: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_residuals` [N, 2n] and their Jacobian [N, 2n, 6] with
    respect to pose6, in closed form: the camera point's derivative is
    (dR/dw_i) X for the rotation (geometry.rodrigues_derivative) and the
    unit vector for the translation; the projection's follows the quotient
    rule, with no depth derivative where the depth is clamped (as
    autodiff of the clamp gives)."""
    N, n, _ = pts3d.shape
    R = rodrigues(pose6[:, :3])
    cam = pts3d @ R.transpose(-1, -2) + pose6[:, None, 3:]  # [N, n, 3]
    dcam_w = pts3d[:, None] @ rodrigues_derivative(
        pose6[:, :3]).transpose(-1, -2)                     # [N, 3, n, 3]
    dcam_t = torch.eye(3, dtype=cam.dtype, device=cam.device)[
        None, :, None, :].expand(N, 3, n, 3)
    dcam = torch.cat([dcam_w, dcam_t], dim=1)               # [N, 6, n, 3]
    zc = cam[..., 2]
    z = zc.clamp(min=_Z_MIN)
    dz = torch.where((zc >= _Z_MIN)[:, None], dcam[..., 2], 0.0)
    fx, fy, px, py = _intrinsics(K)
    proj_x = fx * cam[..., 0] / z + px
    proj_y = fy * cam[..., 1] / z + py
    r = _weighted(proj_x - pts2d[..., 0], proj_y - pts2d[..., 1], w3)
    z1, zz = z[:, None], (z * z)[:, None]                   # [N, 1, n]
    dpx = fx[..., None] * (dcam[..., 0] / z1 - cam[:, None, :, 0] * dz / zz)
    dpy = fy[..., None] * (dcam[..., 1] / z1 - cam[:, None, :, 1] * dz / zz)
    J = _weighted(dpx, dpy, w3[:, None])                    # [N, 6, 2n]
    return r, J.transpose(-1, -2)


def lm_refine(pose0: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
              K: torch.Tensor, w3: torch.Tensor, iters: int = 16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration Levenberg-Marquardt on (angle-axis, t), batched.

    Rejected steps keep the previous iterate and raise the damping,
    accepted steps lower it.

    Args:
      pose0: [N, 3, 4] initial poses.
      w3:    [N, n, 3] per-point (wxx, wxy, wyy) weight-matrix entries.
    Returns:
      ([N, 3, 4] refined poses, [N] final costs).
    """
    p = torch.cat([inverse_rodrigues(pose0[:, :, :3]), pose0[:, :, 3]], -1)

    def res_fn(q):
        return _residuals(q, pts3d, pts2d, K, w3)

    eye = torch.eye(6, dtype=p.dtype, device=p.device)
    cost = (res_fn(p) ** 2).sum(-1)
    lam = torch.full_like(cost, 1e-3)
    for _ in range(iters):
        r, J = _residuals_and_jacobian(p, pts3d, pts2d, K, w3)
        Jt = J.transpose(-1, -2)
        H = Jt @ J
        g = (Jt @ r[..., None])[..., 0]
        dH = torch.diagonal(H, dim1=-2, dim2=-1).clamp(min=1e-9)
        damped = H + lam[:, None, None] * torch.diag_embed(dH)
        step = solve_spd_small(damped + 1e-12 * eye, g)
        p_new = p - step
        cost_new = (res_fn(p_new) ** 2).sum(-1)
        accept = cost_new < cost
        p = torch.where(accept[:, None], p_new, p)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam * 0.33, lam * 3.0).clamp(1e-10, 1e8)
    return pose_from_Rt(rodrigues(p[:, :3]), p[:, 3:]), cost


def lm_multi_start_plain(pose0: torch.Tensor, pts3d: torch.Tensor,
                         pts2d: torch.Tensor, K: torch.Tensor,
                         w3: torch.Tensor, iters: int) -> torch.Tensor:
    """LM from the init plus three 180-degree flips about the object
    centroid; keep the lowest-cost result per problem. Plain tensor
    operations (any device; :func:`lm_multi_start` takes it for CPU
    tensors).

    Near-planar keypoint sets admit a two-fold pose ambiguity that traps a
    single start in the wrong basin; each flip keeps the centroid's camera
    position (t' = t + (R - R')c)."""
    N = pose0.shape[0]
    c = pts3d.mean(dim=1)                                   # [N, 3]
    R0, t0 = pose0[:, :, :3], pose0[:, :, 3]
    flips = torch.diag_embed(torch.tensor(
        [[1.0, 1.0, 1.0], [1.0, -1.0, -1.0], [-1.0, 1.0, -1.0],
         [-1.0, -1.0, 1.0]], dtype=pose0.dtype, device=pose0.device))
    Rs = R0[:, None] @ flips                                # [N, 4, 3, 3]
    ts = (t0 + (R0 @ c[..., None])[..., 0])[:, None] \
        - (Rs @ c[:, None, :, None])[..., 0]                # [N, 4, 3]
    cands = torch.cat([Rs, ts[..., None]], dim=-1).reshape(N * 4, 3, 4)
    poses, costs = lm_refine(cands, _repeat(pts3d, 4), _repeat(pts2d, 4),
                             K if K.ndim == 2 else _repeat(K, 4),
                             _repeat(w3, 4), iters)
    best = torch.argmin(costs.reshape(N, 4), dim=1)
    return poses.reshape(N, 4, 3, 4)[torch.arange(N, device=poses.device),
                                     best]


def identity_w3(pts3d: torch.Tensor) -> torch.Tensor:
    """The LM's identity weight rows (1, 0, 1) for every point of pts3d
    [N, n, 3], as [N, n, 3] (a view of one host-made row)."""
    return pts3d.new_tensor([1.0, 0.0, 1.0]).expand(pts3d.shape)


# ---------------------------------------------------------------------------
# The registered operators: the CPU implementation is the plain version, the
# CUDA one launches the kernel of csrc/pnp.cu (counted on the wrapper's
# ``.launches``) or raises, the fake one gives export's tracer the shape.
# ---------------------------------------------------------------------------

# points a problem the kernels take (csrc/pnp.cu: pnp::NMAX)
KERNEL_MAX_POINTS = 32


def _per_problem(t: torch.Tensor, N: int, shape) -> Tuple[torch.Tensor, int]:
    """t broadcast to [N, *shape]: a tensor whose problem i starts i * stride
    elements after its first, and that stride (0 where the batch shares one
    contiguous block, as pnp_batch's keypoints and one K are)."""
    t = t.expand(N, *shape)
    if N == 0 or t.stride(0) == 0 and t.select(0, 0).is_contiguous():
        return t, 0
    return t.contiguous(), t.select(0, 0).numel()


def _kernel_inputs(pts3d, pts2d, K, *rows):
    """Check what the kernels take and lay it out for them: (pts3d, its
    batch stride, pts2d, K, its batch stride, *rows contiguous or None)."""
    tensors = [pts3d, pts2d, K] + [r for r in rows if r is not None]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the PnP kernels take float32 tensors; got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if any(t.device != pts2d.device for t in tensors):
        raise ValueError("the PnP kernels' tensors must share one device")
    N, n = pts2d.shape[:2]
    if not 1 <= n <= KERNEL_MAX_POINTS:
        raise ValueError(f"the PnP kernels take 1 to {KERNEL_MAX_POINTS} "
                         f"points a problem; got {n}")
    pts3d, s3 = _per_problem(pts3d, N, (n, 3))
    K, sK = _per_problem(K, N, (3, 3))
    return (pts3d, s3, pts2d.contiguous(), K, sK,
            *(None if r is None else r.contiguous() for r in rows))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@torch.library.custom_op(f"{kernel_lib.NAMESPACE}::pnp_epnp",
                         mutates_args=(), device_types="cpu")
def _epnp_op(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
             weights: Optional[torch.Tensor]) -> torch.Tensor:
    return epnp_plain(pts3d, pts2d, K, weights)


@_epnp_op.register_kernel("cuda")
def _epnp_cuda(pts3d, pts2d, K, weights):
    pts3d, s3, pts2d, K, sK, weights = _kernel_inputs(pts3d, pts2d, K,
                                                      weights)
    N, n = pts2d.shape[:2]
    out = pts2d.new_empty((N, 3, 4))
    if N == 0:
        return out
    kernel_lib.launch("pvnet_pnp_epnp", pts2d.device, pts3d.data_ptr(), s3,
                      pts2d.data_ptr(), K.data_ptr(), sK, _ptr(weights),
                      out.data_ptr(), N, n)
    epnp.launches += 1
    return out


@_epnp_op.register_fake
def _epnp_fake(pts3d, pts2d, K, weights):
    return pts2d.new_empty((pts2d.shape[0], 3, 4))


@torch.library.custom_op(f"{kernel_lib.NAMESPACE}::pnp_lm",
                         mutates_args=(), device_types="cpu")
def _lm_op(pose0: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
           K: torch.Tensor, w3: Optional[torch.Tensor],
           iters: int) -> torch.Tensor:
    return lm_multi_start_plain(pose0, pts3d, pts2d, K,
                                identity_w3(pts3d) if w3 is None else w3,
                                iters)


@_lm_op.register_kernel("cuda")
def _lm_cuda(pose0, pts3d, pts2d, K, w3, iters):
    pts3d, s3, pts2d, K, sK, w3, pose0 = _kernel_inputs(pts3d, pts2d, K, w3,
                                                        pose0)
    N, n = pts2d.shape[:2]
    out = pose0.new_empty((N, 3, 4))
    if N == 0:
        return out
    kernel_lib.launch("pvnet_pnp_lm", pose0.device, pose0.data_ptr(),
                      pts3d.data_ptr(), s3, pts2d.data_ptr(), K.data_ptr(),
                      sK, _ptr(w3), out.data_ptr(), N, n, iters)
    lm_multi_start.launches += 1
    return out


@_lm_op.register_fake
def _lm_fake(pose0, pts3d, pts2d, K, w3, iters):
    return pose0.new_empty((pose0.shape[0], 3, 4))


def _check_problems(pts3d, pts2d, K, **rows):
    if pts2d.dim() != 3 or pts2d.shape[-1] != 2:
        raise ValueError(f"pts2d must be [N, n, 2]; got {tuple(pts2d.shape)}")
    N, n = pts2d.shape[:2]
    shapes = {"pts3d": (pts3d, (N, n, 3)), **{
        name: (t, (N, n, 3) if name == "w3" else
               (N, 3, 4) if name == "pose0" else (N, n))
        for name, t in rows.items() if t is not None}}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}; got "
                             f"{tuple(t.shape)}")
    if tuple(K.shape) not in ((3, 3), (N, 3, 3)):
        raise ValueError(f"K must be [3, 3] or [{N}, 3, 3]; got "
                         f"{tuple(K.shape)}")
    kernel_lib.check_device(pts2d)


def epnp(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EPnP closed-form pose estimate, batched (:func:`epnp_plain`'s
    arguments and result: pts3d [N, n, 3], pts2d [N, n, 2], K [3, 3] or
    [N, 3, 3], optional weights [N, n] -> [N, 3, 4]).

    Calls the operator ``pvnet_torch::pnp_epnp``: a CPU tensor runs
    :func:`epnp_plain`, a CUDA tensor launches the kernel (float32, n up to
    :data:`KERNEL_MAX_POINTS`; counted in ``.launches``) or raises."""
    _check_problems(pts3d, pts2d, K, weights=weights)
    with annotate("pnp.epnp"):
        return torch.ops.pvnet_torch.pnp_epnp(pts3d, pts2d, K, weights)


epnp.launches = 0


def lm_multi_start(pose0: torch.Tensor, pts3d: torch.Tensor,
                   pts2d: torch.Tensor, K: torch.Tensor,
                   w3: Optional[torch.Tensor], iters: int) -> torch.Tensor:
    """:func:`lm_multi_start_plain` from pose0 [N, 3, 4]: 4 starts of
    ``iters`` LM iterations each, weight rows w3 [N, n, 3] or None for the
    identity (1, 0, 1); the lowest-cost pose [N, 3, 4].

    Calls the operator ``pvnet_torch::pnp_lm``: a CPU tensor runs the plain
    version, a CUDA tensor launches the kernel (as :func:`epnp`; counted in
    ``.launches``) or raises."""
    _check_problems(pts3d, pts2d, K, pose0=pose0, w3=w3)
    with annotate("pnp.lm"):
        return torch.ops.pvnet_torch.pnp_lm(pose0, pts3d, pts2d, K, w3,
                                            iters)


lm_multi_start.launches = 0


def pnp(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
        iters: int = 16) -> torch.Tensor:
    """Plain PnP, batched: EPnP init + identity-weight multi-start LM.

    pts3d [N, n, 3], pts2d [N, n, 2], K [3, 3] or [N, 3, 3] -> [N, 3, 4].
    Functional equivalent of the reference's ``pnp()``
    (cv2.SOLVEPNP_ITERATIVE)."""
    pose0 = epnp(pts3d, pts2d, K)
    return lm_multi_start(pose0, pts3d, pts2d, K, None, iters)


def pnp_batch(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
              iters: int = 16) -> torch.Tensor:
    """One object's keypoints pts3d [n, 3] shared by a batch of
    observations pts2d [b, n, 2]; K [3, 3] or one per image [b, 3, 3].
    Returns poses [b, 3, 4]."""
    b = pts2d.shape[0]
    return pnp(pts3d.expand(b, *pts3d.shape), pts2d, K, iters)


def uncertainty_pnp(pts2d: torch.Tensor, weights: torch.Tensor,
                    pts3d: torch.Tensor, K: torch.Tensor, iters: int = 16
                    ) -> torch.Tensor:
    """Uncertainty-weighted PnP, batched (ref extend_utils.py:63-114).

    Args:
      pts2d:   [N, n, 2] voted keypoint means.
      weights: [N, n, 3] (wxx, wxy, wyy) rows of the 2x2 weight matrices,
        typically inv_sqrtm_2x2 of the voting covariance (ref
        evaluation_utils.py:172-181); degenerate keypoints carry zeros.
      pts3d:   [N, n, 3] canonical 3D keypoints.
      K:       [3, 3] or [N, 3, 3].
    Returns [N, 3, 4]: EPnP weighted by each matrix's trace, then the
    weighted multi-start LM."""
    pose0 = epnp(pts3d, pts2d, K, weights=weights[..., 0] + weights[..., 2])
    return lm_multi_start(pose0, pts3d, pts2d, K, weights, iters)


def uncertainty_pnp_batch(pts2d: torch.Tensor, weights: torch.Tensor,
                          pts3d: torch.Tensor, K: torch.Tensor,
                          iters: int = 16) -> torch.Tensor:
    """:func:`uncertainty_pnp` for one object's keypoints pts3d [n, 3]
    shared by a batch of observations pts2d [b, n, 2] with weights
    [b, n, 3]; K [3, 3] or [b, 3, 3]. Returns poses [b, 3, 4]."""
    b = pts2d.shape[0]
    return uncertainty_pnp(pts2d, weights, pts3d.expand(b, *pts3d.shape), K,
                           iters)


def uncertainty_pnp_v2(pts2d: torch.Tensor, covars: torch.Tensor,
                       pts3d: torch.Tensor, K: torch.Tensor, iters: int = 16
                       ) -> torch.Tensor:
    """Covariance-input uncertainty PnP, batched (ref
    extend_utils.py:116-177): each keypoint weighted by the scalar
    1 / lambda_max of its covariance (0 where var_x < 1e-5), EPnP with
    those weights, then the multi-start LM with isotropic weight rows.

    pts2d [N, n, 2], covars [N, n, 2, 2], pts3d [N, n, 3], K [3, 3] or
    [N, 3, 3] -> [N, 3, 4]."""
    wscalar, w3 = covariance_weights(covars)
    pose0 = epnp(pts3d, pts2d, K, weights=wscalar)
    return lm_multi_start(pose0, pts3d, pts2d, K, w3, iters)


def covariance_weights(covars: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`uncertainty_pnp_v2`'s weights of covariances [..., 2, 2]:
    the scalar 1 / lambda_max (0 where var_x < 1e-5) [...] and its
    isotropic weight rows (w, 0, w) [..., 3]."""
    a = covars[..., 0, 0]
    b = 0.5 * (covars[..., 0, 1] + covars[..., 1, 0])
    d = covars[..., 1, 1]
    gap = torch.sqrt(torch.clamp(0.25 * (a - d) * (a - d) + b * b, min=0.0))
    lam_max = 0.5 * (a + d) + gap
    wscalar = torch.where(a < 1e-5, 0.0,
                          1.0 / torch.clamp(lam_max, min=1e-12))
    w3 = torch.stack([wscalar, torch.zeros_like(wscalar), wscalar], dim=-1)
    return wscalar, w3


def uncertainty_pnp_v2_batch(pts2d: torch.Tensor, covars: torch.Tensor,
                             pts3d: torch.Tensor, K: torch.Tensor,
                             iters: int = 16) -> torch.Tensor:
    """:func:`uncertainty_pnp_v2` for one object's keypoints pts3d [n, 3]
    shared by a batch of observations pts2d [b, n, 2] with covariances
    [b, n, 2, 2]; K [3, 3] or [b, 3, 3]. Returns poses [b, 3, 4]."""
    b = pts2d.shape[0]
    return uncertainty_pnp_v2(pts2d, covars, pts3d.expand(b, *pts3d.shape),
                              K, iters)
