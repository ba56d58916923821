"""Perspective-n-Point: EPnP initialization + Levenberg-Marquardt refine.

PyTorch port of the plain and the uncertainty-weighted PnP of
pvnet_tpu/ops/pnp.py (the functional equivalents of the reference's
``cv2.solvePnP(..., SOLVEPNP_ITERATIVE)``, ref
lib/utils/evaluation_utils.py:19-52, and of its Ceres
``uncertainty_pnp``, ref extend_utils.py:63-114). Every
function takes a leading batch dimension written out where the JAX code
uses ``vmap``; all solvers run in float32 on conditioned (centred /
normalized) points. K is one [3, 3] matrix for the whole batch or one per
problem, [N, 3, 3] (the JAX package's ``*_batch_K`` forms, for per-image
intrinsics), broadcast through the same code.

The LM residual matches the reference's Ceres cost
(ref uncertainty_pnp.cpp:25-31): r = [wxx*dx + wxy*dy, wxy*dx + wyy*dy].
Its Jacobian is taken by forward-mode autodiff (``torch.func.jvp`` over
the six parameter directions), as ``jax.jacfwd`` does in the reference.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from pvnet_tpu_torch.ops.geometry import (inverse_rodrigues, pose_from_Rt,
                                          project, rodrigues,
                                          solve_spd_small)
from pvnet_tpu_torch.ops.smalllinalg import eigh, inv3x3, so3_project

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


def epnp(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
         weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EPnP closed-form pose estimate, batched.

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
    row_u = torch.stack([fx.expand_as(u), zero, px - u], dim=-1)  # [N, n, 3]
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
    dv = _pairwise_dists(V.transpose(-1, -2).reshape(N, 4, 4, 3))  # [N, 4, 6]
    b1 = (dv * dist_w[:, None]).sum(-1) / ((dv * dv).sum(-1) + 1e-12)
    seeds = torch.diag_embed(b1)                            # [N, 4, 4]
    mixed = torch.stack([b1[:, 0]] + [torch.full_like(b1[:, 0], 1e-2)] * 3,
                        dim=-1)
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
    err = project(pts3d[:, None], cands, K if K.ndim == 2 else K[:, None]) \
        - pts2d[:, None]
    costs = (w[:, None] * (err * err).sum(-1)).sum(-1)      # [N, 6]
    costs = torch.where(torch.isnan(costs), torch.inf, costs)
    best = torch.argmin(costs, dim=1)
    return cands[torch.arange(N, device=cands.device), best]


# ---------------------------------------------------------------------------
# Levenberg-Marquardt refinement
# ---------------------------------------------------------------------------

def _residuals(pose6: torch.Tensor, pts3d: torch.Tensor, pts2d: torch.Tensor,
               K: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """Weighted reprojection residuals [N, 2n] of pose6 [N, 6] = (angle-
    axis, t), matching the Ceres cost (ref uncertainty_pnp.cpp:17-33)."""
    R = rodrigues(pose6[:, :3])
    cam = pts3d @ R.transpose(-1, -2) + pose6[:, None, 3:]
    z = cam[..., 2].clamp(min=1e-5)
    fx, fy, px, py = _intrinsics(K)
    proj_x = fx * cam[..., 0] / z + px
    proj_y = fy * cam[..., 1] / z + py
    dx = proj_x - pts2d[..., 0]
    dy = proj_y - pts2d[..., 1]
    r0 = w3[..., 0] * dx + w3[..., 1] * dy
    r1 = w3[..., 1] * dx + w3[..., 2] * dy
    return torch.cat([r0, r1], dim=-1)


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
    N = pose0.shape[0]
    p = torch.cat([inverse_rodrigues(pose0[:, :, :3]), pose0[:, :, 3]], -1)

    def res_fn(q):
        return _residuals(q, pts3d, pts2d, K, w3)

    # forward-mode Jacobian: one jvp per parameter direction (as jacfwd)
    basis = torch.eye(6, dtype=p.dtype, device=p.device)[:, None, :] \
        .expand(6, N, 6)
    jac_cols = torch.func.vmap(
        lambda tan, q: torch.func.jvp(res_fn, (q,), (tan,))[1],
        in_dims=(0, None))
    eye = torch.eye(6, dtype=p.dtype, device=p.device)

    cost = (res_fn(p) ** 2).sum(-1)
    lam = torch.full_like(cost, 1e-3)
    for _ in range(iters):
        r = res_fn(p)                                       # [N, 2n]
        J = jac_cols(basis, p).permute(1, 2, 0)             # [N, 2n, 6]
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


def _lm_multi_start(pose0: torch.Tensor, pts3d: torch.Tensor,
                    pts2d: torch.Tensor, K: torch.Tensor, w3: torch.Tensor,
                    iters: int) -> torch.Tensor:
    """LM from the init plus three 180-degree flips about the object
    centroid; keep the lowest-cost result per problem.

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


def pnp(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor,
        iters: int = 16) -> torch.Tensor:
    """Plain PnP, batched: EPnP init + identity-weight multi-start LM.

    pts3d [N, n, 3], pts2d [N, n, 2], K [3, 3] or [N, 3, 3] -> [N, 3, 4].
    Functional equivalent of the reference's ``pnp()``
    (cv2.SOLVEPNP_ITERATIVE)."""
    w3 = pts3d.new_tensor([1.0, 0.0, 1.0]).expand(pts3d.shape)
    pose0 = epnp(pts3d, pts2d, K)
    return _lm_multi_start(pose0, pts3d, pts2d, K, w3, iters)


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
    return _lm_multi_start(pose0, pts3d, pts2d, K, weights, iters)


def uncertainty_pnp_batch(pts2d: torch.Tensor, weights: torch.Tensor,
                          pts3d: torch.Tensor, K: torch.Tensor,
                          iters: int = 16) -> torch.Tensor:
    """:func:`uncertainty_pnp` for one object's keypoints pts3d [n, 3]
    shared by a batch of observations pts2d [b, n, 2] with weights
    [b, n, 3]; K [3, 3] or [b, 3, 3]. Returns poses [b, 3, 4]."""
    b = pts2d.shape[0]
    return uncertainty_pnp(pts2d, weights, pts3d.expand(b, *pts3d.shape), K,
                           iters)
