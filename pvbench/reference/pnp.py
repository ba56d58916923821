"""Perspective-n-Point in plain PyTorch, float64: the pose that minimizes
the reprojection error of known 3D keypoints (what PVNet's
``cv2.solvePnP(..., SOLVEPNP_ITERATIVE)`` returns).

Levenberg-Marquardt on (angle-axis, t) with a central-difference Jacobian
refines 48 starts, and the lowest cost wins: the rotation of the direct
linear transform on normalized image points (projected onto SO(3)) turned
by each of the 24 rotations of the cube, and the 24 cube rotations
themselves, each with the keypoints' centroid on the ray through their
image centroid at the depth that their spread in pixels implies. A small
object far from the camera has a mirrored second basin, which a single
start misses, and a noisy transform can put the points behind the camera;
a step that puts any point behind the camera is rejected. The iteration runs to
convergence, so the result is the minimum, whatever the program's own
start (EPnP) and iteration count.
"""
from __future__ import annotations

import torch

F64 = torch.float64


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """[N, 3] angle-axis -> [N, 3, 3]."""
    th = w.norm(dim=-1, keepdim=True)
    k = w / th.clamp(min=1e-12)
    K = torch.zeros(w.shape[:-1] + (3, 3), dtype=w.dtype, device=w.device)
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s, c = torch.sin(th)[..., None], torch.cos(th)[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand_as(K)
    return eye + s * K + (1 - c) * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """[N, 3, 3] rotation -> angle-axis [N, 3] (through the quaternion,
    stable at 0 and pi)."""
    m = R
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    cands = torch.stack([
        torch.stack([1 + t, m[..., 2, 1] - m[..., 1, 2],
                     m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1]], -1),
        torch.stack([m[..., 2, 1] - m[..., 1, 2],
                     1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                     m[..., 0, 1] + m[..., 1, 0],
                     m[..., 0, 2] + m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0],
                     1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                     m[..., 1, 2] + m[..., 2, 1]], -1),
        torch.stack([m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1],
                     1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]], -1)],
        -2)                                                 # [N, 4, 4]
    pick = cands.norm(dim=-1).argmax(-1)
    q = torch.gather(cands, -2, pick[..., None, None].expand(
        *pick.shape, 1, 4))[..., 0, :]
    q = q / q.norm(dim=-1, keepdim=True)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    vec = q[..., 1:]
    s = vec.norm(dim=-1, keepdim=True)
    ang = 2 * torch.atan2(s, q[..., :1])
    return vec / s.clamp(min=1e-15) * ang


def project(pts3d: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
            K: torch.Tensor) -> torch.Tensor:
    """pts3d [n, 3], R [N, 3, 3], t [N, 3] -> pixels [N, n, 2]."""
    cam = pts3d @ R.transpose(-1, -2) + t[:, None]
    uv = cam[..., :2] / cam[..., 2:3]
    return uv * torch.stack([K[0, 0], K[1, 1]]) + torch.stack([K[0, 2],
                                                               K[1, 2]])


def reproj_rms(pts3d, pose, pts2d, K) -> torch.Tensor:
    """RMS pixel distance [N] between pts2d [N, n, 2] and the projection
    of pts3d under poses [N, 3, 4]."""
    pose = pose.to(F64)
    err = project(pts3d.to(F64), pose[:, :, :3], pose[:, :, 3],
                  K.to(F64)) - pts2d.to(F64)
    return (err * err).sum(-1).mean(-1).sqrt()


def dlt(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor):
    """[N] poses from the direct linear transform: (R [N, 3, 3], t)."""
    N, n = pts2d.shape[:2]
    uv = (pts2d - torch.stack([K[0, 2], K[1, 2]])) / torch.stack(
        [K[0, 0], K[1, 1]])
    X = torch.cat([pts3d, torch.ones(n, 1, dtype=F64,
                                     device=pts3d.device)], 1)
    X = X.expand(N, n, 4)
    zero = torch.zeros_like(X)
    A = torch.cat([
        torch.cat([X, zero, -uv[..., :1] * X], -1),
        torch.cat([zero, X, -uv[..., 1:] * X], -1)], 1)     # [N, 2n, 12]
    P = torch.linalg.svd(A).Vh[:, -1].reshape(N, 3, 4)
    U, S, Vh = torch.linalg.svd(P[:, :, :3])
    scale = S.mean(-1)
    R = U @ Vh
    # P is known up to its sign: the sign that makes R proper is the
    # one that puts the points in front of the camera
    sgn = torch.sign(torch.linalg.det(R))
    R = R * sgn[:, None, None]
    t = P[:, :, 3] * (sgn / scale)[:, None]
    return R, t


def _cost(p6, pts3d, pts2d, K):
    R = rodrigues(p6[:, :3])
    err = project(pts3d, R, p6[:, 3:], K) - pts2d
    behind = ((pts3d @ R.transpose(-1, -2))[..., 2] + p6[:, None, 5]
              <= 1e-6).any(-1)
    err = torch.where(behind[:, None, None], torch.inf, err)
    return err.reshape(err.shape[0], -1)


def lm(R0, t0, pts3d, pts2d, K, iters: int = 100) -> tuple:
    """Levenberg-Marquardt from (R0, t0): (poses [N, 3, 4], sum of
    squared pixel errors [N])."""
    p = torch.cat([log_so3(R0), t0], -1)
    r = _cost(p, pts3d, pts2d, K)
    cost = (r * r).sum(-1)
    lam = torch.full_like(cost, 1e-3)
    eps = 1e-7
    eye = torch.eye(6, dtype=F64, device=p.device)
    for _ in range(iters):
        cols = []
        for i in range(6):
            dp = torch.zeros_like(p)
            dp[:, i] = eps
            cols.append((_cost(p + dp, pts3d, pts2d, K)
                         - _cost(p - dp, pts3d, pts2d, K)) / (2 * eps))
        # a start behind the camera has no finite cost: it keeps it
        J = torch.nan_to_num(torch.stack(cols, -1), 0.0, 0.0, 0.0)
        H = J.transpose(1, 2) @ J
        g = (J.transpose(1, 2) @ torch.nan_to_num(r, 0.0, 0.0, 0.0)[
            ..., None])[..., 0]
        D = torch.diag_embed(torch.diagonal(H, dim1=1, dim2=2).clamp(
            min=1e-12))
        step = torch.linalg.solve(H + lam[:, None, None] * D + 1e-12 * eye,
                                  g)
        p_new = p - step
        r_new = _cost(p_new, pts3d, pts2d, K)
        c_new = (r_new * r_new).sum(-1)
        ok = torch.isfinite(c_new) & (c_new < cost)
        r_new = torch.where(ok[:, None], r_new, r)
        p = torch.where(ok[:, None], p_new, p)
        r = r_new
        cost = torch.where(ok, c_new, cost)
        lam = torch.where(ok, lam * 0.3, lam * 4.0).clamp(1e-12, 1e10)
    pose = torch.cat([rodrigues(p[:, :3]), p[:, 3:, None]], -1)
    return pose, cost


def solve(pts3d: torch.Tensor, pts2d: torch.Tensor, K: torch.Tensor
          ) -> torch.Tensor:
    """pts3d [n, 3], pts2d [N, n, 2], K [3, 3] -> poses [N, 3, 4]
    (float64)."""
    pts3d, pts2d, K = pts3d.to(F64), pts2d.to(F64), K.to(F64)
    N = pts2d.shape[0]
    R0, _ = dlt(pts3d, pts2d, K)
    c = pts3d.mean(0)
    # depth from the spread: fx * 3D spread / pixel spread
    spread3 = (pts3d - c).norm(dim=-1).square().mean().sqrt()
    c2 = pts2d.mean(1)                                      # [N, 2]
    spread2 = (pts2d - c2[:, None]).norm(dim=-1).square().mean(-1).sqrt()
    z0 = K[0, 0] * spread3 / spread2.clamp(min=1e-6)
    ray = torch.cat([(c2 - torch.stack([K[0, 2], K[1, 2]])) / torch.stack(
        [K[0, 0], K[1, 1]]), torch.ones_like(c2[:, :1])], -1)
    G = cube_rotations().to(pts3d.device)                  # [24, 3, 3]
    Rs = torch.cat([R0[:, None] @ G, G.expand(N, -1, -1, -1)], 1)
    S = Rs.shape[1]
    ts = (z0[:, None] * ray)[:, None] - Rs @ c              # [N, S, 3]
    poses, costs = lm(Rs.reshape(-1, 3, 3), ts.reshape(-1, 3), pts3d,
                      pts2d.repeat_interleave(S, 0), K)
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    best = costs.reshape(N, S).argmin(1)
    return poses.reshape(N, S, 3, 4)[torch.arange(N), best]


def cube_rotations() -> torch.Tensor:
    """The 24 proper rotations that map the cube onto itself: signed
    permutation matrices of determinant 1, the identity first."""
    out = []
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
                 (2, 1, 0)):
        for signs in ((1, 1, 1), (1, -1, -1), (-1, 1, -1), (-1, -1, 1),
                      (-1, -1, -1), (-1, 1, 1), (1, -1, 1), (1, 1, -1)):
            m = torch.zeros(3, 3, dtype=F64)
            for i, j in enumerate(perm):
                m[i, j] = signs[i]
            if torch.linalg.det(m) > 0:
                out.append(m)
    return torch.stack(out)
