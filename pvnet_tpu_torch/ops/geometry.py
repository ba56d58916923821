"""Pinhole-camera / SO(3) geometry (the subset inference and evaluation
use).

PyTorch port of pvnet_tpu/ops/geometry.py. Every function broadcasts over
leading batch dimensions.
"""
from __future__ import annotations

import torch


def transform_points(pts: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """R @ p + t for pts [..., n, 3] and pose [..., 3, 4]."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def project(pts: torch.Tensor, pose: torch.Tensor, K: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Project 3D points [..., n, 3] with pose [..., 3, 4] and K [..., 3, 3]
    to pixels [..., n, 2] (ref base_utils.py:project_K :289-294)."""
    cam = transform_points(pts, pose)
    z = cam[..., 2:3]
    z = torch.where(z.abs() < eps, torch.where(z < 0, -eps, eps), z)
    uvw = cam @ K.transpose(-1, -2)
    return uvw[..., :2] / z


def find_nearest_point_distance(ref_pts: torch.Tensor, que_pts: torch.Tensor,
                                tile: int = 4096) -> torch.Tensor:
    """For each query point [..., n_que, d], the Euclidean distance to its
    nearest reference point [..., n_ref, d] -> [..., n_que] (ADD-S; the
    reference's brute-force CUDA search, ref nearest_neighborhood.cu).

    Where n_ref > tile the reference axis is walked in tiles of ``tile``
    (the last padded with +inf), so a real LINEMOD mesh never builds an
    [n_que, n_ref] buffer larger than [n_que, tile]."""
    n_ref = ref_pts.shape[-2]
    if n_ref <= tile:
        d2 = ((que_pts[..., :, None, :] - ref_pts[..., None, :, :]) ** 2
              ).sum(-1)
        return torch.sqrt(d2.amin(-1))
    pad = (-n_ref) % tile
    ref_padded = torch.cat(
        [ref_pts, ref_pts.new_full(ref_pts.shape[:-2]
                                   + (pad, ref_pts.shape[-1]), torch.inf)],
        dim=-2)
    best = que_pts.new_full(que_pts.shape[:-1], torch.inf)
    for start in range(0, ref_padded.shape[-2], tile):
        ref_tile = ref_padded[..., start:start + tile, :]
        d2 = ((que_pts[..., :, None, :] - ref_tile[..., None, :, :]) ** 2
              ).sum(-1)
        best = torch.minimum(best, d2.amin(-1))
    return torch.sqrt(best)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Angle-axis [..., 3] -> rotation matrix [..., 3, 3], with Taylor
    fallbacks below theta^2 = 1e-12."""
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(theta_sq.clamp(min=1e-24))
    small = theta_sq < 1e-12
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq.clamp(min=1e-24))
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    Wx = torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wx.shape)
    return eye + a[..., None, None] * Wx + b[..., None, None] * (Wx @ Wx)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z) by Shepperd's method,
    branch-free: the best-conditioned of four constructions is picked."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.sqrt((1.0 + tr).clamp(min=1e-12)) / 2.0
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp(min=1e-12)) / 2.0
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = torch.sqrt((1.0 - m00 + m11 - m22).clamp(min=1e-12)) / 2.0
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = torch.sqrt((1.0 - m00 - m11 + m22).clamp(min=1e-12)) / 2.0
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)

    cand = torch.stack([q0, q1, q2, q3], dim=-2)            # [..., 4, 4]
    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(
        *idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)       # w >= 0


def quaternion_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> angle-axis vector."""
    w = q[..., 0].clamp(-1.0, 1.0)
    xyz = q[..., 1:]
    sin_half = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(sin_half, w)
    small = sin_half < 1e-8
    scale = torch.where(small, 2.0, theta / sin_half.clamp(min=1e-12))
    return xyz * scale[..., None]


def inverse_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> angle-axis [..., 3] (quaternion route,
    stable near theta = 0 and pi)."""
    return quaternion_to_angle_axis(matrix_to_quaternion(R))


def rotation_angle_deg(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (degrees) between rotations
    (ref evaluation_utils.py:cm_degree_5_metric :136-141)."""
    d = R1 @ R2.transpose(-1, -2)
    tr = torch.diagonal(d, dim1=-2, dim2=-1).sum(-1).clamp(max=3.0)
    return torch.rad2deg(torch.arccos(((tr - 1.0) / 2.0).clamp(-1.0, 1.0)))


def pose_from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Stack R [..., 3, 3] and t [..., 3] into [..., 3, 4]."""
    return torch.cat([R, t[..., :, None]], dim=-1)


def inv_sqrtm_2x2(S: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form inverse square root S^{-1/2} [..., 2, 2] of symmetric
    PSD 2x2 matrices S [..., 2, 2], by their eigendecomposition (the
    reference's per-keypoint ``inv(scipy.linalg.sqrtm(cov))``, ref
    evaluation_utils.py:172-179). Eigenvalues are clamped to ``eps``;
    (near-)isotropic matrices take the eigenvector (1, 0)."""
    a = S[..., 0, 0]
    b = 0.5 * (S[..., 0, 1] + S[..., 1, 0])
    d = S[..., 1, 1]
    tr = a + d
    det = a * d - b * b
    gap = torch.sqrt((0.25 * tr * tr - det).clamp(min=0.0))
    l1 = (0.5 * tr + gap).clamp(min=eps)
    l2 = (0.5 * tr - gap).clamp(min=eps)

    # eigenvector of l1: the better-conditioned of (b, l1-a) and (l1-d, b)
    ax = torch.stack([b, l1 - a], dim=-1)
    bx = torch.stack([l1 - d, b], dim=-1)
    v = torch.where(((ax * ax).sum(-1) >= (bx * bx).sum(-1))[..., None],
                    ax, bx)
    n1 = torch.sqrt((v * v).sum(-1))
    iso = n1 < eps
    v1x = torch.where(iso, 1.0, v[..., 0] / n1.clamp(min=eps))
    v1y = torch.where(iso, 0.0, v[..., 1] / n1.clamp(min=eps))
    v2x, v2y = -v1y, v1x

    s1 = 1.0 / torch.sqrt(l1)
    s2 = 1.0 / torch.sqrt(l2)
    m00 = s1 * v1x * v1x + s2 * v2x * v2x
    m01 = s1 * v1x * v1y + s2 * v2x * v2y
    m11 = s1 * v1y * v1y + s2 * v2y * v2y
    return torch.stack([torch.stack([m00, m01], dim=-1),
                        torch.stack([m01, m11], dim=-1)], dim=-2)


def solve_2x2(A: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """Closed-form solve of batched 2x2 systems A [..., 2, 2] x = b [..., 2];
    where |det| < eps the solution is 0."""
    a00, a01 = A[..., 0, 0], A[..., 0, 1]
    a10, a11 = A[..., 1, 0], A[..., 1, 1]
    det = a00 * a11 - a01 * a10
    safe = det.abs() > eps
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, 1.0), 0.0)
    x0 = (a11 * b[..., 0] - a01 * b[..., 1]) * inv_det
    x1 = (-a10 * b[..., 0] + a00 * b[..., 1]) * inv_det
    return torch.stack([x0, x1], dim=-1)


def solve_spd_small(A: torch.Tensor, b: torch.Tensor,
                    eps: float = 1e-10) -> torch.Tensor:
    """Unrolled Cholesky solve of small SPD systems A [..., n, n] x =
    b [..., n].

    Near-rank-deficient systems take a scale-relative pivot floor,
    eps * max(diag A) — a modified-Cholesky guard that keeps the factor
    bounded instead of overflowing to NaN the way an absolute clamp would.
    """
    n = A.shape[-1]
    dmax = torch.diagonal(A, dim1=-2, dim2=-1).amax(-1)
    floor = eps * dmax + 1e-30
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.maximum(s, floor))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)

