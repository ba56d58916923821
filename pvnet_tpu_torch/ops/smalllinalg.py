"""Small-matrix linear algebra for the pose solvers and the voting layers.

PyTorch port of pvnet_tpu/ops/smalllinalg.py. The JAX module builds its
eigendecompositions from a fixed-sweep Jacobi (``eigh_small``) or
``jnp.linalg.eigh`` chosen by backend (``eigh_auto``) to avoid LAPACK
custom calls in exported XLA programs. The port has both forms:

- :func:`eigh` (``torch.linalg.eigh``, batched, ascending eigenvalues),
  which the PnP solvers (ops/pnp.py) use;
- :func:`eigh_small` (cyclic Jacobi with the JAX function's sweep counts)
  and :func:`solve_small` (unrolled elimination with partial pivoting),
  batched plain-tensor functions with no LAPACK call, so they never wait
  on a LAPACK error check. The vanishing-point voting refine
  (ops/voting.py) uses :func:`eigh_small`, as JAX's does.

Eigenvector signs and the order inside a degenerate cluster may differ
between the two eigh forms and from the JAX result, so callers depend on
neither (see ops/pnp.py: EPnP seeds from every null-space vector).
"""
from __future__ import annotations

from typing import Tuple

import torch


def eigh(A: torch.Tensor):
    """Symmetric eigendecomposition of [..., n, n]: (eigenvalues ascending
    [..., n], eigenvectors as columns [..., n, n])."""
    return torch.linalg.eigh(0.5 * (A + A.transpose(-1, -2)))


def _jacobi_sweeps(n: int) -> int:
    """Sweeps of :func:`eigh_small` for an n x n matrix: the JAX module's
    counts (6 reach float32 roundoff for n <= 4, 8 for n <= 9, 10 for
    n <= 12)."""
    if n <= 4:
        return 6
    if n <= 9:
        return 8
    return 10


def eigh_small(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition of small [..., n, n] matrices by cyclic
    Jacobi rotations (port of the JAX ``eigh_small``, batched over the
    leading axes). Returns (eigenvalues ascending [..., n], eigenvectors as
    columns [..., n, n]): ``A @ V[..., :, i] == lam[..., i] * V[..., :, i]``.

    Each rotation is the JAX function's matrix J = I + (c-1)(E_pp + E_qq)
    + s (E_pq - E_qp), applied by matmul (A <- J^T A J, V <- V J), so the
    arithmetic is the reference's up to the order of float32 sums."""
    n = A.shape[-1]
    if A.shape[-2] != n:
        raise ValueError(f"A must be [..., n, n], got {tuple(A.shape)}")
    A = 0.5 * (A + A.transpose(-1, -2))
    batch = A.shape[:-2]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye.expand(*batch, n, n)
    pairs = [(p, q) for p in range(n - 1) for q in range(p + 1, n)]
    consts = []
    for p, q in pairs:
        D = torch.zeros((n, n), dtype=A.dtype, device=A.device)
        X = torch.zeros((n, n), dtype=A.dtype, device=A.device)
        D[p, p] = D[q, q] = 1.0
        X[p, q], X[q, p] = 1.0, -1.0
        consts.append((D, X))
    for _ in range(_jacobi_sweeps(n)):
        for (p, q), (D, X) in zip(pairs, consts):
            # rotation zeroing A'[p, q]: tan(2t) = 2 apq / (aqq - app)
            theta = 0.5 * torch.atan2(2.0 * A[..., p, q],
                                      A[..., q, q] - A[..., p, p])
            c = torch.cos(theta)[..., None, None]
            s = torch.sin(theta)[..., None, None]
            J = eye + (c - 1.0) * D + s * X
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    lam = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.sort(lam, dim=-1, stable=True).indices
    return (torch.gather(lam, -1, order),
            torch.gather(V, -1, order[..., None, :].expand(V.shape)))


def solve_small(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B for small square A [..., n, n] and B [..., n] or
    [..., n, m] by unrolled Gaussian elimination with partial pivoting
    (port of the JAX ``solve_small``, batched over the leading axes): at
    step k the row of largest |pivot| (the first such) at or below k
    swaps with row k, and a pivot under 1e-30 in magnitude is replaced by
    1e-30. B [..., n] gives X [..., n]."""
    n = A.shape[-1]
    if A.shape[-2] != n:
        raise ValueError(f"A must be [..., n, n], got {tuple(A.shape)}")
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B[..., None]
    M = torch.cat([A, B.to(A.dtype)], dim=-1)               # [..., n, n+m]
    rows = torch.arange(n, device=A.device)
    tiny = torch.tensor(1e-30, dtype=A.dtype, device=A.device)
    for k in range(n):
        # partial pivot: swap row k with the max-|pivot| row below it
        piv = k + torch.argmax(M[..., k:, k].abs(), dim=-1)  # [...]
        rk = M[..., k, :]
        rp = torch.gather(M, -2, piv[..., None, None].expand(
            *piv.shape, 1, M.shape[-1]))[..., 0, :]
        is_k = rows == k
        is_p = rows == piv[..., None]                       # [..., n]
        M = torch.where(is_k[:, None], rp[..., None, :],
                        torch.where(is_p[..., None], rk[..., None, :], M))
        mkk = M[..., k, k]
        inv_p = 1.0 / torch.where(mkk.abs() > 1e-30, mkk, tiny)
        factors = M[..., :, k] * inv_p[..., None]
        factors = torch.where(is_k, 0.0, factors)           # keep row k
        M = M - factors[..., :, None] * M[..., k, None, :]
    X = M[..., n:] / torch.diagonal(M[..., :n], dim1=-2, dim2=-1)[..., None]
    return X[..., 0] if vec else X


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det) of [..., 3, 3]."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def so3_project(M: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Nearest rotation to [..., 3, 3] matrices: argmax_R tr(R^T M).

    U diag(1, 1, det(UV^T)) V^T for the SVD M = U S V^T, built from the
    eigendecomposition of M^T M: the two strongest left vectors come from
    M v / s with Gram-Schmidt, and the weakest pair is completed with
    cross products, which bakes in the reflection correction. Invariant to
    the eigenvectors' signs."""
    _, V = eigh(M.transpose(-1, -2) @ M)                    # ascending
    v1, v2 = V[..., :, 1], V[..., :, 2]
    u2 = (M @ v2[..., None])[..., 0]
    u2 = u2 / torch.sqrt((u2 * u2).sum(-1, keepdim=True) + eps)
    u1 = (M @ v1[..., None])[..., 0]
    u1 = u1 - (u1 * u2).sum(-1, keepdim=True) * u2
    n1 = torch.sqrt((u1 * u1).sum(-1, keepdim=True))
    # rank-1 guard: any unit vector orthogonal to u2 (the larger of two
    # candidate crosses, for stability)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=M.dtype, device=M.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=M.dtype, device=M.device)
    alt_a = torch.linalg.cross(u2, ex.expand_as(u2))
    alt_b = torch.linalg.cross(u2, ey.expand_as(u2))
    alt = torch.where((alt_a * alt_a).sum(-1, keepdim=True)
                      > (alt_b * alt_b).sum(-1, keepdim=True), alt_a, alt_b)
    alt = alt / torch.sqrt((alt * alt).sum(-1, keepdim=True) + eps)
    u1 = torch.where(n1 > 1e-6, u1 / torch.sqrt(n1 * n1 + eps), alt)
    u0 = torch.linalg.cross(u1, u2)
    v0 = torch.linalg.cross(v1, v2)

    def outer(u, v):
        return u[..., :, None] * v[..., None, :]
    return outer(u2, v2) + outer(u1, v1) + outer(u0, v0)
