"""The port's LAPACK-free small solvers (eigh_small: cyclic Jacobi;
solve_small: unrolled elimination with partial pivoting) against
pvnet_tpu.ops.smalllinalg and numpy, batched."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.ops import smalllinalg as JS
from pvnet_tpu_torch.ops import smalllinalg as TS

torch.set_num_threads(1)


def _sym(rng, b, n):
    A = rng.randn(b, n, n).astype(np.float32)
    return A + A.transpose(0, 2, 1)


@pytest.mark.parametrize("n", [3, 4, 9, 12])
def test_eigh_small_matches_jax_and_numpy(n):
    A = _sym(np.random.RandomState(n), 4, n)
    lam, V = (x.numpy() for x in TS.eigh_small(torch.tensor(A)))
    jlam, jV = (np.asarray(x) for x in jax.vmap(JS.eigh_small)(
        jnp.asarray(A)))
    scale = np.abs(jlam).max()
    # the same rotations in float32, matmul sums in another order: 1e-5 of
    # the spectrum's scale; eigenvectors up to sign
    np.testing.assert_allclose(lam, jlam, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(np.abs(V), np.abs(jV), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lam, np.linalg.eigvalsh(A), rtol=0,
                               atol=1e-5 * scale)
    assert (np.diff(lam, axis=-1) >= 0).all()
    resid = A @ V - V * lam[:, None, :]
    assert np.abs(resid).max() < 1e-4 * scale
    np.testing.assert_allclose(V.transpose(0, 2, 1) @ V,
                               np.broadcast_to(np.eye(n), V.shape),
                               atol=1e-5)


def test_eigh_small_degenerate_eigenvalues():
    rng = np.random.RandomState(0)
    Q = np.linalg.qr(rng.randn(2, 4, 4))[0]
    A = (Q @ np.diag([2.0, 2.0, 2.0, 5.0]) @ Q.transpose(0, 2, 1)).astype(
        np.float32)
    lam, V = (x.numpy() for x in TS.eigh_small(torch.tensor(A)))
    jlam = np.asarray(jax.vmap(JS.eigh_small)(jnp.asarray(A))[0])
    np.testing.assert_allclose(lam, jlam, rtol=0, atol=1e-5)
    np.testing.assert_allclose(lam, [[2, 2, 2, 5]] * 2, atol=1e-5)
    # inside the repeated cluster only the span is defined: the eigen-
    # equation and orthonormality hold
    assert np.abs(A @ V - V * lam[:, None, :]).max() < 1e-4
    np.testing.assert_allclose(V.transpose(0, 2, 1) @ V,
                               np.broadcast_to(np.eye(4), V.shape), atol=1e-5)


def test_eigh_small_of_a_diagonal_matrix_is_exact():
    A = torch.diag(torch.tensor([3.0, -1.0, 2.0]))
    lam, V = TS.eigh_small(A)
    assert torch.equal(lam, torch.tensor([-1.0, 2.0, 3.0]))
    assert torch.equal(V.abs(), torch.eye(3)[:, [1, 2, 0]])


@pytest.mark.parametrize("n,m", [(3, 1), (4, 5), (9, 2), (12, 1)])
def test_solve_small_matches_jax(n, m):
    rng = np.random.RandomState(10 * n + m)
    A = rng.randn(3, n, n).astype(np.float32) + 2 * np.eye(n,
                                                            dtype=np.float32)
    B = rng.randn(3, n, m).astype(np.float32)
    got = TS.solve_small(torch.tensor(A), torch.tensor(B)).numpy()
    want = np.asarray(jax.vmap(JS.solve_small)(jnp.asarray(A),
                                               jnp.asarray(B)))
    # the same eliminations in the same order: equal to an ulp or two
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.solve(A, B), rtol=1e-3,
                               atol=1e-4)


def test_solve_small_vector_rhs():
    rng = np.random.RandomState(1)
    A = rng.randn(4, 4).astype(np.float32) + 4 * np.eye(4, dtype=np.float32)
    b = rng.randn(4).astype(np.float32)
    got = TS.solve_small(torch.tensor(A), torch.tensor(b)).numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, np.asarray(JS.solve_small(
        jnp.asarray(A), jnp.asarray(b))), rtol=1e-6, atol=1e-6)


def test_solve_small_needs_pivoting():
    # a zero leading pivot: elimination without row swaps divides by 0
    A = np.array([[[0.0, 2.0, 1.0], [1.0, 1.0, 0.0], [3.0, 0.0, 1.0]],
                  [[1e-8, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 2.0, 3.0]]],
                 np.float32)
    B = np.array([[[1.0], [2.0], [3.0]], [[1.0], [0.0], [2.0]]], np.float32)
    got = TS.solve_small(torch.tensor(A), torch.tensor(B)).numpy()
    want = np.asarray(jax.vmap(JS.solve_small)(jnp.asarray(A),
                                               jnp.asarray(B)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.solve(A.astype(np.float64),
                                                    B), rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()
