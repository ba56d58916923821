"""The port's PnP and geometry against pvnet_tpu.ops.pnp / geometry /
smalllinalg on the cases of tests/test_pnp.py.

PnP is compared by pose, never by eigenvectors: the port's
torch.linalg.eigh and the reference's Jacobi eigh may order and sign the
null-space vectors differently (ROADMAP fault F3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.config import LINEMOD_K
from pvnet_tpu.ops import geometry as JG
from pvnet_tpu.ops import pnp as JP
from pvnet_tpu.ops import smalllinalg as JL
from pvnet_tpu_torch.ops import geometry as TG
from pvnet_tpu_torch.ops import pnp as TP
from pvnet_tpu_torch.ops import smalllinalg as TL
from tests.test_pnp import project_np, random_points, random_pose

torch.set_num_threads(1)

_jit_pnp_batch = jax.jit(JP.pnp_batch)


def _t(x):
    return torch.tensor(np.asarray(x))


def _pose_err(pred, ref):
    ang = TG.rotation_angle_deg(_t(pred)[..., :3], _t(ref)[..., :3]).numpy()
    trans = np.linalg.norm(np.asarray(pred)[..., 3] - np.asarray(ref)[..., 3],
                           axis=-1)
    return ang, trans


def _case(name, rng, b=4):
    """(pts3d [n, 3], pts2d [b, n, 2], gt poses [b, 3, 4])."""
    n = 4 if name == "four_points" else 9
    pts3d = random_points(rng, n=n)
    if name == "planar":
        pts3d[:, 2] = 0.0
    poses = np.stack([random_pose(rng) for _ in range(b)])
    pts2d = np.stack([project_np(pts3d, p, LINEMOD_K) for p in poses])
    if name == "noisy":
        pts2d = pts2d + rng.randn(*pts2d.shape).astype(np.float32)
    return pts3d, pts2d.astype(np.float32), poses


# The tolerance of tests/test_pnp.py:126 (rotation < 0.5 deg, translation
# < 5e-3), held between the two implementations.
@pytest.mark.parametrize("name", ["noisefree", "noisy", "planar",
                                  "four_points"])
def test_pnp_batch_matches_jax(name):
    rng = np.random.RandomState(["noisefree", "noisy", "planar",
                                 "four_points"].index(name))
    pts3d, pts2d, gt = _case(name, rng)
    want = np.asarray(_jit_pnp_batch(jnp.asarray(pts3d), jnp.asarray(pts2d),
                                     jnp.asarray(LINEMOD_K)))
    got = TP.pnp_batch(_t(pts3d), _t(pts2d), _t(LINEMOD_K)).numpy()
    assert got.shape == (4, 3, 4) and np.isfinite(got).all()
    ang, trans = _pose_err(got, want)
    assert ang.max() < 0.5 and trans.max() < 5e-3, (ang, trans)
    if name != "noisy":
        ang, trans = _pose_err(got, gt)
        assert ang.max() < 0.5 and trans.max() < 5e-3, (ang, trans)


@pytest.mark.parametrize("n", [9, 6])
def test_epnp_recovers_pose(n):
    rng = np.random.RandomState(n)
    pts3d = random_points(rng, n=n)
    poses = np.stack([random_pose(rng) for _ in range(5)])
    pts2d = np.stack([project_np(pts3d, p, LINEMOD_K) for p in poses])
    got = TP.epnp(_t(pts3d).expand(5, n, 3), _t(pts2d), _t(LINEMOD_K))
    ang, trans = _pose_err(got, poses)
    assert ang.max() < 1.0 and trans.max() < 0.01, (ang, trans)


def test_lm_refine_reaches_exact_pose_from_perturbed_start():
    rng = np.random.RandomState(3)
    pts3d = random_points(rng)
    poses = np.stack([random_pose(rng) for _ in range(3)])
    pts2d = np.stack([project_np(pts3d, p, LINEMOD_K) for p in poses])
    start = poses.copy()
    start[:, :, 3] += 0.01
    w3 = torch.tensor([1.0, 0.0, 1.0]).expand(3, 9, 3)
    got, cost = TP.lm_refine(_t(start), _t(pts3d).expand(3, 9, 3),
                             _t(pts2d), _t(LINEMOD_K), w3)
    ang, trans = _pose_err(got, poses)
    assert ang.max() < 0.1 and trans.max() < 1e-3
    assert (cost < 1e-2).all()


# ---------------------------------------------------------------------------
# geometry / small linear algebra, elementwise against JAX
# ---------------------------------------------------------------------------

def test_rodrigues_and_inverse_match_jax():
    rng = np.random.RandomState(0)
    w = rng.randn(16, 3)
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * rng.uniform(
        0, 3.0, (16, 1))                                    # angle < pi
    w[0] = 0.0
    w[1] = [1e-7, 0.0, 0.0]
    w = w.astype(np.float32)
    R_t = TG.rodrigues(_t(w))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(JG.rodrigues(w)),
                               atol=2e-6)
    np.testing.assert_allclose(TG.inverse_rodrigues(R_t).numpy(),
                               np.asarray(JG.inverse_rodrigues(
                                   jnp.asarray(R_t.numpy()))), atol=2e-5)
    np.testing.assert_allclose(TG.inverse_rodrigues(R_t).numpy(), w,
                               atol=2e-4)


def test_project_and_pose_from_Rt_match_jax():
    rng = np.random.RandomState(1)
    pts = random_points(rng, n=7)
    pose = random_pose(rng)
    np.testing.assert_allclose(
        TG.project(_t(pts), _t(pose), _t(LINEMOD_K)).numpy(),
        np.asarray(JG.project(pts, pose, LINEMOD_K)), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        TG.pose_from_Rt(_t(pose[:, :3]), _t(pose[:, 3])).numpy(), pose)


def test_small_solvers_match_jax():
    rng = np.random.RandomState(2)
    A2 = rng.randn(5, 2, 2).astype(np.float32)
    A2[0] = [[1.0, 2.0], [2.0, 4.0]]                        # singular -> 0
    b2 = rng.randn(5, 2).astype(np.float32)
    np.testing.assert_allclose(TG.solve_2x2(_t(A2), _t(b2)).numpy(),
                               np.asarray(JG.solve_2x2(A2, b2)), atol=1e-5)
    M = rng.randn(6, 6).astype(np.float32)
    A6 = (M @ M.T + 0.5 * np.eye(6)).astype(np.float32)
    b6 = rng.randn(6).astype(np.float32)
    np.testing.assert_allclose(
        TG.solve_spd_small(_t(A6)[None], _t(b6)[None])[0].numpy(),
        np.asarray(JG.solve_spd_small(A6, b6)), rtol=1e-4, atol=1e-5)
    K = LINEMOD_K.astype(np.float32)
    np.testing.assert_allclose(TL.inv3x3(_t(K)).numpy(),
                               np.asarray(JL.inv3x3(K)), rtol=1e-6)


def test_so3_project_matches_jax():
    rng = np.random.RandomState(3)
    M = rng.randn(8, 3, 3).astype(np.float32)
    got = TL.so3_project(_t(M)).numpy()
    for i in range(8):
        np.testing.assert_allclose(got[i], np.asarray(JL.so3_project(M[i])),
                                   atol=1e-5)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)
    assert (np.linalg.det(got) > 0).all()


def test_inv_sqrtm_2x2_matches_jax():
    rng = np.random.RandomState(4)
    M = rng.randn(12, 2, 2).astype(np.float32)
    S = M @ M.transpose(0, 2, 1) + 1e-3 * np.eye(2, dtype=np.float32)
    S[0] = 2.5 * np.eye(2)                                  # isotropic
    S[1] = 0.0                                              # zero
    S[2] = [[4.0, 0.0], [0.0, 1e-14]]                       # rank one
    S = S.astype(np.float32)
    got = TG.inv_sqrtm_2x2(_t(S)).numpy()
    np.testing.assert_allclose(got, np.asarray(JG.inv_sqrtm_2x2(S)),
                               rtol=1e-5)
    # a well-conditioned S: W S W = I
    np.testing.assert_allclose(got[3:] @ S[3:] @ got[3:],
                               np.broadcast_to(np.eye(2), (9, 2, 2)),
                               atol=2e-3)


_jit_unc_batch = jax.jit(JP.uncertainty_pnp_batch)


@pytest.mark.parametrize("name", ["noisy", "planar"])
def test_uncertainty_pnp_batch_matches_jax(name):
    # by pose (fault F3), with test_pnp.py's tolerance; one keypoint of
    # each problem carries zero weights (a degenerate covariance)
    rng = np.random.RandomState(10 + len(name))
    pts3d, pts2d, gt = _case(name, rng)
    M = rng.randn(4, 9, 2, 2).astype(np.float32)
    cov = M @ M.transpose(0, 1, 3, 2) + 0.1 * np.eye(2, dtype=np.float32)
    W = np.asarray(JG.inv_sqrtm_2x2(cov))
    w3 = np.stack([W[..., 0, 0], W[..., 0, 1], W[..., 1, 1]], -1)
    w3[:, 4] = 0.0
    w3 = w3.astype(np.float32)
    want = np.asarray(_jit_unc_batch(jnp.asarray(pts2d), jnp.asarray(w3),
                                     jnp.asarray(pts3d),
                                     jnp.asarray(LINEMOD_K)))
    got = TP.uncertainty_pnp_batch(_t(pts2d), _t(w3), _t(pts3d),
                                   _t(LINEMOD_K)).numpy()
    assert got.shape == (4, 3, 4) and np.isfinite(got).all()
    ang, trans = _pose_err(got, want)
    assert ang.max() < 0.5 and trans.max() < 5e-3, (ang, trans)
