"""The port's gallery (pvnet_tpu_torch/visualize.py) on assets/demo_mini
against the JAX functions that tools/visualize.py's ``run`` calls, with
JAX's own random draws (PRNGKey(0) split in three: the hypotheses with
their counts, v3 voting, the covariance about the voted keypoints), the GT
field at the full 480x640.

JAX's voting runs op by op with its selection forced to 'stratified', as
in tests/test_torch_demo.py; its uncertainty PnP is jitted (no integer
output). Counts must be equal; hypotheses, keypoints and means within
1e-2 px, covariances within 1e-3 of their largest entry or 1e-4 px^2
(chip_smoke.py (k3)'s rule), the pose within 0.05 deg / 1 mm, projected
corners within 1e-2 px."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_demo import (HN, _draws, _jax_fields,  # noqa: F401
                             _pose_close, data, jax_stratified)
from pvnet_tpu import pipeline as JPL
from pvnet_tpu.config import LINEMOD_K
from pvnet_tpu.ops import geometry as JG
from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch import visualize as TVZ

torch.set_num_threads(1)


def test_gallery_math_matches_jax(data, jax_stratified):
    d, mask, vertex = data
    jm, jv = _jax_fields(d)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    hyps_j, counts_j = JV.generate_hypotheses_with_counts(
        jm, jv, k1, hyp_num=HN, max_num=1024)
    kps_j = JV.ransac_voting_v3(jm, jv, k2, hyp_num=HN, max_num=1024)
    mean_j, cov_j = JV.estimate_voting_distribution_with_mean(
        jm, jv, kps_j, k3, max_num=1024)
    with jax.disable_jit(False):
        pose_j = jax.jit(JPL.poses_from_keypoints)(
            jnp.asarray(d["points_3d"]), mean_j, jnp.asarray(LINEMOD_K),
            covar=cov_j)[0]
    h, w = d["mask"].shape
    draws = {}
    for name, k, hn in (("hyp", k1, HN), ("vote", k2, HN),
                        ("cov", k3, 4096)):
        draws[f"{name}_noise"], draws[f"{name}_pair"] = _draws(k, 1, h, w,
                                                               hn)
    out = TVZ.run_gallery(d, mask, vertex, HN, draws=draws)
    np.testing.assert_array_equal(out["counts"], np.asarray(counts_j))
    np.testing.assert_allclose(out["hyps"], np.asarray(hyps_j), atol=1e-2)
    np.testing.assert_allclose(out["kps"], np.asarray(kps_j), atol=1e-2)
    np.testing.assert_allclose(out["mean"], np.asarray(mean_j), atol=1e-2)
    cov_j = np.asarray(cov_j)
    np.testing.assert_allclose(out["cov"], cov_j,
                               atol=max(1e-3 * np.abs(cov_j).max(), 1e-4))
    _pose_close(out["pose"], pose_j)
    corners_j = np.asarray(JG.project(jnp.asarray(d["bb8"]), pose_j,
                                      jnp.asarray(LINEMOD_K)))
    np.testing.assert_allclose(out["corners_pred"], corners_j, atol=1e-2)
