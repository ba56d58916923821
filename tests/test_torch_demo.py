"""The port's demo (pvnet_tpu_torch/demo.py) on assets/demo_mini against
the JAX functions that tools/demo.py calls, with JAX's own random draws
(PRNGKey(0)), the GT field at the full 480x640 (the gallery:
tests/test_torch_gallery.py).

JAX's voting runs op by op (``jax.disable_jit()``): its compiled counts
may round at the cosine boundary unlike its op-by-op form, which the port
follows (ROADMAP fault F4); its selection is forced to 'stratified' (off
the TPU 'auto' picks top-k; the port selects as the TPU does). Counts must
be equal; keypoints within 1e-2 px, poses within 0.05 deg / 1 mm,
projected corners within 1e-2 px."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu import pipeline as JPL
from pvnet_tpu.config import LINEMOD_K
from pvnet_tpu.ops import geometry as JG
from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch import demo as TD

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "assets", "demo_mini")
HN = 512


# shared with tests/test_torch_gallery.py: the port's read of the demo
# data with its GT fields, tools/demo.py's GT field in JAX's layout, the
# draws one JAX voting call takes from a key, JAX's voting op by op with
# its selection forced to 'stratified', and the pose tolerance

@pytest.fixture(scope="module")
def data():
    """The port's read of the demo data, and its GT fields."""
    d = TD.load_demo(DEMO, "cpu")
    mask, vertex = TD.demo_fields(d, "cpu")
    return d, mask, vertex


@pytest.fixture
def jax_stratified(monkeypatch):
    orig = JV.sample_foreground
    monkeypatch.setattr(JV, "sample_foreground", lambda *a, **k: orig(
        *a, **dict(k, method="stratified")))
    with jax.disable_jit():
        yield


def _jax_fields(d):
    """tools/demo.py:62-74's GT field, NHWC [1, h, w, 9, 2]."""
    mask_gt, gt2d = d["mask"], d["gt2d"]
    ys, xs = np.nonzero(mask_gt)
    pix = np.stack([xs, ys], -1).astype(np.float32)
    vec = gt2d[None] - pix[:, None]
    vec = vec / (np.linalg.norm(vec, axis=-1, keepdims=True) + 1e-9)
    vertex = np.zeros(mask_gt.shape + (9, 2), np.float32)
    vertex[ys, xs] = vec
    return jnp.asarray(mask_gt)[None], jnp.asarray(vertex)[None]


def _draws(key, b, h, w, hn):
    """The (noise, pair uniforms) one voting call draws from ``key``."""
    k1, k2 = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(k1, (b, h, w), jnp.float32))
    pair = np.asarray(jax.random.uniform(k2, (b, hn, 2), jnp.float32))
    return torch.tensor(noise), torch.tensor(pair)


def _pose_close(got, want):
    """Within 0.05 deg and 1 mm. The angle is 2 asin(|R1 - R2|_F / sqrt(8))
    in float64: the arccos of a float32 rotation's trace reads a few
    hundredths of a degree between a rotation and itself."""
    want = np.asarray(want, np.float64)
    chord = np.linalg.norm(got[:, :3].astype(np.float64) - want[:, :3])
    ang = np.degrees(2 * np.arcsin(min(chord / 8 ** 0.5, 1.0)))
    assert ang < 0.05, ang
    assert np.abs(got[:, 3] - want[:, 3]).max() < 1e-3


def test_inputs_equal_the_jax_tools(data):
    from PIL import Image
    d, mask, vertex = data
    rgb = np.array(Image.open(os.path.join(DEMO, "cat.jpg")))
    mask_gt = np.array(Image.open(os.path.join(DEMO, "cat_mask.png"))
                       .convert("1")).astype(np.int32)
    np.testing.assert_array_equal(d["rgb"], rgb)
    np.testing.assert_array_equal(d["mask"], mask_gt)
    jm, jv = _jax_fields(d)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    h, w = mask_gt.shape
    np.testing.assert_array_equal(
        vertex.numpy(), np.asarray(jv).reshape(1, h, w, 18)
        .transpose(0, 3, 1, 2))


def test_demo_math_matches_jax(data, jax_stratified):
    """tools/demo.py's vote_and_solve: ransac_voting_v3 (taken apart into
    its four steps, to hold the counts too), then PnP (jitted: it has no
    integer output, and op by op it takes minutes), the corners
    projected."""
    d, mask, vertex = data
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    jm, jv = _jax_fields(d)
    fg_j = JV.sample_foreground(jm, jv, 1024, k1)
    hyps_j = JV.generate_hypotheses(fg_j, HN, k2)
    counts_j = JV.count_inliers(fg_j, hyps_j, 0.99)
    kps_j = JV.vote_argmax_refine(fg_j, hyps_j, counts_j, 0.99, 5)
    np.testing.assert_array_equal(
        np.asarray(kps_j), np.asarray(JV.ransac_voting_v3(
            jm, jv, key, hyp_num=HN, max_num=1024)))
    with jax.disable_jit(False):
        pose_j = jax.jit(JPL.poses_from_keypoints)(
            jnp.asarray(d["points_3d"]), kps_j, jnp.asarray(LINEMOD_K))[0]
    corners_j = np.asarray(JG.project(jnp.asarray(d["bb8"]), pose_j,
                                      jnp.asarray(LINEMOD_K)))

    noise, pair = _draws(key, 1, *d["mask"].shape, HN)
    fg = TD.voting.sample_foreground(mask, vertex, 1024, noise)
    hyps = TD.voting.generate_hypotheses(fg, HN, pair)
    np.testing.assert_array_equal(
        TD.voting.count_inliers(fg, hyps, 0.99).numpy(),
        np.asarray(counts_j))
    out = TD.run_demo(d, mask, vertex, HN, noise=noise, pair_u=pair)
    np.testing.assert_allclose(out["kps"], np.asarray(kps_j), atol=1e-2)
    _pose_close(out["pose"], pose_j)
    np.testing.assert_allclose(out["corners_pred"], corners_j, atol=1e-2)
    ang, trans, px = TD.pose_errors(out["pose"], d["pose"],
                                    out["corners_pred"], out["corners_gt"])
    assert ang < 0.5 and trans < 0.5 and px < 1.0
