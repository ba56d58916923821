"""The port's other voting layers (top-k selection, per-keypoint pairs,
v2, v4, v5, the distribution without a mean, hypotheses with counts, the
vanishing point, center and motion voting) and the covariance PnP against
pvnet_tpu's, fed the same fields and JAX's own random draws.

JAX's layers run op by op (``jax.disable_jit()``): its compiled counts,
the XLA scan and the Pallas kernel in interpret mode alike, may round at
the cosine boundary unlike its op-by-op form, which the port follows
(ROADMAP fault F4). Integer results (selections, counts) must be equal;
float results carry the tolerance stated at each test."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.ops import pnp as JP
from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch.ops import pnp as TP
from pvnet_tpu_torch.ops import voting as TV
from tests.test_voting import BOX, KPTS, make_field

torch.set_num_threads(1)
H = W = 96
HN, TN = 128, 256


@pytest.fixture
def jax_op_by_op():
    with jax.disable_jit():
        yield


def _batch(noise=0.03, outlier_frac=0.2, seed=0, keypoints=KPTS, box=BOX):
    """mask [2, H, W] and NHWC field [2, H, W, vn, 2]: image 0 noisy, image
    1 a shifted copy."""
    rng = np.random.RandomState(seed)
    masks, fields = [], []
    for shift in (0, 4):
        bx = (box[0] + shift, min(box[1] + shift, H), box[2],
              min(box[3] + shift, W))
        m, v = make_field(H, W, keypoints + shift, bx, noise=noise, rng=rng,
                          outlier_frac=outlier_frac)
        masks.append(m)
        fields.append(v)
    return np.stack(masks), np.stack(fields)


def _cmajor(field):
    b, h, w, vn, _ = field.shape
    return np.ascontiguousarray(field.reshape(b, h, w, 2 * vn)
                                .transpose(0, 3, 1, 2))


def _draws(key, b, hn, method, vn=None):
    """JAX's draws of a layer: (selection noise from k1, pair uniforms from
    k2), shared pairs unless ``vn`` is given."""
    k1, k2 = jax.random.split(key)
    shape = (b, H, W) if method == "stratified" else (b, H * W)
    noise = np.asarray(jax.random.uniform(k1, shape, jnp.float32))
    pshape = (b, hn, 2) if vn is None else (b, hn, vn, 2)
    pair = np.asarray(jax.random.uniform(k2, pshape, jnp.float32))
    return torch.tensor(noise), torch.tensor(pair)


def _t(x):
    return torch.tensor(np.asarray(x))


# --- selection -------------------------------------------------------------

@pytest.mark.parametrize("tn,layout", [(256, "cmajor"), (1024, "nhwc"),
                                       (100, "cmajor")])
def test_topk_selection_matches_jax(jax_op_by_op, tn, layout):
    mask, field = _batch(seed=1)
    key = jax.random.PRNGKey(tn)
    want = JV.sample_foreground(jnp.asarray(mask), jnp.asarray(field), tn,
                                key, method="topk")
    noise = jax.random.uniform(key, (2, H * W), jnp.float32)
    vert = _cmajor(field) if layout == "cmajor" else field
    got = TV.sample_foreground(_t(mask), _t(vert), tn, noise=_t(noise),
                               method="topk", exact_topk=True)
    for name in ("coords", "dirs", "valid", "count", "total"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    n = int(got.count[0])
    assert got.valid[0, :n].all() and not got.valid[0, n:].any()


def test_topk_ties_take_the_lower_index_first():
    # a tie-heavy noise map: 4 distinct values, so thousands of equal
    # scores; lax.top_k puts the lower index first
    mask, field = _batch(seed=2)
    rng = np.random.RandomState(0)
    noise = (rng.randint(0, 4, (2, H * W)) * 2.0 ** -23).astype(np.float32)
    score = (mask.reshape(2, -1) != 0) * 2.0 + noise
    _, want_idx = jax.lax.top_k(jnp.asarray(score, jnp.float32), 512)
    want_idx = np.asarray(want_idx)
    got = TV.sample_foreground(_t(mask), _t(_cmajor(field)), 512,
                               noise=_t(noise), method="topk")
    xy = got.coords.numpy().astype(np.int64)
    np.testing.assert_array_equal(xy[..., 1] * W + xy[..., 0], want_idx)


def test_sample_foreground_rejects_unknown_method():
    mask, field = _batch()
    with pytest.raises(ValueError, match="method"):
        TV.sample_foreground(_t(mask), _t(_cmajor(field)), 64, method="auto")


def test_per_keypoint_pairs_match_jax(jax_op_by_op):
    mask, field = _batch(seed=3)
    key = jax.random.PRNGKey(4)
    fg = JV.sample_foreground(jnp.asarray(mask), jnp.asarray(field), TN, key,
                              method="stratified")
    want = np.asarray(JV.generate_hypotheses(fg, HN, key,
                                             shared_pairs=False))
    u = jax.random.uniform(key, (2, HN, 3, 2), jnp.float32)
    tfg = TV.ForegroundSample(*(_t(x) for x in fg))
    got = TV.generate_hypotheses(tfg, HN, pair_u=_t(u),
                                 shared_pairs=False).numpy()
    assert got.shape == (2, HN, 3, 2)
    # closed-form intersections: float32 rounding at pixel scale, 1e-4 px
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the per-keypoint draws really differ between keypoints
    assert not np.allclose(got[:, :, 0], got[:, :, 1])


# --- v2, v4, v5, distribution, counts ----------------------------------------

def _hyps_counts_equal(mask, vert, noise, pair, want_key, method, hn=HN,
                       max_num=TN):
    """The port's hypotheses and counts equal JAX's (same draws)."""
    want_h, want_c = JV.generate_hypotheses_with_counts(
        jnp.asarray(mask), jnp.asarray(vert), want_key, hyp_num=hn,
        max_num=max_num, select_method=method)
    got_h, got_c = TV.generate_hypotheses_with_counts(
        _t(mask), _t(vert), hyp_num=hn, max_num=max_num, noise=noise,
        pair_u=pair, select_method=method)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0,
                               atol=1e-4)
    return got_c


@pytest.mark.parametrize("method", ["stratified", "topk"])
def test_hypotheses_with_counts_match_jax(jax_op_by_op, method):
    mask, field = _batch(seed=5)
    key = jax.random.PRNGKey(6)
    noise, pair = _draws(key, 2, HN, method)
    counts = _hyps_counts_equal(mask, _cmajor(field), noise, pair, key,
                                method)
    assert counts.dtype == torch.int32 and counts.max() > 50


@pytest.mark.parametrize("refine_iter_num", [1, 3])
def test_v2_matches_jax(jax_op_by_op, refine_iter_num):
    mask, field = _batch(seed=7)
    key = jax.random.PRNGKey(8)
    want = np.asarray(JV.ransac_voting_v2(
        jnp.asarray(mask), jnp.asarray(field), key, hyp_num=HN,
        max_num=TN, refine_iter_num=refine_iter_num,
        select_method="stratified"))
    noise, pair = _draws(key, 2, HN, "stratified")
    _hyps_counts_equal(mask, field, noise, pair, key, "stratified")
    got = TV.ransac_voting_v2(_t(mask), _t(_cmajor(field)), hyp_num=HN,
                              max_num=TN, refine_iter_num=refine_iter_num,
                              noise=noise, pair_u=pair).numpy()
    # same winners; each refit sums over the inliers in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[0], KPTS, atol=1.0)


def test_v2_one_round_equals_v3():
    mask, field = _batch(seed=9)
    g = torch.Generator().manual_seed(0)
    noise = torch.rand((2, H, W), generator=g)
    pair = torch.rand((2, HN, 2), generator=g)
    args = (_t(mask), _t(_cmajor(field)), HN, 0.999, TN, 5)
    v2 = TV.ransac_voting_v2(*args, refine_iter_num=1, noise=noise,
                             pair_u=pair)
    v3 = TV.ransac_voting_v3(*args, noise=noise, pair_u=pair)
    assert torch.equal(v2, v3)


@pytest.mark.parametrize("method", ["stratified", "topk"])
def test_v4_matches_jax(jax_op_by_op, method):
    mask, field = _batch(seed=10)
    mask[1] = 0                                     # an empty image: var 1
    key = jax.random.PRNGKey(11)
    want_k, want_v = JV.ransac_voting_v4(
        jnp.asarray(mask), jnp.asarray(field), key, hyp_num=HN, max_num=TN,
        select_method=method)
    noise, pair = _draws(key, 2, HN, method)
    got_k, got_v = TV.ransac_voting_v4(_t(mask), _t(_cmajor(field)),
                                       hyp_num=HN, max_num=TN, noise=noise,
                                       pair_u=pair, select_method=method)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=0,
                               atol=1e-3)
    # a variance of residuals ~1e-2 px^2 summed in another order: 1e-4
    # relative
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=1e-4,
                               atol=1e-7)
    assert (got_v[1] == 1.0).all() and (got_k[1] == 0).all()


def test_v5_matches_jax(jax_op_by_op):
    mask, field = _batch(seed=12)
    key = jax.random.PRNGKey(13)
    want_k, want_c = JV.ransac_voting_v5(
        jnp.asarray(mask), jnp.asarray(field), key, hyp_num=HN, max_num=TN,
        select_method="stratified")
    noise, pair = _draws(key, 2, HN, "stratified")
    got_k, got_c = TV.ransac_voting_v5(_t(mask), _t(_cmajor(field)),
                                       hyp_num=HN, max_num=TN, noise=noise,
                                       pair_u=pair)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=0,
                               atol=1e-3)
    # the confidence counts inliers of the refined point: an integer over
    # the count, exact unless a pixel sits at the boundary (1 pixel)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1.0 / TN)
    assert (got_c > 0.3).all() and (got_c <= 1).all()


@pytest.mark.parametrize("method", ["stratified", "topk"])
def test_distribution_matches_jax(jax_op_by_op, method):
    mask, field = _batch(seed=14)
    key = jax.random.PRNGKey(15)
    want_m, want_c = JV.estimate_voting_distribution(
        jnp.asarray(mask), jnp.asarray(field), key, round_hyp_num=96,
        min_hyp_num=300, topk=40, max_num=TN,
        select_method=method)
    hn = 384                                        # ceil(300 / 96) * 96
    noise, pair = _draws(key, 2, hn, method)
    _hyps_counts_equal(mask, field, noise, pair, key, method, hn=hn)
    got_m, got_c = TV.estimate_voting_distribution(
        _t(mask), _t(_cmajor(field)), round_hyp_num=96, min_hyp_num=300,
        topk=40, max_num=TN, noise=noise, pair_u=pair, select_method=method)
    # weighted sums over the hypotheses in another order: 1e-4 relative
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-4,
                               atol=1e-4)
    want_c = np.asarray(want_c)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-3,
                               atol=1e-4 * np.abs(want_c).max())
    assert got_c.shape == (2, 3, 2, 2)


def test_distribution_empty_image_gives_zeros():
    mask, field = _batch(seed=16)
    mask[0] = 0
    mean, cov = TV.estimate_voting_distribution(
        _t(mask), _t(_cmajor(field)), min_hyp_num=256, topk=32, max_num=TN,
        generator=torch.Generator().manual_seed(0))
    assert (mean[0] == 0).all() and (cov[0] == 0).all()
    assert (cov[1].diagonal(dim1=-2, dim2=-1) > 0).all()


# --- vanishing point ---------------------------------------------------------

def _vanish(mask, vert_j, vert_t, key, hn, tn):
    want = np.asarray(JV.ransac_voting_vanish_point(
        jnp.asarray(mask), jnp.asarray(vert_j), key, hyp_num=hn,
        max_num=tn, select_method="stratified"))
    vn = vert_j.shape[-2]
    noise, pair = _draws(key, mask.shape[0], hn, "stratified", vn=vn)
    # the hypotheses and counts first
    k1, k2 = jax.random.split(key)
    fg = JV.sample_foreground(jnp.asarray(mask), jnp.asarray(vert_j), tn, k1,
                              method="stratified")
    hyps = JV.generate_vanishing_hypotheses(fg, hn, k2)
    counts = np.asarray(JV.vanishing_inliers_for_points(fg, hyps, 0.999)
                        .sum(-1))
    tfg = TV.sample_foreground(_t(mask), _t(vert_t), tn, noise=noise)
    thyps = TV.generate_vanishing_hypotheses(tfg, hn, pair_u=pair)
    np.testing.assert_allclose(thyps.numpy(), np.asarray(hyps), rtol=1e-5,
                               atol=1e-3)
    with mock.patch.object(TV, "_VANISH_CHUNK", 40):        # uneven chunks
        np.testing.assert_array_equal(
            TV.vanishing_counts(tfg, thyps, 0.999).numpy(), counts)
    got = TV.ransac_voting_vanish_point(_t(mask), _t(vert_t), hyp_num=hn,
                                        max_num=tn, noise=noise,
                                        pair_u=pair).numpy()
    return got, want


def test_vanishing_finite_point_matches_jax(jax_op_by_op):
    mask, field = _batch(noise=0.0, outlier_frac=0.0, seed=17)
    got, want = _vanish(mask, field, _cmajor(field), jax.random.PRNGKey(18),
                        HN, TN)
    # unit homogeneous vectors from a 3x3 Jacobi on sums in another order:
    # 1e-4; as pixels (x/z, y/z) within 1e-2 px of JAX's and of the truth
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    pts = got[..., :2] / got[..., 2:]
    np.testing.assert_allclose(pts, want[..., :2] / want[..., 2:], atol=1e-2)
    np.testing.assert_allclose(pts[0], KPTS, atol=1e-2)


def test_vanishing_parallel_field_matches_jax(jax_op_by_op):
    mask = np.zeros((1, H, W), np.int32)
    mask[0, 20:44, 20:44] = 1
    d = np.array([0.6, 0.8], np.float32)
    field = np.zeros((1, H, W, 1, 2), np.float32)
    field[mask == 1, 0] = d
    got, want = _vanish(mask, field, field, jax.random.PRNGKey(19), 64, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    vp = got[0, 0]
    assert abs(vp[2]) < 0.05 * np.linalg.norm(vp[:2])
    assert abs(abs(vp[:2] / np.linalg.norm(vp[:2]) @ d) - 1) < 1e-2


# --- center and motion -------------------------------------------------------

@pytest.mark.parametrize("outlier_frac", [0.0, 0.3])
def test_center_matches_jax(jax_op_by_op, outlier_frac):
    center = np.array([[44.0, 50.0]], np.float32)
    mask, field = _batch(noise=0.0, outlier_frac=outlier_frac, seed=20,
                         keypoints=center)
    key = jax.random.PRNGKey(21)
    tn = 1024
    want = JV.ransac_voting_center(
        jnp.asarray(mask), jnp.asarray(field[:, :, :, 0]), key, hyp_num=HN,
        max_num=tn, select_method="stratified")
    noise, pair = _draws(key, 2, HN, "stratified")
    got = TV.ransac_voting_center(_t(mask), _t(_cmajor(field)), hyp_num=HN,
                                  max_num=tn, noise=noise, pair_u=pair)
    c, inst, ratio = (x.numpy() for x in got)
    np.testing.assert_array_equal(inst, np.asarray(want[1]))
    np.testing.assert_array_equal(ratio, np.asarray(want[2]))
    np.testing.assert_array_equal(c, np.asarray(want[0]))
    np.testing.assert_allclose(c[0], center[0], atol=1.0)
    assert inst[0][mask[0] == 0].sum() == 0 and inst[0].sum() > 500


def test_center_min_num_skip_matches_jax(jax_op_by_op):
    mask = np.zeros((2, H, W), np.int32)
    mask[0, 30:33, 30:33] = 1                       # 9 px < min_num=100
    mask[1, 20:60, 20:60] = 1
    field = np.zeros((2, H, W, 1, 2), np.float32)
    field[..., 0, 0] = 1.0
    key = jax.random.PRNGKey(22)
    want = JV.ransac_voting_center(
        jnp.asarray(mask), jnp.asarray(field), key, hyp_num=64, max_num=256,
        select_method="topk")
    noise, pair = _draws(key, 2, 64, "topk")
    got = TV.ransac_voting_center(_t(mask), _t(field), hyp_num=64,
                                  max_num=256, noise=noise, pair_u=pair,
                                  select_method="topk")
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
    assert (got[0][0] == 0).all() and (got[1][0] == 0).all()


def test_motion_matches_jax(jax_op_by_op):
    mask, field = _batch(noise=0.0, outlier_frac=0.0, seed=23)
    off = np.zeros_like(field)
    for b in range(2):
        ys, xs = np.nonzero(mask[b])
        kp = KPTS + 4 * b
        off[b, ys, xs] = kp[None] - np.stack([xs, ys], -1)[:, None]
    key = jax.random.PRNGKey(24)
    want = np.asarray(JV.ransac_motion_voting(
        jnp.asarray(mask), jnp.asarray(off), key, max_num=TN,
        select_method="stratified"))
    noise = jax.random.uniform(key, (2, H, W), jnp.float32)
    got = TV.ransac_motion_voting(_t(mask), _t(_cmajor(off)), max_num=TN,
                                  noise=_t(noise)).numpy()
    # a mean over the sample in another order: 1e-4 px
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[0], KPTS, atol=1e-3)


# --- covariance PnP ----------------------------------------------------------

def test_uncertainty_pnp_v2_matches_jax():
    fix = np.load("assets/duck_views_480x640.npz")
    pts3d, K, pose = fix["points_3d"], fix["K"], fix["poses"][0]
    rng = np.random.RandomState(25)
    cam = pts3d @ pose[:, :3].T + pose[:, 3]
    uv = cam @ K.T
    kps = (uv[:, :2] / uv[:, 2:]).astype(np.float32)
    b = 3
    kps = kps[None] + rng.randn(b, 9, 2).astype(np.float32) * 0.7
    L = rng.randn(b, 9, 2, 2).astype(np.float32) * 0.8
    cov = L @ L.transpose(0, 1, 3, 2) + 0.05 * np.eye(2, dtype=np.float32)
    cov[1, 3] = 0.0                                  # a degenerate keypoint
    want = np.asarray(jax.vmap(JP.uncertainty_pnp_v2,
                               in_axes=(0, 0, None, None))(
        jnp.asarray(kps), jnp.asarray(cov), jnp.asarray(pts3d),
        jnp.asarray(K)))
    got = TP.uncertainty_pnp_v2_batch(_t(kps), _t(cov), _t(pts3d),
                                      _t(K)).numpy()
    # float32 solvers in two frameworks: poses within 0.05 deg / 0.5 mm
    from pvnet_tpu_torch.ops.geometry import rotation_angle_deg
    ang = rotation_angle_deg(torch.tensor(got[:, :, :3]),
                             torch.tensor(want[:, :, :3]))
    assert float(ang.max()) < 0.05
    np.testing.assert_allclose(got[:, :, 3], want[:, :, 3], atol=5e-4)
    # and the pose is sane: within a few cm of the truth
    assert np.abs(got[:, :, 3] - pose[:, 3]).max() < 0.05
