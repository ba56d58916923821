"""The port's voting main path against pvnet_tpu.ops.voting, fed the same
fields and JAX's own random draws.

Integer results (selected pixels, valid flags, counts) must match exactly;
float results carry the tolerance stated at each test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch.ops import voting as TV
from tests.test_voting import BOX, KPTS, make_field

torch.set_num_threads(1)


def _cmajor_batch(h, w, noise=0.0, outlier_frac=0.0, seed=0):
    """mask [2, h, w] and channel-major field [2, 6, h, w]: image 0 clean
    or noisy, image 1 a shifted copy."""
    rng = np.random.RandomState(seed)
    masks, fields = [], []
    for shift in (0, 5):
        box = (BOX[0] + shift, BOX[1] + shift, BOX[2], BOX[3] + shift)
        m, v = make_field(h, w, KPTS + shift, box, noise=noise, rng=rng,
                          outlier_frac=outlier_frac)
        masks.append(m)
        fields.append(v.reshape(h, w, 6).transpose(2, 0, 1))
    return np.stack(masks), np.ascontiguousarray(np.stack(fields))


def _to_torch_fg(fg):
    return TV.ForegroundSample(*(torch.tensor(np.asarray(x))
                                 for x in fg))


def _assert_fg_equal(got, want):
    np.testing.assert_array_equal(got.coords.numpy(), np.asarray(want.coords))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.total.numpy(), np.asarray(want.total))
    np.testing.assert_array_equal(got.dirs.numpy(), np.asarray(want.dirs))


# (h, w, tn): the phase grid divides the image, or forces padding
@pytest.mark.parametrize("h,w,tn", [(128, 128, 256), (100, 120, 64),
                                    (128, 128, 1024)])
def test_sample_foreground_matches_jax_exactly(h, w, tn):
    mask, vcm = _cmajor_batch(h, w, noise=0.05, seed=1)
    key = jax.random.PRNGKey(tn)
    want = JV.sample_foreground(jnp.asarray(mask), jnp.asarray(vcm), tn, key,
                                method="stratified")
    noise = np.asarray(jax.random.uniform(key, mask.shape, jnp.float32))
    got = TV.sample_foreground(torch.tensor(mask), torch.tensor(vcm),
                               tn, noise=torch.tensor(noise))
    _assert_fg_equal(got, want)
    assert got.coords.shape == (2, tn, 2) and got.dirs.shape == (2, tn, 3, 2)


def test_valid_slots_form_a_prefix():
    mask, vcm = _cmajor_batch(128, 128)
    fg = TV.sample_foreground(torch.tensor(mask), torch.tensor(vcm),
                              1024, generator=torch.Generator().manual_seed(0))
    for b in range(2):
        n = int(fg.count[b])
        assert fg.valid[b, :n].all() and not fg.valid[b, n:].any()
        assert (fg.dirs[b, n:] == 0).all()


def test_generate_hypotheses_matches_jax():
    mask, vcm = _cmajor_batch(128, 128, noise=0.05, seed=2)
    key = jax.random.PRNGKey(3)
    fg = JV.sample_foreground(jnp.asarray(mask), jnp.asarray(vcm), 256, key,
                              method="stratified")
    want = np.asarray(JV.generate_hypotheses(fg, 128, key))
    u = np.asarray(jax.random.uniform(key, (2, 128, 2), jnp.float32))
    got = TV.generate_hypotheses(_to_torch_fg(fg), 128,
                                 pair_u=torch.tensor(u)).numpy()
    assert got.shape == (2, 128, 3, 2)
    # closed-form ray intersections; 1e-4 px covers float32 rounding of the
    # 2x2 solve at pixel coordinates ~1e2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _random_fg(rng, b=2, tn=64, vn=3, hn=160):
    """Random sample with ~20 % invalid slots (the JAX test's helper)."""
    coords = rng.uniform(0, 100, (b, tn, 2)).astype(np.float32)
    dirs = rng.randn(b, tn, vn, 2).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    valid = rng.rand(b, tn) > 0.2
    dirs *= valid[:, :, None, None]
    count = valid.sum(1).astype(np.int32)
    fg = JV.ForegroundSample(jnp.asarray(coords), jnp.asarray(dirs),
                             jnp.asarray(valid), jnp.asarray(count),
                             jnp.asarray(count))
    hyps = rng.uniform(-20, 120, (b, hn, vn, 2)).astype(np.float32)
    return fg, hyps


@pytest.mark.parametrize("thresh,tn,hn", [(0.99, 64, 160), (0.95, 100, 130),
                                          (0.9, 32, 64)])
def test_count_plain_matches_pallas_interpret_and_xla(thresh, tn, hn):
    fg, hyps = _random_fg(np.random.RandomState(tn), tn=tn, hn=hn)
    want_x = np.asarray(JV.count_inliers_xla(fg, jnp.asarray(hyps), thresh))
    want_p = np.asarray(JV.count_inliers_pallas(
        fg, jnp.asarray(hyps), thresh, tile_h=128, tile_t=32,
        interpret=True))
    got = TV.count_inliers_plain(_to_torch_fg(fg), torch.tensor(hyps),
                                 thresh)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_x)
    np.testing.assert_array_equal(got.numpy(), want_p)


def test_count_on_real_field_matches_xla():
    # a voting field: most hypotheses sit near the true keypoints, so many
    # pixels fall close to the cosine boundary
    mask, vcm = _cmajor_batch(128, 128, noise=0.05, seed=4)
    key = jax.random.PRNGKey(5)
    fg = JV.sample_foreground(jnp.asarray(mask), jnp.asarray(vcm), 256, key,
                              method="stratified")
    hyps = JV.generate_hypotheses(fg, 256, key)
    want = np.asarray(JV.count_inliers_xla(fg, hyps, 0.99))
    got = TV.count_inliers_plain(_to_torch_fg(fg),
                                 torch.tensor(np.asarray(hyps)), 0.99)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 100


def test_count_wrapper_takes_plain_version_on_cpu():
    fg, hyps = _random_fg(np.random.RandomState(0))
    tfg, th = _to_torch_fg(fg), torch.tensor(hyps)
    before = TV.count_inliers.launches
    assert torch.equal(TV.count_inliers(tfg, th, 0.99),
                       TV.count_inliers_plain(tfg, th, 0.99))
    assert TV.count_inliers.launches == before
    with pytest.raises(ValueError, match="thresh"):
        TV.count_inliers(tfg, th, 0.0)


def _bad(tfg, th, **fields):
    return tfg._replace(**fields), th


@pytest.mark.parametrize("case,error", [
    ("hyps_3d", ValueError), ("hyps_last", ValueError),
    ("dirs_vn", ValueError), ("coords_tn", ValueError),
    ("valid_shape", ValueError), ("dirs_f64", TypeError),
    ("hyps_f16", TypeError), ("valid_int", TypeError),
    ("valid_device", ValueError)])
def test_count_kernel_args_raise_before_any_launch(case, error):
    # the checks K3's launch makes; on the CPU they run through the same
    # helper without a card
    fg, hyps = _random_fg(np.random.RandomState(1), tn=40, hn=20)
    tfg, th = _to_torch_fg(fg), torch.tensor(hyps)
    tfg, th = {
        "hyps_3d": lambda: (tfg, th[..., 0]),
        "hyps_last": lambda: (tfg, th.repeat(1, 1, 1, 2)),
        "dirs_vn": lambda: _bad(tfg, th, dirs=tfg.dirs[:, :, :2]),
        "coords_tn": lambda: _bad(tfg, th, coords=tfg.coords[:, :30]),
        "valid_shape": lambda: _bad(tfg, th, valid=tfg.valid[:, :30]),
        "dirs_f64": lambda: _bad(tfg, th, dirs=tfg.dirs.double()),
        "hyps_f16": lambda: (tfg, th.half()),
        "valid_int": lambda: _bad(tfg, th, valid=tfg.valid.int()),
        "valid_device": lambda: _bad(tfg, th,
                                     valid=tfg.valid.to("meta")),
    }[case]()
    with pytest.raises(error):
        TV._count_kernel_args(tfg, th)


def test_count_kernel_args_make_contiguous_copies_only():
    fg, hyps = _random_fg(np.random.RandomState(2), tn=40, hn=20)
    tfg, th = _to_torch_fg(fg), torch.tensor(hyps)
    out = TV._count_kernel_args(tfg, th)
    assert all(a is b for a, b in zip(out, (tfg.coords, tfg.dirs, tfg.valid,
                                            th)))
    view = th.transpose(1, 2).contiguous().transpose(1, 2)
    out = TV._count_kernel_args(tfg, view)
    assert out[3].is_contiguous() and torch.equal(out[3], th)
    with pytest.raises(ValueError, match="unsupported device"):
        TV.count_inliers(tfg, th.to("meta"), 0.99)


@pytest.mark.parametrize("noise,outliers", [(0.0, 0.0), (0.03, 0.3)])
def test_ransac_voting_v3_matches_jax(noise, outliers):
    mask, vcm = _cmajor_batch(128, 128, noise=noise, outlier_frac=outliers,
                              seed=6)
    key = jax.random.PRNGKey(7)
    want = np.asarray(JV.ransac_voting_v3(
        jnp.asarray(mask), jnp.asarray(vcm), key, hyp_num=256, max_num=256,
        impl="pallas_interpret", select_method="stratified"))
    k1, k2 = jax.random.split(key)
    sel = np.asarray(jax.random.uniform(k1, mask.shape, jnp.float32))
    pair = np.asarray(jax.random.uniform(k2, (2, 256, 2), jnp.float32))
    got = TV.ransac_voting_v3(
        torch.tensor(mask), torch.tensor(vcm), hyp_num=256,
        max_num=256, noise=torch.tensor(sel),
        pair_u=torch.tensor(pair)).numpy()
    # same winners (exact counts); the WLS refine sums in another order:
    # 1e-3 px
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    if noise == 0.0:
        np.testing.assert_allclose(got[0], KPTS, atol=1e-2)


def test_min_num_guard_gives_zeros():
    mask, vcm = _cmajor_batch(64, 64)
    mask[0] = 0
    mask[0, 10, 10:14] = 1                                  # 4 < min_num
    got = TV.ransac_voting_v3(torch.tensor(mask), torch.tensor(vcm),
                              hyp_num=64, max_num=64, min_num=5,
                              generator=torch.Generator().manual_seed(0))
    assert (got[0] == 0).all()
    assert got.shape == (2, 3, 2)


def test_phase_grid_matches_jax():
    for tn in (64, 100, 128, 512, 1000, 1024):
        assert TV._phase_grid(tn) == JV._phase_grid(tn)


# --- the uncertainty path's covariance ---------------------------------------

# Random fields: JAX's compiled count path may round at the cosine
# boundary unlike its op-by-op form (ROADMAP fault F4); on random rays no
# pixel sits within an ulp of it, so the counts must be equal. The
# covariance is a weighted sum over the hypotheses in another order:
# rtol 1e-4.
@pytest.mark.parametrize("tn,hn", [(64, 160), (100, 256)])
def test_covariance_from_fg_matches_jax(tn, hn):
    rng = np.random.RandomState(tn + hn)
    fg, _ = _random_fg(rng, tn=tn, hn=1)
    mean = rng.uniform(20, 80, (2, 3, 2)).astype(np.float32)
    key = jax.random.PRNGKey(hn)
    want_mean, want_cov = JV.estimate_voting_distribution_from_fg(
        fg, jnp.asarray(mean), key, hyp_num=hn, inlier_thresh=0.9)
    u = np.asarray(jax.random.uniform(key, (2, hn, 2), jnp.float32))
    tfg = _to_torch_fg(fg)
    got_mean, got_cov = TV.estimate_voting_distribution_from_fg(
        tfg, torch.tensor(mean), hn, 0.9, pair_u=torch.tensor(u))
    hyps_j = JV.generate_hypotheses(fg, hn, key)
    hyps_t = TV.generate_hypotheses(tfg, hn, pair_u=torch.tensor(u))
    np.testing.assert_array_equal(
        TV.count_inliers(tfg, hyps_t, 0.9).numpy(),
        np.asarray(JV.count_inliers(fg, hyps_j, 0.9)))
    np.testing.assert_array_equal(got_mean.numpy(), mean)
    assert got_cov.shape == (2, 3, 2, 2)
    want_cov = np.asarray(want_cov)
    np.testing.assert_allclose(got_cov.numpy(), want_cov, rtol=1e-4,
                               atol=1e-6 * np.abs(want_cov).max())


def test_covariance_with_mean_matches_jax():
    mask, vcm = _cmajor_batch(128, 128, noise=0.05, seed=8)
    key = jax.random.PRNGKey(9)
    mean = np.asarray(KPTS[None].repeat(2, 0) + 0.5, np.float32)
    mean[1] += 5
    _, want = JV.estimate_voting_distribution_with_mean(
        jnp.asarray(mask), jnp.asarray(vcm), jnp.asarray(mean), key,
        hyp_num=256, max_num=256, select_method="stratified")
    k1, k2 = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(k1, mask.shape, jnp.float32))
    u = np.asarray(jax.random.uniform(k2, (2, 256, 2), jnp.float32))
    _, got = TV.estimate_voting_distribution_with_mean(
        torch.tensor(mask), torch.tensor(vcm), torch.tensor(mean),
        hyp_num=256, max_num=256, noise=torch.tensor(noise),
        pair_u=torch.tensor(u))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())


# --- bfloat16 counts (K3's bf16 mode, JAX's count_inliers_xla_bf16) ---------

def _real_fg(seed=4):
    mask, vcm = _cmajor_batch(128, 128, noise=0.05, seed=seed)
    key = jax.random.PRNGKey(seed + 1)
    fg = JV.sample_foreground(jnp.asarray(mask), jnp.asarray(vcm), 256, key,
                              method="stratified")
    return fg, np.asarray(JV.generate_hypotheses(fg, 256, key))


# Both sides round every bf16 operation (XLA's CPU build as PyTorch's eager
# ops do here): the counts are equal on these inputs (measured: 100 %).
# Held with tests/test_voting.py's dither bound and mean bias (any count
# within max(3, 5 % of tn), mean difference under 1) plus >= 99 % equal
# counts, so that a compiled XLA that fuses a rounding away may dither a
# boundary pixel. Against the float32 count that bound holds on random
# rays only, as test_voting.py applies it: on the voting field, where many
# pixels sit near the cosine boundary, bf16 counts run lower (measured
# there, in both frameworks alike: mean -6.9, at most 24 of up to 255).
@pytest.mark.parametrize("kind", ["random", "voting field"])
def test_bf16_counts_match_jax(kind):
    if kind == "random":
        fg, hyps = _random_fg(np.random.RandomState(11), tn=256, hn=64)
    else:
        fg, hyps = _real_fg()
    tn = fg.coords.shape[1]
    want = np.asarray(JV.count_inliers_xla_bf16(fg, jnp.asarray(hyps), 0.99))
    tfg, th = _to_torch_fg(fg), torch.tensor(hyps)
    got = TV.count_inliers_plain_bf16(tfg, th, 0.99).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    diff = got - want
    assert np.abs(diff).max() <= max(3, int(0.05 * tn))
    assert abs(float(diff.mean())) < 1.0
    assert (diff == 0).mean() >= 0.99
    if kind == "random":
        f32 = TV.count_inliers_plain(tfg, th, 0.99).numpy()
        assert np.abs(got - f32).max() <= max(3, int(0.05 * tn))
        assert abs(float((got - f32).mean())) < 1.0


def test_count_dispatches_on_impl():
    fg, hyps = _random_fg(np.random.RandomState(12))
    tfg, th = _to_torch_fg(fg), torch.tensor(hyps)
    before = (TV.count_inliers.launches, TV.count_inliers_bf16.launches)
    assert torch.equal(TV.count_inliers(tfg, th, 0.99, impl="bf16"),
                       TV.count_inliers_plain_bf16(tfg, th, 0.99))
    assert torch.equal(TV.count_inliers(tfg, th, 0.99),
                       TV.count_inliers_plain(tfg, th, 0.99))
    assert (TV.count_inliers.launches,
            TV.count_inliers_bf16.launches) == before
    with pytest.raises(ValueError, match="impl"):
        TV.count_inliers(tfg, th, 0.99, impl="pallas")
    with pytest.raises(ValueError, match="thresh"):
        TV.count_inliers(tfg, th, 0.0, impl="bf16")


# test_voting.py's bf16 recovery: the clean field within 0.5 px, 30 %
# outliers within 2 px (the winner seeds a float32 refine either way)
@pytest.mark.parametrize("noise,outliers,atol,hn",
                         [(0.0, 0.0, 0.5, 256), (0.01, 0.3, 2.0, 512)])
def test_bf16_v3_voting_recovers_keypoints(noise, outliers, atol, hn):
    mask, vertex = make_field(128, 128, KPTS, BOX, noise=noise,
                              rng=np.random.RandomState(0),
                              outlier_frac=outliers)
    vcm = vertex.reshape(128, 128, 6).transpose(2, 0, 1)[None]
    got = TV.ransac_voting_v3(
        torch.tensor(mask[None]), torch.tensor(np.ascontiguousarray(vcm)),
        hyp_num=hn, max_num=hn, generator=torch.Generator().manual_seed(0),
        impl="bf16")
    np.testing.assert_allclose(got[0].numpy(), KPTS, atol=atol)


# F2: the covariance pass weighs its scatter by the counts, so bf16 counts
# move it (JAX's docstring says they feed winner selection only). The
# port's bf16 covariance equals JAX's from the same draws (equal counts;
# the weighted sum in another order, rtol 1e-4); against the float32
# covariance from the same hypotheses it moves by 33 % of the largest
# entry on this field (measured), held under 50 %: in the JAX package's
# bf16 path just as much.
def test_bf16_covariance_matches_jax_and_tracks_f32():
    fg, _ = _real_fg(seed=6)
    tfg = _to_torch_fg(fg)
    mean = np.asarray(KPTS[None].repeat(2, 0) + 0.5, np.float32)
    mean[1] += 5
    key = jax.random.PRNGKey(13)
    _, want = JV.estimate_voting_distribution_from_fg(
        fg, jnp.asarray(mean), key, hyp_num=512, inlier_thresh=0.99,
        impl="bf16")
    u = torch.tensor(np.asarray(jax.random.uniform(key, (2, 512, 2),
                                                   jnp.float32)))
    mean_t = torch.tensor(mean)
    _, bf = TV.estimate_voting_distribution_from_fg(tfg, mean_t, 512, 0.99,
                                                     pair_u=u, impl="bf16")
    _, f32 = TV.estimate_voting_distribution_from_fg(tfg, mean_t, 512, 0.99,
                                                      pair_u=u)
    want = np.asarray(want)
    np.testing.assert_allclose(bf.numpy(), want, rtol=1e-4,
                               atol=1e-6 * np.abs(want).max())
    err = float((bf - f32).abs().max() / f32.abs().max())
    assert 0.0 < err < 0.5, err
