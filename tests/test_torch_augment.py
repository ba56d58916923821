"""The port's device augmentation (pvnet_tpu_torch/data/augment_device.py)
against the JAX package's, on the CPU, with JAX's own random draws handed
to the port (tests/_jax_aug_draws.py rebuilds them from the key).

Tolerances. Selections (shifts, taps, flips, blur weights) are exact; the
arithmetic around them (cos/sin of the rotation, the sums of the instance
statistics and the grey mean, multiply-adds that XLA:CPU may contract into
FMAs, ROADMAP fault F4) rounds differently by an ulp here and there. So
images are held to an absolute tolerance well above f32 rounding of
0..255 values, masks to a share of equal pixels (a floor or a u >= 0.5
that sits within an ulp of an integer may flip one), and rotation-free
masks exactly."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_aug_draws import jax_draws, raw_batch
from pvnet_tpu.config import AugConfig as JAugConfig
from pvnet_tpu.data import augment_device as JA
from pvnet_tpu_torch.config import AugConfig, TrainConfig
from pvnet_tpu_torch.data import augment_device as TA

torch.set_num_threads(1)

RECIPE = TrainConfig.from_json(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
    "synthetic_train.json")).aug_cfg


def _jcfg(cfg: AugConfig) -> JAugConfig:
    return JAugConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def batch():
    return raw_batch()


def test_instance_stats_match_jax(batch):
    _, masks, _ = batch
    masks = np.concatenate([masks, np.zeros_like(masks[:1])])  # + empty
    want = jax.vmap(JA._instance_stats)(jnp.asarray(masks))
    got = TA._instance_stats(torch.from_numpy(masks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_warp_matches_jax(batch, seed):
    _, masks, _ = batch
    key = jax.random.PRNGKey(seed)
    k_warp = jax.random.split(key, 5)[0]
    want = jax.vmap(lambda m, k: JA._sample_warp(m, k, 48, 64,
                                                 _jcfg(RECIPE)))(
        jnp.asarray(masks), jax.random.split(k_warp, 2))
    got = TA._sample_warp(torch.from_numpy(masks),
                          jax_draws(key, 2, RECIPE), 48, 64, RECIPE)
    # the crop offsets are floors of the same sums; cos/sin may differ by
    # an ulp, which moves the matrix entries by ~1e-5 at most
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_invert_affine_matches_jax():
    M = np.random.RandomState(0).uniform(-2, 2, (4, 2, 3)).astype(np.float32)
    want = jax.vmap(JA._invert_affine)(jnp.asarray(M))
    np.testing.assert_allclose(TA._invert_affine(torch.from_numpy(M)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ch", [3, 4])
def test_sep_pass_matches_jax(ch):
    rng = np.random.RandomState(ch)
    X = (rng.rand(2, ch, 20, 30) * 255).astype(np.float32)
    scale = np.array([0.9, 1.15], np.float32)
    off = rng.uniform(-8, 8, (2, 20)).astype(np.float32)
    want = JA._sep_pass_cm(jnp.asarray(X), jnp.asarray(scale),
                           jnp.asarray(off), 25)
    got = TA._sep_pass_cm(torch.from_numpy(X), torch.from_numpy(scale),
                          torch.from_numpy(off), 25)
    # taps are selected exactly; the blend's u may differ by an ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_warp_batch_sep_matches_jax(batch):
    images, masks, _ = batch
    key = jax.random.PRNGKey(4)
    Ms = np.asarray(jax.vmap(lambda m, k: JA._sample_warp(
        m, k, 48, 64, _jcfg(RECIPE)))(jnp.asarray(masks),
                                      jax.random.split(key, 2)))
    wi, wm = JA._warp_batch_sep(jnp.asarray(images), jnp.asarray(masks),
                                jnp.asarray(Ms), 48, 64, out_layout="NCHW")
    ti, tm = TA._warp_batch_sep(torch.from_numpy(images),
                                torch.from_numpy(masks),
                                torch.from_numpy(Ms.copy()), 48, 64)
    assert ti.shape == (2, 3, 48, 64) and tm.dtype == torch.int32
    np.testing.assert_allclose(ti.numpy(), np.asarray(wi), atol=2e-3)
    assert (tm.numpy() == np.asarray(wm)).mean() >= 0.99


def test_separable_blur_matches_jax():
    rng = np.random.RandomState(0)
    img = (rng.rand(4, 3, 20, 24) * 255).astype(np.float32)
    bank = TA._gauss_weights_bank()
    np.testing.assert_array_equal(bank.numpy(),
                                  np.asarray(JA._gauss_weights_bank()))
    wts = bank[torch.tensor([0, 1, 2, 3])]
    want = JA._separable_blur(jnp.asarray(img), jnp.asarray(wts.numpy()),
                              spatial_axes=(2, 3))
    got = TA._separable_blur(torch.from_numpy(img), wts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-3)


def test_hsv_matches_jax():
    rgb = np.random.RandomState(1).rand(2, 3, 16, 16).astype(np.float32)
    rgb[0, :, :4] = 0.5                                 # grey: d == 0
    want = JA._rgb_to_hsv(jnp.asarray(rgb), ch_axis=1)
    got = TA._rgb_to_hsv(torch.from_numpy(rgb))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    back = TA._hsv_to_rgb(*got)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(JA._hsv_to_rgb(*want, ch_axis=1)),
        atol=1e-6)
    np.testing.assert_allclose(back.numpy(), rgb, atol=1e-5)


def test_color_jitter_matches_jax():
    img = (np.random.RandomState(2).rand(2, 3, 24, 32) * 255).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    k_jit = jax.random.split(key, 5)[3]
    want = JA._color_jitter(jnp.asarray(img), k_jit, _jcfg(RECIPE),
                            ch_axis=1)
    got = TA._color_jitter(torch.from_numpy(img), jax_draws(key, 2, RECIPE),
                           RECIPE)
    # the grey mean is a reduction in another order; 0..255 values
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def _augment_both(batch, cfg, seed):
    images, masks, hcoords = batch
    key = jax.random.PRNGKey(seed)
    want = JA.augment_batch(jnp.asarray(images), jnp.asarray(masks),
                            jnp.asarray(hcoords), key, (48, 64), _jcfg(cfg),
                            out_layout="NCHW")
    got = TA.augment_batch(torch.from_numpy(images), torch.from_numpy(masks),
                           torch.from_numpy(hcoords), (48, 64), cfg,
                           draws=jax_draws(key, 2, cfg))
    return [t.numpy() for t in got], [np.asarray(w) for w in want]


def test_augment_batch_matches_jax(batch):
    """The recipe's augmentation, b=2, 64x80 frames to 48x64, NCHW.
    Tolerance: the normalized image within 1e-4 (~0.006 of a 0..255 level)
    on all but 0.5 % of values, the mask equal on >= 99 % of pixels,
    hcoords within rtol 1e-5."""
    (ti, tm, th), (wi, wm, wh) = _augment_both(batch, RECIPE, 3)
    assert ti.shape == wi.shape == (2, 3, 48, 64)
    assert tm.dtype == wm.dtype == np.int32
    assert (np.abs(ti - wi) > 1e-4).mean() <= 0.005
    assert (tm == wm).mean() >= 0.99 and wm.sum() > 100
    np.testing.assert_allclose(th, wh, rtol=1e-5, atol=1e-4)


def test_augment_batch_rotation_free_mask_exact(batch):
    """Without rotation (d = 0) the nearest-tap mask has no slanted-line
    rounding: it equals JAX's exactly. Flip on, so the flip path runs."""
    cfg = dataclasses.replace(RECIPE, rot_ang_min=0.0, rot_ang_max=0.0,
                              flip=True)
    (ti, tm, th), (wi, wm, wh) = _augment_both(batch, cfg, 7)
    np.testing.assert_array_equal(tm, wm)
    assert (np.abs(ti - wi) > 1e-4).mean() <= 0.005
    np.testing.assert_allclose(th, wh, rtol=1e-5, atol=1e-4)


def test_sample_draws_ranges_and_determinism():
    cfg = dataclasses.replace(RECIPE, flip=True)
    a = TA.sample_draws(64, cfg, torch.Generator().manual_seed(0), "cpu")
    b = TA.sample_draws(64, cfg, torch.Generator().manual_seed(0), "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.deg.min() >= -30 and a.deg.max() <= 30
    assert a.ratio.min() >= 0.8 and a.ratio.max() <= 1.2
    assert set(a.blur_size.tolist()) <= {0, 1, 2, 3}
    assert a.flip.dtype == a.blur.dtype == torch.bool
    assert a.hue.abs().max() <= 0.05 and a.brightness.min() >= 0.9


def test_gather_warp_range_is_refused(batch):
    images, masks, hcoords = batch
    cfg = dataclasses.replace(RECIPE, rot_ang_min=-90.0, rot_ang_max=90.0)
    with pytest.raises(NotImplementedError, match="gather warp"):
        TA.augment_batch(torch.from_numpy(images), torch.from_numpy(masks),
                         torch.from_numpy(hcoords), (48, 64), cfg,
                         generator=torch.Generator().manual_seed(0))
