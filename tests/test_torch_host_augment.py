"""The port's OpenCV calls (pvnet_tpu_torch/data/cv_ops.py) against cv2,
and its host augmentation (pvnet_tpu_torch/data/augment.py) against the
JAX package's pvnet_tpu/data/augment.py, on the CPU.

uint8 and integer results equal exactly; hcoords within 1e-6 px; the
RandomState after each augmentation equals JAX's (the same draws were
taken). cv2's vector widths are those of its AVX-512 dispatch
(cv_ops.WARP_LANES, cv_ops.HSV_BLOCK); the random cases cover rows that
end in a scalar tail."""
import os

import cv2
import numpy as np
import pytest
import torch

from pvnet_tpu.data import augment as JA
from pvnet_tpu_torch.data import augment as TA
from pvnet_tpu_torch.data import cv_ops as C

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "duck_views_480x640.npz")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_affine(rng, H, W, big=False):
    M = cv2.getRotationMatrix2D((rng.uniform(0, W), rng.uniform(0, H)),
                                rng.uniform(-30, 30), rng.uniform(0.8, 1.2))
    M[:, 2] += rng.uniform(-40, 40, 2) if big else rng.uniform(-1, 1, 2)
    return M


@pytest.mark.parametrize("seed", range(4))
def test_rotation_matrix_matches_cv2(seed):
    rng = np.random.RandomState(seed)
    for _ in range(500):
        c = (rng.uniform(0, 640), rng.uniform(0, 480))
        ang = rng.uniform(-30, 30) if rng.rand() < 0.8 else float(
            rng.randint(-90, 91))
        sc = 1.0 if rng.rand() < 0.5 else rng.uniform(0.8, 1.2)
        np.testing.assert_array_equal(C.get_rotation_matrix_2d(c, ang, sc),
                                      cv2.getRotationMatrix2D(c, ang, sc))


@pytest.mark.parametrize("seed", range(6))
def test_warp_affine_matches_cv2(seed):
    """Rotations of +-30 deg, scales 0.8-1.2, sub-pixel and large
    translations (outputs running off the frame), odd sizes, sizes below
    one vector; INTER_LINEAR on uint8 HxWx3, INTER_NEAREST on uint8 and
    int32 masks."""
    rng = np.random.RandomState(seed)
    for case in range(20):
        H, W = rng.randint(1, 100), rng.randint(1, 130)
        h, w = rng.randint(1, 100), rng.randint(1, 130)
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        m8 = rng.randint(0, 256, (H, W)).astype(np.uint8)
        m32 = rng.randint(-2 ** 31, 2 ** 31 - 1, (H, W)).astype(np.int32)
        M = _random_affine(rng, H, W, big=case % 2 == 1)
        if case % 5 == 0:           # a sub-pixel translation alone
            M = np.float64([[1, 0, rng.uniform(-1, 1)],
                            [0, 1, rng.uniform(-1, 1)]])
        for src, flag, ours in ((img, cv2.INTER_LINEAR, C.INTER_LINEAR),
                                (m8, cv2.INTER_NEAREST, C.INTER_NEAREST),
                                (m32, cv2.INTER_NEAREST, C.INTER_NEAREST)):
            want = cv2.warpAffine(src, M, (w, h), flags=flag,
                                  borderMode=cv2.BORDER_CONSTANT,
                                  borderValue=0)
            got = C.warp_affine(_t(src), M, (w, h), ours).numpy()
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=str(
                (seed, case, src.dtype, flag)))


def test_warp_affine_full_frames_match_cv2():
    """480x640 frames to the sampler's sizes through the fused path's maps
    (rotation, 1/ratio, crop offset; padding when the crop exceeds the
    frame)."""
    rng = np.random.RandomState(11)
    with np.load(FIXTURE) as z:
        frames = z["images"]
    for i, (h, w) in enumerate([(480, 640), (256, 256), (320, 448),
                                (256, 344)]):
        img = frames[i % len(frames)]
        M = cv2.getRotationMatrix2D((rng.uniform(200, 440),
                                     rng.uniform(150, 330)),
                                    rng.uniform(-30, 30), 1)
        M = M / rng.uniform(0.8, 1.2)
        M[:, 2] -= rng.uniform(-100, 100, 2)
        for src, flag, ours in (
                (img, cv2.INTER_LINEAR, C.INTER_LINEAR),
                (rng.randint(0, 2, img.shape[:2]).astype(np.int32),
                 cv2.INTER_NEAREST, C.INTER_NEAREST)):
            want = cv2.warpAffine(src, M, (w, h), flags=flag)
            np.testing.assert_array_equal(
                C.warp_affine(_t(src), M, (w, h), ours).numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_resize_matches_cv2(seed):
    """INTER_LINEAR on uint8 HxWx3 up and down (2x down included),
    INTER_NEAREST on int32."""
    rng = np.random.RandomState(seed)
    sizes = [(rng.randint(1, 150), rng.randint(1, 150), rng.randint(1, 150),
              rng.randint(1, 150)) for _ in range(25)]
    sizes += [(40, 60, 20, 30), (41, 61, 41, 61), (120, 160, 96, 128),
              (96, 128, 120, 160)]
    for H, W, h, w in sizes:
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        m32 = rng.randint(-2 ** 31, 2 ** 31 - 1, (H, W)).astype(np.int32)
        np.testing.assert_array_equal(
            C.resize(_t(img), (w, h), C.INTER_LINEAR).numpy(),
            cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR))
        np.testing.assert_array_equal(
            C.resize(_t(m32), (w, h), C.INTER_NEAREST).numpy(),
            cv2.resize(m32, (w, h), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_gaussian_blur_matches_cv2(ksize):
    rng = np.random.RandomState(ksize)
    for _ in range(12):
        H, W = rng.randint(1, 90), rng.randint(1, 120)
        img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        np.testing.assert_array_equal(
            C.gaussian_blur(_t(img), ksize).numpy(),
            cv2.GaussianBlur(img, (ksize, ksize), 0))


def test_colour_conversions_match_cv2_on_every_colour():
    """RGB2GRAY, RGB2HSV and HSV2RGB of all 2^24 colours (4096 x 4096,
    rows of whole vector blocks), and HSV2RGB of every valid H, S, V
    (hue 0..179) in rows of 33 pixels: 32 through the vector formula and
    one through the scalar tail."""
    allc = np.arange(2 ** 24, dtype=np.uint32)
    img = np.stack([(allc >> 16) & 255, (allc >> 8) & 255, allc & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    for r in range(0, 4096, 1024):
        part = img[r:r + 1024]
        hsv = cv2.cvtColor(part, cv2.COLOR_RGB2HSV)
        got = C.rgb_to_hsv(_t(part))
        np.testing.assert_array_equal(got.numpy(), hsv)
        np.testing.assert_array_equal(C.hsv_to_rgb(got).numpy(),
                                      cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
        np.testing.assert_array_equal(C.rgb_to_gray(_t(part)).numpy(),
                                      cv2.cvtColor(part, cv2.COLOR_RGB2GRAY))
    hh, ss, vv = np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                             indexing="ij")
    hsv = np.stack([hh, ss, vv], -1).astype(np.uint8).reshape(-1, 3)
    hsv = np.concatenate([hsv, hsv[:(-len(hsv)) % 33]]).reshape(-1, 33, 3)
    np.testing.assert_array_equal(C.hsv_to_rgb(_t(hsv)).numpy(),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("size", [3, 5, 7, 9, 11, 15])
def test_filter2d_line_kernels_match_cv2(size):
    rng = np.random.RandomState(size)
    for horizontal in (True, False):
        for _ in range(4):
            H, W = rng.randint(1, 70), rng.randint(1, 90)
            img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
            k = np.zeros((size, size))
            if horizontal:
                k[(size - 1) // 2, :] = 1.0
            else:
                k[:, (size - 1) // 2] = 1.0
            k /= size
            np.testing.assert_array_equal(C.filter2d(_t(img), k).numpy(),
                                          cv2.filter2D(img, -1, k))


# --- augment.py against the JAX package ----------------------------------

def _views():
    """(image uint8 HxWx3, int32 mask, hcoords [9, 3] float32) of the
    fixture's two views at 480x640 and cut to odd sizes."""
    from _jax_aug_draws import raw_batch
    out = []
    imgs, masks, hc = raw_batch(480, 640, 0, 0)
    out += [(imgs[i], masks[i].astype(np.int32), hc[i]) for i in range(2)]
    imgs, masks, hc = raw_batch(121, 163, 180, 250)
    out += [(imgs[i], masks[i].astype(np.int32), hc[i]) for i in range(2)]
    return out


VIEWS = None


def _cases():
    global VIEWS
    if VIEWS is None:
        VIEWS = _views()
    return VIEWS


def _same(got, want, seed):
    """Port output == JAX output; images exact, hcoords to 1e-6 px."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if torch.is_tensor(g):
            g = g.numpy()
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (seed, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6,
                                       err_msg=str(seed))
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=str(seed))


def _both(fn_name, args, seed, img_index=0):
    """Call the port's and JAX's ``fn_name`` on (image, mask, hcoords)
    view ``img_index`` prefixed to ``args``, each with RandomState(seed);
    check outputs and RNG states."""
    img, mask, hc = _cases()[img_index]
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    got = getattr(TA, fn_name)(_t(img), mask.copy(), *args(hc), r1)
    want = getattr(JA, fn_name)(img.copy(), mask.copy(), *args(hc), r2)
    _same(got, want, seed)
    s1, s2 = r1.get_state(), r2.get_state()
    assert s1[2] == s2[2] and np.array_equal(s1[1], s2[1])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("view", [0, 2])
def test_rotate_instance_matches_jax(seed, view):
    _both("rotate_instance", lambda hc: (hc, -30, 30), seed, view)


def test_flip_matches_jax():
    for img, mask, hc in _cases():
        _same(TA.flip(_t(img), mask, hc), JA.flip(img, mask, hc), 0)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("view,thw", [(0, (384, 512)), (2, (150, 200)),
                                      (2, (100, 300)), (0, (480, 640))])
def test_crop_or_padding_instance_matches_jax(seed, view, thw):
    _both("crop_or_padding_to_fixed_size_instance",
          lambda hc: (hc, thw[0], thw[1], 0.8), seed, view)


@pytest.mark.parametrize("seed", range(3))
def test_crop_or_padding_matches_jax(seed):
    img, mask, _ = _cases()[2]
    for th, tw in ((64, 80), (200, 100), (121, 163)):
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        _same(TA.crop_or_padding_to_fixed_size(_t(img), mask, th, tw, r1),
              JA.crop_or_padding_to_fixed_size(img, mask, th, tw, r2), seed)
        assert r1.randint(1 << 30) == r2.randint(1 << 30)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("view,hw", [(0, (256, 344)), (2, (96, 128))])
def test_crop_resize_v1_matches_jax(seed, view, hw):
    _both("crop_resize_instance_v1",
          lambda hc: (hc, hw[0], hw[1], 0.8, 0.8, 1.2), seed, view)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("view,hw", [(0, (256, 344)), (2, (96, 128))])
def test_crop_resize_v2_matches_jax(seed, view, hw):
    _both("crop_resize_instance_v2",
          lambda hc: (hc, hw[0], hw[1], 0.8, 20, 130, 20, 130), seed, view)
    _, mask, _ = _cases()[view]
    assert TA.compute_resize_range(mask, 20, 130, 20, 130) == \
        JA.compute_resize_range(mask, 20, 130, 20, 130)


def test_mask_out_instance_matches_jax():
    """Rectangles over the instance, and over masks at the frame's top and
    left edges, where ``loc - side`` goes negative and numpy's slice
    counts from the end (an empty or a wrapped rectangle)."""
    img, mask, _ = _cases()[2]
    edge = np.zeros_like(mask)
    edge[0:50, 0:60] = 1
    negative = 0
    for seed in range(40):
        m = mask if seed % 2 else edge
        r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
        lo, hi = (0.1, 0.4) if seed % 4 < 2 else (0.5, 1.5)
        _same(TA.mask_out_instance(_t(img), m, lo, hi, r1),
              JA.mask_out_instance(img, m, lo, hi, r2), seed)
        assert r1.randint(1 << 30) == r2.randint(1 << 30)
        r3 = np.random.RandomState(seed)
        ys, xs = np.nonzero(m)
        y_side = int((ys.max() - ys.min()) * r3.uniform(lo, hi) / 2)
        x_side = int((xs.max() - xs.min()) * r3.uniform(lo, hi) / 2)
        r3.randint(xs.min(), max(xs.max(), xs.min() + 1))
        y_loc = r3.randint(ys.min(), max(ys.max(), ys.min() + 1))
        negative += y_loc - y_side < 0
    assert negative >= 5


@pytest.mark.parametrize("ksize", [3, 5, 7, 9])
def test_blur_image_matches_jax(ksize):
    img = _cases()[0][0]
    np.testing.assert_array_equal(TA.blur_image(_t(img), ksize).numpy(),
                                  JA.blur_image(img, ksize))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("amounts", [(0.1, 0.1, 0.05, 0.05),
                                     (0.4, 0.4, 0.6, 0.5),
                                     (0.0, 0.3, 0.0, 0.0)])
def test_color_jitter_matches_jax(seed, amounts):
    img = _cases()[2][0]
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    got = TA.color_jitter(_t(img), *amounts, r1)
    want = JA.color_jitter(img, *amounts, r2)
    np.testing.assert_array_equal(got.numpy(), want)
    assert r1.randint(1 << 30) == r2.randint(1 << 30)


def test_hue_shift_wraps_in_uint8_as_jax():
    """ROADMAP F9: hue 179 shifted by f_hue = -0.05 (171 in uint8) gives
    (179 + 171) % 256 % 180 = 94, not 170, in both packages."""
    img = np.zeros((1, 40, 3), np.uint8)
    img[..., 0], img[..., 2] = 255, 9                  # hue 179 in 0..179
    assert cv2.cvtColor(img, cv2.COLOR_RGB2HSV)[0, 0, 0] == 179

    class Fixed:
        def uniform(self, lo, hi):
            return -0.05 if lo < 0 else 1.0
    got = TA.color_jitter(_t(img), 0.1, 0.1, 0.1, 0.05, Fixed())
    want = JA.color_jitter(img, 0.1, 0.1, 0.1, 0.05, Fixed())
    np.testing.assert_array_equal(got.numpy(), want)
    assert cv2.cvtColor(want, cv2.COLOR_RGB2HSV)[0, 0, 0] in (93, 94, 95)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("view,hw", [(0, (480, 640)), (0, (256, 256)),
                                     (2, (256, 344)), (3, (96, 128))])
def test_fused_rotate_crop_resize_matches_jax(seed, view, hw):
    _both("fused_rotate_crop_resize",
          lambda hc: (hc, hw[0], hw[1], -30, 30, 0.8, 0.8, 1.2), seed, view)


@pytest.mark.parametrize("seed", [0, 1, 2, 4, 24, 37, 45, 56, 59, 70])
def test_add_noise_matches_jax(seed):
    """Both branches: Gaussian noise, and from seeds 4 to 70 (first draw
    >= 0.9) the motion blur's line kernels."""
    img = _cases()[2][0]
    r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
    np.testing.assert_array_equal(TA.add_noise(_t(img), r1).numpy(),
                                  JA.add_noise(img, r2))
    assert r1.randint(1 << 30) == r2.randint(1 << 30)
