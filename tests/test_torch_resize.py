"""data/resample.resize_bilinear (the served image's resize, without PIL)
against PIL's ``Image.resize(size, Image.BILINEAR)``: uint8 RGB and "L"
images exactly, float channels as mode "F" images within 1e-5."""
import numpy as np
import pytest
from PIL import Image

from pvnet_tpu_torch.data.resample import resize_bilinear

# (h, w) -> (height, width): up, down by 2-4x, mixed, odd sizes, 1-pixel
# edges, one axis unchanged, a full frame both ways
CASES = [
    ((17, 23), (40, 50)),
    ((64, 80), (32, 40)),
    ((96, 96), (24, 32)),
    ((120, 160), (30, 40)),
    ((120, 160), (37, 53)),
    ((33, 47), (70, 20)),
    ((33, 47), (33, 20)),
    ((33, 47), (70, 47)),
    ((1, 1), (5, 7)),
    ((5, 1), (1, 9)),
    ((7, 9), (1, 1)),
    ((1, 13), (3, 4)),
    ((48, 40), (64, 64)),
    ((480, 640), (360, 480)),
]


@pytest.mark.parametrize("src,dst", CASES)
def test_uint8_rgb_equals_pil(src, dst):
    rng = np.random.RandomState(sum(src) + 7 * sum(dst))
    img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1],
                                                   Image.BILINEAR))
    got = resize_bilinear(img, *dst)
    assert got.dtype == np.uint8 and got.shape == dst + (3,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,dst", CASES)
def test_float_channel_equals_pil_mode_f(src, dst):
    """Normalized values (signs, fractions) as one mode "F" image per
    channel: float64 sums rounded to float32 after each pass, within
    1e-5."""
    rng = np.random.RandomState(3 + sum(src) + sum(dst))
    img = (rng.randn(*src, 3) * 2.5).astype(np.float32)
    want = np.stack([np.asarray(Image.fromarray(img[..., c], mode="F")
                                .resize(dst[::-1], Image.BILINEAR))
                     for c in range(3)], -1)
    got = resize_bilinear(img, *dst)
    assert got.dtype == np.float32 and got.shape == dst + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gray_and_constant_images():
    """A 2-D "L" image keeps its rank; a constant image stays constant
    (the coefficients of every output pixel sum to one)."""
    rng = np.random.RandomState(1)
    gray = rng.randint(0, 256, (29, 31)).astype(np.uint8)
    np.testing.assert_array_equal(
        resize_bilinear(gray, 11, 70),
        np.asarray(Image.fromarray(gray).resize((70, 11), Image.BILINEAR)))
    flat = np.full((13, 17, 3), 201, np.uint8)
    assert (resize_bilinear(flat, 40, 5) == 201).all()


def test_same_size_is_a_copy_and_bad_input_raises():
    img = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    out = resize_bilinear(img, 2, 4)
    np.testing.assert_array_equal(out, img)
    assert out is not img
    with pytest.raises(TypeError):
        resize_bilinear(img.astype(np.int32), 3, 3)
    with pytest.raises(ValueError):
        resize_bilinear(img, 0, 3)
