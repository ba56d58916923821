"""The port's JPEG/PNG decoder (pvnet_tpu_torch/data/image_io.py) against
the JAX package's readers (pvnet_tpu/data/linemod.py read_rgb_np: cv2, and
read_mask_np: PIL), byte for byte, on the CPU (the plain Python entropy
decoder and PNG unfilter, the plain PyTorch pixel stage)."""
import io

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from _png_rows import filtered_stream
from pvnet_tpu.data.linemod import read_mask_np, read_rgb_np
from pvnet_tpu_torch.data import image_io as IO


def _smooth(h, w, seed):
    """A frame with gradients, edges and noise (what a camera gives)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255.0 / w, y * 255.0 / h, ((x + y) % 64) * 4.0], -1)
    img[h // 3:h // 2, w // 4:w // 2] = [250, 30, 60]
    return np.clip(img + rng.rand(h, w, 3) * 40, 0, 255).astype(np.uint8)


def _same(path):
    got = IO.read_rgb(str(path))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    want = read_rgb_np(str(path))
    np.testing.assert_array_equal(got.numpy(), want)


JPEG_CASES = {
    "q75_420": {},                                   # PIL's default
    "q95_444": {"quality": 95, "subsampling": 0},
    "q75_422": {"subsampling": 1},
    "q10_420": {"quality": 10},
}


@pytest.mark.parametrize("hw", [(48, 64), (37, 53), (120, 160), (17, 3),
                                (9, 2)])
@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_equals_cv2(tmp_path, hw, case):
    p = tmp_path / "f.jpg"
    Image.fromarray(_smooth(*hw, seed=hw[0])).save(p, **JPEG_CASES[case])
    _same(p)


@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
def test_gray_and_restart_jpeg_equal_cv2(tmp_path, hw):
    img = _smooth(*hw, seed=1)
    gray = tmp_path / "g.jpg"
    Image.fromarray(img[..., 0]).save(gray)
    _same(gray)
    rst = tmp_path / "r.jpg"
    assert cv2.imwrite(str(rst), img[..., ::-1],
                       [cv2.IMWRITE_JPEG_RST_INTERVAL, 4])
    assert b"\xff\xdd" in rst.read_bytes()            # a DRI segment
    _same(rst)


def test_truncated_jpeg_equals_cv2(tmp_path):
    # tests/test_data.py::test_read_rgb_tolerates_truncated_jpeg's file:
    # the MCU in which the data ends decodes on zero bits, later blocks
    # stay zero (uniform gray)
    img = (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    data = buf.getvalue()
    p = tmp_path / "trunc.jpg"
    p.write_bytes(data[:len(data) * 2 // 3])
    _same(p)
    out = IO.read_rgb(str(p)).numpy()
    assert (out[-8:] == 128).all()


@pytest.mark.parametrize("seed", range(6))
def test_truncated_noise_jpeg_equals_cv2(tmp_path, seed):
    """Truncated noise at quality 10: the garbage decoded past the end
    reaches |x| >= 512 before the level shift, where libjpeg-turbo's SIMD
    IDCT (cv2's) saturates and jidctint.c's table would wrap."""
    rng = np.random.RandomState(seed)
    h, w = rng.randint(24, 90, 2)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=10)
    data = buf.getvalue()
    p = tmp_path / "t.jpg"
    for cut in (len(data) * 2 // 3, len(data) // 2 + 37):
        p.write_bytes(data[:cut])
        if cv2.imread(str(p)) is None:
            continue        # cv2 gives up: read_rgb_np falls back to PIL
        _same(p)


def test_progressive_jpeg_raises(tmp_path):
    p = tmp_path / "p.jpg"
    Image.fromarray(_smooth(32, 32, 0)).save(p, progressive=True)
    with pytest.raises(IO.ImageDecodeError, match=r"p\.jpg.*SOF2"):
        IO.read_rgb(str(p))


def test_coefficients_and_pixels_split(tmp_path):
    """The two stages apart: the plain entropy decoder's coefficients and
    tables, and the batched pixel stage over two images of one geometry
    through jpeg_pixels (the CPU takes the plain version)."""
    paths = []
    for k in range(2):
        p = tmp_path / f"{k}.jpg"
        Image.fromarray(_smooth(40, 72, k)).save(p)
        paths.append(str(p))
    cs = [IO.jpeg_coefficients_plain(open(p, "rb").read()) for p in paths]
    geo = cs[0].geometry
    assert geo == IO.JpegGeometry(40, 72, (2, 1, 1), (2, 1, 1))
    assert cs[0].coef.shape == (geo.total_blocks(), 64)
    coef = torch.from_numpy(np.stack([c.coef for c in cs]))
    qt = torch.from_numpy(np.stack([c.qt for c in cs]))
    out = torch.empty((2, 40, 72, 3), dtype=torch.uint8)
    IO.jpeg_pixels(coef, qt, geo, out=out)
    for k, p in enumerate(paths):
        np.testing.assert_array_equal(out[k].numpy(), read_rgb_np(p))
    batch = IO.decode_rgb_batch(paths)
    assert torch.equal(batch, out)
    assert IO.tile_blocks(geo) == (90, 20, 48, 32)


def _png(tmp_path, mode, seed):
    rng = np.random.RandomState(seed)
    base = (rng.rand(33, 47, 3) * 255).astype(np.uint8)
    base[:10] = base[0]                       # runs: Up/Sub rows
    im = Image.fromarray(base)
    im = im.quantize(7) if mode == "P" else im.convert(mode)
    p = tmp_path / f"m_{mode}.png"
    im.save(p)
    return str(p)


@pytest.mark.parametrize("mode", ["L", "1", "P", "RGB", "RGBA", "LA"])
def test_png_equals_pil_and_cv2(tmp_path, mode):
    p = _png(tmp_path, mode, 3)
    mask = IO.read_mask(p)
    want = read_mask_np(p)
    assert mask.dtype == np.int32 and mask.shape == want.shape
    np.testing.assert_array_equal(mask, want)
    np.testing.assert_array_equal(IO.read_rgb(p).numpy(), read_rgb_np(p))


@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_png_unfilter_every_filter_type(bpp):
    """Rows filtered with types 0-4 in turn (tests/_png_rows.py) come back
    unfiltered."""
    rows = np.random.RandomState(bpp).randint(0, 256, (10, 6 * bpp + 1),
                                              np.int64).astype(np.uint8)
    raw = filtered_stream(rows, bpp)
    np.testing.assert_array_equal(
        IO.png_unfilter_plain(raw, 10, rows.shape[1], bpp), rows)


def test_png_filters_pil_picks(tmp_path):
    """PIL picks a filter per row: Sub, Up and Paeth rows occur."""
    raw = IO.zlib.decompress(IO._png_chunks(
        open(_png(tmp_path, "RGB", 4), "rb").read(), "x")[5])
    stride = 47 * 3 + 1
    types = {raw[y * stride] for y in range(33)}
    assert {1, 2, 4} <= types, types
    rows = IO.png_unfilter_plain(raw, 33, 47 * 3, 3)
    np.testing.assert_array_equal(
        rows.reshape(33, 47, 3), np.asarray(Image.open(tmp_path /
                                                       "m_RGB.png")))


def test_mask_of_a_linemod_png(tmp_path):
    """A 480x640 mask as the generator writes it (mask * 255, mode L)."""
    mask = np.zeros((480, 640), np.uint8)
    mask[100:300, 200:420] = 255
    mask[150:160, 250:260] = 0
    p = tmp_path / "0000.png"
    Image.fromarray(mask).save(p)
    np.testing.assert_array_equal(IO.read_mask(str(p)), read_mask_np(str(p)))


def test_cpu_never_builds_the_kernels(monkeypatch, tmp_path):
    """On the CPU nothing reaches the C library (nvcc is absent here)."""
    from pvnet_tpu_torch.ops import kernel_lib

    def refuse():
        raise AssertionError("the CPU path called the C library")
    monkeypatch.setattr(kernel_lib, "library", refuse)
    p = tmp_path / "c.jpg"
    Image.fromarray(_smooth(16, 16, 2)).save(p)
    IO.read_rgb(str(p))
    IO.read_mask(_png(tmp_path, "L", 5))
    with pytest.raises(ValueError, match="unsupported device"):
        IO.read_mask(_png(tmp_path, "L", 5), device="meta")
