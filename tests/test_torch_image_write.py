"""The port's JPEG and PNG writers and its 16-bit PNG reading
(pvnet_tpu_torch/data/image_io.py, csrc/jpeg_encode.cu) against PIL and
the JAX package's readers: encode_jpeg writes PIL's bytes (its default
.jpg save: JFIF, quality 75, 4:2:0, islow, standard Huffman tables), the
written PNGs decode in PIL to the pixels given, and a 16-bit gray PNG
reads as ``read_mask_np`` reads it. The C encoder and unfilter (host code)
are compiled with the host's C++ compiler where there is one and held
against the plain versions."""
import ctypes
import io
import os
import shutil
import subprocess
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from pvnet_tpu.data.linemod import read_mask_np
from pvnet_tpu_torch.data import image_io as IO
from pvnet_tpu_torch.ops import kernel_lib

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pvnet_tpu_torch", "csrc")


def pil_jpeg(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG")
    return buf.getvalue()


def _image(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "noise":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "saturated":                 # primaries and extremes
        a = np.zeros((h, w, 3), np.uint8)
        a[..., rng.randint(3)] = 255
        a[::3, :, 1] = 255
        a[:, ::5] = 0
        return a
    if kind == "checker":                   # the largest AC coefficients
        g = (np.indices((h, w)).sum(0) % 2) * 255
        return np.repeat(g[..., None], 3, -1).astype(np.uint8)
    if kind == "smooth":
        y, x = np.mgrid[:h, :w]
        a = np.stack([(x * 7) % 256, (y * 5) % 256, ((x + y) * 3) % 256], -1)
        return (a + rng.randint(0, 12, (h, w, 3))).clip(0, 255).astype(
            np.uint8)
    raise ValueError(kind)


CASES = [("noise", 1, 1), ("noise", 17, 3), ("noise", 37, 53),
         ("saturated", 15, 17), ("checker", 16, 16), ("checker", 33, 31),
         ("smooth", 48, 64), ("smooth", 7, 100), ("saturated", 100, 7),
         ("noise", 120, 160), ("smooth", 480, 640), ("saturated", 1, 9),
         ("smooth", 2, 2)]


@pytest.mark.parametrize("kind,h,w", CASES)
def test_jpeg_bytes_equal_pil(kind, h, w):
    a = _image(kind, h, w, seed=h * 1000 + w)
    got = IO.encode_jpeg(a, "cpu")
    assert got == pil_jpeg(a)
    # and the port's own decoder reads it as cv2 does
    want = cv2.cvtColor(cv2.imdecode(np.frombuffer(got, np.uint8),
                                     cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(IO.decode_rgb_bytes(got).numpy(), want)


def test_jpeg_random_geometries_equal_pil():
    rng = np.random.RandomState(11)
    for _ in range(40):
        h, w = (int(v) for v in rng.randint(1, 70, 2))
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        assert IO.jpeg_encode_plain(a) == pil_jpeg(a), (h, w)


def test_plain_encoder_is_deterministic():
    a = _image("noise", 61, 83, seed=3)
    first = IO.jpeg_encode_plain(a)
    assert all(IO.jpeg_encode_plain(a.copy()) == first for _ in range(3))


def test_encode_jpeg_takes_rgb_uint8_only():
    for a in (np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 4), np.uint8),
              np.zeros((4, 4), np.uint8)):
        with pytest.raises(ValueError, match="RGB uint8"):
            IO.encode_jpeg(a)
    with pytest.raises(ValueError, match="out of range"):
        IO.encode_jpeg(np.zeros((0, 4, 3), np.uint8))


def test_cpu_writers_never_build_the_kernels(monkeypatch, tmp_path):
    def refuse():
        raise AssertionError("the CPU path built the kernel library")
    monkeypatch.setattr(kernel_lib, "build", refuse)
    monkeypatch.setattr(kernel_lib, "_lib", None)
    a = _image("smooth", 20, 30, seed=1)
    IO.write_jpeg(str(tmp_path / "a.jpg"), a, "cpu")
    IO.write_png(str(tmp_path / "a.png"), a)
    assert open(tmp_path / "a.jpg", "rb").read() == pil_jpeg(a)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/jpeg_encode.cu and jpeg_decode.cu's host code built with the
    host's C++ compiler (their device code is behind __CUDACC__)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    out = str(tmp_path_factory.mktemp("lib") / "libhost.so")
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    "-o", out, os.path.join(CSRC, "jpeg_encode.cu"),
                    os.path.join(CSRC, "jpeg_decode.cu")], check=True)
    lib = ctypes.CDLL(out)
    for name in ("pvnet_jpeg_encode", "pvnet_png_unfilter"):
        fn = getattr(lib, name)
        fn.argtypes = kernel_lib._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def test_c_encoder_equals_plain(host_lib, monkeypatch):
    monkeypatch.setattr(kernel_lib, "_lib", host_lib)
    for kind, h, w in CASES:
        a = _image(kind, h, w, seed=h + w)
        assert IO.jpeg_encode_native(a) == IO.jpeg_encode_plain(a), \
            (kind, h, w)


def test_c_encoder_reports_a_short_buffer(host_lib):
    a = _image("noise", 16, 16, seed=0)
    out = np.empty(100, np.uint8)
    n = ctypes.c_long(0)
    assert host_lib.pvnet_jpeg_encode(a.ctypes.data, 16, 16,
                                      out.ctypes.data, 100,
                                      ctypes.byref(n)) == -2
    assert n.value > 100
    assert host_lib.pvnet_jpeg_encode(a.ctypes.data, 0, 16,
                                      out.ctypes.data, 100,
                                      ctypes.byref(n)) == -1


@pytest.mark.parametrize("mode", ["L", "RGB", "I;16"])
def test_written_png_decodes_in_pil_to_the_pixels(tmp_path, mode):
    rng = np.random.RandomState(4)
    if mode == "L":
        a = rng.randint(0, 256, (23, 41)).astype(np.uint8)
    elif mode == "RGB":
        a = rng.randint(0, 256, (23, 41, 3)).astype(np.uint8)
    else:
        a = rng.randint(0, 65536, (23, 41)).astype(np.uint16)
    p = str(tmp_path / "a.png")
    IO.write_png(p, a)
    im = Image.open(p)
    assert im.mode == mode
    np.testing.assert_array_equal(np.asarray(im), a)
    np.testing.assert_array_equal(IO.read_mask(p), read_mask_np(p))


def test_write_png_rejects_other_arrays():
    for a in (np.zeros((3, 3), np.int32), np.zeros((3, 3, 4), np.uint8),
              np.zeros((3, 3, 3), np.uint16)):
        with pytest.raises(ValueError, match="PNG writing takes"):
            IO.encode_png(a)


def _pil_depth_png(path, seed):
    """A depth map as the JAX renderer writes it (PythonRenderer.run:
    millimetres clipped to uint16, saved by PIL as 16-bit gray)."""
    rng = np.random.RandomState(seed)
    depth = np.where(rng.rand(30, 50) < 0.3, 0.0,
                     rng.uniform(0.3, 70.0, (30, 50))).astype(np.float32)
    d16 = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
    Image.fromarray(d16).save(path)
    return d16


@pytest.mark.parametrize("seed", [0, 1])
def test_16bit_mask_reads_as_jax(tmp_path, seed):
    p = str(tmp_path / "0_depth.png")
    d16 = _pil_depth_png(p, seed)
    got = IO.read_mask(p)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, read_mask_np(p))
    np.testing.assert_array_equal(got, d16)
    # cv2.imread(IMREAD_COLOR) of a 16-bit image: the high bytes
    want = cv2.cvtColor(cv2.imread(p, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(IO.read_rgb(p).numpy(), want)


def test_16bit_unfilter_c_equals_plain(host_lib, tmp_path, monkeypatch):
    """PIL's 16-bit PNGs use filters on 2-byte samples (bpp 2)."""
    monkeypatch.setattr(kernel_lib, "_lib", host_lib)
    p = str(tmp_path / "d.png")
    d16 = _pil_depth_png(p, 5)
    data = open(p, "rb").read()
    native = IO.decode_png(data, p, native=True)
    plain = IO.decode_png(data, p, native=False)
    assert native.samples.dtype == np.uint16
    np.testing.assert_array_equal(native.samples, plain.samples)
    np.testing.assert_array_equal(native.samples[..., 0], d16)


@pytest.mark.parametrize("ctype", [2, 4, 6])
def test_other_16bit_colour_types_raise(ctype):
    ch = {2: 3, 4: 2, 6: 4}[ctype]
    raw = b"".join(b"\0" + bytes(2 * ch * 3) for _ in range(2))
    data = (IO._PNG_SIG
            + IO._png_chunk(b"IHDR", bytes.fromhex("0000000300000002")
                            + bytes([16, ctype, 0, 0, 0]))
            + IO._png_chunk(b"IDAT", zlib.compress(raw))
            + IO._png_chunk(b"IEND", b""))
    with pytest.raises(IO.ImageDecodeError,
                       match=f"colour type {ctype} at bit depth 16"):
        IO.decode_png(data)


def test_writers_on_a_cuda_tensor_device_need_the_library(monkeypatch):
    """A CUDA device takes the C encoder, never the plain one: without a
    library to build it raises."""
    def fail():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(kernel_lib, "build", fail)
    monkeypatch.setattr(kernel_lib, "_lib", None)
    monkeypatch.setattr(IO, "jpeg_encode_plain", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        IO.encode_jpeg(np.zeros((8, 8, 3), np.uint8), torch.device("cuda"))
