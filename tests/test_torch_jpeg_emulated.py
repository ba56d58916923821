"""The JPEG pixel kernel's own CUDA source (csrc/jpeg_decode.cu), run on
the CPU under an emulation of the CUDA built-ins it uses
(tests/_cuda_emu.h), against ``jpeg_pixels_plain``.

g++ builds the source with its C entry ``pvnet_jpeg_pixels`` unchanged:
the launch plan, the slot groups and descriptors, both transform passes
(the halo blocks' edge rows and columns among them), the edge
replication, the pixel stage and the 16-byte copy out run as written,
every CUDA thread a host thread. Only the inline PTX is swapped for its
host meaning (the cp.async copy for a memcpy). This holds the kernel's
logic on small geometries at every sampling and halo layout the card
takes, with tiles 2 and 4 MCU rows tall; tests/test_torch_cuda.py holds
the compiled kernel on the card, and tests/test_torch_jpeg_int32.py its
32-bit arithmetic.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pvnet_tpu_torch.data import image_io as IO

_TESTS = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(_TESTS), "pvnet_tpu_torch", "csrc",
                       "jpeg_decode.cu")

_HARNESS = r'''
#include "_cuda_emu.h"
#include "jpeg_emu.cu"
#include <memory>
#include <random>

int (*emu_launch_hook)(const void*, dim3, dim3, void**, size_t);
static int plan_gx, plan_gy, plan_threads, plan_smem;

// Runs the grid a block at a time, all the block's threads at once.
static int launch(const void* fn, dim3 grid, dim3 block, void** a,
                  size_t smem) {
  using K = void (*)(const int16_t*, const int32_t*, uint8_t*, Geo);
  const K k = (K)fn;
  const int16_t* coef = *(const int16_t**)a[0];
  const int32_t* qt = *(const int32_t**)a[1];
  uint8_t* out = *(uint8_t**)a[2];
  const Geo g = *(const Geo*)a[3];
  blockDim = block;
  gridDim = grid;
  const int nt = block.x;
  plan_gx = grid.x; plan_gy = grid.y; plan_threads = nt;
  plan_smem = (int)smem;
  if (nt % 32 || nt > 1024) return 98;
  std::mt19937 noise(1);
  std::vector<uint8_t> mem(smem);
  std::vector<int> shfl(nt);
  for (unsigned z = 0; z < grid.z; z++)
    for (unsigned y = 0; y < grid.y; y++)
      for (unsigned x = 0; x < grid.x; x++) {
        for (auto& v : mem) v = (uint8_t)noise();
        std::barrier<> bar(nt);
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        EmuBlock blk{&bar, {}, shfl.data(), mem.data()};
        for (int w = 0; w < nt / 32; w++) {
          warps.emplace_back(new std::barrier<>(32));
          blk.warps.push_back(warps.back().get());
        }
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; t++)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            emu_blk = &blk;
            k(coef, qt, out, g);
          });
        for (auto& t : ts) t.join();
      }
  return 0;
}

extern "C" int emu_pixels(const int16_t* coef, const int32_t* qt,
                          uint8_t* out, int B, int H, int W, int nc, int h0,
                          int v0, int h1, int v1, int h2, int v2,
                          long* plan) {
  emu_launch_hook = launch;
  emu_ns = 0;
  const int r = pvnet_jpeg_pixels(coef, qt, out, B, H, W, nc, h0, v0, h1,
                                  v1, h2, v2, nullptr);
  plan[0] = plan_gx; plan[1] = plan_gy; plan[2] = plan_threads;
  plan[3] = plan_smem; plan[4] = emu_ns;
  return r;
}
'''


def _host_source(src: str, fill: int = 0) -> str:
    """The kernel's source with its inline PTX in host terms, and each
    block's slot counts recorded; ``fill``, where given, in place of the
    blocks that a launch plan keeps per card before it makes its tiles
    taller (1: every tile 4 MCU rows tall)."""
    src = src.replace("#include <cuda_runtime.h>\n", "")
    src, n = re.subn(r'asm volatile\("cp\.async\.cg\.shared\.global.*?\);',
                     "memcpy(dst, src, 16);", src, flags=re.S)
    subs = {
        'asm volatile("cp.async.wait_all;\\n" ::: "memory");': ";",
        "extern __shared__ __align__(16) uint8_t sm[];":
            "uint8_t* sm = emu_blk->smem;",
        "const int ns = gr.ns;":
            "const int ns = gr.ns; if (threadIdx.x == 0) emu_ns += ns;",
    }
    if fill:
        subs["constexpr int kFillBlocks = 8 * 132;"] = (
            f"constexpr int kFillBlocks = {fill};")
    for old, new in subs.items():
        assert old in src, old
        src = src.replace(old, new)
    assert n == 1 and "asm" not in re.sub(r"//.*", "", src)
    return src


def _build(tmp_path_factory, fill):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the host")
    d = tmp_path_factory.mktemp("jpeg_emu")
    with open(_SOURCE) as f:
        (d / "jpeg_emu.cu").write_text(_host_source(f.read(), fill))
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libjpeg_emu.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared",
                        "-fPIC", "-D__CUDACC__", "-Wno-pointer-arith",
                        f"-I{_TESTS}", "-o", str(lib),
                        str(d / "harness.cpp")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    fn = ctypes.CDLL(str(lib)).emu_pixels
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    return _build(tmp_path_factory, 0)


@pytest.fixture(scope="module")
def emu_tall(tmp_path_factory):
    return _build(tmp_path_factory, 1)


def _coefficients(geo, b, extreme, seed):
    g = torch.Generator().manual_seed(seed)
    n = geo.total_blocks()
    if extreme:
        coef = torch.randint(-32768, 32768, (b, n, 64), generator=g)
        qt = torch.randint(1, 65536, (b, geo.nc, 64), generator=g)
    else:
        coef = (torch.randn(b, n, 64, generator=g)
                * torch.linspace(300, 5, 64)).round()
        coef[..., 0] = torch.randint(-1024, 1024, (b, n), generator=g)
        qt = torch.randint(1, 100, (b, geo.nc, 64), generator=g)
    return coef.to(torch.int16).numpy(), qt.to(torch.int32).numpy()


def _run(emu, geo, coef, qt, offset):
    """The emulated launch into a buffer at byte ``offset``: (rc, output,
    the bytes around it untouched, the plan [grid x, grid y, threads,
    shared bytes, slots of all blocks])."""
    b = coef.shape[0]
    n = b * geo.height * geo.width * 3
    buf = np.full(n + offset + 32, 7, np.uint8)
    plan = (ctypes.c_long * 5)()
    h = list(geo.h) + [1] * (3 - geo.nc)
    v = list(geo.v) + [1] * (3 - geo.nc)
    rc = emu(coef.ctypes.data, qt.ctypes.data, buf.ctypes.data + offset, b,
             geo.height, geo.width, geo.nc, h[0], v[0], h[1], v[1], h[2],
             v[2], plan)
    out = buf[offset:offset + n].reshape(b, geo.height, geo.width, 3)
    around = (buf[:offset] == 7).all() and (buf[offset + n:] == 7).all()
    return rc, out, around, list(plan)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("h,w,hs,vs", [
    (37, 53, (1, 1, 1), (1, 1, 1)), (37, 53, (2, 1, 1), (1, 1, 1)),
    (37, 53, (2, 1, 1), (2, 1, 1)), (17, 3, (2, 1, 1), (2, 1, 1)),
    (9, 2, (2, 1, 1), (1, 1, 1)), (1, 1, (2, 1, 1), (2, 1, 1)),
    (5, 4, (2, 1, 1), (2, 1, 1)), (61, 83, (1,), (1,)),
    (40, 72, (2, 2, 2), (1, 1, 1)), (32, 32, (2, 2, 2), (2, 2, 2)),
    (33, 47, (2, 1, 2), (2, 1, 2)), (33, 47, (2, 2, 1), (2, 2, 1)),
    (33, 47, (1, 1, 1), (2, 2, 2)), (65, 130, (2, 1, 1), (2, 1, 1)),
    (24, 2100, (2, 1, 1), (2, 1, 1)), (17, 2100, (2, 1, 1), (1, 1, 1)),
])
def test_emulated_kernel_matches_plain(emu, h, w, hs, vs, extreme):
    """Every sampling (4:4:4, 4:2:2, 4:2:0, gray, mixed ratios, all
    components at 2x2), tiles cut by the image's edge, box upsampling,
    tiles 16 MCUs wide (2100 wide), b=2 (tiles 2 MCU rows tall), into an
    output at an odd byte offset; extreme coefficients and 16-bit tables
    for the wrap and both saturations. Exact, and the launch's slots are
    the plan's (image_io.tile_blocks)."""
    geo = IO.JpegGeometry(h, w, hs, vs)
    coef, qt = _coefficients(geo, 2, extreme, h * w)
    want = IO.jpeg_pixels_plain(torch.from_numpy(coef), torch.from_numpy(qt),
                                geo).numpy()
    rc, got, around, plan = _run(emu, geo, coef, qt, 3 if extreme else 0)
    assert rc == 0, plan
    np.testing.assert_array_equal(got, want)
    assert around
    assert plan[4] == 2 * sum(IO.tile_blocks(geo, 2)), plan


@pytest.mark.parametrize("h,w,hs,vs", [
    (37, 53, (2, 1, 1), (2, 1, 1)), (70, 53, (2, 1, 1), (1, 1, 1)),
    (61, 83, (1,), (1,)), (33, 47, (2, 1, 2), (2, 1, 2)),
    (40, 72, (2, 2, 2), (1, 1, 1)), (24, 2100, (2, 1, 1), (2, 1, 1)),
])
def test_emulated_tall_tiles_match_plain(emu_tall, monkeypatch, h, w, hs,
                                         vs):
    """Tiles of 4 MCU rows (what the plan picks for large batches; here
    for every launch), the last tile row cut short: exact, into an
    output at an odd byte offset, with the plan's slots."""
    monkeypatch.setattr(IO, "FILL_BLOCKS", 1)
    geo = IO.JpegGeometry(h, w, hs, vs)
    coef, qt = _coefficients(geo, 2, True, h + w)
    want = IO.jpeg_pixels_plain(torch.from_numpy(coef), torch.from_numpy(qt),
                                geo).numpy()
    rc, got, around, plan = _run(emu_tall, geo, coef, qt, 1)
    assert rc == 0, plan
    np.testing.assert_array_equal(got, want)
    assert around
    assert plan[4] == 2 * sum(IO.tile_blocks(geo, 2)), plan


def test_emulated_kernel_refuses(emu):
    """The C entry refuses what the kernel does not take, as the wrapper
    does before it: component 0 not the largest, a 1x2 ratio, factors
    above 2, no images."""
    for hs, vs in (((1, 2, 1), (1, 1, 1)), ((2, 2, 1), (2, 1, 2)),
                   ((4, 1, 1), (1, 1, 1))):
        geo = IO.JpegGeometry(16, 16, hs, vs)
        coef = np.zeros((1, geo.total_blocks(), 64), np.int16)
        qt = np.ones((1, 3, 64), np.int32)
        assert _run(emu, geo, coef, qt, 0)[0] != 0
    geo = IO.JpegGeometry(16, 16, (1,), (1,))
    coef = np.zeros((0, 4, 64), np.int16)
    assert _run(emu, geo, coef, np.ones((0, 1, 64), np.int32), 0)[0] != 0
