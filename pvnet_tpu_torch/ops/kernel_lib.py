"""Build and load the port's CUDA kernels (``pvnet_tpu_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use, never at import, into ``pvnet_tpu_torch/build/`` (listed in
.gitignore). The library's file name carries a hash of the sources and the
flags, so an edited source is rebuilt and an unchanged one is reused.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` calls one on PyTorch's current
stream and turns a non-zero code into an error.

The selection and counting kernels (K1, K2, K3) and the PnP kernels are
reached through registered operators of the :data:`NAMESPACE` namespace
(``torch.ops.pvnet_torch.*``, defined in ops/select_kernel.py,
ops/voting.py and ops/pnp.py), so that ``torch.export`` can trace a
pipeline that launches them; importing ``pvnet_tpu_torch.ops`` registers
them.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

NAMESPACE = "pvnet_torch"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# -fmad=false: no multiply-add contraction anywhere (the count kernel also
# spells its rounding out with __fmul_rn/__fadd_rn; see count_inliers.cu).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes, in the order of the C signature
_SIGNATURES = {
    "pvnet_select_cmajor": [_VP, _VP, _VP, _VP, _VP,
                            _I, _I, _I, _I, _I, _I, _VP],
    "pvnet_select_nhwc": [_VP, _VP, _VP, _VP, _VP,
                          _I, _I, _I, _I, _I, _I, _I, _VP],
    "pvnet_count_inliers": [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                            ctypes.c_float, _I, _VP],
    "pvnet_count_inliers_bf16": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I,
                                 _I, ctypes.c_float, ctypes.c_float, _I,
                                 _VP],
    "pvnet_shift_lanes": [_VP, _VP, _VP, _I, _I, _I, _VP],
    "pvnet_shift_sublanes": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "pvnet_jpeg_pixels": [_VP, _VP, _VP] + [_I] * 10 + [_VP],
    "pvnet_pnp_epnp": [_VP, _I, _VP, _VP, _I, _VP, _VP, _I, _I, _VP],
    "pvnet_pnp_lm": [_VP, _VP, _I, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _VP],
    # host code of jpeg_decode.cu (no stream)
    "pvnet_jpeg_entropy_decode": [ctypes.c_char_p, ctypes.c_size_t, _VP, _I,
                                  _VP],
    "pvnet_png_unfilter": [ctypes.c_char_p, ctypes.c_size_t, _I, _I, _I,
                           _VP],
    # host code of jpeg_encode.cu (no stream)
    "pvnet_jpeg_encode": [_VP, _I, _I, _VP, ctypes.c_long, _VP],
}

_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile csrc/*.cu into the build directory (if not already there)
    and return the library's path. Each source compiles in its own nvcc
    process, all started together; one more nvcc links the objects."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR,
                            f"libpvnet_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o")
                for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} "
                              f"({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp_lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp_lib,
                               *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {err}")


def check_device(t: torch.Tensor) -> None:
    """The operators have a CPU (plain) and a CUDA (kernel) implementation;
    raise for a tensor on any other device."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current stream
    of ``device`` (its last argument); raise if it reports an error."""
    with torch.cuda.device(device):
        err = getattr(library(), name)(
            *args, torch.cuda.current_stream().cuda_stream)
    check(err, name)


def launch_counters() -> dict:
    """{kernel: its CUDA wrapper} of the kernels whose wrappers count
    their launches in ``.launches`` (each adds one where it launches its
    kernel): K1 ``stratified_select_cmajor``, K2 ``stratified_select``, K3
    ``count_inliers`` and its bf16 mode ``count_inliers_bf16``, K4
    ``shift_lanes``, K5 ``shift_sublanes``, the JPEG decoder's pixel
    stage ``jpeg_pixels``, and PnP's ``epnp`` and ``lm_multi_start``."""
    from pvnet_tpu_torch.data import image_io
    from pvnet_tpu_torch.ops import pnp, row_shift, select_kernel, voting
    fns = (select_kernel.stratified_select_cmajor,
           select_kernel.stratified_select, voting.count_inliers,
           voting.count_inliers_bf16, row_shift.shift_lanes,
           row_shift.shift_sublanes, image_io.jpeg_pixels, pnp.epnp,
           pnp.lm_multi_start)
    return {fn.__name__: fn for fn in fns}


def launch_counts() -> dict:
    """{kernel: launches so far in this process} (:func:`launch_counters`)."""
    return {name: fn.launches for name, fn in launch_counters().items()}
