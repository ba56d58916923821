"""Stratified foreground selection (kernels K1 and K2).

For each spatial phase bucket (y mod a, x mod bb) select the pixel with
the highest score and return that pixel's C field values — the hot half of
:func:`pvnet_tpu_torch.ops.voting.sample_foreground` and of
:func:`~pvnet_tpu_torch.ops.voting.sample_foreground_packed`. Counterpart
of pvnet_tpu/ops/select_kernel.py, whose two Pallas kernels the CUDA
kernel in csrc/stratified_select.cu replaces:

- K1, :func:`stratified_select_cmajor`, a channel-major [b, C, h, w] field
  (``_kernel_cmajor``);
- K2, :func:`stratified_select`, a flat NHWC [b, h, w, C] field in float32
  or bfloat16 (``_kernel``).

Each wrapper launches the kernel for a CUDA tensor and takes its plain
version for a CPU tensor: :func:`stratified_select_cmajor_plain` and
:func:`stratified_select_plain`, the PyTorch ports of
``stratified_select_xla``. Values are selected, never blended, so kernel
and plain version return identical results.
"""
from __future__ import annotations

from typing import Tuple

import torch

from pvnet_tpu_torch.ops import kernel_lib

Selection = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(score: torch.Tensor, field: torch.Tensor, a: int, bb: int,
           cmajor: bool):
    layout = "[b, C, h, w]" if cmajor else "[b, h, w, C]"
    if score.dim() != 3 or field.dim() != 4:
        raise ValueError(f"score must be [b, h, w] and field {layout}; "
                         f"got {tuple(score.shape)}, {tuple(field.shape)}")
    b, h, w = score.shape
    hw = field.shape[2:] if cmajor else field.shape[1:3]
    if field.shape[0] != b or hw != (h, w):
        raise ValueError(f"field {tuple(field.shape)} does not match score "
                         f"{tuple(score.shape)}")
    if h % a or w % bb:
        raise ValueError(f"h={h}, w={w} must be multiples of a={a}, bb={bb}"
                         " (pad upstream)")
    if score.device != field.device:
        raise ValueError(f"score on {score.device}, field on {field.device}")


def _winners(score: torch.Tensor, a: int, bb: int):
    """Plain selection: phase-major transpose, argmax (first maximum
    wins). Returns best [b, a*bb], sel [b, a*bb] and each winner's pixel
    rows ys and columns xs [b, a*bb]."""
    b, h, w = score.shape
    ty_n, tx_n = h // a, w // bb
    st = (score.reshape(b, ty_n, a, tx_n, bb).permute(0, 2, 4, 1, 3)
          .reshape(b, a * bb, ty_n * tx_n))
    sel = torch.argmax(st, dim=2)                           # [b, a*bb]
    best = torch.gather(st, 2, sel[..., None])[..., 0]
    dev = score.device
    py = torch.arange(a, device=dev).repeat_interleave(bb)  # [a*bb]
    px = torch.arange(bb, device=dev).repeat(a)
    ys = (sel // tx_n) * a + py
    xs = (sel % tx_n) * bb + px
    return best, sel, ys, xs


def stratified_select_cmajor_plain(score: torch.Tensor, field: torch.Tensor,
                                   a: int, bb: int) -> Selection:
    """Plain PyTorch version of K1 (port of ``stratified_select_xla`` for
    a channel-major field). Runs on any device."""
    _check(score, field, a, bb, cmajor=True)
    b = score.shape[0]
    best, sel, ys, xs = _winners(score, a, bb)
    bi = torch.arange(b, device=score.device)[:, None]
    dirs = field[bi, :, ys, xs]                             # [b, a*bb, C]
    return (best.reshape(b, a, bb), sel.to(torch.int32).reshape(b, a, bb),
            dirs.reshape(b, a, bb, field.shape[1]))


def stratified_select_plain(score: torch.Tensor, field: torch.Tensor,
                            a: int, bb: int) -> Selection:
    """Plain PyTorch version of K2 (port of ``stratified_select_xla``):
    the same selection over a flat NHWC field. Runs on any device."""
    _check(score, field, a, bb, cmajor=False)
    b = score.shape[0]
    best, sel, ys, xs = _winners(score, a, bb)
    bi = torch.arange(b, device=score.device)[:, None]
    dirs = field[bi, ys, xs]                                # [b, a*bb, C]
    return (best.reshape(b, a, bb), sel.to(torch.int32).reshape(b, a, bb),
            dirs.reshape(b, a, bb, field.shape[3]))


def _launch_checks(score: torch.Tensor, field: torch.Tensor, dtypes):
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    if score.dtype != torch.float32 or field.dtype not in dtypes:
        raise TypeError(f"float32 score and a {'/'.join(map(str, dtypes))} "
                        f"field required; got {score.dtype}, {field.dtype}")
    if not (score.is_contiguous() and field.is_contiguous()):
        raise ValueError("score and field must be contiguous")


def _outputs(score: torch.Tensor, a: int, bb: int, c: int, dtype):
    b, dev = score.shape[0], score.device
    return (torch.empty((b, a, bb), dtype=torch.float32, device=dev),
            torch.empty((b, a, bb), dtype=torch.int32, device=dev),
            torch.empty((b, a, bb, c), dtype=dtype, device=dev))


def stratified_select_cmajor(score: torch.Tensor, field: torch.Tensor,
                             a: int, bb: int) -> Selection:
    """Per-phase winner over an [b, h, w] score map (kernel K1).

    Args:
      score: [b, h, w] float32; larger wins (callers use 2*foreground +
        uniform noise, so any foreground pixel beats any background one).
      field: [b, C, h, w] float32 channel-major field.
      a, bb: phase grid; h % a == 0 == w % bb.

    Returns:
      best [b, a, bb] float32 winning scores, idx [b, a, bb] int32 tile
      index ty*(w//bb)+tx of each winner (its pixel is (ty*a + phase_y,
      tx*bb + phase_x)), and dirs [b, a, bb, C] the winners' values.

    A CPU tensor runs :func:`stratified_select_cmajor_plain`; a CUDA tensor
    launches the kernel (and counts the launch in ``.launches``) or raises.
    """
    _check(score, field, a, bb, cmajor=True)
    if score.device.type == "cpu":
        return stratified_select_cmajor_plain(score, field, a, bb)
    _launch_checks(score, field, (torch.float32,))
    b, h, w = score.shape
    c = field.shape[1]
    best, idx, dirs = _outputs(score, a, bb, c, torch.float32)
    if b == 0:
        return best, idx, dirs
    lib = kernel_lib.library()
    with torch.cuda.device(score.device):
        err = lib.pvnet_select_cmajor(
            score.data_ptr(), field.data_ptr(), best.data_ptr(),
            idx.data_ptr(), dirs.data_ptr(), b, c, h, w, a, bb,
            torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(err, "pvnet_select_cmajor")
    stratified_select_cmajor.launches += 1
    return best, idx, dirs


stratified_select_cmajor.launches = 0


def stratified_select(score: torch.Tensor, field: torch.Tensor,
                      a: int, bb: int) -> Selection:
    """Per-phase winner over an [b, h, w] score map, NHWC field (kernel
    K2).

    Args:
      score: [b, h, w] float32; larger wins.
      field: [b, h, w, C] float32 or bfloat16 rows returned for each
        winner (the packed head field of ops/packed_tail.py).
      a, bb: phase grid; h % a == 0 == w % bb. Any (a, bb) launches (the
        Pallas kernel needs a % 8 == 0 and JAX falls back to XLA
        otherwise; both compute the same function).

    Returns best [b, a, bb] float32, idx [b, a, bb] int32 (as
    :func:`stratified_select_cmajor`) and dirs [b, a, bb, C] in the field's
    dtype.

    A CPU tensor runs :func:`stratified_select_plain`; a CUDA tensor
    launches the kernel (and counts the launch in ``.launches``) or raises.
    """
    _check(score, field, a, bb, cmajor=False)
    if score.device.type == "cpu":
        return stratified_select_plain(score, field, a, bb)
    _launch_checks(score, field, (torch.float32, torch.bfloat16))
    b, h, w = score.shape
    c = field.shape[3]
    best, idx, dirs = _outputs(score, a, bb, c, field.dtype)
    if b == 0:
        return best, idx, dirs
    lib = kernel_lib.library()
    with torch.cuda.device(score.device):
        err = lib.pvnet_select_nhwc(
            score.data_ptr(), field.data_ptr(), best.data_ptr(),
            idx.data_ptr(), dirs.data_ptr(), b, c, h, w, a, bb,
            field.element_size(), torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(err, "pvnet_select_nhwc")
    stratified_select.launches += 1
    return best, idx, dirs


stratified_select.launches = 0
