"""Per-row / per-column circular integer shifts (kernels K4 and K5).

  shift_lanes(x, starts)    : y[p, r, c] = x[p, r, (starts[p, r] + c) % C]
  shift_sublanes(x, starts) : y[p, i, c] = x[p, (starts[p, c] + i) % H, c]

Counterpart of pvnet_tpu/ops/row_shift.py, whose Pallas kernels
``_lanes_kernel`` and ``_sublanes_kernel`` the CUDA kernels in
csrc/row_shift.cu replace. The separable affine warp of the training
augmentation (data/augment_device._sep_pass_cm) shifts every row of its
planes with :func:`shift_lanes`; :func:`shift_sublanes` is the same shift
along the other axis.

The shifts are circular by design: the consumer computes validity from the
true unwrapped position and zeroes out-of-range outputs. A CUDA tensor
launches the kernel (and counts the launch in ``.launches``) or raises; a
CPU tensor takes the plain version, the port of the JAX module's XLA
fallback. Elements are moved, never computed on, so both agree bit for bit.
"""
from __future__ import annotations

import torch

from pvnet_tpu_torch.ops import kernel_lib

# dtypes the kernels move as bits, by element size (torch.uint32 exists
# only in newer PyTorch releases)
_KERNEL_DTYPES = {getattr(torch, name): size for name, size in (
    ("float32", 4), ("int32", 4), ("uint32", 4), ("uint8", 1), ("int8", 1))
    if hasattr(torch, name)}


def shift_lanes_plain(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`shift_lanes` (a gather with an index
    from ``torch.remainder``). Runs on any device."""
    C = x.shape[2]
    idx = torch.remainder(starts.long()[..., None]
                          + torch.arange(C, device=x.device), C)
    return torch.gather(x, 2, idx)


def shift_sublanes_plain(x: torch.Tensor,
                         starts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`shift_sublanes`. Runs on any
    device."""
    H = x.shape[1]
    idx = torch.remainder(starts.long()[:, None, :]
                          + torch.arange(H, device=x.device)[None, :, None], H)
    return torch.gather(x, 1, idx)


def _check(x: torch.Tensor, starts: torch.Tensor, starts_shape, name: str):
    if x.dim() != 3 or tuple(starts.shape) != starts_shape:
        raise ValueError(f"{name}: x must be 3-D and starts "
                         f"{starts_shape}; got {tuple(x.shape)}, "
                         f"{tuple(starts.shape)}")
    if starts.dtype.is_floating_point or starts.dtype == torch.bool:
        raise TypeError(f"{name}: integer starts required, got "
                        f"{starts.dtype}")
    if starts.device != x.device:
        raise ValueError(f"{name}: x on {x.device}, starts on "
                         f"{starts.device}")


def _kernel_args(x: torch.Tensor, starts: torch.Tensor, n: int, name: str):
    """Validate a CUDA call; return (element size, int32 starts)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported; the kernel "
                        f"moves {sorted(map(str, _KERNEL_DTYPES))}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if starts.dtype != torch.int32:
        # the kernel reduces int32 shifts itself; others are reduced here,
        # in int64 so that neither n nor the cast can overflow the type
        starts = torch.remainder(starts.long(), n).to(torch.int32)
    return _KERNEL_DTYPES[x.dtype], starts.contiguous()


def shift_lanes(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """y[p, r, c] = x[p, r, (starts[p, r] + c) % C].

    x: [P, R, C] (float32, int32, uint32, uint8 or int8 on the card; any
    dtype on the CPU); starts: [P, R] any integer dtype, any value."""
    _check(x, starts, tuple(x.shape[:2]), "shift_lanes")
    if x.device.type == "cpu":
        return shift_lanes_plain(x, starts)
    P, R, C = x.shape
    esize, starts = _kernel_args(x, starts, C, "shift_lanes")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    kernel_lib.launch("pvnet_shift_lanes", x.device, x.data_ptr(),
                      starts.data_ptr(), y.data_ptr(), P * R, C, esize)
    shift_lanes.launches += 1
    return y


def shift_sublanes(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """y[p, i, c] = x[p, (starts[p, c] + i) % H, c].

    x: [P, H, C] (dtypes as :func:`shift_lanes`); starts: [P, C] any
    integer dtype, any value."""
    _check(x, starts, (x.shape[0], x.shape[2]), "shift_sublanes")
    if x.device.type == "cpu":
        return shift_sublanes_plain(x, starts)
    P, H, C = x.shape
    esize, starts = _kernel_args(x, starts, H, "shift_sublanes")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    kernel_lib.launch("pvnet_shift_sublanes", x.device, x.data_ptr(),
                      starts.data_ptr(), y.data_ptr(), P, H, C, esize)
    shift_sublanes.launches += 1
    return y


shift_lanes.launches = 0
shift_sublanes.launches = 0
