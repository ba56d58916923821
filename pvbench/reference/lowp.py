"""The reference's convolutions in a lower precision: the controls that a
comparison has to fail.

Each is a drop-in for ``F.conv2d`` in reference/fcn.forward. The input
and the kernel are rounded to the lower format, and the products are
summed in float32, as the card's tensor cores do; the rounding is written
out, so that it is the same on every device and on the CPU.

- ``tf32``: 10 explicit mantissa bits, round to nearest even (what TF32
  tensor cores read for a float32 configuration with TF32 off).
- ``fp8``: float8 e4m3 with one scale per tensor (the largest magnitude to
  448) for the input and the kernel, for a bfloat16 configuration. In
  training the backward pass multiplies the same rounded tensors with the
  output's gradient rounded to float8 e5m2 (largest magnitude to 57344),
  as fp8 training keeps its gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with 10 mantissa bits (ties to even)."""
    bits = x.contiguous().view(torch.int32)
    keep = bits + 0xFFF + ((bits >> 13) & 1)
    out = (keep & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """float32 -> float8 (e4m3, or e5m2) with a per-tensor scale, and
    back."""
    top = 448.0 if dtype == torch.float8_e4m3fn else 57344.0
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x.detach() / scale).to(dtype).to(torch.float32) * scale


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        xq, wq = round_fp8(x.float()), round_fp8(w.float())
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, dilation, b is not None)
        return F.conv2d(xq, wq, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, dilation, has_b = ctx.conf
        gq = round_fp8(g, torch.float8_e5m2)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding,
                                        dilation)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding,
                                         dilation)
        gb = g.sum((0, 2, 3)) if has_b else None
        return gx, gw, gb, None, None, None


def conv_tf32(x, w, b=None, stride=1, padding=0, dilation=1):
    return F.conv2d(round_tf32(x.float()), round_tf32(w.float()), b, stride,
                    padding, dilation)


def conv_fp8(x, w, b=None, stride=1, padding=0, dilation=1):
    return _Fp8Conv.apply(x, w, b, stride, padding, dilation)


CONTROLS = {"tf32": conv_tf32, "fp8": conv_fp8}
