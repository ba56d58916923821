"""Int8 post-training-quantized convolution for inference.

Port of pvnet_tpu/ops/quant_conv.py (``Conv`` with ``quant=True``,
``conv2d_int8``, ``calibrate``), the same symmetric scheme:

- weights: a per-output-channel scale absmax/127, quantized from the float
  weight at call time (round half to even, clipped to +-127), so a
  checkpoint serves the float and the int8 model alike;
- activations: ``mode`` 'dynamic' takes each image's absmax ([b, 1, 1, 1]
  scale, so an image's result never depends on its batchmates);
  'calibrate' also keeps the running absmax of every call in the
  non-persistent buffer ``act_absmax`` and uses it; 'static' uses the
  calibrated scalar, and falls back to the per-image scale while there is
  none, as the JAX module does without a ``quant`` collection;
- accumulation in int32, exact; the result is dequantized as
  ``acc * (s_x * s_w)`` in float32, the bias added in float32, and returned
  in the dtype an ``nn.Conv2d`` returns in the same place (bfloat16 under
  autocast).

The int32 product (:func:`conv_int8_acc`) runs on the CPU as a float64
convolution over the int8 codes, exact since |sum| <= 127^2 * 4608 < 2^53.
On the card it is the JAX package's XLA int8 convolution's counterpart, a
library GEMM: the kxk taps of the padded, dilated, strided channels-last
int8 input are gathered into [N*Ho*Wo, k*k*Cin] and multiplied by the
[k*k*Cin, Cout] int8 weight with ``torch._int_mm`` (cuBLASLt's int8 tensor
cores). That call needs more than 16 rows and K and N multiples of 8; every
quantized convolution of the serving preset meets it (Cin and Cout are
multiples of 8: the backbone's 64-512 channels, the decoder's 384 and 512,
the packed tail's 4x-packed 128-2048), and a shape that does not raises.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MODES = ("dynamic", "calibrate", "static")


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127, a correctly rounded division on every
    device (PyTorch's CUDA kernels multiply by the reciprocal of a Python
    scalar divisor, which can differ from JAX's quotient by an ulp)."""
    return amax.clamp_min(1e-12) / torch.full((), 127.0, device=amax.device)


def weight_codes(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW float weight -> (int8 codes [cout, cin, kh, kw], float32 scale
    [cout])."""
    wf = w.float()
    s_w = _scale(wf.abs().amax(dim=(1, 2, 3)))
    q = torch.clamp(torch.round(wf / s_w[:, None, None, None]), -127, 127)
    return q.to(torch.int8), s_w


def image_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-image activation scale [b, 1, 1, 1] of [b, c, h, w]."""
    return _scale(x.float().abs().amax(dim=(1, 2, 3), keepdim=True))


def activation_codes(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """x / s_x rounded half to even and clipped to +-127, as int8."""
    return torch.clamp(torch.round(x.float() / s_x), -127, 127) \
        .to(torch.int8)


def conv_int8_acc_plain(q: torch.Tensor, w_q: torch.Tensor, stride=1,
                        padding=0, dilation=1) -> torch.Tensor:
    """Plain version of :func:`conv_int8_acc`: a float64 convolution of
    the codes, exact, cast to int32."""
    return F.conv2d(q.double(), w_q.double(), None, _pair(stride),
                    _pair(padding), _pair(dilation)).to(torch.int32)


def _gather_taps(q: torch.Tensor, kh: int, kw: int, stride, padding,
                 dilation) -> Tuple[torch.Tensor, int, int]:
    """[b, c, h, w] int8 -> ([b*ho*wo, kh*kw*c] int8 rows, ho, wo): each
    output pixel's taps in (ky, kx, c) order, from the padded
    channels-last input."""
    b, c, h, w = q.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    ho = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    wo = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    x = q.permute(0, 2, 3, 1)
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        return x.reshape(b * h * w, c), ho, wo
    x = F.pad(x, (0, 0, pw, pw, ph, ph)).contiguous()
    sb, sy, sx, sc = x.stride()
    taps = x.as_strided((b, ho, wo, kh, kw, c),
                        (sb, sy * sh, sx * sw, sy * dh, sx * dw, sc))
    return taps.reshape(b * ho * wo, kh * kw * c), ho, wo


def conv_int8_acc(q: torch.Tensor, w_q: torch.Tensor, stride=1, padding=0,
                  dilation=1) -> torch.Tensor:
    """Int32 accumulators [b, cout, ho, wo] of the convolution of int8
    codes q [b, cin, h, w] with int8 weights w_q [cout, cin, kh, kw]
    (symmetric zero padding). A CPU tensor takes
    :func:`conv_int8_acc_plain`; a CUDA tensor the gathered-tap
    ``torch._int_mm`` route, counted in ``.launches``, or raises. The
    result is a channels-last view on the card."""
    if q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8 codes required; got {q.dtype}, {w_q.dtype}")
    stride, padding, dilation = (_pair(stride), _pair(padding),
                                 _pair(dilation))
    if q.device.type == "cpu":
        return conv_int8_acc_plain(q, w_q, stride, padding, dilation)
    if q.device.type != "cuda" or w_q.device != q.device:
        raise ValueError(f"codes on {q.device}, weights on {w_q.device}")
    cout, cin, kh, kw = w_q.shape
    if q.dim() != 4 or q.shape[1] != cin:
        raise ValueError(f"input {tuple(q.shape)} for weights "
                         f"{tuple(w_q.shape)}")
    rows, ho, wo = _gather_taps(q, kh, kw, stride, padding, dilation)
    m, k = rows.shape
    if m <= 16 or k % 8 or cout % 8:
        raise ValueError(f"torch._int_mm needs more than 16 rows and K, N "
                         f"multiples of 8; got M={m}, K={k}, N={cout}")
    w_cols = w_q.permute(0, 2, 3, 1).reshape(cout, k).t()   # [K, N] col-major
    acc = torch._int_mm(rows, w_cols)                       # [M, N] int32
    conv_int8_acc.launches += 1
    return acc.reshape(q.shape[0], ho, wo, cout).permute(0, 3, 1, 2)


conv_int8_acc.launches = 0


def conv2d_int8(x: torch.Tensor, w: torch.Tensor, stride=1, padding=0,
                dilation=1, s_x=None) -> torch.Tensor:
    """Functional int8 convolution (the JAX ``conv2d_int8``), NCHW input
    and OIHW float weights: per-output-channel weight scales, the
    activation scale ``s_x`` (a scalar or [b, 1, 1, 1]; by default each
    image's absmax/127), exact int32 accumulation, dequantized to float32.
    No bias, no activation."""
    w_q, s_w = weight_codes(w)
    s_x = image_scale(x) if s_x is None else torch.as_tensor(
        s_x, dtype=torch.float32, device=x.device)
    acc = conv_int8_acc(activation_codes(x, s_x), w_q, stride, padding,
                        dilation)
    return acc.float() * (s_x * s_w[:, None, None])


class QuantConv2d(nn.Conv2d):
    """``nn.Conv2d`` that runs int8 in eval mode (the JAX ``Conv`` with
    ``quant=True``); in training mode it is ``nn.Conv2d``. Parameters are
    ``nn.Conv2d``'s, so every checkpoint loads unchanged. ``mode`` is one
    of :data:`MODES`; ``act_absmax`` (non-persistent, None until
    calibrated) holds the running activation absmax."""

    def __init__(self, *args, mode: str = "dynamic", **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if self.groups != 1 or self.padding_mode != "zeros" or isinstance(
                self.padding, str):
            raise ValueError("quant conv: groups 1, explicit zero padding")
        self.mode = mode
        self.register_buffer("act_absmax", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return super().forward(x)
        return self.int8_conv(x, self.activation_scale(x), self.padding)

    def activation_scale(self, x: torch.Tensor,
                         reduce_max=None) -> torch.Tensor:
        """The eval-mode activation scale of input ``x`` in this module's
        mode (updating ``act_absmax`` when calibrating). ``reduce_max``,
        where given, takes an absmax ([b] per image, or a scalar) to its
        maximum over the other row shards of the same images
        (parallel/spatial.py), so that a shard's scale is the image's."""
        reduce_max = reduce_max or (lambda t: t)
        if self.mode == "calibrate":
            amax = reduce_max(x.detach().float().abs().amax())
            if self.act_absmax is not None:
                amax = torch.maximum(self.act_absmax, amax)
            self.act_absmax = amax
        if self.mode == "dynamic" or self.act_absmax is None:
            amax = reduce_max(x.float().abs().amax(dim=(1, 2, 3)))
            return _scale(amax)[:, None, None, None]
        return _scale(self.act_absmax)

    def int8_conv(self, x: torch.Tensor, s_x: torch.Tensor,
                  padding) -> torch.Tensor:
        """The eval-mode convolution of ``x`` at activation scale ``s_x``
        with zero ``padding`` (this module's own, or a row shard's)."""
        out = conv2d_int8(x, self.weight, self.stride, padding,
                          self.dilation, s_x)
        if self.bias is not None:
            out = out + self.bias.float()[:, None, None]
        dev = x.device.type
        dtype = (torch.get_autocast_dtype(dev)
                 if torch.is_autocast_enabled(dev) else x.dtype)
        return out.to(dtype)


def quant_convs(model: nn.Module) -> Dict[str, QuantConv2d]:
    """{qualified name: module} of every QuantConv2d in ``model``."""
    return {n: m for n, m in model.named_modules()
            if isinstance(m, QuantConv2d)}


@torch.no_grad()
def calibrate(model: nn.Module, batches: Iterable[torch.Tensor],
              **forward_kw) -> Dict[str, torch.Tensor]:
    """Run calibration batches through ``model`` in eval mode with every
    QuantConv2d in 'calibrate' mode, from no running absmax (the JAX
    ``calibrate``'s fresh ``quant`` collection), then restore each
    module's mode. The absmax stays in each module's ``act_absmax``, where
    a 'static' module reads it; returns {module name: act_absmax}."""
    convs = quant_convs(model)
    modes = {n: m.mode for n, m in convs.items()}
    for m in convs.values():
        m.act_absmax, m.mode = None, "calibrate"
    training = model.training
    model.eval()
    try:
        for x in batches:
            model(x, **forward_kw)
    finally:
        for n, m in convs.items():
            m.mode = modes[n]
        model.train(training)
    return {n: m.act_absmax for n, m in convs.items()}


@contextlib.contextmanager
def uncalibrated(model: nn.Module):
    """Within the block, every QuantConv2d of ``model`` is without its
    calibrated absmax, so 'static' modules take per-image scales: the JAX
    train loop's loss forward, which applies without the ``quant``
    collection."""
    convs = quant_convs(model)
    saved = {n: m.act_absmax for n, m in convs.items()}
    for m in convs.values():
        m.act_absmax = None
    try:
        yield
    finally:
        for n, m in convs.items():
            m.act_absmax = saved[n]
