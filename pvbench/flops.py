"""Work counted from the architecture's published shapes and the
algorithms' own formulas, not from the program: the yardstick of the
rooflines and MFU metrics.

Peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense, at the
700 W limit): 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s
TF32, 989 TFLOP/s bfloat16; 3.35 TB/s of HBM3.

- FCN: every convolution of the configuration's network
  (reference/fcn.py's description of its blocks, widths and skips) at
  the input's (h, w), 2 * c_in * c_out * k^2 FLOPs per output pixel (a
  multiply and an add), the head's bias included; BatchNorm,
  activations, the upsamples and the loss are elementwise and left out
  (under 1 % of the total). At 480x640 that is 144.88 GFLOP an image
  through Resnet18_8s, 385.5 through Resnet50_8s. A training step counts 3x the forward
  (the backward's two products per convolution), not the recomputed work.
- K3 ``count_inliers``: one (image, keypoint, hypothesis, pixel) pair is
  the inlier test dot = h.n - c.n, |d|^2 = |h|^2 - 2 h.c + |c|^2, then
  dot^2 > t^2 |d|^2 |n|^2: 8 multiplications and 5 additions with the
  pixel's c.n, |c|^2 and |n|^2 and the hypothesis's |h|^2 formed once,
  13 FLOPs. Comparisons and the count's integer add are not counted.
  Bytes: each input once (coords 8 B, valid 1 B a pixel; dirs and
  hypotheses 8 B a keypoint) and the int32 counts once.
- K4 ``shift_lanes``: a circular shift of each row, no arithmetic; bytes
  are the planes read once and written once, and the int32 start of each
  row. The augmentation launches it twice a step: pass V on [4b, W, H]
  (the source's columns as rows: 3 colour planes and the mask), pass H
  on [4b, out_h, W].
"""
from __future__ import annotations

from typing import List, Tuple

from pvbench.reference import fcn

PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
K3_FLOPS_PER_PAIR = 13


def _out(n: int, k: int, stride: int, pad: int, dil: int = 1) -> int:
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


def fcn_convs(h: int, w: int, cfg: dict
              ) -> List[Tuple[str, int, int, int, int, int]]:
    """(name, c_in, c_out, k, h_out, w_out) of every convolution of the
    network that the configuration ``cfg`` describes (reference/fcn.py's
    description: its blocks, widths and skips)."""
    convs = []
    h2, w2 = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    convs.append(("stem", 3, 64, 7, h2, w2))
    hc, wc = _out(h2, 3, 2, 1), _out(w2, 3, 2, 1)           # max pool
    skips = {}
    for blk in fcn.blocks(cfg):
        name = blk["name"].split(".", 1)[1]
        cur = (hc, wc)
        for conv, cin, cout, k, s, d in fcn.block_convs(cfg, blk):
            src = (hc, wc) if conv == "downsample.0" else cur
            pad = d if k == 3 else 0
            out = (_out(src[0], k, s, pad, d), _out(src[1], k, s, pad, d))
            label = "downsample" if conv == "downsample.0" else conv
            convs.append((f"{name}.{label}", cin, cout, k, *out))
            if conv != "downsample.0":
                cur = out
        hc, wc = cur
        skips[blk["layer"]] = cur
    h8, w8 = hc, wc
    h4, w4 = skips["layer1"]
    (_, c8, s8), (_, c4, s4), (_, c2, s2), (_, craw, raw) = fcn.decoder(cfg)
    convs.append(("fc", fcn.blocks(cfg)[-1]["cout"], cfg["fcdim"], 3, h8,
                  w8))
    convs.append(("conv8s", c8, s8, 3, h8, w8))
    convs.append(("conv4s", c4, s4, 3, h4, w4))
    convs.append(("conv2s", c2, s2, 3, h2, w2))
    convs.append(("convraw", craw, raw, 3, h, w))
    convs.append(("head", raw, cfg["seg_dim"] + cfg["ver_dim"], 1, h, w))
    return convs


def fcn_flops(h: int, w: int, cfg: dict) -> float:
    """Forward FLOPs of one image at (h, w) through ``cfg``'s network."""
    total = 0.0
    for name, cin, cout, k, ho, wo in fcn_convs(h, w, cfg):
        total += 2.0 * cin * cout * k * k * ho * wo
        if name == "head":
            total += cout * ho * wo                         # the bias
    return total


def train_step_flops(h: int, w: int, batch: int, cfg: dict) -> float:
    """A training step's FLOPs: forward and backward, 3x the forward."""
    return 3.0 * batch * fcn_flops(h, w, cfg)


def k3_work(b: int, vn: int, hn: int, tn: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one count over b images."""
    flops = float(K3_FLOPS_PER_PAIR) * b * vn * hn * tn
    nbytes = b * tn * (8 + 1) + b * tn * vn * 8 + b * hn * vn * 8 \
        + b * hn * vn * 4
    return flops, float(nbytes)


def k4_bytes(planes: int, rows: int, cols: int, esize: int = 4) -> float:
    """Bytes of one shift of [planes, rows, cols]: read once, written
    once, one int32 start a row."""
    return 2.0 * planes * rows * cols * esize + 4.0 * planes * rows


def k4_step_bytes(b: int, src_h: int, src_w: int, out_h: int) -> float:
    """Bytes of an augmentation's two K4 launches."""
    return (k4_bytes(4 * b, src_w, src_h) + k4_bytes(4 * b, out_h, src_w))


def bound_seconds(flops: float, nbytes: float, peak: float
                  ) -> Tuple[float, str]:
    """The least time the card could take and which bound binds it."""
    tc, tm = flops / peak, nbytes / HBM_BYTES_PER_S
    return (tc, "compute") if tc >= tm else (tm, "bytes")
