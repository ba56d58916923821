"""Per-pixel keypoint vector-field targets.

Port of pvnet_tpu/data/vertex.py: unit vectors pixel -> keypoint inside the
object mask (ref lib/datasets/linemod_dataset.py:68-81,
compute_vertex_hcoords), as a host numpy function and as a batched tensor
function that runs on the training step's device, plus the multi-class
form whose pixels point at the keypoints of their own class.
"""
from __future__ import annotations

import numpy as np
import torch


def compute_vertex_targets_np(mask: np.ndarray, hcoords: np.ndarray,
                              use_motion: bool = False) -> np.ndarray:
    """Host reference implementation (ref linemod_dataset.py:68-81).

    Args:
      mask:    [h, w] foreground mask (1 = object).
      hcoords: [k, 3] homogeneous 2D keypoints (x, y, w).
      use_motion: if True store raw offsets instead of unit vectors.

    Returns:
      [h, w, k*2] float32, zero outside the mask.
    """
    h, w = mask.shape
    m = hcoords.shape[0]
    xy = np.argwhere(mask == 1)[:, [1, 0]]
    vertex = xy[:, None, :] * hcoords[None, :, 2:]
    vertex = hcoords[None, :, :2] - vertex
    if not use_motion:
        norm = np.linalg.norm(vertex, axis=2, keepdims=True)
        norm[norm < 1e-3] += 1e-3
        vertex = vertex / norm
    out = np.zeros([h, w, m, 2], np.float32)
    out[xy[:, 1], xy[:, 0]] = vertex
    return np.reshape(out, [h, w, m * 2])


def compute_vertex_targets(mask: torch.Tensor, hcoords: torch.Tensor,
                           use_motion: bool = False,
                           layout: str = "NCHW") -> torch.Tensor:
    """Batched targets on the inputs' device.

    Args:
      mask:    [b, h, w]
      hcoords: [b, k, 3]
      layout:  'NCHW' -> [b, k*2, h, w] (channel order x0, y0, x1, y1, ...,
        as the model head emits it); 'NHWC' -> [b, h, w, k*2].
    Returns:
      float32 vector field, zero outside the mask.
    """
    b, h, w = mask.shape
    k = hcoords.shape[1]
    dev = mask.device
    hcoords = hcoords.to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    if layout == "NCHW":
        xs, ys = xs[None, None, None, :], ys[None, None, :, None]
        hx = hcoords[:, :, 0, None, None]                       # [b,k,1,1]
        hy = hcoords[:, :, 1, None, None]
        hw = hcoords[:, :, 2, None, None]
    elif layout == "NHWC":
        xs, ys = xs[None, None, :, None], ys[None, :, None, None]
        hx = hcoords[:, None, None, :, 0]                       # [b,1,1,k]
        hy = hcoords[:, None, None, :, 1]
        hw = hcoords[:, None, None, :, 2]
    else:
        raise ValueError(f"layout must be 'NCHW' or 'NHWC', got {layout!r}")
    vx = hx - xs * hw
    vy = hy - ys * hw
    if not use_motion:
        norm = torch.sqrt(vx * vx + vy * vy)
        norm = torch.where(norm < 1e-3, norm + 1e-3, norm)
        vx = vx / norm
        vy = vy / norm
    else:
        # raw offsets: vx varies along x only and vy along y only, so they
        # are broadcast to the full grid before stacking (the JAX module
        # stacks them unbroadcast and raises, ROADMAP fault F5)
        vx, vy = torch.broadcast_tensors(vx, vy)
    fg = mask == 1
    if layout == "NCHW":
        v = torch.stack([vx, vy], 2) * fg[:, None, None]        # [b,k,2,h,w]
        return v.reshape(b, k * 2, h, w)
    v = torch.stack([vx, vy], -1) * fg[..., None, None]         # [b,h,w,k,2]
    return v.reshape(b, h, w, k * 2)


def compute_vertex_targets_multiclass(mask: torch.Tensor,
                                      hcoords: torch.Tensor,
                                      layout: str = "NCHW") -> torch.Tensor:
    """Multi-class field targets: one field shared by the classes, where
    each pixel's vectors point at the keypoints of its own class (the
    semantics the multi-class voting layer assumes, ref
    ransac_voting_gpu.py:10-97). The sum over classes of
    :func:`compute_vertex_targets` on each class's mask, from zeros, as the
    JAX function adds them.

    Args:
      mask:    [b, h, w] integer labels, 0 = background, 1..C = classes.
      hcoords: [b, C, k, 3] per-class homogeneous keypoints.
      layout:  as :func:`compute_vertex_targets`.
    Returns:
      float32 field [b, k*2, h, w] ('NCHW') or [b, h, w, k*2], zero outside
      every class.
    """
    b, h, w = mask.shape
    n_cls, k = hcoords.shape[1], hcoords.shape[2]
    shape = (b, k * 2, h, w) if layout == "NCHW" else (b, h, w, k * 2)
    out = torch.zeros(shape, dtype=torch.float32, device=mask.device)
    for c in range(n_cls):          # class regions are disjoint
        out = out + compute_vertex_targets(
            (mask == c + 1).to(torch.int32), hcoords[:, c], layout=layout)
    return out
