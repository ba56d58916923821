"""Training losses and segmentation quality stats.

Port of pvnet_tpu/train/loss.py: per-pixel cross-entropy on the
segmentation logits averaged per sample (ref tools/train_linemod.py:83-88)
plus a masked smooth-L1 on the vertex field normalized by foreground pixel
count (ref lib/utils/net_utils.py:54-79), combined with vertex_loss_ratio
(ref train_linemod.py:148).

Every function takes ``channel_axis`` (1 for the channel-major head the
port's model emits, -1 for NHWC tensors). Arithmetic is in float32 whatever
the input dtype (under bf16 autocast the head emits bfloat16).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def seg_loss(seg_pred: torch.Tensor, mask: torch.Tensor,
             channel_axis: int = 1) -> torch.Tensor:
    """Per-pixel softmax cross-entropy, mean over pixels per sample.
    seg_pred [b, c, h, w] (channel_axis=1) or [b, h, w, c] (-1) logits,
    mask [b, h, w] integer labels. Returns [b]."""
    logp = F.log_softmax(seg_pred.to(torch.float32), dim=channel_axis)
    labels = mask.to(torch.int64)
    if channel_axis in (-1, logp.dim() - 1):
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    else:
        ll = torch.gather(logp, 1, labels[:, None])[:, 0]
    return -ll.reshape(ll.shape[0], -1).mean(1)


def smooth_l1_vertex_loss(ver_pred: torch.Tensor, ver_target: torch.Tensor,
                          ver_weights: torch.Tensor, sigma: float = 1.0,
                          normalize: bool = True,
                          channel_axis: int = 1) -> torch.Tensor:
    """Masked smooth-L1 on the vertex field (ref net_utils.py:54-79).

    The weight multiplies the *difference* before the robust kernel, and
    normalization divides by ver_dim * sum(weights) + 1e-3.
    ver_pred, ver_target [b, ver_dim, h, w] (or NHWC with channel_axis=-1),
    ver_weights [b, 1, h, w] (or [b, h, w, 1]). Returns [b]."""
    b = ver_pred.shape[0]
    ver_dim = ver_pred.shape[channel_axis]
    sigma2 = sigma ** 2
    w = ver_weights.to(torch.float32)
    diff = w * (ver_pred.to(torch.float32) - ver_target.to(torch.float32))
    abs_diff = diff.abs()
    quad = abs_diff < (1.0 / sigma2)
    loss = torch.where(quad, 0.5 * sigma2 * diff * diff,
                       abs_diff - 0.5 / sigma2)
    loss = loss.reshape(b, -1).sum(1)
    if normalize:
        wsum = w.reshape(b, -1).sum(1)
        loss = loss / (ver_dim * wsum + 1e-3)
    return loss


def precision_recall(seg_pred: torch.Tensor, mask: torch.Tensor,
                     channel_axis: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Foreground precision/recall with +1 smoothing
    (ref net_utils.py:329-348). Returns ([b] precision, [b] recall)."""
    b = seg_pred.shape[0]
    preds = torch.argmax(seg_pred, dim=channel_axis).to(torch.float32)
    target = mask.to(torch.float32)
    tp = (preds * target).reshape(b, -1).sum(1)
    fp = (preds * (1 - target)).reshape(b, -1).sum(1)
    fn = ((1 - preds) * target).reshape(b, -1).sum(1)
    return (tp + 1) / (tp + fp + 1), (tp + 1) / (tp + fn + 1)


def total_loss(seg_pred, ver_pred, mask, ver_target, ver_weights,
               vertex_loss_ratio: float = 1.0, channel_axis: int = 1
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Combined objective (ref train_linemod.py:146-148). Returns the
    scalar loss and a metrics dict (detached scalars)."""
    ls = seg_loss(seg_pred, mask, channel_axis)
    lv = smooth_l1_vertex_loss(ver_pred, ver_target, ver_weights,
                               channel_axis=channel_axis)
    with torch.no_grad():
        precision, recall = precision_recall(seg_pred, mask, channel_axis)
    loss = ls.mean() + lv.mean() * vertex_loss_ratio
    metrics = {
        "loss": loss.detach(),
        "seg_loss": ls.mean().detach(),
        "ver_loss": lv.mean().detach(),
        "precision": precision.mean(),
        "recall": recall.mean(),
    }
    return loss, metrics
