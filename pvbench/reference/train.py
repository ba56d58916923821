"""PVNet's training step in plain PyTorch, float32: the augmented batch,
the vertex targets, the loss, the backward pass and Adam (PVNet
tools/train_linemod.py, lib/utils/net_utils.py).

- Targets: inside the object (mask == 1) the unit vector from the pixel
  to each keypoint, (k_xy - p w) / |.|, a norm below 1e-3 raised by 1e-3;
  zero elsewhere. Channels x0, y0, x1, y1, ...
- Loss: the per-pixel softmax cross-entropy of the segmentation, averaged
  over each image's pixels, plus the smooth-L1 (sigma 1) of the masked
  vector difference, summed over each image and divided by ver_dim times
  its mask pixels plus 1e-3; each averaged over the batch and added with
  the recipe's vertex_loss_ratio.
- The forward pass normalizes with the batch's statistics (train mode).
- Adam (beta 0.9, 0.999, eps 1e-8, bias-corrected, eps added to the
  root) on every parameter.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from pvbench.reference import augment as ref_augment
from pvbench.reference import fcn


def vertex_targets(mask: torch.Tensor, hcoords: torch.Tensor
                   ) -> torch.Tensor:
    b, h, w = mask.shape
    dev = mask.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    hx = hcoords[:, :, 0, None, None]
    hy = hcoords[:, :, 1, None, None]
    hw = hcoords[:, :, 2, None, None]
    vx, vy = hx - xs * hw, hy - ys * hw                     # [b, k, h, w]
    n = torch.sqrt(vx * vx + vy * vy)
    n = torch.where(n < 1e-3, n + 1e-3, n)
    inside = (mask == 1)[:, None]
    v = torch.stack([vx / n * inside, vy / n * inside], 2)
    return v.reshape(b, -1, h, w)


def loss(seg, ver, mask, hcoords, vertex_loss_ratio: float = 1.0):
    seg_l = F.cross_entropy(seg.float(), mask.long(), reduction="none")
    seg_l = seg_l.flatten(1).mean(1)
    target = vertex_targets(mask, hcoords)
    wgt = (mask > 0)[:, None].float()
    diff = wgt * (ver.float() - target)
    a = diff.abs()
    sl1 = torch.where(a < 1.0, 0.5 * diff * diff, a - 0.5).flatten(1).sum(1)
    ver_l = sl1 / (ver.shape[1] * wgt.flatten(1).sum(1) + 1e-3)
    return seg_l.mean() + vertex_loss_ratio * ver_l.mean()


class Adam:
    """Adam on a dict of leaf tensors, in place."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.p, self.lr, self.b1, self.b2, self.eps = params, lr, *betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            self.p[k] -= self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + self.eps)


def trainable(params: Dict[str, torch.Tensor]) -> List[str]:
    """The parameters Adam moves: all but the running statistics."""
    return [k for k in params if not k.endswith(("running_mean",
                                                 "running_var"))]


def run(params: Dict[str, torch.Tensor], batches: List[dict], cfg: dict,
        conv: Callable = F.conv2d) -> dict:
    """Train ``params`` (float32, modified in place) of the network that
    the configuration ``cfg`` describes (reference/fcn.py), by its recipe
    ``cfg["train"]``, through ``batches`` (raw image, mask, hcoords, draws
    dict, out_hw each). Returns each step's loss, each leaf's first
    gradient, and the parameters after the last step."""
    recipe = cfg["train"]
    names = trainable(params)
    for k in names:
        params[k].requires_grad_(True)
    opt = Adam({k: params[k] for k in names}, recipe["lr"])
    losses, first = [], None
    for bt in batches:
        x, m, hc = ref_augment.augment(bt["image"], bt["mask"],
                                       bt["hcoords"], bt["draws"],
                                       bt["out_hw"], recipe["aug_cfg"])
        seg, ver = fcn.forward(params, x, cfg, train=True, conv=conv)
        lv = loss(seg, ver, m, hc, recipe.get("vertex_loss_ratio", 1.0))
        grads = torch.autograd.grad(lv, [params[k] for k in names])
        del seg, ver, x
        losses.append(float(lv.detach()))
        grads = dict(zip(names, grads))
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
    for k in names:
        params[k].requires_grad_(False)
    return {"loss": losses, "grad": first, "params": params}
