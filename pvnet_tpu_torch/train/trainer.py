"""Training step, optimizer and LR schedule.

Port of pvnet_tpu/train/trainer.py on the device-data path: Adam at
lr 1e-3 (ref tools/train_linemod.py:260), stepped decay x0.5 every 20
epochs with a 1e-5 floor (ref lib/utils/net_utils.py:272-281), and a step
that augments on the device, builds the vertex targets there, and runs the
forward/backward pass and the Adam update.

Where the JAX step is a pure function returning a new state, the port's
updates the model, its BatchNorm statistics and the optimizer in place and
returns the step's metrics. The step trains channel-major only (the JAX
package's ``head_layout='NCHW'``, ``input_layout='NCHW'``, which
tools/train.py selects for ``--device_data``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.data.augment_device import AugDraws, augment_batch
from pvnet_tpu_torch.data.vertex import (compute_vertex_targets,
                                        compute_vertex_targets_multiclass)
from pvnet_tpu_torch.train.loss import total_loss


@dataclass
class TrainState:
    """Model + optimizer + step count (ref checkpoints carry
    net/optim/epoch, net_utils.py:124-130)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def lr_for_epoch(cfg: TrainConfig, epoch: int) -> float:
    """Step-decay schedule (ref net_utils.py:272-281): lr0 * rate^(epoch //
    decay_epoch), floored at lr_min."""
    lr = cfg.lr * (cfg.lr_decay_rate ** (epoch // cfg.lr_decay_epoch))
    return max(lr, cfg.lr_min)


def make_optimizer(model: torch.nn.Module,
                   cfg: TrainConfig) -> torch.optim.Adam:
    """Adam with optax.adam's defaults (b1 0.9, b2 0.999, eps 1e-8); the
    loop sets the learning rate per epoch."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8)


def create_train_state(model: torch.nn.Module,
                       cfg: TrainConfig) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(model, cfg))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def apply_device_aug(batch: Dict[str, torch.Tensor], aug_cfg,
                     aug_hw: Tuple[int, int],
                     draws: Optional[AugDraws] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
    """Augment a raw batch (uint8 0..255 frames) on its device: the image
    comes out normalized and channel-major [b, 3, h, w]; mask and hcoords
    follow the warp. The JAX step's ``_apply_device_aug``. Multi-class
    hcoords [b, C, k, 3] are refused: the augmentation warps one object's
    keypoints."""
    if batch["hcoords"].dim() != 3:
        raise ValueError(f"device augmentation takes hcoords [b, k, 3], got "
                         f"{tuple(batch['hcoords'].shape)}")
    image, mask, hcoords = augment_batch(
        batch["image"], batch["mask"], batch["hcoords"], aug_hw, aug_cfg,
        draws=draws, generator=generator)
    return dict(batch, image=image, mask=mask, hcoords=hcoords)


def batch_loss(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
               vertex_loss_ratio: float, use_motion: bool, bf16: bool):
    """Forward pass and loss of an augmented batch (image [b, 3, h, w]
    normalized, mask [b, h, w], hcoords [b, k, 3], optional ignore [b]):
    vertex targets and weights on the device, the FCN under bf16 autocast
    when asked, the loss in float32. Multi-class hcoords [b, C, k, 3]
    (mask labels 0..C) take the shared multi-class targets
    (:func:`compute_vertex_targets_multiclass`), as the JAX step's
    ``_batch_vertex`` chooses; a motion model with them is refused, as
    there."""
    mask, hcoords = batch["mask"], batch["hcoords"]
    if hcoords.dim() == 4:
        if use_motion:
            raise ValueError("motion model + multi-class unsupported")
        vertex = compute_vertex_targets_multiclass(mask, hcoords,
                                                   layout="NCHW")
    else:
        vertex = compute_vertex_targets(mask, hcoords, use_motion,
                                        layout="NCHW")
    vw = (mask > 0)[:, None].to(torch.float32)              # [b, 1, h, w]
    if "ignore" in batch:
        vw = vw * (1.0 - batch["ignore"])[:, None, None, None]
    dev = batch["image"].device
    with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
        seg, ver = model(batch["image"])
    return total_loss(seg, ver, mask, vertex, vw, vertex_loss_ratio,
                      channel_axis=1)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[AugDraws] = None,
               vertex_loss_ratio: float = 1.0, use_motion: bool = False,
               aug_cfg=None, aug_hw: Optional[Tuple[int, int]] = None,
               bf16: bool = False) -> Dict[str, torch.Tensor]:
    """One optimization step, in place. Returns the metrics (scalar
    tensors on the device: loss, seg_loss, ver_loss, precision, recall).

    With ``aug_cfg``/``aug_hw`` the batch is raw (image [b, H, W, 3] uint8,
    mask [b, H, W], hcoords [b, k, 3], optional ignore [b]) and is
    augmented first, with ``draws`` or draws from ``generator``; without,
    it is already augmented (image normalized [b, 3, h, w]). After the
    step every parameter's ``.grad`` holds this step's gradient."""
    if aug_cfg is not None:
        batch = apply_device_aug(batch, aug_cfg, aug_hw, draws, generator)
    state.model.train()
    loss, metrics = batch_loss(state.model, batch, vertex_loss_ratio,
                               use_motion, bf16)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return metrics


def train_step_from_data(state: TrainState, data: Dict[str, torch.Tensor],
                         idx: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[AugDraws] = None,
                         vertex_loss_ratio: float = 1.0,
                         use_motion: bool = False, aug_cfg=None,
                         aug_hw: Optional[Tuple[int, int]] = None,
                         bf16: bool = False) -> Dict[str, torch.Tensor]:
    """Device-resident input pipeline: one step that gathers its minibatch
    by index from the whole training set held on the device.

    data: {image [N, h, w, 3] uint8, mask [N, h, w] uint8, hcoords
    [N, k, 3] float32, optional ignore [N] float32}; idx [b] int64 on the
    data's device. Augmentation runs on the device (aug_cfg/aug_hw)."""
    batch = {k: data[k][idx] for k in ("image", "mask", "hcoords", "ignore")
             if k in data}
    return train_step(state, batch, generator, draws, vertex_loss_ratio,
                      use_motion, aug_cfg, aug_hw, bf16)


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              vertex_loss_ratio: float = 1.0, use_motion: bool = False,
              bf16: bool = False) -> Dict[str, torch.Tensor]:
    """Loss/metrics of an augmented batch with frozen batch statistics and
    no parameter update (ref val(), train_linemod.py:177-205)."""
    state.model.eval()
    _, metrics = batch_loss(state.model, batch, vertex_loss_ratio,
                            use_motion, bf16)
    return metrics
