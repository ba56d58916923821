"""Training step, optimizer and LR schedule.

Port of pvnet_tpu/train/trainer.py: Adam at lr 1e-3 (ref
tools/train_linemod.py:260), stepped decay x0.5 every 20 epochs with a
1e-5 floor (ref lib/utils/net_utils.py:272-281), and the step: on a raw
batch it augments on the device first (JAX's ``--device_aug``), on a
host-augmented batch it takes the batch as it comes; then it builds the
vertex targets on the device (unless the batch carries them) and runs the
forward/backward pass and the Adam update.

Where the JAX step is a pure function returning a new state, the port's
updates the model, its BatchNorm statistics and the optimizer in place and
returns the step's metrics. The step trains channel-major (PyTorch's
layout; JAX's ``head_layout``/``input_layout`` change no value).

The data-parallel steps (``make_sharded_train_step``,
``make_sharded_train_step_from_data``, ``make_sharded_eval_step``, JAX's
names) run over a parallel.Mesh, one process per device: each rank takes
its rows of the global batch (or of the resident set's ``idx``) and of the
global batch's augmentation draws, the model's BatchNorm layers normalize
over the global batch (parallel.convert_sync), DistributedDataParallel
averages the gradients, and the metrics come back as global-batch means.
Every rank then holds the same weights, as after the unsharded step on the
whole batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.data.augment_device import (AugDraws, augment_batch,
                                                 sample_draws)
from pvnet_tpu_torch.data.vertex import (compute_vertex_targets,
                                        compute_vertex_targets_multiclass)
from pvnet_tpu_torch.parallel.mesh import (Mesh, all_reduce_mean,
                                           shard_batch)
from pvnet_tpu_torch.parallel.sync_bn import convert_sync
from pvnet_tpu_torch.train.loss import total_loss


@dataclass
class TrainState:
    """Model + optimizer + step count (ref checkpoints carry
    net/optim/epoch, net_utils.py:124-130). ``replica`` is the model's
    DistributedDataParallel wrapper once a sharded step has made it;
    ``model`` stays the bare module that checkpoints and evaluation see."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    replica: Optional[torch.nn.Module] = None


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
    normalized, mask [b, h, w], hcoords [b, k, 3]; optional ignore [b],
    vertex_weights [b, 1, h, w], vertex [b, 2k, h, w]): vertex targets
    from hcoords on the device unless the batch carries them (JAX's
    ``_batch_vertex``), weights (mask > 0) * (1 - ignore) unless given;
    the FCN under bf16 autocast when asked, the loss in float32.
    Multi-class hcoords [b, C, k, 3] (mask labels 0..C) take the shared
    multi-class targets (:func:`compute_vertex_targets_multiclass`); a
    motion model with them is refused, as there."""
    mask, hcoords = batch["mask"], batch.get("hcoords")
    if "vertex" in batch:
        vertex = batch["vertex"]
    elif hcoords.dim() == 4:
        if use_motion:
            raise ValueError("motion model + multi-class unsupported")
        vertex = compute_vertex_targets_multiclass(mask, hcoords,
                                                   layout="NCHW")
    else:
        vertex = compute_vertex_targets(mask, hcoords, use_motion,
                                        layout="NCHW")
    if "vertex_weights" in batch:
        vw = batch["vertex_weights"]
    else:
        vw = (mask > 0)[:, None].to(torch.float32)          # [b, 1, h, w]
        if "ignore" in batch:
            vw = vw * (1.0 - batch["ignore"])[:, None, None, None]
    dev = batch["image"].device
    with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
        seg, ver = model(batch["image"])
    return total_loss(seg, ver, mask, vertex, vw, vertex_loss_ratio,
                      channel_axis=1)


def host_batch(batch: Dict[str, object], device) -> Dict[str, torch.Tensor]:
    """A host-augmented loader batch (data.dataset.collate's non-raw
    branch) as the step takes it, on ``device`` (JAX loop's
    ``_device_batch``): the image channel-major, mask, vertex_weights
    [b, 1, h, w], and hcoords, or the host's vertex targets
    [b, 2k, h, w]."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {"image": batch["image"].to(device).permute(0, 3, 1, 2)
           .contiguous(),
           "mask": dev(batch["mask"])}
    if "vertex_weights" in batch:
        out["vertex_weights"] = dev(batch["vertex_weights"]).permute(
            0, 3, 1, 2)
    if "vertex" in batch:
        out["vertex"] = dev(batch["vertex"]).permute(0, 3, 1, 2).contiguous()
    else:
        out["hcoords"] = dev(batch["hcoords"])
    return out


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: Optional[AugDraws] = None,
               vertex_loss_ratio: float = 1.0, use_motion: bool = False,
               aug_cfg=None, aug_hw: Optional[Tuple[int, int]] = None,
               bf16: bool = False,
               forward_model: Optional[torch.nn.Module] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimization step, in place. Returns the metrics (scalar
    tensors on the device: loss, seg_loss, ver_loss, precision, recall).
    ``forward_model`` runs the forward in place of ``state.model`` (a
    sharded step's data-parallel wrapper of it).

    With ``aug_cfg``/``aug_hw`` the batch is raw (image [b, H, W, 3] uint8,
    mask [b, H, W], hcoords [b, k, 3], optional ignore [b]) and is
    augmented first, with ``draws`` or draws from ``generator``; without,
    it is already augmented (image normalized [b, 3, h, w]; a
    host-augmented batch through :func:`host_batch`, JAX's
    ``train_step(..., aug_cfg=None)``). After the step every parameter's
    ``.grad`` holds this step's gradient."""
    if aug_cfg is not None:
        batch = apply_device_aug(batch, aug_cfg, aug_hw, draws, generator)
    state.model.train()
    loss, metrics = batch_loss(forward_model or state.model, batch,
                               vertex_loss_ratio, use_motion, bf16)
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


# -- data parallelism -----------------------------------------------------

def replica(state: TrainState, mesh: Mesh) -> torch.nn.Module:
    """The module a sharded step runs: ``state.model``, its BatchNorm
    layers synchronized over the mesh (parallel.convert_sync, in place),
    wrapped once in DistributedDataParallel over the mesh's group (kept on
    ``state.replica``; gradients averaged over the ranks, buffers not
    broadcast, since the synchronized BatchNorm keeps them equal), or the
    model itself without a group."""
    if mesh.group is None:
        return state.model
    if state.replica is None or state.replica.module is not state.model:
        convert_sync(state.model, mesh)
        from torch.nn.parallel import DistributedDataParallel
        state.replica = DistributedDataParallel(
            state.model, process_group=mesh.group, broadcast_buffers=False,
            device_ids=([mesh.device.index] if mesh.device.type == "cuda"
                        else None))
    return state.replica


def _rows(batch: Dict[str, torch.Tensor]) -> int:
    return len(next(iter(batch.values())))


def shard_draws(draws: AugDraws, mesh: Mesh, b: int) -> AugDraws:
    """This rank's rows of a global batch's augmentation draws."""
    rows = mesh.rows(b)
    return AugDraws(*(d[rows].to(mesh.device) for d in draws))


def global_metrics(metrics: Dict[str, torch.Tensor], mesh: Mesh
                   ) -> Dict[str, torch.Tensor]:
    """Per-rank metric means -> global-batch means (equal shards), with
    one all-reduce."""
    keys = list(metrics)
    t = all_reduce_mean(torch.stack([metrics[k].float() for k in keys]),
                        mesh)
    return dict(zip(keys, t.unbind()))


def make_sharded_train_step(mesh: Mesh, vertex_loss_ratio: float = 1.0,
                            use_motion: bool = False, aug_cfg=None,
                            aug_hw: Optional[Tuple[int, int]] = None,
                            bf16: bool = False):
    """:func:`train_step` data-parallel over ``mesh`` (JAX
    ``make_sharded_train_step``). Returns step(state, batch,
    generator=None, draws=None, local=False) -> global metrics.

    ``batch`` is the global batch (each rank takes its rows, on its
    device), or with ``local=True`` this rank's rows of it already. With
    ``aug_cfg``/``aug_hw`` the batch is raw and augmented on the device
    with this rank's rows of the global batch's draws: ``draws`` for the
    whole batch, or :func:`~pvnet_tpu_torch.data.augment_device.
    sample_draws` of the whole batch from ``generator`` (seeded alike on
    every rank), so that N ranks draw what one rank on the whole batch
    draws. The model's BatchNorm layers are synchronized over the mesh
    on the first step (:func:`replica`), so that the step equals the
    unsharded one on the whole batch."""
    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[AugDraws] = None, local: bool = False):
        if local:
            b = _rows(batch) * mesh.size
            batch = {k: v.to(mesh.device) for k, v in batch.items()}
        else:
            b = _rows(batch)
            batch = shard_batch(batch, mesh)
        if aug_cfg is not None:
            if draws is None:
                draws = sample_draws(b, aug_cfg, generator, mesh.device)
            draws = shard_draws(draws, mesh, b)
        metrics = train_step(state, batch, draws=draws,
                             vertex_loss_ratio=vertex_loss_ratio,
                             use_motion=use_motion, aug_cfg=aug_cfg,
                             aug_hw=aug_hw, bf16=bf16,
                             forward_model=replica(state, mesh))
        return global_metrics(metrics, mesh)
    return step


def make_sharded_train_step_from_data(mesh: Mesh,
                                      vertex_loss_ratio: float = 1.0,
                                      use_motion: bool = False,
                                      aug_cfg=None,
                                      aug_hw: Optional[Tuple[int, int]]
                                      = None, bf16: bool = False):
    """:func:`train_step_from_data` data-parallel over ``mesh`` (JAX
    ``make_sharded_train_step_from_data``): every rank holds the whole
    resident set, ``idx`` [b] is the global batch's, and each rank gathers
    its rows of it; draws as in :func:`make_sharded_train_step`. Returns
    step(state, data, idx, generator=None, draws=None) -> global
    metrics."""
    sharded = make_sharded_train_step(mesh, vertex_loss_ratio, use_motion,
                                      aug_cfg, aug_hw, bf16)

    def step(state: TrainState, data: Dict[str, torch.Tensor],
             idx: torch.Tensor, generator: Optional[torch.Generator] = None,
             draws: Optional[AugDraws] = None):
        if aug_cfg is not None and draws is None:
            draws = sample_draws(len(idx), aug_cfg, generator, mesh.device)
        mine = idx[mesh.rows(len(idx))].to(data["image"].device)
        batch = {k: data[k][mine] for k in ("image", "mask", "hcoords",
                                            "ignore") if k in data}
        return sharded(state, batch, draws=draws, local=True)
    return step


def make_sharded_eval_step(mesh: Mesh, vertex_loss_ratio: float = 1.0,
                           use_motion: bool = False, bf16: bool = False):
    """:func:`eval_step` over ``mesh`` (JAX ``make_sharded_eval_step``):
    each rank's rows of the global batch, frozen statistics, no collective
    but the metrics' mean. Returns step(state, batch) -> global
    metrics."""
    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return global_metrics(eval_step(state, shard_batch(batch, mesh),
                                        vertex_loss_ratio, use_motion, bf16),
                              mesh)
    return step
