"""The device-data training loop (ref tools/train_linemod.py:132-175,
305-347).

Port of the ``device_data`` path of pvnet_tpu/train/loop.py (``TrainLoop``):
the whole training set lives on the device as uint8 frames, each step
gathers its minibatch there by index, augments it there, and trains; only
the index vector and the random draws' seed come from the host. Per epoch:
the learning rate from the schedule, the steps, a scalar record every
``loss_rec_step`` steps, and a checkpoint.

Not ported yet: the host-augmentation and host-batch paths (``PoseDataset``,
``Prefetcher``), the per-epoch validation pass and pose evaluation, ImageNet
backbone initialization, and int8 calibration.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.config import TrainConfig, VOTE_TYPE_TO_NUM
from pvnet_tpu_torch.data.dataset import ImageSizeBatchSampler
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.models.resnet import init_weights
from pvnet_tpu_torch.train import trainer as trainer_mod
from pvnet_tpu_torch.train.checkpoint import load_model, save_model
from pvnet_tpu_torch.train.recorder import AverageMeter, Recorder
from pvnet_tpu_torch.utils.weights import load_weights

_METRICS = ("loss", "seg_loss", "ver_loss", "precision", "recall")


class TrainLoop:
    """End-to-end trainer for one object class on one device."""

    def __init__(self, cfg: TrainConfig, model_dir: str,
                 record_dir: Optional[str] = None,
                 buckets: Optional[List[Tuple[int, int]]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.vote_num = VOTE_TYPE_TO_NUM[cfg.vote_type]
        self.model_dir = model_dir
        self.recorder = Recorder(record_dir)
        self.buckets = buckets
        self.device = torch.device(device)

    # -- state ------------------------------------------------------------
    def init_state(self, init: Optional[str] = None
                   ) -> trainer_mod.TrainState:
        """A fresh train state: He fan-out weights drawn from cfg.seed, or
        the weights of ``init`` (a flax msgpack or a port ``.pth``)."""
        model = build_model(self.cfg.network, ver_dim=self.vote_num * 2,
                            seg_dim=2)
        init_weights(model, torch.Generator().manual_seed(self.cfg.seed))
        if init:
            load_weights(model, init)
        model.to(self.device)
        return trainer_mod.create_train_state(model, self.cfg)

    def resume(self, state: trainer_mod.TrainState
               ) -> Tuple[trainer_mod.TrainState, int]:
        """Continue from the latest checkpoint in model_dir when
        cfg.resume (ref train_linemod.py:307-308); else start at epoch 0."""
        if not self.cfg.resume:
            return state, 0
        return load_model(state, self.model_dir, epoch=-1)

    # -- data -------------------------------------------------------------
    def build_device_dataset(self, images: np.ndarray, masks: np.ndarray,
                             hcoords: np.ndarray,
                             ignore: Optional[np.ndarray] = None
                             ) -> Dict[str, torch.Tensor]:
        """Park the training set on the device: images [N, h, w, 3] uint8,
        masks [N, h, w] uint8, hcoords [N, k, 3] float32, ignore [N]
        (1 drops an image's vertex loss; default 0)."""
        n = len(images)
        if ignore is None:
            ignore = np.zeros((n,), np.float32)
        arrays = {"image": np.asarray(images, np.uint8),
                  "mask": np.asarray(masks, np.uint8),
                  "hcoords": np.asarray(hcoords, np.float32),
                  "ignore": np.asarray(ignore, np.float32)}
        for k, v in arrays.items():
            if len(v) != n:
                raise ValueError(f"{k} has {len(v)} records, images {n}")
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    # -- steps ------------------------------------------------------------
    def train_epoch_from_data(self, state, data, sampler, epoch: int,
                              max_steps: Optional[int] = None):
        """One epoch (or its first ``max_steps`` steps) of device-data
        training; the sampler yields (index, h, w) batches. Metrics are
        read back to the host only at record steps."""
        meters = {k: AverageMeter() for k in _METRICS}
        begin = time.time()
        size = len(sampler)
        seed = np.random.SeedSequence([self.cfg.seed, 7919 * (epoch + 1)])
        gen = torch.Generator(self.device).manual_seed(
            int(seed.generate_state(1)[0]))
        pending = []
        steps = 0
        for idx, batch_ihw in enumerate(sampler):
            if max_steps is not None and steps >= max_steps:
                break
            # a copy from pinned memory does not wait for the device's queue
            ids = torch.tensor([i for i, _, _ in batch_ihw], dtype=torch.int64)
            if self.device.type == "cuda":
                ids = ids.pin_memory()
            ids = ids.to(self.device, non_blocking=True)
            aug_hw = (batch_ihw[0][1], batch_ihw[0][2])
            metrics = trainer_mod.train_step_from_data(
                state, data, ids, generator=gen,
                vertex_loss_ratio=self.cfg.vertex_loss_ratio,
                use_motion=self.cfg.motion_model, aug_cfg=self.cfg.aug_cfg,
                aug_hw=aug_hw, bf16=self.cfg.bf16)
            steps += 1
            pending.append(metrics)
            if idx % self.cfg.loss_rec_step == 0:
                for met in pending:
                    for k, m in meters.items():
                        m.update(float(met[k]))
                pending.clear()
                self.recorder.rec_loss_batch(
                    {f"train/scalar/{k}": m.avg for k, m in meters.items()},
                    epoch * size + idx, epoch)
                for m in meters.values():
                    m.reset()
        print(f"epoch {epoch} training cost {time.time() - begin:.1f} s "
              f"({steps} steps)", flush=True)
        return state, steps

    # -- orchestration ----------------------------------------------------
    def fit(self, images: np.ndarray, masks: np.ndarray, hcoords: np.ndarray,
            init: Optional[str] = None, epochs: Optional[int] = None,
            max_steps: Optional[int] = None) -> trainer_mod.TrainState:
        """Full training run with resume and a checkpoint per epoch
        (ref train_net() :305-347); stops after ``max_steps`` steps in all
        when given, saving the epoch it stopped in."""
        state = self.init_state(init)
        state, begin_epoch = self.resume(state)
        data = self.build_device_dataset(images, masks, hcoords)
        sampler = ImageSizeBatchSampler(
            range(len(images)), self.cfg.train_batch_size, drop_last=True,
            aug_cfg=self.cfg.aug_cfg, buckets=self.buckets,
            seed=self.cfg.seed)
        if len(sampler) == 0:
            raise ValueError(f"{len(images)} images make no batch of "
                             f"{self.cfg.train_batch_size}")
        end_epoch = epochs if epochs is not None else self.cfg.epoch_num
        left = max_steps
        for epoch in range(begin_epoch, end_epoch):
            trainer_mod.set_learning_rate(
                state, trainer_mod.lr_for_epoch(self.cfg, epoch))
            state, steps = self.train_epoch_from_data(state, data, sampler,
                                                      epoch, left)
            save_model(state, epoch, self.model_dir,
                       keep=self.cfg.checkpoint_keep)
            if left is not None:
                left -= steps
                if left <= 0:
                    break
        self.recorder.close()
        return state

