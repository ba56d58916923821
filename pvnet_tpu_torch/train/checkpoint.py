"""Checkpoints in the reference's own per-epoch layout.

The reference writes ``{model_dir}/{epoch}.pth`` holding
{'net', 'optim', 'epoch'} every epoch and restores the largest (or the
requested) epoch (ref lib/utils/net_utils.py:92-130,
train_linemod.py:307-308, 347). The JAX package keeps the layout with
orbax step directories (pvnet_tpu/train/checkpoint.py); the port writes
the reference's ``.pth`` files, keeping the newest ``keep`` of them.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import torch

from pvnet_tpu_torch.train.trainer import TrainState


def _epochs(model_dir: str) -> List[int]:
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(f[:-4]) for f in os.listdir(model_dir)
                  if f.endswith(".pth") and f[:-4].isdigit())


def _path(model_dir: str, epoch: int) -> str:
    return os.path.join(model_dir, f"{epoch}.pth")


def save_model(state: TrainState, epoch: int, model_dir: str,
               keep: int = 10) -> str:
    """Write {net, optim, epoch} (ref net_utils.py:124-130) and delete all
    but the newest ``keep`` checkpoints. Returns the file's path."""
    os.makedirs(model_dir, exist_ok=True)
    path = _path(model_dir, epoch)
    tmp = path + ".tmp"
    torch.save({"net": state.model.state_dict(),
                "optim": state.optimizer.state_dict(),
                "epoch": epoch}, tmp)
    os.replace(tmp, path)
    for old in _epochs(model_dir)[:-keep]:
        os.remove(_path(model_dir, old))
    return path


def _read(model_dir: str, epoch: int):
    epochs = _epochs(model_dir)
    if not epochs:
        return None
    target = max(epochs) if epoch == -1 else epoch
    return torch.load(_path(model_dir, target),
                      map_location="cpu", weights_only=True)


def load_model(state: TrainState, model_dir: str, epoch: int = -1
               ) -> Tuple[TrainState, int]:
    """Restore net + optimizer; returns (state, begin_epoch). A missing dir
    or no checkpoint is a cold start at epoch 0, as in the reference
    (ref net_utils.py:92-98); epoch=-1 picks the latest."""
    ckpt = _read(model_dir, epoch)
    if ckpt is None:
        return state, 0
    state.model.load_state_dict(ckpt["net"])
    state.optimizer.load_state_dict(ckpt["optim"])
    return state, ckpt["epoch"] + 1


def load_net(state: TrainState, model_dir: str, epoch: int = -1
             ) -> Tuple[TrainState, int]:
    """Restore the network weights of ``epoch`` (-1: the latest) only,
    keeping the optimizer — the reference's eval-time loader (ref
    net_utils.py:110-122). Returns (state, epoch + 1), or (state, 0) when
    there is no checkpoint."""
    ckpt = _read(model_dir, epoch)
    if ckpt is None:
        return state, 0
    state.model.load_state_dict(ckpt["net"])
    return state, ckpt["epoch"] + 1
