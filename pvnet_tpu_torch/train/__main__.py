"""Train PVNet with the port (the training branch of tools/train.py with
``--device_data``: the set held on the device, augmentation on the device,
channel-major model input and head).

  python -m pvnet_tpu_torch.train --cfg_file configs/synthetic_train.json \\
      --data assets/duck_views_480x640.npz --buckets 480x640 \\
      --init assets/duck_ckpt.msgpack --steps 10 --device cuda

``--data`` is an .npz with the keys of tools/make_torch_fixture.py:
images [n, h, w, 3] uint8, masks [n, h, w] uint8, poses [n, 3, 4],
points_3d [k, 3] and K [3, 3]; the keypoint targets are the projections of
points_3d. A set smaller than one batch is repeated to fill one.
Checkpoints go to ``{model_dir}/{epoch}.pth``, which
``python -m pvnet_tpu_torch.infer --checkpoint`` reads, and the scalar log
to ``{model_dir}/log.jsonl``.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.data.dataset import load_training_set
from pvnet_tpu_torch.train.loop import TrainLoop

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def parse_buckets(spec: str) -> Optional[List[Tuple[int, int]]]:
    if not spec:
        return None
    try:
        buckets = [tuple(map(int, b.split("x"))) for b in spec.split(",")]
    except ValueError:
        raise SystemExit(f"--buckets must be HxW[,HxW...], got {spec!r}")
    if any(len(b) != 2 or b[0] <= 0 or b[1] <= 0 for b in buckets):
        raise SystemExit(f"--buckets must be HxW[,HxW...] with positive "
                         f"dims, got {spec!r}")
    return buckets


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cfg_file",
                   default=os.path.join(_REPO, "configs",
                                        "synthetic_train.json"))
    p.add_argument("--data",
                   default=os.path.join(_REPO, "assets",
                                        "duck_views_480x640.npz"),
                   help="fixture-layout .npz (tools/make_torch_fixture.py)")
    p.add_argument("--epochs", type=int, default=None,
                   help="override epoch_num")
    p.add_argument("--steps", type=int, default=None,
                   help="stop after this many steps in all")
    p.add_argument("--buckets", default="256x256,320x448,480x640",
                   help="comma-separated HxW output sizes; one is drawn "
                        "per batch (empty = the reference's 8-px grid)")
    p.add_argument("--model_dir", default=None,
                   help="checkpoint dir (default data/model/"
                        "duck_{model_name})")
    p.add_argument("--init", default=None,
                   help="initial weights: a flax msgpack or a .pth")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = TrainConfig.from_json(args.cfg_file)
    if args.epochs is not None:
        cfg.epoch_num = args.epochs
    device = torch.device(args.device)
    if device.type == "cuda" and not cfg.bf16:
        # full float32 convolutions and matmuls, as the JAX reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    name = f"duck_{cfg.model_name}"
    model_dir = args.model_dir or os.path.join(_REPO, "data", "model", name)
    images, masks, hcoords = load_training_set(args.data)
    if len(images) < cfg.train_batch_size:
        # a set smaller than one batch (the 2-view fixture) is repeated to
        # fill one, as chip_smoke.py's training phase does
        tile = np.arange(cfg.train_batch_size) % len(images)
        images, masks, hcoords = images[tile], masks[tile], hcoords[tile]
    print(f"train set: {len(images)} images at {images.shape[1]}x"
          f"{images.shape[2]}; batch {cfg.train_batch_size}; "
          f"{'bf16' if cfg.bf16 else 'f32'}; device {device}", flush=True)
    loop = TrainLoop(cfg, model_dir, record_dir=model_dir,
                     buckets=parse_buckets(args.buckets), device=device)
    loop.fit(images, masks, hcoords, init=args.init, max_steps=args.steps)
    print(f"checkpoints in {model_dir}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
