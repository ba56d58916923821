"""Train or evaluate PVNet with the port (tools/train.py: its training
branch with ``--device_data`` — the set held on the device, augmentation on
the device, channel-major model input and head — and its ``--test_model``
branch on the synthetic split).

  python -m pvnet_tpu_torch.train --cfg_file configs/synthetic_train.json \\
      --data assets/duck_views_480x640.npz --buckets 480x640 \\
      --init assets/duck_ckpt.msgpack --steps 10 --device cuda

  python -m pvnet_tpu_torch.train --test_model --synthetic \\
      --synthetic_images 2048 --synthetic_occluder_prob 0.5 \\
      --synthetic_clutter 2 --init assets/duck_ckpt.msgpack \\
      [--use_uncertainty_pnp] [--tail_depth 3]

``--data`` is an .npz with the keys of tools/make_torch_fixture.py:
images [n, h, w, 3] uint8, masks [n, h, w] uint8, poses [n, 3, 4],
points_3d [k, 3] and K [3, 3]; the keypoint targets are the projections of
points_3d. A set smaller than one batch is repeated to fill one.
Checkpoints go to ``{model_dir}/{epoch}.pth``, which
``python -m pvnet_tpu_torch.infer --checkpoint`` reads, and the scalar log
to ``{model_dir}/log.jsonl``.

``--test_model --synthetic`` generates the test half of the JAX package's
synthetic split (data/synthetic.generate_synthetic_linemod, seed 0) in the
order tools/train.py evaluates it (test, then val), caches it as an .npz
under ``--data_dir``, and evaluates the weights of ``--init`` (or the
checkpoint ``--load_epoch`` of the model dir) in the recipe's dtype,
printing the 2D-projection, ADD and 5cm5deg rates. The LINEMOD trees of
``--normal``, ``--occluded`` and ``--truncated`` are not read yet.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.data.dataset import eval_batches, load_training_set
from pvnet_tpu_torch.data.synthetic import (evaluation_order,
                                            generate_synthetic_linemod)
from pvnet_tpu_torch.eval.evaluator import Evaluator
from pvnet_tpu_torch.train.checkpoint import load_net
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
    p.add_argument("--test_model", action="store_true",
                   help="evaluate instead of training (needs --synthetic)")
    p.add_argument("--use_uncertainty_pnp", action="store_true")
    p.add_argument("--tail_depth", type=int, default=0, choices=(0, 1, 2, 3),
                   help="evaluation decoder tail: 0 plain; 1-3 packed "
                        "lattice of that depth. tools/train.py defaults to "
                        "3; the port to 0, the faster one on an H100 "
                        "(PERF.md)")
    p.add_argument("--load_epoch", type=int, default=-1,
                   help="checkpoint epoch to evaluate without --init "
                        "(-1: the latest)")
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on the generated synthetic split")
    p.add_argument("--synthetic_images", type=int, default=64)
    p.add_argument("--synthetic_occluder_prob", type=float, default=0.0,
                   help="probability of an occluder object per image")
    p.add_argument("--synthetic_clutter", type=int, default=0,
                   help="max clutter objects per image")
    p.add_argument("--data_dir", default=os.path.join(_REPO, "data"),
                   help="where the generated split is cached")
    return p.parse_args(argv)


def synthetic_test_split(args) -> Tuple[Dict[str, np.ndarray], float]:
    """The synthetic split's test half in evaluation order, from the cache
    under --data_dir or generated (and cached); with the seconds
    generating it took (0 from the cache)."""
    n, occ, clutter = (args.synthetic_images, args.synthetic_occluder_prob,
                       args.synthetic_clutter)
    path = os.path.join(args.data_dir, f"synthetic_duck_{n}_occ{occ:g}_"
                                       f"clutter{clutter}_seed0_test.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}, 0.0
    order = evaluation_order(n)
    print(f"generating the test half of the synthetic split ({len(order)} "
          f"of {n} images, occluder_prob={occ}, clutter<={clutter}) ...",
          flush=True)
    t0 = time.time()
    split = generate_synthetic_linemod(
        n, occluder_prob=occ, max_clutter=clutter, render=order,
        workers=len(os.sched_getaffinity(0)))
    seconds = time.time() - t0
    pos = {int(k): i for i, k in enumerate(split["index"])}
    perm = np.asarray([pos[int(k)] for k in order])
    for k in ("images", "masks", "poses", "index"):
        split[k] = split[k][perm]
    os.makedirs(args.data_dir, exist_ok=True)
    np.savez(path, **split)
    print(f"generated in {seconds:.1f} s; cached as {path}", flush=True)
    return split, seconds


def run_test_model(args, cfg: TrainConfig, model_dir: str, device) -> int:
    """tools/train.py --test_model on the synthetic split."""
    if not args.synthetic:
        raise SystemExit("--test_model needs --synthetic: reading LINEMOD "
                         "trees from disk is not ported yet")
    split, gen_s = synthetic_test_split(args)
    loop = TrainLoop(cfg, model_dir, record_dir=model_dir, device=device)
    state = loop.init_state(args.init)
    epoch = 0
    if not args.init:
        state, epoch = load_net(state, model_dir, args.load_epoch)
        if epoch == 0:
            raise SystemExit(f"no checkpoint in {model_dir}; give --init")
    n = len(split["images"])
    print(f"evaluating {args.init or model_dir} on {n} images at "
          f"{split['images'].shape[1]}x{split['images'].shape[2]}; "
          f"{'bf16' if cfg.bf16 else 'f32'}; tail_depth {args.tail_depth};"
          f" uncertainty {args.use_uncertainty_pnp}; device {device}",
          flush=True)
    t0 = time.time()
    losses = loop.validate(
        state, eval_batches(split, cfg.test_batch_size), epoch,
        evaluate_pose=True, uncertainty=args.use_uncertainty_pnp,
        tail_depth=args.tail_depth,
        evaluator=Evaluator(loop.object_meta(split), device=device))
    eval_s = time.time() - t0
    loop.recorder.close()
    print(json.dumps({
        "images": n, "proj": losses["val/scalar/projection_error"],
        "add": losses["val/scalar/add"], "cm": losses["val/scalar/cm"],
        "dtype": "bf16" if cfg.bf16 else "f32",
        "uncertainty": args.use_uncertainty_pnp,
        "tail_depth": args.tail_depth, "generate_s": gen_s,
        "evaluate_s": eval_s, "images_per_s": n / eval_s}), flush=True)
    return 0


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
    if args.test_model:
        return run_test_model(args, cfg, model_dir, device)
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
