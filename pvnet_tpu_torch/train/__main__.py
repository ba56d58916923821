"""Train or evaluate PVNet with the port (tools/train.py: its training
branch with ``--device_data`` — the set held on the device, augmentation on
the device, channel-major model input and head — and its ``--test_model``
branch).

  python -m pvnet_tpu_torch.train --linemod_cls cat --data_dir data \\
      [--imagenet_pth resnet18-f37072fd.pth]

  python -m pvnet_tpu_torch.train --linemod_cls cat --data_dir data \\
      --test_model [--use_test_set] [--occluded] [--truncated] \\
      [--use_uncertainty_pnp] [--tail_depth 3] [--save_inter_result]

  python -m pvnet_tpu_torch.train --synthetic --epochs 3

  python -m pvnet_tpu_torch.train --cfg_file configs/synthetic_train.json \\
      --data assets/duck_views_480x640.npz --buckets 480x640 \\
      --init assets/duck_ckpt.msgpack --steps 10 --device cuda

  python -m pvnet_tpu_torch.train --test_model --synthetic \\
      --synthetic_images 2048 --synthetic_occluder_prob 0.5 \\
      --synthetic_clutter 2 --init assets/duck_ckpt.msgpack

The network is the recipe's (``network``: resnet18_8s, resnet34_8s,
resnet50_8s). ``--imagenet_pth`` starts its backbone from a torchvision
ImageNet checkpoint, the heads from the seeded draw (the reference's
standard init); ``--init`` starts every weight from a checkpoint.

``--linemod_cls CLS`` (without ``--synthetic``) trains on the LINEMOD tree
under ``--data_dir`` (LINEMOD/, LINEMOD_ORIG/, OCCLUSION_LINEMOD/, the JAX
package's data.linemod layout) as tools/train.py does: LineModImageDB's
render set, its real train list (the recipe's ``use_real_train``) and its
fuse set (``use_fuse``), validated on the val list (or the test list when
there is none). The whole set is decoded onto the device (data/image_io,
the port's own JPEG/PNG decoder) and augmented there: the counterpart of
JAX's ``--device_aug --device_data``, the only training route of the port
(JAX's host augmentation needs cv2).

``--synthetic`` does what tools/train.py --synthetic does: it writes the
JAX package's synthetic LINEMOD tree (data/synthetic.write_synthetic_linemod,
seed 0: JPEG frames equal to the ones PIL writes, PNG masks, pose files
and the three lists) under ``--data_dir``/synthetic, or /synthetic_occ with
occluders or clutter, unless its train.txt is there already, and then
takes the ``--linemod_cls`` route on that tree, for training and for
``--test_model``: the network trains and is evaluated on the decoded JPEG
frames, as JAX's is.

Otherwise ``--data`` is an .npz with the keys of tools/make_torch_fixture.py:
images [n, h, w, 3] uint8, masks [n, h, w] uint8, poses [n, 3, 4],
points_3d [k, 3] and K [3, 3]; the keypoint targets are the projections of
points_3d.

A training set smaller than one batch is repeated to fill one.
Checkpoints go to ``{model_dir}/{epoch}.pth`` (default
data/model/{cls}_{model_name}), which ``python -m pvnet_tpu_torch.infer
--checkpoint`` reads, and the scalar log to ``{model_dir}/log.jsonl``. The
last line of a training run is a JSON object: the set's sizes, the
generation seconds, every epoch's seconds, steps and losses, and the
kernels' launches.

``--test_model`` evaluates the weights of ``--init`` (or the checkpoint
``--load_epoch`` of the model dir) in the recipe's dtype, printing the
2D-projection, ADD and 5cm5deg rates; RANSAC's draws come from
``--vote_seed``. Without ``--synthetic`` it reads the LINEMOD tree under
``--data_dir`` as tools/train.py does: the test and val lists of
``--linemod_cls`` (with ``--normal``, the default), the Occlusion LINEMOD
test list (``--occluded``, for its 8 classes) and the Truncation LINEMOD
set with its per-image K (``--truncated``); its last line is a JSON object
with each set's rates (and the seconds writing the synthetic tree).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.config import (OCC_LINEMOD_CLS_NAMES, PathConfig,
                                    TrainConfig)
from pvnet_tpu_torch.data.dataset import load_training_set, record_loader
from pvnet_tpu_torch.data.linemod import (LineModImageDB,
                                          OcclusionLineModImageDB,
                                          TruncatedLineModImageDB)
from pvnet_tpu_torch.data.synthetic import write_synthetic_linemod
from pvnet_tpu_torch.eval.evaluator import Evaluator
from pvnet_tpu_torch.ops.kernel_lib import launch_counts
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
                        "{cls}_{model_name})")
    p.add_argument("--linemod_cls", default=None,
                   help="LINEMOD class: train (or with --test_model "
                        "evaluate) on the LINEMOD tree under --data_dir; "
                        "also names the model dir (default duck). The set "
                        "is decoded onto the device and augmented there, "
                        "as JAX's --device_aug --device_data: the port has "
                        "no host augmentation (JAX's needs cv2)")
    p.add_argument("--init", default=None,
                   help="initial weights: a flax msgpack or a .pth")
    p.add_argument("--imagenet_pth", default=None,
                   help="torchvision ImageNet .pth of the recipe's backbone "
                        "(resnet18/34/50) to start the backbone from; the "
                        "heads stay at their seeded draw")
    p.add_argument("--device", default="cuda")
    p.add_argument("--test_model", action="store_true",
                   help="evaluate instead of training: the LINEMOD tree's "
                        "sets, or the synthetic split with --synthetic")
    p.add_argument("--use_test_set", action="store_true",
                   help="name the LINEMOD rates test/ instead of val/")
    p.add_argument("--normal", action="store_true", default=True,
                   help="evaluate the LINEMOD test and val lists (default)")
    p.add_argument("--no-normal", dest="normal", action="store_false")
    p.add_argument("--occluded", action="store_true",
                   help="also evaluate the Occlusion LINEMOD test list")
    p.add_argument("--truncated", action="store_true",
                   help="also evaluate the Truncation LINEMOD set")
    p.add_argument("--vote_seed", type=int, default=0,
                   help="seed of RANSAC's draws in the evaluation")
    p.add_argument("--num_threads", type=int, default=4,
                   help="loader threads of the evaluation")
    p.add_argument("--save_inter_result", action="store_true",
                   help="with --test_model: write each batch's first "
                        "image's predicted and GT masks, image and pose "
                        "of the normal set into --save_inter_dir")
    p.add_argument("--save_inter_dir", default="save_result")
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
                   help="write the synthetic LINEMOD tree under --data_dir "
                        "(unless it is there) and train (or with "
                        "--test_model evaluate) on it")
    p.add_argument("--synthetic_images", type=int, default=64)
    p.add_argument("--synthetic_occluder_prob", type=float, default=0.0,
                   help="probability of an occluder object per image")
    p.add_argument("--synthetic_clutter", type=int, default=0,
                   help="max clutter objects per image")
    p.add_argument("--data_dir", default=os.path.join(_REPO, "data"),
                   help="the LINEMOD root (LINEMOD/, LINEMOD_ORIG/, "
                        "OCCLUSION_LINEMOD/); with --synthetic the parent "
                        "of the synthetic tree's root")
    return p.parse_args(argv)


def synthetic_tree(args, cls_name: str, device) -> Tuple[str, float]:
    """tools/train.py --synthetic's tree: its root under --data_dir
    (``synthetic``, or ``synthetic_occ`` with occluders or clutter),
    written by data/synthetic.write_synthetic_linemod unless its train.txt
    exists; with the seconds writing it took (0 when it was there)."""
    occ = args.synthetic_occluder_prob > 0 or args.synthetic_clutter > 0
    root = os.path.join(args.data_dir, "synthetic_occ" if occ else "synthetic")
    if os.path.exists(os.path.join(root, "LINEMOD", cls_name, "train.txt")):
        return root, 0.0
    print(f"generating synthetic dataset ({args.synthetic_images} images, "
          f"occluder_prob={args.synthetic_occluder_prob}, "
          f"clutter<={args.synthetic_clutter}) ...", flush=True)
    t0 = time.time()
    write_synthetic_linemod(root, cls_name, num_images=args.synthetic_images,
                            occluder_prob=args.synthetic_occluder_prob,
                            max_clutter=args.synthetic_clutter, device=device,
                            workers=len(os.sched_getaffinity(0)))
    seconds = time.time() - t0
    print(f"wrote {root} in {seconds:.1f} s", flush=True)
    return root, seconds


def _eval_state(args, loop: TrainLoop, model_dir: str):
    """(state, epoch) to evaluate: --init's weights, or the checkpoint
    --load_epoch of the model dir."""
    state = loop.init_state(args.init)
    if args.init:
        return state, 0
    state, epoch = load_net(state, model_dir, args.load_epoch)
    if epoch == 0:
        raise SystemExit(f"no checkpoint in {model_dir}; give --init")
    return state, epoch


def linemod_test_sets(args, cls_name: str, paths: PathConfig, device):
    """tools/train.py --test_model's sets of the LINEMOD tree:
    [(name, records, data prefix, per-image K, intermediate-result dir)]
    for --normal (the test list, then the val list; with
    --save_inter_result its results go to --save_inter_dir, as
    tools/train.py writes them for this set only), --occluded (Occlusion
    LINEMOD's test list, for its classes) and --truncated."""
    prefix = "test" if args.use_test_set else "val"
    sets = []
    if args.normal:
        db = LineModImageDB(cls_name, has_render_set=False,
                            has_fuse_set=False, paths=paths, device=device)
        sets.append((prefix, db.test_real_set + db.val_real_set,
                     paths.linemod_dir, False,
                     args.save_inter_dir if args.save_inter_result else None))
    if args.occluded and cls_name in OCC_LINEMOD_CLS_NAMES:
        odb = OcclusionLineModImageDB(cls_name, paths=paths)
        sets.append((f"occ_{prefix}", odb.test_real_set,
                     paths.occlusion_linemod_dir, False, None))
    if args.truncated:
        tdb = TruncatedLineModImageDB(cls_name, paths=paths)
        sets.append(("trun_test", tdb.set, paths.linemod_dir, True, None))
    return sets


def run_test_linemod(args, cfg: TrainConfig, cls_name: str, model_dir: str,
                     device, data_dir: str, gen_s: float) -> int:
    """tools/train.py --test_model on the LINEMOD tree under ``data_dir``
    (``gen_s``: the seconds writing it, for the summary)."""
    paths = PathConfig(data_dir=data_dir)
    loop = TrainLoop(cfg, model_dir, record_dir=model_dir, device=device)
    state, epoch = _eval_state(args, loop, model_dir)
    meta = loop.linemod_object_meta(cls_name, paths)
    results = {}
    for name, records, prefix, own_k, inter_dir in linemod_test_sets(
            args, cls_name, paths, device):
        if not records:
            print(f"{name}: no records under {prefix}", flush=True)
            continue
        print(f"testing {name}: {len(records)} images of {cls_name} from "
              f"{prefix}; {'bf16' if cfg.bf16 else 'f32'}; tail_depth "
              f"{args.tail_depth}; uncertainty {args.use_uncertainty_pnp}; "
              f"vote seed {args.vote_seed}; device {device}", flush=True)
        t0 = time.time()
        loader = record_loader(records, prefix, cfg.vote_type,
                               cfg.test_batch_size, cfg.aug_cfg,
                               use_intrinsic=own_k, device=device,
                               num_threads=args.num_threads)
        losses = loop.validate(
            state, loader, epoch, name, evaluate_pose=True,
            uncertainty=args.use_uncertainty_pnp,
            use_camera_intrinsic=own_k, tail_depth=args.tail_depth,
            vote_seed=args.vote_seed,
            evaluator=Evaluator(meta, device=device),
            save_inter_dir=inter_dir)
        seconds = time.time() - t0
        results[name] = {
            "images": len(records),
            "proj": losses[f"{name}/scalar/projection_error"],
            "add": losses[f"{name}/scalar/add"],
            "cm": losses[f"{name}/scalar/cm"], "evaluate_s": seconds,
            "images_per_s": len(records) / seconds}
    loop.recorder.close()
    print(json.dumps({"class": cls_name, "sets": results,
                      "dtype": "bf16" if cfg.bf16 else "f32",
                      "uncertainty": args.use_uncertainty_pnp,
                      "tail_depth": args.tail_depth,
                      "vote_seed": args.vote_seed, "generate_s": gen_s,
                      "launches": launch_counts()}), flush=True)
    return 0


def linemod_train_val(cfg: TrainConfig, cls_name: str, paths: PathConfig,
                      device):
    """(train records, val records) of a class as tools/train.py builds
    them: the render set, the real train list (use_real_train), the fuse
    set (use_fuse); the val list, or the test list when there is none."""
    db = LineModImageDB(cls_name, has_render_set=True,
                        has_fuse_set=cfg.use_fuse, paths=paths,
                        device=device)
    train_db = list(db.render_set)
    if cfg.use_real_train:
        train_db += db.train_real_set
    if cfg.use_fuse:
        train_db += db.fuse_set
    val_db = db.val_real_set if db.val_real_set else db.test_real_set
    return train_db, val_db


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
    cls_name = args.linemod_cls or "duck"
    name = f"{cls_name}_{cfg.model_name}"
    model_dir = args.model_dir or os.path.join(_REPO, "data", "model", name)
    data_dir, gen_s = args.data_dir, 0.0
    if args.synthetic:
        data_dir, gen_s = synthetic_tree(args, cls_name, device)
    if args.test_model:
        return run_test_linemod(args, cfg, cls_name, model_dir, device,
                                data_dir, gen_s)
    loop = TrainLoop(cfg, model_dir, record_dir=model_dir,
                     buckets=parse_buckets(args.buckets), device=device)
    if args.linemod_cls or args.synthetic:
        paths = PathConfig(data_dir=data_dir)
        train_db, val_db = linemod_train_val(cfg, cls_name, paths, device)
        if not train_db:
            raise SystemExit(f"no training records of {cls_name} under "
                             f"{paths.linemod_dir}")
        n_train, n_val = len(train_db), len(val_db)
        # a set smaller than one batch is repeated to fill one
        train_db = [train_db[i % n_train]
                    for i in range(max(n_train, cfg.train_batch_size))]
        print(f"train set: {n_train} records of {cls_name} (render, real "
              f"train, fuse), val: {n_val}; batch {cfg.train_batch_size}; "
              f"{'bf16' if cfg.bf16 else 'f32'}; {cfg.network}; device "
              f"{device}", flush=True)
        loop.fit_records(train_db, val_db, paths.linemod_dir, cls_name,
                         paths, init=args.init,
                         imagenet_pth=args.imagenet_pth,
                         max_steps=args.steps,
                         num_threads=args.num_threads)
    else:
        images, masks, hcoords = load_training_set(args.data)
        n_train, n_val = len(images), 0
        if n_train < cfg.train_batch_size:
            tile = np.arange(cfg.train_batch_size) % n_train
            images, masks, hcoords = images[tile], masks[tile], hcoords[tile]
        print(f"train set: {len(images)} images at {images.shape[1]}x"
              f"{images.shape[2]}; batch {cfg.train_batch_size}; "
              f"{'bf16' if cfg.bf16 else 'f32'}; device {device}", flush=True)
        loop.fit(images, masks, hcoords, init=args.init,
                 imagenet_pth=args.imagenet_pth, max_steps=args.steps)
    print(f"checkpoints in {model_dir}", flush=True)
    print(json.dumps({"train_images": n_train, "val_images": n_val,
                      "generate_s": gen_s, "epochs": loop.epoch_log,
                      "launches": launch_counts()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
