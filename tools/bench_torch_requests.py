"""Time the port's single-card serving requests and training step on a
CUDA card, for comparing two versions of the package in one call.

  python tools/bench_torch_requests.py [--repo DIR] [--requests 5]
      [--steps 5]

``--repo`` times the ``pvnet_tpu_torch`` package of another checkout (e.g.
a parent commit unpacked with ``git archive``); run both versions in one
call, in turns (parent, change, change, parent). Requests: 16 images at
480x640 (the fixture's views tiled, as chip_smoke.py's), the duck
checkpoint in float32 without TF32, through ``infer.infer_batch`` at
tail_depth 0 (plain) and 3 (packed), one warm-up each; host milliseconds
after a synchronize. Steps: configs/synthetic_train.json (bf16, b=16)
through ``trainer.train_step_from_data`` on the fixture held on the card,
3 warm-up steps. Prints one JSON line: the per-request and per-step
milliseconds, their medians, the version's path, and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_requests: needs a CUDA card", file=sys.stderr)
        return 1
    from pvnet_tpu_torch import infer
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.data.dataset import load_training_set
    from pvnet_tpu_torch.train import trainer as TT

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fixture = os.path.join(HERE, "assets", "duck_views_480x640.npz")
    ckpt = os.path.join(HERE, "assets", "duck_ckpt.msgpack")
    with np.load(fixture) as z:
        views, pts, K = z["images"], z["points_3d"], z["K"]
    rng = np.random.RandomState(0)
    idx = np.arange(16) % len(views)
    model = infer.load_model(ckpt, len(pts), dev)
    pts_t, K_t = torch.tensor(pts, device=dev), torch.tensor(K, device=dev)
    params = pl.VoteParams()
    out = {"repo": os.path.abspath(args.repo)}
    for name, depth in (("plain", 0), ("packed", 3)):
        gen = torch.Generator(device=dev).manual_seed(0)
        ms = []
        for r in range(args.requests + 1):
            imgs = np.clip(views[idx].astype(np.int16)
                           + rng.randint(-3, 4, (16, 1, 1, 1)), 0,
                           255).astype(np.uint8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            infer.infer_batch(model, imgs, pts_t, K_t, params, gen,
                              tail_depth=depth)
            torch.cuda.synchronize()
            if r:                                   # 0: the warm-up
                ms.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_ms"] = ms
        out[f"{name}_median_ms"] = statistics.median(ms)

    cfg = TrainConfig.from_json(os.path.join(HERE, "configs",
                                             "synthetic_train.json"))
    images, masks, hcoords = load_training_set(fixture)
    tile = np.arange(cfg.train_batch_size) % len(images)
    data = {"image": torch.from_numpy(images[tile]).to(dev),
            "mask": torch.from_numpy(masks[tile]).to(dev),
            "hcoords": torch.from_numpy(hcoords[tile]).to(dev),
            "ignore": torch.zeros(len(tile), device=dev)}
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.utils.weights import load_weights
    net = build_model(cfg.network, ver_dim=2 * len(pts), seg_dim=2)
    load_weights(net, ckpt)
    state = TT.create_train_state(net.to(dev), cfg)
    ids = torch.arange(len(tile), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = []
    for s in range(3 + args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        TT.train_step_from_data(state, data, ids, generator=gen,
                                aug_cfg=cfg.aug_cfg, aug_hw=(480, 640),
                                bf16=cfg.bf16)
        torch.cuda.synchronize()
        if s >= 3:
            ms.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = ms
    out["step_median_ms"] = statistics.median(ms)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
