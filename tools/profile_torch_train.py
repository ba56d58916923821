#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one CUDA card.

  python tools/profile_torch_train.py [--steps 5] [--sharded]

The step of chip_smoke.py's phase (f): configs/synthetic_train.json (bf16,
batch 16, Adam) from assets/duck_ckpt.msgpack, the fixture's 2 views tiled
to a device-resident uint8 set of 16, augmentation to 480x640. After 3
warm-up steps it prints:

- the median milliseconds of each stage over --steps steps, from CUDA
  events: gather + augmentation, vertex targets + forward + loss,
  backward, Adam;
- the host's waits for the device in one step (operations that block
  the host until the device's queue drains, from
  torch.cuda.set_sync_debug_mode), by the line that made them;
- from torch.profiler over 2 steps: the device's busy time (the sum of its
  kernels', copies' and memsets' times) against the wall-clock window,
  hence the idle share, and the 12 kernels with the most device time.

``--sharded`` profiles the data-parallel step instead
(trainer.make_sharded_train_step_from_data in a world-1 NCCL group that
the script makes itself: synchronized BatchNorm, DistributedDataParallel,
the metrics' all-reduce), its stages split the same way; the forward runs
through the DDP wrapper, and the whole step's median is printed beside
the stages' sum.

Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import warnings
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 16, 480, 640


def world_one_mesh():
    """A world-1 NCCL group on cuda:0, as torchrun would describe it."""
    import socket
    from pvnet_tpu_torch.parallel import init_process_group
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    return init_process_group("cuda")


def build_step(dev):
    import numpy as np
    import torch
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.data.dataset import load_training_set
    from pvnet_tpu_torch.train.loop import TrainLoop

    cfg = TrainConfig.from_json(os.path.join(REPO, "configs",
                                             "synthetic_train.json"))
    images, masks, hcoords = load_training_set(
        os.path.join(REPO, "assets", "duck_views_480x640.npz"))
    tile = np.arange(B) % len(images)
    loop = TrainLoop(cfg, model_dir=os.devnull, device=dev)
    state = loop.init_state(init=os.path.join(REPO, "assets",
                                              "duck_ckpt.msgpack"))
    data = loop.build_device_dataset(images[tile], masks[tile],
                                     hcoords[tile])
    ids = torch.arange(B, device=dev)
    return cfg, state, data, ids, torch.Generator(device=dev).manual_seed(0)


def stage_ms(cfg, state, data, ids, gen, mesh=None):
    """One step split by CUDA events; the same work as train_step_from_data
    (its pieces called in its order), or with ``mesh`` as the sharded
    step's: the forward through its DDP wrapper (whose backward averages
    the gradients) and the metrics all-reduced."""
    import torch
    from pvnet_tpu_torch.train import trainer as TT

    model = state.model if mesh is None else TT.replica(state, mesh)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    ev[0].record()
    batch = TT.apply_device_aug({k: v[ids] for k, v in data.items()},
                                cfg.aug_cfg, (H, W), generator=gen)
    ev[1].record()
    state.model.train()
    loss, metrics = TT.batch_loss(model, batch, cfg.vertex_loss_ratio,
                                  False, cfg.bf16)
    ev[2].record()
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    ev[3].record()
    state.optimizer.step()
    ev[4].record()
    if mesh is not None:
        TT.global_metrics(metrics, mesh)
    ev[5].record()
    torch.cuda.synchronize()
    names = ("gather+augmentation", "targets+forward+loss", "backward",
             "adam", "metrics")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--sharded", action="store_true",
                   help="the data-parallel step in a world-1 NCCL group")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        return profile(args)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def profile(args) -> int:
    import torch
    from pvnet_tpu_torch.train import trainer as TT
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    mesh = world_one_mesh() if args.sharded else None
    cfg, state, data, ids, gen = build_step(dev)
    if mesh is None:
        def step():
            return TT.train_step_from_data(
                state, data, ids, generator=gen, aug_cfg=cfg.aug_cfg,
                aug_hw=(H, W), bf16=cfg.bf16)
    else:
        sharded = TT.make_sharded_train_step_from_data(
            mesh, aug_cfg=cfg.aug_cfg, aug_hw=(H, W), bf16=cfg.bf16)

        def step():
            return sharded(state, data, ids, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    runs = [stage_ms(cfg, state, data, ids, gen, mesh)
            for _ in range(args.steps)]
    med = {k: sorted(r[k] for r in runs)[len(runs) // 2] for k in runs[0]}
    total = sum(med.values())
    whole = []
    for _ in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        step()
        ev[1].record()
        torch.cuda.synchronize()
        whole.append(ev[0].elapsed_time(ev[1]))
    kind = "sharded (NCCL world 1)" if mesh else "unsharded"
    print(f"stage ms, {kind} (median of {args.steps} bf16 steps, b={B}, "
          f"{H}x{W}): " + ", ".join(f"{k} {v:.3f} ({v / total * 100:.1f} %)"
                                     for k, v in med.items())
          + f"; sum {total:.3f}; whole step median "
          f"{sorted(whole)[len(whole) // 2]:.3f}", flush=True)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    waits = Counter(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                    for w in caught if "synchroniz" in str(w.message))
    print(f"host waits for the device in one step: {sum(waits.values())}"
          + "".join(f"; {n}x {where}" for where, n in waits.most_common()),
          flush=True)
    torch.cuda.synchronize()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the operator
    # rows carry their kernels' time again
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    if not rows:
        print("torch.profiler saw no device time", flush=True)
        return 0
    busy = sum(r[1] for r in rows)
    print(f"profiler, 2 steps: device busy {busy:.3f} ms of a "
          f"{wall_ms:.3f} ms window, idle share {1 - busy / wall_ms:.3f} "
          f"(the profiler slows the host)", flush=True)
    for key, ms, count in rows[:12]:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
