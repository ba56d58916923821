#!/usr/bin/env python3
"""Where the time of the port's packed serving path goes, on one CUDA card.

  python tools/profile_torch_serving.py [--repeats 5]

The request of chip_smoke.py's phase (g): 16 fixture images at 480x640,
resnet18_8s with assets/duck_ckpt.msgpack, float32 with TF32 off,
tail_depth 3. It prints:

- the median milliseconds of each piece of the packed tail over
  --repeats runs, from CUDA events: per stage (4s, 2s, raw) the phase
  upsample (two matrix products and the copy into packed order), the
  2x2 lattice convolution, the stride-2 skip (or rgb) convolution and the
  BatchNorm + LeakyReLU, then the head matmul with fgcnt; beside them the
  plain decoder's stages (conv4s, conv2s, convraw with their upsamples);
- from torch.profiler over one whole request (infer_batch with
  uncertainty): the device's busy time against the wall-clock window,
  hence the idle share, and the 12 kernels with the most device time;
- the same over the select stage alone, on the plain path
  (voting.sample_foreground on the plain forward's fields: mask sum,
  noise, score, kernel K1, compaction) and on the packed path
  (voting.sample_foreground_packed, through K2): its device operations and
  the kernels by device time.

Needs a CUDA card; exits 1 without one.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W, VN = 16, 480, 640, 9


def timed(pieces, fns):
    """Run fns in order, each recording a CUDA event after it; add each
    one's milliseconds to pieces[name]. Returns the last result."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(fns) + 1)]
    ev[0].record()
    out = None
    for i, (name, fn) in enumerate(fns):
        out = fn(out)
        ev[i + 1].record()
    torch.cuda.synchronize()
    for i, (name, _) in enumerate(fns):
        pieces.setdefault(name, []).append(ev[i].elapsed_time(ev[i + 1]))
    return out


def packed_pieces(model, x, pieces):
    import torch
    import torch.nn.functional as F
    from pvnet_tpu_torch.ops import packed_tail as PT

    f32 = torch.float32
    fm8, x4s, x2s = model(x, return_8s_features=True)
    h2, w2 = x2s.shape[2:]
    stages = [("4s", PT._fold_stage(model.conv4s, fm8.shape[1],
                                    *x4s.shape[2:]), x4s, False),
              ("2s", PT._fold_stage(model.conv2s,
                                    model.conv4s[0].out_channels, h2, w2),
                x2s, True),
              ("raw", PT._fold_tail(model, H, W, h2, w2), x, True)]
    fm = fm8
    for name, p, skip, packed_in in stages:
        up_fn = (PT.phase_upsample_from_packed if packed_in
                 else PT.phase_upsample_packed)
        w_skip = p.w_skip if name != "raw" else p.w_im
        fm = timed(pieces, [
            (f"{name} upsample", lambda _, fm=fm: up_fn(fm, p.ah, p.aw, f32)),
            (f"{name} lattice conv", lambda up: F.conv2d(up, p.w_fm)),
            (f"{name} skip conv", lambda y: y + PT._conv_skip_direct(
                skip, w_skip, f32)),
            (f"{name} bn+lrelu", lambda y: PT._bn_lrelu(y, p.scale4,
                                                        p.bias4, 0.1))])
    tp = stages[-1][1]
    timed(pieces, [("head+fgcnt", lambda _: (
        fm.permute(0, 2, 3, 1) @ tp.w_head4 + tp.b_head4)
        .reshape(B, h2, w2, 4, -1)[..., :2].argmax(-1).sum(-1))])


def plain_pieces(model, x, pieces):
    import torch
    from pvnet_tpu_torch.models.pvnet import _upsample

    fm8, x4s, x2s = model(x, return_8s_features=True)
    timed(pieces, [
        ("plain up+conv4s", lambda _: model.conv4s(torch.cat(
            [_upsample(fm8, *x4s.shape[2:]), x4s], 1))),
        ("plain up+conv2s", lambda fm: model.conv2s(torch.cat(
            [_upsample(fm, *x2s.shape[2:]), x2s], 1))),
        ("plain up+convraw", lambda fm: model.convraw(torch.cat(
            [_upsample(fm, H, W), x], 1)))])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from pvnet_tpu_torch import infer, pipeline as pl
    from pvnet_tpu_torch.ops import packed_tail as PT, voting
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    with np.load(os.path.join(REPO, "assets", "duck_views_480x640.npz")) as z:
        images = z["images"][np.arange(B) % len(z["images"])]
        pts = torch.as_tensor(z["points_3d"], device=dev)
        K = torch.as_tensor(z["K"], device=dev)
    model = infer.load_model(os.path.join(REPO, "assets",
                                          "duck_ckpt.msgpack"), VN, dev)
    x = pl.normalize_images(torch.from_numpy(images).to(dev))
    x = x.permute(0, 3, 1, 2).contiguous()
    pieces = {}
    with torch.no_grad():
        for r in range(args.repeats + 1):       # the first is a warm-up
            packed_pieces(model, x, pieces)
            plain_pieces(model, x, pieces)
    med = {k: sorted(v[1:])[len(v[1:]) // 2] for k, v in pieces.items()}
    packed = sum(v for k, v in med.items() if not k.startswith("plain"))
    plain = sum(v for k, v in med.items() if k.startswith("plain"))
    print(f"median ms of {args.repeats} runs, b={B}, {H}x{W}, float32: "
          f"packed tail {packed:.3f}, plain decoder stages {plain:.3f}",
          flush=True)
    for k, v in med.items():
        print(f"  {v:9.3f} ms  {k}", flush=True)

    def request():
        return infer.infer_batch(model, images, pts, K, pl.VoteParams(),
                                 torch.Generator(device=dev).manual_seed(0),
                                 tail_depth=3, uncertainty=True)

    profile_once("one packed request with uncertainty", request, 12)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        mask, vertex = pl.predict_fields(model, pl.normalize_images(
            torch.from_numpy(images).to(dev)))
        packed, fgcnt = PT.packed_tail_deep3_from_model(
            model, *model(x, return_8s_features=True), x, dtype=torch.float32)
    profile_once("the plain path's select stage (sample_foreground, K1)",
                 lambda: voting.sample_foreground(mask, vertex, 512,
                                                  generator=g), 40)
    profile_once("the packed path's select stage (sample_foreground_packed, "
                 "K2)", lambda: voting.sample_foreground_packed(
                     packed, fgcnt, 512, generator=g), 40)
    return 0


def profile_once(label, fn, top):
    """torch.profiler over one call of fn after a warm-up: the device's busy
    time against the wall-clock window, its operations, and the top
    kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    if not rows:
        print(f"profiler, {label}: torch.profiler saw no device time",
              flush=True)
        return
    busy = sum(r[1] for r in rows)
    print(f"profiler, {label}: device busy {busy:.3f} ms of a "
          f"{wall_ms:.3f} ms window, idle share {1 - busy / wall_ms:.3f}, "
          f"{sum(r[2] for r in rows)} device operations (the profiler slows "
          f"the host)", flush=True)
    for key, ms, count in rows[:top]:
        print(f"  {ms:9.3f} ms  {count:5d}x  {key[:100]}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
