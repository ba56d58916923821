"""Time the port's batched PnP (ops/pnp.pnp_batch and
uncertainty_pnp_batch) on a CUDA card, for comparing two versions of the
solver in one call, and time its two kernels (csrc/pnp.cu) against the
plain functions.

  python tools/bench_torch_pnp.py [--repo DIR] [--batch 16] [--calls 10]

``--repo`` times the ``pvnet_tpu_torch`` package of another checkout (e.g.
a parent commit unpacked with ``git archive``); run both versions in one
call, in turns (parent, change, change, parent), since PnP's time follows
the host. Each call is one request's solve: b problems of the 9 duck
keypoints, noisy projections of random poses, 4 LM starts of 16
iterations. Prints one JSON line: per-call host milliseconds (after a
synchronize), their median, the device operations one call launches
(torch.profiler), and the card's name and power limit. Where the package
has the PnP kernels (``pnp.epnp_plain``), also each kernel's device
milliseconds by CUDA events, warm (50 launches on the same inputs, queued
behind a sleep kernel) and cold (one launch after the L2 was overwritten,
20 times), their bound (the operations of :func:`pnp_operations` at 33.5
T/s, float32 without FMA), and the plain functions' host milliseconds on
the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

OPS_PER_S = 33.5e12        # H100 SXM: float32, non-FMA instructions


def pnp_operations(b: int, n: int = 9, iters: int = 16) -> dict:
    """Float32 operations of the two kernels for b problems of n points,
    counted from csrc/pnp.cu (multiplies, adds, divides, square roots and
    compares; a sine, cosine or arctangent as 20):

    - EPnP: a Jacobi rotation of an m x m matrix 6 (m - 2) + 16 + 6 m and
      75 for its angle; 10 sweeps of 66 rotations (12 x 12), 8 of 36
      (9 x 9), 6 of 3 (3 x 3) in each of 8 calls (control points, plane,
      6 x so3_project); M^T M 4 * 78 * n and A^T A 4 * 45 * n; five seeds'
      Gauss-Newton, 8 iterations of ~1000; ~100 n for the rest of each
      candidate (barycentric, Procrustes, costs) over 6 candidates.
    - LM, per start: per iteration rodrigues and its derivative ~600, a
      6 x 6 Cholesky solve ~200, per point ~280 for the residual, Jacobian
      and the J^T J, J^T r sums, and ~40 for the trial cost.
    """
    def rot(m):
        return 6 * (m - 2) + 16 + 6 * m + 75
    epnp = (10 * 66 * rot(12) + 8 * 36 * rot(9) + 8 * 6 * 3 * rot(3)
            + 4 * 78 * n + 4 * 45 * n + 5 * 8 * 1000 + 6 * 100 * n)
    lm = 4 * iters * (600 + 200 + 280 * n + 40 * n)
    return {"epnp": b * epnp, "lm": b * lm}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_pnp: needs a CUDA card", file=sys.stderr)
        return 1
    from pvnet_tpu_torch.ops import pnp
    from pvnet_tpu_torch.ops.geometry import rodrigues

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    b = args.batch
    with np.load(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "assets",
            "duck_views_480x640.npz")) as z:
        pts3d = torch.tensor(z["points_3d"], device=dev)
        K = torch.tensor(z["K"], device=dev)
    R = rodrigues(torch.tensor(rng.randn(b, 3) * 0.6, dtype=torch.float32,
                               device=dev))
    t = torch.tensor(np.c_[rng.uniform(-0.05, 0.05, (b, 2)),
                           rng.uniform(0.4, 0.8, (b, 1))],
                     dtype=torch.float32, device=dev)
    uv = (pts3d @ R.transpose(1, 2) + t[:, None]) @ K.T
    kps = uv[..., :2] / uv[..., 2:] + torch.tensor(
        rng.randn(b, len(pts3d), 2) * 0.5, dtype=torch.float32, device=dev)
    w3 = torch.tensor(np.stack([rng.uniform(0.5, 2, (b, len(pts3d))),
                                rng.uniform(-0.2, 0.2, (b, len(pts3d))),
                                rng.uniform(0.5, 2, (b, len(pts3d)))], -1),
                      dtype=torch.float32, device=dev)
    solvers = {"pnp_batch": lambda: pnp.pnp_batch(pts3d, kps, K),
               "uncertainty_pnp_batch": lambda: pnp.uncertainty_pnp_batch(
                   kps, w3, pts3d, K)}
    kernels = hasattr(pnp, "epnp_plain")
    if kernels:
        pts = pts3d.expand(b, *pts3d.shape)
        w3_id = pnp.identity_w3(pts)
        pose0 = pnp.epnp_plain(pts, kps, K)
        solvers["plain pnp_batch"] = lambda: pnp.lm_multi_start_plain(
            pnp.epnp_plain(pts, kps, K), pts, kps, K, w3_id, 16)
    out = {"repo": os.path.abspath(args.repo), "batch": b,
           "torch": torch.__version__,
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip().splitlines()[0]}
    for name, fn in solvers.items():
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        out[name] = {"ms": [round(x, 3) for x in ms],
                     "median_ms": sorted(ms)[len(ms) // 2],
                     "launches": launches}
    if kernels:
        ops = pnp_operations(b, len(pts3d))
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        launch = {"epnp": lambda: pnp.epnp(pts, kps, K),
                  "lm": lambda: pnp.lm_multi_start(pose0, pts, kps, K, None,
                                                   16)}
        for name, fn in launch.items():
            fn()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda._sleep(20_000_000)       # ~10 ms: the queue fills
            e0.record()
            for _ in range(50):
                fn()
            e1.record()
            torch.cuda.synchronize()
            warm = e0.elapsed_time(e1) / 50
            cold = []
            for _ in range(20):
                flush.fill_(1)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                cold.append(e0.elapsed_time(e1))
            out[f"kernel {name}"] = {
                "warm_ms": round(warm, 4),
                "cold_ms": round(sorted(cold)[len(cold) // 2], 4),
                "operations": ops[name],
                "bound_ms": round(ops[name] / OPS_PER_S * 1e3, 5)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
