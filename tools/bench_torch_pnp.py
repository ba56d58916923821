"""Time the port's batched PnP (ops/pnp.pnp_batch and
uncertainty_pnp_batch) on a CUDA card, for comparing two versions of the
solver in one call.

  python tools/bench_torch_pnp.py [--repo DIR] [--batch 16] [--calls 10]

``--repo`` times the ``pvnet_tpu_torch`` package of another checkout (e.g.
a parent commit unpacked with ``git archive``); run both versions in one
call, in turns (parent, change, change, parent), since PnP's time follows
the host. Each call is one request's solve: b problems of the 9 duck
keypoints, noisy projections of random poses, 4 LM starts of 16
iterations. Prints one JSON line: per-call host milliseconds (after a
synchronize), their median, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


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
        out[name] = {"ms": [round(x, 3) for x in ms],
                     "median_ms": sorted(ms)[len(ms) // 2]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
