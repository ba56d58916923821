"""Readings of the comparison that decides ``correct``, over many seeds in
one process: the program's (the lower readings of the limits), the
control's (the plain reference computed in the precision below the
configuration's, in the program's place: the upper readings) and, with
``--fault``, the program's with a fault planted (pvbench/faults.py).

  python3 -m pvbench.control --workload r18_f32.offline_b128 \
      --seeds 101-112 --control tf32 --control_seeds 101-103 --seconds 3

Each seed runs the cell's own set-up and a short window at its own load,
then the comparison of as many answers (or checked steps) as a run makes;
one JSON line a seed and mode. The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        a, _, b = part.partition("-")
        out += list(range(int(a), int(b) + 1)) if b else [int(a)]
    return out


def readings(cell: dict, seed: int, seconds: float, control=None,
             fault=None, job=None):
    """One seed's readings; ``job`` is reused across seeds where it can
    be (the offline model)."""
    from pvbench import faults
    ctx = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    t0 = time.time()
    with ctx:
        if cell["mix"]["loop"] == "offline":
            job.load_inputs(seed)
            res = job.run(seconds, False, t0)
            out = job.readings(res["prog"], job.sample(seed,
                                                       res["attempted"]),
                               control)
        else:
            job.load(seed)
            res = job.run(seconds, False, t0)
            job.free_program()
            out = job.readings(res["prog"], control)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default=None, choices=("tf32", "fp8"))
    p.add_argument("--control_seeds", default="")
    p.add_argument("--fault", default=None,
                   help="comma-separated names of pvbench/faults.py")
    p.add_argument("--fault_seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from pvbench import spec
    cell = spec.cell(args.workload)
    plan = [(s, None, None) for s in seeds(args.seeds)]
    plan += [(s, args.control, None) for s in seeds(args.control_seeds)]
    plan += [(s, None, f) for f in filter(None, (args.fault or "").split(","))
             for s in seeds(args.fault_seeds)]
    device = torch.device("cuda", 0)
    if cell["mix"]["loop"] == "offline":
        from pvbench.offline import Offline
        job = Offline(cell, device)
        job.load_program()
    else:
        from pvbench.training import Training
        job = Training(cell, device)
    for seed, control, fault in plan:
        t = time.time()
        r = readings(cell, seed, args.seconds, control, fault, job)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": control or (f"fault:{fault}" if fault
                                              else "program"),
                          "readings": r, "s": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
