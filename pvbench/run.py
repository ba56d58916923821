#!/usr/bin/env python3
"""The benchmark of pvnet_tpu_torch on NVIDIA GPUs: one run of one cell.

  python3 pvbench/run.py --workload r18_f32.offline_b128 --seed 7 \
      --seconds 30 --trace 0

The cell, its configuration and its traffic are read from BENCHMARK.json
and the files under pvbench/ (pvbench/spec.py). The run builds its inputs
and weights from ``--seed`` on the card, warms every shape it will use
(set-up), runs the traffic for ``--seconds``, then checks a sample of what
the timed path produced against the plain reference (pvbench/reference/,
float32) and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` and, traced, ``breakdown``; then ``checks``, each number
compared with its limit, which also end standard error.

It needs as many CUDA cards as the cell names and exits 2 without them
(every cell so far takes one card). It exits 3 if JAX, flax or the JAX
package was loaded. Build and kernel caches stay inside the checkout.
"""
import time

T_CALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pvnet_tpu")


def process_start() -> float:
    """The wall-clock time at which this process started (Linux), else the
    time of this module's first statement."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_CALL


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (pvnet_tpu_torch is not pvnet_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def set_environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX through
    libraries that would load it."""
    cache = os.path.join(ROOT, ".pvbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def host_load() -> dict:
    """This process's context switches and threads and the host's load
    average (Linux; empty elsewhere), for the run's diagnostic line."""
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key in ("Threads", "voluntary_ctxt_switches",
                           "nonvoluntary_ctxt_switches"):
                    out[key] = float(val)
        with open("/proc/loadavg") as f:
            out["loadavg 1 min"] = float(f.read().split()[0])
    except (OSError, ValueError):
        pass
    return out


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             t_start: float, device) -> dict:
    """Set-up, window and comparison of one run; numbers only."""
    from pvbench import metrics_io
    import torch
    phases = {"imports": time.time() - t_start}
    torch.zeros(1, device=device)
    phases["device"] = time.time() - t_start
    if cell["mix"]["loop"] == "offline":
        from pvbench.offline import Offline
        job = Offline(cell, device)
        job.load_program()
        phases["program"] = time.time() - t_start
        job.load_inputs(seed)
        phases["inputs"] = time.time() - t_start
    else:
        from pvbench.training import Training
        job = Training(cell, device)
        job.load(seed)
        phases["program and inputs"] = time.time() - t_start
    before = host_load()
    res = job.run(seconds, traced, t_start)
    after = host_load()
    if cell["mix"]["loop"] == "offline":
        idx = job.sample(seed, res["attempted"])
        job.free_program()
        readings = job.readings(res["prog"], idx)
    else:
        job.free_program()
        readings = job.readings(res["prog"])
    out = {k: res[k] for k in ("setup_s", "window_s", "attempted", "failed",
                               "e2e")}
    phases["warm-up (set-up ends)"] = res["setup_s"]
    phases.update(res.get("unit_s", {}))
    out["phases"] = phases
    out["host"] = {k: after[k] - before.get(k, 0.0)
                   if k.endswith("switches") else after[k] for k in after}
    out["memory_peak_bytes"] = res.get("memory_peak_bytes", 0)
    out["readings"] = readings
    if traced:
        out.update(metrics_io.per_layer_inputs(res, cell["per_layer_names"]))
    out["forbidden"] = forbidden_modules()
    return out


def finish(bench: dict, cell: dict, res: dict, traced: bool, kind: str):
    """The result line of a run and the check lines that end standard
    error."""
    from pvbench import check, metrics_io
    limits = cell["check"]["limits"]
    readings = res["readings"]
    line = metrics_io.result_line(bench, cell, res, traced, kind)
    line["correct"] = check.judge(readings, limits)
    line["checks"] = {k: {"value": readings[k], "limit": limits[k]}
                      for k in limits}
    return line, check.lines(readings, limits)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()
    sys.path.insert(0, ROOT)
    set_environment()
    from pvbench import spec
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    cell["per_layer_names"] = spec.per_layer(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"pvbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell["chips"] != 1:
        print(f"pvbench: {args.workload} asks for {cell['chips']} cards; "
              f"this harness runs one", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start,
                   torch.device("cuda", 0))
    bad = sorted(set(forbidden_modules()) | set(res["forbidden"]))
    if bad:
        print(f"pvbench: loaded {bad}, which the port must not load",
              file=sys.stderr)
        return 3
    line, checks = finish(bench, cell, res, bool(args.trace),
                          torch.cuda.get_device_name(0))
    print(f"pvbench: {args.workload} seed {args.seed} on {power_line()}",
          flush=True)
    print("pvbench: seconds from the process's start: " + ", ".join(
        f"{k} {v:.2f}" for k, v in res["phases"].items()), file=sys.stderr)
    print("pvbench: host over warm-up and window: " + ", ".join(
        f"{k} {v:g}" for k, v in res["host"].items()), file=sys.stderr)
    if "idle_with_spans" in res:
        print(f"pvbench: device idle {res['idle_with_spans']:.2f} % of the "
              f"stretch profiled with CPU activity and spans",
              file=sys.stderr)
    for text in checks:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
