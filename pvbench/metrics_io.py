"""From a run's results to its last line.

The per-layer metrics are read where the device trace is (each metric's
module under metrics/, found by name).
"""
from __future__ import annotations

from typing import Dict, List

from pvbench import spec, trace


def per_layer_inputs(res: dict, names: List[str]) -> dict:
    """The run's per-layer metric values (None where a reader found
    nothing), the device's busy seconds in the window
    (``trace.window_busy_s``) and the window's length, the idle share of
    the stretch profiled with CPU activity and spans (for the diagnostic
    line), and the breakdown from that stretch."""
    rec = res["record"]
    tr = res["trace"]
    values = {}
    for name, mod in spec.metric_modules(names).items():
        v = mod.read(rec)
        values[name] = None if v is None else float(v)
    return {"per_layer": values, "busy_s": trace.window_busy_s(rec),
            "traced_window_s": rec["window_s"],
            "idle_with_spans": 100.0 * (1.0 - tr.busy_s() / tr.window_s),
            "device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}


def result_line(bench: dict, cell: dict, res: dict, traced: bool,
                kind: str) -> dict:
    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    metrics: Dict[str, dict] = {}
    if not traced:
        for name in spec.end_to_end(bench, cell["name"]):
            v = res["setup_s"] if name == "setup_s" else res["e2e"][name]
            metrics[name] = {"value": float(v), "unit": units[name]}
    else:
        for name in spec.per_layer(bench, cell["name"]):
            v = res["per_layer"].get(name)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": None, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": device}
    if traced:
        device["busy_s"] = float(res["busy_s"])
        device["window_s"] = float(res["traced_window_s"])
        line["breakdown"] = {"device_ops": res["device_ops"],
                             "idle_gaps": res["idle_gaps"]}
    return line
