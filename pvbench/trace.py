"""Spans and the device trace of a ``--trace 1`` run.

:class:`Spans`: CUDA events around each named stage of each batch or
step, read once the window has closed (the pattern of the repository's
chip_smoke.py ``stage_ms``), and a ``torch.profiler.record_function`` of
the same name, so that the device trace can tell what the host did.

:func:`profiled`: ``torch.profiler`` over a short steady stretch; its
Chrome trace is written to a temporary file, read back and deleted. From
it: the device's busy seconds (the union of every kernel, copy and fill),
the kernels' seconds by name and, where the stretch also recorded CPU
activity and spans, the kernels that each host span launched and the
idle gaps between device work labelled by the span that launched the
work after the gap. Recording CPU activity and the spans' host
synchronizations slows a launch-bound host, and so, less, does recording
device activity alone: the device's busy seconds a batch or step are
read from a second stretch, profiled with device activity alone and run
without spans, and :func:`window_busy_s` scales them to the traced
run's window, whose host clock no profiler slowed.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "pvbench."


class Spans:
    """Named stages timed with CUDA events; ``on=False`` times nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event]] \
            = []
        self.ms: Dict[str, List[float]] = defaultdict(list)
        self.host_ms: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str, host_clock: bool = False):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(PREFIX + name):
            if host_clock:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            if host_clock:
                torch.cuda.synchronize()
                self.host_ms[name].append((time.perf_counter() - t0) * 1e3)
            self.pending.append((name, a, b))

    def read(self) -> None:
        """Turn the recorded events into milliseconds (synchronizes)."""
        torch.cuda.synchronize()
        for name, a, b in self.pending:
            self.ms[name].append(a.elapsed_time(b))
        self.pending.clear()


class DeviceTrace:
    """What one profiled stretch shows."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        self.kernels = [(e["name"], float(e["ts"]), float(e["dur"]),
                         e.get("args", {}).get("correlation"))
                        for e in dev]
        self.kernels.sort(key=lambda k: k[1])
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(PREFIX)]
        self.spans = sorted(((e["name"][len(PREFIX):], float(e["ts"]),
                              float(e["ts"]) + float(e["dur"]))
                             for e in spans), key=lambda s: s[1])
        self._starts = [s[1] for s in self.spans]
        launches = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                       "cuda_driver"):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    launches[c] = float(e["ts"])
        self.launch_ts = launches

    # -- totals ------------------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which some device work ran (union of intervals)."""
        total, end = 0.0, None
        for _, ts, dur, _ in self.kernels:
            if end is None or ts > end:
                total += dur
                end = ts + dur
            elif ts + dur > end:
                total += ts + dur - end
                end = ts + dur
        return total / 1e6

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, _, dur, _ in self.kernels:
            out[name] += dur / 1e6
        return dict(out)

    def seconds_matching(self, *parts: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds any of
        ``parts``."""
        ks = [k for k in self.kernels if any(p in k[0] for p in parts)]
        return sum(k[2] for k in ks) / 1e6, len(ks)

    def kernel_seconds(self) -> float:
        return sum(k[2] for k in self.kernels
                   if not k[0].startswith(("Memcpy", "Memset"))) / 1e6

    # -- by host span ------------------------------------------------------
    def span_of(self, ts: float) -> Optional[str]:
        """The innermost benchmark span open on the host at ``ts``."""
        # the latest-opened span that still holds ts is the innermost
        for j in range(bisect.bisect_right(self._starts, ts) - 1, -1, -1):
            name, a, b = self.spans[j]
            if ts <= b:
                return name
            if ts - a > 600e6:          # no span lasts ten minutes
                break
        return None

    def launched_in(self, span: str) -> int:
        """Device operations launched from inside host span ``span``."""
        n = 0
        for _, _, _, c in self.kernels:
            ts = self.launch_ts.get(c)
            if ts is not None and self.span_of(ts) == span:
                n += 1
        return n

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The device's idle time, by the span whose launch ended each
        gap, largest first."""
        out: Dict[str, float] = defaultdict(float)
        end = None
        for _, ts, dur, c in self.kernels:
            if end is not None and ts > end:
                lt = self.launch_ts.get(c)
                label = (self.span_of(lt) if lt is not None else None) \
                    or "outside the benchmark's spans"
                out[label] += (ts - end) / 1e6
            end = ts + dur if end is None else max(end, ts + dur)
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def top_ops(self, top: int = 10) -> List[List]:
        return [[k, v] for k, v in sorted(self.seconds_by_name().items(),
                                          key=lambda kv: -kv[1])[:top]]


def window_busy_s(rec: dict):
    """The device's busy seconds in the window: those a unit (batch or
    step) of the stretch profiled with device activity alone
    (``device_trace`` over ``idle_units``) times the window's units
    (``window_units``); None without a trace."""
    tr = rec.get("device_trace")
    if tr is None or not tr.kernels or not rec.get("idle_units"):
        return None
    return tr.busy_s() / rec["idle_units"] * rec["window_units"]


def profiled(fn, cpu: bool = True) -> DeviceTrace:
    """Run ``fn`` under torch.profiler (CUDA activity, and CPU activity
    with ``cpu``) between two synchronizations; the window is the host
    clock between them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return DeviceTrace(events, window)
