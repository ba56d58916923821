"""The program's own spans and counters in a ``--trace 1`` run.

``pvnet_tpu_torch.utils.profiling`` records the program's spans while any
``torch.profiler`` collects, so the two stretches that
:func:`pvbench.trace.profiled` profiles leave theirs in its recorder, in
order: first the stretch with CPU activity and the benchmark's spans
(``rec["profiled"]`` batches, or ``rec["profiled_sizes"]`` steps), then
the one with device activity alone (the last ``rec["idle_units"]``
batches or steps). :func:`spans` drains the recorder once and keeps its
spans in the run's record for every reader. A program without the
recorder leaves nothing to read, and each reader then returns None.

Each span is a dict: ``name``, ``id``, ``parent`` (the id of the span it
opened in), ``unit``, ``start_ns`` and ``end_ns`` on the unix clock,
``device_ms`` (CUDA events, or None) and ``counters``.

The profiler's Chrome trace, as :class:`pvbench.trace.DeviceTrace` keeps
it, counts microseconds from a base it does not keep. :func:`offset_us`
finds it again from the benchmark's ``fcn`` and ``voting`` spans, each of
which opens microseconds before the program's span of the same name with
no synchronization between them (``pnp`` is not used: the benchmark's span
synchronizes after it opens).
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional

ALIGN = ("fcn", "voting")


def spans(rec: dict) -> Optional[List[dict]]:
    """The program's spans of this run, in the order they opened (drained
    from its recorder at the first call and kept in ``rec``), or None."""
    if "program_spans" not in rec:
        try:
            from pvnet_tpu_torch.utils.profiling import RECORDER
        except ImportError:
            rec["program_spans"] = None
        else:
            rec["program_spans"] = RECORDER.drain()
    return rec["program_spans"] or None


def named(spans: List[dict], name: str) -> List[dict]:
    return [s for s in spans if s["name"] == name]


def inside(spans: List[dict], outer: dict) -> List[dict]:
    """``outer`` and every span opened inside it."""
    ids, out = {outer["id"]}, [outer]
    for s in spans:
        if s["parent"] in ids:
            ids.add(s["id"])
            out.append(s)
    return out


def host_ms(span: dict) -> float:
    return (span["end_ns"] - span["start_ns"]) / 1e6


def mean_inside(rec: dict, outer: str, n: int, value, last: bool = False):
    """The mean over the first (or ``last``) ``n`` spans named ``outer`` of
    ``value(spans inside it, ``outer`` included)``; None without them or
    where ``value`` gives None."""
    ss = spans(rec)
    if ss is None or not n:
        return None
    outs = named(ss, outer)
    outs = outs[-n:] if last else outs[:n]
    if len(outs) < n:
        return None
    vals = [value(inside(ss, o)) for o in outs]
    if any(v is None for v in vals):
        return None
    return sum(vals) / n


def host_ms_of(name: str):
    """Summed host milliseconds of the spans named ``name``."""
    return lambda group: sum(host_ms(s) for s in group if s["name"] == name)


def device_ms_of(name: str):
    """Summed CUDA-event milliseconds of the spans named ``name``; None if
    one has none, or there are none."""
    def value(group):
        ms = [s["device_ms"] for s in group if s["name"] == name]
        return None if not ms or None in ms else sum(ms)
    return value


def counter_of(name: str):
    """Summed counter ``name`` of the spans."""
    return lambda group: sum(s["counters"].get(name, 0) for s in group)


def offset_us(rec: dict) -> Optional[float]:
    """Unix microseconds minus the Chrome trace's microseconds in the
    stretch profiled with CPU activity: the median, over its batches, of
    each program ``fcn`` / ``voting`` span's start less the start of the
    benchmark's span of the same name."""
    ss, tr, n = spans(rec), rec.get("trace"), rec.get("profiled")
    if ss is None or tr is None or not n:
        return None
    diffs = []
    for name in ALIGN:
        bench = [s for s in tr.spans if s[0] == name][:n]
        prog = named(ss, name)[:n]
        diffs += [p["start_ns"] / 1e3 - b[1] for p, b in zip(prog, bench)]
    return statistics.median(diffs) if diffs else None


def idle_by_span(rec: dict) -> Optional[Dict[str, float]]:
    """The device's idle seconds in the stretch profiled with CPU activity,
    by the innermost program span open at the launch of the device
    operation that ended each gap (``None`` labels gaps outside every
    program span); None where the clocks cannot be aligned."""
    if "program_idle" in rec:
        return rec["program_idle"]
    off = offset_us(rec)
    if off is None:
        return None
    tr = rec["trace"]
    opened = sorted(((s["start_ns"] / 1e3 - off, s["end_ns"] / 1e3 - off,
                      s["name"], s["parent"] is None) for s in spans(rec)),
                    key=lambda s: s[0])
    starts = [s[0] for s in opened]

    def label(ts: float) -> Optional[str]:
        # the latest-opened span that still holds ts is the innermost; no
        # span opened before an outermost one that ended holds it
        for j in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
            _, stop, name, outermost = opened[j]
            if ts <= stop:
                return name
            if outermost:
                break
        return None

    out: Dict[Optional[str], float] = defaultdict(float)
    end = None
    for _, ts, dur, corr in tr.kernels:
        if end is not None and ts > end:
            launch = tr.launch_ts.get(corr)
            out[None if launch is None else label(launch)] += \
                (ts - end) / 1e6
        end = ts + dur if end is None else max(end, ts + dur)
    rec["program_idle"] = dict(out)
    return rec["program_idle"]


def idle_ms(rec: dict, name: str) -> Optional[float]:
    """Milliseconds a batch of device idle that launches inside program
    span ``name`` ended, in the stretch profiled with CPU activity."""
    idle = idle_by_span(rec)
    if idle is None:
        return None
    return 1e3 * idle.get(name, 0.0) / rec["profiled"]
