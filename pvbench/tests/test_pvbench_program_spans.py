"""The readers of the program's spans (pvbench/program_spans.py and the
metrics that use it) on a fabricated device trace and recorder spans
whose clock is offset from the trace's by a known amount: the offset is
recovered, each planted idle gap goes to the right span, each metric
reads its planted value, and every reader returns None where the program
recorded nothing or has no recorder."""
import sys
import types

import pytest

from pvbench import program_spans as ps
from pvbench import spec
from pvbench.trace import DeviceTrace

OFF_US = 1.792e12 + 123.25      # unix µs minus trace µs
LAG_US = 4.0                    # the program's span opens after the bench's
PERIOD = 10000.0                # µs between batches


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


class _Batches:
    """Two profiled batches: the benchmark's spans, the program's spans on
    the unix clock, and kernels with planted gaps."""

    def __init__(self):
        self.events, self.spans, self.corr, self.ids = [], [], 0, 0

    def kernel(self, launch, start, dur):
        self.corr += 1
        self.events.append(_x("cuda_runtime", "cudaLaunchKernel", launch, 2.0,
                              correlation=self.corr))
        self.events.append(_x("kernel", f"k{self.corr}", start, dur,
                              correlation=self.corr))

    def span(self, name, start, end, parent=None, unit=0, device_ms=None,
             **counters):
        self.ids += 1
        s = {"name": name, "id": self.ids,
             "parent": None if parent is None else parent["id"],
             "unit": unit, "start_ns": int((start + OFF_US) * 1e3),
             "end_ns": int((end + OFF_US) * 1e3), "device_ms": device_ms,
             "counters": counters}
        self.spans.append(s)
        return s

    def batch(self, k):
        t = k * PERIOD
        for name, a, b in (("fcn", 0, 1000), ("voting", 1000, 2000),
                           ("pnp", 2000, 6000)):
            self.events.append(_x("user_annotation", "pvbench." + name,
                                  t + a, b - a))
        u = 3 * k
        self.span("fcn", t + LAG_US, t + 995, unit=u)
        self.span("voting", t + 1000 + LAG_US, t + 1990, unit=u + 1)
        pnp = self.span("pnp", t + 2100, t + 5900, unit=u + 2, host_syncs=1)
        self.span("pnp.epnp", t + 2110, t + 3000, pnp, u + 2, host_syncs=8)
        self.span("pnp.lm", t + 3010, t + 5800, pnp, u + 2, host_syncs=1)
        self.kernel(t + 50, t + 100, 800)           # fcn: ends at t + 900
        self.kernel(t + 1200, t + 1300, 100)        # gap 400 µs: voting
        self.kernel(t + 2400, t + 2500, 100)        # gap 1100 µs: pnp.epnp
        self.kernel(t + 3200, t + 3500, 100)        # gap 900 µs: pnp.lm
        self.kernel(t + 3550, t + 3600, 50)         # no gap
        self.kernel(t + 5850, t + 5950, 10)         # gap 2300 µs: pnp


def _offline_rec():
    b = _Batches()
    for k in range(2):
        b.batch(k)
    # the stretch profiled with device activity alone: two batches of
    # estimate_poses, from which the host-time readers take EPnP and the
    # LM, and whose counts no profiled-with-CPU reader may take
    for j in range(2):
        t = (3 + j) * PERIOD
        est = b.span("estimate", t, t + PERIOD - 10, unit=9 + j)
        pnp = b.span("pnp", t + 5000, t + 9000, est, 9 + j, host_syncs=99)
        b.span("pnp.epnp", t + 6000, t + 6500 + 100 * j, pnp, 9 + j)
        b.span("pnp.lm", t + 6600 + 100 * j, t + 8600, pnp, 9 + j)
    return {"trace": DeviceTrace(b.events, 0.02), "profiled": 2,
            "idle_units": 2, "program_spans": b.spans}


def _read(metric, rec):
    return spec.metric_module(metric).read(rec)


def test_offset_is_recovered():
    assert ps.offset_us(_offline_rec()) == pytest.approx(OFF_US + LAG_US,
                                                         abs=0.01)


def test_gaps_go_to_the_innermost_program_span():
    idle = ps.idle_by_span(_offline_rec())
    # fcn: the second batch's first kernel, 4140 µs after the first's last
    want = {"fcn": 0.00414, "voting": 0.0008, "pnp.epnp": 0.0022,
            "pnp.lm": 0.0018, "pnp": 0.0046}
    assert set(idle) == set(want)
    for k, v in want.items():
        assert idle[k] == pytest.approx(v, abs=1e-9), k


@pytest.mark.parametrize("metric,want", [
    ("epnp_ms.infer", 0.55), ("lm_ms.infer", 1.95),
    ("pnp_syncs.infer", 10.0), ("epnp_idle_ms.infer", 1.1),
    ("lm_idle_ms.infer", 0.9)])
def test_pose_readers(metric, want):
    assert _read(metric, _offline_rec()) == pytest.approx(want, abs=1e-6)


def _train_rec(device_ms=True):
    b = _Batches()
    for j in range(3):      # the stretch profiled with CPU activity
        b.span("augment", j * 100, j * 100 + 10, unit=2 * j)
        step = b.span("train.step", j * 100 + 10, j * 100 + 90,
                      unit=2 * j + 1)
        b.span("train.forward", j * 100 + 11, j * 100 + 30, step,
               device_ms=99.0)
    for j in range(4):      # the cycle profiled with device activity alone
        t = 1000 + j * 100
        step = b.span("train.step", t, t + 90, unit=10 + j)
        b.span("augment", t + 1, t + 9, step, device_ms=9.0)
        ms = (lambda v: v) if device_ms else (lambda v: None)
        b.span("train.forward", t + 10, t + 30, step, device_ms=ms(30.0 + j))
        b.span("train.optimizer", t + 31, t + 32, step, device_ms=ms(0.5))
        b.span("train.backward", t + 33, t + 70, step, device_ms=ms(50.0))
        b.span("train.optimizer", t + 71, t + 80, step, device_ms=ms(4.5))
    return {"idle_units": 4, "profiled_sizes": [None] * 3,
            "program_spans": b.spans}


@pytest.mark.parametrize("metric,want", [
    ("forward_ms.train", 31.5), ("backward_ms.train", 50.0),
    ("optimizer_ms.train", 5.0)])
def test_train_readers(metric, want):
    assert _read(metric, _train_rec()) == pytest.approx(want)
    assert _read(metric, _train_rec(device_ms=False)) is None


NEW = ("epnp_ms.infer", "lm_ms.infer", "pnp_syncs.infer",
       "epnp_idle_ms.infer", "lm_idle_ms.infer", "forward_ms.train",
       "backward_ms.train", "optimizer_ms.train")


@pytest.mark.parametrize("metric", NEW)
def test_none_without_the_programs_spans(metric):
    """No spans recorded (the key missing: the recorder is drained and
    holds none here), or a program without a recorder."""
    rec = _offline_rec()
    rec.update(idle_units=4, program_spans=[])
    assert _read(metric, rec) is None
    del rec["program_spans"]
    assert _read(metric, rec) is None
    old = types.ModuleType("pvnet_tpu_torch.utils.profiling")
    saved = sys.modules.get(old.__name__)
    sys.modules[old.__name__] = old
    try:
        rec = _offline_rec()
        rec["idle_units"] = 4
        del rec["program_spans"]
        assert _read(metric, rec) is None
    finally:
        if saved is None:
            del sys.modules[old.__name__]
        else:
            sys.modules[old.__name__] = saved


def test_every_new_metric_has_its_entry():
    bench = spec.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric in NEW:
        mod = spec.metric_module(metric)
        m = entries[metric]
        assert (m["unit"], m["layer"], m["moves"], m["source"]) == (
            mod.UNIT, mod.LAYER, mod.MOVES, "program_span")
