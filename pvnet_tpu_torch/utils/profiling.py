"""Profiling, step timing and the program's spans (port of
pvnet_tpu/utils/profiling.py, the same names, and the span recorder).

:class:`StepTimer` times steps on the host clock and, with ``sync``,
waits for the CUDA device that holds a step's result before reading it
(PyTorch returns before the card finishes); :func:`trace` records a
``torch.profiler`` trace, with CUDA activity where a card is present,
and writes it into ``log_dir`` as a Chrome trace (chrome://tracing,
Perfetto), with the program's spans beside it.

The program's spans: :func:`annotate` names a region of the program, and
:func:`count` adds to a counter of the innermost open region. Both are
off by default, and then ``annotate`` returns one shared null context
after reading a flag. They are on inside :func:`recording` and while any
``torch.profiler`` is collecting (also around :func:`trace`), except
while ``torch.compile`` or ``torch.export`` traces the code. On, each
span is kept in :data:`RECORDER` with its name, parent, unit (each
outermost span opens a new unit, which its inner spans share), host
start and end in unix nanoseconds (``time.time_ns()``, the clock of the
profiler's Chrome trace: ``baseTimeNanoseconds + ts * 1000``), its
counters, and, where CUDA is in use, CUDA events around it that are read
when the recorder is drained; it is also a
``torch.profiler.record_function("pvnet." + name)``. Where CUDA is in
use, each outermost span counts the host synchronizations of the CUDA
device inside it as the counter ``host_syncs`` of the innermost span
(PyTorch's sync debug mode, whose warnings are counted and not shown),
unless a sync debug mode is already set. The mode and the warnings'
filters and hook are process-wide: they are set while an outermost span
is open on any thread, and a thread outside the spans that warns then, or
changes the filters, meets them (``warnings.catch_warnings`` is not
thread-safe).

The spans the program records (its one counter, ``host_syncs``, lands on
any of them):

=================  ========================================
span (parent)      where
=================  ========================================
estimate           pipeline.estimate_poses
fcn                pipeline.predict_fields,
                   pipeline.fused_tail_foreground
voting             voting.ransac_voting_v3(_from_fg)
pnp                pipeline.poses_from_keypoints
pnp.epnp (pnp)     pnp.epnp
pnp.lm (pnp)       pnp.lm_multi_start
augment            trainer.apply_device_aug
train.step         trainer.train_step (in train_step_from_data
                   after the gather)
train.forward,     trainer.batch_loss in the step,
train.backward,    loss.backward(), zero_grad and
train.optimizer    optimizer.step() (train.step)
=================  ========================================
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a result (a tensor, or nested
    tuples, lists and dicts of them)."""
    if torch.is_tensor(tree):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(t) for t in tree))
    return set()


class StepTimer:
    """Wall-clock step timing with optional device sync."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """The seconds since :meth:`start`, recorded; with ``sync``, after
        the CUDA devices that hold ``result``'s tensors have finished (the
        others are not waited for)."""
        if self.sync and result is not None:
            for dev in _cuda_devices(result):
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def summary(self) -> Dict[str, float]:
        """Mean, median and 95th percentile seconds of the steps after the
        first (the warm-up step; all of them when there is one), and the
        number of steps recorded."""
        t = np.asarray(self.times[1:] or self.times)
        return {
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "steps": len(self.times),
        }


# -- the program's spans ----------------------------------------------------

PREFIX = "pvnet."
SYNC_WARNING = "called a synchronizing CUDA operation"

CAPACITY = 1 << 16      # closed spans a Recorder keeps until drained
_recording = 0          # depth of open recording() blocks


class Span:
    """One recorded region (see the module docstring)."""

    __slots__ = ("name", "id", "parent", "unit", "start_ns", "end_ns",
                 "counters", "events", "_rf", "_watched")

    def __init__(self, name: str, span_id: int, parent: Optional[int],
                 unit: int):
        self.name, self.id, self.parent, self.unit = (name, span_id, parent,
                                                      unit)
        self.start_ns = self.end_ns = 0
        self.counters: Dict[str, int] = {}
        self.events = None
        self._rf = None
        self._watched = False

    def as_dict(self, device_ms: Optional[float] = None) -> dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "unit": self.unit, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "device_ms": device_ms,
                "counters": dict(self.counters)}


class _SyncWatch:
    """Counts the CUDA device's host synchronizations while at least one
    outermost span is open: PyTorch's sync debug mode set to warn, and
    its warnings counted as ``host_syncs`` on the innermost span of the
    thread that synchronized instead of being shown. It starts only where
    the mode reads 0 (off), and at the end puts the mode back only where
    it still reads the 1 it set: a mode set inside the spans stays."""

    def __init__(self, recorder: "Recorder"):
        self.recorder = recorder
        self.depth = 0
        self.lock = threading.Lock()
        self._catch = None
        self._shown = None

    @staticmethod
    def available() -> bool:
        return (torch.cuda.is_initialized()
                and torch.cuda.get_sync_debug_mode() == 0)

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_WARNING in str(message):
            self.recorder.count("host_syncs")
        else:
            self._shown(message, category, filename, lineno, file, line)

    def enter(self) -> bool:
        """Start watching (or go on); False where it cannot."""
        with self.lock:
            if self.depth == 0:
                if not self.available():
                    return False
                # saves the filters and the hook, which exit() restores
                self._catch = warnings.catch_warnings()
                self._catch.__enter__()
                warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
                # set_sync_debug_mode's own note that the mode is a
                # prototype
                warnings.filterwarnings("ignore",
                                        message="Synchronization debug mode")
                self._shown = warnings.showwarning
                warnings.showwarning = self._show
                torch.cuda.set_sync_debug_mode(1)
            self.depth += 1
            return True

    def exit(self) -> None:
        with self.lock:
            self.depth -= 1
            if self.depth == 0:
                if torch.cuda.get_sync_debug_mode() == 1:
                    torch.cuda.set_sync_debug_mode(0)
                self._catch.__exit__(None, None, None)
                self._catch = None


class Recorder:
    """The process's spans and counter totals, in memory: at most
    :data:`CAPACITY` closed spans are kept until :meth:`drain` (later ones
    are not)."""

    def __init__(self):
        self.totals: Dict[str, int] = {}
        self._spans: List[Span] = []
        self._ids = itertools.count()
        self._units = itertools.count()
        self._local = threading.local()
        self._syncs = _SyncWatch(self)

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str) -> Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        span = Span(name, next(self._ids),
                    None if parent is None else parent.id,
                    next(self._units) if parent is None else parent.unit)
        if parent is None:
            span._watched = self._syncs.enter()
        if torch.cuda.is_initialized():
            span.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        stack.append(span)
        span._rf = torch.profiler.record_function(PREFIX + name)
        span.start_ns = time.time_ns()
        span._rf.__enter__()
        if span.events is not None:
            span.events[0].record()
        return span

    def close(self, span: Span) -> None:
        if span.events is not None:
            span.events[1].record()
        span._rf.__exit__(None, None, None)
        span.end_ns = time.time_ns()
        span._rf = None
        stack = self._stack()
        stack.pop()
        if span._watched:
            self._syncs.exit()
        if len(self._spans) < CAPACITY:
            self._spans.append(span)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open span of this
        thread (if any) and to the process total."""
        self.totals[name] = self.totals.get(name, 0) + n
        stack = self._stack()
        if stack:
            c = stack[-1].counters
            c[name] = c.get(name, 0) + n

    def drain(self) -> List[dict]:
        """The closed spans in the order they opened, as dicts (see
        :meth:`Span.as_dict`; ``device_ms`` from their CUDA events, else
        None), and forget them. Synchronizes once where CUDA events were
        recorded."""
        spans, self._spans = self._spans, []
        spans.sort(key=lambda s: s.id)
        if any(s.events is not None for s in spans):
            torch.cuda.synchronize()
        return [s.as_dict(None if s.events is None
                          else s.events[0].elapsed_time(s.events[1]))
                for s in spans]


RECORDER = Recorder()


class _Annotation:
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.span = RECORDER.open(self.name)
        return self.span

    def __exit__(self, *exc):
        RECORDER.close(self.span)
        return False


class _Null:
    """The null context :func:`annotate` returns off (cheaper to enter and
    leave than ``contextlib.nullcontext``)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL = _Null()


def annotate(name: str):
    """A span of the program named ``name`` (see the module docstring);
    off, the shared null context."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NULL
    if torch.compiler.is_compiling():
        return _NULL
    return _Annotation(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span and to the
    process total, while spans are recorded. ``n`` is a Python number: a
    counter reads no device."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return
    if torch.compiler.is_compiling():
        return
    RECORDER.count(name, n)


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block; yields
    :data:`RECORDER` (``drain()`` returns and forgets its spans)."""
    global _recording
    _recording += 1
    try:
        yield RECORDER
    finally:
        _recording -= 1


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    present), written to ``log_dir``/trace.json as a Chrome trace, and the
    program's spans and counters recorded meanwhile to
    ``log_dir``/spans.json (with the trace's ``baseTimeNanoseconds``;
    this drains :data:`RECORDER`). Yields the profiler
    (``key_averages()`` sums the kernels by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = dict(RECORDER.totals)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        base = json.load(f).get("baseTimeNanoseconds")
    totals = {k: v - before.get(k, 0) for k, v in RECORDER.totals.items()
              if v != before.get(k, 0)}
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"baseTimeNanoseconds": base, "spans": RECORDER.drain(),
                   "totals": totals}, f)
