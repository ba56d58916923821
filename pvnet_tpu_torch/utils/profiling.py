"""Profiling and step timing (port of pvnet_tpu/utils/profiling.py, the
same names).

:class:`StepTimer` times steps on the host clock and, with ``sync``,
waits for the CUDA device that holds a step's result before reading it
(PyTorch returns before the card finishes); :func:`trace` records a
``torch.profiler`` trace, with CUDA activity where a card is present,
and writes it into ``log_dir`` as a Chrome trace (chrome://tracing,
Perfetto); :func:`annotate` names a region in such a trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


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


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where a card is
    present), written to ``log_dir``/trace.json as a Chrome trace. Yields
    the profiler (``key_averages()`` sums the kernels by name)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield
