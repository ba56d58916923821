"""The port's profiling helpers (pvnet_tpu_torch/utils/profiling.py)
against pvnet_tpu/utils/profiling.py: StepTimer's summary of the same
recorded times, the trace file torch.profiler writes, nested annotations,
and which devices stop() waits for."""
import json
import os

import numpy as np
import pytest
import torch

from pvnet_tpu.utils.profiling import StepTimer as JStepTimer
from pvnet_tpu_torch.utils import profiling as TP


@pytest.mark.parametrize("times", [[0.5], [0.9, 0.1, 0.2, 0.4],
                                   [3.0, 0.25, 0.25, 0.5, 1.0, 0.75]])
def test_summary_matches_jax(times):
    """The same keys and values: the first (compile / warm-up) step
    dropped unless it is the only one."""
    got, want = TP.StepTimer(), JStepTimer()
    got.times, want.times = list(times), list(times)
    assert got.summary() == want.summary()


def test_start_stop_records_a_step_per_call(monkeypatch):
    """A CPU result waits for no device; each stop() adds its seconds."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    t = TP.StepTimer()
    for _ in range(3):
        t.start()
        dt = t.stop({"y": torch.ones(4) * 2, "n": [torch.zeros(1)]})
        assert dt >= 0
    assert len(t.times) == 3 and t.summary()["steps"] == 3
    assert synced == []


def test_stop_waits_for_the_results_cuda_devices(monkeypatch):
    """stop(result) synchronizes each CUDA device its tensors lie on, once,
    and no other (the devices read off the result's tensors)."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    monkeypatch.setattr(TP, "_cuda_devices",
                        lambda tree: {torch.device("cuda", 1)})
    t = TP.StepTimer()
    t.start()
    t.stop(torch.zeros(1))
    assert synced == [torch.device("cuda", 1)]
    t.sync = False
    t.start()
    t.stop(torch.zeros(1))
    assert synced == [torch.device("cuda", 1)]


def test_cuda_devices_of_a_cpu_result():
    assert TP._cuda_devices((torch.zeros(2), {"a": [torch.ones(1)]},
                             3, None)) == set()


def test_trace_writes_a_chrome_trace_with_nested_annotations(tmp_path):
    """trace() writes trace.json under log_dir; annotate() regions nest:
    the inner span lies within the outer one."""
    log_dir = str(tmp_path / "tb")
    with TP.trace(log_dir) as prof:
        with TP.annotate("outer"):
            x = torch.randn(64, 64)
            with TP.annotate("inner"):
                y = x @ x
            y.sum()
    path = os.path.join(log_dir, "trace.json")
    assert os.path.exists(path)
    with open(path) as f:
        events = {e["name"]: e for e in json.load(f)["traceEvents"]
                  if e.get("name") in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    o, i = events["outer"], events["inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert any(e.key == "inner" for e in prof.key_averages())
    assert np.isfinite(float(y.sum()))
