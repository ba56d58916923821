"""The port's profiling helpers (pvnet_tpu_torch/utils/profiling.py)
against pvnet_tpu/utils/profiling.py: StepTimer's summary of the same
recorded times, the trace file torch.profiler writes, nested annotations,
and which devices stop() waits for; and the program's spans and counters:
off by default, their nesting, units and counters, their clock against
the profiler's, spans.json, none traced by torch.export, the spans of
estimate_poses and of the training step, and results bit for bit the same
with recording on and off."""
import contextlib
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
    """trace() writes trace.json under log_dir; annotate() regions, named
    with the ``pvnet.`` prefix, nest: the inner span lies within the outer
    one."""
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
                  if e.get("name") in ("pvnet.outer", "pvnet.inner")}
    assert set(events) == {"pvnet.outer", "pvnet.inner"}
    o, i = events["pvnet.outer"], events["pvnet.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert any(e.key == "pvnet.inner" for e in prof.key_averages())
    assert np.isfinite(float(y.sum()))


# -- the program's spans and counters ---------------------------------------

RECIPE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "synthetic_train.json")


@pytest.fixture
def recorder():
    """The process's recorder, empty before and after the test."""
    TP.RECORDER.drain()
    yield TP.RECORDER
    TP.RECORDER.drain()


def test_annotate_off_is_the_shared_null_context(recorder):
    """Off (no recording(), no profiler): the one null context, and
    nothing recorded, counted or added to the totals."""
    totals = dict(recorder.totals)
    assert TP.annotate("a") is TP.annotate("b") is TP._NULL
    with TP.annotate("a"):
        TP.count("n", 3)
    assert recorder.drain() == [] and recorder.totals == totals


def test_spans_nest_with_parents_units_and_counters(recorder):
    """Each outermost span opens a unit its inner spans share; a counter
    lands on the innermost open span and on the process total."""
    before = recorder.totals.get("n", 0)
    with TP.recording() as rec:
        assert rec is recorder
        with TP.annotate("a"):
            with TP.annotate("b"):
                with TP.annotate("c"):
                    TP.count("n", 2)
                TP.count("n")
            with TP.annotate("d"):
                pass
        with TP.annotate("e"):
            TP.count("m", 5)
    assert TP.annotate("a") is TP._NULL
    spans = recorder.drain()
    by = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["a", "b", "c", "d", "e"]
    assert by["a"]["parent"] is None and by["e"]["parent"] is None
    assert by["b"]["parent"] == by["d"]["parent"] == by["a"]["id"]
    assert by["c"]["parent"] == by["b"]["id"]
    assert {by[k]["unit"] for k in "abcd"} == {by["a"]["unit"]}
    assert by["e"]["unit"] != by["a"]["unit"]
    assert by["c"]["counters"] == {"n": 2} and by["b"]["counters"] == {"n": 1}
    assert by["a"]["counters"] == {} and by["e"]["counters"] == {"m": 5}
    assert recorder.totals["n"] == before + 3
    for s in spans:
        assert s["device_ms"] is None            # no CUDA here
        assert 0 < s["start_ns"] <= s["end_ns"]
    assert by["a"]["start_ns"] <= by["b"]["start_ns"] \
        and by["c"]["end_ns"] <= by["b"]["end_ns"] <= by["a"]["end_ns"]
    assert recorder.drain() == []


def test_recorder_keeps_at_most_its_capacity(monkeypatch):
    monkeypatch.setattr(TP, "CAPACITY", 2)
    rec = TP.Recorder()
    for name in "abc":
        rec.close(rec.open(name))
    assert [s["name"] for s in rec.drain()] == ["a", "b"]


def test_host_syncs_count_on_the_innermost_span(recorder, monkeypatch):
    """The sync debug mode's warnings become ``host_syncs`` of the
    innermost span, are not shown, and the mode is set only while an
    outermost span is open; other warnings still show."""
    modes = []
    monkeypatch.setattr(TP._SyncWatch, "available", staticmethod(
        lambda: True))
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1] if modes else 0)
    import warnings
    with TP.recording():
        with TP.annotate("outer"):
            warnings.warn(TP.SYNC_WARNING)
            with TP.annotate("inner"):
                for _ in range(3):
                    warnings.warn(TP.SYNC_WARNING)
                with pytest.warns(UserWarning, match="other"):
                    warnings.warn("some other warning")
        assert modes == [1, 0]
    by = {s["name"]: s for s in recorder.drain()}
    assert by["outer"]["counters"] == {"host_syncs": 1}
    assert by["inner"]["counters"] == {"host_syncs": 3}


def test_sync_watch_keeps_a_mode_set_inside_the_spans(recorder,
                                                      monkeypatch):
    """The watch starts only where the sync debug mode reads 0, puts it
    back to 0 only where it still reads the 1 it set, and leaves a mode
    that the code inside the spans set; the warnings' hook is restored."""
    import warnings
    mode = [0]
    class Event:                        # CUDA seen as in use, with no card
        def __init__(self, **kw):
            pass

        def record(self):
            pass

        def elapsed_time(self, end):
            return 0.0

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, m))
    hook = warnings.showwarning
    with TP.recording():
        with TP.annotate("outer"):
            assert mode[0] == 1 and warnings.showwarning is not hook
            mode[0] = 2                 # the caller's own mode, inside
        assert mode[0] == 2 and warnings.showwarning is hook
        with TP.annotate("outer"):      # a mode already set: not watched
            assert mode[0] == 2 and warnings.showwarning is hook
        mode[0] = 0
        with TP.annotate("outer"):
            assert mode[0] == 1
        assert mode[0] == 0 and warnings.showwarning is hook
    assert [s["name"] for s in recorder.drain()] == ["outer"] * 3


def test_spans_share_the_profilers_clock(recorder, tmp_path):
    """Under a CPU torch.profiler the spans record without recording():
    each span's start lies within 1 ms of its ``pvnet.`` event's
    baseTimeNanoseconds + ts * 1000 in the exported trace, and trace()
    writes the spans and counters to spans.json."""
    log_dir = str(tmp_path / "tb")
    with TP.trace(log_dir):
        for _ in range(3):
            with TP.annotate("outer"):
                x = torch.randn(32, 32)
                with TP.annotate("inner"):
                    (x @ x).sum()
                    TP.count("k", 4)
    with open(os.path.join(log_dir, "trace.json")) as f:
        trace = json.load(f)
    with open(os.path.join(log_dir, "spans.json")) as f:
        spans = json.load(f)
    base = trace["baseTimeNanoseconds"]
    assert spans["baseTimeNanoseconds"] == base
    assert spans["totals"] == {"k": 12}
    assert [s["name"] for s in spans["spans"]] == ["outer", "inner"] * 3
    events = sorted((e for e in trace["traceEvents"]
                     if str(e.get("name", "")).startswith(TP.PREFIX)),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in events] == ["pvnet.outer", "pvnet.inner"] * 3
    for s, e in zip(spans["spans"], events):
        assert abs(base + e["ts"] * 1000 - s["start_ns"]) < 1e6
    assert recorder.drain() == []


def test_export_traces_no_span(recorder):
    """torch.export traces none of a span's nodes, recording or not."""
    class M(torch.nn.Module):
        def forward(self, x):
            with TP.annotate("m"):
                TP.count("calls")
                return x * 2

    with TP.recording():
        prog = torch.export.export(M(), (torch.ones(3),), strict=False)
    assert recorder.drain() == []
    assert "record_function" not in str(prog.graph)
    assert [n.op for n in prog.graph.nodes] == ["placeholder",
                                                "call_function", "output"]


def _small_pose_inputs():
    from pvnet_tpu_torch.models.pvnet import build_model
    torch.manual_seed(0)
    model = build_model("resnet18_8s", ver_dim=18, seg_dim=2).eval()
    g = torch.Generator().manual_seed(3)
    images = torch.randn(2, 48, 64, 3, generator=g)
    pts = torch.randn(9, 3, generator=g) * 0.05
    K = torch.tensor([[80.0, 0.0, 32.0], [0.0, 80.0, 24.0],
                      [0.0, 0.0, 1.0]])
    noise = torch.rand(2, 48, 64, generator=g)
    pair_u = torch.rand(2, 32, 2, generator=g)
    return model, images, pts, K, noise, pair_u


def _subtree(spans, root):
    ids, out = {root["id"]}, [root]
    for s in spans:
        if s["parent"] in ids:
            ids.add(s["id"])
            out.append(s)
    return out


def test_estimate_poses_records_its_pieces(recorder):
    """A CPU estimate_poses records estimate > fcn, voting, pnp >
    pnp.epnp, pnp.lm in one unit, and gives the same poses, keypoints and
    counts bit for bit as with recording off."""
    from pvnet_tpu_torch import pipeline as PL
    model, images, pts, K, noise, pair_u = _small_pose_inputs()
    params = PL.VoteParams(hyp_num=32, max_num=64)
    off = PL.estimate_poses(model, images, pts, K, params, noise=noise,
                            pair_u=pair_u)
    with TP.recording():
        on = PL.estimate_poses(model, images, pts, K, params, noise=noise,
                               pair_u=pair_u)
    spans = recorder.drain()
    by = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["estimate", "fcn", "voting", "pnp",
                                          "pnp.epnp", "pnp.lm"]
    est = by["estimate"]
    assert est["parent"] is None
    assert {s["unit"] for s in spans} == {est["unit"]}
    for k in ("fcn", "voting", "pnp"):
        assert by[k]["parent"] == est["id"]
    assert by["pnp.epnp"]["parent"] == by["pnp.lm"]["parent"] == \
        by["pnp"]["id"]
    assert all(s["counters"] == {} for s in spans)      # no CUDA here
    assert len(_subtree(spans, by["pnp"])) == 3
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_train_step_records_its_phases(recorder):
    """train_step_from_data records train.step > augment, train.forward,
    train.optimizer (zero_grad), train.backward, train.optimizer (the
    update); train_step on an augmented batch the same but augment; the
    losses and the parameters after the steps are bit for bit those of
    steps with recording off."""
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.data.augment_device import sample_draws
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.train import trainer as TT
    cfg = TrainConfig.from_json(RECIPE)
    g = torch.Generator().manual_seed(1)
    data = {"image": torch.randint(0, 256, (3, 56, 72, 3), generator=g,
                                   dtype=torch.uint8),
            "mask": (torch.rand(3, 56, 72, generator=g) > 0.5).to(
                torch.uint8),
            "hcoords": torch.cat([torch.rand(3, 9, 2, generator=g) * 50,
                                  torch.ones(3, 9, 1)], -1)}
    draws = sample_draws(2, cfg.aug_cfg, torch.Generator().manual_seed(2),
                         "cpu")
    idx = torch.tensor([2, 0])

    def run(record: bool):
        torch.manual_seed(0)
        state = TT.create_train_state(
            build_model("resnet18_8s", ver_dim=18, seg_dim=2), cfg)
        with TP.recording() if record else contextlib.nullcontext():
            m1 = TT.train_step_from_data(state, data, idx, draws=draws,
                                         aug_cfg=cfg.aug_cfg,
                                         aug_hw=(48, 64))
            batch = TT.apply_device_aug({k: v[idx] for k, v in
                                         data.items()}, cfg.aug_cfg,
                                        (48, 64), draws)
            m2 = TT.train_step(state, batch)
        return [m1["loss"], m2["loss"]], state.model.state_dict()

    loss_off, sd_off = run(False)
    assert recorder.drain() == []
    loss_on, sd_on = run(True)
    spans = recorder.drain()
    names = [s["name"] for s in spans]
    phases = ["train.forward", "train.optimizer", "train.backward",
              "train.optimizer"]
    assert names == ["train.step", "augment"] + phases + ["augment",
                                                          "train.step"] \
        + phases
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["train.step", "augment",
                                          "train.step"]
    assert len({s["unit"] for s in roots}) == 3
    for root in (roots[0], roots[2]):
        assert all(s["unit"] == root["unit"] for s in _subtree(spans, root))
        assert all(s["parent"] == root["id"]
                   for s in _subtree(spans, root)[1:])
    assert torch.equal(torch.stack(loss_off), torch.stack(loss_on))
    assert sd_off.keys() == sd_on.keys()
    for k in sd_off:
        assert torch.equal(sd_off[k], sd_on[k]), k
