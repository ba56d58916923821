"""The comparison that decides ``correct`` fails where it must: a run at a
tiny size on the CPU, the harness's look for a card skipped, passes
sound and fails with each fault the cell can have planted underneath the
timed path (pvbench/faults.py), and with the control (the reference in
the precision below the configuration's) in the program's place."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from pvbench import check, faults, spec

sys.path.insert(0, spec.HERE)
import run  # noqa: E402

torch.set_num_threads(2)
BENCH = spec.benchmark()
SMALL = {"crop": [208, 256, 128, 160], "shift_x": 8, "shift_y": 8}


def small(name, **mix):
    cell = spec.cell(name, BENCH)
    cell["per_layer_names"] = spec.per_layer(BENCH, name)
    cell["mix"] = dict(cell["mix"], **SMALL, **mix)
    return cell


def offline_cell(name="r18_f32.offline_b128"):
    cell = small(name, batch=4, pool_batches=2)
    cell["check"] = dict(cell["check"], sample=16)
    return cell


def train_cell(name="r18_bf16.train_b32"):
    """The training cell at a tiny size, its step in float32: the CPU's
    bfloat16 autocast is not the card's, and a batch of 4 tiny frames
    rounds otherwise than 32 large ones, so the card's limits hold the
    card's bfloat16 alone."""
    cell = small(name, batch=4, set_frames=16, sizes_h=[64],
                 sizes_w=[96, 112, 128])
    cell["cfg"] = dict(cell["cfg"], train=dict(cell["cfg"]["train"],
                                               bf16=False))
    return cell


def one_run(cell, fault=None, seed=7):
    with faults.FAULTS[fault]() if fault else _nothing():
        r = run.run_cell(cell, seed, 0.5, False, time.time(), "cpu")
    return run.finish(BENCH, cell, r, False, "cpu")


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def test_sound_offline_run_and_its_line():
    line, lines = one_run(offline_cell())
    assert line["correct"] is True, lines
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"poses_per_s", "setup_s"}
    assert line["failed"] == 0 and line["attempted"] >= 4
    json.dumps(line)


@pytest.mark.parametrize("fault", ["altered", "half_batch", "pnp_quarter",
                                   "voting_quarter"])
def test_offline_fault_is_not_correct(fault):
    line, lines = one_run(offline_cell(), fault)
    assert line["correct"] is False, lines
    if fault.endswith("_quarter"):      # the masks stay right
        assert line["checks"]["fg_gap"]["value"] == 0, lines


def test_offline_control_is_not_correct():
    from pvbench.offline import Offline
    cell = offline_cell()
    job = Offline(cell, "cpu")
    job.load_program()
    job.load_inputs(11)
    res = job.run(0.5, False, time.time())
    idx = job.sample(11, res["attempted"])
    readings = job.readings(res["prog"], idx, control="tf32")
    assert not check.judge(readings, cell["check"]["limits"]), readings


def test_sound_training_run():
    line, lines = one_run(train_cell())
    assert line["correct"] is True, lines
    assert set(line["metrics"]) == {"train_imgs_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_fault_is_not_correct(fault):
    line, lines = one_run(train_cell(), fault)
    assert line["correct"] is False, lines


def test_training_control_is_not_correct():
    from pvbench.training import Training
    cell = train_cell()
    job = Training(cell, "cpu")
    job.load(13)
    res = job.run(0.5, False, time.time())
    job.free_program()
    readings = job.readings(res["prog"], control="fp8")
    assert not check.judge(readings, cell["check"]["limits"]), readings


def _run_py(cwd, workload="r18_f32.offline_b128"):
    return subprocess.run(
        [sys.executable, "pvbench/run.py", "--workload", workload, "--seed",
         "2147483999", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


@pytest.mark.parametrize("workload", ["r18_f32.offline_b128",
                                      "r18_bf16.train_b32"])
def test_no_card_no_result(workload):
    p = _run_py(spec.ROOT, workload)
    assert p.returncode == 2 and "{" not in p.stdout


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "pvbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and "{" not in p.stdout
