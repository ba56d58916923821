"""On a CUDA card: the program passes the comparison and the control (the
plain reference in the precision below the configuration's, in the
program's place) fails it, at sizes a test run holds: full 480x640 frames
in batches of 16 for the pose cells, the training cell's batch of 32 on a
set of 512 frames at three of its sizes. pvbench/control.py reads the
same at each cell's own size over many seeds.

  python -m pytest -q pvbench/tests/test_pvbench_card.py
"""
import time

import pytest
import torch

from pvbench import check, spec

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name,control", [
    ("r18_f32.offline_b128", "tf32"), ("r18_bf16.offline_b128", "fp8")])
def test_pose_cell_program_passes_control_fails(cuda, name, control):
    from pvbench.offline import Offline
    cell = spec.cell(name)
    cell["mix"] = dict(cell["mix"], batch=16)
    job = Offline(cell, cuda)
    job.load_program()
    job.load_inputs(4242)
    res = job.run(1.0, False, time.time())
    idx = job.sample(4242, res["attempted"])
    limits = cell["check"]["limits"]
    assert check.judge(job.readings(res["prog"], idx), limits)
    assert not check.judge(job.readings(res["prog"], idx, control), limits)


def test_training_cell_program_passes_control_fails(cuda):
    from pvbench.training import Training
    cell = spec.cell("r18_bf16.train_b32")
    cell["mix"] = dict(cell["mix"], set_frames=512, sizes_h=[256],
                       sizes_w=[256, 384, 512])
    job = Training(cell, cuda)
    job.load(4243)
    res = job.run(1.0, False, time.time())
    job.free_program()
    limits = cell["check"]["limits"]
    assert check.judge(job.readings(res["prog"]), limits)
    assert not check.judge(job.readings(res["prog"], "fp8"), limits)
