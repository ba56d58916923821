"""The train and infer CLIs under ``python -m torch.distributed.run``
(torchrun) on gloo CPU ranks, against the same CLIs in one process: the
rank-0 checkpoint of a 2-rank ``--device_data`` or ``--device_aug`` run
equals a 1-process run's on the same global batch and loads through
infer.load_model (no ``module.`` prefix); the host-augmentation route
runs on 2 ranks (its draws come from ``RandomState(seed + rank)``, so it
trains on other draws than one process); 2-rank inference writes the
poses one process writes, an uneven last batch among them. Every process
has a time limit and a process-group timeout (PVNET_PG_TIMEOUT)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _parallel_worker import free_port
from pvnet_tpu_torch.data.synthetic import write_synthetic_linemod
from pvnet_tpu_torch.infer import load_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
FIXTURE = os.path.join(REPO, "assets", "duck_views_480x640.npz")
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")
STEPS = 2


def _run(args, ranks, timeout=120):
    """``python -m <args>`` in one process (ranks=0, no process group) or
    under torchrun with ``ranks`` CPU ranks; returns its stdout."""
    env = dict(os.environ, PVNET_PG_TIMEOUT="60", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    cmd = [sys.executable, "-m"]
    if ranks:
        cmd += ["torch.distributed.run", "--nproc_per_node", str(ranks),
                "--master_addr", "127.0.0.1", "--master_port",
                str(free_port()), "-m"]
    proc = subprocess.run(cmd + args, cwd=REPO, env=env, timeout=timeout,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic LINEMOD tree of 12 frames at 48x64 where ``--synthetic``
    finds it (one batch of 4 an epoch), and an f32 b=4 copy of
    configs/synthetic_train.json for 2 epochs."""
    tmp = tmp_path_factory.mktemp("cli")
    write_synthetic_linemod(str(tmp / "data" / "synthetic"), "duck",
                            num_images=12, image_hw=(48, 64))
    with open(RECIPE) as f:
        recipe = json.load(f)
    recipe.update(bf16=False, train_batch_size=4, test_batch_size=2,
                  epoch_num=STEPS, resume=False, loss_rec_step=1)
    cfg = tmp / "recipe.json"
    cfg.write_text(json.dumps(recipe))
    return tmp, str(cfg)


_RUNS = {}


def _train(tree, ranks, name, *route):
    """The summary and last checkpoint of a training run, made once a
    module (name, ranks and route) and kept."""
    key = (name, ranks, route)
    if key not in _RUNS:
        _RUNS[key] = _train_once(tree, ranks, name, *route)
    return _RUNS[key]


def _train_once(tree, ranks, name, *route):
    tmp, cfg = tree
    out = _run(["pvnet_tpu_torch.train", "--synthetic", "--cfg_file", cfg,
                "--device", "cpu", "--steps", str(STEPS), "--buckets",
                "32x32", "--init", CKPT, "--num_threads", "1",
                "--data_dir", str(tmp / "data"), "--model_dir",
                str(tmp / name), *route], ranks)
    summary = json.loads(out.strip().splitlines()[-1])
    path = str(tmp / name / f"{STEPS - 1}.pth")
    assert sorted(os.listdir(tmp / name)) == [
        f"{e}.pth" for e in range(STEPS)] + ["log.jsonl"]
    return summary, path


@pytest.fixture(scope="module")
def device_data(tree):
    """--device_data on 1 process and on 2 ranks."""
    return (_train(tree, 0, "one", "--device_data"),
            _train(tree, 2, "two", "--device_data"))


def _same_run(one, p1, two, p2):
    """A 2-rank run's summary (rank 0's alone) and checkpoint against one
    process on the same global batch of 4: the same losses within 1e-4
    (global-batch means), the running statistics within 1e-4 of each
    tensor's largest value, and the weights as Adam's steps leave them
    (see test_torch_parallel.py::test_sharded_step_parameters_match_jax:
    where a gradient is ~0 a weight may move either way, 2 lr a step)."""
    assert (one["world_size"], two["world_size"]) == (1, 2)
    l1 = [x for e in one["epochs"] for x in e["losses"]]
    l2 = [x for e in two["epochs"] for x in e["losses"]]
    assert len(l1) == len(l2) == STEPS
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    sd1 = torch.load(p1, weights_only=True)["net"]
    sd2 = torch.load(p2, weights_only=True)["net"]
    assert list(sd1) == list(sd2)
    assert not any(k.startswith("module.") for k in sd2)
    diff = []
    for k, w in sd1.items():
        if "running" in k:
            torch.testing.assert_close(sd2[k], w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()))
        elif w.is_floating_point():
            diff.append((sd2[k] - w).abs().flatten())
    diff = torch.cat(diff)
    assert float(diff.max()) <= 2 * STEPS * 1e-3 + 1e-6
    assert float((diff < 1e-5).float().mean()) >= 0.99


def test_two_ranks_write_one_checkpoint_as_one_process(device_data):
    """--device_data: :func:`_same_run`."""
    (one, p1), (two, p2) = device_data
    _same_run(one, p1, two, p2)


def test_device_aug_on_two_ranks_trains_as_one_process(tree):
    """--device_aug: each rank's loader builds its rows of every global
    batch, and each rank draws the global batch's augmentation from the
    step's key and keeps its rows, so 2 ranks train as one process
    (:func:`_same_run`)."""
    _same_run(*_train(tree, 0, "one_aug", "--device_aug"),
              *_train(tree, 2, "two_aug", "--device_aug"))


def test_the_checkpoint_loads_through_infer(device_data):
    (_, p1), (_, p2) = device_data
    m1, m2 = load_model(p1, 9, "cpu"), load_model(p2, 9, "cpu")
    x = torch.zeros(1, 3, 32, 32)
    with torch.no_grad():
        assert all(torch.isfinite(t).all() for t in m2(x))
    assert set(m1.state_dict()) == set(m2.state_dict())


@pytest.mark.parametrize("route", [["--device_aug"], []],
                         ids=["device_aug", "host_aug"])
def test_streamed_routes_run_on_two_ranks(tree, route):
    """The streamed routes: each rank's loader builds its rows of every
    global batch; finite global losses, one loadable rank-0 checkpoint."""
    summary, path = _train(tree, 2, "two_aug" if route else "two_host",
                           *route)
    assert summary["route"] == ("device aug" if route else "host aug")
    losses = [x for e in summary["epochs"] for x in e["losses"]]
    assert len(losses) == STEPS and np.isfinite(losses).all()
    load_model(path, 9, "cpu")


def test_infer_on_two_ranks_writes_what_one_process_writes(tmp_path):
    """5 views (the fixture's two, each brightened, and the first
    darkened) at 120x160 with the crop's K, batches of 4: each rank poses
    its 2 of the first batch with its rows of the draws, and of the last
    batch of 1, padded to 2, rank 0 poses the image and rank 1 a black
    one; rank 0 writes the file one process writes, byte for byte (on the
    CPU each image's convolutions do not depend on the batch)."""
    y0, x0 = 216, 232
    with np.load(FIXTURE) as z:
        views = z["images"][:, y0:y0 + 120, x0:x0 + 160]
        K = z["K"].copy()
    K[0, 2] -= x0
    K[1, 2] -= y0
    imgs = np.concatenate([views, np.clip(views * 1.2, 0, 255),
                           views[:1] * 0.8]).astype(np.uint8)
    np.save(tmp_path / "imgs.npy", imgs)
    np.savetxt(tmp_path / "K.txt", K)
    for ranks, name in ((0, "one.jsonl"), (2, "two.jsonl")):
        _run(["pvnet_tpu_torch.infer", "--checkpoint", CKPT, "--points_3d",
              FIXTURE, "--images", str(tmp_path / "imgs.npy"), "--K",
              str(tmp_path / "K.txt"), "--device", "cpu", "--batch", "4",
              "--output", str(tmp_path / name)], ranks)
    one = (tmp_path / "one.jsonl").read_text()
    assert len(one.splitlines()) == 5
    assert (tmp_path / "two.jsonl").read_text() == one
