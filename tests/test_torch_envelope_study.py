"""The port's envelope study (pvnet_tpu_torch/envelope_study.py) against
tools/envelope_study.py on a copy of assets/linemod_mini whose test list
holds two of its 480x640 duck frames: both CLIs with the duck checkpoint,
f32, two envelopes, the port's validate fed JAX's RANSAC draws (the key
chain of JAX's TrainLoop.validate, as tests/test_torch_eval.py's
test_validate_matches_jax), and the port's CLI in a process without JAX
for its keys."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from _linemod_tree import own_jax_caches
from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch import envelope_study as TES
from pvnet_tpu_torch.train.loop import TrainLoop
from test_torch_eval import _jax_draws
from tools import envelope_study as JES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
MINI = os.path.join(REPO, "assets", "linemod_mini")
ENVELOPES = "32,128"
# two frames of the test list that the checkpoint poses
TEST_FRAMES = ("000015.jpg", "000017.jpg")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree (its databases write posedb/ into it) and an f32 recipe
    evaluating both frames in one batch."""
    base = tmp_path_factory.mktemp("env")
    root = str(base / "data")
    shutil.copytree(MINI, root)
    with open(os.path.join(root, "LINEMOD", "duck", "test.txt"), "w") as f:
        f.write("".join(name + "\n" for name in TEST_FRAMES))
    r = json.load(open(RECIPE))
    r.update(bf16=False, test_batch_size=len(TEST_FRAMES))
    recipe = str(base / "recipe.json")
    with open(recipe, "w") as f:
        json.dump(r, f)
    return root, recipe


def _rows(out: str):
    """The JSON rows printed before the summary heading, and after it."""
    head, _, tail = out.partition("envelope sweep:")
    parse = [json.loads(line) for line in head.splitlines()
             if line.startswith("{")]
    return parse, [json.loads(line) for line in tail.splitlines()
                   if line.startswith("{")]


def test_rows_match_jax(tree, monkeypatch, capsys):
    """Each envelope's rates equal JAX's, key for key; the summary
    repeats the rows."""
    root, recipe = tree
    argv = ["--cfg_file", recipe, "--data_dir", root, "--cls", "duck",
            "--envelopes", ENVELOPES, "--weights", CKPT, "--num_threads",
            "1"]
    # JAX's 'auto' selection is top-k off the TPU; the port's stratified
    orig = JV.sample_foreground
    monkeypatch.setattr(JV, "sample_foreground", lambda *a, **k: orig(
        *a, **dict(k, method="stratified")))
    monkeypatch.setattr(sys, "argv", ["envelope_study.py"] + argv)
    with own_jax_caches():
        assert JES.main() == 0
    want, want_summary = _rows(capsys.readouterr().out)

    # JAX's validate draws each batch from fold_in(key, bidx), the key
    # carried from batch to batch, from PRNGKey(0) at every envelope
    keys, key = [], jax.random.PRNGKey(0)
    for bidx in range(len(TEST_FRAMES)):
        key = jax.random.fold_in(key, bidx)
        keys.append(key)
    validate = TrainLoop.validate

    def with_jax_draws(self, *a, **k):
        return validate(self, *a, draws=_jax_draws(
            keys, k["uncertainty"], k["tail_depth"], k["vote_params"]), **k)
    monkeypatch.setattr(TrainLoop, "validate", with_jax_draws)
    assert TES.main(argv + ["--device", "cpu"]) == 0
    got, got_summary = _rows(capsys.readouterr().out)
    assert [r["hyp_num"] for r in want] == [32, 128]
    assert got == want and got_summary == got and want_summary == want
    assert any(r["proj"] > 0 for r in got), got    # poses the model gets


def test_cli_without_jax_prints_the_sweep(tree):
    """``python -m pvnet_tpu_torch.envelope_study`` with JAX, flax,
    msgpack, PIL, cv2 and pvnet_tpu blocked: the covariance sweep with
    bf16 counts, its rows in JAX's keys."""
    root, recipe = tree
    blocked = ("jax", "flax", "msgpack", "PIL", "cv2", "pvnet_tpu")
    code = ("import sys, runpy\n"
            f"for m in {blocked!r}: sys.modules[m] = None\n"
            "sys.argv = ['envelope_study'] + sys.argv[1:]\n"
            "runpy.run_module('pvnet_tpu_torch.envelope_study', "
            "run_name='__main__')\n")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--cfg_file", recipe, "--data_dir", root,
         "--envelopes", "32", "--unc_hyp_nums", "32,64", "--vote_impl",
         "bf16", "--weights", CKPT, "--num_threads", "1", "--device", "cpu"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rows, summary = _rows(proc.stdout)
    assert rows == summary and len(rows) == 2
    for r, u in zip(rows, (32, 64)):
        assert set(r) == {"hyp_num", "max_num", "uncertainty_hyp_num",
                          "vote_impl", "uncertainty", "proj", "add",
                          "cm5deg5"}
        assert (r["hyp_num"], r["max_num"], r["uncertainty_hyp_num"],
                r["vote_impl"], r["uncertainty"]) == (32, 32, u, "bf16",
                                                      True)


def test_no_checkpoint_is_refused(tree, tmp_path, capsys):
    """Without --weights and with no training checkpoint the study stops
    with exit code 1, as JAX's."""
    _, recipe = tree
    assert TES.main(["--cfg_file", recipe, "--data_dir", str(tmp_path),
                     "--device", "cpu"]) == 1
    assert "no checkpoint" in capsys.readouterr().err
