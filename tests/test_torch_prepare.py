"""Dataset preparation with the port against the JAX package:
crop_instance and the truncated-set generator (pvnet_tpu_torch/data/
linemod.py), data/render.py (the Euler helpers, DataStatistics,
PythonRenderer, BlenderRenderer, generate_occlusion_masks), ``python -m
pvnet_tpu_torch.prepare`` against tools/prepare.py for each ``--type`` on
copies of one tree, and the render set read back (LineModImageDB,
PoseDataset) and trained on by the train CLI. Files compare exactly: JPEG
bytes, PNG pixels, pickled arrays, text."""
import json
import os
import pickle
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from _linemod_tree import make_tree, own_jax_caches
from pvnet_tpu.config import BLENDER_K as J_BLENDER_K
from pvnet_tpu.config import LINEMOD_K as J_LINEMOD_K
from pvnet_tpu.config import PathConfig as JPathConfig
from pvnet_tpu.data import dataset as JD
from pvnet_tpu.data import linemod as JL
from pvnet_tpu.data import render as JR
from pvnet_tpu.data.synthetic import sample_object_pose
from pvnet_tpu_torch import prepare
from pvnet_tpu_torch.config import PathConfig
from pvnet_tpu_torch.data import dataset as TD
from pvnet_tpu_torch.data import linemod as TL
from pvnet_tpu_torch.data import render as TR
from pvnet_tpu_torch.train import __main__ as CLI
from tools import prepare as jax_prepare

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI = os.path.join(REPO, "assets", "linemod_mini")


@pytest.fixture(autouse=True)
def _fresh_jax_caches():
    with own_jax_caches():
        yield


def _blob_image(seed, h=120, w=160):
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    cy, cx = rng.randint(10, h - 10), rng.randint(10, w - 10)
    ry, rx = rng.randint(3, 60), rng.randint(3, 90)
    y, x = np.mgrid[:h, :w]
    msk = (((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 <= 1).astype(np.int32)
    return rgb, msk


@pytest.mark.parametrize("seed", range(16))
def test_crop_instance_matches_jax(seed):
    rgb, msk = _blob_image(seed)
    size = 64 if seed % 2 else 48
    for _ in range(3):                      # the retry loop's later draws
        rng, jrng = (np.random.RandomState(seed) for _ in range(2))
        got = TL.crop_instance(rgb, msk, size, rng)
        want = JL.crop_instance(rgb, msk, size, jrng)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (size, size, 3)
        np.testing.assert_array_equal(rng.get_state()[1],
                                      jrng.get_state()[1])
        assert rng.get_state()[2] == jrng.get_state()[2]


def test_crop_instance_of_an_empty_mask_raises_as_jax():
    rgb, msk = _blob_image(0)
    for fn in (TL.crop_instance, JL.crop_instance):
        with pytest.raises(ValueError):
            fn(rgb, np.zeros_like(msk), 64, np.random.RandomState(0))


def _rotations(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        out.append(np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]))
    out.append(np.eye(3))                   # sy = 0: the degenerate branch
    out.append(np.diag([1.0, -1.0, -1.0]))
    return out


def test_euler_helpers_and_sphere_match_jax():
    for R in _rotations(20, 1):
        assert TR.mat2euler_szxz(R) == JR.mat2euler_szxz(R)
        pose = np.concatenate([R, [[0.1], [0.0], [0.5]]], 1)
        np.testing.assert_array_equal(TR.blender_pose_to_blender_euler(pose),
                                      JR.blender_pose_to_blender_euler(pose))
    for n, ele in ((10, 0.0), (37, -30.0), (5, 45.0)):
        for a, b in zip(TR.sample_sphere(n, ele), JR.sample_sphere(n, ele)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flat", [False, True])
def test_data_statistics_match_jax(flat):
    poses = []
    rng = np.random.RandomState(2)
    for R in _rotations(12, 3):
        t = rng.uniform(-0.1, 0.1, 3) + [0, 0, 0.6]
        if flat:
            t[2] = 0.6                      # a fixed-height rig: jittered
        poses.append(np.concatenate([R, t[:, None]], 1))
    got, want = TR.DataStatistics(poses), JR.DataStatistics(poses)
    np.testing.assert_array_equal(got.eulers, want.eulers)
    np.testing.assert_array_equal(got.translations, want.translations)
    np.testing.assert_array_equal(got.sample_poses(25, seed=4),
                                  want.sample_poses(25, seed=4))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX-written 120x160 tree (tests/_linemod_tree.py)."""
    base = tmp_path_factory.mktemp("prep")
    with own_jax_caches():
        make_tree(str(base / "src"))
    return str(base / "src")


def _copies(src, tmp_path):
    out = []
    for name in ("jax", "port"):
        shutil.copytree(src, str(tmp_path / name))
        out.append(str(tmp_path / name))
    return out


def _small_K():
    K = J_BLENDER_K.copy()
    K[:2] /= 10                             # the object inside 48x64
    return K


def test_python_renderer_matches_jax(tree, tmp_path):
    jroot, root = _copies(tree, tmp_path)
    rng = np.random.RandomState(0)
    poses = [sample_object_pose(rng) for _ in range(3)]
    jout = JR.PythonRenderer("duck", JPathConfig(data_dir=jroot),
                             K=_small_K(), hw=(48, 64)).run(poses)
    out = TR.PythonRenderer("duck", PathConfig(data_dir=root), K=_small_K(),
                            hw=(48, 64)).run(poses)
    got = chip_smoke.tree_digests(out, "", JL.read_mask_np)
    want = chip_smoke.tree_digests(jout, "", JL.read_mask_np)
    assert len(want) == 9 and got == want
    depth = JL.read_mask_np(os.path.join(out, "0_depth.png"))
    assert depth.max() > 300 and (depth == 0).any()     # mm; background 0
    with open(os.path.join(out, "1_RT.pkl"), "rb") as f:
        rt = pickle.load(f)
    np.testing.assert_array_equal(rt["RT"], poses[1])


def test_occlusion_masks_match_jax(tree, tmp_path):
    jroot, root = _copies(tree, tmp_path)
    for r in (jroot, root):
        chip_smoke.occlusion_scene(r)
    K = J_LINEMOD_K.copy()
    K[:2] /= 10
    classes = list(chip_smoke.OCC_NUMBERS)
    recs = {c: JL.OcclusionLineModImageDB(
        c, paths=JPathConfig(data_dir=jroot)).real_set for c in classes}
    n = 0
    for (i, got), (j, want) in zip(
            TR.generate_occlusion_masks(classes, recs, PathConfig(
                data_dir=root), hw=(48, 64), K=K),
            JR.generate_occlusion_masks(classes, recs, JPathConfig(
                data_dir=jroot), hw=(48, 64), K=K)):
        assert i == j and list(got) == list(want)
        for c in classes:
            np.testing.assert_array_equal(got[c], want[c])
        n += 1
    assert n == 2
    assert sum(int(m.sum()) for m in got.values()) > 0


def test_blender_renderer_raises_without_the_binary(tmp_path):
    r = TR.BlenderRenderer(str(tmp_path / "blender"), "render.py")
    assert not r.available()
    with pytest.raises(RuntimeError, match="Blender binary not found"):
        r.run("obj.ply", str(tmp_path), 1)


def _run_both(jroot, root, monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["prepare.py", *argv,
                                      "--data_dir", jroot])
    jax_prepare.main()
    assert prepare.main([*argv, "--data_dir", root, "--device", "cpu"]) == 0


@pytest.mark.parametrize("kind", ["fps", "truncated", "render", "gen_mask"])
def test_prepare_cli_matches_tools_prepare(tree, tmp_path, monkeypatch,
                                           kind):
    """Each --type on a copy of the tree per package; every file written
    equals JAX's (posedb caches aside)."""
    jroot, root = _copies(tree, tmp_path)
    if kind == "fps":
        _run_both(jroot, root, monkeypatch, "--type", "fps", "--linemod_cls",
                  "duck", "--num", "12")
        sub = os.path.join("LINEMOD", "duck", "farthest12.txt")
        assert open(os.path.join(root, sub)).read() == \
            open(os.path.join(jroot, sub)).read()
        return
    if kind == "gen_mask":
        for r in (jroot, root):
            chip_smoke.occlusion_scene(r)
    extra = {"truncated": ["--linemod_cls", "duck"],
             "render": ["--linemod_cls", "duck", "--num", "2"],
             "gen_mask": []}[kind]
    _run_both(jroot, root, monkeypatch, "--type", kind, *extra)
    sub = {"truncated": "LINEMOD/truncated", "render": "LINEMOD/renders",
           "gen_mask": "OCCLUSION_LINEMOD/masks_gen"}[kind]
    got = chip_smoke.tree_digests(root, sub, JL.read_mask_np)
    want = chip_smoke.tree_digests(jroot, sub, JL.read_mask_np)
    assert got == want
    assert len(want) == {"truncated": 30, "render": 6, "gen_mask": 16}[kind]


def test_render_set_reads_back_as_jax(tmp_path, monkeypatch):
    """The render set written by --type render, read through
    LineModImageDB(has_render_set=True) and PoseDataset: records, frames
    and the masks of its 16-bit depth PNGs equal JAX's (fault F8: the
    port could not read 16-bit PNGs)."""
    jroot, root = _copies(MINI, tmp_path)
    _run_both(jroot, root, monkeypatch, "--type", "render", "--linemod_cls",
              "duck", "--num", "2")
    jdb = JL.LineModImageDB("duck", has_fuse_set=False,
                            paths=JPathConfig(data_dir=jroot))
    db = TL.LineModImageDB("duck", has_fuse_set=False,
                           paths=PathConfig(data_dir=root))
    assert len(db.render_set) == len(jdb.render_set) == 2
    for a, b in zip(db.render_set, jdb.render_set):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], str):
                assert a[k] == b[k], k
            else:
                np.testing.assert_allclose(np.asarray(a[k], np.float64),
                                           np.asarray(b[k], np.float64),
                                           rtol=1e-6, atol=1e-12, err_msg=k)
    prefix = os.path.join(root, "LINEMOD")
    ds = TD.PoseDataset(db.render_set, prefix, "Farthest", raw=True)
    jds = JD.PoseDataset(jdb.render_set, os.path.join(jroot, "LINEMOD"),
                         "Farthest", raw=True)
    for i in range(2):
        s, js = ds[(i, 48, 64)], jds[(i, 48, 64)]
        np.testing.assert_array_equal(s.rgb.numpy(), js.rgb)
        np.testing.assert_array_equal(s.mask, js.mask)
        assert s.mask.sum() > 0 and s.mask.max() == 1
        np.testing.assert_allclose(s.hcoords, js.hcoords, rtol=1e-6)


def test_linemod_cli_trains_with_the_render_set(tmp_path, capsys):
    """python -m pvnet_tpu_torch.train --linemod_cls duck on a tree with
    a render set: the render records join the real train list."""
    root = str(tmp_path / "data")
    shutil.copytree(MINI, root)
    assert prepare.main(["--type", "render", "--linemod_cls", "duck",
                         "--num", "2", "--data_dir", root,
                         "--device", "cpu"]) == 0
    recipe = json.load(open(os.path.join(REPO, "configs",
                                         "synthetic_train.json")))
    recipe.update(train_batch_size=2, test_batch_size=2, bf16=False)
    cfg = str(tmp_path / "recipe.json")
    json.dump(recipe, open(cfg, "w"))
    capsys.readouterr()
    assert CLI.main(["--linemod_cls", "duck", "--data_dir", root, "--init",
                     os.path.join(REPO, "assets", "duck_ckpt.msgpack"),
                     "--steps", "1", "--buckets", "48x64", "--cfg_file", cfg,
                     "--device_data", "--device", "cpu", "--model_dir",
                     str(tmp_path / "m")]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["train_images"] == 2 + 12       # render + real train
    assert sum(e["steps"] for e in summary["epochs"]) == 1
    assert np.isfinite(summary["epochs"][0]["losses"]).all()
