"""data/synthetic.write_synthetic_linemod against the JAX package's
generate_synthetic_linemod, which writes the tree tools/train.py
--synthetic trains on: every file equal (JPEG bytes, mask pixels, pose
text, meshes, distance.txt, the three lists), with and without occluders,
serially and in worker processes, and the tree read back by the port's
LineModImageDB and PoseDataset as JAX's reads its own."""
import os

import jax
import numpy as np
import pytest

import chip_smoke
from _linemod_tree import own_jax_caches
from pvnet_tpu.config import PathConfig as JPathConfig
from pvnet_tpu.data import dataset as JD
from pvnet_tpu.data import linemod as JL
from pvnet_tpu.data import synthetic as JS
from pvnet_tpu_torch.config import PathConfig
from pvnet_tpu_torch.data import dataset as TD
from pvnet_tpu_torch.data import linemod as TL
from pvnet_tpu_torch.data import synthetic as TS

jax.config.update("jax_platforms", "cpu")
HW = (120, 160)
N = 8


@pytest.fixture(autouse=True)
def _small_frames(monkeypatch):
    """LINEMOD_K scaled to the 120x160 frames in both generators."""
    K = JS.LINEMOD_K.copy()
    K[:2] /= 4
    monkeypatch.setattr(JS, "LINEMOD_K", K)
    monkeypatch.setattr(TS, "LINEMOD_K", K)
    with own_jax_caches():
        yield


def _trees(tmp_path, workers=1, **kw):
    jroot, root = str(tmp_path / "jax"), str(tmp_path / "port")
    JS.generate_synthetic_linemod(jroot, "duck", num_images=N, image_hw=HW,
                                  **kw)
    paths = TS.write_synthetic_linemod(root, "duck", num_images=N,
                                       image_hw=HW, workers=workers, **kw)
    assert paths.data_dir == root
    return jroot, root


@pytest.mark.parametrize("occ,clutter,seed", [(0.0, 0, 0), (0.5, 2, 0),
                                              (1.0, 3, 7)])
def test_tree_equals_jax(tmp_path, occ, clutter, seed):
    jroot, root = _trees(tmp_path, occluder_prob=occ, max_clutter=clutter,
                         seed=seed)
    want = chip_smoke.tree_digests(jroot, "", JL.read_mask_np)
    got = chip_smoke.tree_digests(root, "", JL.read_mask_np)
    assert len(want) == 4 * N + 6 and got == want
    masks = [JL.read_mask_np(os.path.join(root, "LINEMOD", "duck", "mask",
                                          f"{k:04}.png")) for k in range(N)]
    assert sum(int(m.sum() > 0) for m in masks) >= N // 2   # ducks in view
    assert set(np.unique(np.concatenate([m.ravel() for m in masks]))) \
        <= {0, 255}


def test_tree_in_worker_processes_equals_jax(tmp_path):
    jroot, root = _trees(tmp_path, workers=2, occluder_prob=0.5,
                         max_clutter=2)
    assert chip_smoke.tree_digests(root, "", JL.read_mask_np) == \
        chip_smoke.tree_digests(jroot, "", JL.read_mask_np)


def test_tree_reads_back_as_jax(tmp_path):
    """The port's records and raw samples of its own tree equal JAX's of
    JAX's tree: the lists, poses through the .rot/.tra round trip, frames
    and masks."""
    jroot, root = _trees(tmp_path, occluder_prob=0.5, max_clutter=2)
    jdb = JL.LineModImageDB("duck", has_render_set=False,
                            has_fuse_set=False,
                            paths=JPathConfig(data_dir=jroot))
    db = TL.LineModImageDB("duck", has_render_set=False, has_fuse_set=False,
                           paths=PathConfig(data_dir=root))
    for name in ("real_set", "train_real_set", "val_real_set",
                 "test_real_set"):
        got, want = getattr(db, name), getattr(jdb, name)
        assert [r["rgb_pth"] for r in got] == [r["rgb_pth"] for r in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["RT"], b["RT"])
            np.testing.assert_allclose(a["farthest"], b["farthest"],
                                       rtol=1e-6)
    assert (len(db.train_real_set), len(db.val_real_set),
            len(db.test_real_set)) == (4, 1, 3)
    recs = db.train_real_set + db.val_real_set
    jrecs = jdb.train_real_set + jdb.val_real_set
    ds = TD.PoseDataset(recs, os.path.join(root, "LINEMOD"), "Farthest",
                        raw=True)
    jds = JD.PoseDataset(jrecs, os.path.join(jroot, "LINEMOD"), "Farthest",
                         raw=True)
    for i in range(len(recs)):
        s, js = ds[(i, 48, 64)], jds[(i, 48, 64)]
        np.testing.assert_array_equal(s.rgb.numpy(), js.rgb)
        np.testing.assert_array_equal(s.mask, js.mask)
        np.testing.assert_allclose(s.hcoords, js.hcoords, rtol=1e-6)


def test_views_of_a_generated_split_equal_the_whole_tree(tmp_path):
    """write_linemod_views of generate_synthetic_linemod's images 1, 4, 6
    (chip_smoke.py's envelope study writes phase (h)'s frames so) writes
    those views' files as write_synthetic_linemod does, and the lists it is
    given."""
    kw = dict(num_images=N, image_hw=HW, occluder_prob=0.5, max_clutter=2)
    whole = str(tmp_path / "whole")
    TS.write_synthetic_linemod(whole, "duck", **kw)
    split = TS.generate_synthetic_linemod(render=[6, 1, 4], **kw)
    part = str(tmp_path / "part")
    TS.write_linemod_views(part, split, {"test": [4, 1]})
    want = chip_smoke.tree_digests(whole, "", JL.read_mask_np)
    got = chip_smoke.tree_digests(part, "", JL.read_mask_np)
    lists = {"LINEMOD/duck/train.txt", "LINEMOD/duck/val.txt",
             "LINEMOD/duck/test.txt"}
    for name, digest in got.items():
        if name not in lists:
            assert want[name] == digest, name
    assert len(got) == 3 * 4 + 6
    cls_dir = os.path.join(part, "LINEMOD", "duck")
    assert open(os.path.join(cls_dir, "test.txt")).read() == \
        "000004.jpg\n000001.jpg\n"
    assert open(os.path.join(cls_dir, "train.txt")).read() == ""
