"""PoseDataset(augment=True) and collate's non-raw batch of the port
(pvnet_tpu_torch/data/dataset.py) against the JAX package's, on the CPU,
on the 120x160 tree of tests/_linemod_tree.py with a render set and a
record whose mask is empty: for the default recipe
(configs/linemod_train.json: the fused warp, blur, jitter), fast_aug=False
(rotate, then crop-resize v1), use_old=False (v2), and mask, use_mask_out
and flip, over several seeds and target sizes. The normalized image within
1e-6, masks exactly, hcoords within 1e-6 px, the dataset's RandomState
equal to JAX's after every sample; the batch's image within 1e-6, mask and
vertex_weights exactly; host vertex targets within 1e-6."""
import dataclasses
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from _linemod_tree import make_tree, own_jax_caches
from pvnet_tpu.config import PathConfig as JPathConfig
from pvnet_tpu.config import TrainConfig as JTrainConfig
from pvnet_tpu.data import dataset as JD
from pvnet_tpu.data import linemod as JL
from pvnet_tpu_torch.config import PathConfig, TrainConfig
from pvnet_tpu_torch.data import dataset as TD
from pvnet_tpu_torch.data import linemod as TL

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "linemod_train.json")
N_RENDER = 2


def write_render(root: str) -> None:
    """A render set of N_RENDER views (the layout of
    LineModImageDB.collect_render_set_info): a frame of the tree, a 16-bit
    depth PNG that is non-zero on its mask, the pose pickle."""
    lm = os.path.join(root, "LINEMOD")
    out = os.path.join(lm, "renders", "duck")
    os.makedirs(out, exist_ok=True)
    for k in range(N_RENDER):
        shutil.copy(os.path.join(lm, "duck", "JPEGImages", f"{k:06}.jpg"),
                    os.path.join(out, f"{k}.jpg"))
        mask = np.array(Image.open(os.path.join(lm, "duck", "mask",
                                                f"{k:04}.png")))
        if mask.ndim == 3:
            mask = mask.sum(2)
        depth = ((mask > 0) * (700 + 10 * k)).astype(np.uint16)
        Image.fromarray(depth).save(os.path.join(out, f"{k}_depth.png"))
        rt = np.zeros((3, 4), np.float32)
        rt[:, :3] = np.eye(3)
        rt[2, 3] = 0.6 + 0.05 * k
        with open(os.path.join(out, f"{k}_RT.pkl"), "wb") as f:
            pickle.dump({"RT": rt}, f)


def _records(root, jax_side: bool):
    """The train records of a copy of the tree (render, real train, fuse)
    and one more: a real record whose mask file is all zeros."""
    mod, P = (JL, JPathConfig) if jax_side else (TL, PathConfig)
    with own_jax_caches():
        db = mod.LineModImageDB("duck", has_render_set=True,
                                has_fuse_set=True, paths=P(data_dir=root))
    recs = db.render_set + db.train_real_set + db.fuse_set
    empty = dict(db.train_real_set[0], dpt_pth="duck/mask/empty.png")
    return recs + [empty]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("host")
    src = str(base / "src")
    make_tree(src)
    write_render(src)
    Image.fromarray(np.zeros((120, 160), np.uint8)).save(
        os.path.join(src, "LINEMOD", "duck", "mask", "empty.png"))
    out = {}
    for side in ("jax", "port"):
        root = str(base / side)
        shutil.copytree(src, root)
        out[side] = (os.path.join(root, "LINEMOD"),
                     _records(root, side == "jax"))
    kinds = [r["rnd_typ"] for r in out["port"][1]]
    assert kinds.count("render") == N_RENDER and "fuse" in kinds
    return out


VARIANTS = {
    "default": {},
    "fast_aug_false": {"fast_aug": False},
    "v2": {"use_old": False},
    "mask_maskout_flip": {"mask": True, "use_mask_out": True, "flip": True,
                          "ignore_fuse_ms_vertex": True},
}


def _datasets(trees, variant, seed, host_vertex=False):
    opts = dict(VARIANTS[variant])
    fast = opts.pop("fast_aug", True)
    jcfg, cfg = JTrainConfig.from_json(RECIPE), TrainConfig.from_json(RECIPE)
    jaug = dataclasses.replace(jcfg.aug_cfg, **opts)
    aug = dataclasses.replace(cfg.aug_cfg, **opts)
    jprefix, jrecs = trees["jax"]
    prefix, recs = trees["port"]
    jds = JD.PoseDataset(jrecs, jprefix, "Farthest", augment=True,
                         aug_cfg=jaug, seed=seed, fast_aug=fast,
                         host_vertex=host_vertex)
    ds = TD.PoseDataset(recs, prefix, "Farthest", augment=True, aug_cfg=aug,
                        seed=seed, fast_aug=fast, host_vertex=host_vertex)
    return ds, jds


def _same_state(a, b):
    sa, sb = a.get_state(), b.get_state()
    assert sa[2] == sb[2] and np.array_equal(sa[1], sb[1])


def _check_sample(s, js, tag):
    assert s.rgb.dtype == torch.float32 and s.mask.dtype == np.int32
    np.testing.assert_allclose(s.rgb.numpy(), js.rgb, rtol=0, atol=1e-6,
                               err_msg=tag)
    np.testing.assert_array_equal(s.mask, js.mask, err_msg=tag)
    np.testing.assert_allclose(s.hcoords, js.hcoords, rtol=0, atol=1e-6,
                               err_msg=tag)
    np.testing.assert_array_equal(s.pose, js.pose)
    assert s.ignore_vertex == js.ignore_vertex and s.out_hw is None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_augmented_samples_and_batches_match_jax(trees, variant, seed):
    ds, jds = _datasets(trees, variant, seed)
    n = len(ds)
    samples, jsamples = [], []
    for j, hw in enumerate([(96, 128), (120, 160), (64, 80)]):
        for i in range(n):
            idx = (i, *hw)
            s, js = ds[idx], jds[idx]
            _check_sample(s, js, f"{variant} {seed} {idx}")
            _same_state(ds.rng, jds.rng)
            if j == 0:
                samples.append(s)
                jsamples.append(js)
    batch, jbatch = TD.collate(samples), JD.collate(jsamples)
    assert set(batch) == set(jbatch) == {"image", "mask", "hcoords", "pose",
                                         "vertex_weights"}
    assert batch["image"].dtype == torch.float32
    np.testing.assert_allclose(batch["image"].numpy(), jbatch["image"],
                               rtol=0, atol=1e-6)
    for k in ("mask", "vertex_weights", "pose"):
        assert batch[k].dtype == jbatch[k].dtype, k
        np.testing.assert_array_equal(batch[k], jbatch[k], err_msg=k)
    np.testing.assert_allclose(batch["hcoords"], jbatch["hcoords"], rtol=0,
                               atol=1e-6)
    if VARIANTS[variant].get("ignore_fuse_ms_vertex"):
        fuse = [r["rnd_typ"] == "fuse" for r in trees["port"][1]]
        assert (batch["vertex_weights"][np.array(fuse)] == 0).all()


def test_empty_mask_takes_the_background_crop(trees):
    """The record without foreground goes through
    crop_or_padding_to_fixed_size: a padded crop, an empty mask."""
    ds, jds = _datasets(trees, "default", 3)
    last = len(ds) - 1
    for hw in ((96, 128), (160, 200)):
        s, js = ds[(last, *hw)], jds[(last, *hw)]
        _check_sample(s, js, str(hw))
        assert s.mask.shape == hw and s.mask.sum() == 0
        _same_state(ds.rng, jds.rng)


def test_host_vertex_and_plain_normalization_match_jax(trees):
    """host_vertex=True: the vertex targets and the batch's vertex; and
    augment=False: the frame normalized at its own size."""
    ds, jds = _datasets(trees, "default", 4, host_vertex=True)
    samples, jsamples = [], []
    for i in range(4):
        s, js = ds[(i, 96, 128)], jds[(i, 96, 128)]
        _check_sample(s, js, str(i))
        np.testing.assert_allclose(s.vertex, js.vertex, rtol=0, atol=1e-6)
        samples.append(s)
        jsamples.append(js)
    batch, jbatch = TD.collate(samples), JD.collate(jsamples)
    np.testing.assert_allclose(batch["vertex"], jbatch["vertex"], rtol=0,
                               atol=1e-6)
    jprefix, jrecs = trees["jax"]
    prefix, recs = trees["port"]
    plain = TD.PoseDataset(recs, prefix, "Farthest")
    jplain = JD.PoseDataset(jrecs, jprefix, "Farthest")
    for i in (0, len(recs) - 2):
        s, js = plain[(i, 0, 0)], jplain[(i, 0, 0)]
        _check_sample(s, js, str(i))
        assert s.rgb.shape == (120, 160, 3)


def test_cached_images_give_the_same_samples(trees):
    """cache_images keeps the decoded frames: a second epoch over the cache
    draws and augments as without it."""
    prefix, recs = trees["port"]
    cfg = TrainConfig.from_json(RECIPE)
    a = TD.PoseDataset(recs, prefix, "Farthest", augment=True,
                       aug_cfg=cfg.aug_cfg, seed=5, cache_images=True)
    b = TD.PoseDataset(recs, prefix, "Farthest", augment=True,
                       aug_cfg=cfg.aug_cfg, seed=5)
    for _ in range(2):
        for i in range(3):
            s, t = a[(i, 64, 80)], b[(i, 64, 80)]
            assert torch.equal(s.rgb, t.rgb)
            np.testing.assert_array_equal(s.mask, t.mask)
    assert len(a._cache) == 3
