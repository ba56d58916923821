"""The port's side-experiment datasets (pvnet_tpu_torch/data/experimental.py)
and PrinterAligner (data/pose_transforms.py) against the JAX package's on
small YCB, special-render and printer trees written here (PIL JPEGs and
PNGs, pickles, .xyz / .txt point clouds; the models are copies of
assets/linemod_mini's duck mesh), one tree for each package."""
import os
import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

from _linemod_tree import own_jax_caches
from pvnet_tpu.config import PathConfig as JPathConfig
from pvnet_tpu.data import experimental as JX
from pvnet_tpu.data.pose_transforms import PrinterAligner as JAligner
from pvnet_tpu_torch.config import PathConfig
from pvnet_tpu_torch.data import experimental as TX
from pvnet_tpu_torch.data.pose_transforms import PrinterAligner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUCK_PLY = os.path.join(REPO, "assets", "linemod_mini", "LINEMOD", "duck",
                        "duck.ply")
N_POSES = 3


def _rotation(rng):
    q, r = np.linalg.qr(rng.randn(3, 3))
    return q * np.sign(np.diag(r))


def _pose(rng):
    return np.concatenate([_rotation(rng),
                           [[0.02], [-0.01], [0.5 + 0.1 * rng.rand()]]], 1)


def _write_tree(root):
    """YCB/ (a render, its pose, a point cloud, three masks), LINEMOD/ (the
    duck and cat models, special/duck with poses for 0, 2 and 3) and
    cat_print/ (a point cloud, N_POSES camera blocks)."""
    rng = np.random.RandomState(5)
    ren = os.path.join(root, "YCB", "renders", "mug")
    os.makedirs(ren)
    img = (rng.rand(48, 64, 3) * 255).astype(np.uint8)
    img[8:40, 16:48] = (200, 120, 40)
    Image.fromarray(img).save(os.path.join(ren, "0.jpg"))
    with open(os.path.join(ren, "0_RT.pkl"), "wb") as f:
        pickle.dump({"RT": _pose(rng)}, f)
    models = os.path.join(root, "YCB", "models", "mug")
    os.makedirs(models)
    np.savetxt(os.path.join(models, "points.xyz"),
               rng.uniform(-0.05, 0.05, (40, 3)))
    masks = os.path.join(root, "YCB", "masks")
    os.makedirs(masks)
    for k, (y, x, h, w) in enumerate([(3, 5, 10, 20), (0, 0, 0, 0),
                                      (20, 30, 25, 12)]):
        m = np.zeros((48, 64), np.uint8)
        m[y:y + h, x:x + w] = 1
        m[0, 63] = 2                   # another instance, not counted
        Image.fromarray(m).save(os.path.join(masks, f"{k}.png"))

    for cls in ("duck", "cat"):
        os.makedirs(os.path.join(root, "LINEMOD", cls))
        shutil.copy(DUCK_PLY, os.path.join(root, "LINEMOD", cls,
                                           f"{cls}.ply"))
    special = os.path.join(root, "LINEMOD", "special", "duck")
    os.makedirs(special)
    for k in (0, 2, 3):
        with open(os.path.join(special, f"{k}_RT.pkl"), "wb") as f:
            pickle.dump({"RT": _pose(rng)}, f)

    printer = os.path.join(root, "cat_print")
    os.makedirs(os.path.join(printer, "images"))
    np.savetxt(os.path.join(printer, "point_cloud.txt"),
               np.concatenate([rng.uniform(-0.05, 0.05, (200, 3)),
                               rng.rand(200, 3)], 1))
    with open(os.path.join(printer, "new_camera_poses_ascii.txt"),
              "w") as f:
        for k in range(N_POSES):
            # a camera-to-world block: the inverse of a pose in front of
            # the camera, so that the point cloud projects into the frame
            RT = _pose(rng)
            R, t = RT[:, :3].T, -(RT[:, :3].T @ RT[:, 3])
            f.write(f"{k}\n")
            for row in np.concatenate([R, t[:, None]], 1):
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
            f.write("0 0 0 1\n")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("experimental")
    out = {}
    for side in ("jax", "port"):
        root = str(base / side)
        _write_tree(root)
        out[side] = root
    return out


def test_ycb_validate_pose_matches_jax(trees):
    """The render decoded without PIL equals PIL's pixels; the model's
    projection equals JAX's."""
    rgb_j, pts_j = JX.YCBDB("mug", os.path.join(trees["jax"], "YCB")) \
        .validate_pose(0)
    rgb, pts = TX.YCBDB("mug", os.path.join(trees["port"], "YCB")) \
        .validate_pose(0)
    np.testing.assert_array_equal(rgb, rgb_j)
    np.testing.assert_array_equal(pts, pts_j)


def test_ycb_default_dir_follows_the_data_root():
    assert TX.YCBDB("mug").ycb_dir == os.path.join(PathConfig().data_dir,
                                                   "YCB")
    assert TX.YCBDB("mug").rgb_pattern.endswith(
        os.path.join("YCB", "data", "{:04}/{:06}-color.png"))


def test_crop_size_statistics_match_jax(trees):
    def masks(root):
        d = os.path.join(root, "YCB", "masks")
        return [os.path.join(d, f"{k}.png") for k in range(3)]
    want = JX.YCBDB.crop_size_statistics(masks(trees["jax"]))
    assert TX.YCBDB.crop_size_statistics(masks(trees["port"])) == want
    assert want == {"min_width": 11, "max_width": 19, "min_height": 9,
                    "max_height": 24}


def test_special_render_dataset_matches_jax(trees):
    """Records of the poses present (0, 2, 3 of num 5), their centres
    projected with blender intrinsics."""
    with own_jax_caches():
        want = JX.special_render_dataset(
            "duck", num=5, paths=JPathConfig(data_dir=trees["jax"]))
    got = TX.special_render_dataset("duck", num=5,
                                    paths=PathConfig(data_dir=trees["port"]))
    assert [r["rgb_pth"] for r in got] == [r["rgb_pth"] for r in want] == [
        f"special/duck/{k}.jpg" for k in (0, 2, 3)]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["dpt_pth"], g["rnd_typ"]) == (w["dpt_pth"], w["rnd_typ"])
        np.testing.assert_array_equal(g["RT"], w["RT"])
        np.testing.assert_array_equal(g["center"], w["center"])


def test_printer_model_db_matches_jax(trees):
    """Poses parsed from the camera blocks, aligned by PrinterAligner, the
    point clouds, and the splatted masks (PNG pixels equal to PIL's)."""
    with own_jax_caches():
        jdb = JX.PrinterModelDB("cat", JPathConfig(data_dir=trees["jax"]))
        jdb.generate_mask_images()
    db = TX.PrinterModelDB("cat", PathConfig(data_dir=trees["port"]))
    db.generate_mask_images()
    assert db.image_num == jdb.image_num == N_POSES
    for name in ("printer_model_pts", "model_pts"):
        np.testing.assert_array_equal(getattr(db, name), getattr(jdb, name))
    for got, want in ((db.poses, jdb.poses),
                      (db.aligned_poses, jdb.aligned_poses)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for k in range(1, N_POSES + 1):
        m = np.asarray(Image.open(db.mask_pattern.format(k)))
        np.testing.assert_array_equal(
            m, np.asarray(Image.open(jdb.mask_pattern.format(k))))
        assert m.shape == (484, 648) and m.sum() > 10


def test_printer_aligner_matches_jax():
    rng = np.random.RandomState(3)
    got, want = PrinterAligner(), JAligner()
    for name in ("t_p2w", "R_p2w", "s_p2w"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want,
                                                                  name))
    for _ in range(4):
        RT = _pose(rng)
        np.testing.assert_array_equal(got.pose_p2w(RT), want.pose_p2w(RT))
