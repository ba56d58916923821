"""The port's synthetic split, rasterizer, FPS and PLY I/O against the JAX
package's numpy code: bit for bit (all numpy on both sides, the same
operations in the same order)."""
import os

import numpy as np
import pytest

from pvnet_tpu.config import LINEMOD_K
from pvnet_tpu.data import ply as JPLY
from pvnet_tpu.data import synthetic as JS
from pvnet_tpu.data.dataset import VotingType
from pvnet_tpu.data.linemod import LineModImageDB, LineModModelDB
from pvnet_tpu.ops import rasterize as JR
from pvnet_tpu_torch.data import ply as TPLY
from pvnet_tpu_torch.data import synthetic as TS
from pvnet_tpu_torch.ops import rasterize as TR
from pvnet_tpu_torch.ops.fps import farthest_point_sampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "assets", "duck_views_480x640.npz")


def _same_mesh(a, b):
    for k in ("vertices", "faces", "colors"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_meshes_bit_equal():
    _same_mesh(TS.make_duck_mesh(), JS.make_duck_mesh())
    rt, rj = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(4):
        _same_mesh(TS.make_distractor_mesh(rt), JS.make_distractor_mesh(rj))
    assert rt.randint(1 << 30) == rj.randint(1 << 30)


def test_pose_and_distractor_draws_bit_equal():
    rt, rj = np.random.RandomState(5), np.random.RandomState(5)
    meshes = [JS.make_distractor_mesh(np.random.RandomState(i))
              for i in range(3)]
    for _ in range(6):
        pt, pj = TS.sample_object_pose(rt), JS.sample_object_pose(rj)
        np.testing.assert_array_equal(pt, pj)
        dt = TS.sample_distractors(pt, rt, meshes, 0.5, 2)
        dj = JS.sample_distractors(pj, rj, meshes, 0.5, 2)
        assert [m is n for (m, _), (n, _) in zip(dt, dj)] == [True] * len(dj)
        for (_, a), (_, b) in zip(dt, dj):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TS.sample_sphere_poses(4, rt),
                                  JS.sample_sphere_poses(4, rj))


def _triangles(seed, h, w):
    rng = np.random.RandomState(seed)
    tri = rng.uniform(-10, [w + 10, h + 10], (40, 3, 2))
    tri[5] = tri[5, :1]                                     # degenerate
    z = rng.uniform(0.3, 0.9, (40, 3)).astype(np.float32)
    attr = rng.uniform(0, 255, (40, 3, 3)).astype(np.float32)
    return tri, z, attr


def test_rasterize_bit_equal():
    """JAX's _rasterize directly: its mesh_binary_rasterization takes the
    native library where it is built."""
    h, w = 37, 53
    tri, z, attr = _triangles(0, h, w)
    mt, mj = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
    TR._rasterize(tri, None, h, w, mask_out=mt)
    JR._rasterize(tri, None, h, w, mask_out=mj)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(TR.mesh_binary_rasterization(tri, h, w), mj)
    assert 0 < mj.sum() < h * w
    outs = []
    for R in (TR, JR):
        d = np.full((h, w), np.inf, np.float32)
        a = np.zeros((h, w, 3), np.float32)
        R._rasterize(tri, z, h, w, depth_out=d, triattr=attr, attr_out=a)
        outs.append((d, a))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)


def test_mesh_renders_bit_equal():
    mesh = JS.make_duck_mesh()
    pose = JS.sample_object_pose(np.random.RandomState(2))
    K = LINEMOD_K.copy()
    K[:2] *= 0.25
    args = (pose, K, mesh.vertices, mesh.faces)
    np.testing.assert_array_equal(TR.render_mesh_depth(*args, 120, 160),
                                  JR.render_mesh_depth(*args, 120, 160))
    attrs = mesh.colors.astype(np.float32)
    for x, y in zip(TR.render_mesh_attributes(*args, attrs, 120, 160),
                    JR.render_mesh_attributes(*args, attrs, 120, 160)):
        np.testing.assert_array_equal(x, y)
        assert x.any()


def test_render_synthetic_view_bit_equal():
    rng = np.random.RandomState(9)
    mesh = JS.make_duck_mesh()
    dm = [JS.make_distractor_mesh(rng) for _ in range(3)]
    K = LINEMOD_K.copy()
    K[:2] *= 0.5
    visible = []
    for seed in (1, 2, 4):
        pr = np.random.RandomState(seed)
        pose = JS.sample_object_pose(pr)
        dist = JS.sample_distractors(pose, pr, dm, 0.5, 2)
        rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        got = TS.render_synthetic_view(mesh, pose, K, 240, 320, rt, dist)
        want = JS.render_synthetic_view(mesh, pose, K, 240, 320, rj,
                                        distractors=dist)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype == np.uint8
            np.testing.assert_array_equal(x, y)
        visible.append(int(got[1].sum()))
        assert rt.randint(1 << 30) == rj.randint(1 << 30)
    assert max(visible) > 100, visible


def _jax_replay(n, hw, seed, occ, clutter, render=None):
    """JAX generate_synthetic_linemod's draws and renders, in memory: its
    own functions in its loop's order; a skipped image draws only its
    background, as a render would."""
    rng = np.random.RandomState(seed)
    dm = [JS.make_distractor_mesh(rng) for _ in range(8)] \
        if (occ > 0 or clutter > 0) else []
    mesh = JS.make_duck_mesh()
    out = []
    for k in range(n):
        pose = JS.sample_object_pose(rng)
        dist = JS.sample_distractors(pose, rng, dm, occ, clutter)
        if render is None or k in render:
            rgb, mask = JS.render_synthetic_view(mesh, pose, LINEMOD_K, *hw,
                                                 rng, distractors=dist)
            out.append((k, rgb, mask, pose))
        else:
            rng.randint(0, 80, hw + (3,))
    return out


@pytest.mark.parametrize("render,workers", [(None, 1), ((6, 3), 2)])
def test_generator_matches_a_replay_of_jax(render, workers):
    """At the split's full 480x640 (K is LINEMOD's there), 8 images; with
    range skipping in two worker processes and without."""
    n, hw = 8, (480, 640)
    got = TS.generate_synthetic_linemod(n, hw, seed=0, occluder_prob=0.5,
                                        max_clutter=2, render=render,
                                        workers=workers)
    want = _jax_replay(n, hw, 0, 0.5, 2, render)
    assert got["index"].tolist() == [k for k, *_ in want]
    for i, (_, rgb, mask, pose) in enumerate(want):
        np.testing.assert_array_equal(got["images"][i], rgb)
        np.testing.assert_array_equal(got["masks"][i], mask)
        np.testing.assert_array_equal(got["poses"][i], pose)
    assert got["masks"].reshape(len(want), -1).sum(1).max() > 1000
    np.testing.assert_array_equal(got["K"], LINEMOD_K)


def test_generator_without_occluders_draws_no_distractor_meshes():
    got = TS.generate_synthetic_linemod(3, (48, 64), seed=2)
    want = _jax_replay(3, (48, 64), 2, 0.0, 0)
    for i, (_, rgb, _, pose) in enumerate(want):
        np.testing.assert_array_equal(got["images"][i], rgb)
        np.testing.assert_array_equal(got["poses"][i], pose)


def test_split_and_metadata_match_the_jax_tree(tmp_path):
    """The JAX generator's LINEMOD tree read back by the JAX package's DB:
    the split lists, the evaluation order of tools/train.py --test_model
    (test_real_set + val_real_set), the ObjectMeta fields and the GT poses
    (through the pose files' 8-decimal text)."""
    n = 23
    paths = JS.generate_synthetic_linemod(str(tmp_path), num_images=n,
                                          image_hw=(48, 64),
                                          occluder_prob=0.5, max_clutter=2)
    got = TS.generate_synthetic_linemod(n, (48, 64), occluder_prob=0.5,
                                        max_clutter=2)
    for name in ("train", "val", "test"):
        with open(os.path.join(paths.linemod_dir, "duck", f"{name}.txt")) \
                as f:
            want = [int(line.strip()[:6]) for line in f]
        assert got[name].tolist() == want, name
    db = LineModImageDB("duck", has_render_set=False, has_fuse_set=False,
                        paths=paths)
    records = db.test_real_set + db.val_real_set
    order = TS.evaluation_order(n)
    assert order.tolist() == [int(r["rgb_pth"][-10:-4]) for r in records]
    for r, k in zip(records, order):
        np.testing.assert_allclose(got["poses"][k], r["RT"], atol=2e-7)
    mdb = LineModModelDB(paths)
    np.testing.assert_array_equal(
        got["points_3d"],
        VotingType.get_pts_3d("Farthest", "duck", mdb).astype(np.float32))
    np.testing.assert_array_equal(got["model_pts"],
                                  mdb.get_ply_model("duck"))
    assert float(got["diameter"]) == mdb.get_diameter("duck")


def test_fps_reproduces_the_fixture_keypoints():
    """The fixture's points_3d came from the JAX package's FPS (its native
    library where built): the port's numpy FPS picks the same 8 points."""
    v = np.asarray(JS.make_duck_mesh().vertices, np.float32)
    with np.load(FIXTURE) as z:
        want = z["points_3d"]
    np.testing.assert_array_equal(farthest_point_sampling(v, 8, True),
                                  want[:8])
    np.testing.assert_array_equal(TS.object_metadata(
        TS.make_duck_mesh())["points_3d"], want)
    from pvnet_tpu.ops.fps import _fps_numpy
    for init_center in (False, True):
        np.testing.assert_array_equal(
            farthest_point_sampling(v, 12, init_center),
            _fps_numpy(v, 12, init_center))


def _write_binary_ply(path, mesh):
    n, m = len(mesh.vertices), len(mesh.faces)
    head = ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\nproperty float x\nproperty float y\n"
            "property float z\nproperty uchar red\nproperty uchar green\n"
            f"property uchar blue\nelement face {m}\n"
            "property list uchar int vertex_indices\nend_header\n")
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                    ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    v = np.empty(n, vdt)
    for i, k in enumerate("xyz"):
        v[k] = mesh.vertices[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        v[k] = mesh.colors[:, i]
    fdt = np.dtype([("n", "u1"), ("i", "<i4", (3,))])
    f = np.empty(m, fdt)
    f["n"], f["i"] = 3, mesh.faces
    with open(path, "wb") as fh:
        fh.write(head.encode() + v.tobytes() + f.tobytes())


def test_ply_roundtrip_matches_jax(tmp_path):
    mesh = TS.make_distractor_mesh(np.random.RandomState(1))
    TPLY.save_ply_ascii(str(tmp_path / "a.ply"), mesh)
    JPLY.save_ply_ascii(str(tmp_path / "j.ply"), mesh)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "j.ply") \
        .read_bytes()
    _write_binary_ply(tmp_path / "b.ply", mesh)
    for name in ("a.ply", "b.ply"):
        got = TPLY.load_ply(str(tmp_path / name))
        want = JPLY.load_ply(str(tmp_path / name))
        _same_mesh(got, want)
        _same_mesh(got, mesh)
    with pytest.raises(ValueError):
        (tmp_path / "bad.ply").write_bytes(b"ply\nformat ascii 1.0\n")
        TPLY.load_ply(str(tmp_path / "bad.ply"))
