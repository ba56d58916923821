"""The port's LINEMOD read path (pvnet_tpu_torch/data/linemod.py,
pose_transforms.py, dataset.py) against the JAX package's on a tree the
JAX package writes (tools/make_torch_linemod_fixture.write_tree at
120x160: its LINEMOD, Occlusion and Truncation layouts, plus a fuse set
written here): the databases' records, each package reading the other's
posedb pickles, VotingType, raw PoseDataset samples and collate batches."""
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

from _linemod_tree import HW, N_IMAGES, make_tree, own_jax_caches
from pvnet_tpu.config import AugConfig as JAugConfig
from pvnet_tpu.config import PathConfig as JPathConfig
from pvnet_tpu.data import dataset as JD
from pvnet_tpu.data import linemod as JL
from pvnet_tpu.data.pose_transforms import PoseTransformer as JPoseTransformer
from pvnet_tpu_torch.config import AugConfig, PathConfig
from pvnet_tpu_torch.data import dataset as TD
from pvnet_tpu_torch.data import linemod as TL
from pvnet_tpu_torch.data.pose_transforms import PoseTransformer

jax.config.update("jax_platforms", "cpu")
VOTE_TYPES = ["BB8", "BB8C", "BB8S", "Farthest", "Farthest4", "Farthest12",
              "Farthest16", "Farthest20"]


@pytest.fixture(autouse=True)
def _fresh_jax_caches():
    with own_jax_caches():
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX-written tree, and a copy for each package (the databases
    write posedb/ caches and keypoint files into it)."""
    base = tmp_path_factory.mktemp("tree")
    make_tree(str(base / "src"))
    for name in ("jax", "port"):
        shutil.copytree(str(base / "src"), str(base / name))
    return {k: str(base / k) for k in ("src", "jax", "port")}


def _jax_dbs(root):
    paths = JPathConfig(data_dir=root)
    db = JL.LineModImageDB("duck", paths=paths)
    return (db, JL.OcclusionLineModImageDB("duck", paths=paths),
            JL.TruncatedLineModImageDB("duck", paths=paths))


def _port_dbs(root):
    paths = PathConfig(data_dir=root)
    db = TL.LineModImageDB("duck", paths=paths)
    return (db, TL.OcclusionLineModImageDB("duck", paths=paths),
            TL.TruncatedLineModImageDB("duck", paths=paths))


def _sets(dbs):
    db, odb, tdb = dbs
    return {"render": db.render_set, "real": db.real_set,
            "train": db.train_real_set, "val": db.val_real_set,
            "test": db.test_real_set, "fuse": db.fuse_set,
            "occ_test": odb.test_real_set, "occ_train": odb.train_real_set,
            "truncated": tdb.set}


def _same_records(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for k in ("rgb_pth", "dpt_pth", "cls_typ", "rnd_typ"):
            assert a[k] == b[k], k
        for k in a:
            if k not in ("rgb_pth", "dpt_pth", "cls_typ", "rnd_typ"):
                np.testing.assert_allclose(
                    np.asarray(a[k], np.float64), np.asarray(b[k],
                                                             np.float64),
                    rtol=1e-6, atol=1e-12, err_msg=k)


@pytest.fixture(scope="module")
def both(tree):
    with own_jax_caches():
        return _sets(_jax_dbs(tree["jax"])), _sets(_port_dbs(tree["port"]))


def test_records_match_jax(both):
    jsets, tsets = both
    assert set(jsets) == set(tsets)
    sizes = {k: len(v) for k, v in jsets.items()}
    # the generator's split: 5 train, 1 val, 4 test; 2 fuse, 2 occluded,
    # 8 crops; no render set
    assert sizes == {"render": 0, "real": N_IMAGES, "train": 5, "val": 1,
                     "test": 4, "fuse": 2, "occ_test": 2, "occ_train": 0,
                     "truncated": 8}, sizes
    for k in jsets:
        _same_records(tsets[k], jsets[k])
    assert "K" in tsets["fuse"][0] and "van_pts" not in tsets["fuse"][0]
    assert "van_pts" in tsets["occ_test"][0]


def test_model_db_matches_jax(tree, both):
    jm = JL.LineModModelDB(JPathConfig(data_dir=tree["jax"]))
    tm = TL.LineModModelDB(PathConfig(data_dir=tree["port"]))
    for fn in ("get_corners_3d", "get_small_bbox", "get_centers_3d",
               "get_ply_model"):
        np.testing.assert_allclose(getattr(tm, fn)("duck"),
                                   getattr(jm, fn)("duck"), rtol=1e-6,
                                   err_msg=fn)
    for num in (4, 8, 12, 16, 20):
        np.testing.assert_array_equal(tm.get_farthest_3d("duck", num),
                                      jm.get_farthest_3d("duck", num))
    assert tm.get_diameter("duck") == jm.get_diameter("duck")
    v, f = tm.get_ply_mesh("duck")
    jv, jf = jm.get_ply_mesh("duck")
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_each_package_reads_the_others_posedb(tree, both):
    """The port on JAX's pickles and JAX on the port's: the caches are
    read (a mark put in each pickle comes back) and give the same
    records."""
    jsets, tsets = both
    for reader, writer in ((_port_dbs, "jax"), (_jax_dbs, "port")):
        posedb = os.path.join(tree[writer], "LINEMOD", "posedb")
        names = sorted(os.listdir(posedb))
        assert names == ["duck_fuse.pkl", "duck_real.pkl", "duck_render.pkl",
                         "duck_truncated.pkl"], names
        root = tree[writer] + "_read"
        shutil.copytree(tree[writer], root)
        pkl = os.path.join(root, "LINEMOD", "posedb", "duck_real.pkl")
        with open(pkl, "rb") as f:
            recs = pickle.load(f)
        recs[0] = dict(recs[0], mark=writer)
        with open(pkl, "wb") as f:
            pickle.dump(recs, f)
        got = _sets(reader(root))
        assert got["real"][0].pop("mark") == writer
        for k in got:
            _same_records(got[k], jsets[k])


@pytest.mark.parametrize("vote_type", VOTE_TYPES)
def test_voting_type_matches_jax(tree, both, vote_type):
    jsets, tsets = both
    assert TD.VotingType.vote_num(vote_type) == \
        JD.VotingType.vote_num(vote_type)
    for rec, jrec in zip(tsets["test"] + tsets["fuse"],
                         jsets["test"] + jsets["fuse"]):
        np.testing.assert_array_equal(
            TD.VotingType.get_data_pts_2d(vote_type, rec),
            JD.VotingType.get_data_pts_2d(vote_type, jrec))
    got = TD.VotingType.get_pts_3d(
        vote_type, "duck", TL.LineModModelDB(PathConfig(tree["port"])))
    want = JD.VotingType.get_pts_3d(
        vote_type, "duck", JL.LineModModelDB(JPathConfig(tree["jax"])))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _raw_cases(both, tree):
    """(name, port records, JAX records, data prefix, use_intrinsic) of
    each set a sample is taken from: real frames (L masks), fuse frames
    (label masks), Occlusion frames (RGB PNG and RGB masks), crops."""
    jsets, tsets = both
    lm = os.path.join(tree["src"], "LINEMOD")
    occ = os.path.join(tree["src"], "OCCLUSION_LINEMOD")
    return [("real", tsets["real"][:4], jsets["real"][:4], lm, False),
            ("fuse", tsets["fuse"], jsets["fuse"], lm, True),
            ("occ", tsets["occ_test"], jsets["occ_test"], occ, False),
            ("truncated", tsets["truncated"][:3], jsets["truncated"][:3], lm,
             True)]


@pytest.mark.parametrize("case", ["real", "fuse", "occ", "truncated"])
def test_raw_samples_and_batches_match_jax(tree, both, case):
    """PoseDataset(raw=True) and collate's raw branch, the fuse records
    with ignore_fuse_ms_vertex: uint8 exact, hcoords to 1e-6."""
    name, recs, jrecs, prefix, own_k = next(
        c for c in _raw_cases(both, tree) if c[0] == case)
    aug = AugConfig(ignore_fuse_ms_vertex=True)
    jaug = JAugConfig(ignore_fuse_ms_vertex=True)
    ds = TD.PoseDataset(recs, prefix, "Farthest", aug_cfg=aug,
                        use_intrinsic=own_k, raw=True)
    jds = JD.PoseDataset(jrecs, prefix, "Farthest", aug_cfg=jaug,
                         use_intrinsic=own_k, raw=True)
    samples, jsamples = [], []
    for i in range(len(recs)):
        s, js = ds[(i, 48, 64)], jds[(i, 48, 64)]
        assert s.rgb.dtype == torch.uint8 and s.mask.dtype == np.uint8
        np.testing.assert_array_equal(s.rgb.numpy(), js.rgb)
        np.testing.assert_array_equal(s.mask, js.mask)
        assert s.mask.max() <= 1 and s.mask.sum() > 0
        np.testing.assert_allclose(s.hcoords, js.hcoords, rtol=1e-6)
        np.testing.assert_array_equal(s.pose, js.pose)
        assert s.ignore_vertex == js.ignore_vertex == (case == "fuse")
        assert s.out_hw == js.out_hw == (48, 64)
        if own_k:
            np.testing.assert_array_equal(s.K, js.K)
        samples.append(s)
        jsamples.append(js)
    batch, jbatch = TD.collate(samples), JD.collate(jsamples)
    assert set(batch) == set(jbatch)
    for k in batch:
        got = batch[k].numpy() if torch.is_tensor(batch[k]) else batch[k]
        assert got.dtype == np.asarray(jbatch[k]).dtype, k
        np.testing.assert_allclose(got, jbatch[k], rtol=1e-6, err_msg=k)


def test_record_loader_batches_in_order(tree, both):
    """The validation loader: raw batches of the records in order, the
    last one short, as JAX's unshuffled sampler and Prefetcher give."""
    _, tsets = both
    recs = tsets["test"] + tsets["val"]
    loader = TD.record_loader(recs, os.path.join(tree["src"], "LINEMOD"),
                              "Farthest", 2, num_threads=3)
    batches = list(loader)
    assert [len(b["pose"]) for b in batches] == [2, 2, 1]
    poses = np.concatenate([b["pose"] for b in batches])
    np.testing.assert_array_equal(poses, np.stack([r["RT"] for r in recs]))
    assert batches[0]["image"].shape == (2,) + HW + (3,)


def test_translation_cache_keyed_by_tree(tree, tmp_path):
    """ROADMAP D3: two trees of one class whose LINEMOD_ORIG meshes
    differ. JAX's class-keyed cache gives the second tree the first's
    transform; the port's, keyed by the model files, gives each its own."""
    from pvnet_tpu_torch.data.ply import PlyMesh, load_ply, save_ply_ascii
    other = str(tmp_path / "other")
    shutil.copytree(tree["src"], other)
    mesh_path = os.path.join(other, "LINEMOD_ORIG", "duck", "mesh.ply")
    mesh = load_ply(mesh_path)
    save_ply_ascii(mesh_path, PlyMesh(
        vertices=(mesh.vertices + np.array([5.0, -3.0, 2.0])).astype(
            np.float32), faces=mesh.faces))
    pose = np.concatenate([np.eye(3), [[0.0], [0.0], [0.5]]], 1)
    got, want = [], []
    for root in (tree["src"], other):
        p = PathConfig(data_dir=root)
        got.append(PoseTransformer("duck", p.linemod_dir,
                                   p.linemod_orig_dir).
                   orig_pose_to_blender_pose(pose))
        want.append(JPoseTransformer("duck", p.linemod_dir,
                                     p.linemod_orig_dir).
                    orig_pose_to_blender_pose(pose))
    np.testing.assert_array_equal(want[0], want[1])         # JAX: cached
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    shift = got[1][:, 3] - got[0][:, 3]
    np.testing.assert_allclose(shift, [0.005, -0.003, 0.002], atol=1e-6)
