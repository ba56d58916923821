"""The slice end to end: the port's image -> pose path against the JAX
pieces composed the way the TPU runs them, the committed fixture, and the
port's import without JAX."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pvnet_tpu import pipeline as JPL
from pvnet_tpu.config import IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import pnp as JP
from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch import pipeline as TPL
from pvnet_tpu_torch.infer import load_model
from pvnet_tpu_torch.ops import voting as TV
from pvnet_tpu_torch.ops.geometry import rotation_angle_deg
from tools.make_torch_fixture import DEFAULT_OUT, make_views

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")


@pytest.fixture(scope="module")
def small_views():
    # bench.py:52-54: a downscaled render with K scaled to match
    return make_views(2, 120, 160, seed=1)


def test_slice_matches_jax_composition(small_views):
    v = small_views
    params = TPL.VoteParams()
    images = ((v["images"].astype(np.float32) / 255.0 - IMAGENET_MEAN)
              / IMAGENET_STD).astype(np.float32)
    b, h, w, _ = images.shape

    # JAX, composed the TPU way: NCHW-head flax model, stratified selection,
    # the Pallas count kernel (interpret mode), batched PnP
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    fmodel = build_flax("resnet18_8s", ver_dim=18, head_layout="NCHW")
    mask_j, ver_j = JPL.predict_fields(fmodel.apply, variables,
                                       jnp.asarray(images))
    key = jax.random.PRNGKey(11)
    kps_j = JV.ransac_voting_v3(
        mask_j, ver_j, key, hyp_num=params.hyp_num,
        inlier_thresh=params.inlier_thresh, max_num=params.max_num,
        min_num=params.min_num, impl="pallas_interpret",
        select_method="stratified")
    pose_j = np.asarray(jax.jit(JP.pnp_batch)(
        jnp.asarray(v["points_3d"]), kps_j, jnp.asarray(v["K"])))
    k1, k2 = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(k1, (b, h, w), jnp.float32))
    pair_u = np.asarray(jax.random.uniform(k2, (b, params.hyp_num, 2),
                                           jnp.float32))

    model = load_model(CKPT, 9, "cpu")
    pts3d, K = torch.tensor(v["points_3d"]), torch.tensor(v["K"])
    noise_t, pair_t = torch.tensor(noise), torch.tensor(pair_u)

    # (1) the port's voting stages on JAX's own fields and draws: the same
    # pixels, the same hypotheses, and the same counts as JAX evaluated op
    # by op. (JAX's compiled count paths — the scan body of
    # count_inliers_xla, the Pallas kernel in interpret mode — may contract
    # multiply-adds into FMAs, which moves pixels lying within an ulp of
    # the cosine boundary: on this learned field they disagree with each
    # other on a few counts, and with the op-by-op form on ~1 %.)
    fg_j = JV.sample_foreground(mask_j, ver_j, params.max_num, k1,
                                method="stratified")
    hyps_j = JV.generate_hypotheses(fg_j, params.hyp_num, k2)
    hx, hy = hyps_j[..., 0], hyps_j[..., 1]
    hf = jnp.stack([hx, hy, hx * hx + hy * hy], -1)[:, :, :, None, :]
    counts_j = jnp.sum(JV._inlier_terms(JV._pixel_features(fg_j)[:, None],
                                        hf, params.inlier_thresh), -1)
    fg_t = TV.sample_foreground(torch.tensor(np.asarray(mask_j)),
                                torch.tensor(np.asarray(ver_j)),
                                params.max_num, noise=noise_t)
    for got, want in zip(fg_t, fg_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hyps_t = TV.generate_hypotheses(fg_t, params.hyp_num, pair_u=pair_t)
    np.testing.assert_array_equal(hyps_t.numpy(), np.asarray(hyps_j))
    np.testing.assert_array_equal(
        TV.count_inliers(fg_t, hyps_t, params.inlier_thresh).numpy(),
        np.asarray(counts_j))

    # (2) the whole port, its own FCN included
    est = TPL.estimate_poses(model, torch.tensor(images), pts3d, K, params,
                             noise=noise_t, pair_u=pair_t)
    mask_t, _ = TPL.predict_fields(model, torch.tensor(images))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(est.fg_pixels.numpy(),
                                  np.asarray(mask_j).reshape(b, -1).sum(1))
    # Equal masks and draws select the same pixels, but the fields differ
    # by ~1e-6 (convolution summation order) and the JAX counts come from a
    # kernel that may round differently (see (1)). On a learned field many
    # hypotheses tie on their inlier count, so one boundary pixel can hand
    # the argmax to a neighbouring hypothesis whose refined point lies up
    # to ~1 px away. At this 4x downscale (fx ~ 143 px) 1 px on one of 9
    # keypoints moves the depth by ~1 %, ~5 mm at 0.5 m. Tolerance: 80 % of
    # the keypoints within 0.05 px, all within 2 px; poses within 1 deg
    # and 15 mm.
    err = np.linalg.norm(est.kps.numpy() - np.asarray(kps_j), axis=-1)
    assert (err < 5e-2).mean() >= 0.8 and err.max() < 2.0, err
    assert _rot_err(est.pose, pose_j).max() < 1.0
    np.testing.assert_allclose(est.pose[..., 3].numpy(), pose_j[..., 3],
                               atol=1.5e-2)


def _rot_err(pose_t, pose_np):
    return rotation_angle_deg(pose_t[..., :3],
                              torch.tensor(pose_np[..., :3])).numpy()


@pytest.fixture(scope="module")
def crop_views():
    """A 120x160 crop of the 480x640 fixture around both objects (the
    model sees them at the scale it was trained at; a 120x160 render
    leaves view 0 with 7 foreground pixels), K shifted to the crop. The
    packed lattice is 60x80, so selection pads 60 rows to 64."""
    y0, x0 = 216, 232
    with np.load(DEFAULT_OUT) as z:
        K = z["K"].copy()
        K[0, 2] -= x0
        K[1, 2] -= y0
        return {"images": z["images"][:, y0:y0 + 120, x0:x0 + 160],
                "points_3d": z["points_3d"], "K": K, "poses": z["poses"]}


@pytest.mark.parametrize("uncertainty", [False, True])
def test_packed_slice_matches_jax_run_fused(crop_views, uncertainty):
    v = crop_views
    params = TPL.VoteParams()
    images = ((v["images"].astype(np.float32) / 255.0 - IMAGENET_MEAN)
              / IMAGENET_STD).astype(np.float32)
    b, h, w, _ = images.shape
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    fmodel = build_flax("resnet18_8s", ver_dim=18)
    key = jax.random.PRNGKey(11)
    run = jax.jit(JPL.make_pose_pipeline(
        fmodel.apply, v["points_3d"], v["K"], params,
        uncertainty=uncertainty, fused_tail=True, tail_depth=3,
        tail_dtype=jnp.float32))
    pose_j, kps_j = (np.asarray(t) for t in run(variables,
                                                jnp.asarray(images), key))
    # run_fused's draws: split(key, 3) -> selection, pairs, covariance
    k0, k1, k2 = jax.random.split(key, 3)
    fg_j = JPL.fused_tail_foreground(fmodel.apply, variables,
                                     jnp.asarray(images), params.max_num,
                                     k0, dtype=jnp.float32, tail_depth=3)

    def u(k, shape):
        return torch.tensor(np.asarray(jax.random.uniform(k, shape,
                                                          jnp.float32)))

    est = TPL.estimate_poses(
        load_model(CKPT, 9, "cpu"), torch.tensor(images),
        torch.tensor(v["points_3d"]), torch.tensor(v["K"]), params,
        noise=u(k0, (b, h // 2, w // 2)),
        pair_u=u(k1, (b, params.hyp_num, 2)),
        cov_pair_u=u(k2, (b, params.uncertainty_hyp_num, 2)),
        uncertainty=uncertainty, fused_tail=True, tail_depth=3,
        tail_dtype=torch.float32)
    np.testing.assert_array_equal(est.fg_pixels.numpy(),
                                  np.asarray(fg_j.total))
    assert (est.fg_pixels.numpy() > 1000).all()
    # the tolerance of test_slice_matches_jax_composition, for its reasons
    err = np.linalg.norm(est.kps.numpy() - kps_j, axis=-1)
    assert (err < 5e-2).mean() >= 0.8 and err.max() < 2.0, err
    assert _rot_err(est.pose, pose_j).max() < 1.0
    np.testing.assert_allclose(est.pose[..., 3].numpy(), pose_j[..., 3],
                               atol=1.5e-2)
    # and both near the ground truth of the well-visible view 0
    assert _rot_err(est.pose[:1], v["poses"][:1]).max() < 5.0
    assert np.abs(pose_j[0, :, 3] - v["poses"][0, :, 3]).max() < 0.05


def test_run_closure_shapes_and_determinism(small_views):
    model = load_model(CKPT, 9, "cpu")
    images = TPL.normalize_images(torch.tensor(small_views["images"]))
    run = TPL.make_pose_pipeline(model, small_views["points_3d"],
                                 small_views["K"],
                                 TPL.VoteParams(hyp_num=64, max_num=64))
    pose1, kps1 = run(images, torch.Generator().manual_seed(0))
    pose2, kps2 = run(images, torch.Generator().manual_seed(0))
    assert pose1.shape == (2, 3, 4) and kps1.shape == (2, 9, 2)
    assert torch.isfinite(pose1).all()
    assert torch.equal(pose1, pose2) and torch.equal(kps1, kps2)


def test_run_closure_places_its_constants_where_the_model_is(small_views,
                                                            monkeypatch):
    # without ``device`` the keypoints and K go to the model's device: a
    # model on the meta device must meet meta constants, not CPU ones
    model = load_model(CKPT, 9, "cpu").to("meta")
    seen = {}

    def fake_estimate(model_, images, points_3d, K, *args, **kwargs):
        seen["devices"] = (points_3d.device, K.device)
        return TPL.PoseEstimate(None, None, None)

    monkeypatch.setattr(TPL, "estimate_poses", fake_estimate)
    run = TPL.make_pose_pipeline(model, small_views["points_3d"],
                                 small_views["K"])
    run(torch.zeros(1, 8, 8, 3, device="meta"))
    assert seen["devices"] == (torch.device("meta"), torch.device("meta"))


@pytest.mark.parametrize("uncertainty", [False, True])
def test_packed_run_closure_shapes_and_determinism(crop_views, uncertainty):
    model = load_model(CKPT, 9, "cpu")
    images = TPL.normalize_images(torch.tensor(crop_views["images"]))
    run = TPL.make_pose_pipeline(
        model, crop_views["points_3d"], crop_views["K"],
        TPL.VoteParams(hyp_num=64, max_num=64, uncertainty_hyp_num=128),
        uncertainty=uncertainty, fused_tail=True, tail_depth=3)
    pose1, kps1 = run(images, torch.Generator().manual_seed(0))
    pose2, kps2 = run(images, torch.Generator().manual_seed(0))
    assert pose1.shape == (2, 3, 4) and kps1.shape == (2, 9, 2)
    assert torch.isfinite(pose1).all()
    assert torch.equal(pose1, pose2) and torch.equal(kps1, kps2)


def test_fixture_regenerates_from_seed():
    with np.load(DEFAULT_OUT) as z:
        stored = {k: z[k] for k in z.files}
    fresh = make_views()
    assert set(stored) == set(fresh)
    for k in ("poses", "points_3d", "K"):
        np.testing.assert_array_equal(stored[k], fresh[k], err_msg=k)
    np.testing.assert_array_equal(stored["images"], fresh["images"])
    assert stored["images"].shape == (2, 480, 640, 3)
    assert (stored["masks"].reshape(2, -1).sum(1) > 1000).all()


_BLOCKED = ("jax", "flax", "msgpack", "PIL", "pvnet_tpu")


def _run_blocked(code, cwd):
    prelude = ("import sys\n"
               f"for m in {_BLOCKED!r}: sys.modules[m] = None\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_port_imports_and_infers_without_jax(tmp_path):
    with np.load(DEFAULT_OUT) as z:
        pts = z["points_3d"]
        imgs = z["images"][:, :64, :96]
    np.savez(tmp_path / "views.npz", images=imgs, points_3d=pts)
    out = tmp_path / "poses.jsonl"
    out3 = tmp_path / "poses_packed.jsonl"
    argv = (f"['infer', '--checkpoint', {CKPT!r}, '--points_3d',"
            f" {str(tmp_path / 'views.npz')!r}, '--images',"
            f" {str(tmp_path / 'views.npz')!r}, '--device', 'cpu',"
            " '--batch', '1', '--output', ")
    # and the evaluation entry: --test_model on a 4-image split (its test
    # half, 2 images at 480x640, generated, cached and evaluated)
    test_model = ["train", "--test_model", "--synthetic",
                  "--synthetic_images", "4", "--synthetic_occluder_prob",
                  "0.5", "--synthetic_clutter", "2", "--init", CKPT,
                  "--device", "cpu", "--data_dir", str(tmp_path / "data"),
                  "--model_dir", str(tmp_path / "model")]
    code = (
        "import runpy\n"
        "import pvnet_tpu_torch.ops.voting, pvnet_tpu_torch.ops.pnp\n"
        "import pvnet_tpu_torch.pipeline, pvnet_tpu_torch.infer\n"
        "import pvnet_tpu_torch.eval, pvnet_tpu_torch.data.synthetic\n"
        f"argv = {argv}{str(out3)!r}, '--tail_depth', '3',"
        " '--uncertainty']\n"
        "assert pvnet_tpu_torch.infer.main(argv[1:]) == 0\n"
        f"sys.argv = {test_model!r}\n"
        "try:\n"
        "    runpy.run_module('pvnet_tpu_torch.train', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"sys.argv = {argv}{str(out)!r}]\n"
        "runpy.run_module('pvnet_tpu_torch.infer', run_name='__main__')\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rates = json.loads(next(line for line in proc.stdout.splitlines()
                            if line.startswith('{"images"')))
    assert rates["images"] == 2 and rates["dtype"] == "bf16"
    assert all(0.0 <= rates[k] <= 1.0 for k in ("proj", "add", "cm"))
    assert list((tmp_path / "data").glob("synthetic_duck_4_*.npz"))
    for path in (out, out3):
        rows = [json.loads(line) for line in path.read_text().splitlines()]
        assert len(rows) == 2
        for row in rows:
            assert set(row) == {"path", "pose", "kps", "fg_pixels"}
            assert np.isfinite(np.asarray(row["pose"])).all()
            assert np.asarray(row["pose"]).shape == (3, 4)
            assert np.asarray(row["kps"]).shape == (9, 2)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    proc = _run_blocked(
        "import runpy\n"
        f"runpy.run_path({os.path.join(REPO, 'chip_smoke.py')!r},"
        " run_name='__main__')\n", tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
