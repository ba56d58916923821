"""Pose evaluation of the port against the JAX package on the CPU: the
metrics, the accumulating Evaluator, PnP with per-image intrinsics, and
the whole evaluation slice (TrainLoop.validate: loss meters, FCN, voting,
PnP, metrics) on generated images with JAX's own draws."""
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pvnet_tpu.config import (IMAGENET_MEAN, IMAGENET_STD, LINEMOD_K,
                              PathConfig)
from pvnet_tpu.config import TrainConfig as JTrainConfig
from pvnet_tpu.eval import metrics as JM
from pvnet_tpu.eval.evaluator import Evaluator as JEvaluator
from pvnet_tpu.eval.evaluator import ObjectMeta as JObjectMeta
from pvnet_tpu.ops import geometry as JG
from pvnet_tpu.ops import voting as JV
from pvnet_tpu.train import trainer as JT
from pvnet_tpu.train.loop import TrainLoop as JTrainLoop
from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.data import synthetic as TS
from pvnet_tpu_torch.data.dataset import eval_batches
from pvnet_tpu_torch.eval import Evaluator, ObjectMeta
from pvnet_tpu_torch.eval import metrics as TM
from pvnet_tpu_torch.ops import geometry as TG
from pvnet_tpu_torch.ops import pnp as TP
from pvnet_tpu_torch.pipeline import VoteParams
from pvnet_tpu_torch.train import trainer as TT
from pvnet_tpu_torch.train.loop import TrainLoop

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")
FIXTURE = os.path.join(REPO, "assets", "duck_views_480x640.npz")


def _random_poses(rng, n):
    w = rng.normal(0, 1.2, (n, 3))
    R = TG.rodrigues(torch.tensor(w, dtype=torch.float32)).numpy()
    t = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(0.4, 0.9, n)], -1)
    return np.concatenate([R, t[..., None]], -1).astype(np.float32)


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


@pytest.fixture(scope="module")
def meshes():
    rng = np.random.RandomState(0)
    model = rng.normal(0, 0.05, (300, 3)).astype(np.float32)
    pp = _random_poses(rng, 5)
    pg = _random_poses(rng, 5)
    Ks = np.stack([LINEMOD_K * np.float32(s) for s in (1, 1, .5, 2, 1)])
    Ks[:, 2, 2] = 1
    return model, pp, pg, Ks


def test_metrics_match_jax(meshes):
    """Each metric within 1e-5 relative of JAX's, batched over poses and
    per-pose K."""
    model, pp, pg, Ks = meshes
    t = [torch.tensor(x) for x in (model, pp, pg, Ks)]
    j = [jnp.asarray(x) for x in (model, pp, pg, Ks)]
    _close(TM.add_error(t[1], t[2], t[0]), JM.add_error(j[1], j[2], j[0]))
    _close(TM.projection_error(t[1], t[2], t[0], t[3]),
           JM.projection_error(j[1], j[2], j[0], j[3]))
    for tile in (4096, 64):       # dense, and tiled with a padded last tile
        _close(TM.add_error_sym(t[1], t[2], t[0], tile=tile),
               JM.add_error_sym(j[1], j[2], j[0], tile=tile))
        _close(TM.projection_error_sym(t[1], t[2], t[0], t[3], tile=tile),
               JM.projection_error_sym(j[1], j[2], j[0], j[3], tile=tile))
    for a, b in zip(TM.cm_degree_errors(t[1], t[2]),
                    JM.cm_degree_errors(j[1], j[2])):
        _close(a, b)


@pytest.mark.parametrize("n_ref,tile", [(300, 4096), (300, 64), (256, 64)])
def test_nearest_point_distance_branches(n_ref, tile):
    """Both branches against JAX's and against a float64 brute force."""
    rng = np.random.RandomState(n_ref + tile)
    ref = rng.normal(0, 1, (2, n_ref, 3)).astype(np.float32)
    que = rng.normal(0, 1, (2, 50, 3)).astype(np.float32)
    got = TG.find_nearest_point_distance(torch.tensor(ref), torch.tensor(que),
                                         tile=tile).numpy()
    _close(got, JG.find_nearest_point_distance(jnp.asarray(ref),
                                               jnp.asarray(que), tile=tile))
    brute = np.sqrt(((que[:, :, None].astype(np.float64)
                      - ref[:, None]) ** 2).sum(-1).min(-1))
    _close(got, brute)


def test_pnp_takes_one_K_per_image():
    """K [b, 3, 3] through the same code equals per-image solves."""
    with np.load(FIXTURE) as z:
        pts = z["points_3d"]
    rng = np.random.RandomState(1)
    poses = _random_poses(rng, 4)
    Ks = np.stack([LINEMOD_K * np.float32(s) for s in (1, .5, 2, .75)])
    Ks[:, 2, 2] = 1
    kps = TG.project(torch.tensor(pts), torch.tensor(poses),
                     torch.tensor(Ks)) + torch.tensor(
        rng.normal(0, 1.0, (4, 9, 2)), dtype=torch.float32)
    w3 = torch.tensor(rng.uniform(0.2, 1, (4, 9, 3)), dtype=torch.float32)
    w3[..., 1] *= 0.1
    pts_t, Ks_t = torch.tensor(pts), torch.tensor(Ks)
    batched = TP.pnp_batch(pts_t, kps, Ks_t)
    ubatched = TP.uncertainty_pnp_batch(kps, w3, pts_t, Ks_t)
    for i in range(4):
        one = TP.pnp_batch(pts_t, kps[i:i + 1], Ks_t[i])
        uone = TP.uncertainty_pnp_batch(kps[i:i + 1], w3[i:i + 1], pts_t,
                                        Ks_t[i])
        np.testing.assert_allclose(batched[i].numpy(), one[0].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(ubatched[i].numpy(), uone[0].numpy(),
                                   rtol=0, atol=1e-5)
    rot = TG.rotation_angle_deg(batched[:, :, :3],
                                torch.tensor(poses[:, :, :3]))
    assert rot.max() < 5.0


def _meta(symmetric):
    with np.load(FIXTURE) as z:
        pts = z["points_3d"]
    md = TS.object_metadata(TS.make_duck_mesh())
    return dict(points_3d=pts, model_pts=md["model_pts"],
                diameter=float(md["diameter"]), symmetric=symmetric,
                name="glue" if symmetric else "duck")


def _observations(n=40, seed=2):
    """n GT poses, per-image K, noisy keypoints (some far off, so that
    every metric has passes and failures) and covariances (two of them
    degenerate, which the uncertainty solver must weight 0)."""
    rng = np.random.RandomState(seed)
    with np.load(FIXTURE) as z:
        pts = z["points_3d"]
    poses = _random_poses(rng, n)
    Ks = np.stack([LINEMOD_K * np.float32(rng.uniform(0.7, 1.3))
                   for _ in range(n)])
    Ks[:, 2, 2] = 1
    kps = TG.project(torch.tensor(pts), torch.tensor(poses),
                     torch.tensor(Ks)).numpy()
    sigma = np.where(np.arange(n) % 3 == 0, 12.0, 1.5)[:, None, None]
    kps = (kps + rng.normal(0, 1, kps.shape) * sigma).astype(np.float32)
    a = rng.normal(0, 2, (n, 9, 2, 2))
    cov = (a @ a.transpose(0, 1, 3, 2) + 0.5 * np.eye(2)).astype(np.float32)
    cov[3, 2] = 0.0
    cov[7, 5, 0, 0] = np.nan
    return kps, cov, poses, Ks


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("uncertainty", [False, True])
def test_evaluator_matches_jax(symmetric, uncertainty):
    """40 images (past one flush of 32), per-image K: per image for the
    first 8, batched for the rest. Pass/fail lists and rates equal; ADD
    within 1e-4 m and 2D projection within 1e-2 px (measured 2.6e-5 m and
    7.5e-3 px: float32 PnP in two frameworks, on keypoints up to 12 px
    off, ends its 16 LM iterations up to ~1e-5 apart; on equal poses the
    metrics agree to 1e-5 relative, test_metrics_match_jax)."""
    kps, cov, poses, Ks = _observations()
    meta = _meta(symmetric)
    ev, jev = Evaluator(ObjectMeta(**meta)), JEvaluator(JObjectMeta(**meta))
    for e in (ev, jev):
        for i in range(8):
            if uncertainty:
                e.evaluate_uncertainty(kps[i], cov[i], poses[i], Ks[i])
            else:
                e.evaluate(kps[i], poses[i], Ks[i])
        if uncertainty:
            e.evaluate_uncertainty_batch(kps[8:], cov[8:], poses[8:], Ks[8:])
        else:
            e.evaluate_batch(kps[8:], poses[8:], Ks[8:])
    assert len(ev._pending) == 40
    for name in ("add_recorder", "projection_2d_recorder",
                 "cm_degree_5_recorder"):
        got, want = getattr(ev, name), getattr(jev, name)
        assert got == want, name
        assert 0 < sum(got) < 40, name
    assert not ev._pending
    np.testing.assert_allclose(ev.add_dists, jev.add_dists, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(ev.proj_mean_diffs, jev.proj_mean_diffs,
                               rtol=0, atol=1e-2)
    assert ev.average_precision(False) == jev.average_precision(False)


def test_evaluator_records_external_poses_and_saves(tmp_path):
    meta = _meta(False)
    ev, jev = Evaluator(ObjectMeta(**meta)), JEvaluator(JObjectMeta(**meta))
    assert all(np.isnan(ev.average_precision(False)))
    _, _, poses, Ks = _observations()
    poses, Ks = poses[:6], Ks[:6]
    pred = poses.copy()
    pred[:, :, 3] += np.linspace(0, 0.06, 6)[:, None]
    for e in (ev, jev):
        for i in range(6):
            e.evaluate_pose(pred[i], poses[i], Ks[i])
    assert ev.average_precision(False) == jev.average_precision(False)
    path = ev.save_proj_diffs(str(tmp_path / "d.npy"))
    np.testing.assert_allclose(np.load(path), jev.proj_mean_diffs,
                               rtol=1e-5)


# --- the whole slice ------------------------------------------------------

HW = (240, 320)


@pytest.fixture(scope="module")
def split():
    """Four views at 240x320, K scaled to it as tools/make_torch_fixture.py
    does, rendered with the port's generator functions (occluders and
    clutter as the occluded split's), with the duck's metadata."""
    rng = np.random.RandomState(3)
    mesh = TS.make_duck_mesh()
    dm = [TS.make_distractor_mesh(rng) for _ in range(8)]
    K = LINEMOD_K.copy()
    K[0] *= HW[1] / 640.0
    K[1] *= HW[0] / 480.0
    images, masks, poses = [], [], []
    while len(images) < 4:
        pose = TS.sample_object_pose(rng, z_range=(0.4, 0.55))
        dist = TS.sample_distractors(pose, rng, dm, 0.5, 2)
        rgb, mask = TS.render_synthetic_view(mesh, pose, K, *HW, rng, dist)
        if mask.sum() > 800:       # the model sees a duck in every view
            images.append(rgb)
            masks.append(mask)
            poses.append(pose)
    out = {"images": np.stack(images), "masks": np.stack(masks),
           "poses": np.stack(poses), "K": np.stack([K] * 4)}
    out.update(TS.object_metadata(mesh))
    return out


def _jax_validate(split, uncertainty, tail_depth, tmp_path, monkeypatch):
    """JAX's TrainLoop.validate on the same arrays, f32: its eval_step, its
    eval_pipeline (the plain path's selection forced to 'stratified', the
    TPU's; off the TPU 'auto' picks top-k, which the port does not have),
    Evaluator with the per-image K. Returns the loss meters, the evaluator
    and each batch's key."""
    orig = JV.sample_foreground
    monkeypatch.setattr(JV, "sample_foreground", lambda *a, **k: orig(
        *a, **dict(k, method="stratified")))
    cfg = JTrainConfig.from_json(RECIPE)
    cfg.bf16, cfg.test_batch_size = False, 2
    loop = JTrainLoop(cfg, "duck", paths=PathConfig(data_dir=str(tmp_path)),
                      use_mesh=False)
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    state = SimpleNamespace(apply_fn=loop.model.apply, **variables)
    meta = JObjectMeta(points_3d=split["points_3d"],
                       model_pts=split["model_pts"],
                       diameter=float(split["diameter"]))
    ev = JEvaluator(meta)
    eval_loss = jax.jit(lambda p, s, batch: JT.eval_step(
        SimpleNamespace(apply_fn=loop.model.apply, params=p,
                        batch_stats=s), batch))
    key = jax.random.PRNGKey(0)
    keys, meters = [], []
    for bidx in range(2):
        sl = slice(2 * bidx, 2 * bidx + 2)
        image = ((split["images"][sl].astype(np.float32) / 255.0
                  - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)
        mask = split["masks"][sl].astype(np.int32)
        batch = next(eval_batches({k: (v[sl] if k in ("images", "masks",
                                                        "poses", "K")
                                       else v) for k, v in split.items()},
                                  2))
        dev = {"image": jnp.asarray(image), "mask": jnp.asarray(mask),
               "hcoords": jnp.asarray(batch["hcoords"]),
               "vertex_weights": jnp.asarray(
                   mask[..., None].astype(np.float32))}
        meters.append({k: float(v) for k, v in eval_loss(
            state.params, state.batch_stats, dev).items()})
        fwd = loop.eval_pipeline(HW, 2, uncertainty, tail_depth=tail_depth)
        key = jax.random.fold_in(key, bidx)
        keys.append(key)
        if uncertainty:
            mean, cov = fwd(variables, jnp.asarray(image), key)
            ev.evaluate_uncertainty_batch(np.asarray(mean), np.asarray(cov),
                                          batch["pose"], batch["K"])
        else:
            ev.evaluate_batch(np.asarray(fwd(variables, jnp.asarray(image),
                                             key)), batch["pose"], batch["K"])
    return meters, ev, keys


def _jax_draws(keys, uncertainty, tail_depth, params):
    """JAX's draws of each batch, in the port's keyword form: the splits
    of eval_pipeline's fwd (ransac_voting_v3 / keypoints_with_covariance /
    fused_tail_foreground)."""
    def u(k, shape):
        return torch.tensor(np.asarray(jax.random.uniform(k, shape,
                                                          jnp.float32)))

    def draws(bidx, b, h, w):
        key = keys[bidx]
        if tail_depth > 0:
            k0, k1, k2 = jax.random.split(key, 3)
            d = {"noise": u(k0, (b, h // 2, w // 2)),
                 "pair_u": u(k1, (b, params.hyp_num, 2))}
            if uncertainty:
                d["cov_pair_u"] = u(k2, (b, params.uncertainty_hyp_num, 2))
            return d
        vote_key, cov_key = jax.random.split(key) if uncertainty \
            else (key, None)
        k1, k2 = jax.random.split(vote_key)
        d = {"noise": u(k1, (b, h, w)), "pair_u": u(k2, (b, params.hyp_num,
                                                          2))}
        if uncertainty:
            k3, k4 = jax.random.split(cov_key)
            d["cov_noise"] = u(k3, (b, h, w))
            d["cov_pair_u"] = u(k4, (b, params.uncertainty_hyp_num, 2))
        return d
    return draws


@pytest.mark.parametrize("tail_depth,uncertainty",
                         [(0, False), (0, True), (3, True)])
def test_validate_matches_jax(split, tail_depth, uncertainty, tmp_path,
                              monkeypatch):
    """Port validate vs JAX's, f32, 4 images in batches of 2, JAX's draws
    fed to the port. Rates and pass/fail lists equal; per-image keypoint-
    driven errors within test_torch_pipeline.py's tolerances for poses
    (1 deg, 15 mm: the fields differ by ~1e-6 and a boundary pixel can hand
    the vote to a neighbouring hypothesis) — here as ADD within 15 mm and
    2D projection within 2 px; the loss meters within
    test_torch_train_step.py's rtol 1e-4."""
    jmeters, jev, keys = _jax_validate(split, uncertainty, tail_depth,
                                       tmp_path, monkeypatch)
    cfg = TrainConfig.from_json(RECIPE)
    cfg.bf16, cfg.test_batch_size = False, 2
    loop = TrainLoop(cfg, str(tmp_path / "m"), device="cpu")
    state = loop.init_state(CKPT)
    ev = Evaluator(loop.object_meta(split))
    seen = []
    orig_eval_step = TT.eval_step

    def spy(*a, **k):
        m = orig_eval_step(*a, **k)
        seen.append({key: float(v) for key, v in m.items()})
        return m
    monkeypatch.setattr(TT, "eval_step", spy)
    losses = loop.validate(
        state, eval_batches(split, 2), 0, evaluate_pose=True,
        uncertainty=uncertainty, use_camera_intrinsic=True, evaluator=ev,
        tail_depth=tail_depth,
        draws=_jax_draws(keys, uncertainty, tail_depth, VoteParams()))
    assert len(seen) == len(jmeters) == 2
    for got, want in zip(seen, jmeters):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
    for name in ("add_recorder", "projection_2d_recorder",
                 "cm_degree_5_recorder"):
        assert getattr(ev, name) == getattr(jev, name), name
    assert sum(ev.add_recorder) >= 1          # a pose the model gets right
    rates = ev.average_precision(False)
    assert rates == jev.average_precision(False)
    assert [losses[f"val/scalar/{k}"] for k in
            ("projection_error", "add", "cm")] == list(rates)
    np.testing.assert_allclose(ev.add_dists, jev.add_dists, rtol=0,
                               atol=0.015)
    np.testing.assert_allclose(ev.proj_mean_diffs, jev.proj_mean_diffs,
                               rtol=0, atol=2.0)


def test_fit_validates_on_the_jax_schedule(tmp_path, monkeypatch):
    """eval_epoch with eval_inter 2 from epoch 1, val_inter 5, 3 epochs:
    loss-only validation at epoch 0 (val_inter), pose evaluation at epoch
    2, the last (eval_inter), none at epoch 1."""
    cfg = TrainConfig.from_json(RECIPE)
    cfg.eval_epoch, cfg.eval_inter, cfg.eval_epoch_begin = True, 2, 1
    cfg.val_inter, cfg.train_batch_size, cfg.resume = 5, 2, False
    loop = TrainLoop(cfg, str(tmp_path / "m"), device="cpu")
    monkeypatch.setattr(loop, "train_epoch_from_data",
                        lambda state, data, sampler, epoch, left:
                        (state, 1))
    calls = []
    monkeypatch.setattr(loop, "validate", lambda state, loader, epoch,
                        evaluate_pose, evaluator: calls.append(
                            (epoch, evaluate_pose, evaluator is not None,
                             len(list(loader)))))
    images = np.zeros((2, 48, 64, 3), np.uint8)
    val = {"images": np.zeros((3, 48, 64, 3), np.uint8),
           "masks": np.zeros((3, 48, 64), np.uint8),
           "poses": _random_poses(np.random.RandomState(0), 3),
           "K": LINEMOD_K, "points_3d": np.zeros((9, 3), np.float32),
           "model_pts": np.zeros((5, 3), np.float32), "diameter": 0.1}
    loop.fit(images, images[..., 0], np.zeros((2, 9, 3), np.float32),
             epochs=3, val=val)
    # test_batch_size 8 of the recipe: one batch of the 3 images
    assert calls == [(0, False, False, 1), (2, True, True, 1)]
