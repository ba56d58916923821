"""The packed4 stem of the port (models/resnet.py stem='packed4',
utils/weights.fold_stem_state_dict, pipeline.normalize_packed_u8, the
packed tail's packed-image term, raw_uint8) against the JAX package's
(pvnet_tpu/models/resnet.py, pipeline.normalize_packed_u8,
make_pose_pipeline(raw_uint8=True)), on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pvnet_tpu import pipeline as JPL
from pvnet_tpu.models import resnet as JR
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import pnp as JP
from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch import pipeline as TPL
from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.infer import load_model
from pvnet_tpu_torch.models import resnet as TR
from pvnet_tpu_torch.ops import packed_tail as TPT
from pvnet_tpu_torch.ops.geometry import rotation_angle_deg
from pvnet_tpu_torch.train import trainer as TT
from pvnet_tpu_torch.utils.weights import (fold_stem_state_dict,
                                           state_dict_from_flax)
from tools.make_torch_fixture import DEFAULT_OUT

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "duck_ckpt.msgpack")


@pytest.fixture(scope="module")
def crop():
    """A 120x160 uint8 crop of the fixture around both objects, K shifted
    to it (test_torch_pipeline.py's crop_views)."""
    y0, x0 = 216, 232
    with np.load(DEFAULT_OUT) as z:
        K = z["K"].copy()
        K[0, 2] -= x0
        K[1, 2] -= y0
        return {"images": z["images"][:, y0:y0 + 120, x0:x0 + 160].copy(),
                "points_3d": z["points_3d"], "K": K, "poses": z["poses"]}


@pytest.fixture(scope="module")
def flax_packed():
    """The duck checkpoint's variables with the stem folded by JAX's
    fold_stem_params."""
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    return variables, JR.fold_stem_params(variables)


def test_space_to_depth_round_trip_and_layouts():
    x = np.random.RandomState(0).randn(2, 8, 10, 3).astype(np.float32)
    t = torch.tensor(x)
    packed = TR.space_to_depth2(t)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JR.space_to_depth2(x)))
    assert torch.equal(TR.depth_to_space2(packed), t)
    # the channel-major forms are the same packing of an NCHW tensor
    cm = TR.space_to_depth2_cm(t.permute(0, 3, 1, 2))
    assert torch.equal(cm, packed.permute(0, 3, 1, 2))
    assert torch.equal(TR.depth_to_space2_cm(cm), t.permute(0, 3, 1, 2))


@pytest.mark.parametrize("cin,cout", [(3, 64), (2, 5)])
def test_fold_conv7_to_packed4_equals_jax(cin, cout):
    w7 = np.random.RandomState(cin).randn(7, 7, cin, cout).astype(np.float32)
    want = JR.fold_conv7_to_packed4(w7)                     # HWIO
    got = TR.fold_conv7_to_packed4(torch.tensor(w7).permute(3, 2, 0, 1))
    assert got.shape == (cout, 4 * cin, 4, 4)
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


def test_fold_stem_state_dict_equals_jax(flax_packed):
    variables, folded = flax_packed
    got = fold_stem_state_dict(state_dict_from_flax(variables))
    want = state_dict_from_flax(folded)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["resnet18_8s.conv1.weight"].shape == (64, 12, 4, 4)
    # an already folded state_dict passes through unchanged
    again = fold_stem_state_dict(got)
    assert all(again[k] is got[k] for k in got)


def test_packed4_model_against_jax_and_conv7(crop, flax_packed):
    _, folded = flax_packed
    x = TPL.normalize_images(torch.tensor(crop["images"]))
    fmodel = build_flax("resnet18_8s", ver_dim=18, stem="packed4")
    seg_j, ver_j = jax.jit(lambda v, a: fmodel.apply(v, a, train=False))(
        folded, jnp.asarray(x.numpy()))
    model4 = load_model(CKPT, 9, "cpu", stem="packed4")
    model7 = load_model(CKPT, 9, "cpu")
    xc = x.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        seg4, ver4 = model4(xc)
        seg7, ver7 = model7(xc)
        # a pre-packed input computes the identical function
        seg4p, ver4p = model4(TR.space_to_depth2_cm(xc))
    assert torch.equal(seg4p, seg4) and torch.equal(ver4p, ver4)
    for got, want in ((seg4, seg_j), (ver4, ver_j)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-4, atol=1e-4)
    # tests/test_packed_stem.py's tolerance, against the conv7 model
    for got, want in ((seg4, seg7), (ver4, ver7)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_normalize_packed_u8_against_jax():
    u8 = np.random.RandomState(3).randint(0, 256, (2, 6, 8, 3), np.uint8)
    t = torch.tensor(u8)
    got = TPL.normalize_packed_u8(t)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(JPL.normalize_packed_u8(u8)),
                               rtol=1e-6, atol=1e-6)
    # packing commutes with the per-channel normalization exactly
    assert torch.equal(got, TR.space_to_depth2(TPL.normalize_images(t)))
    # an already packed input is only normalized
    assert torch.equal(TPL.normalize_packed_u8(TR.space_to_depth2(t)), got)


def test_packed_tail_on_a_packed_image(crop):
    # the raw stage's image term as the refolded 3x3 on the packed image
    # (_fold_direct_to_packed3) equals the direct stride-2 4x4 on the
    # unpacked one, and the refold equals JAX's
    from pvnet_tpu.ops import packed_tail as JPT
    w4 = torch.randn(8, 3, 4, 4, generator=torch.Generator().manual_seed(4))
    w3 = TPT._fold_direct_to_packed3(w4)
    want = JPT._fold_direct_to_packed3(jnp.asarray(
        w4.permute(2, 3, 1, 0).numpy()))
    np.testing.assert_array_equal(w3.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(want))
    model = load_model(CKPT, 9, "cpu", stem="packed4")
    x = TPL.normalize_images(torch.tensor(crop["images"]))
    xc = x.permute(0, 3, 1, 2).contiguous()
    xp = TR.space_to_depth2_cm(xc)
    with torch.no_grad():
        feats = model(xp, return_8s_features=True)
        got = TPT.packed_tail_deep3_from_model(model, *feats, xp,
                                               dtype=torch.float32)
        want = TPT.packed_tail_deep3_from_model(model, *feats, xc,
                                                dtype=torch.float32)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert torch.equal(got[1], want[1])


def _u(key, shape):
    return torch.tensor(np.asarray(jax.random.uniform(key, shape,
                                                      jnp.float32)))


def _assert_poses_close(est, kps_j, pose_j):
    # test_torch_pipeline.py's tolerances (each side its own FCN): 80 % of
    # the keypoints within 0.05 px, all within 2 px; poses within 1 deg
    # and 15 mm
    err = np.linalg.norm(est.kps.numpy() - np.asarray(kps_j), axis=-1)
    assert (err < 5e-2).mean() >= 0.8 and err.max() < 2.0, err
    rot = rotation_angle_deg(est.pose[..., :3],
                             torch.tensor(np.asarray(pose_j)[..., :3]))
    assert rot.max() < 1.0
    np.testing.assert_allclose(est.pose[..., 3].numpy(),
                               np.asarray(pose_j)[..., 3], atol=1.5e-2)


def test_raw_uint8_fused_pipeline_matches_jax(crop, flax_packed):
    _, folded = flax_packed
    v = crop
    params = TPL.VoteParams()
    b, h, w, _ = v["images"].shape
    fmodel = build_flax("resnet18_8s", ver_dim=18, stem="packed4")
    key = jax.random.PRNGKey(11)
    run = jax.jit(JPL.make_pose_pipeline(
        fmodel.apply, v["points_3d"], v["K"], params, fused_tail=True,
        tail_depth=3, tail_dtype=jnp.float32, raw_uint8=True))
    pose_j, kps_j = run(folded, jnp.asarray(v["images"]), key)
    # run_fused's draws: split(key, 3) -> selection, pairs, covariance
    k0, k1, _ = jax.random.split(key, 3)
    fg_j = JPL.fused_tail_foreground(
        fmodel.apply, folded, JPL.normalize_packed_u8(v["images"]),
        params.max_num, k0, dtype=jnp.float32, tail_depth=3)
    est = TPL.estimate_poses(
        load_model(CKPT, 9, "cpu", stem="packed4"),
        torch.tensor(v["images"]), torch.tensor(v["points_3d"]),
        torch.tensor(v["K"]), params, noise=_u(k0, (b, h // 2, w // 2)),
        pair_u=_u(k1, (b, params.hyp_num, 2)), fused_tail=True,
        tail_depth=3, tail_dtype=torch.float32, raw_uint8=True)
    np.testing.assert_array_equal(est.fg_pixels.numpy(),
                                  np.asarray(fg_j.total))
    assert (est.fg_pixels.numpy() > 1000).all()
    _assert_poses_close(est, kps_j, pose_j)


def test_raw_uint8_plain_pipeline_matches_jax(crop, flax_packed):
    # JAX's plain path composed as the TPU runs it (stratified selection,
    # the Pallas count in interpret mode) on JAX's packed input; the port
    # through estimate_poses(raw_uint8=True) with JAX's draws
    _, folded = flax_packed
    v = crop
    params = TPL.VoteParams()
    b, h, w, _ = v["images"].shape
    fmodel = build_flax("resnet18_8s", ver_dim=18, stem="packed4",
                        head_layout="NCHW")
    mask_j, ver_j = JPL.predict_fields(
        fmodel.apply, folded, JPL.normalize_packed_u8(v["images"]))
    key = jax.random.PRNGKey(12)
    kps_j = JV.ransac_voting_v3(
        mask_j, ver_j, key, hyp_num=params.hyp_num,
        inlier_thresh=params.inlier_thresh, max_num=params.max_num,
        min_num=params.min_num, impl="pallas_interpret",
        select_method="stratified")
    pose_j = jax.jit(JP.pnp_batch)(jnp.asarray(v["points_3d"]), kps_j,
                                   jnp.asarray(v["K"]))
    k1, k2 = jax.random.split(key)
    model = load_model(CKPT, 9, "cpu", stem="packed4")
    est = TPL.estimate_poses(
        model, torch.tensor(v["images"]), torch.tensor(v["points_3d"]),
        torch.tensor(v["K"]), params, noise=_u(k1, (b, h, w)),
        pair_u=_u(k2, (b, params.hyp_num, 2)), raw_uint8=True)
    mask_t, _ = TPL.predict_fields(
        model, TPL.normalize_packed_u8(torch.tensor(v["images"])))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(est.fg_pixels.numpy(),
                                  np.asarray(mask_j).reshape(b, -1).sum(1))
    _assert_poses_close(est, kps_j, pose_j)
    # and the well-visible view 0 near its ground truth
    rot0 = rotation_angle_deg(est.pose[:1, :, :3],
                              torch.tensor(v["poses"][:1, :, :3]))
    assert rot0.max() < 5.0


def test_packed_stem_training_step_has_finite_gradients(crop):
    model = load_model(CKPT, 9, "cpu", stem="packed4").train()
    state = TT.create_train_state(model, TrainConfig())
    u8 = torch.tensor(crop["images"][:, :64, :96])
    b = u8.shape[0]
    mask = torch.zeros((b, 64, 96), dtype=torch.uint8)
    mask[:, 16:48, 24:72] = 1
    hcoords = torch.cat([torch.rand(b, 9, 2) * 64,
                         torch.ones(b, 9, 1)], -1)
    batch = {"image": TPL.normalize_images(u8).permute(0, 3, 1, 2)
             .contiguous(), "mask": mask, "hcoords": hcoords}
    before = model.resnet18_8s.conv1.weight.detach().clone()
    metrics = TT.train_step(state, batch)
    assert torch.isfinite(metrics["loss"])
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    stem = model.resnet18_8s.conv1.weight
    assert stem.shape == (64, 12, 4, 4) and stem.grad.abs().sum() > 0
    assert not torch.equal(stem.detach(), before)
