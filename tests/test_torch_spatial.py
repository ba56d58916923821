"""The port's spatial partitioning (pvnet_tpu_torch/parallel/spatial.py)
on 4 gloo CPU ranks (tests/_parallel_worker.py ``spatial``: one pool of
ranks for the module), held against the JAX package's
make_spatial_field_fn / make_spatial_pose_pipeline on its 8-device CPU
mesh (tests/conftest.py), from the same weights
(utils/weights.state_dict_from_flax) and JAX's draws.

Shapes: tests/test_spatial.py's randomly initialized resnet18_8s on 2
images of 64x64 (4 shards of 16 rows: at stride 8 a shard holds 2 rows,
so layer 4's dilation-4 halo spans two shards), and the duck checkpoint
on tests/test_torch_pipeline.py's fixture cropped to 128x160 (2 views
tiled to 4) on a 2x2 data x sp mesh."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _parallel_worker import spawn
from pvnet_tpu import pipeline as JPL
from pvnet_tpu.config import IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import voting as JV
from pvnet_tpu.parallel.mesh import make_mesh
from pvnet_tpu.parallel.spatial import (make_spatial_field_fn as
                                        j_field_fn)
from pvnet_tpu.parallel.spatial import (make_spatial_pose_pipeline as
                                        j_pose_pipeline)
from pvnet_tpu_torch import pipeline as TPL
from pvnet_tpu_torch.infer import load_model
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.ops.geometry import rotation_angle_deg
from pvnet_tpu_torch.parallel import (make_spatial_field_fn,
                                      make_spatial_mesh,
                                      make_spatial_pose_pipeline)
from pvnet_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_eval import _jax_draws
from tools.make_torch_fixture import DEFAULT_OUT

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
CROP = (212, 232, 128, 160)        # y0, x0, h, w
TILE = np.array([0, 1, 0, 1])
# a mask pixel may differ where the unsharded logits tie within this
NEAR_TIE = 1e-4


def _port_vertex(ver_nhwc):
    """JAX's NHWC head field [b, h, w, vn, 2] as the port's [b, vn*2, h,
    w]."""
    v = np.asarray(ver_nhwc)
    b, h, w = v.shape[:3]
    return v.reshape(b, h, w, -1).transpose(0, 3, 1, 2)


def _crop():
    y0, x0, h, w = CROP
    with np.load(DEFAULT_OUT) as z:
        K = z["K"].copy()
        K[0, 2] -= x0
        K[1, 2] -= y0
        views = z["images"][:, y0:y0 + h, x0:x0 + w]
        pts, poses = z["points_3d"], z["poses"]
    imgs = ((views[TILE].astype(np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD).astype(np.float32)
    return imgs, pts, K, poses[TILE]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's spatial functions on the 8-device mesh and the port's on 4
    gloo ranks, from the same weights, images and draws."""
    fmodel = build_flax("resnet18_8s", ver_dim=18)
    variables = jax.jit(lambda k, x: fmodel.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    x64 = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    jax_out = {"field64": j_field_fn(make_mesh((8,), ("sp",)),
                                     fmodel.apply)(variables,
                                                   jnp.asarray(x64))}

    crop, pts, K, gt = _crop()
    with open(CKPT, "rb") as f:
        duck = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    mesh = make_mesh((2, 4), ("data", "sp"))
    jax_out["field128"] = j_field_fn(mesh, fmodel.apply, data_axis="data")(
        duck, jnp.asarray(crop))
    params = JPL.VoteParams()
    key = jax.random.PRNGKey(11)
    b, h, w, _ = crop.shape
    draws = {}
    # JAX's 'auto' selection is top-k off the TPU; the port's is
    # stratified (tests/test_torch_parallel.py does the same)
    with pytest.MonkeyPatch.context() as mp:
        orig = JV.sample_foreground
        mp.setattr(JV, "sample_foreground", lambda *a, **k: orig(
            *a, **dict(k, method="stratified")))
        for unc in (False, True):
            fn = j_pose_pipeline(mesh, fmodel.apply, pts, K, params,
                                 uncertainty=unc, data_axis="data")
            jax_out[f"pipeline_{unc}"] = tuple(
                np.asarray(t) for t in fn(duck, jnp.asarray(crop), key))
            # the draws of the plain path's fwd (tail_depth 0) under key
            draws[f"draws_{unc}"] = _jax_draws([key], unc, 0, params)(
                0, b, h, w)

    inp = {"sd": state_dict_from_flax(variables),
           "images64": torch.from_numpy(x64), "ckpt": CKPT,
           "crop": torch.from_numpy(crop), "points_3d": pts, "K": K,
           **draws}
    tmp = tmp_path_factory.mktemp("spatial")
    inp_path, out_path = str(tmp / "in.pt"), str(tmp / "out.pt")
    torch.save(inp, inp_path)
    spawn("spatial", 4, inp_path, out_path)
    port = torch.load(out_path, weights_only=False)
    return {"jax": jax_out, "port": port, "inp": inp, "gt": gt}


def _unsharded(model, images):
    with torch.no_grad():
        return model(torch.as_tensor(images).permute(0, 3, 1, 2)
                     .contiguous())


def _masks_equal_but_near_ties(mask, want, seg):
    """``mask`` equals ``want`` except where the unsharded logits ``seg``
    [b, 2, h, w] of the two classes lie within NEAR_TIE; returns the
    count of such pixels."""
    diff = mask != want
    gap = (seg[:, 0] - seg[:, 1]).abs().numpy()
    assert (gap[diff] < NEAR_TIE).all(), gap[diff]
    return int(diff.sum())


def _fields_match(got, want_mask, want_ver, seg):
    mask, ver = (t.numpy() for t in got)
    _masks_equal_but_near_ties(mask, np.asarray(want_mask), seg)
    np.testing.assert_allclose(ver, _port_vertex(want_ver), rtol=1e-4,
                               atol=1e-4)


def _random_model(run, **kw):
    model = build_model("resnet18_8s", ver_dim=18, **kw)
    model.load_state_dict(run["inp"]["sd"])
    return model.eval()


def test_fields_over_4_shards_match_jax(run):
    """64x64 over 4 sp ranks (halos that span two shards at stride 8)
    against JAX's row-sharded forward over 8 devices: masks equal but for
    near-ties, vertex within tests/test_spatial.py's 1e-4."""
    seg, _ = _unsharded(_random_model(run), run["inp"]["images64"])
    _fields_match(run["port"]["field64"], *run["jax"]["field64"], seg)


def test_fields_on_a_2x2_mesh_match_jax(run):
    """The duck checkpoint on the 128x160 crop, 2 data groups of 2 sp
    ranks, against JAX's (2, 4) data x sp mesh."""
    seg, _ = _unsharded(load_model(CKPT, 9, "cpu"), run["inp"]["crop"])
    _fields_match(run["port"]["field128"], *run["jax"]["field128"], seg)
    assert (run["port"]["field128"][0] != 0).sum() > 1000


def test_packed4_stem_over_2_shards_matches_jax(run):
    """The packed4 stem (the conv7 kernel folded) on the 2x2 mesh: its
    (2, 1) padding comes from the stem module like any convolution's."""
    seg, _ = _unsharded(_random_model(run), run["inp"]["images64"])
    _fields_match(run["port"]["packed64"], *run["jax"]["field64"], seg)


def test_dynamic_int8_sharded_equals_unsharded(run):
    """Every stage and the decoder in dynamic int8: each image's
    activation scale is the maximum over all shards, so the sharded
    forward equals the unsharded port's (vertex within 1e-4 of the
    field's scale; float rounding before a quantization can move a code by
    one)."""
    mask, ver = run["port"]["int8"]
    seg, want = run["port"]["int8_one"]
    _masks_equal_but_near_ties(mask.numpy(), seg.argmax(1).numpy(), seg)
    err = (ver - want).abs().max() / want.abs().max()
    assert err < 1e-4, err


def test_refuses_heights_that_do_not_split(run):
    """72 rows over 4 shards: H % (8*4) != 0, and the message names the
    least valid height."""
    msg = run["port"]["refusal"]
    assert "72" in msg and "32" in msg and "96" in msg, msg


@pytest.mark.parametrize("uncertainty", [False, True])
def test_pipeline_on_a_2x2_mesh_matches_jax(run, uncertainty):
    """make_spatial_pose_pipeline on the 2x2 mesh with JAX's draws against
    JAX's on the (2, 4) mesh: keypoints and poses within
    tests/test_spatial.py's 1e-2, and the visible view near its ground
    truth."""
    pose, kps = (t.numpy() for t in
                 run["port"][f"pipeline_{uncertainty}"])
    pose_j, kps_j = run["jax"][f"pipeline_{uncertainty}"]
    np.testing.assert_allclose(kps, kps_j, atol=1e-2)
    np.testing.assert_allclose(pose, pose_j, atol=1e-2)
    rot = rotation_angle_deg(torch.from_numpy(pose[::2, :, :3]),
                             torch.from_numpy(run["gt"][::2, :, :3]))
    assert rot.max() < 5.0, rot


def test_world_size_one_equals_unsharded_bit_for_bit(run):
    """Without a process group the mesh is 1x1: the field function is
    predict_fields and the pipeline estimate_poses, bit for bit."""
    mesh = make_spatial_mesh(device="cpu")
    assert (mesh.data.size, mesh.sp.size) == (1, 1)
    model = load_model(CKPT, 9, "cpu")
    crop = run["inp"]["crop"]
    mask, ver = make_spatial_field_fn(mesh, model)(crop)
    mask1, ver1 = TPL.predict_fields(model, crop)
    assert torch.equal(mask, mask1) and torch.equal(ver, ver1)
    draws = run["inp"]["draws_True"]
    pts, K = run["inp"]["points_3d"], run["inp"]["K"]
    pose, kps = make_spatial_pose_pipeline(mesh, model, pts, K,
                                           uncertainty=True)(
        crop, draws=draws)
    est = TPL.estimate_poses(model, crop, torch.from_numpy(pts),
                             torch.from_numpy(K), uncertainty=True, **draws)
    assert torch.equal(pose, est.pose) and torch.equal(kps, est.kps)
