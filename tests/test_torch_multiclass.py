"""Multi-object inference and training of the port against pvnet_tpu's, on
fuse-style scenes: the box and cylinder meshes and the class-labelled
renders (bit for bit), the multi-class vertex targets, multi-class voting
in its three forms, the multi-class pose pipeline on a ground-truth
stand-in model, the one PnP over every (image, class) against a PnP per
class, one multi-class training step, and the symmetric ADD-S branch.

JAX's voting runs op by op (``jax.disable_jit()``; its compiled counts
may round at the cosine boundary unlike its op-by-op form, which the port
follows: ROADMAP fault F4). Integer results must be equal; float results
carry the tolerance stated at each test."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu import pipeline as JPL
from pvnet_tpu.config import LINEMOD_K
from pvnet_tpu.data import synthetic as JS
from pvnet_tpu.data.vertex import (
    compute_vertex_targets_multiclass as j_targets)
from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch import pipeline as TPL
from pvnet_tpu_torch.data import multiclass as TM
from pvnet_tpu_torch.data import synthetic as TS
from pvnet_tpu_torch.data.vertex import compute_vertex_targets_multiclass
from pvnet_tpu_torch.eval.evaluator import Evaluator
from pvnet_tpu_torch.ops import pnp as TP
from pvnet_tpu_torch.ops import voting as TV
from pvnet_tpu_torch.ops.geometry import rotation_angle_deg

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/tools")
import multiclass_study as MS  # noqa: E402

torch.set_num_threads(1)
H, W = 120, 160


def _K(h=H, w=W):
    K = LINEMOD_K.copy()
    K[0] *= w / 640.0
    K[1] *= h / 480.0
    return K.astype(np.float32)


@pytest.fixture(scope="module")
def split():
    """Two scenes of the port's generator at 120x160, and the JAX study's
    classes and metadata."""
    classes = TM.build_class_set()
    metas = [TM.class_meta(*c) for c in classes]
    images, masks, hcoords, poses = TM.generate_split(classes, metas, 2,
                                                      _K(), H, W, seed=3)
    return classes, metas, images, masks, hcoords, poses


@pytest.fixture
def jax_op_by_op():
    with jax.disable_jit():
        yield


def _t(x):
    return torch.tensor(np.asarray(x))


# --- scenes ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["make_box_mesh", "make_cylinder_mesh"])
def test_meshes_match_jax(name):
    want, got = getattr(JS, name)(), getattr(TS, name)()
    for f in ("vertices", "faces", "colors"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)


def test_split_and_meta_match_jax_study(split):
    _, metas, images, masks, hcoords, poses = split
    jc = MS.build_class_set()
    jm = [MS.class_meta(*c) for c in jc]
    for a, b in zip(jm, metas):
        assert (a.name, a.symmetric, a.diameter) == (b.name, b.symmetric,
                                                      b.diameter)
        np.testing.assert_array_equal(a.points_3d, b.points_3d)
        np.testing.assert_array_equal(a.model_pts, b.model_pts)
    want = MS.generate_split(jc, jm, 2, _K(), H, W, seed=3)
    for g, w in zip((images, masks, hcoords, poses), want):
        np.testing.assert_array_equal(g, w)
    for c in (1, 2, 3):                      # every class well visible
        assert ((masks == c).sum((1, 2)) > 40).all()


def test_render_multiclass_view_matches_jax(split):
    classes, _, _, _, _, poses = split
    mp = [(c[1], p) for c, p in zip(classes, poses[0])]
    want = JS.render_multiclass_view(mp, _K(), H, W,
                                     np.random.RandomState(7))
    got = TS.render_multiclass_view(mp, _K(), H, W, np.random.RandomState(7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# --- targets and voting --------------------------------------------------------

@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_vertex_targets_multiclass_match_jax(split, layout):
    _, _, _, masks, hcoords, _ = split
    want = np.asarray(j_targets(jnp.asarray(masks.astype(np.int32)),
                                jnp.asarray(hcoords)))      # NHWC
    got = compute_vertex_targets_multiclass(_t(masks), _t(hcoords),
                                            layout=layout).numpy()
    if layout == "NCHW":
        got = got.transpose(0, 2, 3, 1)
    # the same float32 operations per class: equal to 1 ulp
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got[masks == 0] == 0).all()


def _gt_field(masks, hcoords):
    """The ground-truth multi-class field, channel-major [b, 18, H, W]."""
    return compute_vertex_targets_multiclass(_t(masks), _t(hcoords))


def _class_draws(key, b, hn, C, method):
    """JAX's per-class draws of ransac_voting_multiclass: for each class
    key, sub = split(key), then v3/v2 split sub into (noise, pairs)."""
    noise, pair = [], []
    for _ in range(C):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        shape = (b, H, W) if method == "stratified" else (b, H * W)
        noise.append(np.asarray(jax.random.uniform(k1, shape, jnp.float32)))
        pair.append(np.asarray(jax.random.uniform(k2, (b, hn, 2),
                                                  jnp.float32)))
    return _t(np.stack(noise)), _t(np.stack(pair))


@pytest.mark.parametrize("refine_iter_num", [None, 2])
def test_multiclass_voting_matches_jax(jax_op_by_op, split,
                                       refine_iter_num):
    """JAX's own form: top-k selection (its 'auto' off the TPU), per-class
    key splits; v3, and v2 with 2 rounds."""
    _, _, _, masks, hcoords, _ = split
    field = _gt_field(masks, hcoords)
    key = jax.random.PRNGKey(2)
    want = np.asarray(JV.ransac_voting_multiclass(
        jnp.asarray(masks.astype(np.int32)), jnp.asarray(field.numpy()), key,
        class_num=4, hyp_num=128, max_num=256,
        refine_iter_num=refine_iter_num))
    noise, pair = _class_draws(key, 2, 128, 3, "topk")
    got = TV.ransac_voting_multiclass(
        _t(masks), field, 4, hyp_num=128, max_num=256,
        refine_iter_num=refine_iter_num, noise=noise, pair_u=pair,
        select_method="topk").numpy()
    assert got.shape == (2, 3, 9, 2)
    # the same winners; the refits sum in another order: 1e-3 px
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got, hcoords[..., :2], atol=0.1)


def test_multiclass_stratified_matches_jax_per_class(jax_op_by_op, split):
    """The port's default form (K1) against JAX's per-class
    ransac_voting_v3(select_method='stratified') with the same draws."""
    _, _, _, masks, hcoords, _ = split
    field = _gt_field(masks, hcoords)
    key = jax.random.PRNGKey(3)
    noise, pair = _class_draws(key, 2, 128, 3, "stratified")
    want, sub = [], key
    for c in (1, 2, 3):
        sub, k = jax.random.split(sub)
        want.append(np.asarray(JV.ransac_voting_v3(
            jnp.asarray((masks == c).astype(np.int32)),
            jnp.asarray(field.numpy()), k, hyp_num=128, max_num=256,
            select_method="stratified")))
    got = TV.ransac_voting_multiclass(_t(masks), field, 4, hyp_num=128,
                                      max_num=256, noise=noise,
                                      pair_u=pair).numpy()
    np.testing.assert_allclose(got, np.stack(want, 1), rtol=0, atol=1e-3)


class _StandIn(torch.nn.Module):
    """A model that returns one-hot * 10 logits and a given field."""

    def __init__(self, masks, field):
        super().__init__()
        onehot = torch.nn.functional.one_hot(masks.long(), 4)
        self.seg = onehot.permute(0, 3, 1, 2).float() * 10.0
        self.ver = field

    def forward(self, x):
        return self.seg, self.ver


def test_multiclass_pipeline_matches_jax(split):
    """make_multiclass_pose_pipeline on the ground-truth stand-in, as JAX's
    test_multiclass_pose_pipeline_api, within 0.05 deg / 1 mm of JAX's
    (jitted) pipeline with the same draws, and within 5 deg / 2 cm of the
    truth."""
    _, metas, _, masks, hcoords, poses = split
    field = _gt_field(masks, hcoords)
    pts = np.stack([m.points_3d for m in metas])
    params = dict(hyp_num=256, max_num=256)
    seg = jax.nn.one_hot(masks.astype(np.int32), 4) * 10.0
    ver = jnp.asarray(field.numpy().transpose(0, 2, 3, 1))

    def apply_fn(variables, image, train=False):
        return seg, ver

    key = jax.random.PRNGKey(2)
    run_j = jax.jit(JPL.make_multiclass_pose_pipeline(
        apply_fn, pts, _K(), params=JPL.VoteParams(**params)))
    want_p, want_k = (np.asarray(x) for x in run_j({}, jnp.zeros(
        (2, H, W, 3)), key))
    noise, pair = _class_draws(key, 2, 256, 3, "topk")
    got_p, got_k = TPL.estimate_multiclass_poses(
        _StandIn(_t(masks), field), torch.zeros(2, H, W, 3), _t(pts),
        _t(_K()), TPL.VoteParams(**params), select_method="topk",
        noise=noise, pair_u=pair)
    assert got_p.shape == (2, 3, 3, 4) and got_k.shape == (2, 3, 9, 2)
    np.testing.assert_allclose(got_k.numpy(), want_k, rtol=0, atol=1e-2)
    ang = rotation_angle_deg(got_p[..., :3], _t(want_p[..., :3]))
    assert float(ang.max()) < 0.05
    np.testing.assert_allclose(got_p[..., 3].numpy(), want_p[..., 3],
                               atol=1e-3)
    truth = rotation_angle_deg(got_p[..., :3], _t(poses[..., :3]))
    assert float(truth.max()) < 5.0
    assert float((got_p[..., 3] - _t(poses[..., 3])).norm(dim=-1).max()) \
        < 0.02
    # the closure and its generator give the same shapes
    run = TPL.make_multiclass_pose_pipeline(
        _StandIn(_t(masks), field), pts, _K(), TPL.VoteParams(**params),
        device="cpu")
    p, k = run(torch.zeros(2, H, W, 3), torch.Generator().manual_seed(0))
    assert p.shape == (2, 3, 3, 4) and k.shape == (2, 3, 9, 2)
    assert torch.isfinite(p).all()


def test_one_pnp_over_all_classes_equals_a_pnp_per_class(split):
    _, metas, _, _, hcoords, _ = split
    pts = _t(np.stack([m.points_3d for m in metas]))
    rng = np.random.RandomState(4)
    kps = _t(hcoords[..., :2] + rng.randn(2, 3, 9, 2).astype(np.float32)
             * 0.5)
    got = TPL.multiclass_poses_from_keypoints(pts, kps, _t(_K()))
    want = torch.stack([TP.pnp_batch(pts[c], kps[:, c], _t(_K()))
                        for c in range(3)], dim=1)
    # the same problems batched another way: equal to float32 rounding
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    Ks = _t(np.stack([_K(), _K()]))
    np.testing.assert_allclose(
        TPL.multiclass_poses_from_keypoints(pts, kps, Ks).numpy(),
        got.numpy(), rtol=0, atol=1e-5)


# --- training ------------------------------------------------------------------

TH, TW = 96, 128


@pytest.fixture(scope="module")
def train_batch():
    classes = TM.build_class_set()
    metas = [TM.class_meta(*c) for c in classes]
    images, masks, hcoords, _ = TM.generate_split(classes, metas, 2,
                                                  _K(TH, TW), TH, TW, seed=5)
    return images.astype(np.float32) / 255.0, masks, hcoords


def test_multiclass_train_step_matches_jax(train_batch):
    """One float32 step on a multi-class batch (hcoords [b, C, k, 3]) with
    flax-initialized seg_dim = 4 weights carried over by
    state_dict_from_flax: loss and metrics within 1e-4 relative, the
    gradient's global norm within 1e-3 relative, and the head's gradient
    within 1e-3 of its max abs."""
    from pvnet_tpu.models.pvnet import build_model as build_flax
    from pvnet_tpu.train import trainer as JT
    from pvnet_tpu.train.loss import total_loss as j_total_loss
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.train import trainer as TT
    from pvnet_tpu_torch.utils.weights import (flax_from_state_dict,
                                               state_dict_from_flax)
    image, masks, hcoords = train_batch
    fmodel = build_flax("resnet18_8s", ver_dim=18, seg_dim=4,
                        head_layout="NCHW")
    variables = fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, TH, TW, 3)),
                            train=False)
    batch = {"image": jnp.asarray(image),
             "mask": jnp.asarray(masks.astype(np.int32)),
             "hcoords": jnp.asarray(hcoords),
             "vertex_weights": jnp.asarray(
                 (masks > 0)[..., None].astype(np.float32))}

    @jax.jit
    def jax_step(params, batch_stats):
        vert = JT._batch_vertex(batch, False, "NCHW")       # the dispatch
        vw = batch["vertex_weights"].reshape(2, 1, TH, TW)

        def loss_fn(p):
            (sp, vp), _ = fmodel.apply(
                {"params": p, "batch_stats": batch_stats}, batch["image"],
                train=True, mutable=["batch_stats"])
            return j_total_loss(sp, vp, batch["mask"], vert, vw,
                                channel_axis=1)
        return jax.grad(loss_fn, has_aux=True)(params)

    jgrads, jmet = jax_step(variables["params"], variables["batch_stats"])

    model = build_model("resnet18_8s", ver_dim=18, seg_dim=4)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.array, variables)))
    state = TT.create_train_state(model, TrainConfig(model_name="t"))
    met = TT.train_step(state, {
        "image": _t(image).permute(0, 3, 1, 2).contiguous(),
        "mask": _t(masks), "hcoords": _t(hcoords)})
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)
    params = dict(model.named_parameters())
    tgrads = flax_from_state_dict({
        k: params[k].grad if k in params else v
        for k, v in model.state_dict().items()})["params"]
    jl = jax.tree_util.tree_leaves(jgrads)
    tl = jax.tree_util.tree_leaves(tgrads)
    assert len(jl) == len(tl)
    jn = np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                     for g in jl))
    tn = np.sqrt(sum(float(np.sum(np.asarray(g, np.float64) ** 2))
                     for g in tl))
    np.testing.assert_allclose(tn, jn, rtol=1e-3)
    head_j = np.asarray(jgrads["Conv_5"]["kernel"])
    head_t = np.asarray(tgrads["Conv_5"]["kernel"])
    assert head_t.shape == head_j.shape == (1, 1, 32, 22)
    np.testing.assert_allclose(head_t, head_j, rtol=0,
                               atol=1e-3 * np.abs(head_j).max())


def test_trainer_refuses_motion_and_augmentation_with_multiclass(
        train_batch):
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.train import trainer as TT
    image, masks, hcoords = train_batch
    batch = {"image": _t(image).permute(0, 3, 1, 2).contiguous(),
             "mask": _t(masks), "hcoords": _t(hcoords)}
    model = build_model("resnet18_8s", ver_dim=18, seg_dim=4)
    with pytest.raises(ValueError, match="multi-class"):
        TT.batch_loss(model, batch, 1.0, use_motion=True, bf16=False)
    with pytest.raises(ValueError, match="hcoords"):
        TT.apply_device_aug(batch, None, (TH, TW))


# --- evaluation -------------------------------------------------------------------

def test_symmetric_adds_branch(split):
    """A box pose turned by its own 90-degree symmetry: the port's
    Evaluator fails plain ADD and passes ADD-S with symmetric=True (ref
    evaluation_utils.py:119-130,155-158), as JAX's test shows for its
    metrics."""
    from pvnet_tpu.eval import metrics as JM
    from pvnet_tpu_torch.data.pose_transforms import project_np
    from pvnet_tpu_torch.eval import metrics as TMM
    box = next(m for m in split[1] if m.name == "box")
    assert box.symmetric
    rng = np.random.RandomState(5)
    R0 = np.linalg.qr(rng.randn(3, 3))[0]
    if np.linalg.det(R0) < 0:
        R0[:, 0] *= -1
    t0 = np.array([0.02, -0.01, 0.6])
    pose_gt = np.concatenate([R0, t0[:, None]], 1).astype(np.float32)
    Rz = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    pose_pred = np.concatenate([R0 @ Rz, t0[:, None]], 1).astype(np.float32)
    args = (_t(pose_pred), _t(pose_gt), _t(box.model_pts))
    jargs = tuple(jnp.asarray(a.numpy()) for a in args)
    add, adds = float(TMM.add_error(*args)), float(TMM.add_error_sym(*args))
    np.testing.assert_allclose(add, float(JM.add_error(*jargs)), rtol=1e-5)
    np.testing.assert_allclose(adds, float(JM.add_error_sym(*jargs)),
                               rtol=1e-5, atol=1e-7)
    thresh = 0.1 * box.diameter
    assert add > thresh and adds < 0.5 * thresh

    K = np.broadcast_to(_K(480, 640), (1, 3, 3))
    kps2d = project_np(box.points_3d, pose_pred, K[0])[None]
    ev = Evaluator(box)
    ev.evaluate_batch(kps2d, pose_gt[None], K)
    assert ev.add_recorder == [True]
    ev_plain = Evaluator(dataclasses.replace(box, symmetric=False))
    ev_plain.evaluate_batch(kps2d, pose_gt[None], K)
    assert ev_plain.add_recorder == [False]
