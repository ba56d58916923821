"""The port's data parallelism (pvnet_tpu_torch/parallel, trainer's
make_sharded_* steps, pipeline.make_sharded_pose_pipeline) on gloo
process groups of 2 and 4 CPU ranks (tests/_parallel_worker.py), held
against the JAX package's sharded functions on its 8-device CPU mesh
(tests/conftest.py) and flax's BatchNorm on the whole batch, from the same
weights (utils/weights.state_dict_from_flax) and the same draws.

Shapes: b=8 at 32x32 for the steps (48x64 after the device augmentation,
from tests/_jax_aug_draws.raw_batch's 64x80 frames), and the pipeline on
tests/test_torch_pipeline.py's 120x160 crop of the fixture (a 32x32 image
shows no object to pose)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax import serialization

from _jax_aug_draws import jax_draws, raw_batch
from _parallel_worker import spawn
from pvnet_tpu import pipeline as JPL
from pvnet_tpu.config import IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu.config import TrainConfig as JTrainConfig
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import voting as JV
from pvnet_tpu.parallel import make_mesh, replicate, shard_batch
from pvnet_tpu.train import trainer as JT
from pvnet_tpu_torch.ops.geometry import rotation_angle_deg
from pvnet_tpu_torch.parallel import make_mesh as t_make_mesh
from pvnet_tpu_torch.parallel import shard_batch as t_shard_batch
from pvnet_tpu_torch.utils.weights import (flax_from_state_dict,
                                           state_dict_from_flax)
from tools.make_torch_fixture import DEFAULT_OUT

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
B = 8
AUG_HW = (48, 64)
IDX = [1, 0, 3, 2, 5, 4, 7, 6]
HYP = 512


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the mesh helpers and the synchronized BatchNorm -------------------------

@pytest.fixture(scope="module", params=[2, 4])
def mesh_run(request, tmp_path_factory):
    """The worker's ``mesh`` mode on ``world`` ranks, and flax's BatchNorm
    (momentum 0.9, eps 1e-5) on the whole batch of the same input."""
    world = request.param
    rng = np.random.RandomState(world)
    x = (rng.randn(B, 5, 6, 7) * 3 + 1).astype(np.float32)
    g = rng.randn(B, 5, 6, 7).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    tmp = tmp_path_factory.mktemp(f"mesh{world}")
    inp, out = str(tmp / "in.pt"), str(tmp / "out.pt")
    torch.save({k: torch.from_numpy(v) for k, v in
                dict(x=x, g=g, weight=weight, bias=bias).items()}, inp)
    spawn("mesh", world, inp, out)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = bn.init(jax.random.PRNGKey(0), xh)
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}

    def loss(params, xh):
        y, mut = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xh,
                          mutable=["batch_stats"])
        return jnp.sum(y * g.transpose(0, 2, 3, 1)), (y, mut)
    (dp, dx), (y, mut) = jax.grad(loss, argnums=(0, 1), has_aux=True)(
        params, xh)
    want = {"y": np.asarray(y).transpose(0, 3, 1, 2),
            "dx": np.asarray(dx).transpose(0, 3, 1, 2),
            "dw": np.asarray(dp["scale"]), "db": np.asarray(dp["bias"]),
            "mean": np.asarray(mut["batch_stats"]["mean"]),
            "var": np.asarray(mut["batch_stats"]["var"])}
    return world, torch.load(out, weights_only=False), want


def test_rows_per_rank_and_replicate(mesh_run):
    """Each rank's rows are its contiguous block in rank order; an
    indivisible batch raised and replicate gave rank 0's values (checked
    in every rank)."""
    world, got, _ = mesh_run
    np.testing.assert_array_equal(
        got["rows"].numpy(),
        np.arange(4 * world * 3, dtype=np.float32).reshape(-1, 3))


def test_global_helpers_mirror_multihost(mesh_run):
    """tests/test_multihost.py's check: each process contributes 4 rows
    (its own values), a replicated weight of 2, one global reduction."""
    world, got, _ = mesh_run
    g = np.concatenate([np.arange(12, dtype=np.float32).reshape(4, 3)
                        + 100 * p for p in range(world)])
    want = (g * 2.0).sum(1)
    np.testing.assert_allclose(got["global_rows"].numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(float(got["global_sum"]), want.sum(),
                               rtol=1e-6)


@pytest.mark.parametrize("key", ["y", "dx", "dw", "db", "mean", "var"])
def test_sync_batchnorm_equals_flax_on_the_whole_batch(mesh_run, key):
    """Output, input / weight / bias gradients and the biased running
    statistics of the ranks' synchronized BatchNorm against flax's on the
    whole batch: atol 1e-5 (the sums over 8 x 42 values a channel, in
    float32)."""
    _, got, want = mesh_run
    np.testing.assert_allclose(got[f"bn_{key}"].numpy(), want[key],
                               rtol=1e-5, atol=1e-5)


def test_mesh_without_a_process_group():
    """No group: world size 1, every row, no collective."""
    mesh = t_make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    x = np.arange(6).reshape(3, 2)
    assert torch.equal(t_shard_batch({"x": x}, mesh)["x"],
                       torch.from_numpy(x))


# -- the sharded steps and the sharded pipeline, against JAX ---------------

@pytest.fixture(scope="module")
def model_run(tmp_path_factory):
    """JAX's make_sharded_train_step, make_sharded_train_step_from_data,
    make_sharded_eval_step and make_sharded_pose_pipeline on the 8-device
    mesh, and the worker's ``model`` mode on 2 ranks from the same
    weights, batches and draws."""
    mesh = make_mesh()
    assert mesh.shape["data"] == 8
    jcfg = JTrainConfig()
    aug_cfg = JTrainConfig.from_json(RECIPE).aug_cfg
    fmodel = build_flax("resnet18_8s", ver_dim=18)
    state0 = JT.create_train_state(fmodel, jcfg, (B, 32, 32, 3),
                                   jax.random.PRNGKey(0))
    sd = state_dict_from_flax(_np({"params": state0.params,
                                   "batch_stats": state0.batch_stats}))
    rng = np.random.RandomState(0)
    batch = {"image": rng.randn(B, 32, 32, 3).astype(np.float32),
             "mask": rng.randint(0, 2, (B, 32, 32)).astype(np.int32),
             "vertex": rng.randn(B, 32, 32, 18).astype(np.float32),
             "vertex_weights": (rng.rand(B, 32, 32, 1) < 0.5).astype(
                 np.float32)}
    jbatch = shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                         mesh)
    out = {}

    def step_out(state):
        new, met = state
        mu = new.opt_state.inner_state[0].mu        # (1 - b1) g, b1 = 0.9
        return {"metrics": _np(met), "params": _np(new.params),
                "stats": _np(new.batch_stats),
                "grads": jax.tree_util.tree_map(
                    lambda m: np.asarray(m) / 0.1, mu)}

    out["step"] = step_out(JT.make_sharded_train_step(mesh, donate=False)(
        replicate(state0, mesh), jbatch))

    images, masks, hcoords = raw_batch()
    tile = np.arange(B) % 2
    data = {"image": images[tile], "mask": masks[tile],
            "hcoords": hcoords[tile], "ignore": np.zeros(B, np.float32)}
    key = jax.random.PRNGKey(5)
    out["data"] = step_out(JT.make_sharded_train_step_from_data(
        mesh, donate=False, aug_cfg=aug_cfg, aug_hw=AUG_HW)(
            replicate(state0, mesh),
            replicate({k: jnp.asarray(v) for k, v in data.items()}, mesh),
            np.asarray(IDX, np.int32), key))
    out["eval"] = _np(JT.make_sharded_eval_step(mesh)(
        replicate(state0, mesh), jbatch))

    # the pipeline: tests/test_torch_pipeline.py's crop, 4 copies of each
    # view, the plain path with stratified selection (off the TPU JAX's
    # 'auto' picks top-k, which the port does not have)
    with np.load(DEFAULT_OUT) as z:
        y0, x0 = 216, 232
        K = z["K"].copy()
        K[0, 2] -= x0
        K[1, 2] -= y0
        views = z["images"][:, y0:y0 + 120, x0:x0 + 160]
        pts, poses = z["points_3d"], z["poses"]
    imgs = ((views[tile].astype(np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD).astype(np.float32)
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    pmodel = build_flax("resnet18_8s", ver_dim=18, head_layout="NCHW")
    pkey = jax.random.PRNGKey(11)
    with pytest.MonkeyPatch.context() as mp:
        orig = JV.sample_foreground
        mp.setattr(JV, "sample_foreground", lambda *a, **k: orig(
            *a, **dict(k, method="stratified")))
        run = JPL.make_sharded_pose_pipeline(mesh, pmodel.apply, pts, K)
        pose_j, kps_j = run(replicate(variables, mesh),
                            jnp.asarray(imgs), pkey)
    k1, k2 = jax.random.split(pkey)
    h, w = imgs.shape[1:3]
    noise = np.asarray(jax.random.uniform(k1, (B, h, w), jnp.float32))
    pair_u = np.asarray(jax.random.uniform(k2, (B, HYP, 2), jnp.float32))
    # JAX's selection, hypotheses and counts op by op from its own fields
    mask_j, ver_j = JPL.predict_fields(pmodel.apply, variables,
                                       jnp.asarray(imgs))
    fg_j = JV.sample_foreground(mask_j, ver_j, HYP, k1, method="stratified")
    hyps_j = JV.generate_hypotheses(fg_j, HYP, k2)
    hx, hy = hyps_j[..., 0], hyps_j[..., 1]
    hf = jnp.stack([hx, hy, hx * hx + hy * hy], -1)[:, :, :, None, :]
    counts_j = jnp.sum(JV._inlier_terms(JV._pixel_features(fg_j)[:, None],
                                        hf, 0.99), -1)
    out["pipeline"] = {"pose": np.asarray(pose_j), "kps": np.asarray(kps_j),
                       "fg": _np(tuple(fg_j)), "hyps": np.asarray(hyps_j),
                       "counts": np.asarray(counts_j), "gt": poses[tile]}

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    draws = jax_draws(key, B, aug_cfg)
    inp = {"recipe": RECIPE, "sd": sd, "aug_hw": AUG_HW,
           "batch": {"image": t(batch["image"].transpose(0, 3, 1, 2)),
                     "mask": t(batch["mask"]),
                     "vertex": t(batch["vertex"].transpose(0, 3, 1, 2)),
                     "vertex_weights": t(batch["vertex_weights"]
                                         .transpose(0, 3, 1, 2))},
           "data": {k: t(v) for k, v in data.items()},
           "idx": torch.tensor(IDX), "draws": draws._asdict(),
           "ckpt": CKPT, "points_3d": pts, "K": K, "images": t(imgs),
           "noise": t(noise), "pair_u": t(pair_u),
           "mask_j": t(np.asarray(mask_j)), "ver_j": t(np.asarray(ver_j))}
    tmp = tmp_path_factory.mktemp("model")
    inp_path, out_path = str(tmp / "in.pt"), str(tmp / "out.pt")
    torch.save(inp, inp_path)
    spawn("model", 2, inp_path, out_path)
    return out, torch.load(out_path, weights_only=False)


def _metrics_close(got, want, rtol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   err_msg=k)


def _grad_errors(got_sd, want_tree):
    want = _leaves(want_tree)
    got = _leaves(flax_from_state_dict(got_sd)["params"])
    assert set(got) == set(want)
    rel = {k: np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30)
           for k, w in want.items()}
    total = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items())
                    / sum(np.sum(w ** 2) for w in want.values()))
    return rel, total


def _full_sd(model_sd, grads):
    """The state dict with each parameter replaced by its gradient."""
    return {k: grads.get(k, v) for k, v in model_sd.items()}


def _stats_close(got_sd, want_stats, atol_rel):
    want = _leaves(want_stats)
    got = _leaves(flax_from_state_dict(got_sd)["batch_stats"])
    assert set(got) == set(want) and len(got) == 2 * 25
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=atol_rel * np.abs(w).max(),
                                   err_msg=k)


def test_sharded_step_loss_matches_jax(model_run):
    """tests/test_train.py::test_sharded_matches_single_device's rtol 1e-4,
    on every metric (global-batch means on both sides)."""
    jax_out, port = model_run
    _metrics_close(port["step_metrics"], jax_out["step"]["metrics"], 1e-4)


def test_sharded_step_synchronizes_an_unconverted_model(model_run):
    """The model went into the sharded step with the port's plain
    BatchNorm2d layers (the worker checks); the step made every one a
    SyncBatchNorm2d, and test_sharded_step_loss_matches_jax holds its
    global-batch statistics."""
    _, port = model_run
    assert port["synchronized"]
    assert set(port["synchronized"]) == {"SyncBatchNorm2d"}


def test_sharded_step_gradients_and_stats_match_jax(model_run):
    """The averaged gradients of the 2 ranks against JAX's over the 8
    devices (read from Adam's first moment, 0.1 g), with
    tests/test_torch_train_step.py's tolerances for the same batch (each
    within 3e-3 of its norm, all within 1e-3), and the biased running
    statistics within 1e-4 of each tensor's largest value."""
    jax_out, port = model_run
    rel, total = _grad_errors(_full_sd(port["step_sd"], port["step_grads"]),
                              jax_out["step"]["grads"])
    assert max(rel.values()) < 3e-3, max(rel.items(), key=lambda kv: kv[1])
    assert total < 1e-3
    _stats_close(port["step_sd"], jax_out["step"]["stats"], 1e-4)


def test_sharded_step_parameters_match_jax(model_run):
    """The weights after the step: Adam's first step moves each weight by
    lr * g / (|g| + eps), so where the gradients agree every weight agrees
    to float32 rounding; a weight whose gradient is ~0 may move either way
    (at most 2 lr = 2e-3 apart)."""
    jax_out, port = model_run
    want = _leaves(jax_out["step"]["params"])
    got = _leaves(flax_from_state_dict(port["step_sd"])["params"])
    diff = np.concatenate([np.abs(got[k] - w).ravel()
                           for k, w in want.items()])
    assert diff.max() <= 2e-3 + 1e-6
    assert (diff < 1e-5).mean() >= 0.999, (diff >= 1e-5).sum()


def test_sharded_step_from_data_matches_jax(model_run):
    """The resident-set step with the device augmentation and JAX's draws
    for the global batch, each rank its rows. Loss within rtol 1e-4 and
    statistics within 1e-4, as tests/test_torch_train_step.py's whole step.
    Its gradients differ from JAX's as the unsharded port step's do: the
    port's augmented frames differ from JAX's by ~1e-5, which the
    random-init network amplifies in its deepest layers (measured on this
    batch: each gradient within 1.2e-2 of its norm, all within 7e-3, for the
    2 ranks and for one process alike). Held: each within 3e-2 (that
    file's bound), all within 1e-2, and the 2 ranks no further from JAX
    than one process plus a quarter."""
    jax_out, port = model_run
    _metrics_close({"loss": port["data_metrics"]["loss"]},
                   {"loss": jax_out["data"]["metrics"]["loss"]}, 1e-4)
    rel, total = _grad_errors(_full_sd(port["data_sd"], port["data_grads"]),
                              jax_out["data"]["grads"])
    _, one = _grad_errors(_full_sd(port["one_sd"], port["one_grads"]),
                          jax_out["data"]["grads"])
    assert max(rel.values()) < 3e-2, max(rel.items(), key=lambda kv: kv[1])
    assert total < 1e-2 and total < 1.25 * one, (total, one)
    _stats_close(port["data_sd"], jax_out["data"]["stats"], 1e-4)


def test_sharded_step_equals_one_process_in_float64(model_run):
    """Step (1) in float64 on 2 ranks and unsharded in one process: the
    same loss, gradients and running statistics to float64 rounding (the
    float32 steps differ by rounding amplified through the random-init
    network's BatchNorm layers; here nothing is left to amplify)."""
    _, port = model_run
    _metrics_close(port["f64_metrics"], port["f64_one_metrics"], 1e-12)
    for k, want in port["f64_one_grads"].items():
        got = port["f64_grads"][k]
        assert (got - want).norm() <= 1e-9 * want.norm() + 1e-300, k
    for k, want in port["f64_one_sd"].items():
        if "running" in k:
            torch.testing.assert_close(port["f64_sd"][k], want, rtol=1e-12,
                                       atol=1e-12, msg=k)


def test_sharded_eval_step_matches_jax(model_run):
    """Frozen statistics, the same weights: every metric within 1e-5."""
    jax_out, port = model_run
    _metrics_close(port["eval_metrics"], jax_out["eval"], 1e-5)


def test_sharded_pipeline_integers_match_jax(model_run):
    """Each rank's rows of the global draws on JAX's fields: the same
    pixels, hypotheses and counts as JAX's op by op, exactly."""
    jax_out, port = model_run
    pj = jax_out["pipeline"]
    for got, want in zip(port["fg"], pj["fg"]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port["hyps"].numpy(), pj["hyps"])
    np.testing.assert_array_equal(port["counts"].numpy(), pj["counts"])


def test_sharded_pipeline_poses_match_jax(model_run):
    """The 2-rank pipeline against JAX's on the 8-device mesh with the
    same draws: tests/test_torch_pipeline.py's tolerances (80 % of the
    keypoints within 0.05 px, all within 2 px; poses within 1 deg and
    15 mm; poses compared, not eigenvectors), and the visible view near
    its ground truth."""
    jax_out, port = model_run
    pj = jax_out["pipeline"]
    err = np.linalg.norm(port["kps"].numpy() - pj["kps"], axis=-1)
    assert (err < 5e-2).mean() >= 0.8 and err.max() < 2.0, err
    rot = rotation_angle_deg(port["pose"][..., :3],
                             torch.tensor(pj["pose"][..., :3])).numpy()
    assert rot.max() < 1.0, rot
    np.testing.assert_allclose(port["pose"][..., 3].numpy(),
                               pj["pose"][..., 3], atol=1.5e-2)
    gt = rotation_angle_deg(port["pose"][::2, :, :3],
                            torch.tensor(pj["gt"][::2, :, :3])).numpy()
    assert gt.max() < 5.0, gt
