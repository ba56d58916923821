"""The port's training pieces against the JAX package's, on the CPU: the
recipe, losses, vertex targets, the LR schedule, Adam against optax,
BatchNorm running statistics, the sampler, the projection, weights both
ways, checkpoints, and the trainer's entry point without JAX.

The whole training step against JAX's is tests/test_torch_train_step.py
(its own file: its JAX compile is the heavy one)."""
import json
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _jax_aug_draws import FIXTURE, raw_batch
from pvnet_tpu.config import TrainConfig as JTrainConfig
from pvnet_tpu.data.dataset import ImageSizeBatchSampler as JSampler
from pvnet_tpu.data.pose_transforms import project_np as j_project_np
from pvnet_tpu.data.vertex import compute_vertex_targets as j_vertex
from pvnet_tpu.data.vertex import compute_vertex_targets_np as j_vertex_np
from pvnet_tpu.train import loss as JL
from pvnet_tpu.train.trainer import lr_for_epoch as j_lr_for_epoch
from pvnet_tpu_torch import infer
from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.data.dataset import ImageSizeBatchSampler
from pvnet_tpu_torch.data.pose_transforms import project_np
from pvnet_tpu_torch.data.vertex import (compute_vertex_targets,
                                         compute_vertex_targets_np)
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.models.resnet import BatchNorm2d, init_weights
from pvnet_tpu_torch.train import checkpoint as CK
from pvnet_tpu_torch.train import loss as TL
from pvnet_tpu_torch.train import trainer as TT
from pvnet_tpu_torch.train.recorder import AverageMeter, Recorder
from pvnet_tpu_torch.utils.weights import (flax_from_state_dict,
                                           state_dict_from_flax)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = [os.path.join(REPO, "configs", f) for f in
           ("synthetic_train.json", "linemod_train.json")]


@pytest.mark.parametrize("path", RECIPES)
def test_recipe_loads_as_in_jax(path):
    if not os.path.exists(path):
        pytest.fail(f"missing recipe {path}")
    got, want = TrainConfig.from_json(path), JTrainConfig.from_json(path)
    assert got.to_dict() == want.to_dict()
    assert got.recipe_keys == want.recipe_keys


# ---------------------------------------------------------------------------
# losses and targets: float32 on both sides, sums in another order, so
# rtol 1e-5; argmax-based precision/recall exactly
# ---------------------------------------------------------------------------

def _loss_inputs(ca, seed=0):
    rng = np.random.RandomState(seed)
    seg = rng.randn(2, 2, 12, 16).astype(np.float32)
    ver = rng.randn(2, 6, 12, 16).astype(np.float32) * 2
    tgt = rng.randn(2, 6, 12, 16).astype(np.float32)
    w = (rng.rand(2, 1, 12, 16) < 0.5).astype(np.float32)
    mask = rng.randint(0, 2, (2, 12, 16)).astype(np.int32)
    if ca == -1:
        seg, ver, tgt, w = (a.transpose(0, 2, 3, 1) for a in (seg, ver, tgt, w))
    return [np.ascontiguousarray(a) for a in (seg, ver, tgt, w)] + [mask]


@pytest.mark.parametrize("ca", [1, -1])
def test_losses_match_jax(ca):
    seg, ver, tgt, w, mask = _loss_inputs(ca)
    T = [torch.from_numpy(a) for a in (seg, ver, tgt, w, mask)]
    J = [jnp.asarray(a) for a in (seg, ver, tgt, w, mask)]
    np.testing.assert_allclose(TL.seg_loss(T[0], T[4], ca).numpy(),
                               np.asarray(JL.seg_loss(J[0], J[4], ca)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        TL.smooth_l1_vertex_loss(T[1], T[2], T[3], channel_axis=ca).numpy(),
        np.asarray(JL.smooth_l1_vertex_loss(J[1], J[2], J[3],
                                            channel_axis=ca)), rtol=1e-5)
    for g, wnt in zip(TL.precision_recall(T[0], T[4], ca),
                      JL.precision_recall(J[0], J[4], ca)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    loss, met = TL.total_loss(*T[:2], T[4], T[2], T[3], 0.7, ca)
    jloss, jmet = JL.total_loss(J[0], J[1], J[4], J[2], J[3], 0.7, ca)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5)


def test_bf16_logits_lose_no_precision_in_the_loss():
    # the head emits bf16 under autocast; the loss upcasts before any sum
    seg, _, _, _, mask = _loss_inputs(1)
    s16 = torch.from_numpy(seg).to(torch.bfloat16)
    np.testing.assert_allclose(
        TL.seg_loss(s16, torch.from_numpy(mask)).numpy(),
        TL.seg_loss(s16.float(), torch.from_numpy(mask)).numpy(), rtol=0)


def _vertex_inputs():
    rng = np.random.RandomState(1)
    mask = (rng.rand(2, 16, 20) < 0.3).astype(np.int32)
    hc = np.concatenate([rng.rand(2, 5, 2) * 20, np.ones((2, 5, 1))],
                        -1).astype(np.float32)
    hc[0, 0, :2] = [3.0, 4.0]                     # a keypoint on a pixel
    mask[0, 4, 3] = 1
    return mask, hc


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_vertex_targets_match_jax(layout):
    mask, hc = _vertex_inputs()
    want = j_vertex(jnp.asarray(mask), jnp.asarray(hc), False, layout)
    got = compute_vertex_targets(torch.from_numpy(mask), torch.from_numpy(hc),
                                 False, layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(compute_vertex_targets_np(mask[0], hc[0]),
                                  j_vertex_np(mask[0], hc[0]))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_motion_targets_follow_the_reference(layout):
    """Fault F5: the JAX package's compute_vertex_targets(use_motion=True)
    stacks an x-only and a y-only offset grid unbroadcast and raises. The
    port broadcasts them and equals the host reference
    (compute_vertex_targets_np, ref linemod_dataset.py:68-81)."""
    mask, hc = _vertex_inputs()
    with pytest.raises(ValueError, match="same shape"):
        j_vertex(jnp.asarray(mask), jnp.asarray(hc), True, layout)
    got = compute_vertex_targets(torch.from_numpy(mask), torch.from_numpy(hc),
                                 True, layout).numpy()
    want = np.stack([j_vertex_np(m, h, True) for m, h in zip(mask, hc)])
    if layout == "NCHW":
        want = want.transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_project_np_equals_jax():
    with np.load(FIXTURE) as z:
        pts, pose, K = z["points_3d"], z["poses"][0], z["K"]
    np.testing.assert_array_equal(project_np(pts, pose, K),
                                  j_project_np(pts, pose, K))


# ---------------------------------------------------------------------------
# optimizer, schedule, BatchNorm, init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 19, 20, 40, 139, 199])
def test_lr_for_epoch_equals_jax(epoch):
    for path in RECIPES[:1]:
        assert TT.lr_for_epoch(TrainConfig.from_json(path), epoch) == \
            j_lr_for_epoch(JTrainConfig.from_json(path), epoch)


def test_adam_matches_optax_for_3_steps():
    """Identical gradients in, parameters out within f32 rounding of the
    same formula (torch divides by sqrt(v)/sqrt(bc2) + eps, optax by
    sqrt(v/bc2) + eps: one rounding apart)."""
    rng = np.random.RandomState(0)
    p0 = {"w": rng.randn(4, 5).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * 10 ** rng.uniform(-4, 1)).astype(
        np.float32) for k, v in p0.items()} for _ in range(3)]
    model = torch.nn.Module()
    for k, v in p0.items():
        model.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    state = TT.create_train_state(model, TrainConfig())
    tx = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt = tx.init(jp)
    for g in grads:
        for k, v in g.items():
            getattr(model, k).grad = torch.tensor(v)
        state.optimizer.step()
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt,
                             jp)
        jp = optax.apply_updates(jp, upd)
        for k in p0:
            np.testing.assert_allclose(getattr(model, k).detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)


def test_set_learning_rate():
    model = torch.nn.Linear(2, 2)
    state = TT.set_learning_rate(
        TT.create_train_state(model, TrainConfig()), 2.5e-4)
    assert [g["lr"] for g in state.optimizer.param_groups] == [2.5e-4]
    assert state.optimizer.defaults["betas"] == (0.9, 0.999)
    assert state.optimizer.defaults["eps"] == 1e-8


def test_batchnorm_running_stats_match_flax():
    """One train-mode pass over n = 2*8*8 = 128 values per channel: the
    port's running mean and variance equal flax's (biased variance);
    PyTorch's own BatchNorm2d keeps the unbiased one, n/(n-1) larger."""
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 8, 8, 5) * 3 + 1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j, mut = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    port, plain = BatchNorm2d(5, eps=1e-5), torch.nn.BatchNorm2d(5, eps=1e-5)
    with torch.no_grad():
        port.running_var.fill_(2.0)               # a non-trivial old value
        plain.running_var.fill_(2.0)
    y_t = port.train()(xt)
    plain.train()(xt)
    with torch.no_grad():                         # flax starts at var 1
        port.running_var.fill_(1.0)
        port.running_mean.zero_()
        port(xt)
    np.testing.assert_allclose(y_t.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_j), rtol=1e-5, atol=1e-5)
    stats = mut["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6)
    # the same old value 2.0 in both: only the new term differs, by n/(n-1)
    biased = xt.var((0, 2, 3), unbiased=False)
    np.testing.assert_allclose((plain.running_var - 0.9 * 2.0).numpy(),
                               (0.1 * biased * 128 / 127).numpy(), rtol=1e-5)


def test_init_is_he_fanout_truncated_normal():
    model = init_weights(build_model("resnet18_8s", ver_dim=18),
                         torch.Generator().manual_seed(0))
    w = model.resnet18_8s.layer3[0].conv1.weight.detach()   # 256x128x3x3
    std = (2.0 / (256 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert float(model.convraw[3].bias.detach().abs().max()) == 0.0
    assert float(model.conv8s[1].running_var.min()) == 1.0


# ---------------------------------------------------------------------------
# data plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("buckets", [None, [(48, 64), (32, 32)]])
def test_sampler_equals_jax(buckets):
    kw = dict(drop_last=True, buckets=buckets, seed=3)
    got = list(ImageSizeBatchSampler(range(37), 4, **kw))
    want = list(JSampler(range(37), 4, **kw))
    assert got == want and len(got) == 9
    assert len(ImageSizeBatchSampler(range(37), 4)) == 10


def test_flax_from_state_dict_inverts_state_dict_from_flax():
    model = build_model("resnet18_8s", ver_dim=18)
    sd = model.state_dict()
    back = state_dict_from_flax(flax_from_state_dict(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    tree = flax_from_state_dict(sd)
    assert tree["params"]["Conv_5"]["kernel"].shape == (1, 1, 32, 20)
    with pytest.raises(KeyError):
        flax_from_state_dict(dict(sd, extra=torch.zeros(1)))


# ---------------------------------------------------------------------------
# training behaviour, checkpoints, recorder, entry point
# ---------------------------------------------------------------------------

def _small_state(seed=0):
    model = init_weights(build_model("resnet18_8s", ver_dim=18),
                         torch.Generator().manual_seed(seed))
    return TT.create_train_state(model, TrainConfig())


def _augmented_batch(b=2):
    images, masks, hcoords = raw_batch(32, 32, 216, 300)
    return TT.apply_device_aug(
        {"image": torch.from_numpy(images), "mask": torch.from_numpy(masks),
         "hcoords": torch.from_numpy(hcoords)},
        TrainConfig().aug_cfg, (32, 32),
        generator=torch.Generator().manual_seed(0))


def test_loss_falls_on_a_fixed_batch():
    """As tests/test_train.py:135 does for JAX: ten steps on one batch."""
    state = _small_state()
    batch = _augmented_batch()
    losses = [float(TT.train_step(state, batch)["loss"]) for _ in range(10)]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert state.step == 10
    metrics = TT.eval_step(state, batch)
    assert set(metrics) == {"loss", "seg_loss", "ver_loss", "precision",
                            "recall"}
    assert not state.model.training


def test_checkpoint_roundtrip(tmp_path):
    state = _small_state()
    batch = _augmented_batch()
    TT.train_step(state, batch)
    for epoch in range(4):
        CK.save_model(state, epoch, str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["2.pth", "3.pth"]
    fresh = _small_state(seed=1)
    restored, begin = CK.load_model(fresh, str(tmp_path))
    assert begin == 4
    for (k, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert (restored.optimizer.state_dict()["state"][0]["step"]
            == state.optimizer.state_dict()["state"][0]["step"])
    _, begin2 = CK.load_model(_small_state(), str(tmp_path), epoch=2)
    assert begin2 == 3
    net_only, begin3 = CK.load_net(_small_state(seed=2), str(tmp_path))
    assert begin3 == 4 and not net_only.optimizer.state_dict()["state"]
    assert CK.load_model(fresh, str(tmp_path / "none"))[1] == 0
    # the inference entry point reads the trainer's checkpoint
    model = infer.load_model(str(tmp_path / "3.pth"), 9, "cpu")
    for a, b in zip(model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)


def test_recorder_writes_jsonl(tmp_path, capsys):
    meter = AverageMeter()
    for v in (1.0, 2.0, 6.0):
        meter.update(v)
    assert meter.avg == 3.0
    rec = Recorder(str(tmp_path))
    rec.rec_loss_batch({"train/scalar/loss": meter.avg}, 5, 1)
    rec.close()
    row = json.loads((tmp_path / "log.jsonl").read_text())
    assert row["step"] == 5 and row["train/scalar/loss"] == 3.0
    assert "loss 3.0" in capsys.readouterr().out


def test_recorder_tensorboard_sink(tmp_path):
    # a sink only where torch.utils.tensorboard imports (decided here, at
    # run time): then it writes an event file beside the JSONL log
    try:
        import torch.utils.tensorboard  # noqa: F401
        have_tb = True
    except ImportError:
        have_tb = False
    rec = Recorder(str(tmp_path), use_tensorboard=True)
    rec.rec_loss_batch({"train/scalar/loss": 1.5}, 0, 0)
    rec.close()
    assert (rec.writer is not None) == have_tb
    events = [f for f in os.listdir(tmp_path) if "tfevents" in f]
    assert bool(events) == have_tb and (tmp_path / "log.jsonl").exists()


_BLOCKED = ("jax", "flax", "msgpack", "PIL", "pvnet_tpu")


def _write_set(path, h=64, w=80, y0=200, x0=280):
    """The fixture's two views cut to [y0:y0+h, x0:x0+w], as an .npz in
    the trainer's data layout."""
    images, masks, _ = raw_batch(h, w, y0, x0)
    with np.load(FIXTURE) as z:
        K = z["K"].copy()
        K[0, 2] -= x0
        K[1, 2] -= y0
        np.savez(path, images=images, masks=masks, poses=z["poses"],
                 points_3d=z["points_3d"], K=K)


def test_train_entry_point_runs_without_jax(tmp_path):
    _write_set(tmp_path / "set.npz")
    recipe = json.loads(open(RECIPES[0]).read())
    recipe["train_batch_size"] = 2
    (tmp_path / "recipe.json").write_text(json.dumps(recipe))
    model_dir = tmp_path / "model"
    code = ("import sys\n"
            f"for m in {_BLOCKED!r}: sys.modules[m] = None\n"
            "import runpy\n"
            "sys.argv = ['train', '--device', 'cpu', '--steps', '2',"
            f" '--cfg_file', {str(tmp_path / 'recipe.json')!r},"
            " '--buckets', '48x64', '--data',"
            f" {str(tmp_path / 'set.npz')!r}, '--model_dir',"
            f" {str(model_dir)!r}]\n"
            "runpy.run_module('pvnet_tpu_torch.train', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(model_dir)) == ["0.pth", "1.pth", "log.jsonl"]
    rows = [json.loads(line) for line in
            (model_dir / "log.jsonl").read_text().splitlines()]
    assert len(rows) == 2
    assert all(np.isfinite(r["train/scalar/loss"]) for r in rows)
    ckpt = torch.load(model_dir / "1.pth", weights_only=True)
    assert ckpt["epoch"] == 1 and set(ckpt) == {"net", "optim", "epoch"}


def test_train_entry_point_fills_a_batch_from_a_small_set(tmp_path, capsys):
    """The recipe's batch of 16 from a 2-image set: the set is repeated."""
    from pvnet_tpu_torch.train.__main__ import main
    _write_set(tmp_path / "set.npz", 32, 32, 216, 300)
    model_dir = tmp_path / "model"
    assert main(["--device", "cpu", "--steps", "1", "--buckets", "32x32",
                 "--cfg_file", RECIPES[0], "--data",
                 str(tmp_path / "set.npz"),
                 "--model_dir", str(model_dir)]) == 0
    assert "train set: 16 images at 32x32; batch 16" in capsys.readouterr().out
    assert sorted(os.listdir(model_dir)) == ["0.pth", "log.jsonl"]
