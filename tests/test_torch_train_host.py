"""The host-augmented training route of the port against the JAX
package's, on the CPU, on the 120x160 tree of tests/_linemod_tree.py:
TrainLoop.make_loaders + train_epoch (JAX's pvnet_tpu/train/loop.py:
253-304, 467-485) for one epoch of b=2 48x64 batches from the duck
checkpoint in float32, one loader thread (the dataset's RandomState is
shared by the threads, so only one reproduces JAX's draws): the
host-augmented batches equal JAX's and the loss of every step agrees
within tests/test_torch_train_step.py's rtol 1e-4, each port step starting
from the weights, statistics and Adam moments JAX's step started from
(Adam's first step moves each weight by ~lr whatever its gradient's size,
so two float32 runs drift apart by ~1e-3 in two steps); the same for the
streamed raw batches of --device_aug, fed JAX's augmentation draws
(tests/_jax_aug_draws.py) from JAX's per-step keys. Then the CLI's three
routes on the tree, and fit_records' refusal of device_data without
device_aug."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _jax_aug_draws import jax_draws
from _linemod_tree import make_tree, own_jax_caches
from pvnet_tpu.config import PathConfig as JPathConfig
from pvnet_tpu.config import TrainConfig as JTrainConfig
from pvnet_tpu.data import linemod as JL
from pvnet_tpu.train.loop import TrainLoop as JTrainLoop
from pvnet_tpu_torch.config import PathConfig, TrainConfig
from pvnet_tpu_torch.data import linemod as TL
from pvnet_tpu_torch.train import __main__ as CLI
from pvnet_tpu_torch.train import trainer as TT
from pvnet_tpu_torch.train.loop import TrainLoop
from pvnet_tpu_torch.utils.weights import state_dict_from_flax

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "linemod_train.json")
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
HW = (48, 64)


@pytest.fixture(autouse=True)
def _fresh_jax_caches():
    with own_jax_caches():
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree") / "data")
    make_tree(root)
    return root


@pytest.fixture(scope="module")
def sets(tree, tmp_path_factory):
    """(root, train records: real train list + fuse set, val records) of a
    copy of the tree for each package."""
    base = tmp_path_factory.mktemp("copies")
    out = {}
    for side in ("jax", "port"):
        root = str(base / side)
        shutil.copytree(tree, root)
        mod, P = (JL, JPathConfig) if side == "jax" else (TL, PathConfig)
        with own_jax_caches():
            db = mod.LineModImageDB("duck", has_render_set=False,
                                    paths=P(data_dir=root))
        out[side] = (root, db.train_real_set + db.fuse_set,
                     db.val_real_set)
    return out


def _recipe(cfg, device_aug):
    cfg.bf16 = False
    cfg.train_batch_size = 2
    cfg.loss_rec_step = 1
    cfg.device_aug = device_aug
    return cfg


class Recording:
    """A loader that keeps the batches it yields."""

    def __init__(self, loader):
        self.loader, self.batches = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            self.batches.append(batch)
            yield batch


def _port_names(tree, stats):
    """A flax tree shaped like the params -> the port's names."""
    return state_dict_from_flax(jax.tree_util.tree_map(
        np.array, {"params": tree, "batch_stats": stats}))


def _sync(state, jstate):
    """Carry JAX's weights, statistics and Adam moments into the port's
    state (tests/test_torch_multiclass_study.py)."""
    model = state.model
    model.load_state_dict(_port_names(jstate.params, jstate.batch_stats))
    adam = jstate.opt_state.inner_state[0]
    mu = _port_names(adam.mu, jstate.batch_stats)
    nu = _port_names(adam.nu, jstate.batch_stats)
    for name, p in model.named_parameters():
        st = state.optimizer.state[p]
        assert int(st["step"]) == int(adam.count)
        st["exp_avg"].copy_(mu[name])
        st["exp_avg_sq"].copy_(nu[name])


def _epochs(sets, tmp_path, monkeypatch, device_aug):
    """One epoch of each package's train_epoch on its make_loaders' train
    loader, each port step from the state of JAX's: (JAX's batches,
    per-step losses), (the port's)."""
    jroot, jtrain, jval = sets["jax"]
    root, train, val = sets["port"]
    jcfg = _recipe(JTrainConfig.from_json(RECIPE), device_aug)
    jloop = JTrainLoop(jcfg, "duck", paths=JPathConfig(data_dir=jroot),
                       buckets=[HW], use_mesh=False)
    state = jloop.init_state(HW)
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    jlosses, jstates = [], []
    jloop.recorder.rec_loss_batch = \
        lambda d, *a, **k: jlosses.append(d["train/scalar/loss"])
    step_fn = jloop.train_step_fn

    def recording_step_fn(*args, **kwargs):
        step = step_fn(*args, **kwargs)

        def run(state, *rest):
            jstates.append(state)
            return step(state, *rest)
        return run
    jloop.train_step_fn = recording_step_fn
    jloader = Recording(jloop.make_loaders(
        jtrain, jval, os.path.join(jroot, "LINEMOD"), num_threads=1)[0])
    jloop.train_epoch(state, jloader, 0)

    cfg = _recipe(TrainConfig.from_json(RECIPE), device_aug)
    loop = TrainLoop(cfg, str(tmp_path / "m"), buckets=[HW], device="cpu")
    tstate = loop.init_state(CKPT)
    train_step, steps_run = TT.train_step, []

    def synced_step(state, *args, **kwargs):
        if steps_run:
            _sync(state, jstates[len(steps_run)])
        steps_run.append(1)
        return train_step(state, *args, **kwargs)
    monkeypatch.setattr(TT, "train_step", synced_step)
    loader = Recording(loop.make_loaders(
        train, val, os.path.join(root, "LINEMOD"), num_threads=1)[0])
    draws = None
    if device_aug:
        keys = np.random.SeedSequence([cfg.seed, 7919]).generate_state(
            2 * len(loader)).astype(np.uint32).reshape(-1, 2)

        def draws(idx, b):
            return jax_draws(jnp.asarray(keys[idx]), b, cfg.aug_cfg)
    _, steps = loop.train_epoch(tstate, loader, 0, draws=draws)
    assert steps == len(loader) == len(jstates) == len(steps_run) == 3
    # 7 records, b=2, drop_last
    losses = loop.epoch_log[-1]["losses"]
    return (jloader.batches, jlosses), (loader.batches, losses)


def test_host_augmented_epoch_matches_jax(sets, tmp_path, monkeypatch):
    (jbatches, jlosses), (batches, losses) = _epochs(sets, tmp_path,
                                                     monkeypatch, False)
    assert len(batches) == len(jbatches) == len(losses) == len(jlosses) == 3
    for b, jb in zip(batches, jbatches):
        assert set(b) == set(jb) == {"image", "mask", "hcoords", "pose",
                                     "vertex_weights"}
        assert b["image"].shape == (2,) + HW + (3,)
        np.testing.assert_allclose(b["image"].numpy(), jb["image"], rtol=0,
                                   atol=1e-6)
        for k in ("mask", "vertex_weights"):
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
        np.testing.assert_allclose(b["hcoords"], jb["hcoords"], rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_streamed_device_aug_epoch_matches_jax(sets, tmp_path,
                                              monkeypatch):
    """--device_aug without --device_data: raw uint8 batches (equal to
    JAX's), augmented in the step with JAX's draws of each step's key."""
    (jbatches, jlosses), (batches, losses) = _epochs(sets, tmp_path,
                                                     monkeypatch, True)
    assert len(losses) == len(jlosses) == 3
    for b, jb in zip(batches, jbatches):
        assert "out_hw" in b and b["image"].dtype == torch.uint8
        np.testing.assert_array_equal(b["image"].numpy(), jb["image"])
        np.testing.assert_array_equal(b["mask"], jb["mask"])
        assert tuple(b["out_hw"]) == HW     # JAX's train_epoch pops it
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_host_vertex_batch_trains_as_the_device_targets(sets, tmp_path):
    """A batch with the host's vertex targets (PoseDataset(host_vertex=
    True), JAX's _batch_vertex taking batch["vertex"]) gives the step the
    loss of the same batch whose targets are built from hcoords on the
    device."""
    from pvnet_tpu_torch.data.dataset import PoseDataset, collate
    root, train, _ = sets["port"]
    cfg = _recipe(TrainConfig.from_json(RECIPE), False)
    ds = PoseDataset(train, os.path.join(root, "LINEMOD"), cfg.vote_type,
                     augment=True, aug_cfg=cfg.aug_cfg, host_vertex=True)
    batch = collate([ds[(i, *HW)] for i in range(2)])
    assert batch["vertex"].shape == (2,) + HW + (18,)
    losses = []
    for with_vertex in (True, False):
        b = dict(batch) if with_vertex else {
            k: v for k, v in batch.items() if k != "vertex"}
        state = TrainLoop(cfg, str(tmp_path / "m"),
                          device="cpu").init_state(CKPT)
        dev = TT.host_batch(b, "cpu")
        assert ("vertex" in dev) == with_vertex
        losses.append(float(TT.train_step(state, dev)["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def _small_recipe(tmp_path):
    r = json.load(open(RECIPE))
    r.update(bf16=False, train_batch_size=2, test_batch_size=2)
    path = str(tmp_path / "recipe.json")
    with open(path, "w") as f:
        json.dump(r, f)
    return path


@pytest.mark.parametrize("flags,route", [
    ([], "host aug"), (["--device_aug"], "device aug"),
    (["--device_data"], "device data"),
    (["--device_aug", "--device_data"], "device data")])
def test_cli_routes(tree, tmp_path, capsys, flags, route):
    """python -m pvnet_tpu_torch.train --linemod_cls duck --steps 2: no
    flag trains with host augmentation, --device_aug on streamed raw
    batches, --device_data (with or without --device_aug) on the set held
    on the device."""
    root = str(tmp_path / "data")
    shutil.copytree(tree, root)
    model_dir = str(tmp_path / "model")
    assert CLI.main(["--linemod_cls", "duck", "--data_dir", root,
                     "--init", CKPT, "--steps", "2", "--buckets", "48x64",
                     "--cfg_file", _small_recipe(tmp_path), "--model_dir",
                     model_dir, "--num_threads", "2", "--device", "cpu"]
                    + flags) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["route"] == route
    assert f"; {route}; device cpu" in out
    assert summary["train_images"] == 7 and summary["val_images"] == 1
    losses = [x for e in summary["epochs"] for x in e["losses"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert all(e["wait_s"] >= 0 for e in summary["epochs"])
    assert os.path.exists(os.path.join(model_dir, "0.pth"))


def test_cli_recipe_default_is_jax_s():
    assert CLI.parse_args([]).cfg_file == os.path.join(
        REPO, "configs", "linemod_train.json")
    args = CLI.parse_args(["--device_data"])
    assert args.device_data and not args.device_aug


def test_device_data_without_device_aug_is_refused(sets, tmp_path):
    """The CLI cannot ask for it (--device_data implies --device_aug);
    fit_records raises JAX's ValueError."""
    root, train, val = sets["port"]
    cfg = _recipe(TrainConfig.from_json(RECIPE), False)
    cfg.device_data = True
    loop = TrainLoop(cfg, str(tmp_path / "m"), buckets=[HW], device="cpu")
    with pytest.raises(ValueError, match="device_data requires device_aug"):
        loop.fit_records(train, val, os.path.join(root, "LINEMOD"), "duck",
                         PathConfig(data_dir=root), init=CKPT, max_steps=1)
