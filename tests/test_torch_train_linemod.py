"""Training and evaluation from a LINEMOD tree on disk with the port
(train/loop.py fit_records, build_device_dataset_from_records, validate on
record loaders; train/__main__.py --linemod_cls, --test_model) against the
JAX package, on the CPU, on the 120x160 tree of tests/_linemod_tree.py:
the device set equals JAX's build_device_dataset, one training step from
the same weights and augmentation draws agrees with JAX's at
tests/test_torch_train_step.py's tolerances, validate on the test list
with JAX's RANSAC draws gives JAX's per-image verdicts, and the CLI trains
and tests from the tree."""
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
from pvnet_tpu.data import dataset as JD
from pvnet_tpu.data import linemod as JL
from pvnet_tpu.data.vertex import compute_vertex_targets as j_vertex
from pvnet_tpu.eval.evaluator import Evaluator as JEvaluator
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import voting as JV
from pvnet_tpu.train import trainer as JT
from pvnet_tpu.train.loop import TrainLoop as JTrainLoop
from pvnet_tpu.train.loss import total_loss as j_total_loss
from pvnet_tpu_torch.config import PathConfig, TrainConfig
from pvnet_tpu_torch.data import linemod as TL
from pvnet_tpu_torch.data.dataset import record_loader
from pvnet_tpu_torch.eval import Evaluator
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.pipeline import VoteParams
from pvnet_tpu_torch.train import __main__ as CLI
from pvnet_tpu_torch.train import trainer as TT
from pvnet_tpu_torch.train.loop import TrainLoop
from pvnet_tpu_torch.utils.weights import (flax_from_state_dict,
                                           state_dict_from_flax)

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
MINI = os.path.join(REPO, "assets", "linemod_mini")
AUG_HW = (48, 64)
IDX = [1, 0]
N_VAL = 4


@pytest.fixture(autouse=True)
def _fresh_jax_caches():
    with own_jax_caches():
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree") / "data")
    make_tree(root)
    return root


def _records(root, jax_side: bool):
    """(train records: real train list + fuse set, test list) of a copy
    of the tree for one package."""
    mod, P = (JL, JPathConfig) if jax_side else (TL, PathConfig)
    with own_jax_caches():
        db = mod.LineModImageDB("duck", has_render_set=False,
                                paths=P(data_dir=root))
    return db.train_real_set + db.fuse_set, db.test_real_set + db.val_real_set


@pytest.fixture(scope="module")
def sets(tree, tmp_path_factory):
    base = tmp_path_factory.mktemp("copies")
    out = {}
    for side in ("jax", "port"):
        root = str(base / side)
        shutil.copytree(tree, root)
        out[side] = (root,) + _records(root, side == "jax")
    return out


def _jax_cfg():
    cfg = JTrainConfig.from_json(RECIPE)
    cfg.bf16 = False
    cfg.aug_cfg.ignore_fuse_ms_vertex = True
    return cfg


def _port_cfg():
    cfg = TrainConfig.from_json(RECIPE)
    cfg.bf16 = False
    cfg.aug_cfg.ignore_fuse_ms_vertex = True
    return cfg


@pytest.fixture(scope="module")
def device_sets(sets, tmp_path_factory):
    jroot, jtrain, _ = sets["jax"]
    root, train, _ = sets["port"]
    jloop = JTrainLoop(_jax_cfg(), "duck", paths=JPathConfig(data_dir=jroot),
                       use_mesh=False)
    jdata = jloop.build_device_dataset(jtrain,
                                       os.path.join(jroot, "LINEMOD"))
    loop = TrainLoop(_port_cfg(), str(tmp_path_factory.mktemp("m")),
                     device="cpu")
    data = loop.build_device_dataset_from_records(
        train, os.path.join(root, "LINEMOD"))
    return {k: np.asarray(v) for k, v in jdata.items()}, data


def test_device_set_equals_jax(device_sets):
    jdata, data = device_sets
    assert set(data) == set(jdata) == {"image", "mask", "hcoords", "ignore"}
    assert data["image"].shape == (7, 120, 160, 3)      # 5 real + 2 fuse
    for k in ("image", "mask"):
        assert data[k].dtype == torch.uint8
        np.testing.assert_array_equal(data[k].numpy(), jdata[k], err_msg=k)
    np.testing.assert_allclose(data["hcoords"].numpy(), jdata["hcoords"],
                               rtol=1e-6)
    np.testing.assert_array_equal(data["ignore"].numpy(), jdata["ignore"])
    assert data["ignore"].numpy().tolist() == [0] * 5 + [1, 1]


def test_device_set_refuses_mixed_sizes(sets, tmp_path):
    """JAX's uniform-size check: a crop of the truncated set among the
    frames."""
    root, train, _ = sets["port"]
    with own_jax_caches():
        crops = TL.TruncatedLineModImageDB(
            "duck", paths=PathConfig(data_dir=root)).set
    loop = TrainLoop(_port_cfg(), str(tmp_path / "m"), device="cpu")
    with pytest.raises(ValueError, match="uniform image sizes"):
        loop.build_device_dataset_from_records(
            train[:2] + crops[:1], os.path.join(root, "LINEMOD"))


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def steps(device_sets):
    """One training step on frames 1 and 0 of the device sets from the
    duck checkpoint's weights with JAX's augmentation draws: JAX's
    (_apply_device_aug, NCHW, jax.grad of total_loss), the port's whole
    train_step_from_data, and the port's train_step on JAX's augmented
    batch."""
    jdata, data = device_sets
    jcfg = _jax_cfg()
    fmodel = build_flax("resnet18_8s", ver_dim=18, head_layout="NCHW",
                        input_layout="NCHW")
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    key = jax.random.PRNGKey(5)
    jd = {k: jnp.asarray(v) for k, v in jdata.items()}

    def jax_step(params, batch_stats):
        batch = {k: v[jnp.asarray(IDX)] for k, v in jd.items()}
        batch = JT._apply_device_aug(batch, key, jcfg.aug_cfg, AUG_HW,
                                     image_layout="NCHW")
        vert = j_vertex(batch["mask"], batch["hcoords"], layout="NCHW")
        vw = batch["vertex_weights"]
        vw = vw.reshape(vw.shape[0], 1, *vw.shape[1:3])

        def loss_fn(p):
            (sp, vp), _ = fmodel.apply(
                {"params": p, "batch_stats": batch_stats}, batch["image"],
                train=True, mutable=["batch_stats"])
            loss, met = j_total_loss(sp, vp, batch["mask"], vert, vw,
                                     channel_axis=1)
            return loss, met
        grads, met = jax.grad(loss_fn, has_aux=True)(params)
        return grads, met, batch

    jgrads, jmet, jbatch = jax.jit(jax_step)(variables["params"],
                                             variables["batch_stats"])
    cfg = _port_cfg()
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.array, variables))

    def port_state():
        model = build_model("resnet18_8s", ver_dim=18)
        model.load_state_dict(sd)
        return TT.create_train_state(model, cfg)

    def grads_of(state):
        params = dict(state.model.named_parameters())
        return dict(_leaves(flax_from_state_dict({
            k: params[k].grad if k in params else v
            for k, v in state.model.state_dict().items()})["params"]))

    state = port_state()
    draws = jax_draws(key, 2, cfg.aug_cfg)
    metrics = TT.train_step_from_data(state, data, torch.tensor(IDX),
                                      draws=draws, aug_cfg=cfg.aug_cfg,
                                      aug_hw=AUG_HW)
    batch = TT.apply_device_aug({k: v[torch.tensor(IDX)]
                                 for k, v in data.items()},
                                cfg.aug_cfg, AUG_HW, draws=draws)
    same = port_state()
    TT.train_step(same, {k: torch.from_numpy(np.array(v))
                         for k, v in jbatch.items()
                         if k in ("image", "mask", "hcoords", "ignore")})
    return {"jax": (dict(_leaves(jgrads)), jmet, jbatch),
            "whole": (grads_of(state), metrics, batch),
            "same": grads_of(same)}


def _grad_errors(got, want):
    assert set(got) == set(want) and len(got) == 77
    rel = {k: np.linalg.norm(got[k] - w) / np.linalg.norm(w)
           for k, w in want.items()}
    total = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items())
                    / sum(np.sum(w ** 2) for w in want.values()))
    return rel, total


def test_training_batch_matches_jax(steps):
    """The augmented batch at tests/test_torch_augment.py's tolerances."""
    jbatch = steps["jax"][2]
    tb = steps["whole"][2]
    ti, wi = tb["image"].numpy(), np.asarray(jbatch["image"])
    assert ti.shape == wi.shape == (2, 3) + AUG_HW
    assert (np.abs(ti - wi) > 1e-4).mean() <= 0.005
    assert (tb["mask"].numpy() == np.asarray(jbatch["mask"])).mean() >= 0.99
    np.testing.assert_allclose(tb["hcoords"].numpy(),
                               np.asarray(jbatch["hcoords"]), rtol=1e-5,
                               atol=1e-4)


def test_training_step_matches_jax(steps):
    """tests/test_torch_train_step.py's tolerances: the loss and metrics
    of the whole step within rtol 1e-4; on JAX's own batch each gradient
    within 3e-3 of its norm and all within 1e-3; over the whole step,
    the port's augmentation included, within 3e-2 and 5e-3."""
    jgrads, jmet, _ = steps["jax"]
    whole, metrics, _ = steps["whole"]
    assert set(metrics) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k]), float(jmet[k]),
                                   rtol=1e-4, err_msg=k)
    rel, total = _grad_errors(steps["same"], jgrads)
    assert max(rel.values()) < 3e-3, max(rel.items(), key=lambda kv: kv[1])
    assert total < 1e-3
    rel, total = _grad_errors(whole, jgrads)
    assert max(rel.values()) < 3e-2, max(rel.items(), key=lambda kv: kv[1])
    assert total < 5e-3


def _jax_draws(keys, params):
    """JAX's plain-path draws of each batch (ransac_voting_v3's two
    splits of the batch key), in the port's keyword form."""
    def u(k, shape):
        return torch.tensor(np.asarray(jax.random.uniform(k, shape,
                                                          jnp.float32)))

    def draws(bidx, b, h, w):
        k1, k2 = jax.random.split(keys[bidx])
        return {"noise": u(k1, (b, h, w)),
                "pair_u": u(k2, (b, params.hyp_num, 2))}
    return draws


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """Copies of assets/linemod_mini (480x640, the duck model's own
    frames) for each package, with the first N_VAL records of each one's
    test list."""
    base = tmp_path_factory.mktemp("mini")
    out = {}
    for side in ("jax", "port"):
        root = str(base / side)
        shutil.copytree(MINI, root)
        out[side] = (root, _records(root, side == "jax")[1][:N_VAL])
    return out


def test_validate_on_the_test_list_matches_jax(mini, tmp_path,
                                               monkeypatch):
    """The first 4 frames of assets/linemod_mini's test list, one batch,
    f32, the duck checkpoint, tail_depth 0: JAX's TrainLoop.validate on
    its PoseDataset / Prefetcher with its plain path's selection forced to
    'stratified' (the port's; off the TPU JAX's 'auto' picks top-k), and
    the port's validate on its record loader with JAX's draws. Per-image
    2D / ADD / 5cm5deg verdicts equal; errors within
    tests/test_torch_eval.py's 15 mm / 2 px."""
    jroot, jtest = mini["jax"]
    root, test = mini["port"]
    orig = JV.sample_foreground
    monkeypatch.setattr(JV, "sample_foreground", lambda *a, **k: orig(
        *a, **dict(k, method="stratified")))
    jcfg = _jax_cfg()
    jcfg.test_batch_size = N_VAL
    paths = JPathConfig(data_dir=jroot)
    jloop = JTrainLoop(jcfg, "duck", paths=paths, use_mesh=False)
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    state = jloop.init_state(input_hw=(64, 64)).replace(
        params=variables["params"], batch_stats=variables["batch_stats"])
    keys = []
    orig_fold = jax.random.fold_in

    def fold(key, i):
        k = orig_fold(key, i)
        keys.append(k)
        return k
    monkeypatch.setattr(jax.random, "fold_in", fold)
    with own_jax_caches():
        jev = JEvaluator(jloop.object_meta())
    loader = JD.Prefetcher(
        JD.PoseDataset(jtest, paths.linemod_dir, jcfg.vote_type,
                       aug_cfg=jcfg.aug_cfg),
        JD.ImageSizeBatchSampler(range(len(jtest)), N_VAL,
                                 aug_cfg=jcfg.aug_cfg, shuffle=False))
    jloop.validate(state, loader, 0, evaluate_pose=True, evaluator=jev)
    monkeypatch.setattr(jax.random, "fold_in", orig_fold)
    assert len(keys) == 1

    cfg = _port_cfg()
    cfg.test_batch_size = N_VAL
    loop = TrainLoop(cfg, str(tmp_path / "m"), device="cpu")
    tstate = loop.init_state(CKPT)
    ev = Evaluator(loop.linemod_object_meta("duck",
                                            PathConfig(data_dir=root)))
    loop.validate(tstate, record_loader(test, os.path.join(root, "LINEMOD"),
                                        cfg.vote_type, N_VAL),
                  0, evaluate_pose=True, evaluator=ev,
                  draws=_jax_draws(keys, VoteParams()))
    for name in ("add_recorder", "projection_2d_recorder",
                 "cm_degree_5_recorder"):
        assert getattr(ev, name) == getattr(jev, name), name
    assert sum(ev.projection_2d_recorder) >= 1    # poses the model gets
    assert ev.average_precision(False) == jev.average_precision(False)
    np.testing.assert_allclose(ev.add_dists, jev.add_dists, rtol=0,
                               atol=0.015)
    np.testing.assert_allclose(ev.proj_mean_diffs, jev.proj_mean_diffs,
                               rtol=0, atol=2.0)


def _small_recipe(tmp_path):
    r = json.load(open(RECIPE))
    r.update(bf16=False, train_batch_size=2, test_batch_size=4)
    path = str(tmp_path / "recipe.json")
    with open(path, "w") as f:
        json.dump(r, f)
    return path


def test_cli_trains_and_tests_from_the_tree(tree, tmp_path, capsys):
    """python -m pvnet_tpu_torch.train --linemod_cls duck --steps 2, then
    --test_model --occluded --truncated, on the CPU."""
    root = str(tmp_path / "data")
    shutil.copytree(tree, root)
    recipe = _small_recipe(tmp_path)
    model_dir = str(tmp_path / "model")
    assert CLI.main(["--linemod_cls", "duck", "--data_dir", root,
                     "--init", CKPT, "--steps", "2", "--buckets", "48x64",
                     "--cfg_file", recipe, "--model_dir", model_dir,
                     "--device_data", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["train_images"] == 5 and summary["val_images"] == 1
    losses = [x for e in summary["epochs"] for x in e["losses"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert os.path.exists(os.path.join(model_dir, "0.pth"))
    assert CLI.main(["--test_model", "--linemod_cls", "duck", "--data_dir",
                     root, "--occluded", "--truncated", "--use_test_set",
                     "--cfg_file", recipe, "--model_dir", model_dir,
                     "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["class"] == "duck" and out["dtype"] == "f32"
    assert {k: v["images"] for k, v in out["sets"].items()} == {
        "test": 5, "occ_test": 2, "trun_test": 8}
    for r in out["sets"].values():
        assert all(0.0 <= r[m] <= 1.0 for m in ("proj", "add", "cm"))
