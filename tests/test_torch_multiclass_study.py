"""The port's multi-class study (python -m pvnet_tpu_torch.multiclass_study)
against the JAX study (tools/multiclass_study.py) at --quick shapes (8 + 4
scenes at 120x160, b=4): two float32 training steps from carried JAX
weights on the study's minibatches, the evaluation forward (labels and
multi-class keypoints from JAX's draws; JAX's voting op by op, ROADMAP
F4) and the per-class rates; and the CLI end to end."""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.config import IMAGENET_MEAN, IMAGENET_STD
from pvnet_tpu.config import TrainConfig as JTrainConfig
from pvnet_tpu.eval.evaluator import Evaluator as JEvaluator
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import voting as JV
from pvnet_tpu.train import trainer as JT
from pvnet_tpu_torch import multiclass_study as MS
from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.data.vertex import compute_vertex_targets_multiclass
from pvnet_tpu_torch.eval.evaluator import Evaluator
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.train import trainer as TT
from pvnet_tpu_torch.utils.weights import (flax_from_state_dict,
                                           state_dict_from_flax)

sys.path.insert(0, __file__.rsplit("/", 2)[0] + "/tools")
import multiclass_study as JMS  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def study():
    """The --quick study's splits (the JAX study's own generator), its
    minibatches, and two float32 steps on each side from the same
    weights."""
    args = MS.parse_args(["--quick"])
    h, w, b = args.height, args.width, args.batch
    K = MS.study_K(h, w)
    np.testing.assert_array_equal(K, _jax_K(h, w))
    classes = JMS.build_class_set()
    metas = [JMS.class_meta(*c) for c in classes]
    tr = JMS.generate_split(classes, metas, args.train_images, K, h, w, 0)
    te = JMS.generate_split(classes, metas, args.test_images, K, h, w, 1)
    perm = np.random.RandomState(7).permutation(args.train_images)
    steps = [perm[s * b:(s + 1) * b] for s in range(2)]

    jcfg = JTrainConfig(model_name="multiclass_study", lr=args.lr,
                        train_batch_size=b)
    fmodel = build_flax("resnet18_8s", ver_dim=18, seg_dim=4)
    jstate = JT.create_train_state(fmodel, jcfg, (1, h, w, 3),
                                   jax.random.PRNGKey(0))
    jstate = JT.set_learning_rate(jstate, JT.lr_for_epoch(jcfg, 0))
    data = {"image": jnp.asarray(tr[0]), "mask": jnp.asarray(tr[1]),
            "hcoords": jnp.asarray(tr[2])}
    mean, std = jnp.asarray(IMAGENET_MEAN), jnp.asarray(IMAGENET_STD)

    @jax.jit
    def jstep(state, idx):                  # the JAX study's step
        img = data["image"][idx].astype(jnp.float32) / 255.0
        batch = {"image": (img - mean) / std,
                 "mask": data["mask"][idx].astype(jnp.int32),
                 "hcoords": data["hcoords"][idx]}
        batch["vertex_weights"] = (batch["mask"] > 0)[..., None].astype(
            jnp.float32)
        return JT.train_step(state, batch,
                             vertex_loss_ratio=jcfg.vertex_loss_ratio)

    model = build_model("resnet18_8s", ver_dim=18, seg_dim=4)
    model.load_state_dict(state_dict_from_flax(jax.tree_util.tree_map(
        np.array, {"params": jstate.params,
                   "batch_stats": jstate.batch_stats})))
    cfg = TrainConfig(model_name="multiclass_study", lr=args.lr,
                      train_batch_size=b)
    state = TT.create_train_state(model, cfg)
    TT.set_learning_rate(state, TT.lr_for_epoch(cfg, 0))
    tdata = {"image": torch.from_numpy(tr[0]),
             "mask": torch.from_numpy(tr[1]),
             "hcoords": torch.from_numpy(tr[2])}
    jmet, tmet, before = [], [], None
    for idx in steps:
        if before is not None:
            _sync(state, jstate)
            before = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            before = {k: v.clone() for k, v in model.state_dict().items()}
        jstate, m = jstep(jstate, jnp.asarray(idx))
        jmet.append({k: float(v) for k, v in m.items()})
        m = MS.study_step(state, tdata, torch.from_numpy(idx), bf16=False)
        tmet.append({k: float(v) for k, v in m.items()})
    return dict(args=args, K=K, metas=metas, te=te, fmodel=fmodel,
                jstate=jstate, state=state, jmet=jmet, tmet=tmet,
                before=before)


def _port_names(tree, stats):
    """A flax tree shaped like the params -> the port's names."""
    return state_dict_from_flax(jax.tree_util.tree_map(
        np.array, {"params": tree, "batch_stats": stats}))


def _sync(state, jstate):
    """Carry JAX's weights, statistics and Adam moments into the port's
    state, so that the next step starts from the same point on both
    sides (Adam's first step moves each weight by ~lr whatever its
    gradient's size, so two float32 steps run apart otherwise)."""
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


def _jax_K(h, w):
    from pvnet_tpu.config import LINEMOD_K
    K = LINEMOD_K.copy()
    K[0] *= w / 640.0
    K[1] *= h / 480.0
    return K


def test_two_study_steps_match_jax(study):
    """tests/test_torch_multiclass.py's train-step tolerance on each
    step's loss and metrics (rtol 1e-4); the second step's update of each
    weight and statistic against JAX's within 3e-2 of its norm, all of
    them within 5e-3."""
    for j, t in zip(study["jmet"], study["tmet"]):
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
    jstate = study["jstate"]
    want = _port_names(jstate.params, jstate.batch_stats)
    got = study["state"].model.state_dict()
    before = study["before"]
    rel, diff2, upd2 = {}, 0.0, 0.0
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            continue
        du = (want[k] - before[k]).double()
        d = (v - want[k]).double()
        rel[k] = float(d.norm() / du.norm())
        diff2 += float((d ** 2).sum())
        upd2 += float((du ** 2).sum())
    # measured: worst tensor 2.4e-2 of its update, all 1.6e-3 (the
    # bounds of tests/test_torch_train_step.py's whole-step gradients)
    assert max(rel.values()) < 3e-2, max(rel.items(), key=lambda kv: kv[1])
    assert (diff2 / upd2) ** 0.5 < 5e-3


class _Fixed(torch.nn.Module):
    """A model returning fixed (seg, ver) whatever its input."""

    def __init__(self, seg, ver):
        super().__init__()
        self.out = (seg, ver)

    def forward(self, x):
        return self.out


def _class_draws(key, b, hw, hn, C):
    """JAX's per-class draws of ransac_voting_multiclass with top-k
    selection (its 'auto' off the TPU): for each class, key, sub =
    split(key); noise and pair uniforms from split(sub)."""
    noise, pair = [], []
    for _ in range(C):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        noise.append(np.asarray(jax.random.uniform(k1, (b, hw))))
        pair.append(np.asarray(jax.random.uniform(k2, (b, hn, 2))))
    return torch.tensor(np.stack(noise)), torch.tensor(np.stack(pair))


def test_eval_forward_and_rates_match_jax(study):
    """The JAX study's eval_fwd (float32 here) and the port's
    eval_forward with the trained JAX weights and JAX's draws: the same
    labels, fields within tests/test_torch_model.py's tolerance; from the
    same labels, field and draws keypoints within 1e-3 px
    (tests/test_torch_multiclass.py); and each class's three rates of the
    two evaluations equal."""
    args, metas, te = study["args"], study["metas"], study["te"]
    images, masks, _, poses = te
    b, h, w = masks.shape
    jstate = study["jstate"]
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    key = jax.random.fold_in(jax.random.PRNGKey(0), 999)
    mean, std = jnp.asarray(IMAGENET_MEAN), jnp.asarray(IMAGENET_STD)
    img = (jnp.asarray(images).astype(jnp.float32) / 255.0 - mean) / std
    seg, ver = jax.jit(lambda v, x: study["fmodel"].apply(
        v, x, train=False))(variables, img)
    labels = jnp.argmax(seg, axis=-1)
    with jax.disable_jit():
        jkps = np.asarray(JV.ransac_voting_multiclass(
            labels, ver.reshape(b, h, w, 9, 2), key, class_num=4,
            hyp_num=MS.HYP_NUM, max_num=MS.MAX_NUM))

    model = build_model("resnet18_8s", ver_dim=18, seg_dim=4)
    model.load_state_dict(_port_names(jstate.params, jstate.batch_stats))
    noise, pair = _class_draws(key, b, h * w, MS.HYP_NUM, 3)
    draws = dict(noise=noise, pair_u=pair, select_method="topk")
    tlabels, tkps = MS.eval_forward(model, torch.from_numpy(images), 4,
                                    bf16=False, **draws)
    np.testing.assert_array_equal(tlabels.numpy(), np.asarray(labels))
    assert tkps.shape == (b, 3, 9, 2)
    with torch.no_grad():
        tseg, tver = model.eval()(torch.from_numpy(np.array(img))
                                  .permute(0, 3, 1, 2))
    for got, want in ((tseg, seg), (tver, ver)):
        want = np.asarray(want).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    # the vote from the same labels, field and draws: the ground truth's,
    # whose refits are well conditioned (a two-step network's field makes
    # them ill-conditioned, and the FCNs' 1e-6 differences then move
    # keypoints by up to ~0.05 px, as chip_smoke.py (k2) shows on the card)
    masks_t = torch.from_numpy(masks)
    field = compute_vertex_targets_multiclass(masks_t,
                                              torch.from_numpy(te[2]))
    onehot = torch.nn.functional.one_hot(masks_t.long(), 4).permute(
        0, 3, 1, 2).float() * 10.0
    with jax.disable_jit():
        gkps = np.asarray(JV.ransac_voting_multiclass(
            jnp.asarray(masks.astype(np.int32)),
            jnp.asarray(field.permute(0, 2, 3, 1).numpy()).reshape(
                b, h, w, 9, 2), key, class_num=4, hyp_num=MS.HYP_NUM,
            max_num=MS.MAX_NUM))
    glabels, vkps = MS.eval_forward(_Fixed(onehot, field),
                                    torch.from_numpy(images), 4,
                                    bf16=False, **draws)
    assert torch.equal(glabels, masks_t.long())
    np.testing.assert_allclose(vkps.numpy(), gkps, rtol=0, atol=1e-3)


    Ks = np.broadcast_to(study["K"].astype(np.float32), (b, 3, 3))
    for c, meta in enumerate(metas):
        jev = JEvaluator(meta)
        jev.evaluate_batch(jkps[:, c], poses[:, c], Ks)
        tev = Evaluator(meta)
        tev.evaluate_batch(tkps[:, c].numpy(), poses[:, c], Ks)
        assert tev.average_precision(False) == jev.average_precision(False)


def test_cli_quick_writes_metrics_and_loadable_weights(tmp_path, capsys):
    from pvnet_tpu_torch.utils.weights import load_weights
    out = str(tmp_path / "study")
    assert MS.main(["--quick", "--device", "cpu", "--out_dir", out]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(line) for line in lines[-4:-1]]
    assert [r["class"] for r in rows] == ["duck", "box", "cyl"]
    assert [r["metric"] for r in rows] == ["ADD", "ADD-S", "ADD"]
    assert set(rows[0]) == {"class", "symmetric", "metric", "proj", "add",
                            "cm5deg5"}
    assert set(json.loads(lines[-1])) == {"seg_accuracy"}
    metrics = json.load(open(os.path.join(out, "metrics.json")))
    assert {"seg_accuracy", "train_images", "test_images", "epochs", "hw",
            "rows"} <= set(metrics)
    assert metrics["rows"] == rows and metrics["hw"] == [120, 160]
    assert len(metrics["epoch_loss"]) == 2
    assert np.isfinite(metrics["epoch_loss"]).all()
    model = build_model("resnet18_8s", ver_dim=18, seg_dim=4)
    load_weights(model, os.path.join(out, "params.pth"))
