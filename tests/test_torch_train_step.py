"""One whole training step of the port (train_step_from_data: gather,
device augmentation, vertex targets, forward/backward, Adam) against the
JAX package's train_step_from_data pieces, on the CPU, at b=2, 64x80
frames to 48x64, float32, from the same flax-initialized weights carried
over with state_dict_from_flax and with JAX's own augmentation draws.

JAX's side is its step as tools/train.py --device_data runs it
(_apply_device_aug with the NCHW image, NCHW head, total_loss with
channel_axis=1), with jax.grad taken of the same loss, and the mutated
batch_stats."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_aug_draws import jax_draws, raw_batch
from pvnet_tpu.config import TrainConfig as JTrainConfig
from pvnet_tpu.data.vertex import compute_vertex_targets as j_vertex
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.train import trainer as JT
from pvnet_tpu.train.loss import total_loss as j_total_loss
from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.train import trainer as TT
from pvnet_tpu_torch.utils.weights import (flax_from_state_dict,
                                           state_dict_from_flax)

torch.set_num_threads(2)

RECIPE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "synthetic_train.json")
HW = (48, 64)
IDX = [1, 0]


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.fixture(scope="module")
def steps():
    jcfg = JTrainConfig.from_json(RECIPE)
    images, masks, hcoords = raw_batch()
    fmodel = build_flax("resnet18_8s", ver_dim=18, head_layout="NCHW",
                        input_layout="NCHW")
    variables = jax.jit(lambda k: fmodel.init(
        k, jnp.zeros((1, 3) + HW), train=False))(jax.random.PRNGKey(0))
    data = {"image": jnp.asarray(images), "mask": jnp.asarray(masks),
            "hcoords": jnp.asarray(hcoords), "ignore": jnp.zeros((2,))}
    key = jax.random.PRNGKey(5)

    def jax_step(params, batch_stats):
        idx = jnp.asarray(IDX)
        batch = {k: v[idx] for k, v in data.items()}
        batch = JT._apply_device_aug(batch, key, jcfg.aug_cfg, HW,
                                     image_layout="NCHW")
        vert = j_vertex(batch["mask"], batch["hcoords"], layout="NCHW")
        vw = batch["vertex_weights"]
        vw = vw.reshape(vw.shape[0], 1, *vw.shape[1:3])

        def loss_fn(p):
            (sp, vp), mut = fmodel.apply(
                {"params": p, "batch_stats": batch_stats}, batch["image"],
                train=True, mutable=["batch_stats"])
            loss, met = j_total_loss(sp, vp, batch["mask"], vert, vw,
                                     channel_axis=1)
            return loss, (met, mut["batch_stats"])
        grads, (met, stats) = jax.grad(loss_fn, has_aux=True)(params)
        return grads, met, stats, batch

    jgrads, jmet, jstats, jbatch = jax.jit(jax_step)(
        variables["params"], variables["batch_stats"])

    cfg = TrainConfig.from_json(RECIPE)
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.array, variables))

    def port_state():
        model = build_model("resnet18_8s", ver_dim=18)
        model.load_state_dict(sd)
        return TT.create_train_state(model, cfg)

    def grads_of(state):
        params = dict(state.model.named_parameters())
        return flax_from_state_dict({
            k: params[k].grad if k in params else v
            for k, v in state.model.state_dict().items()})

    # (a) the port's whole step on the raw data, JAX's draws
    state = port_state()
    draws = jax_draws(key, 2, cfg.aug_cfg)
    tdata = {"image": torch.from_numpy(images),
             "mask": torch.from_numpy(masks),
             "hcoords": torch.from_numpy(hcoords), "ignore": torch.zeros(2)}
    metrics = TT.train_step_from_data(state, tdata, torch.tensor(IDX),
                                      draws=draws, aug_cfg=cfg.aug_cfg,
                                      aug_hw=HW)
    tbatch = TT.apply_device_aug({k: v[torch.tensor(IDX)]
                                  for k, v in tdata.items()},
                                 cfg.aug_cfg, HW, draws=draws)
    whole = grads_of(state)
    whole["metrics"] = metrics
    whole["batch"] = tbatch

    # (b) the port's step on JAX's own augmented batch
    state_b = port_state()
    TT.train_step(state_b, {k: torch.from_numpy(np.array(v))
                            for k, v in jbatch.items()
                            if k in ("image", "mask", "hcoords", "ignore")})
    same = grads_of(state_b)
    return {"jax": (jgrads, jmet, jstats, jbatch), "whole": whole,
            "same": same}


def test_augmented_batch_matches_jax(steps):
    """Tolerances of tests/test_torch_augment.py."""
    jbatch = steps["jax"][3]
    tb = steps["whole"]["batch"]
    ti, wi = tb["image"].numpy(), np.asarray(jbatch["image"])
    assert ti.shape == wi.shape == (2, 3) + HW
    assert (np.abs(ti - wi) > 1e-4).mean() <= 0.005
    assert (tb["mask"].numpy() == np.asarray(jbatch["mask"])).mean() >= 0.99
    np.testing.assert_allclose(tb["hcoords"].numpy(),
                               np.asarray(jbatch["hcoords"]), rtol=1e-5,
                               atol=1e-4)


def test_loss_and_metrics_match_jax(steps):
    """Both sides in float32 on near-equal batches: rtol 1e-4 (measured
    ~1e-6); precision and recall count pixels, equal up to a flipped one."""
    jmet = steps["jax"][1]
    met = steps["whole"]["metrics"]
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-4,
                                   err_msg=k)


def test_batch_stats_match_jax(steps):
    """The running statistics after the step: flax's biased-variance update
    (models/resnet.BatchNorm2d); within 1e-4 of each tensor's largest value
    (measured 6e-6)."""
    want = dict(_leaves(steps["jax"][2]))
    got = dict(_leaves(steps["whole"]["batch_stats"]))
    assert set(got) == set(want) and len(got) == 2 * 25
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def _grad_errors(got_tree, want_tree):
    want = dict(_leaves(want_tree))
    got = dict(_leaves(got_tree))
    assert set(got) == set(want) and len(got) == 77
    rel = {k: np.linalg.norm(got[k] - w) / np.linalg.norm(w)
           for k, w in want.items()}
    total = np.sqrt(sum(np.sum((got[k] - w) ** 2) for k, w in want.items())
                    / sum(np.sum(w ** 2) for w in want.values()))
    return rel, total


def test_gradients_match_jax_on_the_same_batch(steps):
    """The port's forward/backward on JAX's augmented batch: each
    parameter's gradient within 3e-3 of its norm (f32 convolutions summed
    in another order through 20 BatchNorm layers at a random init; measured
    <= 6e-4)."""
    rel, total = _grad_errors(steps["same"]["params"], steps["jax"][0])
    assert max(rel.values()) < 3e-3, max(rel.items(), key=lambda kv: kv[1])
    assert total < 1e-3


def test_gradients_match_jax_over_the_whole_step(steps):
    """The whole step, the port's own augmentation included: its batch
    differs from JAX's by ~1e-5, which the random-init network amplifies in
    the deepest layers. Each gradient within 3e-2 of its norm (measured
    <= 5.4e-3), all together within 5e-3."""
    rel, total = _grad_errors(steps["whole"]["params"], steps["jax"][0])
    assert max(rel.values()) < 3e-2, max(rel.items(), key=lambda kv: kv[1])
    assert total < 5e-3
