"""The packed inference tail (ops/packed_tail.py) and the packed4 stem
behind resnet34_8s and resnet50_8s, against the JAX package's
``packed_tail_{,deep_,deep3_}from_variables`` and ``fold_stem_params``.

The folds read the decoder's conv4s, conv2s and convraw, whose input
widths follow the backbone (resnet50's Bottleneck widens the 8s and 4s
skips four times, and its decoder is wider), so each depth is held at both
networks. One random model per network (the seeded He init, random
BatchNorm statistics) is carried across to flax by utils/weights.flax_
from_state_dict, at a [2, 96, 128] crop. Tolerances are tests/test_torch_packed_
tail.py's: float32 fields within rtol 2e-4 / atol 2e-5, foreground
counts exactly; the packed4 model's fields within
tests/test_torch_packed_stem.py's rtol / atol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.models import resnet as JR
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import packed_tail as JPT
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.models.resnet import init_weights
from pvnet_tpu_torch.ops import packed_tail as TPT
from pvnet_tpu_torch.utils.weights import (flax_from_state_dict,
                                           fold_stem_state_dict,
                                           state_dict_from_flax)

torch.set_num_threads(1)
NETWORKS = ("resnet34_8s", "resnet50_8s")
VER_DIM = 6


def _model(network):
    """The port's model of ``network`` from the JAX models' seeded init,
    with random BatchNorm statistics (so the folds' affine is exercised),
    and the same weights as flax variables (utils/weights.flax_from_
    state_dict; its inverse is held by tests/test_torch_model_family.py)."""
    model = build_model(network, ver_dim=VER_DIM, seg_dim=2)
    g = torch.Generator().manual_seed(len(network))
    init_weights(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t in (m.running_mean, m.running_var):
                    t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    variables = flax_from_state_dict(model.state_dict())
    x = np.random.RandomState(len(network)).randn(2, 96, 128, 3).astype(
        np.float32)
    return (build_flax(network, ver_dim=VER_DIM, seg_dim=2), variables,
            model.eval(), x)


@pytest.fixture(scope="module", params=NETWORKS)
def family(request):
    return (request.param, *_model(request.param))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _port(model, xt, depth):
    with torch.no_grad():
        if depth == 3:
            return TPT.packed_tail_deep3_from_model(
                model, *model(xt, return_8s_features=True), xt,
                dtype=torch.float32)
        if depth == 2:
            return TPT.packed_tail_deep_from_model(
                model, *model(xt, return_4s_features=True), xt,
                dtype=torch.float32)
        return TPT.packed_tail_from_model(
            model, model(xt, return_2s_features=True), xt,
            dtype=torch.float32)


def _jax(fmodel, variables, x, depth):
    def feats(**kw):
        return fmodel.apply(variables, x, train=False, **kw)
    if depth == 3:
        return JPT.packed_tail_deep3_from_variables(
            variables, *feats(return_8s_features=True), x,
            dtype=jnp.float32)
    if depth == 2:
        return JPT.packed_tail_deep_from_variables(
            variables, *feats(return_4s_features=True), x,
            dtype=jnp.float32)
    return JPT.packed_tail_from_variables(
        variables, feats(return_2s_features=True), x, dtype=jnp.float32)


def test_fold_widths_follow_the_backbone(family):
    network, _, variables, model, _ = family
    p = variables["params"]
    cp4 = TPT._fold_stage(model.conv4s, model.conv8s[0].out_channels, 24, 32)
    want = JPT.fold_packed_stage(
        p["Conv_2"]["kernel"], p["BatchNorm_2"]["scale"],
        p["BatchNorm_2"]["bias"], variables["batch_stats"]["BatchNorm_2"]
        ["mean"], variables["batch_stats"]["BatchNorm_2"]["var"],
        model.conv8s[0].out_channels, 24, 32)
    np.testing.assert_array_equal(cp4.w_fm.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(want.w_fm))
    np.testing.assert_array_equal(cp4.w_skip.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(want.w_skip))
    # the 4s skip is 64 x the block's expansion wide (4 for Bottleneck)
    skip = model.conv4s[0].in_channels - model.conv8s[0].out_channels
    assert skip == (256 if network == "resnet50_8s" else 64)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_packed_field_and_fgcnt_match_jax(family, depth):
    _, fmodel, variables, model, x = family
    packed, fgcnt = _port(model, _nchw(x), depth)
    want_p, want_c = _jax(fmodel, variables, x, depth)
    assert packed.shape == (2, 48, 64, 4 * (2 + VER_DIM))
    want_p = np.asarray(want_p)
    np.testing.assert_allclose(packed.numpy(), want_p, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_array_equal(fgcnt.numpy(), np.asarray(want_c))


def test_packed4_stem_matches_jax(family):
    network, _, variables, model, x = family
    folded = JR.fold_stem_params(variables)
    got = fold_stem_state_dict(state_dict_from_flax(variables))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.array, folded))
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    stem = f"{network}.conv1.weight"
    assert got[stem].shape == (64, 12, 4, 4)

    fmodel4 = build_flax(network, ver_dim=VER_DIM, seg_dim=2, stem="packed4")
    model4 = build_model(network, ver_dim=VER_DIM, seg_dim=2, stem="packed4")
    model4.load_state_dict(got)
    seg_j, ver_j = fmodel4.apply(folded, x, train=False)
    xt = _nchw(x)
    with torch.no_grad():
        seg4, ver4 = model4.eval()(xt)
        seg7, ver7 = model(xt)
    for g, w in ((seg4, seg_j), (ver4, ver_j)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=1e-4, atol=1e-4)
    # the folded stem computes the conv7 model's function
    for g, w in ((seg4, seg7), (ver4, ver7)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
