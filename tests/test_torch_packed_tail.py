"""The port's packed inference tail (ops/packed_tail.py) and packed
foreground sampler against pvnet_tpu.ops.packed_tail / voting, on the
model of tests/test_packed_tail.py (resnet18_8s, ver_dim=6, [2, 32, 64, 3])
with its flax weights carried across by utils/weights.state_dict_from_flax.

Tolerances are test_packed_tail.py's: float32 fields within rtol 2e-4 /
atol 2e-5 (the same products summed in another order), bfloat16 within
0.02 of the field's scale; foreground counts, folded weights' scatter
positions and sampled pixels exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import packed_tail as JPT
from pvnet_tpu.ops import voting as JV
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.ops import packed_tail as TPT
from pvnet_tpu_torch.ops import voting as TV
from pvnet_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    fmodel = build_flax("resnet18_8s", ver_dim=6, seg_dim=2)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 64, 3).astype(np.float32)
    variables = fmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            train=False)
    # non-trivial BatchNorm statistics, so the folds' affine is exercised
    stats = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32),
        variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    model = build_model("resnet18_8s", ver_dim=6, seg_dim=2)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.array, variables)))
    model.eval()
    return fmodel, variables, model, x


def _hwio(w_oihw):
    return w_oihw.permute(2, 3, 1, 0).numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def test_folded_weights_match_jax(models):
    _, variables, model, _ = models
    p, bs = variables["params"], variables["batch_stats"]
    cp = TPT._fold_stage(model.conv4s, 128, 8, 16)
    want = JPT.fold_packed_stage(
        p["Conv_2"]["kernel"], p["BatchNorm_2"]["scale"],
        p["BatchNorm_2"]["bias"], bs["BatchNorm_2"]["mean"],
        bs["BatchNorm_2"]["var"], 128, 8, 16)
    np.testing.assert_array_equal(_hwio(cp.w_fm), np.asarray(want.w_fm))
    np.testing.assert_array_equal(_hwio(cp.w_skip), np.asarray(want.w_skip))
    for name in ("ah", "aw"):
        np.testing.assert_array_equal(getattr(cp, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("scale4", "bias4"):
        np.testing.assert_allclose(getattr(cp, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6)
    assert cp.w_fm.is_contiguous(memory_format=torch.channels_last)

    tp = TPT._fold_tail(model, 32, 64, 16, 32)
    want = JPT.fold_packed_tail(
        p["Conv_4"]["kernel"], p["BatchNorm_4"]["scale"],
        p["BatchNorm_4"]["bias"], bs["BatchNorm_4"]["mean"],
        bs["BatchNorm_4"]["var"], p["Conv_5"]["kernel"],
        p["Conv_5"]["bias"], 32, 64, 16, 32)
    np.testing.assert_array_equal(_hwio(tp.w_fm), np.asarray(want.w_fm))
    np.testing.assert_array_equal(_hwio(tp.w_im), np.asarray(want.w_im))
    for name in ("ah", "aw", "w_head4", "b_head4"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("scale4", "bias4"):
        np.testing.assert_allclose(getattr(tp, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6)


def test_features_match_jax(models):
    fmodel, variables, model, x = models
    xt = _nchw(x)
    with torch.no_grad():
        got8 = model(xt, return_8s_features=True)
        got4 = model(xt, return_4s_features=True)
        got2 = model(xt, return_2s_features=True)
    want8 = fmodel.apply(variables, x, train=False, return_8s_features=True)
    want4 = fmodel.apply(variables, x, train=False, return_4s_features=True)
    want2 = fmodel.apply(variables, x, train=False, return_2s_features=True)
    for g, w in zip((*got8, *got4, got2), (*want8, *want4, want2)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), rtol=2e-4, atol=2e-5)


def _port_depth(model, xt, depth, dtype):
    with torch.no_grad():
        if depth == 3:
            return TPT.packed_tail_deep3_from_model(
                model, *model(xt, return_8s_features=True), xt, dtype=dtype)
        if depth == 2:
            return TPT.packed_tail_deep_from_model(
                model, *model(xt, return_4s_features=True), xt, dtype=dtype)
        return TPT.packed_tail_from_model(
            model, model(xt, return_2s_features=True), xt, dtype=dtype)


def _jax_depth(fmodel, variables, x, depth, dtype):
    if depth == 3:
        return JPT.packed_tail_deep3_from_variables(
            variables, *fmodel.apply(variables, x, train=False,
                                     return_8s_features=True), x,
            dtype=dtype)
    if depth == 2:
        return JPT.packed_tail_deep_from_variables(
            variables, *fmodel.apply(variables, x, train=False,
                                     return_4s_features=True), x,
            dtype=dtype)
    return JPT.packed_tail_from_variables(
        variables, fmodel.apply(variables, x, train=False,
                                return_2s_features=True), x, dtype=dtype)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_packed_field_and_fgcnt_match_jax_f32(models, depth):
    fmodel, variables, model, x = models
    packed, fgcnt = _port_depth(model, _nchw(x), depth, torch.float32)
    want_p, want_c = _jax_depth(fmodel, variables, x, depth, jnp.float32)
    assert packed.shape == (2, 16, 32, 32) and packed.is_contiguous()
    assert packed.dtype == torch.float32
    np.testing.assert_allclose(packed.numpy(), np.asarray(want_p),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_array_equal(fgcnt.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("depth", [1, 3])
def test_packed_field_matches_jax_bf16(models, depth):
    fmodel, variables, model, x = models
    packed, _ = _port_depth(model, _nchw(x), depth, torch.bfloat16)
    want_p, _ = _jax_depth(fmodel, variables, x, depth, jnp.bfloat16)
    assert packed.dtype == torch.bfloat16
    got = packed.float().numpy()
    want = np.asarray(want_p, np.float32)
    assert np.abs(got - want).max() < 0.02 * np.abs(want).max()


def test_phase_upsample_from_packed_matches_jax():
    rng = np.random.RandomState(3)
    fmp = rng.randn(2, 4, 6, 20).astype(np.float32)         # c = 5
    ah = JPT._shifted_phase_matrices(16, 8)
    aw = JPT._shifted_phase_matrices(24, 12)
    want = JPT.phase_upsample_from_packed(
        jnp.asarray(fmp), jnp.asarray(ah), jnp.asarray(aw), jnp.float32)
    got = TPT.phase_upsample_from_packed(
        _nchw(fmp), torch.from_numpy(ah), torch.from_numpy(aw),
        torch.float32)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-6)


def _packed_field(rng, b, hp, wp, vn=3):
    """A random packed head field with ~40 % foreground sub-pixels, and
    its fgcnt."""
    rows = rng.randn(b, hp, wp, 4, 2 + 2 * vn).astype(np.float32)
    rows[..., 1] = rows[..., 0] + np.where(rng.rand(b, hp, wp, 4) < 0.4,
                                           1.0, -1.0)
    fgcnt = (rows[..., 1] > rows[..., 0]).sum(-1).astype(np.float32)
    return rows.reshape(b, hp, wp, -1), fgcnt


# (HP, WP, tn): (-HP) % a and (-WP) % bb nonzero -> padding; the last is
# the 480x640 path's grid (HP=240, WP=320, tn=512 -> a=8, bb=16) scaled
@pytest.mark.parametrize("hp,wp,tn", [(20, 30, 256), (30, 20, 128),
                                      (24, 32, 512)])
@pytest.mark.parametrize("bf16", [False, True])
def test_sample_foreground_packed_matches_jax(hp, wp, tn, bf16):
    rng = np.random.RandomState(hp * wp + tn)
    packed, fgcnt = _packed_field(rng, 2, hp, wp)
    jp = jnp.asarray(packed, jnp.bfloat16 if bf16 else jnp.float32)
    tp = torch.from_numpy(packed)
    if bf16:
        tp = tp.bfloat16()
    key = jax.random.PRNGKey(tn)
    want = JV.sample_foreground_packed(jp, jnp.asarray(fgcnt), tn, key)
    noise = np.array(jax.random.uniform(key, (2, hp, wp), jnp.float32))
    got = TV.sample_foreground_packed(tp, torch.from_numpy(fgcnt), tn,
                                      noise=torch.from_numpy(noise))
    assert got.coords.shape == (2, tn, 2) and got.dirs.shape == (2, tn, 3, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got.total.numpy() == fgcnt.reshape(2, -1).sum(1)).all()


def test_sample_foreground_packed_rejects_bad_budgets():
    packed = torch.zeros(1, 8, 8, 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        TV.sample_foreground_packed(packed, torch.zeros(1, 8, 8), 30)
    with pytest.raises(ValueError, match="seg_dim"):
        TV.sample_foreground_packed(packed, torch.zeros(1, 8, 8), 32,
                                    seg_dim=3)


def test_sample_foreground_takes_nhwc_field_through_k2():
    # the JAX vertex.ndim == 5 branch; the same pixels as channel-major
    rng = np.random.RandomState(5)
    mask = (rng.rand(2, 40, 56) < 0.3).astype(np.int32)
    field = rng.randn(2, 40, 56, 3, 2).astype(np.float32)
    noise = torch.from_numpy(rng.rand(2, 40, 56).astype(np.float32))
    nhwc = TV.sample_foreground(torch.from_numpy(mask),
                                torch.from_numpy(field), 128, noise=noise)
    cm = TV.sample_foreground(
        torch.from_numpy(mask),
        torch.from_numpy(np.ascontiguousarray(
            field.reshape(2, 40, 56, 6).transpose(0, 3, 1, 2))), 128,
        noise=noise)
    for g, w in zip(nhwc, cm):
        assert torch.equal(g, w)
