"""The port's int8 inference against pvnet_tpu's, on the CPU: the int8
convolution (ops/quant_conv.py: conv2d_int8, QuantConv2d in each mode,
calibrate), the calibrated scales carried across (utils/weights), the
quantized PVNet (backbone stages 0-3 and the decoder) and the packed tail's
int8 branch.

Both frameworks quantize the same float input with the same scheme, so the
int8 codes, the int32 accumulators and the dequantized outputs are equal
bit for bit (measured; XLA keeps the division). Where whole networks run,
their float convolutions differ in summation order (~1e-6 relative), which
moves an activation across a rounding boundary of its int8 grid here and
there; those tolerances are stated at each test."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax import lax

from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.ops import packed_tail as JPT
from pvnet_tpu.ops import quant_conv as JQ
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.ops import packed_tail as TPT
from pvnet_tpu_torch.ops import quant_conv as TQ
from pvnet_tpu_torch.utils.weights import (flax_quant_from_model,
                                           load_pvnet_checkpoint,
                                           quant_from_flax)
from tools.make_torch_fixture import DEFAULT_OUT

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "duck_ckpt.msgpack")
STAGES = (0, 1, 2, 3)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).float().numpy()


# (stride, dilation, padding, kernel, bias): the backbone's 3x3 convs at
# dilations 1, 2, 4 and stride 2, its strided 1x1 downsample, the packed
# tail's VALID 2x2 lattice conv and its stride-2 4x4 skip conv
_CASES = [(1, 1, 1, 3, False), (2, 1, 1, 3, True), (1, 2, 2, 3, False),
          (1, 4, 4, 3, True), (2, 1, 0, 1, False), (1, 1, 0, 2, False),
          (2, 1, 1, 4, False)]


@pytest.mark.parametrize("stride,dil,pad,k,bias", _CASES)
def test_conv2d_int8_matches_jax_exactly(stride, dil, pad, k, bias):
    rng = np.random.RandomState(k * 10 + dil)
    x = rng.randn(3, 13, 12, 16).astype(np.float32)
    x[1] *= 50.0                                # an outlier image
    w = (rng.randn(k, k, 16, 24) * 0.1).astype(np.float32)
    s2, p2, d2 = (stride,) * 2, ((pad, pad),) * 2, (dil,) * 2
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    # JAX's codes and accumulators, spelled as JQ.conv2d_int8 makes them
    s_w = jnp.maximum(jnp.max(jnp.abs(wj), axis=(0, 1, 2)), 1e-12) / 127.0
    w_i8 = jnp.clip(jnp.round(wj / s_w), -127, 127).astype(jnp.int8)
    s_x = jnp.maximum(jnp.max(jnp.abs(xj), axis=(1, 2, 3), keepdims=True),
                      1e-12) / 127.0
    q = jnp.clip(jnp.round(xj / s_x), -127, 127).astype(jnp.int8)
    acc = lax.conv_general_dilated(
        q, w_i8, s2, p2, rhs_dilation=d2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    want = np.asarray(JQ.conv2d_int8(xj, wj, s2, p2, d2))

    xt, wt = _nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1)
    wq_t, sw_t = TQ.weight_codes(wt)
    q_t = TQ.activation_codes(xt, TQ.image_scale(xt))
    np.testing.assert_array_equal(wq_t.permute(2, 3, 1, 0).numpy(),
                                  np.asarray(w_i8))
    np.testing.assert_array_equal(sw_t.numpy(), np.asarray(s_w))
    np.testing.assert_array_equal(q_t.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(q))
    acc_t = TQ.conv_int8_acc(q_t, wq_t, stride, pad, dil)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(acc))
    got = TQ.conv2d_int8(xt, wt, stride, pad, dil)
    np.testing.assert_array_equal(_nhwc(got), want)
    # and as a module, with the bias added in float32
    mod = TQ.QuantConv2d(16, 24, k, stride=stride, padding=pad, dilation=dil,
                         bias=bias).eval()
    b = rng.randn(24).astype(np.float32)
    with torch.no_grad():
        mod.weight.copy_(wt)
        if bias:
            mod.bias.copy_(torch.from_numpy(b))
    jmod = JQ.Conv(24, (k, k), strides=s2, padding=list(p2),
                   kernel_dilation=d2, use_bias=bias, quant=True)
    params = {"kernel": wj, **({"bias": jnp.asarray(b)} if bias else {})}
    np.testing.assert_array_equal(
        _nhwc(mod(xt)), np.asarray(jmod.apply({"params": params}, xj)))


def _module_pair(mode, seed=0):
    rng = np.random.RandomState(seed)
    w = (rng.randn(3, 3, 8, 16) * 0.2).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    jmod = JQ.Conv(16, (3, 3), padding=[(2, 2)] * 2, kernel_dilation=(2, 2),
                   use_bias=True, quant=True, mode=mode)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}
    mod = TQ.QuantConv2d(8, 16, 3, padding=2, dilation=2, mode=mode).eval()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        mod.bias.copy_(torch.from_numpy(b))
    x1 = rng.randn(2, 10, 9, 8).astype(np.float32)
    x2 = (rng.randn(2, 10, 9, 8) * 3.0).astype(np.float32)
    return jmod, params, mod, x1, x2


def test_quant_conv_calibrate_and_static_match_jax():
    """'calibrate' keeps the running absmax (and uses it), 'static' the
    calibrated scalar: outputs and the absmax equal JAX's exactly."""
    jmod, params, mod, x1, x2 = _module_pair("calibrate")
    quant = None
    for x in (x1, x2):
        v = params if quant is None else {**params, "quant": quant}
        want, upd = jmod.apply(v, jnp.asarray(x), mutable=["quant"])
        quant = upd["quant"]
        np.testing.assert_array_equal(_nhwc(mod(_nchw(x))), np.asarray(want))
    assert float(mod.act_absmax) == float(quant["act_absmax"])
    assert float(mod.act_absmax) == float(np.abs(x2).max())
    static = jmod.clone(mode="static")
    mod.mode = "static"
    np.testing.assert_array_equal(
        _nhwc(mod(_nchw(x1))),
        np.asarray(static.apply({**params, "quant": quant},
                                jnp.asarray(x1))))


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_quant_conv_per_image_scales_match_jax(mode):
    """'dynamic', and 'static' before any calibration (JAX's fallback
    without a quant collection): each image's absmax."""
    jmod, params, mod, x1, _ = _module_pair(mode, seed=1)
    x = x1.copy()
    x[1] *= 50.0
    got = mod(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got),
                                  np.asarray(jmod.apply(params,
                                                        jnp.asarray(x))))
    # an image's result does not depend on its batchmates
    assert torch.equal(got[:1], mod(_nchw(x[:1])))


def test_quant_conv_training_is_float_and_bf16_under_autocast():
    _, _, mod, x1, _ = _module_pair("dynamic")
    float_conv = torch.nn.Conv2d(8, 16, 3, padding=2, dilation=2)
    float_conv.load_state_dict(mod.state_dict())
    x = _nchw(x1)
    assert torch.equal(mod.train()(x), float_conv(x))
    mod.eval()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = mod(x)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, mod(x).to(torch.bfloat16))
    with pytest.raises(ValueError):
        TQ.QuantConv2d(8, 16, 3, mode="fixed")


def _duck_variables():
    with open(CKPT, "rb") as f:
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))


def _port_model(quant_decoder=True, **kw):
    model = build_model("resnet18_8s", ver_dim=18, quant_stages=STAGES,
                        quant_decoder=quant_decoder, **kw)
    load_pvnet_checkpoint(model, CKPT)
    return model.eval()


@pytest.fixture(scope="module")
def calibrated():
    """The duck model (stages 0-3 and the decoder in int8) calibrated by
    both frameworks on the same two batches of 64x64 images."""
    rng = np.random.RandomState(7)
    batches = [rng.randn(2, 64, 64, 3).astype(np.float32) for _ in range(2)]
    variables = _duck_variables()
    fmodel = build_flax("resnet18_8s", ver_dim=18, quant_stages=STAGES,
                        quant_decoder=True, quant_mode="calibrate",
                        head_layout="NCHW")
    quant = JQ.calibrate(fmodel, variables,
                         [jnp.asarray(x) for x in batches], train=False)
    port = _port_model(quant_mode="static")
    scales = TQ.calibrate(port, [_nchw(x) for x in batches])
    return variables, fmodel, jax.tree_util.tree_map(np.asarray, quant), \
        port, scales, batches


def test_calibrate_matches_jax(calibrated):
    """The running absmax of every int8 conv against JAX's calibrate. The
    first block's two convs see inputs that differ only by float32
    summation order: within 1e-6 relative (measured 2.1e-7). Every later
    one sees the int8 outputs of earlier convs, in which an activation on
    a rounding boundary takes the other code here and there (one step is
    1/127 of a scale), and a maximum over the tensor can land on such a
    pixel: within 1.5e-2 (measured 8.4e-3, layer3's second block); the
    mechanism itself is held exactly by
    test_quant_conv_calibrate_and_static_match_jax."""
    _, _, quant, port, scales, _ = calibrated
    assert len(scales) == 21           # 16 block convs, 3 downsample, 2
    want = flax_quant_from_model(port)
    got_leaves = jax.tree_util.tree_leaves_with_path(want)
    ref = {jax.tree_util.keystr(p): v for p, v in
           jax.tree_util.tree_leaves_with_path(quant)}
    assert len(got_leaves) == len(ref) == 21
    for p, v in got_leaves:
        key = jax.tree_util.keystr(p)
        r = ref[key]
        tol = 1e-6 if "BasicBlock_0'" in key else 1.5e-2
        assert abs(float(v) - float(r)) <= tol * float(r), (key, v, r)


def test_scales_round_trip_exactly(calibrated):
    _, _, quant, port, _, _ = calibrated
    fresh = _port_model(quant_mode="static")
    quant_from_flax(fresh, quant)
    back = flax_quant_from_model(fresh)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(quant)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(quant)):
        assert a.dtype == np.float32 and float(a) == float(b)
    # strict both ways
    with pytest.raises(KeyError):
        quant_from_flax(fresh, {**quant, "Conv_9": {"act_absmax": 1.0}})
    partial = dict(quant)
    partial.pop("Conv_1")
    with pytest.raises(KeyError):
        quant_from_flax(fresh, partial)
    with pytest.raises(ValueError):
        flax_quant_from_model(_port_model())


# Tolerance of the whole network against JAX: the same int8 scheme on
# float inputs that differ by float32 summation order; a few activations
# land on the other side of a rounding boundary and move by one code
# (1/127 of their conv's scale), which the next layers spread. Measured on
# these inputs: seg argmax equal on >= 99.9 % of pixels, the vector field
# within 0.5 % (relative L2) of JAX's. Held: 99.5 % and 2 %; for scale,
# int8 against float moves the field by ~8 % here.
@pytest.mark.parametrize("mode", ["static", "dynamic", "calibrate"])
def test_quantized_pvnet_matches_jax(calibrated, mode):
    variables, fmodel, quant, _, _, batches = calibrated
    x = batches[0]
    port = _port_model(quant_mode=mode)
    jm = fmodel.clone(quant_mode=mode)
    if mode == "static":
        quant_from_flax(port, quant)
        seg_j, ver_j = jm.apply({**variables, "quant": quant},
                                jnp.asarray(x), train=False)
    elif mode == "calibrate":
        (seg_j, ver_j), _ = jm.apply(variables, jnp.asarray(x), train=False,
                                     mutable=["quant"])
    else:
        seg_j, ver_j = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        seg_t, ver_t = port(_nchw(x))
    ver_j = np.asarray(ver_j)
    rel = np.linalg.norm(ver_t.numpy() - ver_j) / np.linalg.norm(ver_j)
    agree = (seg_t.argmax(1).numpy() == np.asarray(seg_j).argmax(1)).mean()
    assert rel < 0.02 and agree >= 0.995, (rel, agree)


def test_training_mode_is_float_and_checkpoints_interchange(tmp_path):
    rng = np.random.RandomState(8)
    x = _nchw(rng.randn(2, 32, 32, 3))
    quant = _port_model(quant_mode="static").train()
    flt = build_model("resnet18_8s", ver_dim=18)
    load_pvnet_checkpoint(flt, CKPT)
    flt.train()
    for a, b in zip(quant(x), flt(x)):
        assert torch.equal(a, b)
    # a .pth of either loads strictly into the other; the calibrated
    # scales are not part of it
    TQ.calibrate(quant, [x])
    torch.save({"net": quant.state_dict()}, tmp_path / "q.pth")
    assert not any("act_absmax" in k for k in quant.state_dict())
    other = build_model("resnet18_8s", ver_dim=18)
    other.load_state_dict(torch.load(tmp_path / "q.pth")["net"], strict=True)
    back = build_model("resnet18_8s", ver_dim=18, quant_stages=STAGES,
                       quant_decoder=True)
    back.load_state_dict(other.state_dict(), strict=True)
    for k, v in quant.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


@pytest.fixture(scope="module")
def crop_features():
    """The float duck model's features of a 120x160 crop of the fixture
    (both objects), from JAX, for each tail depth."""
    with np.load(DEFAULT_OUT) as z:
        imgs = z["images"][:, 216:336, 232:392]
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    x = ((imgs.astype(np.float32) / 255.0 - mean) / std).astype(np.float32)
    variables = _duck_variables()
    fmodel = build_flax("resnet18_8s", ver_dim=18)
    xj = jnp.asarray(x)
    feats = {d: fmodel.apply(variables, xj, train=False, **{flag: True})
             for d, flag in ((3, "return_8s_features"),
                             (2, "return_4s_features"),
                             (1, "return_2s_features"))}
    port = build_model("resnet18_8s", ver_dim=18)
    load_pvnet_checkpoint(port, CKPT)
    return variables, xj, feats, port.eval()


# Tolerance of the int8 tail against JAX's on the same features: the
# codes of the packed upsample (float32 matmuls summed in another order)
# may differ by one at a rounding boundary. Measured: the packed field
# within 1e-4 of its max abs, and every foreground count equal but for a
# few cells per thousand. Held: 2e-3 of the max abs and 99.5 % of the
# cells' counts equal.
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_packed_tail_int8_matches_jax(crop_features, depth):
    variables, xj, feats, port = crop_features
    f = feats[depth]
    fns = {3: (JPT.packed_tail_deep3_from_variables,
               TPT.packed_tail_deep3_from_model),
           2: (JPT.packed_tail_deep_from_variables,
               TPT.packed_tail_deep_from_model),
           1: (JPT.packed_tail_from_variables,
               TPT.packed_tail_from_model)}[depth]
    args = (f,) if depth == 1 else tuple(f)
    want_p, want_c = fns[0](variables, *args, xj, dtype=jnp.float32,
                            quant=True)
    with torch.no_grad():
        got_p, got_c = fns[1](port, *(_nchw(a) for a in args), _nchw(xj),
                              dtype=torch.float32, quant=True)
        float_p, _ = fns[1](port, *(_nchw(a) for a in args), _nchw(xj),
                            dtype=torch.float32)
    want_p = np.asarray(want_p)
    scale = np.abs(want_p).max()
    assert got_p.shape == want_p.shape and got_p.dtype == torch.float32
    assert np.abs(got_p.numpy() - want_p).max() < 2e-3 * scale
    assert (got_c.numpy() == np.asarray(want_c)).mean() >= 0.995
    # the int8 branch really ran: it is not the float tail
    assert (got_p - float_p).abs().max() > 1e-3 * scale


def test_train_loop_calibrates_and_evaluates_int8(tmp_path):
    """A recipe with quant_stages builds the int8 model; its evaluation
    takes per-image scales until TrainLoop.calibrate_quant has run (JAX
    TrainLoop.calibrate_quant), then the calibrated ones; the loss meters
    keep per-image scales either way; validate runs with bf16 counts."""
    from pvnet_tpu_torch import pipeline as TPL
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.data.dataset import eval_batches
    from pvnet_tpu_torch.eval.evaluator import Evaluator
    from pvnet_tpu_torch.train.loop import TrainLoop
    cfg = TrainConfig.from_dict({"quant_stages": [0, 1, 2, 3],
                                 "quant_mode": "static",
                                 "test_batch_size": 2})
    loop = TrainLoop(cfg, str(tmp_path), device="cpu")
    state = loop.init_state(CKPT)
    convs = TQ.quant_convs(state.model)
    assert len(convs) == 19 and all(m.mode == "static" and
                                    m.act_absmax is None
                                    for m in convs.values())
    with np.load(DEFAULT_OUT) as z:
        split = {"images": z["images"][:, 200:264, 280:376],
                 "masks": z["masks"][:, 200:264, 280:376],
                 "poses": z["poses"], "points_3d": z["points_3d"],
                 "K": z["K"], "model_pts": z["points_3d"],
                 "diameter": 0.1}
    image = loop._images(next(eval_batches(split, 2)))
    x = image.permute(0, 3, 1, 2).contiguous()
    dynamic = _port_model(False, quant_mode="dynamic")
    state.model.eval()
    with torch.no_grad():
        before = state.model(x)
        assert all(torch.equal(a, b) for a, b in zip(before, dynamic(x)))
    scales = loop.calibrate_quant(state, eval_batches(split, 2),
                                  num_batches=1)
    fresh = _port_model(False, quant_mode="static")
    want = TQ.calibrate(fresh, [x])
    assert set(scales) == set(convs) and all(
        torch.equal(scales[n], want[n]) for n in scales)
    with torch.no_grad():
        after = state.model(x)
        assert all(torch.equal(a, b) for a, b in zip(after, fresh(x)))
        assert not torch.equal(after[1], before[1])
    params = TPL.VoteParams(hyp_num=64, max_num=64, uncertainty_hyp_num=64)
    losses = loop.validate(state, eval_batches(split, 2), 0,
                           evaluate_pose=True, vote_params=params,
                           vote_impl="bf16",
                           evaluator=Evaluator(loop.object_meta(split)))
    assert all(np.isfinite(losses[f"val/scalar/{k}"])
               for k in ("loss", "seg_loss", "ver_loss"))
    assert all(torch.equal(m.act_absmax, scales[n])
               for n, m in convs.items())
