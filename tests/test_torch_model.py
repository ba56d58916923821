"""The port's PVNet (ResNet18-8s) against the flax model with the duck
checkpoint's weights, in float32 on the CPU."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.models.resnet import resnet18_backbone
from pvnet_tpu_torch.utils.weights import load_pvnet_checkpoint

torch.set_num_threads(1)

CKPT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "duck_ckpt.msgpack")


@pytest.fixture(scope="module")
def models():
    with open(CKPT, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    # the same bf16-stored values, upcast to f32 for both models
    variables = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float32), ref)
    flax_model = build_flax("resnet18_8s", ver_dim=18, head_layout="NCHW")
    port = build_model("resnet18_8s", ver_dim=18)
    load_pvnet_checkpoint(port, CKPT)
    return flax_model, variables, port.eval()


# Tolerance: both sides compute in float32 and differ only in convolution
# summation order, ~1e-6 absolute on logits of magnitude ~5 (1e-4 relative
# leaves two orders of margin); the argmax mask must agree on >= 99.9 % of
# pixels (a logit pair within ~1e-6 of a tie may flip).
@pytest.mark.parametrize("shape", [(1, 96, 128), (2, 64, 80)])
def test_logits_match_flax(models, shape):
    flax_model, variables, port = models
    b, h, w = shape
    x = np.random.RandomState(h).randn(b, h, w, 3).astype(np.float32)
    seg_j, ver_j = flax_model.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        seg_t, ver_t = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert seg_t.shape == (b, 2, h, w) and ver_t.shape == (b, 18, h, w)
    for got, want in ((seg_t, seg_j), (ver_t, ver_j)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale)
    agree = (seg_t.argmax(1).numpy() == np.asarray(seg_j).argmax(1)).mean()
    assert agree >= 0.999


def test_backbone_strides_and_dilations():
    bb = resnet18_backbone()
    feats = bb(torch.zeros(1, 3, 64, 96))
    assert [tuple(f.shape[1:]) for f in feats] == [
        (64, 32, 48), (64, 16, 24), (128, 8, 12), (256, 8, 12),
        (512, 8, 12)]
    assert bb.layer3[0].conv1.dilation == (2, 2)
    assert bb.layer4[1].conv2.dilation == (4, 4)
    assert bb.layer2[0].conv1.stride == (2, 2)
    assert bb.layer3[0].conv1.stride == (1, 1)


def test_build_model_rejects_unknown_network():
    with pytest.raises(ValueError):
        build_model("resnet101_8s", ver_dim=18)
