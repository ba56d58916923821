"""pvbench/flops.py against counts by hand and against the convolutions
that the program's own modules run."""
import pytest
import torch

from pvbench import flops
from pvbench.tests.networks import NETWORKS, R18, R50


def test_one_dilated_convolution():
    # layer4.1.conv2: 512 -> 512, 3x3, dilation 4, padding 4, stride 1, on
    # the 60x80 stride-8 grid of a 480x640 image: 2 * 512 * 512 * 9 * 4800
    convs = {c[0]: c for c in flops.fcn_convs(480, 640, R18)}
    name, cin, cout, k, ho, wo = convs["layer4.1.conv2"]
    assert (cin, cout, k, ho, wo) == (512, 512, 3, 60, 80)
    assert 2 * cin * cout * k * k * ho * wo == 22_649_241_600


def test_whole_fcn_at_480x640():
    # per group, 2 * c_in * c_out * k^2 * pixels, counted by hand
    px2, px4, px8, px = 240 * 320, 120 * 160, 60 * 80, 480 * 640
    mac = (3 * 64 * 49 * px2                                # stem
           + 4 * 64 * 64 * 9 * px4                          # layer1
           + (64 * 128 * 9 + 128 * 128 * 9 * 3 + 64 * 128) * px8
           + (128 * 256 * 9 + 256 * 256 * 9 * 3 + 128 * 256) * px8
           + (256 * 512 * 9 + 512 * 512 * 9 * 3 + 256 * 512) * px8
           + 512 * 256 * 9 * px8                            # fc
           + 384 * 128 * 9 * px8                            # conv8s
           + 192 * 64 * 9 * px4                             # conv4s
           + 128 * 32 * 9 * px2                             # conv2s
           + 35 * 32 * 9 * px                               # convraw
           + 32 * 20 * px)                                  # head
    want = 2 * mac + 20 * px                                # + head bias
    assert flops.fcn_flops(480, 640, R18) == want
    assert round(want / 1e9, 2) == 144.88


def test_flops_scale_with_area_on_the_recipe_grid():
    full = flops.fcn_flops(480, 640, R18)
    half = flops.fcn_flops(240, 640, R18)
    assert 0.49 < half / full < 0.51
    assert flops.train_step_flops(256, 256, 32, R18) == \
        3 * 32 * flops.fcn_flops(256, 256, R18)


def test_resnet50_8s_at_480x640():
    convs = {c[0]: c for c in flops.fcn_convs(480, 640, R50)}
    # a Bottleneck's 1x1 expansion and layer4's dilated 3x3 at stride 8
    assert convs["layer3.5.conv3"][1:] == (256, 1024, 1, 60, 80)
    assert convs["layer4.0.conv2"][1:] == (512, 512, 3, 60, 80)
    assert convs["layer4.0.downsample"][1:] == (1024, 2048, 1, 60, 80)
    assert convs["fc"][1:3] == (2048, 384)
    assert convs["conv8s"][1:3] == (384 + 512, 256)
    assert convs["conv4s"][1:3] == (256 + 256, 128)
    assert round(flops.fcn_flops(480, 640, R50) / 1e9, 1) == 385.5


@pytest.mark.parametrize("network", sorted(NETWORKS))
def test_count_equals_the_programs_convolutions(network):
    """Every nn.Conv2d that the program's module runs, counted by a
    forward hook at a small size, 2 c_in c_out k^2 a pixel and the
    bias."""
    from pvnet_tpu_torch.models.pvnet import build_model
    cfg = NETWORKS[network]
    model = build_model(network, ver_dim=cfg["ver_dim"],
                        seg_dim=cfg["seg_dim"]).eval()
    counted = []

    def hook(mod, args, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        n = 2.0 * mod.in_channels * mod.out_channels * k * out[0, 0].numel()
        if mod.bias is not None:
            n += out[0].numel()
        counted.append(n)

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 3, 72, 88))
    assert len(counted) == len(flops.fcn_convs(72, 88, cfg))
    assert sum(counted) == flops.fcn_flops(72, 88, cfg)


def test_k3_and_k4_work():
    f, b = flops.k3_work(128, 9, 512, 512)
    assert f == 13 * 128 * 9 * 512 * 512
    assert b == 128 * 512 * 9 + 128 * 512 * 9 * 8 + 128 * 512 * 9 * 8 \
        + 128 * 512 * 9 * 4
    t, which = flops.bound_seconds(f, b, flops.PEAK_FLOPS["float32"])
    assert which == "compute" and t == pytest.approx(f / 67e12)
    # pass V on [4b, W, H] and pass H on [4b, out_h, W], float32 planes
    assert flops.k4_step_bytes(8, 480, 640, 256) == (
        2 * 32 * 640 * 480 * 4 + 4 * 32 * 640
        + 2 * 32 * 256 * 640 * 4 + 4 * 32 * 256)
    t, which = flops.bound_seconds(0.0, 1e9, 1.0)
    assert which == "bytes" and t == pytest.approx(1e9 / 3.35e12)
