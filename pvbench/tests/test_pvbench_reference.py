"""The plain reference against the program at a tiny size on the CPU,
where the program runs its kernels' plain versions: the FCN, the voting
with fixed draws, PnP, the augmentation and one training step."""
import json
import os

import pytest
import torch
import torch.nn.functional as F

from pvbench import inputs, spec
from pvbench.reference import augment as ref_augment
from pvbench.reference import fcn as ref_fcn
from pvbench.reference import lowp, msgpack
from pvbench.reference import pnp as ref_pnp
from pvbench.reference import train as ref_train
from pvbench.reference import voting as ref_voting
from pvbench.tests.networks import NETWORKS, R18, R50

torch.set_num_threads(2)
MIX = {"shift_x": 8, "shift_y": 8, "brightness": [0.8, 1.2],
       "crop": [208, 256, 128, 160]}


@pytest.fixture(scope="module")
def model_and_params():
    from pvnet_tpu_torch import infer
    path = os.path.join(spec.ROOT, "assets", "duck_ckpt.msgpack")
    return (infer.load_model(path, 9, "cpu"),
            ref_fcn.params_from_flax(msgpack.load(path), "cpu", R18))


@pytest.fixture(scope="module")
def frames():
    return inputs.frames(4, 3, 1, MIX, "cpu")


def test_fcn_equals_program(model_and_params, frames):
    from pvnet_tpu_torch import pipeline as pl
    model, p = model_and_params
    x = pl.normalize_images(frames["image"])
    with torch.no_grad():
        seg, ver = model(x.permute(0, 3, 1, 2).contiguous())
        rs, rv = ref_fcn.forward(p, x.permute(0, 3, 1, 2).contiguous(), R18)
    assert torch.equal(seg, rs) and torch.equal(ver, rv)
    assert set(p) == {k for k in model.state_dict()
                      if "num_batches" not in k}


def _forward_before(p, x):
    """The reference's Resnet18_8s forward pass as it stood before the
    network became the configuration's (hard-coded BasicBlocks (2, 2, 2,
    2) and widths), frozen here to hold the described one to it."""
    relu, lrelu = torch.relu, lambda t: F.leaky_relu(t, 0.1)

    def bn(name, t):
        return F.batch_norm(t, p[f"{name}.running_mean"],
                            p[f"{name}.running_var"], p[f"{name}.weight"],
                            p[f"{name}.bias"], training=False, eps=1e-5)

    b0 = "resnet18_8s"
    x2s = relu(bn(f"{b0}.bn1", F.conv2d(x, p[f"{b0}.conv1.weight"], None,
                                        2, 3)))
    y = F.max_pool2d(x2s, 3, 2, 1)
    feats = {}
    for stage, stride, dil in ((1, 1, 1), (2, 2, 1), (3, 1, 2), (4, 1, 4)):
        for i in range(2):
            n, s = f"{b0}.layer{stage}.{i}", stride if i == 0 else 1
            res = y
            if f"{n}.downsample.0.weight" in p:
                res = bn(f"{n}.downsample.1", F.conv2d(
                    y, p[f"{n}.downsample.0.weight"], None, s))
            z = relu(bn(f"{n}.bn1", F.conv2d(y, p[f"{n}.conv1.weight"],
                                             None, s, dil, dil)))
            z = bn(f"{n}.bn2", F.conv2d(z, p[f"{n}.conv2.weight"], None, 1,
                                        dil, dil))
            y = relu(z + res)
        feats[stage] = y
    fc = relu(bn(f"{b0}.fc.1", F.conv2d(feats[4], p[f"{b0}.fc.0.weight"],
                                        None, 1, 1)))

    def stage(name, t):
        return lrelu(bn(f"{name}.1", F.conv2d(t, p[f"{name}.0.weight"], None,
                                              1, 1)))

    def up(t, like):
        return F.interpolate(t, size=tuple(like.shape[2:]), mode="bilinear",
                             align_corners=True)

    fm = stage("conv8s", torch.cat([fc, feats[2]], 1))
    fm = stage("conv4s", torch.cat([up(fm, feats[1]), feats[1]], 1))
    fm = stage("conv2s", torch.cat([up(fm, x2s), x2s], 1))
    fm = stage("convraw", torch.cat([up(fm, x), x], 1))
    out = F.conv2d(fm, p["convraw.3.weight"], p["convraw.3.bias"])
    return out[:, :2], out[:, 2:]


def test_resnet18_forward_as_before(model_and_params, frames):
    from pvnet_tpu_torch import pipeline as pl
    _, p = model_and_params
    x = pl.normalize_images(frames["image"]).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        got = ref_fcn.forward(p, x, R18)
        want = _forward_before(p, x)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("network", sorted(NETWORKS))
def test_description_is_the_programs_state_dict(network):
    """conv_shapes and bn_names give exactly the program's tensors, by
    name and shape: the described weights load into build_model's module
    by name (strict, but for BatchNorm's step counters), and its
    state_dict holds nothing the description lacks."""
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvbench.offline import load_by_name, widths
    cfg = NETWORKS[network]
    model = build_model(network, ver_dim=cfg["ver_dim"],
                        seg_dim=cfg["seg_dim"], **widths(cfg))
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    p = inputs.init_params(ref_fcn.conv_shapes(cfg), ref_fcn.bn_names(cfg),
                           1, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    load_by_name(model, p)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in p.items())


def test_flax_reader_refuses_a_bottleneck():
    with pytest.raises(ValueError, match="Bottleneck"):
        ref_fcn.params_from_flax({"params": {}}, "cpu", R50)


def test_resnet50_seeded_and_calibrated_equals_program(frames):
    """Resnet50_8s on seeded weights whose BatchNorm statistics one
    train-mode pass set, against the program's pvnet_resnet50, float32 on
    the CPU (b = 2, 64x80). Both call the same convolution and
    BatchNorm routines on the same tensors and agree exactly here; 1e-5
    of the outputs' largest magnitude leaves room for a CPU library that
    orders a sum otherwise, while a wrong weight, statistic or skip moves
    them by tens of percent. The eval-mode pass on the calibration frames
    equals the train-mode one up to the two formulas' rounding (1.1e-5
    of the largest magnitude here; 1e-4 allowed). Without the
    calibration the outputs' deviation is ~150 where it is ~1.8 with it."""
    from pvnet_tpu_torch.models.pvnet import pvnet_resnet50
    from pvbench.offline import load_by_name, normalized
    x = normalized(frames["image"][:2, :64, :80], "cpu")
    p = inputs.init_params(ref_fcn.conv_shapes(R50), ref_fcn.bn_names(R50),
                           9, "cpu")
    ref_fcn.calibrate(p, x, R50)
    assert p["resnet50_8s.layer4.2.bn3.running_var"].std() > 0
    model = pvnet_resnet50(ver_dim=18, seg_dim=2).eval()
    load_by_name(model, p)
    with torch.no_grad():
        seg, ver = model(x)
        rs, rv = ref_fcn.forward(p, x, R50)
        ts, tv = ref_fcn.forward(p, x, R50, train=True)
    for a, b in ((seg, rs), (ver, rv)):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
    # the calibrated statistics are the pass's own: eval equals train
    assert (rv - tv).abs().max() <= 1e-4 * tv.abs().max()
    assert 0.1 < rv.std() < 100


def test_voting_with_fixed_draws(model_and_params, frames):
    from pvnet_tpu_torch import pipeline as pl
    model, _ = model_and_params
    g = torch.Generator().manual_seed(0)
    b, h, w = frames["mask"].shape
    noise = torch.rand(b, h, w, generator=g)
    pair_u = torch.rand(b, 512, 2, generator=g)
    with torch.no_grad():
        mask, ver = pl.predict_fields(model, pl.normalize_images(
            frames["image"]))
        got = pl.keypoints_from_fields(mask, ver, pl.VoteParams(), noise,
                                       pair_u)
    want, total = ref_voting.vote(mask, ver, noise, pair_u)
    assert torch.equal(total, (mask != 0).flatten(1).sum(1))
    d = (got - want).norm(dim=-1)
    # the inlier test's rounding can move a near-tied winner: the median
    # keypoint agrees to rounding, a few may move by a pixel or so
    assert d.median() < 1e-3 and d.max() < 5.0


def test_pnp_reaches_the_programs_optimum():
    from pvnet_tpu_torch.ops import pnp as P
    fx = inputs.fixture()
    pts = torch.tensor(fx["points_3d"], dtype=torch.float64)
    K = torch.tensor(fx["K"], dtype=torch.float64)
    poses = torch.tensor(fx["poses"], dtype=torch.float64)
    g = torch.Generator().manual_seed(1)
    kp = ref_pnp.project(pts, poses[:, :, :3], poses[:, :, 3], K).repeat(
        4, 1, 1) + 2 * torch.randn(8, 9, 2, generator=g, dtype=torch.float64)
    ref = ref_pnp.solve(pts, kp, K)
    prog = P.pnp_batch(pts.float(), kp.float(), K.float())
    gap = ref_pnp.reproj_rms(pts, prog, kp, K) - ref_pnp.reproj_rms(
        pts, ref, kp, K)
    assert gap.abs().max() < 1e-4


def test_augmentation_equals_program(frames):
    from pvnet_tpu_torch.config import AugConfig
    from pvnet_tpu_torch.data import augment_device as ad
    rec = json.load(open(os.path.join(spec.HERE, "configs",
                                      "r18_bf16.json")))["train"]["aug_cfg"]
    d = inputs.aug_draws(4, 0, 4, rec, "cpu")
    d["blur"] = torch.ones(4, dtype=torch.bool)
    got = ad.augment_batch(frames["image"], frames["mask"],
                           frames["hcoords"], (64, 96),
                           AugConfig.from_dict(rec), draws=ad.AugDraws(**d))
    want = ref_augment.augment(frames["image"], frames["mask"],
                               frames["hcoords"], d, (64, 96), rec)
    assert (got[0] - want[0]).abs().max() < 1e-3
    assert (got[1] != want[1]).float().mean() < 1e-3
    assert (got[2] - want[2]).abs().max() < 1e-3


def test_one_training_step_equals_program(frames):
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.data.augment_device import AugDraws
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.train import trainer
    cfg = json.load(open(os.path.join(spec.HERE, "configs",
                                      "r18_bf16.json")))
    recipe = cfg["train"]
    p0 = inputs.init_params(ref_fcn.conv_shapes(cfg), ref_fcn.bn_names(cfg),
                            5, "cpu")
    model = build_model("resnet18_8s", ver_dim=18, seg_dim=2)
    model.load_state_dict(p0, strict=False)
    tcfg = TrainConfig.from_dict({"aug_cfg": recipe["aug_cfg"]})
    state = trainer.create_train_state(model, tcfg)
    d = inputs.aug_draws(5, 0, 4, recipe["aug_cfg"], "cpu")
    m = trainer.train_step_from_data(state, frames, torch.arange(4),
                                     draws=AugDraws(**d),
                                     aug_cfg=tcfg.aug_cfg, aug_hw=(64, 96))
    out = ref_train.run({k: v.clone() for k, v in p0.items()},
                        [dict(frames, draws=d, out_hw=(64, 96))], cfg)
    assert abs(float(m["loss"]) - out["loss"][0]) < 1e-4 * out["loss"][0]
    for n, p in model.named_parameters():
        g = state.optimizer.state[p]["exp_avg"] / 0.1
        assert (g.norm() - out["grad"][n].norm()).abs() <= 1e-2 * max(
            out["grad"][n].norm(), 1e-3)
        assert torch.allclose(p.detach(), out["params"][n], atol=2.5e-3)


def test_controls_round_as_stated():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 3.14159265])
    assert lowp.round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9,
                                           3.140625]
    y = torch.linspace(-3, 3, 101)
    q = lowp.round_fp8(y)
    assert (q - y).abs().max() <= 3 / 448 * 32          # 3-bit mantissa
    assert not torch.equal(q, y)
    # the fp8 convolution's backward rounds the gradient too
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    lowp.conv_fp8(x, w, None, 1, 1).square().sum().backward()
    x2, w2 = x.detach().requires_grad_(), w.detach().requires_grad_()
    torch.nn.functional.conv2d(x2, w2, None, 1, 1).square().sum().backward()
    rel = (x.grad - x2.grad).norm() / x2.grad.norm()
    assert 1e-3 < rel < 0.3
