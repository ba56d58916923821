"""ImageNet and reference-checkpoint initialization of the port against
the JAX package's converters (pvnet_tpu/utils/torch_convert.py), on
checkpoints synthesized to torchvision's exact key and shape layout (no
real weights are in the repository): the port's manifest equals JAX's,
both ImageNet loaders give bit-equal backbones, both refuse extra and
missing tensors, and a reference-layout .pth loads to the same network."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.utils import imagenet_manifest as JIM
from pvnet_tpu.utils import torchvision_manifest as JTM
from pvnet_tpu.utils.torch_convert import (convert_state_dict,
                                           load_imagenet_backbone as j_load,
                                           load_torch_checkpoint)
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.models.resnet import init_weights
from pvnet_tpu_torch.utils import torchvision_manifest as TM
from pvnet_tpu_torch.utils.weights import (flax_from_state_dict,
                                           load_imagenet_backbone,
                                           load_reference_checkpoint)

torch.set_num_threads(1)
ARCHS = ["resnet18", "resnet34", "resnet50"]


def _port(arch, seed=0):
    model = build_model(f"{arch}_8s", ver_dim=18)
    return init_weights(model, torch.Generator().manual_seed(seed))


def _tree_equal(got, want):
    want = jax.tree_util.tree_leaves_with_path(want)
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], np.asarray(w), str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_manifest_equals_jax(arch):
    got, want = TM.state_dict_manifest(arch), JTM.state_dict_manifest(arch)
    assert list(got.items()) == list(want.items())
    assert got == JIM.torchvision_manifest(arch)
    sd, jsd = TM.synthesize_state_dict(arch, 3), JTM.synthesize_state_dict(
        arch, 3)
    assert list(sd) == list(jsd)
    for k in sd:
        assert sd[k].dtype == jsd[k].dtype
        np.testing.assert_array_equal(sd[k], jsd[k], k)
    assert TM.ARCHS == JTM.ARCHS == JIM.ARCHS
    assert TM.CHECKPOINT_FILES == JIM.CHECKPOINT_FILES


@pytest.mark.parametrize("arch", ARCHS)
def test_imagenet_backbone_equals_jax(arch, tmp_path):
    """The same synthesized checkpoint through both loaders: the backbone
    bit-equal, the heads untouched; from a dict and from a .pth."""
    sd = TM.synthesize_state_dict(arch, seed=1)
    fmodel = build_flax(f"{arch}_8s", ver_dim=18)
    variables = fmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            train=False)
    want = j_load(variables, sd, arch=arch)

    model = _port(arch)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / TM.CHECKPOINT_FILES[arch])
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    for src in (sd, path):
        load_imagenet_backbone(model, src, arch=arch)
        got = flax_from_state_dict(model.state_dict())
        for col in ("params", "batch_stats"):
            _tree_equal(got[col]["ResNetBackbone_0"],
                        want[col]["ResNetBackbone_0"])
    after = model.state_dict()
    bb = f"{arch}_8s."
    heads = [k for k in after if not k.startswith(bb) or
             k.startswith(bb + "fc.")]
    assert len(heads) == 32           # fc, conv8s, conv4s, conv2s, convraw
    for k in heads:
        assert torch.equal(after[k], before[k]), k
    changed = [k for k in after if k not in heads
               and not k.endswith("num_batches_tracked")]
    assert all(not torch.equal(after[k], before[k]) for k in changed)


@pytest.mark.parametrize("arch", ARCHS)
def test_imagenet_loader_is_strict(arch):
    """tests/test_imagenet_manifest.py's cases: an extra and a missing
    tensor raise KeyError; also a wrong shape (ValueError) and another
    arch's checkpoint."""
    sd = TM.synthesize_state_dict(arch)
    model = _port(arch)
    extra = dict(sd, **{"layer9.0.conv1.weight":
                        np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(KeyError):
        load_imagenet_backbone(model, extra, arch=arch)
    missing = dict(sd)
    del missing["layer2.0.downsample.0.weight"]
    with pytest.raises(KeyError):
        load_imagenet_backbone(model, missing, arch=arch)
    wrong = dict(sd, **{"bn1.weight": np.zeros((65,), np.float32)})
    with pytest.raises(ValueError):
        load_imagenet_backbone(model, wrong, arch=arch)
    other = "resnet50" if arch != "resnet50" else "resnet34"
    with pytest.raises((KeyError, ValueError)):
        load_imagenet_backbone(model, TM.synthesize_state_dict(other),
                               arch=arch)
    with pytest.raises(ValueError):
        load_imagenet_backbone(model, sd, arch=other)


def _reference_pth(arch, path, seed):
    """A reference-layout checkpoint ({'net', 'optim', 'epoch'}, ref
    net_utils.py:124-130) of a seeded network with drawn BatchNorm
    statistics; the counters dropped, as older PyTorch versions wrote."""
    model = _port(arch, seed)
    g = torch.Generator().manual_seed(seed)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.endswith(("running_mean", "bias")):
            v.copy_(0.1 * torch.randn(v.shape, generator=g))
        elif k.endswith("running_var"):
            v.copy_(0.5 + torch.rand(v.shape, generator=g))
    net = {k: v for k, v in sd.items()
           if not k.endswith("num_batches_tracked")}
    torch.save({"net": net, "optim": {"state": {}, "param_groups": []},
                "epoch": 199}, path)
    return net


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_equals_jax(arch, tmp_path):
    """Both converters of the same reference .pth give bit-equal trees;
    for resnet18 (the prefix load_torch_checkpoint assumes) the JAX
    loader's network and the port's give the same forward."""
    path = str(tmp_path / "199.pth")
    net = _reference_pth(arch, path, seed=2)
    model = _port(arch, seed=9)
    load_reference_checkpoint(model, path)
    got = flax_from_state_dict(model.state_dict())
    stage_sizes, bottleneck = TM.ARCHS[arch]
    params, stats = convert_state_dict(
        {k: v.numpy() for k, v in net.items()}, stage_sizes, bottleneck,
        backbone_prefix=f"{arch}_8s.")
    for flat, col in ((params, "params"), (stats, "batch_stats")):
        for k, v in flat.items():
            node = got[col]
            for p in k.split("/"):
                node = node[p]
            np.testing.assert_array_equal(node, v, k)
    if arch != "resnet18":
        return
    jparams, jstats = load_torch_checkpoint(path)
    fmodel = build_flax("resnet18_8s", ver_dim=18)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    seg_j, ver_j = fmodel.apply({"params": jparams, "batch_stats": jstats},
                                jnp.asarray(x), train=False)
    with torch.no_grad():
        seg_t, ver_t = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in ((seg_t, seg_j), (ver_t, ver_j)):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_reference_loader_is_strict(tmp_path):
    path = str(tmp_path / "ref.pth")
    net = _reference_pth("resnet18", path, seed=4)
    model = _port("resnet18")
    torch.save({"net": dict(net, extra=torch.zeros(1))}, path)
    with pytest.raises(KeyError):
        load_reference_checkpoint(model, path)
    del net["conv8s.0.weight"]
    torch.save(net, path)                     # a bare state_dict
    with pytest.raises(KeyError):
        load_reference_checkpoint(model, path)
    prefixed = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"net": prefixed}, path)       # no prefix stripping
    with pytest.raises(KeyError):
        load_reference_checkpoint(model, path)
