"""Training on the synthetic split from the port's CLI (``python -m
pvnet_tpu_torch.train --synthetic``, tools/train.py --synthetic's
counterpart): it writes the JAX generator's LINEMOD tree and trains on its
train.txt and val.txt lists, ``main()`` trains a tiny recipe from a
synthesized ImageNet backbone and writes a checkpoint the inference entry
point reads, and the ImageNet backbone survives TrainLoop.init_state
exactly."""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pvnet_tpu.config import PathConfig
from pvnet_tpu.data.linemod import LineModImageDB, read_mask_np
from pvnet_tpu.data.synthetic import generate_synthetic_linemod
from pvnet_tpu_torch import infer
from pvnet_tpu_torch.config import PathConfig as PortPathConfig
from pvnet_tpu_torch.config import TrainConfig
from pvnet_tpu_torch.data.image_io import read_mask
from pvnet_tpu_torch.data.linemod import LineModImageDB as PortImageDB
from pvnet_tpu_torch.train import __main__ as CLI
from pvnet_tpu_torch.train.loop import TrainLoop
from pvnet_tpu_torch.utils.torchvision_manifest import synthesize_state_dict

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")


def _imagenet_pth(path, arch="resnet18", seed=0):
    sd = synthesize_state_dict(arch, seed)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return sd


def test_train_and_val_sets_are_the_jax_lists(tmp_path):
    """20 images: the CLI's synthetic tree is the JAX generator's, file for
    file (JPEG bytes, mask pixels, pose text, lists), and LineModImageDB
    reads the same train.txt (10) and val.txt (2) records from it as the
    JAX package's does from its own, in their order (masks bit for bit,
    poses equal)."""
    args = SimpleNamespace(synthetic_images=20, synthetic_occluder_prob=0.0,
                           synthetic_clutter=0,
                           data_dir=str(tmp_path / "port"))
    root, gen_s = CLI.synthetic_tree(args, "duck", "cpu")
    assert gen_s > 0 and root == str(tmp_path / "port" / "synthetic")
    jroot = str(tmp_path / "jax")
    generate_synthetic_linemod(jroot, "duck", num_images=20)
    n = 0
    for d, _, files in os.walk(jroot):
        for f in files:
            want = os.path.join(d, f)
            got = os.path.join(root, os.path.relpath(want, jroot))
            if f.endswith(".png"):
                np.testing.assert_array_equal(read_mask_np(got),
                                              read_mask_np(want))
            else:
                assert open(got, "rb").read() == open(want, "rb").read(), f
            n += 1
    assert n == 20 * 4 + 3 + 3          # frames, masks, poses; lists; meshes
    jdb = LineModImageDB("duck", has_render_set=False, has_fuse_set=False,
                         paths=PathConfig(data_dir=jroot))
    pdb = PortImageDB("duck", has_render_set=False, has_fuse_set=False,
                      paths=PortPathConfig(data_dir=root))
    for got, recs in ((pdb.train_real_set, jdb.train_real_set),
                      (pdb.val_real_set, jdb.val_real_set)):
        assert [r["rgb_pth"] for r in got] == [r["rgb_pth"] for r in recs]
        for g, r in zip(got, recs):
            np.testing.assert_array_equal(
                read_mask(os.path.join(root, "LINEMOD", g["dpt_pth"])),
                read_mask_np(os.path.join(jroot, "LINEMOD", r["dpt_pth"])))
            np.testing.assert_array_equal(g["RT"], r["RT"])
    assert (len(pdb.train_real_set), len(pdb.val_real_set)) == (10, 2)
    # written once: the second call finds train.txt
    assert CLI.synthetic_tree(args, "duck", "cpu") == (root, 0.0)


def test_main_trains_from_imagenet_and_writes_a_loadable_checkpoint(
        tmp_path, capsys):
    recipe = json.load(open(RECIPE))
    recipe.update(train_batch_size=2, test_batch_size=2, bf16=False,
                  eval_epoch=True, eval_epoch_begin=0, eval_inter=1)
    cfg_file = str(tmp_path / "recipe.json")
    json.dump(recipe, open(cfg_file, "w"))
    pth = str(tmp_path / "resnet18-f37072fd.pth")
    _imagenet_pth(pth)
    model_dir = str(tmp_path / "model")
    assert CLI.main(["--synthetic", "--device_data", "--cfg_file", cfg_file,
                     "--synthetic_images", "4", "--steps", "2",
                     "--buckets", "64x64", "--imagenet_pth", pth,
                     "--device", "cpu", "--data_dir", str(tmp_path / "d"),
                     "--model_dir", model_dir]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert (summary["train_images"], summary["val_images"]) == (2, 1)
    assert [e["steps"] for e in summary["epochs"]] == [1, 1]
    assert all(np.isfinite(e["losses"]).all() for e in summary["epochs"])
    assert "ADD metric" in out                   # pose evaluation ran
    assert set(summary["launches"].values()) == {0}      # the CPU
    assert sorted(os.listdir(model_dir)) == ["0.pth", "1.pth", "log.jsonl"]
    model = infer.load_model(os.path.join(model_dir, "1.pth"), 9, "cpu")
    ckpt = torch.load(os.path.join(model_dir, "1.pth"), weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ckpt["net"][k]), k


@pytest.mark.parametrize("network", ["resnet18_8s", "resnet50_8s"])
def test_imagenet_backbone_survives_init_state(tmp_path, network):
    arch = network.split("_")[0]
    pth = str(tmp_path / f"{arch}.pth")
    sd = _imagenet_pth(pth, arch, seed=5)
    cfg = TrainConfig(model_name="t", network=network)
    state = TrainLoop(cfg, str(tmp_path / "m"), device="cpu").init_state(
        imagenet_pth=pth)
    got = state.model.state_dict()
    n = 0
    for k, v in sd.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[f"{network}.{k}"], torch.from_numpy(v)), k
        n += 1
    assert n == len(got) - sum(
        1 for k in got if not k.startswith(network + ".")
        or k.startswith(network + ".fc.")
        or k.endswith("num_batches_tracked"))
    # the heads keep the seeded draw of a state without the checkpoint
    fresh = TrainLoop(cfg, str(tmp_path / "m2"), device="cpu").init_state()
    for k, v in fresh.model.state_dict().items():
        if not k.startswith(network + ".") or ".fc." in k:
            assert torch.equal(got[k], v), k
    with pytest.raises(KeyError):               # another arch's tensors
        TrainLoop(TrainConfig(model_name="t", network="resnet34_8s"),
                  str(tmp_path / "m3"), device="cpu").init_state(
            imagenet_pth=pth)


_BLOCKED = ("jax", "flax", "msgpack", "PIL", "pvnet_tpu")


def test_new_entry_points_run_without_jax(tmp_path):
    """``--synthetic`` training from an ImageNet backbone and the study's
    --quick run, in a process where importing JAX, flax, msgpack, PIL or
    the JAX package fails; the new model modules import there too."""
    recipe = json.load(open(RECIPE))
    recipe.update(train_batch_size=2, test_batch_size=2, network="resnet34_8s")
    cfg_file = str(tmp_path / "recipe.json")
    json.dump(recipe, open(cfg_file, "w"))
    pth = str(tmp_path / "resnet34.pth")
    _imagenet_pth(pth, "resnet34")
    argv = ["train", "--synthetic", "--cfg_file", cfg_file,
            "--synthetic_images", "4", "--steps", "1", "--buckets", "48x64",
            "--imagenet_pth", pth, "--device", "cpu",
            "--data_dir", str(tmp_path / "d"),
            "--model_dir", str(tmp_path / "m")]
    code = ("import sys\n"
            f"for m in {_BLOCKED!r}: sys.modules[m] = None\n"
            "import runpy\n"
            "import pvnet_tpu_torch.models.detector\n"
            "import pvnet_tpu_torch.models.vgg\n"
            "from pvnet_tpu_torch import multiclass_study\n"
            f"sys.argv = {argv!r}\n"
            "try:\n"
            "    runpy.run_module('pvnet_tpu_torch.train', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "assert multiclass_study.main(['--quick', '--device', 'cpu', "
            f"'--epochs', '1', '--out_dir', {str(tmp_path / 's')!r}]) == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(tmp_path / "m")) == ["0.pth", "log.jsonl"]
    assert os.path.exists(tmp_path / "s" / "metrics.json")
