"""The port's demo and gallery CLIs (python -m pvnet_tpu_torch.demo,
visualize) run without JAX, flax, PIL, cv2 or matplotlib; ``train
--test_model --save_inter_result`` writes the files JAX's TrainLoop.
_save_inter writes; and assets/demo_mini regenerates bit for bit from
tools/make_torch_demo_fixture.py. On the CPU."""
import filecmp
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import serialization
from PIL import Image

from _linemod_tree import own_jax_caches
from pvnet_tpu.config import PathConfig as JPathConfig
from pvnet_tpu.data import dataset as JD
from pvnet_tpu.data import linemod as JL
from pvnet_tpu.models.pvnet import build_model as build_flax
from pvnet_tpu.train.loop import TrainLoop as JTrainLoop
from pvnet_tpu_torch.data import image_io
from pvnet_tpu_torch.data.synthetic import write_synthetic_linemod
from pvnet_tpu_torch.train import __main__ as CLI
from pvnet_tpu_torch.visualize import GALLERY
from tools.make_torch_demo_fixture import FILES, OUT, make_fixture

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
BLOCKED = ("jax", "flax", "msgpack", "PIL", "cv2", "matplotlib",
           "pvnet_tpu")


def test_demo_and_gallery_clis_run_without_jax_pil_or_matplotlib(tmp_path):
    out = tmp_path / "demo_out.png"
    viz = tmp_path / "viz"
    script = (
        "import sys\n"
        f"for m in {BLOCKED!r}: sys.modules[m] = None\n"
        "from pvnet_tpu_torch import demo, visualize\n"
        f"demo.main(['--device', 'cpu', '--output', {str(out)!r}])\n"
        f"visualize.main(['--device', 'cpu', '--out_dir', {str(viz)!r}])\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[0].startswith("pose error: ") and "bb8 corner error" \
        in lines[0], lines
    assert lines[1].startswith(f"wrote {out}"), lines
    assert lines[2].startswith("pose error: "), lines
    drawn = image_io.read_rgb(str(out)).numpy()
    rgb = image_io.read_rgb(os.path.join(OUT, "cat.jpg")).numpy()
    assert drawn.shape == rgb.shape == (480, 640, 3)
    # only the box's pixels changed, to blue or green
    changed = (drawn != rgb).any(-1)
    assert 0 < changed.sum() < 0.05 * changed.size
    assert set(map(tuple, drawn[changed])) <= {(0, 0, 255), (0, 128, 0)}
    for name in GALLERY:
        assert (viz / name).is_file(), name
        assert image_io.read_rgb(str(viz / name)).numpy().shape[0] == 480
    # without CUDA the default device raises; nothing moves to the CPU
    res = subprocess.run([sys.executable, "-m", "pvnet_tpu_torch.demo",
                          "--output", str(tmp_path / "x.png")], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr
    assert not (tmp_path / "x.png").exists()


def test_save_inter_result_equals_jax(tmp_path):
    """--test_model --save_inter_result on the 4-image synthetic tree
    (README's occluders; its 2 test and val frames make one batch), float32:
    the four files of batch 0 against JAX's _save_inter on the same batch
    (JAX's PoseDataset on the same records) and weights. PNGs decode to
    equal pixels (the bytes are the port's zlib stream, not PIL's), the
    pickle loads to an equal array."""
    data_dir = str(tmp_path / "data")
    root = os.path.join(data_dir, "synthetic_occ")
    write_synthetic_linemod(root, "duck", num_images=4, occluder_prob=0.5,
                            max_clutter=2, workers=1)
    recipe = tmp_path / "f32.json"
    recipe.write_text('{"bf16": false, "test_batch_size": 8}')
    ours = tmp_path / "ours"
    assert CLI.main(["--test_model", "--synthetic", "--synthetic_images",
                     "4", "--synthetic_occluder_prob", "0.5",
                     "--synthetic_clutter", "2", "--init", CKPT,
                     "--device", "cpu", "--data_dir", data_dir,
                     "--model_dir", str(tmp_path / "m"), "--cfg_file",
                     str(recipe), "--save_inter_result",
                     "--save_inter_dir", str(ours)]) == 0
    assert sorted(os.listdir(ours)) == ["0_mask_gt.png", "0_mask_pr.png",
                                        "0_pose.pkl", "0_rgb.png"]

    with own_jax_caches():
        db = JL.LineModImageDB("duck", has_render_set=False,
                               has_fuse_set=False,
                               paths=JPathConfig(data_dir=root))
    records = db.test_real_set + db.val_real_set
    assert len(records) == 2
    ds = JD.PoseDataset(records, os.path.join(root, "LINEMOD"), "Farthest",
                        augment=False)
    batch = JD.collate([ds[(i, 480, 640)] for i in range(len(records))])
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    theirs = tmp_path / "theirs"
    loop = SimpleNamespace(model=build_flax("resnet18_8s", ver_dim=18))
    JTrainLoop._save_inter(loop, str(theirs), 0, SimpleNamespace(
        params=variables["params"], batch_stats=variables["batch_stats"]),
        batch, {"image": jnp.asarray(batch["image"])})
    for name in ("0_mask_pr.png", "0_mask_gt.png"):
        got = image_io.read_mask(str(ours / name))
        want = np.asarray(Image.open(str(theirs / name)), np.int32)
        np.testing.assert_array_equal(got, want, err_msg=name)
        assert want.max() == 255
    np.testing.assert_array_equal(
        image_io.read_rgb(str(ours / "0_rgb.png")).numpy(),
        np.asarray(Image.open(str(theirs / "0_rgb.png"))))
    with open(ours / "0_pose.pkl", "rb") as f:
        got = pickle.load(f)
    with open(theirs / "0_pose.pkl", "rb") as f:
        want = pickle.load(f)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_demo_fixture_regenerates_bit_for_bit(tmp_path):
    make_fixture(str(tmp_path))
    match, mismatch, errors = filecmp.cmpfiles(OUT, str(tmp_path), FILES,
                                               shallow=False)
    assert sorted(match) == sorted(FILES), (mismatch, errors)
