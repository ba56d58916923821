"""The port's inference CLI takes the reference CLI's intrinsics and
keypoint inputs: every named intrinsics matrix, a file before a name
(tools/infer.py's lookup order), and --center_3d."""
import json
import os

import numpy as np
import pytest

from pvnet_tpu import config as JC
from pvnet_tpu_torch import config as TC
from pvnet_tpu_torch import infer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
FIXTURE = os.path.join(REPO, "assets", "duck_views_480x640.npz")


def test_intrinsics_table_matches_the_jax_package():
    assert set(TC.INTRINSIC_MATRICES) == set(JC.INTRINSIC_MATRICES)
    for name, K in JC.INTRINSIC_MATRICES.items():
        got = TC.INTRINSIC_MATRICES[name]
        assert got.dtype == K.dtype, name
        np.testing.assert_array_equal(got, K, err_msg=name)
    assert TC.SYMMETRIC_CLS_NAMES == JC.SYMMETRIC_CLS_NAMES


@pytest.mark.parametrize("name", ["linemod", "blender", "pascal"])
def test_K_names_resolve_as_tools_infer(name):
    K = infer.resolve_K(name)
    assert K.dtype == np.float32
    np.testing.assert_array_equal(K, JC.INTRINSIC_MATRICES[name])


def test_K_file_comes_before_a_name(tmp_path, monkeypatch):
    K = np.array([[600.0, 0, 300], [0, 610, 200], [0, 0, 1]])
    np.savetxt(tmp_path / "blender", K)
    monkeypatch.chdir(tmp_path)
    # a file called like a named matrix wins, as os.path.exists comes first
    np.testing.assert_array_equal(infer.resolve_K("blender"),
                                  K.astype(np.float32))
    np.testing.assert_array_equal(
        infer.resolve_K(str(tmp_path / "blender")), K.astype(np.float32))
    with pytest.raises(SystemExit):
        infer.resolve_K("kinect")


def test_cli_with_blender_K_and_center_3d(tmp_path):
    """The 8 FPS keypoints in a txt and the centre through --center_3d give
    the 9-keypoint set of the fixture, so the poses equal those of the
    fixture's own points_3d; --K blender reaches the solver."""
    with np.load(FIXTURE) as z:
        pts = z["points_3d"]
        np.savez(tmp_path / "views.npz", images=z["images"][:, 200:264,
                                                            280:376])
    np.savetxt(tmp_path / "fps8.txt", pts[:8])
    np.savetxt(tmp_path / "center.txt", pts[8:])
    np.savez(tmp_path / "pts9.npz", points_3d=pts)
    np.testing.assert_array_equal(
        infer.load_points_3d(str(tmp_path / "fps8.txt"),
                             str(tmp_path / "center.txt")), pts)

    def run(out, *extra):
        argv = ["--checkpoint", CKPT, "--images",
                str(tmp_path / "views.npz"), "--device", "cpu", "--batch",
                "2", "--output", str(tmp_path / out), *extra]
        assert infer.main(argv) == 0
        return [json.loads(line)
                for line in (tmp_path / out).read_text().splitlines()]

    center = run("center.jsonl", "--points_3d", str(tmp_path / "fps8.txt"),
                 "--center_3d", str(tmp_path / "center.txt"), "--K",
                 "blender")
    whole = run("whole.jsonl", "--points_3d", str(tmp_path / "pts9.npz"),
                "--K", "blender")
    linemod = run("linemod.jsonl", "--points_3d", str(tmp_path / "pts9.npz"))
    assert len(center) == len(whole) == 2
    for a, b, c in zip(center, whole, linemod):
        assert np.asarray(a["kps"]).shape == (9, 2)
        assert a["pose"] == b["pose"] and a["kps"] == b["kps"]
        # the same keypoints under other intrinsics give another pose
        assert a["kps"] == c["kps"] and a["pose"] != c["pose"]


def test_cli_reads_jpeg_files(tmp_path):
    """--images as a glob of JPEG files decodes them with data/image_io
    (no PIL): the same pixels as the JAX package's reader (cv2) and the
    same poses as those pixels given as an .npy."""
    from PIL import Image
    from pvnet_tpu.data.linemod import read_rgb_np
    with np.load(FIXTURE) as z:
        crops = z["images"][:, 200:264, 280:376]
    for i, crop in enumerate(crops):
        Image.fromarray(crop).save(tmp_path / f"view{i}.jpg")
    imgs, names = infer.load_images(str(tmp_path / "view*.jpg"))
    assert names == [str(tmp_path / f"view{i}.jpg") for i in range(2)]
    want = np.stack([read_rgb_np(n) for n in names])
    np.testing.assert_array_equal(imgs, want)
    np.save(tmp_path / "decoded.npy", want)

    def run(images, out):
        assert infer.main(["--checkpoint", CKPT, "--images", images,
                           "--points_3d", FIXTURE, "--device", "cpu",
                           "--batch", "2", "--output",
                           str(tmp_path / out)]) == 0
        return [json.loads(line)
                for line in (tmp_path / out).read_text().splitlines()]
    a = run(str(tmp_path / "view*.jpg"), "jpeg.jsonl")
    b = run(str(tmp_path / "decoded.npy"), "npy.jsonl")
    assert [r["pose"] for r in a] == [r["pose"] for r in b]


@pytest.mark.parametrize("argv,recipe,want", [
    # without --quant the recipe's options, and tools/infer.py passes its
    # quant_mode only with stages
    ([], {}, ((), "dynamic", False, False)),
    ([], {"quant_stages": [2, 3], "quant_mode": "static"},
     ((2, 3), "static", False, False)),
    ([], {"quant_decoder": True, "quant_tail": True, "quant_mode": "static"},
     ((), "dynamic", True, True)),
    # --quant: the CLI's stages (default all four) and mode (default
    # static); --quant_decoder / --quant_tail only with --quant
    (["--quant"], {"quant_stages": [3]}, ((0, 1, 2, 3), "static", False,
                                          False)),
    (["--quant", "--quant_stages", "1,3", "--quant_mode", "dynamic",
      "--quant_decoder", "--quant_tail"], {}, ((1, 3), "dynamic", True,
                                              True)),
    (["--quant_decoder", "--quant_tail"], {}, ((), "dynamic", False, False)),
])
def test_quant_options_follow_tools_infer(argv, recipe, want):
    args = infer.parse_args(["--checkpoint", CKPT, "--images", "x.npz",
                             "--points_3d", "x.npz", *argv])
    opts = infer.quant_options(args, TC.TrainConfig.from_dict(recipe))
    assert (opts["quant_stages"], opts["quant_mode"], opts["quant_decoder"],
            opts["tail_quant"]) == want
