"""The production artifact through the export CLI
(``python -m pvnet_tpu_torch.export --packed_stem --quant``: raw uint8
images packed and normalized in the program, the folded packed4 stem, int8
backbone stages 0-3 with static scales calibrated on a rendered batch,
bf16 FCN and tail, the packed tail at depth 3), on the CPU at 64x96:
its manifest, its operators, the call against the direct
pipeline.estimate_poses with the same weights, scales and draws (bit for
bit), and ``--load``."""
import json
import os

import numpy as np
import pytest
import torch

from pvnet_tpu_torch import export as TE
from pvnet_tpu_torch import pipeline as TPL
from pvnet_tpu_torch.ops import quant_conv
from tools.make_torch_fixture import DEFAULT_OUT

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
# tools/export.py's manifest keys (:205-220), and the port's additions
JAX_KEYS = {"batch", "height", "width", "network", "vn", "uncertainty",
            "fused_tail", "tail_depth", "quant", "quant_stages",
            "quant_mode", "quant_tail", "quant_decoder", "platforms",
            "weights", "input_dtype", "points_3d", "call"}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("preset"))
    assert TE.main(["--out_dir", out, "--checkpoint", CKPT, "--points_3d",
                    DEFAULT_OUT, "--packed_stem", "--quant", "--device",
                    "cpu", "--batch", "2", "--height", "64", "--width",
                    "96"]) == 0
    return out, TE.load_artifact(out, "cpu")


def test_manifest(exported):
    out, art = exported
    with open(os.path.join(out, TE.MANIFEST)) as f:
        m = json.load(f)
    assert JAX_KEYS <= set(m)
    assert (m["batch"], m["height"], m["width"], m["vn"]) == (2, 64, 96, 9)
    assert m["input_dtype"] == "uint8" and m["bf16"] and m["fused_tail"]
    assert m["tail_depth"] == 3 and not m["uncertainty"]
    assert m["quant_stages"] == [0, 1, 2, 3] and m["quant_mode"] == "static"
    assert m["draws"] == {"noise": [2, 32, 48], "pair_u": [2, 512, 2]}
    assert m["custom_ops"] == ["count_inliers", "pnp_epnp", "pnp_lm",
                               "select_nhwc"]
    with np.load(DEFAULT_OUT) as z:
        np.testing.assert_array_equal(np.float32(m["points_3d"]),
                                      z["points_3d"])


def test_operators_and_baked_scales(exported):
    _, art = exported
    assert TE.custom_ops(art.program) == ["count_inliers", "pnp_epnp",
                                          "pnp_lm", "select_nhwc"]
    model = TE.eager_model(art)
    convs = quant_conv.quant_convs(model)
    assert len(convs) == 19 and model.resnet18_8s.stem == "packed4"
    assert all(c.mode == "static" and float(c.act_absmax) > 0
               for c in convs.values())


def test_call_equals_direct_pipeline(exported):
    _, art = exported
    with np.load(DEFAULT_OUT) as z:
        u8 = torch.tensor(z["images"][:, 224:288, 264:360].copy())
    pose, kps = art.call(u8, 5)
    m = art.manifest
    est = TPL.estimate_poses(
        TE.eager_model(art), u8, torch.tensor(m["points_3d"]),
        torch.tensor(m["K"]), TPL.VoteParams(),
        **dict(zip(m["draws"], art.draws(5))), **TE.pipeline_options(m))
    assert torch.isfinite(pose).all() and pose.shape == (2, 3, 4)
    assert torch.equal(pose, est.pose) and torch.equal(kps, est.kps)
    again = art.call(u8, 5)
    assert torch.equal(again[0], pose) and torch.equal(again[1], kps)


def test_load_cli(exported, capsys):
    out, _ = exported
    assert TE.main(["--load", out]) == 0
    text = capsys.readouterr().out
    assert "pose (2, 3, 4) kps (2, 9, 2) finite=True" in text
