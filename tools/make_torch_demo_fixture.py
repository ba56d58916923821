"""Write assets/demo_mini: the five files that tools/demo.py and
tools/visualize.py read from their --demo_dir, made from frame 0 of the
duck in assets/linemod_mini, on which the port's demo
(python -m pvnet_tpu_torch.demo) and gallery (python -m
pvnet_tpu_torch.visualize) run and are held against the JAX tools' math.

The object is the duck. The files are named ``cat_*`` because the JAX
tools hard-code those names (they were written for the reference's cat
demo data, which is not in the repository):

- ``cat.jpg``: LINEMOD/duck/JPEGImages/000000.jpg, its bytes copied;
- ``cat_mask.png``: LINEMOD/duck/mask/0000.png (8-bit gray, 0/255), its
  bytes copied (the tools read it with PIL's ``convert("1")``, a dither
  that keeps a 0/255 mask whole);
- ``cat_pose.npy``: the frame's pose in the blender frame, as the JAX
  package's ``PoseTransformer.orig_pose_to_blender_pose`` gives it from
  LINEMOD_ORIG/duck/data/rot0.rot and tra0.tra;
- ``cat_points_3d.txt``: ``LineModModelDB.get_farthest_3d('duck')`` (8
  farthest points) and the box centre (``get_centers_3d``), 9 rows: the
  tools build a [h, w, 9, 2] field;
- ``cat_bb8_3d.txt``: ``get_corners_3d('duck')``, in the corner order that
  utils/viz.py's ``_BOX_EDGES`` assumes.

The JAX databases write keypoint and corner files into the tree they
read, so they read a temporary copy of it.

  python tools/make_torch_demo_fixture.py       # a few seconds, JAX on CPU
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
from unittest import mock

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SRC = os.path.join(REPO, "assets", "linemod_mini")
OUT = os.path.join(REPO, "assets", "demo_mini")
CLS = "duck"
FRAME = 0
FILES = ("cat.jpg", "cat_mask.png", "cat_pose.npy", "cat_points_3d.txt",
         "cat_bb8_3d.txt")


def make_fixture(out_dir: str = OUT, src: str = SRC) -> None:
    """Write the five files of frame FRAME of the duck under ``src`` into
    ``out_dir``."""
    from pvnet_tpu.config import PathConfig
    from pvnet_tpu.data.linemod import LineModModelDB
    from pvnet_tpu.data.pose_transforms import PoseTransformer, read_pose

    os.makedirs(out_dir, exist_ok=True)
    lm = os.path.join(src, "LINEMOD", CLS)
    shutil.copyfile(os.path.join(lm, "JPEGImages", f"{FRAME:06}.jpg"),
                    os.path.join(out_dir, "cat.jpg"))
    shutil.copyfile(os.path.join(lm, "mask", f"{FRAME:04}.png"),
                    os.path.join(out_dir, "cat_mask.png"))
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("LINEMOD", "LINEMOD_ORIG"):
            shutil.copytree(os.path.join(src, sub, CLS),
                            os.path.join(tmp, sub, CLS))
        paths = PathConfig(data_dir=tmp)
        # the transformer caches each class's translation by its name:
        # read this tree's, whatever the process read before
        with mock.patch.object(PoseTransformer, "_translation_cache", {}):
            transformer = PoseTransformer(CLS, paths.linemod_dir,
                                          paths.linemod_orig_dir)
            data = os.path.join(paths.linemod_orig_dir, CLS, "data")
            pose = transformer.orig_pose_to_blender_pose(read_pose(
                os.path.join(data, f"rot{FRAME}.rot"),
                os.path.join(data, f"tra{FRAME}.tra")))
        modeldb = LineModModelDB(paths)
        pts = np.concatenate([modeldb.get_farthest_3d(CLS),
                              modeldb.get_centers_3d(CLS)[None]], 0)
        corners = modeldb.get_corners_3d(CLS)
    np.save(os.path.join(out_dir, "cat_pose.npy"), pose)
    np.savetxt(os.path.join(out_dir, "cat_points_3d.txt"), pts)
    np.savetxt(os.path.join(out_dir, "cat_bb8_3d.txt"), corners)


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    make_fixture()
    for name in FILES:
        print(f"wrote {os.path.relpath(os.path.join(OUT, name), REPO)} "
              f"({os.path.getsize(os.path.join(OUT, name))} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
