"""Offline dataset preparation with the port (tools/prepare.py: ref run.py
and data_utils.py's __main__), writing the JAX package's files without
PIL or cv2.

  python -m pvnet_tpu_torch.prepare --type fps --linemod_cls cat [--num 8]
      FPS keypoint files farthest{N}.txt (ref data_utils.py:1034-1039)
  python -m pvnet_tpu_torch.prepare --type truncated
      the Truncation LINEMOD set (ref data_utils.py:475-518)
  python -m pvnet_tpu_torch.prepare --type render --linemod_cls cat --num 100
      a Blender-free synthetic render set (LINEMOD/renders/{cls}/)
  python -m pvnet_tpu_torch.prepare --type gen_mask
      occlusion-aware masks by z-buffer compositing
      (OCCLUSION_LINEMOD/masks_gen/{cls}/{idx}.png; ref run.py:6-10)

The flags and defaults are tools/prepare.py's, plus ``--device``: JPEGs
are decoded and encoded through data/image_io on that device (the C
decoder and encoder and the CUDA pixel kernel on a CUDA device, the plain
versions on the CPU); the output files are the same either way.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from pvnet_tpu_torch.config import (LINEMOD_CLS_NAMES, OCC_LINEMOD_CLS_NAMES,
                                    PathConfig)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--type", required=True,
                   choices=["fps", "truncated", "render", "gen_mask"])
    p.add_argument("--linemod_cls", default=None,
                   help="single class (default: all)")
    p.add_argument("--num", type=int, default=8)
    p.add_argument("--data_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the JPEG decoding and encoding")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    paths = (PathConfig(data_dir=args.data_dir) if args.data_dir
             else PathConfig())
    cls_names = [args.linemod_cls] if args.linemod_cls \
        else LINEMOD_CLS_NAMES

    if args.type == "fps":
        from pvnet_tpu_torch.data.linemod import LineModModelDB
        db = LineModModelDB(paths)
        for cls in cls_names:
            pts = db.compute_farthest_surface_point_3d(cls, args.num)
            print(f"{cls}: wrote {args.num} FPS keypoints ({pts.shape})",
                  flush=True)

    elif args.type == "truncated":
        from pvnet_tpu_torch.data.linemod import \
            make_truncated_linemod_dataset
        make_truncated_linemod_dataset(cls_names, paths, device=args.device)
        print("truncated dataset written")

    elif args.type == "render":
        from pvnet_tpu_torch.data.linemod import LineModImageDB
        from pvnet_tpu_torch.data.render import PythonRenderer
        from pvnet_tpu_torch.data.synthetic import sample_object_pose
        for cls in cls_names:
            # tools/prepare.py also reads the class's records and builds
            # DataStatistics of its real train poses, and then draws every
            # pose from sample_object_pose either way; the port reads the
            # records (which writes their posedb cache, as JAX's does) and
            # draws the same poses
            LineModImageDB(cls, has_render_set=False, has_fuse_set=False,
                           paths=paths, device=args.device)
            renderer = PythonRenderer(cls, paths, device=args.device)
            rng = np.random.RandomState(0)
            poses = [sample_object_pose(rng) for _ in range(args.num)]
            out = renderer.run(poses)
            print(f"{cls}: rendered {args.num} views -> {out}", flush=True)

    elif args.type == "gen_mask":
        from pvnet_tpu_torch.data.image_io import write_png
        from pvnet_tpu_torch.data.linemod import OcclusionLineModImageDB
        from pvnet_tpu_torch.data.render import generate_occlusion_masks
        recs = {}
        for cls in OCC_LINEMOD_CLS_NAMES:
            db = OcclusionLineModImageDB(cls, paths=paths)
            if db.real_set:
                recs[cls] = db.real_set
        if not recs:
            print("no occlusion records found", file=sys.stderr)
            return 1
        out_root = os.path.join(paths.occlusion_linemod_dir, "masks_gen")
        for idx, masks in generate_occlusion_masks(list(recs), recs,
                                                   paths=paths):
            for cls, m in masks.items():
                d = os.path.join(out_root, cls)
                os.makedirs(d, exist_ok=True)
                write_png(os.path.join(d, f"{idx}.png"), m * 255)
            if idx % 100 == 0:
                print(f"image {idx}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
