"""Visualization gallery CLI (ref tools/visualize.py, which stands in for
the reference's missing ``visualization.ipynb``).

The port's counterpart of tools/visualize.py, with its flags plus
``--device`` and ``--seed``: it runs the pose pipeline on the demo data
(GT fields, or the FCN of ``--checkpoint``) and writes into ``--out_dir``

  bbox.png        projected 3D bounding box, pred (blue) vs GT (green)
  mask.png        segmentation mask
  overlap_0.png   mask tinted over the image
  hypotheses.png  RANSAC hypothesis scatter colored by inlier count
  ellipses.png    keypoint covariance ellipses (uncertainty path)
  keypoints_0.png voted keypoints vs GT, colored by keypoint index

  python -m pvnet_tpu_torch.visualize --demo_dir assets/demo_mini \
      --out_dir viz_out [--device cpu]

The calls are tools/visualize.py's (:93-105): generate_hypotheses_with_
counts (hyp_num), ransac_voting_v3 (hyp_num), estimate_voting_distribution_
with_mean (hn 4096) about the voted keypoints, then the uncertainty PnP
(pipeline.poses_from_keypoints with covar=). On a CUDA device each of the
three voting calls runs K1 once and K3 once. The overlays are drawn by
utils/viz.py (ROADMAP D5).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from pvnet_tpu_torch import pipeline as pl_mod
from pvnet_tpu_torch.config import LINEMOD_K
from pvnet_tpu_torch.demo import (DEFAULT_DEMO_DIR, check_device,
                                  demo_fields, load_demo, pose_errors,
                                  project_np)
from pvnet_tpu_torch.ops import voting
from pvnet_tpu_torch.utils import viz

GALLERY = ("bbox.png", "mask.png", "overlap_0.png", "hypotheses.png",
           "ellipses.png", "keypoints_0.png")


def run_gallery(data: Dict[str, np.ndarray], mask: torch.Tensor,
                vertex: torch.Tensor, hyp_num: int = 512,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, np.ndarray]:
    """tools/visualize.py's ``run`` on the fields: the hypotheses and
    their counts, v3 keypoints, their covariance and the uncertainty PnP.
    ``draws`` may hold each call's noise and pair uniforms (keys
    ``hyp_noise``, ``hyp_pair``, ``vote_noise``, ``vote_pair``,
    ``cov_noise``, ``cov_pair``); the rest come from ``generator``.
    Returns numpy hyps [1, hn, vn, 2], counts [1, hn, vn], kps, mean
    [1, vn, 2], cov [1, vn, 2, 2], pose [3, 4], corners_pred / corners_gt
    [8, 2]."""
    d = draws or {}
    dev = vertex.device
    K = torch.as_tensor(LINEMOD_K, device=dev)
    hyps, counts = voting.generate_hypotheses_with_counts(
        mask, vertex, hyp_num=hyp_num, max_num=1024,
        noise=d.get("hyp_noise"), pair_u=d.get("hyp_pair"),
        generator=generator)
    kps = voting.ransac_voting_v3(
        mask, vertex, hyp_num=hyp_num, max_num=1024,
        noise=d.get("vote_noise"), pair_u=d.get("vote_pair"),
        generator=generator)
    mean, cov = voting.estimate_voting_distribution_with_mean(
        mask, vertex, kps, max_num=1024, noise=d.get("cov_noise"),
        pair_u=d.get("cov_pair"), generator=generator)
    poses = pl_mod.poses_from_keypoints(
        torch.as_tensor(data["points_3d"], device=dev), mean, K, covar=cov)
    pose = poses[0]
    out = {k: v.cpu().numpy() for k, v in (
        ("hyps", hyps), ("counts", counts), ("kps", kps), ("mean", mean),
        ("cov", cov), ("pose", pose))}
    out["corners_pred"] = project_np(data["bb8"], pose, K)
    out["corners_gt"] = project_np(
        data["bb8"], torch.as_tensor(data["pose"], device=dev), K)
    return out


def write_gallery(out_dir: str, data: Dict[str, np.ndarray],
                  mask: np.ndarray, out: Dict[str, np.ndarray]) -> None:
    """The six overlays of tools/visualize.py:99-110 into ``out_dir``
    (mask: the voted mask [1, h, w])."""
    o, rgb, gt2d = out_dir, data["rgb"], data["gt2d"]
    viz.visualize_bounding_box(rgb, out["corners_pred"], out["corners_gt"],
                               save_path=os.path.join(o, "bbox.png"))
    viz.visualize_mask(mask[0], save_path=os.path.join(o, "mask.png"))
    viz.visualize_overlap_mask(rgb[None], mask,
                               save_path=os.path.join(o, "overlap_{}.png"))
    viz.visualize_hypothesis(rgb, out["hyps"][0], out["counts"][0], gt2d,
                             save_path=os.path.join(o, "hypotheses.png"))
    viz.visualize_voting_ellipse(rgb, out["mean"][0], out["cov"][0], gt2d,
                                 save_path=os.path.join(o, "ellipses.png"))
    viz.visualize_keypoints(rgb[None], gt2d[None], out["kps"],
                            save_path=os.path.join(o, "keypoints_{}.png"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--demo_dir", default=DEFAULT_DEMO_DIR)
    p.add_argument("--checkpoint", default=None,
                   help="flax msgpack checkpoint or the port's .pth "
                        "(infer.load_model); GT fields when omitted")
    p.add_argument("--hyp_num", type=int, default=512)
    p.add_argument("--out_dir", default="viz_out")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = check_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out_dir, exist_ok=True)
    data = load_demo(args.demo_dir, device)
    mask, vertex = demo_fields(data, device, args.checkpoint)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = run_gallery(data, mask, vertex, args.hyp_num, gen)
    write_gallery(args.out_dir, data, mask.cpu().numpy(), out)
    ang, trans, _ = pose_errors(out["pose"], data["pose"],
                                out["corners_pred"], out["corners_gt"])
    print(f"pose error: {ang:.3f} deg, {trans:.3f} cm")
    print(f"wrote gallery to {args.out_dir}/: bbox, mask, overlap, "
          f"hypotheses, ellipses, keypoints")
    return 0


if __name__ == "__main__":
    sys.exit(main())
