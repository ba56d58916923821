"""Single-image pose demo (ref tools/demo.py).

The port's counterpart of tools/demo.py, with its flags and defaults plus
``--device`` and ``--seed``: image -> (GT-derived or FCN fields) -> RANSAC
voting -> PnP -> the projected 3D bounding box drawn over the image and
written to ``--output``.

  python -m pvnet_tpu_torch.demo --demo_dir assets/demo_mini \
      [--checkpoint assets/duck_ckpt.msgpack] [--device cpu]

``--demo_dir`` holds the five files the JAX tool reads: ``cat.jpg``,
``cat_mask.png``, ``cat_pose.npy``, ``cat_points_3d.txt`` and
``cat_bb8_3d.txt`` (the reference's cat demo data is not in the
repository; assets/demo_mini holds the duck's frame 0 of
assets/linemod_mini under those names, tools/make_torch_demo_fixture.py).
The image and mask are decoded by data/image_io (the mask dithered as
PIL's ``convert("1")`` does).

Without ``--checkpoint`` (or with ``--gt-field``) the vertex field is
built from the GT mask and pose (ref demo.py:58-87): every foreground
pixel's unit vector to each projected keypoint, channel-major [1, 2vn, h,
w] with channel 2k + {0, 1} keypoint k's (x, y). With ``--checkpoint``
the FCN of a flax msgpack checkpoint or a ``.pth`` of the port's trainer
(the formats of infer.load_model; the JAX tool takes an orbax directory,
ROADMAP D5) gives the fields through pipeline.predict_fields. Voting is
ransac_voting_v3 (K1 selects the foreground, K3 counts inliers on a CUDA
device), then pipeline.poses_from_keypoints.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional

import numpy as np
import torch

from pvnet_tpu_torch import pipeline as pl_mod
from pvnet_tpu_torch.config import LINEMOD_K, repo_root
from pvnet_tpu_torch.data.image_io import read_bilevel, read_rgb
from pvnet_tpu_torch.ops import geometry as geo
from pvnet_tpu_torch.ops import voting
from pvnet_tpu_torch.utils import viz

DEFAULT_DEMO_DIR = os.path.join(repo_root(), "assets", "demo_mini")


def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (nothing
    moves to the CPU unless asked)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the CPU")
    return device


def load_demo(demo_dir: str, device) -> Dict[str, np.ndarray]:
    """The demo's inputs (tools/demo.py:52-60): rgb uint8 [h, w, 3] (as a
    tensor on ``device`` under ``rgb_t``), mask int32 [h, w], pose float32
    [3, 4], points_3d float32 [vn, 3], bb8 float32 [8, 3], and gt2d float32
    [vn, 2], the keypoints projected with the GT pose."""
    rgb_t = read_rgb(os.path.join(demo_dir, "cat.jpg"), device)
    mask = read_bilevel(os.path.join(demo_dir, "cat_mask.png"),
                        device).astype(np.int32)
    pose = np.load(os.path.join(demo_dir, "cat_pose.npy")).astype(np.float32)
    pts3d = np.loadtxt(os.path.join(demo_dir, "cat_points_3d.txt")).astype(
        np.float32)
    bb8 = np.loadtxt(os.path.join(demo_dir, "cat_bb8_3d.txt")).astype(
        np.float32)
    cam = pts3d @ pose[:, :3].T + pose[:, 3]
    uv = cam @ LINEMOD_K.T
    gt2d = (uv[:, :2] / uv[:, 2:]).astype(np.float32)
    return {"rgb": rgb_t.cpu().numpy(), "rgb_t": rgb_t, "mask": mask,
            "pose": pose, "points_3d": pts3d, "bb8": bb8, "gt2d": gt2d}


def gt_field(mask: np.ndarray, gt2d: np.ndarray) -> np.ndarray:
    """The unit-vector field of the GT mask towards the GT keypoints
    (ref demo.py:58-72 compute_vertex), channel-major float32
    [2vn, h, w]: channel 2k + {0, 1} is keypoint k's (x, y), zero off the
    mask."""
    ys, xs = np.nonzero(mask)
    pix = np.stack([xs, ys], -1).astype(np.float32)
    vec = gt2d[None] - pix[:, None]
    vec = vec / (np.linalg.norm(vec, axis=-1, keepdims=True) + 1e-9)
    vertex = np.zeros(mask.shape + (len(gt2d), 2), np.float32)
    vertex[ys, xs] = vec
    h, w = mask.shape
    return np.ascontiguousarray(vertex.reshape(h, w, -1).transpose(2, 0, 1))


def demo_fields(data: Dict[str, np.ndarray], device,
                checkpoint: Optional[str] = None):
    """(mask [1, h, w], vertex [1, 2vn, h, w]) on ``device``: the GT fields
    without ``checkpoint``, else the FCN's (infer.load_model: float32
    resnet18_8s, as tools/demo.py builds TrainConfig().network)."""
    if checkpoint is None:
        mask = torch.from_numpy(data["mask"])[None].to(device)
        vertex = torch.from_numpy(gt_field(data["mask"], data["gt2d"])
                                  )[None].to(device)
        return mask, vertex
    from pvnet_tpu_torch.infer import load_model
    model = load_model(checkpoint, len(data["points_3d"]), device)
    image = pl_mod.normalize_images(data["rgb_t"][None])
    with torch.no_grad():
        return pl_mod.predict_fields(model, image)


def pose_errors(pose_pred: np.ndarray, pose_gt: np.ndarray,
                corners_pred: np.ndarray, corners_gt: np.ndarray):
    """(rotation error in degrees, translation error in cm, mean bb8
    corner error in px), as tools/demo.py prints them."""
    ang = float(geo.rotation_angle_deg(
        torch.as_tensor(pose_pred[:, :3]), torch.as_tensor(pose_gt[:, :3])))
    trans = float(np.linalg.norm(pose_pred[:, 3] - pose_gt[:, 3])) * 100
    corner_px = float(np.linalg.norm(corners_pred - corners_gt,
                                     axis=-1).mean())
    return ang, trans, corner_px


def project_np(pts: np.ndarray, pose: torch.Tensor,
               K: torch.Tensor) -> np.ndarray:
    """Points [n, 3] projected with pose [3, 4] and K, on K's device, as
    numpy [n, 2]."""
    return geo.project(torch.as_tensor(pts, device=K.device), pose,
                       K).cpu().numpy()


def run_demo(data: Dict[str, np.ndarray], mask: torch.Tensor,
             vertex: torch.Tensor, hyp_num: int = 512,
             generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None,
             pair_u: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
    """tools/demo.py's vote_and_solve and projections on the fields:
    ransac_voting_v3 (hyp_num, max_num 1024; draws ``noise`` / ``pair_u``
    or from ``generator``), PnP, the bb8 corners projected with the
    predicted and the GT pose. Returns numpy kps [1, vn, 2], pose [3, 4],
    corners_pred / corners_gt [8, 2]."""
    dev = vertex.device
    K = torch.as_tensor(LINEMOD_K, device=dev)
    kps = voting.ransac_voting_v3(mask, vertex, hyp_num=hyp_num,
                                  max_num=1024, noise=noise, pair_u=pair_u,
                                  generator=generator)
    poses = pl_mod.poses_from_keypoints(
        torch.as_tensor(data["points_3d"], device=dev), kps, K)
    pose = poses[0]
    return {"kps": kps.cpu().numpy(), "pose": pose.cpu().numpy(),
            "corners_pred": project_np(data["bb8"], pose, K),
            "corners_gt": project_np(
                data["bb8"], torch.as_tensor(data["pose"], device=dev), K)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--demo_dir", default=DEFAULT_DEMO_DIR)
    p.add_argument("--checkpoint", default=None,
                   help="flax msgpack checkpoint or the port's .pth "
                        "(infer.load_model)")
    p.add_argument("--gt-field", action="store_true", default=None,
                   help="derive fields from GT mask+pose (default when no "
                        "checkpoint)")
    p.add_argument("--hyp_num", type=int, default=512)
    p.add_argument("--output", default="demo_out.png")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = check_device(args.device)
    if device.type == "cuda":
        # full float32 convolutions and matmuls, as the JAX reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    data = load_demo(args.demo_dir, device)
    use_gt = args.gt_field or args.checkpoint is None
    mask, vertex = demo_fields(data, device,
                               None if use_gt else args.checkpoint)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out = run_demo(data, mask, vertex, args.hyp_num, gen)
    ang, trans, corner_px = pose_errors(out["pose"], data["pose"],
                                        out["corners_pred"],
                                        out["corners_gt"])
    print(f"pose error: {ang:.3f} deg, {trans:.3f} cm, "
          f"bb8 corner error {corner_px:.1f} px")
    path = viz.visualize_bounding_box(data["rgb"], out["corners_pred"],
                                      out["corners_gt"],
                                      save_path=args.output)
    print(f"wrote {path} (blue = predicted, green = ground truth)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
