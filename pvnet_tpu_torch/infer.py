"""Batch pose inference CLI — images in, poses out.

The port's counterpart of tools/infer.py: loads a flax-msgpack PVNet
checkpoint, streams the images through the image -> FCN -> voting -> PnP
pipeline in fixed-size batches, and writes one JSON line per image:

  {"path": ..., "pose": [[r r r t], ...], "kps": [[x, y], ...],
   "fg_pixels": N}

  python -m pvnet_tpu_torch.infer --checkpoint assets/duck_ckpt.msgpack \
      --points_3d assets/duck_views_480x640.npz \
      --images assets/duck_views_480x640.npz --device cuda --batch 16 \
      --output poses.jsonl [--tail_depth 3] [--uncertainty] \
      [--cfg_file configs/synthetic_train.json] [--quant] [--packed_stem]

``--tail_depth 1-3`` runs the packed-lattice decoder tail (the JAX CLI's
default is 3; here it is 0, the plain decoder, which is the faster one on
an H100, see PERF.md); ``--uncertainty`` weights the PnP by each
keypoint's hypothesis covariance. ``--cfg_file`` takes the recipe's
``network`` and ``bf16`` (the FCN under bfloat16 autocast and a bfloat16
packed tail) and its ``quant_*`` options; ``--quant`` runs the backbone
stages ``--quant_stages`` in int8 (ops/quant_conv.py), with static scales
calibrated on the first 8 images by default, as tools/infer.py does.
``--packed_stem`` builds the model with the packed4 stem (the checkpoint's
7x7 stem folded exactly) and sends the uint8 images to the device, where
they are packed and normalized (pipeline.normalize_packed_u8).

Under ``torchrun --nproc_per_node N`` the run is data parallel, one
process per device (NCCL between GPUs, gloo with ``--device cpu``): the
batch is rounded down to a multiple of N (at least N), as tools/infer.py
rounds it to the device count; each rank decodes and poses its rows of
every batch with its rows of the batch's draws (pipeline.
estimate_poses_sharded), and rank 0 gathers them and writes the output. A
last batch that N does not divide is padded with black images; its draws
are drawn for its real images alone and padded with zeros, so that every
image is posed as one process poses it. Without torchrun the same code
runs as one rank.

  torchrun --nproc_per_node 4 -m pvnet_tpu_torch.infer --checkpoint ... \
      --images 'frames/*.jpg' --batch 64

``--images`` is an .npz (key ``images``) or .npy of uint8 [n, h, w, 3], or
a glob of JPEG or PNG files of one size, decoded by the port's own decoder
(data/image_io; no PIL or cv2). ``--points_3d`` is a text file of the
object's 3D keypoints (one x y z row each) or an .npz with a
``points_3d`` key.
"""
from __future__ import annotations

import argparse
import glob as globmod
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pvnet_tpu_torch import pipeline as pl_mod
from pvnet_tpu_torch.config import (INTRINSIC_MATRICES, TrainConfig,
                                    model_kwargs)
from pvnet_tpu_torch.data.image_io import decode_rgb_batch
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.ops import quant_conv
from pvnet_tpu_torch.parallel import (Mesh, all_gather_rows,
                                      init_process_group)
from pvnet_tpu_torch.utils.weights import load_weights


def image_source(spec: str, device="cpu"
                 ) -> Tuple[List[str], Callable[[Sequence[int]], np.ndarray]]:
    """A name for each image of ``spec`` and fetch(indices) -> their uint8
    [k, h, w, 3]: an .npz (its ``images``) or .npy read whole, or a glob of
    JPEG/PNG files of one size decoded when fetched, by data/image_io (on
    a CUDA ``device`` through its C entropy decoder and CUDA kernel)."""
    if spec.endswith((".npz", ".npy")):
        if spec.endswith(".npz"):
            with np.load(spec) as z:
                imgs = z["images"]
        else:
            imgs = np.load(spec)
        return ([f"{spec}[{i}]" for i in range(len(imgs))],
                lambda idx: imgs[list(idx)])
    paths = sorted(globmod.glob(spec))
    if not paths:
        raise FileNotFoundError(f"no images match {spec}")
    return paths, lambda idx: decode_rgb_batch(
        [paths[i] for i in idx], device).cpu().numpy()


def load_images(spec: str, device="cpu") -> Tuple[np.ndarray, List[str]]:
    """uint8 [n, h, w, 3] images and a name for each (:func:`image_source`,
    every image fetched)."""
    names, fetch = image_source(spec, device)
    return fetch(range(len(names))), names


def load_points_3d(spec: str, center_3d: Optional[str] = None
                   ) -> np.ndarray:
    """[k, 3] keypoints from ``spec``; with ``center_3d`` (a txt of the
    object centre, 1x3) the centre is appended as the last keypoint, as
    tools/infer.py does."""
    if spec.endswith(".npz"):
        with np.load(spec) as z:
            pts = z["points_3d"].astype(np.float32)
    else:
        pts = np.loadtxt(spec).astype(np.float32)
    if center_3d:
        pts = np.concatenate(
            [pts, np.loadtxt(center_3d).reshape(1, 3)], 0).astype(np.float32)
    return pts


def resolve_K(spec: str) -> np.ndarray:
    """Intrinsics [3, 3] float32: an existing txt file first, otherwise a
    name in config.INTRINSIC_MATRICES (linemod, blender, pascal), the
    lookup order of tools/infer.py."""
    if os.path.exists(spec):
        return np.loadtxt(spec).astype(np.float32)
    if spec not in INTRINSIC_MATRICES:
        raise SystemExit(f"--K {spec!r} is neither a file nor one of "
                         f"{sorted(INTRINSIC_MATRICES)}")
    return INTRINSIC_MATRICES[spec].astype(np.float32)


def load_model(checkpoint: str, vn: int, device,
               cfg: Optional[TrainConfig] = None,
               **model_kw) -> torch.nn.Module:
    """The PVNet of a flax msgpack checkpoint or of a ``.pth`` written by
    the port's trainer, on ``device`` in eval mode, built as the recipe
    ``cfg`` says (its network and int8 options; float32 ResNet18-8s
    without one); ``model_kw`` overrides the recipe's options."""
    cfg = cfg or TrainConfig()
    model = build_model(cfg.network, ver_dim=2 * vn, seg_dim=2,
                        **{**model_kwargs(cfg), **model_kw})
    load_weights(model, checkpoint)
    return model.to(device).eval()


def quant_options(args, cfg: TrainConfig) -> dict:
    """The int8 options of tools/infer.py (:129-138, :160): the CLI's when
    --quant is given, else the recipe's; the decoder and the tail also when
    the recipe asks. Returns build_model's quant_* keywords plus
    ``tail_quant``."""
    if args.quant:
        stages = tuple(int(s) for s in args.quant_stages.split(","))
        mode = args.quant_mode
    else:
        stages, mode = tuple(cfg.quant_stages), cfg.quant_mode
    return {"quant_stages": stages,
            # tools/infer.py passes quant_mode only with stages
            "quant_mode": mode if stages else "dynamic",
            "quant_decoder": bool(args.quant and args.quant_decoder)
            or bool(cfg.quant_decoder),
            "tail_quant": bool(args.quant and args.quant_tail)
            or bool(cfg.quant_tail)}


def calibrate_static(model: torch.nn.Module, images_u8: np.ndarray,
                     bf16: bool = False, packed_stem: bool = False) -> int:
    """Calibrate the model's static int8 scales on the first min(8, n)
    images, in one batch, in the serving dtype (tools/infer.py:177-190);
    with ``packed_stem`` on the normalized packed input. Returns the
    number of images used."""
    n = min(8, len(images_u8))
    device = next(model.parameters()).device
    x = torch.from_numpy(np.ascontiguousarray(images_u8[:n])).to(device)
    x = (pl_mod.normalize_packed_u8(x) if packed_stem
         else pl_mod.normalize_images(x))
    with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
        quant_conv.calibrate(model, [x.permute(0, 3, 1, 2).contiguous()])
    return n


def infer_batch(model: torch.nn.Module, images_u8: np.ndarray,
                points_3d: torch.Tensor, K: torch.Tensor,
                params: pl_mod.VoteParams, generator: torch.Generator,
                tail_depth: int = 0, uncertainty: bool = False,
                bf16: bool = False, impl: Optional[str] = None,
                tail_quant: bool = False, packed_stem: bool = False,
                mesh: Optional[Mesh] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None
                ) -> pl_mod.PoseEstimate:
    """One request: uint8 [b, h, w, 3] host images -> poses on the model's
    device (upload, normalization, FCN, voting, PnP). With ``mesh`` the
    images are this rank's rows of a global batch of b * mesh.size, posed
    with its rows of the global draws, ``draws`` or drawn from
    ``generator`` (pipeline.estimate_poses_sharded).

    tail_depth 0 runs the plain decoder; 1-3 the packed-lattice tail of
    that depth (pipeline.fused_tail_foreground; even image dims), its
    stage convolutions in int8 with ``tail_quant``. bf16 runs the FCN
    under bfloat16 autocast and the tail in bfloat16 (a bf16 recipe), else
    both in float32. ``impl`` is the inlier count's mode (None float32,
    'bf16'). uncertainty=True adds the covariance pass and the
    uncertainty-weighted PnP."""
    device = points_3d.device
    x = pl_mod.normalize_images(
        torch.from_numpy(np.ascontiguousarray(images_u8)).to(device))
    options = dict(uncertainty=uncertainty, fused_tail=tail_depth > 0,
                   tail_depth=tail_depth,
                   tail_dtype=torch.bfloat16 if bf16 else torch.float32,
                   fcn_bf16=bf16, impl=impl, tail_quant=tail_quant)
    if mesh is not None:
        return pl_mod.estimate_poses_sharded(mesh, model, x, points_3d, K,
                                             params, generator, draws,
                                             **options)
    return pl_mod.estimate_poses(model, x, points_3d, K, params,
                                 generator=generator, **options)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="flax msgpack checkpoint (e.g. assets/"
                        "duck_ckpt.msgpack)")
    p.add_argument("--images", required=True,
                   help=".npz/.npy of uint8 [n, h, w, 3], or a glob of "
                        "JPEG/PNG files of one size (data/image_io)")
    p.add_argument("--points_3d", required=True,
                   help="txt of the object's 3D keypoints, or an .npz "
                        "with a points_3d key")
    p.add_argument("--center_3d", default=None,
                   help="optional txt with the object centre (1x3), "
                        "appended as the last keypoint")
    p.add_argument("--K", default="linemod",
                   help="a txt file with the 3x3 intrinsics, or a named "
                        "matrix: " + ", ".join(INTRINSIC_MATRICES))
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--tail_depth", type=int, default=0, choices=(0, 1, 2, 3),
                   help="0 plain decoder; 1-3 packed-lattice tail of that "
                        "depth (ops/packed_tail.py; needs even image dims)")
    p.add_argument("--uncertainty", action="store_true",
                   help="uncertainty-weighted PnP from the hypothesis "
                        "covariance")
    p.add_argument("--hyp_num", type=int, default=None,
                   help="hypotheses per keypoint (default: VoteParams)")
    p.add_argument("--cfg_file", default=None,
                   help="training recipe JSON: network, bf16, quant_*")
    p.add_argument("--quant", action="store_true",
                   help="int8 PTQ of the backbone stages --quant_stages "
                        "(ops/quant_conv.py; the checkpoint loads "
                        "unchanged)")
    p.add_argument("--quant_stages", default="0,1,2,3",
                   help="comma-separated backbone stages (0 = layer1) "
                        "to quantize with --quant (default: all four)")
    p.add_argument("--quant_mode", default="static",
                   choices=("dynamic", "static"),
                   help="with --quant: 'static' (default) calibrates "
                        "scalar activation scales on the first 8 images; "
                        "'dynamic' takes each image's absmax")
    p.add_argument("--quant_tail", action="store_true",
                   help="with --quant: int8 packed-tail stage convolutions "
                        "(per-image dynamic scales)")
    p.add_argument("--quant_decoder", action="store_true",
                   help="with --quant: int8 the decoder's fc and 8s "
                        "convolutions")
    p.add_argument("--packed_stem", action="store_true",
                   help="run the stem on the space-to-depth packed uint8 "
                        "image, packed and normalized on the device (the "
                        "checkpoint's 7x7 stem is folded exactly)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default="poses.jsonl")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh = init_process_group(args.device)
    try:
        return _main(args, mesh)
    finally:
        if mesh.group is not None:
            torch.distributed.destroy_process_group()


def _main(args, mesh: Mesh) -> int:
    device = mesh.device
    if device.type == "cuda":
        # full float32 convolutions and matmuls, as the JAX reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    names, fetch = image_source(args.images, device)
    n = len(names)
    pts3d = load_points_3d(args.points_3d, args.center_3d)
    K = resolve_K(args.K)
    cfg = (TrainConfig.from_json(args.cfg_file) if args.cfg_file
           else TrainConfig())
    quant = quant_options(args, cfg)
    tail_quant = quant.pop("tail_quant")
    # the batch as tools/infer.py rounds it to the device count
    batch = max(args.batch // mesh.size, 1) * mesh.size
    first = fetch(range(min(8, n)))
    h, w = first.shape[1:3]
    if mesh.is_main:
        print(f"{n} images at {h}x{w}; vn={len(pts3d)}; device {device}; "
              f"{mesh.size} rank(s), batch {batch}; tail_depth "
              f"{args.tail_depth}; uncertainty {args.uncertainty}; "
              f"{'bf16' if cfg.bf16 else 'float32'}; int8 stages "
              f"{list(quant['quant_stages'])} ({quant['quant_mode']}), "
              f"decoder {quant['quant_decoder']}, tail {tail_quant}; packed "
              f"stem {args.packed_stem}", flush=True)

    model = load_model(args.checkpoint, len(pts3d), device, cfg,
                       stem="packed4" if args.packed_stem else "conv7",
                       **quant)
    if quant["quant_stages"] and quant["quant_mode"] == "static":
        k = calibrate_static(model, first, cfg.bf16, args.packed_stem)
        if mesh.is_main:
            print(f"calibrated static int8 scales on {k} images",
                  flush=True)
    pts_t = torch.as_tensor(pts3d, device=device)
    K_t = torch.as_tensor(K, device=device)
    params = pl_mod.VoteParams()
    if args.hyp_num:
        params = params._replace(hyp_num=args.hyp_num)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    kw = dict(tail_depth=args.tail_depth, uncertainty=args.uncertainty,
              bf16=cfg.bf16, tail_quant=tail_quant,
              packed_stem=args.packed_stem)

    t0 = time.time()
    out = open(args.output, "w") if mesh.is_main else None
    try:
        for i in range(0, n, batch):
            chunk = names[i:i + batch]
            # rows of a global batch padded to a multiple of the ranks
            b = -(-len(chunk) // mesh.size) * mesh.size
            rows = range(i + mesh.rows(b).start, i + mesh.rows(b).stop)
            mine = [j for j in rows if j < n]
            imgs = np.zeros((len(rows) - len(mine), h, w, 3), np.uint8)
            if mine:
                imgs = np.concatenate([fetch(mine), imgs]) if len(imgs) \
                    else fetch(mine)
            draws = pl_mod.draw_votes(
                pl_mod.draw_shapes(len(chunk), h, w, params,
                                   args.uncertainty, args.tail_depth > 0),
                gen, b)
            est = infer_batch(model, imgs, pts_t, K_t, params, gen,
                              mesh=mesh, draws=draws, **kw)
            est = pl_mod.PoseEstimate(
                *(all_gather_rows(t, mesh) for t in est))
            if out is None:
                continue
            poses = est.pose.cpu().numpy()
            kps = est.kps.cpu().numpy()
            fg = est.fg_pixels.cpu().numpy()
            for j, name in enumerate(chunk):
                out.write(json.dumps({
                    "path": name,
                    "pose": np.round(poses[j], 6).tolist(),
                    "kps": np.round(kps[j], 2).tolist(),
                    "fg_pixels": int(fg[j]),
                }) + "\n")
    finally:
        if out is not None:
            out.close()
    dt = time.time() - t0
    if mesh.is_main:
        print(f"wrote {args.output}: {n} poses in {dt:.1f}s on {device} "
              f"x {mesh.size}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
