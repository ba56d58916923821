"""Export the image -> pose pipeline as one servable artifact, weights baked
in (the port's counterpart of tools/export.py).

``torch.export`` traces the whole pipeline (FCN, the packed tail, the
selection, hypotheses, counts, the refine, optionally the covariance, and
PnP) at a fixed batch and image size into one ``ExportedProgram``, saved as
``pipeline.pt2`` beside a ``manifest.json``. The program runs op by op as
it was traced; its selection and counting kernels are the operators
``pvnet_torch::select_cmajor`` / ``select_nhwc`` / ``count_inliers``
(ops/select_kernel.py, ops/voting.py), so the loading process imports
``pvnet_tpu_torch.ops`` to register them, which :func:`load_artifact`
does. That is the one difference from the JAX artifact, which holds no
custom call.

The port's functions take their random draws as inputs, so the program
takes ``(images, *draws)``; :meth:`Artifact.call` makes the draws from a
``torch.Generator`` seeded with ``seed`` on the artifact's device, so the
same (images, seed) gives the same pose, as JAX's ``fn.call(images,
seed)``:

    from pvnet_tpu_torch.export import load_artifact
    art = load_artifact("export_out")
    pose, kps = art.call(images, seed)       # [b, 3, 4], [b, vn, 2]

Usage:
  # export (random init without --checkpoint)
  python -m pvnet_tpu_torch.export --out_dir export_out \\
      --checkpoint assets/duck_ckpt.msgpack \\
      --points_3d assets/duck_views_480x640.npz [--batch 8] \\
      [--uncertainty] [--no-fused_tail] [--no-bf16] [--packed_stem] \\
      [--quant] [--device cpu --height 64 --width 64]

  # validate: load the artifact and run one call
  python -m pvnet_tpu_torch.export --load export_out
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import typing
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch import pipeline as pl_mod
from pvnet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, LINEMOD_K
from pvnet_tpu_torch.ops import kernel_lib, quant_conv

PROGRAM, MANIFEST = "pipeline.pt2", "manifest.json"


def draw_shapes(batch: int, height: int, width: int,
                params: pl_mod.VoteParams, uncertainty: bool,
                fused_tail: bool) -> Dict[str, List[int]]:
    """The pipeline's random draws, in the program's argument order, by
    the names of pipeline.estimate_poses: the selection noise (on the
    packed lattice with the fused tail), the hypothesis pairs and, with
    uncertainty, the covariance pass's pairs (and, on the plain path,
    which samples the foreground again for it, its noise)."""
    grid = ([batch, height // 2, width // 2] if fused_tail
            else [batch, height, width])
    shapes = {"noise": grid, "pair_u": [batch, params.hyp_num, 2]}
    if uncertainty:
        if not fused_tail:
            shapes["cov_noise"] = grid
        shapes["cov_pair_u"] = [batch, params.uncertainty_hyp_num, 2]
    return shapes


def pipeline_options(manifest: dict) -> dict:
    """pipeline.estimate_poses' options of the artifact ``manifest``
    describes."""
    bf16 = manifest["bf16"]
    return dict(uncertainty=manifest["uncertainty"],
                fused_tail=manifest["fused_tail"],
                tail_depth=manifest["tail_depth"], fcn_bf16=bf16,
                tail_dtype=torch.bfloat16 if bf16 else torch.float32,
                tail_quant=manifest["quant_tail"],
                raw_uint8=manifest["input_dtype"] == "uint8")


class PosePipeline(torch.nn.Module):
    """The pipeline as a module: forward(images, *draws) -> (pose
    [b, 3, 4], kps [b, vn, 2]), the draws named ``draw_names`` (the order
    of :func:`draw_shapes`), the rest of estimate_poses' options in
    ``options`` (:func:`pipeline_options`)."""

    def __init__(self, model: torch.nn.Module, points_3d, K,
                 params: pl_mod.VoteParams, draw_names, options: dict):
        super().__init__()
        self.model = model
        device = next(model.parameters()).device
        self.register_buffer("points_3d", torch.as_tensor(
            np.asarray(points_3d, np.float32), device=device))
        self.register_buffer("K", torch.as_tensor(
            np.asarray(K, np.float32), device=device))
        self.params, self.draw_names = params, tuple(draw_names)
        self.options = options

    def forward(self, images: torch.Tensor, *draws: torch.Tensor):
        est = pl_mod.estimate_poses(
            self.model, images, self.points_3d, self.K, self.params,
            **dict(zip(self.draw_names, draws)), **self.options)
        return est.pose, est.kps


def graph_ops(program) -> Dict[str, int]:
    """{operator name: calls} of a traced program's graph, the graphs of
    its autocast regions included (an ExportedProgram)."""
    ops: Dict[str, int] = {}
    for gm in program.graph_module.modules():
        if isinstance(gm, torch.fx.GraphModule):
            for n in gm.graph.nodes:
                if n.op == "call_function":
                    ops[str(n.target)] = ops.get(str(n.target), 0) + 1
    return ops


def custom_ops(program) -> List[str]:
    """The sorted names of the ``pvnet_torch`` operators a traced program
    calls."""
    prefix = kernel_lib.NAMESPACE + "."
    return sorted({k[len(prefix):].split(".")[0] for k in graph_ops(program)
                   if k.startswith(prefix)})


def build_exported(model: torch.nn.Module, points_3d, K, batch: int,
                   height: int, width: int, uncertainty: bool = False,
                   vote_params: Optional[pl_mod.VoteParams] = None,
                   fused_tail: bool = False, tail_depth: int = 1,
                   tail_quant: bool = False, raw_uint8: bool = False,
                   bf16: bool = False):
    """Export f(images [b, h, w, 3] float32 (uint8 with raw_uint8),
    *draws) -> (pose, kps) of ``model`` (eval mode, on its device, weights
    and calibrated int8 scales baked in) with ``torch.export.export``.
    Returns (ExportedProgram, draw shapes)."""
    params = vote_params or pl_mod.VoteParams()
    device = next(model.parameters()).device
    shapes = draw_shapes(batch, height, width, params, uncertainty,
                         fused_tail)
    options = pipeline_options(dict(
        uncertainty=uncertainty, fused_tail=fused_tail,
        tail_depth=tail_depth, bf16=bf16, quant_tail=tail_quant,
        input_dtype="uint8" if raw_uint8 else "float32"))
    module = PosePipeline(model.eval(), points_3d, K, params, shapes,
                          options).eval()
    images = torch.zeros((batch, height, width, 3),
                         dtype=torch.uint8 if raw_uint8 else torch.float32,
                         device=device)
    draws = tuple(torch.zeros(s, device=device) for s in shapes.values())
    # traced without autograd, so that the pipeline's own no_grad leaves
    # no grad-mode region in the graph; without the source line of each of
    # its ~10^4 nodes where PyTorch can leave them out (much of the
    # tracing time)
    config = torch.fx.config
    skip = hasattr(config, "do_not_emit_stack_traces")
    emit = skip and config.do_not_emit_stack_traces
    if skip:
        config.do_not_emit_stack_traces = True
    try:
        with torch.no_grad():
            program = torch.export.export(module, (images, *draws),
                                          strict=False)
    finally:
        if skip:
            config.do_not_emit_stack_traces = emit
    program.example_inputs = None       # not saved with the artifact
    return program, shapes


def save_artifact(program, out_dir: str, manifest: dict) -> str:
    """Write ``pipeline.pt2`` (torch.export.save) and ``manifest.json`` to
    ``out_dir``; returns the program's path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, PROGRAM)
    torch.export.save(program, path)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


class Artifact:
    """A loaded artifact: ``manifest`` (dict), ``program`` (the
    ExportedProgram), ``device``; :meth:`call` runs it."""

    def __init__(self, program, manifest: dict, device: torch.device):
        self.program, self.manifest, self.device = program, manifest, device
        self._module = program.module()
        self.input_dtype = (torch.uint8 if manifest["input_dtype"] == "uint8"
                            else torch.float32)
        self.draw_shapes = [tuple(s) for s in manifest["draws"].values()]

    def draws(self, seed: int) -> List[torch.Tensor]:
        """The draws of :meth:`call` for ``seed``: uniform [0, 1) float32
        from a generator seeded with ``seed`` on the artifact's device, in
        the manifest's order."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return [torch.rand(s, generator=gen, device=self.device)
                for s in self.draw_shapes]

    def call(self, images, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [b, h, w, 3] (the manifest's batch, size and input
        dtype; a numpy array or a tensor), seed -> (pose [b, 3, 4],
        keypoints [b, vn, 2]) on the artifact's device."""
        m = self.manifest
        x = torch.as_tensor(images).to(self.device)
        want = (m["batch"], m["height"], m["width"], 3)
        if tuple(x.shape) != want or x.dtype != self.input_dtype:
            raise ValueError(f"images must be {want} {self.input_dtype}; "
                             f"got {tuple(x.shape)} {x.dtype}")
        with torch.no_grad():
            return self._module(x, *self.draws(seed))


def eager_model(artifact: Artifact) -> torch.nn.Module:
    """The artifact's network as an eager model on its device, with the
    program's weights (the packed stem's folded kernel included) and int8
    scales: for holding the program against pipeline.estimate_poses."""
    from pvnet_tpu_torch.models.pvnet import build_model
    m = artifact.manifest
    model = build_model(
        m["network"], ver_dim=2 * m["vn"], seg_dim=2,
        quant_stages=tuple(m["quant_stages"]),
        quant_mode=m["quant_mode"] or "dynamic",
        quant_decoder=m["quant_decoder"],
        stem="packed4" if m["input_dtype"] == "uint8" else "conv7")
    prefix = "model."
    model.load_state_dict({k[len(prefix):]: v for k, v in
                           artifact.program.state_dict.items()
                           if k.startswith(prefix)}, strict=True)
    for name, conv in quant_conv.quant_convs(model).items():
        conv.act_absmax = artifact.program.constants.get(
            f"{prefix}{name}.act_absmax")
    return model.to(artifact.device).eval()


def load_artifact(export_dir: str, device=None) -> Artifact:
    """Load ``pipeline.pt2`` and ``manifest.json`` from ``export_dir``.
    The program runs on the device it was exported for (``device``, if
    given, must be that one's type)."""
    with open(os.path.join(export_dir, MANIFEST)) as f:
        manifest = json.load(f)
    want = torch.device(manifest["device"])
    if device is not None and torch.device(device).type != want.type:
        raise ValueError(f"{export_dir} was exported for {want.type}, not "
                         f"{torch.device(device)}")
    with _memoized_type_hints():
        program = torch.export.load(os.path.join(export_dir, PROGRAM))
    return Artifact(program, manifest, want)


@contextlib.contextmanager
def _memoized_type_hints():
    """Within the block, ``typing.get_type_hints`` answers repeated
    questions from a cache. torch.export.load asks it for the hints of the
    same few schema dataclasses once per serialized object, ~10^5 times
    for the pipeline's graph, which makes these lookups most of the
    loading time. The answers are the function's own, for the same
    arguments (the cache holds the namespaces it keys by identity)."""
    original = typing.get_type_hints
    cache = {}

    def cached(obj, globalns=None, localns=None, include_extras=False):
        key = (obj, id(globalns), id(localns), include_extras)
        if key not in cache:
            cache[key] = (globalns, localns,
                          original(obj, globalns, localns, include_extras))
        return cache[key][2]

    typing.get_type_hints = cached
    try:
        yield
    finally:
        typing.get_type_hints = original


def render_inputs(batch: int, h: int, w: int, seed: int = 0,
                  uint8: bool = False) -> np.ndarray:
    """Rendered synthetic views (the duck mesh with distractors and
    occluders), the calibration batch of bench.py's ``build_inputs``:
    ImageNet-normalized float32 [batch, h, w, 3] with a per-image
    brightness jitter, or uint8 with an integer jitter."""
    from pvnet_tpu_torch.data.synthetic import (make_distractor_mesh,
                                                make_duck_mesh,
                                                render_synthetic_view,
                                                sample_distractors,
                                                sample_object_pose)
    rng = np.random.RandomState(seed)
    mesh = make_duck_mesh()
    dmeshes = [make_distractor_mesh(rng) for _ in range(3)]
    K = LINEMOD_K.copy()
    K[0] *= w / 640.0
    K[1] *= h / 480.0
    n_base = min(batch, 8)
    raw = []
    for _ in range(n_base):
        pose = sample_object_pose(rng)
        dist = sample_distractors(pose, rng, dmeshes, occluder_prob=0.3,
                                  max_clutter=1)
        rgb, _ = render_synthetic_view(mesh, pose, K, h, w, rng,
                                       distractors=dist)
        raw.append(rgb)
    reps = -(-batch // n_base)
    tiled = np.tile(np.stack(raw), (reps, 1, 1, 1))[:batch]
    if uint8:
        jit = rng.randint(-3, 4, (batch, 1, 1, 1))
        return np.clip(tiled.astype(np.int16) + jit, 0, 255).astype(np.uint8)
    images = (tiled.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return images + rng.randn(batch, 1, 1, 1).astype(np.float32) * 0.01


def calibrate(model: torch.nn.Module, height: int, width: int, bf16: bool,
              packed_stem: bool) -> None:
    """Static int8 scales from one rendered batch of 8 (tools/export.py's
    calibration): uint8 views packed and normalized on the device with the
    packed stem, else normalized float views; in the serving dtype."""
    device = next(model.parameters()).device
    x = torch.from_numpy(render_inputs(8, height, width,
                                       uint8=packed_stem)).to(device)
    x = pl_mod.normalize_packed_u8(x) if packed_stem else x
    with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
        quant_conv.calibrate(model, [x.permute(0, 3, 1, 2).contiguous()])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out_dir", default="export_out")
    ap.add_argument("--load", default=None,
                    help="load an exported dir and run one call")
    ap.add_argument("--checkpoint", default=None,
                    help="flax msgpack or port .pth checkpoint (random "
                         "init without)")
    ap.add_argument("--points_3d", default=None,
                    help="txt of the object's 3D keypoints, or an .npz "
                         "with a points_3d key (required to export)")
    ap.add_argument("--network", default="resnet18_8s")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--uncertainty", action="store_true")
    ap.add_argument("--fused_tail", action="store_true", default=True,
                    help="export the packed-lattice tail path (default)")
    ap.add_argument("--no-fused_tail", dest="fused_tail",
                    action="store_false")
    ap.add_argument("--tail_depth", type=int, default=3, choices=(1, 2, 3),
                    help="packed decoder depth with --fused_tail")
    ap.add_argument("--no-bf16", dest="bf16", action="store_false",
                    default=True,
                    help="float32 FCN and tail (default: bf16 autocast "
                         "FCN, bf16 tail)")
    ap.add_argument("--packed_stem", action="store_true",
                    help="the artifact takes raw uint8 images; packing, "
                         "normalization and the folded packed stem run "
                         "inside the program")
    ap.add_argument("--quant", action="store_true",
                    help="int8 backbone stages --quant_stages")
    ap.add_argument("--quant_stages", default="0,1,2,3",
                    help="comma-separated backbone stages (0 = layer1) to "
                         "quantize with --quant")
    ap.add_argument("--quant_mode", default="static",
                    choices=("dynamic", "static"),
                    help="with --quant: 'static' (default) calibrates "
                         "scalar scales on one rendered batch and bakes "
                         "them into the artifact")
    ap.add_argument("--quant_tail", action="store_true",
                    help="with --quant: int8 packed-tail stage "
                         "convolutions (per-image scales)")
    ap.add_argument("--quant_decoder", action="store_true",
                    help="with --quant: int8 the decoder's fc and 8s "
                         "convolutions")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def export_from_args(args) -> Tuple["torch.export.ExportedProgram", dict]:
    """Build, export and save the artifact the CLI's ``args`` describe.
    Returns (the ExportedProgram, manifest) and prints the export seconds
    and the artifact's size."""
    from pvnet_tpu_torch.infer import load_points_3d
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.models.resnet import init_weights
    from pvnet_tpu_torch.utils.weights import load_weights

    if args.points_3d is None:
        raise SystemExit("--points_3d is required to export")
    device = torch.device(args.device)
    if device.type == "cuda":
        # full float32 convolutions and matmuls, as the JAX reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    points_3d = load_points_3d(args.points_3d)
    vn = len(points_3d)
    qs = (tuple(int(s) for s in args.quant_stages.split(","))
          if args.quant else ())
    qd = bool(args.quant and args.quant_decoder)
    model = build_model(args.network, ver_dim=2 * vn, seg_dim=2,
                        quant_stages=qs, quant_mode=args.quant_mode,
                        quant_decoder=qd,
                        stem="packed4" if args.packed_stem else "conv7")
    if args.checkpoint:
        load_weights(model, args.checkpoint)
        src = args.checkpoint
    else:
        init_weights(model, torch.Generator().manual_seed(0))
        src = "random-init"
    model = model.to(device).eval()
    if args.quant and args.quant_mode == "static":
        calibrate(model, args.height, args.width, args.bf16,
                  args.packed_stem)
    t0 = time.time()
    program, shapes = build_exported(
        model, points_3d, LINEMOD_K, args.batch, args.height, args.width,
        uncertainty=args.uncertainty, fused_tail=args.fused_tail,
        tail_depth=args.tail_depth,
        tail_quant=bool(args.quant and args.quant_tail),
        raw_uint8=args.packed_stem, bf16=args.bf16)
    export_s = time.time() - t0
    manifest = {
        "batch": args.batch, "height": args.height, "width": args.width,
        "network": args.network, "vn": vn, "uncertainty": args.uncertainty,
        "fused_tail": args.fused_tail, "tail_depth": args.tail_depth,
        "bf16": args.bf16,
        "quant": args.quant, "quant_stages": list(qs),
        "quant_mode": args.quant_mode if args.quant else None,
        "quant_tail": bool(args.quant and args.quant_tail),
        "quant_decoder": qd,
        "platforms": [device.type], "device": str(device),
        "weights": src,
        "input_dtype": "uint8" if args.packed_stem else "float32",
        "points_3d": points_3d.tolist(), "K": LINEMOD_K.tolist(),
        "draws": shapes, "custom_ops": custom_ops(program),
        "call": "load_artifact(dir).call(images [b,h,w,3] "
                + ("u8 raw" if args.packed_stem else "f32 normalized")
                + ", seed int) -> (pose [b,3,4], keypoints [b,vn,2])",
    }
    path = save_artifact(program, args.out_dir, manifest)
    print(f"exported {os.path.getsize(path) / 1e6:.1f} MB artifact for "
          f"{device} to {args.out_dir} in {export_s:.1f} s (weights: {src};"
          f" operators {manifest['custom_ops']})", flush=True)
    return program, manifest


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.load:
        t0 = time.time()
        art = load_artifact(args.load)
        m = art.manifest
        images = torch.zeros((m["batch"], m["height"], m["width"], 3),
                             dtype=art.input_dtype)
        pose, kps = art.call(images, 0)
        print(f"loaded {args.load} in {time.time() - t0:.1f} s: pose "
              f"{tuple(pose.shape)} kps {tuple(kps.shape)} "
              f"finite={bool(torch.isfinite(pose).all())}", flush=True)
        return 0
    export_from_args(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
