"""Write the JAX reference that chip_smoke.py's evaluation phase holds the
port against: pose-evaluation rates of assets/duck_ckpt.msgpack on 64
images of the synthetic occluded split, computed with the JAX package.

The split is README's: the test half of
generate_synthetic_linemod(num_images=2048, occluder_prob=0.5,
max_clutter=2, seed=0). The 64 images are the first 64 that
``tools/train.py --test_model`` evaluates (test.txt without val.txt, i.e.
images 1228-1291). This script replays the JAX generator's draws with the
JAX package's own functions and renders those 64 in memory (no JPEG or PNG
is written, so the arrays are the raw renders the port generates), then
evaluates them as TrainLoop.validate does: batches of the recipe's
test_batch_size, ``TrainLoop.eval_pipeline`` at the JAX CLI's default
tail_depth 3 (its stratified packed-lattice sampler runs on every backend;
off the TPU the plain path samples by top-k instead) in float32, LINEMOD_K,
``Evaluator``, the batch key ``fold_in(PRNGKey(seed), batch)``. It does so
for PRNG seeds 0, 1 and 2, plain and with uncertainty PnP; the spread of
the rates over the seeds is how far RANSAC's draws alone move them, and
sets the tolerance of the comparison. It then evaluates the same images
once more as README's run saw them: written as JPEG by PIL, as the JAX
generator writes them, and read back by cv2, as the JAX dataset reads
them (``runs_jpeg``).

  python tools/make_torch_eval_fixture.py     # assets/duck_eval_occ64.json
  # the int8 production preset's reference: f32 with whole-backbone int8
  # PTQ, static scales calibrated on the first 8 of the 64 images
  python tools/make_torch_eval_fixture.py --quant   # ..._occ64_int8.json
  # README's whole test half, one seed, plain, raw renders (~1 h)
  python tools/make_torch_eval_fixture.py --count 1024 --seeds 0 \
      --modes plain --inputs raw --output data/jax_eval_occ1024_raw.json

Runs on the CPU (JAX_PLATFORMS=cpu), about ten minutes. ``--quant``
evaluates the same 64 raw renders with the JAX model built as
``tools/infer.py --quant`` builds it (stages 0-3 int8, ``quant_mode``
'static', scales from ``ops.quant_conv.calibrate`` on images 1228-1235 in
one batch, as ``tools/infer.py`` calibrates on a request's first 8
images), float32, tail_depth 3, and also writes the calibrated ``quant``
collection (``{flax path: act_absmax}``). XLA's int8 convolution is slow
on the CPU (~6 min per batch of 8 at 480x640), so the FCN and packed tail
run once per batch, in ``--workers`` processes, and each seed and mode
votes on the stored packed fields with the ops of
``TrainLoop.eval_pipeline``'s fwd: about 65 minutes with 4 workers on 8
cores. The fields (1.6 GB) are cached under the gitignored data/.
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "assets", "duck_eval_occ64.json")
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
SPLIT = dict(num_images=2048, occluder_prob=0.5, max_clutter=2, seed=0)
N_EVAL = 64
TAIL_DEPTH = 3
SEEDS = (0, 1, 2)
QUANT_OUT = os.path.join(REPO, "assets", "duck_eval_occ64_int8.json")
QUANT_STAGES = (0, 1, 2, 3)
N_CALIB = 8


def first_evaluated(num_images: int, count: int) -> list:
    """The first ``count`` images tools/train.py --test_model evaluates:
    LineModImageDB's test_real_set (test.txt minus val.txt), then its
    val_real_set, with the JAX generator's split arithmetic."""
    n_train = max(1, int(num_images * 0.5))
    n_val = max(1, int(num_images * 0.1))
    names = list(range(num_images))
    val = names[n_train:n_train + n_val]
    test_only = [k for k in names[n_train:] if k not in val]
    return (test_only + val)[:count]


def render_views(indices):
    """(images, masks, poses) of the split's images ``indices``: the JAX
    generator's draws in its order, rendering only those images (a render
    draws only its background, which a skipped image still draws)."""
    from pvnet_tpu.config import LINEMOD_K
    from pvnet_tpu.data import synthetic as S
    wanted = set(indices)
    rng = np.random.RandomState(SPLIT["seed"])
    dmeshes = [S.make_distractor_mesh(rng) for _ in range(8)]
    mesh = S.make_duck_mesh()
    views = {}
    for k in range(SPLIT["num_images"]):
        pose = S.sample_object_pose(rng)
        dist = S.sample_distractors(pose, rng, dmeshes,
                                    SPLIT["occluder_prob"],
                                    SPLIT["max_clutter"])
        if k in wanted:
            rgb, mask = S.render_synthetic_view(mesh, pose, LINEMOD_K, 480,
                                                640, rng, distractors=dist)
            views[k] = (rgb, mask, pose)
        else:
            rng.randint(0, 80, (480, 640, 3))
    images, masks, poses = (np.stack([views[k][i] for k in indices])
                            for i in range(3))
    return images, masks, poses.astype(np.float32), mesh


def object_meta(mesh):
    """ObjectMeta as LineModModelDB reads it back from the tree the JAX
    generator writes (FPS 8 + bbox centre, the mesh, distance.txt / 100)."""
    from pvnet_tpu.eval.evaluator import ObjectMeta
    from pvnet_tpu.ops.fps import farthest_point_sampling
    v = np.asarray(mesh.vertices, np.float32)
    center = (v.max(0) + v.min(0)) / 2.0
    pts = np.concatenate([farthest_point_sampling(v, 8, init_center=True),
                          center[None]], 0).astype(np.float32)
    buf = io.StringIO()
    np.savetxt(buf, np.asarray([np.linalg.norm(v.max(0) - v.min(0))
                                * 100.0]))
    diameter = float(np.loadtxt(io.StringIO(buf.getvalue()))) / 100.0
    return ObjectMeta(points_3d=pts, model_pts=v, diameter=diameter,
                      symmetric=False, name="duck")


def jpeg_roundtrip(images: np.ndarray) -> np.ndarray:
    """The images as the JAX training CLI sees them: PIL's JPEG encoding
    (generate_synthetic_linemod's Image.save, default quality) decoded by
    cv2 (data.linemod.read_rgb_np)."""
    import cv2
    from PIL import Image
    out = []
    for rgb in images:
        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="JPEG")
        bgr = cv2.imdecode(np.frombuffer(buf.getvalue(), np.uint8),
                           cv2.IMREAD_COLOR)
        out.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    return np.stack(out)


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def evaluate(images, poses, meta, uncertainty: bool, seed: int):
    """Rates and per-image errors of one pass, as TrainLoop.validate."""
    import jax
    import jax.numpy as jnp
    from flax import serialization
    from pvnet_tpu.config import (IMAGENET_MEAN, IMAGENET_STD, LINEMOD_K,
                                  PathConfig, TrainConfig)
    from pvnet_tpu.eval import metrics as M
    from pvnet_tpu.eval.evaluator import Evaluator
    from pvnet_tpu.train.loop import TrainLoop

    cfg = TrainConfig.from_json(RECIPE)
    cfg.bf16 = False
    # its recorder writes under the gitignored data/record/
    loop = TrainLoop(cfg, "duck", paths=PathConfig(), use_mesh=False)
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    ev = Evaluator(meta)
    bs = cfg.test_batch_size
    key = jax.random.PRNGKey(seed)
    preds = []
    for bidx in range(0, len(images) // bs):
        sl = slice(bidx * bs, (bidx + 1) * bs)
        x = ((images[sl].astype(np.float32) / 255.0 - IMAGENET_MEAN)
             / IMAGENET_STD).astype(np.float32)
        fwd = loop.eval_pipeline((480, 640), bs, uncertainty,
                                 tail_depth=TAIL_DEPTH)
        key = jax.random.fold_in(key, bidx)
        Ks = np.broadcast_to(LINEMOD_K, (bs, 3, 3))
        if uncertainty:
            mean, cov = fwd(variables, jnp.asarray(x), key)
            preds.append(ev.evaluate_uncertainty_batch(
                np.asarray(mean), np.asarray(cov), poses[sl], Ks))
        else:
            kps = fwd(variables, jnp.asarray(x), key)
            preds.append(ev.evaluate_batch(np.asarray(kps), poses[sl], Ks))
    proj, add, cm = ev.average_precision(verbose=False)
    pp = jnp.asarray(np.concatenate(preds))
    trans_cm, rot_deg = (np.asarray(t) for t in
                         M.cm_degree_errors(pp, jnp.asarray(poses)))
    return {"proj": proj, "add": add, "cm": cm,
            "per_image": {"add_m": [float(x) for x in ev.add_dists],
                          "proj_px": [float(x) for x in ev.proj_mean_diffs],
                          "trans_cm": trans_cm.tolist(),
                          "rot_deg": rot_deg.tolist()}}


def _variables():
    import jax
    import jax.numpy as jnp
    from flax import serialization
    with open(CKPT, "rb") as f:
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))


def _normalized(images):
    from pvnet_tpu.config import IMAGENET_MEAN, IMAGENET_STD
    return ((images.astype(np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD).astype(np.float32)


def _quant_model(mode: str):
    from pvnet_tpu.models.pvnet import build_model
    return build_model("resnet18_8s", ver_dim=18, seg_dim=2,
                       quant_stages=QUANT_STAGES, quant_mode=mode)


def calibrate_quant(images) -> dict:
    """The ``quant`` collection of ``ops.quant_conv.calibrate`` on the
    first N_CALIB images, in one batch, float32 (numpy leaves)."""
    import jax
    import jax.numpy as jnp
    from pvnet_tpu.ops import quant_conv
    quant = quant_conv.calibrate(
        _quant_model("calibrate"), _variables(),
        [jnp.asarray(_normalized(images[:N_CALIB]))], train=False)
    return jax.tree_util.tree_map(np.asarray, quant)


def _packed_fields(job):
    """Worker: the static int8 model's packed field and fgcnt of one batch
    (the part of eval_pipeline's fwd before selection)."""
    images, quant = job
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from pvnet_tpu.ops import packed_tail
    model = _quant_model("static")
    variables = {**_variables(), "quant": quant}

    @jax.jit
    def fields(v, x):
        fm8, x4s, x2s = model.apply(v, x, train=False,
                                    return_8s_features=True)
        return packed_tail.packed_tail_deep3_from_variables(
            v, fm8, x4s, x2s, x, dtype=jnp.float32)

    packed, fgcnt = fields(variables, jnp.asarray(_normalized(images)))
    return np.asarray(packed), np.asarray(fgcnt)


def evaluate_packed(fields, poses, meta, uncertainty: bool, seed: int):
    """Rates of one pass voting on stored packed fields, with the draws and
    ops of TrainLoop.eval_pipeline's fwd (tail_depth 3, f32 counts)."""
    import jax
    import jax.numpy as jnp
    from pvnet_tpu import pipeline as pl_mod
    from pvnet_tpu.config import LINEMOD_K
    from pvnet_tpu.eval.evaluator import Evaluator
    from pvnet_tpu.ops import voting
    params = pl_mod.VoteParams()

    @jax.jit
    def vote(packed, fgcnt, key):
        k0, k1, k2 = jax.random.split(key, 3)
        fg = voting.sample_foreground_packed(packed, fgcnt, params.max_num,
                                             k0)
        kps = voting.ransac_voting_v3_from_fg(
            fg, k1, hyp_num=params.hyp_num,
            inlier_thresh=params.inlier_thresh, min_num=params.min_num)
        if not uncertainty:
            return kps
        _, cov = voting.estimate_voting_distribution_from_fg(
            fg, kps, k2, hyp_num=params.uncertainty_hyp_num,
            inlier_thresh=params.inlier_thresh)
        return kps, cov

    ev = Evaluator(meta)
    key = jax.random.PRNGKey(seed)
    bs = len(fields[0][0])
    for bidx, (packed, fgcnt) in enumerate(fields):
        sl = slice(bidx * bs, (bidx + 1) * bs)
        key = jax.random.fold_in(key, bidx)
        Ks = np.broadcast_to(LINEMOD_K, (bs, 3, 3))
        out = vote(jnp.asarray(packed), jnp.asarray(fgcnt), key)
        if uncertainty:
            ev.evaluate_uncertainty_batch(np.asarray(out[0]),
                                          np.asarray(out[1]), poses[sl], Ks)
        else:
            ev.evaluate_batch(np.asarray(out), poses[sl], Ks)
    proj, add, cm = ev.average_precision(verbose=False)
    return {"proj": proj, "add": add, "cm": cm, "seed": seed}


def main_quant(args, seeds) -> int:
    import multiprocessing as mp
    t0 = time.time()
    indices = first_evaluated(SPLIT["num_images"], args.count)
    images, masks, poses, mesh = render_views(indices)
    meta = object_meta(mesh)
    print(f"rendered {len(indices)} views in {time.time() - t0:.1f} s",
          flush=True)
    bs = 8
    # the forwards are the slow part: kept under the gitignored data/, so
    # that a rerun only votes
    cache = os.path.join(REPO, "data", f"jax_int8_fields_{args.count}.npz")
    if os.path.exists(cache):
        with np.load(cache, allow_pickle=True) as z:
            quant = z["quant"].item()
            fields = list(zip(z["packed"], z["fgcnt"]))
        print(f"read the packed fields from {cache}", flush=True)
    else:
        quant = calibrate_quant(images)
        print(f"calibrated on images {indices[:N_CALIB]} in "
              f"{time.time() - t0:.1f} s", flush=True)
        jobs = [(images[i:i + bs], quant)
                for i in range(0, len(images), bs)]
        with mp.get_context("spawn").Pool(args.workers) as pool:
            fields = pool.map(_packed_fields, jobs)
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        np.savez(cache, quant=np.asarray(quant, dtype=object),
                 packed=np.stack([f[0] for f in fields]),
                 fgcnt=np.stack([f[1] for f in fields]))
        print(f"packed fields of {len(jobs)} batches in "
              f"{time.time() - t0:.1f} s", flush=True)
    out = {"split": SPLIT, "indices": indices, "tail_depth": TAIL_DEPTH,
           "dtype": "float32", "test_batch_size": bs,
           "quant": {"stages": list(QUANT_STAGES), "mode": "static",
                     "calibration_indices": indices[:N_CALIB],
                     "act_absmax": {k: float(v["act_absmax"]) for k, v in
                                    _flat_modules(quant).items()}},
           "sha256": {"images": sha256(images), "masks": sha256(masks),
                      "poses": sha256(poses)},
           "runs": {}}
    for mode in args.modes.split(","):
        runs = []
        for seed in seeds:
            r = evaluate_packed(fields, poses, meta, mode == "uncertainty",
                                seed)
            runs.append(r)
            print(f"int8 {mode} seed {seed}: proj {r['proj']:.4f} add "
                  f"{r['add']:.4f} cm {r['cm']:.4f}", flush=True)
        out["runs"][mode] = runs
    with open(args.output or QUANT_OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.output or QUANT_OUT} in {time.time() - t0:.1f} s")
    return 0


def _flat_modules(tree, prefix=""):
    """{flax module path: its variables} of a nested collection."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if any(isinstance(x, dict) for x in v.values()):
            out.update(_flat_modules(v, path))
        else:
            out[path] = v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output", default=None,
                   help=f"default {DEFAULT_OUT}, or with --quant "
                        f"{QUANT_OUT}")
    p.add_argument("--count", type=int, default=N_EVAL,
                   help="images of the test half, in its evaluation order "
                        "(1024: the whole half, README's set)")
    p.add_argument("--seeds", default=",".join(map(str, SEEDS)))
    p.add_argument("--modes", default="plain,uncertainty")
    p.add_argument("--inputs", default="raw,jpeg",
                   help="raw renders and/or their JPEG round trip")
    p.add_argument("--quant", action="store_true",
                   help="the int8-static preset's reference (raw inputs)")
    p.add_argument("--workers", type=int, default=4,
                   help="processes for the int8 forwards (--quant)")
    args = p.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    import jax
    jax.config.update("jax_platforms", "cpu")
    if args.quant:
        return main_quant(args, seeds)
    args.output = args.output or DEFAULT_OUT

    t0 = time.time()
    indices = first_evaluated(SPLIT["num_images"], args.count)
    images, masks, poses, mesh = render_views(indices)
    meta = object_meta(mesh)
    print(f"rendered {len(indices)} views in {time.time() - t0:.1f} s",
          flush=True)
    out = {"split": SPLIT, "indices": indices, "tail_depth": TAIL_DEPTH,
           "dtype": "float32", "test_batch_size": 8,
           "sha256": {"images": sha256(images), "masks": sha256(masks),
                      "poses": sha256(poses)},
           "readme": {"plain": [0.641, 0.521, 0.548],
                      "uncertainty": [0.659, 0.559, 0.569]},
           "runs": {}}
    inputs = args.inputs.split(",")
    for key, kind in (("runs", "raw"), ("runs_jpeg", "jpeg")):
        if kind not in inputs:
            continue
        out[key] = {}
        imgs = images if kind == "raw" else jpeg_roundtrip(images)
        for mode in args.modes.split(","):
            runs = []
            for seed in seeds:
                t1 = time.time()
                r = evaluate(imgs, poses, meta, mode == "uncertainty", seed)
                r["seed"] = seed
                if seed != seeds[0] or key == "runs_jpeg":
                    del r["per_image"]      # kept for the first seed only
                runs.append(r)
                print(f"{key} {mode} seed {seed}: proj {r['proj']:.4f} add "
                      f"{r['add']:.4f} cm {r['cm']:.4f} "
                      f"({time.time() - t1:.1f} s)", flush=True)
            out[key][mode] = runs
    with open(args.output, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.output} in {time.time() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main())
