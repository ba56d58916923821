"""Write assets/linemod_mini: a LINEMOD tree on disk with its JAX reference,
which the port's LINEMOD read path is held against on the card
(chip_smoke.py phase (m)) without JAX.

Three layouts under one data root:

- LINEMOD / LINEMOD_ORIG: ``generate_synthetic_linemod(root, "duck",
  num_images=24, image_hw=(480, 640), occluder_prob=0.5, max_clutter=2,
  seed=0)`` (24 JPEG frames as PIL writes them, 4:2:0 at quality 75, PNG
  masks, .rot/.tra poses, train/val/test lists);
- OCCLUSION_LINEMOD: 2 frames rendered by the JAX package's renderer
  (RandomState(1), an occluder on the camera ray; the background noise
  replaced by a smooth gradient, which PNG stores in a tenth of the
  bytes), written as RGB PNG
  ``RGB-D/rgb_noseg/color_{k:05}.png`` with RGB PNG masks
  ``masks/duck/{k}.png``, their poses as ``poses/Duck/info_{k:05}.txt`` in
  the Occlusion frame (the inverse of
  ``PoseTransformer.occlusion_pose_to_blender_pose``), the model
  ``models/Duck/007.xyz`` (the duck's vertices, shifted by a few mm and
  permuted into the .xyz frame) and ``LINEMOD/duck/test_occlusion.txt``;
- LINEMOD/truncated/duck: ``make_truncated_linemod_dataset`` (seed 0) on
  the first 8 frames of that tree.

Beside them, ``cases/``: small JPEGs at the decoder's edges (4:4:4,
4:2:2 and 4:2:0 at odd sizes, 2 and 3 pixels wide, gray, restart markers
written by cv2, a file cut mid-scan and a noisy quality-10 one cut
mid-scan), so that the card decodes every branch of the C entropy decoder
and of the pixel kernel against the JAX reader's hashes.

It then reads the three with the JAX package's databases (in a temporary
copy: they write posedb/ caches and keypoint files) and writes
``manifest.json``: the sha256 of ``read_rgb_np`` / ``read_mask_np``'s
output for every image file, every record's RT and keypoints, and the
rates of ``tools/train.py --test_model`` for assets/duck_ckpt.msgpack on
the test list (``--normal``), ``--occluded`` and ``--truncated``, float32,
tail_depth 0 (the port CLI's default; the plain path's selection forced to
'stratified', the TPU's and the port's: off the TPU JAX's 'auto' picks
top-k), over RANSAC seeds 0, 1 and 2 (``fold_in(PRNGKey(seed), batch)``,
as TrainLoop.validate folds its key).

  python tools/make_torch_linemod_fixture.py     # ~4 min on the CPU
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "assets", "linemod_mini")
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
CLS = "duck"
NUM_IMAGES = 24
OCC_FRAMES = 2
OCC_SEED = 1
OCC_OFFSET = np.array([0.002, -0.003, 0.0015])    # metres, .xyz vs .ply
TRUNCATED_FRAMES = 8
SEEDS = (0, 1, 2)
TAIL_DEPTH = 0
# the record fields the manifest keeps
KEYPOINTS = ("corners", "farthest", "farthest4", "farthest12", "farthest16",
             "farthest20", "center", "small_bbox")


def occlusion_pose(pose_b: np.ndarray, t_occ: np.ndarray) -> np.ndarray:
    """The Occlusion-frame pose that occlusion_pose_to_blender_pose maps
    to ``pose_b``: R_b = F R M, t_b = F t + F R M t_occ with F =
    diag(1, -1, -1) and M that function's permutation."""
    F = np.diag([1.0, -1.0, -1.0])
    M = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    R = F @ pose_b[:, :3].astype(np.float64) @ M.T
    t = F @ pose_b[:, 3].astype(np.float64) - R @ M @ t_occ
    return np.concatenate([R, t[:, None]], 1)


def write_occlusion(root: str, hw=(480, 640), K=None) -> None:
    from PIL import Image
    from pvnet_tpu.config import LINEMOD_K, PathConfig
    from pvnet_tpu.data import synthetic as S
    from pvnet_tpu.data.ply import load_ply
    from pvnet_tpu.data.pose_transforms import (CLASS_TYPE_TO_NUMBER,
                                                OCC_XYZ_ROTATION,
                                                PoseTransformer)
    K = LINEMOD_K if K is None else K
    paths = PathConfig(data_dir=root)
    occ = paths.occlusion_linemod_dir
    for d in ("RGB-D/rgb_noseg", f"masks/{CLS}", f"poses/{CLS.title()}",
              f"models/{CLS.title()}"):
        os.makedirs(os.path.join(occ, d), exist_ok=True)
    mesh = load_ply(os.path.join(paths.linemod_dir, CLS, f"{CLS}.ply"))
    xyz = (mesh.vertices.astype(np.float64) + OCC_OFFSET) @ OCC_XYZ_ROTATION
    np.savetxt(os.path.join(occ, "models", CLS.title(),
                            f"{CLASS_TYPE_TO_NUMBER[CLS]}.xyz"), xyz,
               fmt="%.6f")
    transformer = PoseTransformer(CLS, paths.linemod_dir,
                                  paths.linemod_orig_dir, occ)
    t_occ = transformer.occ_translation_transform()
    rng = np.random.RandomState(OCC_SEED)
    dmeshes = [S.make_distractor_mesh(rng) for _ in range(4)]
    duck = S.make_duck_mesh()
    lines = []
    for k in range(OCC_FRAMES):
        pose = S.sample_object_pose(rng)
        dist = S.sample_distractors(pose, rng, dmeshes, 1.0, 1)
        rgb, mask = S.render_synthetic_view(duck, pose, K, *hw, rng,
                                            distractors=dist)
        # the renderer's background is uniform noise, which PNG stores at
        # ~0.8 MB a frame: a second render with other noise finds it, and
        # a smooth gradient replaces it
        other = np.random.RandomState(OCC_SEED + 100 + k)
        again, _ = S.render_synthetic_view(duck, pose, K, *hw, other,
                                           distractors=dist)
        yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
        grad = np.stack([xx * 80 // hw[1], yy * 80 // hw[0],
                         (xx + yy) * 40 // sum(hw)], -1).astype(np.uint8)
        rgb = np.where((rgb != again).any(-1, keepdims=True), grad, rgb)
        Image.fromarray(rgb).save(os.path.join(
            occ, "RGB-D/rgb_noseg", f"color_{k:05}.png"))
        Image.fromarray(np.repeat(mask[..., None] * 255, 3, -1)).save(
            os.path.join(occ, "masks", CLS, f"{k}.png"))
        p = occlusion_pose(pose, t_occ)
        back = transformer.occlusion_pose_to_blender_pose(p)
        assert np.allclose(back, pose, atol=1e-6), (back, pose)
        with open(os.path.join(occ, "poses", CLS.title(),
                               f"info_{k:05}.txt"), "w") as f:
            f.write(f"image size\n{hw[0]} {hw[1]}\n{CLS}\nrotation:\n")
            for row in p[:, :3]:
                f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
            f.write("center:\n")
            f.write(" ".join(f"{v:.9f}" for v in p[:, 3]) + "\n")
        lines.append(f"{k:05}.jpg\n")
    with open(os.path.join(paths.linemod_dir, CLS, "test_occlusion.txt"),
              "w") as f:
        f.writelines(lines)


def write_truncated(root: str, size: int = 256) -> None:
    """make_truncated_linemod_dataset on a copy of the tree that holds the
    first TRUNCATED_FRAMES frames (it walks every frame, and frame 13 of the
    24 shows no duck, where crop_instance fails), its crops moved into
    root."""
    from pvnet_tpu.config import PathConfig
    from pvnet_tpu.data.linemod import make_truncated_linemod_dataset
    paths = PathConfig(data_dir=root)
    with tempfile.TemporaryDirectory() as tmp:
        part = PathConfig(data_dir=tmp)
        cls_dir = os.path.join(part.linemod_dir, CLS)
        os.makedirs(os.path.join(cls_dir, "JPEGImages"))
        os.makedirs(os.path.join(cls_dir, "mask"))
        shutil.copy(os.path.join(paths.linemod_dir, CLS, f"{CLS}.ply"),
                    cls_dir)
        shutil.copytree(paths.linemod_orig_dir, part.linemod_orig_dir)
        for k in range(TRUNCATED_FRAMES):
            for sub, name in (("JPEGImages", f"{k:06}.jpg"),
                              ("mask", f"{k:04}.png")):
                shutil.copy(os.path.join(paths.linemod_dir, CLS, sub, name),
                            os.path.join(cls_dir, sub))
        make_truncated_linemod_dataset([CLS], paths=part, size=size, seed=0)
        shutil.copytree(os.path.join(part.linemod_dir, "truncated"),
                        os.path.join(paths.linemod_dir, "truncated"))


def write_tree(root: str, num_images: int = NUM_IMAGES, hw=(480, 640),
               trunc_size: int = 256, render_K=None) -> None:
    """The three layouts under ``root`` (module docstring). ``render_K``
    renders the frames with other intrinsics than LINEMOD_K (a smaller
    frame shows the object with LINEMOD_K scaled to it); the poses and
    records stay LINEMOD's."""
    from pvnet_tpu.data import synthetic as S
    saved = S.LINEMOD_K
    if render_K is not None:
        S.LINEMOD_K = render_K
    try:
        S.generate_synthetic_linemod(root, CLS, num_images=num_images,
                                     image_hw=hw, occluder_prob=0.5,
                                     max_clutter=2, seed=0)
    finally:
        S.LINEMOD_K = saved
    write_occlusion(root, hw, render_K)
    write_truncated(root, trunc_size)


def write_cases(root: str) -> None:
    """cases/: JPEGs at the decoder's edges (module docstring)."""
    import io
    import cv2
    from PIL import Image
    out = os.path.join(root, "cases")
    os.makedirs(out, exist_ok=True)
    rng = np.random.RandomState(2)

    def smooth(h, w):
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([x * 255.0 / w, y * 255.0 / h,
                        ((x + y) % 64) * 4.0], -1)
        return np.clip(img + rng.rand(h, w, 3) * 40, 0, 255).astype(
            np.uint8)

    img = smooth(37, 53)
    Image.fromarray(img).save(os.path.join(out, "444_37x53.jpg"),
                              quality=95, subsampling=0)
    Image.fromarray(img).save(os.path.join(out, "422_37x53.jpg"),
                              subsampling=1)
    Image.fromarray(img).save(os.path.join(out, "420_37x53.jpg"))
    Image.fromarray(smooth(17, 3)).save(os.path.join(out, "420_17x3.jpg"))
    Image.fromarray(smooth(9, 2)).save(os.path.join(out, "422_9x2.jpg"),
                                       subsampling=1)
    Image.fromarray(img[..., 0]).save(os.path.join(out, "gray_37x53.jpg"))
    cv2.imwrite(os.path.join(out, "rst_48x64.jpg"), smooth(48, 64)[..., ::-1],
                [cv2.IMWRITE_JPEG_RST_INTERVAL, 4])
    for name, arr, kw in (
            ("cut_48x64.jpg",
             (np.random.RandomState(0).rand(48, 64, 3) * 255).astype(
                 np.uint8), {}),
            ("cut_q10_61x83.jpg", (rng.rand(61, 83, 3) * 255).astype(
                np.uint8), {"quality": 10})):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", **kw)
        data = buf.getvalue()
        with open(os.path.join(out, name), "wb") as f:
            f.write(data[:len(data) * 2 // 3])
        assert cv2.imread(os.path.join(out, name)) is not None


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def file_hashes(root: str) -> dict:
    """{relative path: sha256 of read_rgb_np (frames) / read_mask_np
    (masks)} of every image file under root."""
    from pvnet_tpu.data.linemod import read_mask_np, read_rgb_np
    out = {}
    for d, _, files in sorted(os.walk(root)):
        for name in sorted(files):
            p = os.path.join(d, name)
            rel = os.path.relpath(p, root)
            if name.endswith(".jpg") or name.startswith("color_"):
                a = read_rgb_np(p)
                out[rel] = {"sha256": sha256(a), "reader": "rgb",
                            "shape": list(a.shape)}
            elif name.endswith(".png"):
                a = read_mask_np(p)
                out[rel] = {"sha256": sha256(a), "reader": "mask",
                            "shape": list(a.shape)}
    return out


def record_fields(rec: dict) -> dict:
    out = {"rgb_pth": rec["rgb_pth"], "dpt_pth": rec["dpt_pth"],
           "rnd_typ": rec["rnd_typ"],
           "RT": np.asarray(rec["RT"], np.float64).tolist()}
    for k in KEYPOINTS:
        if k in rec:
            out[k] = np.asarray(rec[k], np.float64).tolist()
    if "K" in rec:
        out["K"] = np.asarray(rec["K"], np.float64).tolist()
    return out


def jax_sets(root: str):
    from pvnet_tpu.config import PathConfig
    from pvnet_tpu.data.linemod import (LineModImageDB,
                                        OcclusionLineModImageDB,
                                        TruncatedLineModImageDB)
    paths = PathConfig(data_dir=root)
    db = LineModImageDB(CLS, has_render_set=False, has_fuse_set=False,
                        paths=paths)
    odb = OcclusionLineModImageDB(CLS, paths=paths)
    tdb = TruncatedLineModImageDB(CLS, paths=paths)
    return paths, {
        "real": db.real_set,
        "test": db.test_real_set + db.val_real_set,
        "occluded": odb.test_real_set,
        "truncated": tdb.set}


def rates(paths, sets) -> dict:
    """JAX's --test_model rates of the duck checkpoint on each set, f32,
    tail_depth 0 with stratified selection, per RANSAC seed."""
    import jax
    import jax.numpy as jnp
    from flax import serialization
    from pvnet_tpu.config import LINEMOD_K, TrainConfig
    from pvnet_tpu.data.dataset import (ImageSizeBatchSampler, PoseDataset,
                                        Prefetcher)
    from pvnet_tpu.eval.evaluator import Evaluator
    from pvnet_tpu.ops import voting as JV
    from pvnet_tpu.train.loop import TrainLoop

    orig = JV.sample_foreground
    JV.sample_foreground = lambda *a, **k: orig(
        *a, **dict(k, method="stratified"))
    cfg = TrainConfig.from_json(RECIPE)
    cfg.bf16 = False
    loop = TrainLoop(cfg, CLS, paths=paths, use_mesh=False)
    with open(CKPT, "rb") as f:
        variables = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            serialization.msgpack_restore(f.read()))
    meta = loop.object_meta()
    out = {}
    for name, prefix, own_k in (("test", paths.linemod_dir, False),
                                ("occluded", paths.occlusion_linemod_dir,
                                 False),
                                ("truncated", paths.linemod_dir, True)):
        ds = PoseDataset(sets[name], prefix, cfg.vote_type, augment=False,
                         aug_cfg=cfg.aug_cfg, use_intrinsic=own_k)
        batches = list(Prefetcher(ds, ImageSizeBatchSampler(
            range(len(ds)), cfg.test_batch_size, aug_cfg=cfg.aug_cfg,
            shuffle=False), num_threads=1))
        runs = []
        for seed in SEEDS:
            ev = Evaluator(meta)
            key = jax.random.PRNGKey(seed)
            for bidx, batch in enumerate(batches):
                b, h, w = batch["mask"].shape
                fwd = loop.eval_pipeline((h, w), b, False,
                                         tail_depth=TAIL_DEPTH)
                key = jax.random.fold_in(key, bidx)
                Ks = (np.asarray(batch["K"], np.float32) if own_k
                      else np.broadcast_to(LINEMOD_K, (b, 3, 3)))
                kps = np.asarray(fwd(variables, jnp.asarray(batch["image"]),
                                     key))
                ev.evaluate_batch(kps, batch["pose"], Ks)
            proj, add, cm = ev.average_precision(verbose=False)
            runs.append({"seed": seed, "proj": float(proj),
                         "add": float(add), "cm": float(cm)})
            print(f"{name} seed {seed}: proj {proj:.4f} add {add:.4f} "
                  f"cm {cm:.4f}", flush=True)
        out[name] = {"images": len(sets[name]), "runs": runs}
    JV.sample_foreground = orig
    return out


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    if os.path.exists(OUT):
        shutil.rmtree(OUT)
    write_tree(OUT)
    write_cases(OUT)
    manifest = {"class": CLS, "files": file_hashes(OUT)}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "root")
        shutil.copytree(OUT, root)
        paths, sets = jax_sets(root)
        manifest["records"] = {k: [record_fields(r) for r in v]
                               for k, v in sets.items() if k != "real"}
        manifest["records"]["real"] = [record_fields(r)
                                       for r in sets["real"]]
        manifest["rates"] = rates(paths, sets)
    manifest["rates_setup"] = {
        "checkpoint": "assets/duck_ckpt.msgpack",
        "recipe": "configs/synthetic_train.json with bf16 false",
        "tail_depth": TAIL_DEPTH, "select": "stratified",
        "seeds": list(SEEDS),
        "key": "fold_in(PRNGKey(seed), batch), folded cumulatively"}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, fs in os.walk(OUT) for n in fs)
    print(f"wrote {OUT}: {len(manifest['files'])} image files, "
          f"{total / 1e6:.2f} MB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
