"""Write assets/prepare_manifest.json: the JAX package's and PIL's outputs
of chip_smoke.py phase (n), dataset preparation, as sha256 digests, for
the GPU host, which has neither JAX nor PIL.

  JAX_PLATFORMS=cpu python tools/make_torch_prepare_fixture.py \
      [--out assets/prepare_manifest.json]

On a temporary copy of assets/linemod_mini, in phase (n)'s order (~30 s on
the CPU):

  (n1) PIL's JPEG of each of the 24 duck frames as the JAX reader decodes
       them (read_rgb_np), and of chip_smoke.encode_edge_images();
  (n2) tools/prepare.py --type truncated on chip_smoke.truncation_tree
       (the first 13 frames);
  (n3) tools/prepare.py --type render --linemod_cls duck --num 4;
  (n4) chip_smoke.occlusion_scene, then tools/prepare.py --type gen_mask,
       and tools/prepare.py --type fps --linemod_cls duck;
  (n5) generate_synthetic_linemod(<copy>/synthetic_occ, 'duck', 16,
       occluder_prob=0.5, max_clutter=2), the tree tools/train.py
       --synthetic writes with README's occluder settings.

Each tools/prepare.py call runs in a process of its own (JAX's
PoseTransformer caches translations by class name for a whole process,
ROADMAP D3). A digest is chip_smoke.file_digest's: a PNG's decoded pixels,
a pickle's arrays, any other file's bytes; no image is stored.
"""
from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as CS  # noqa: E402  (numpy-only helpers of phase (n))


def _prepare(root: str, *args: str) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "prepare.py"),
                    "--data_dir", root, *args], check=True, env=env,
                   cwd=REPO, stdout=subprocess.DEVNULL)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=CS.PREPARE_MANIFEST)
    args = p.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import PIL
    from PIL import Image
    from pvnet_tpu.data.linemod import read_mask_np, read_rgb_np
    from pvnet_tpu.data.synthetic import generate_synthetic_linemod

    def pil_jpeg(a):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG")
        return hashlib.sha256(buf.getvalue()).hexdigest()

    out = {"pil": PIL.__version__, "numpy": np.__version__}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        shutil.copytree(os.path.join(REPO, "assets", "linemod_mini"), root)
        frames = sorted(os.listdir(os.path.join(root, "LINEMOD", "duck",
                                                "JPEGImages")))
        out["encode"] = {
            "frames": {f: pil_jpeg(read_rgb_np(os.path.join(
                root, "LINEMOD", "duck", "JPEGImages", f))) for f in frames},
            "edges": {k: pil_jpeg(a)
                      for k, a in CS.encode_edge_images().items()}}
        trunc = os.path.join(tmp, "trunc")
        CS.truncation_tree(root, trunc)
        _prepare(trunc, "--type", "truncated")
        out["truncated"] = CS.tree_digests(trunc, "LINEMOD/truncated",
                                           read_mask_np)
        _prepare(root, "--type", "render", "--linemod_cls", "duck", "--num",
                 str(CS.N_RENDER))
        out["render"] = CS.tree_digests(root, "LINEMOD/renders",
                                        read_mask_np)
        CS.occlusion_scene(root)
        _prepare(root, "--type", "gen_mask")
        out["gen_mask"] = CS.tree_digests(root, "OCCLUSION_LINEMOD/masks_gen",
                                          read_mask_np)
        _prepare(root, "--type", "fps", "--linemod_cls", "duck")
        fps = os.path.join("LINEMOD", "duck", "farthest.txt")
        out["fps"] = {fps: CS.file_digest(os.path.join(root, fps))}
        synth = os.path.join(tmp, "synthetic_occ")
        occ, clutter = CS.N_SYNTH_OCC
        generate_synthetic_linemod(synth, "duck", num_images=CS.N_SYNTH,
                                   occluder_prob=occ, max_clutter=clutter)
        out["synthetic"] = CS.tree_digests(synth, "", read_mask_np)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    n = sum(len(v) for k, v in out.items() if isinstance(v, dict))
    print(f"wrote {args.out}: {n} digests "
          f"({', '.join(k for k, v in out.items() if isinstance(v, dict))})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
