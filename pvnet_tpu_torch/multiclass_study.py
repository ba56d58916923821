"""Multi-class training and evaluation study: fuse-style composites,
multi-class voting, one evaluator per class, ADD-S for the symmetric one.
The port of tools/multiclass_study.py.

Three object classes (duck, asymmetric; box, symmetric under a 90-degree
turn and scored with ADD-S; cylinder, with a painted stripe) are posed
into every frame with class-labelled masks (data/multiclass.py). A
resnet18_8s with seg_dim = classes + 1 trains in bf16 on the shared
multi-class vertex field (data/vertex.compute_vertex_targets_multiclass)
without augmentation, then each test frame is voted through
ops/voting.ransac_voting_multiclass (hyp_num 512, max_num 512; K1 and K3
once per class) and posed by PnP, one Evaluator per class.

  python -m pvnet_tpu_torch.multiclass_study --train_images 192 --epochs 60
  python -m pvnet_tpu_torch.multiclass_study --quick --device cpu   # smoke

Prints one JSON row per class (proj / ADD(-S) / 5cm5deg) and the
segmentation accuracy, and writes ``metrics.json`` (the JAX study's keys,
plus each epoch's last loss, the seconds of each part and the kernels'
launches) and the weights as ``params.pth`` ({net, optim, epoch}, which
utils/weights.load_weights reads) to ``--out_dir``. The splits, the
minibatch order and the learning-rate schedule are the JAX study's; the
weights' initial draw and the voting's random draws are the port's own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch import pipeline as pl
from pvnet_tpu_torch.config import LINEMOD_K, TrainConfig
from pvnet_tpu_torch.data.multiclass import (build_class_set, class_meta,
                                             generate_split)
from pvnet_tpu_torch.eval.evaluator import Evaluator
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.models.resnet import init_weights
from pvnet_tpu_torch.ops import voting
from pvnet_tpu_torch.ops.kernel_lib import launch_counts
from pvnet_tpu_torch.train import trainer

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HYP_NUM = MAX_NUM = 512


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train_images", type=int, default=192)
    ap.add_argument("--test_images", type=int, default=64)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out_dir",
                    default=os.path.join(_REPO, "data", "multiclass_study"))
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes (smoke; metrics meaningless)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.quick:
        args.train_images, args.test_images = 8, 4
        args.height, args.width = 120, 160
        args.epochs, args.batch = 2, 4
    return args


def study_K(h: int, w: int) -> np.ndarray:
    """LINEMOD_K scaled from 480x640 to h x w."""
    K = LINEMOD_K.copy()
    K[0] *= w / 640.0
    K[1] *= h / 480.0
    return K


def study_step(state: trainer.TrainState, data: Dict[str, torch.Tensor],
               idx: torch.Tensor, bf16: bool,
               vertex_loss_ratio: float = 1.0) -> Dict[str, torch.Tensor]:
    """One step of the study: the minibatch ``idx`` gathered from the set
    held on the device (image [n, h, w, 3] uint8, mask [n, h, w], hcoords
    [n, C, k, 3]), ImageNet-normalized, vertex weights mask > 0 (in
    trainer.batch_loss), no augmentation."""
    batch = {"image": pl.normalize_images(data["image"][idx])
             .permute(0, 3, 1, 2).contiguous(),
             "mask": data["mask"][idx].to(torch.int32),
             "hcoords": data["hcoords"][idx]}
    return trainer.train_step(state, batch,
                              vertex_loss_ratio=vertex_loss_ratio, bf16=bf16)


@torch.no_grad()
def eval_forward(model: torch.nn.Module, images_u8: torch.Tensor,
                 class_num: int, bf16: bool,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 pair_u: Optional[torch.Tensor] = None,
                 select_method: str = "stratified"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 [b, h, w, 3] -> (labels [b, h, w], keypoints [b, C, vn, 2]):
    the FCN (bf16 autocast when asked), the argmax labels and multi-class
    voting with the study's hyp_num and max_num. ``noise``/``pair_u`` are
    per-class draws (voting.ransac_voting_multiclass), else drawn from
    ``generator``."""
    model.eval()
    x = pl.normalize_images(images_u8)
    with torch.autocast(x.device.type, dtype=torch.bfloat16, enabled=bf16):
        labels, vertex = pl.predict_fields(model, x)
    kps = voting.ransac_voting_multiclass(
        labels, vertex, class_num, hyp_num=HYP_NUM, max_num=MAX_NUM,
        noise=noise, pair_u=pair_u, generator=generator,
        select_method=select_method)
    return labels, kps


def run(args) -> dict:
    """The study; returns metrics.json's contents."""
    device = torch.device(args.device)
    classes = build_class_set()
    metas = [class_meta(*c) for c in classes]
    C = len(classes)
    h, w = args.height, args.width
    K = study_K(h, w)

    print(f"generating {args.train_images}+{args.test_images} composite "
          f"frames ({h}x{w}, classes: "
          f"{[m.name + ('*' if m.symmetric else '') for m in metas]}; "
          "* = symmetric, scored with ADD-S) ...", flush=True)
    t0 = time.time()
    tr_img, tr_mask, tr_hc, _ = generate_split(
        classes, metas, args.train_images, K, h, w, seed=0)
    te_img, te_mask, _, te_poses = generate_split(
        classes, metas, args.test_images, K, h, w, seed=1)
    generate_s = time.time() - t0

    vn = metas[0].points_3d.shape[0]
    cfg = TrainConfig(model_name="multiclass_study", lr=args.lr,
                      train_batch_size=args.batch)
    model = build_model("resnet18_8s", ver_dim=vn * 2, seg_dim=C + 1)
    init_weights(model, torch.Generator().manual_seed(0))
    state = trainer.create_train_state(model.to(device), cfg)
    data = {"image": torch.from_numpy(tr_img).to(device),
            "mask": torch.from_numpy(tr_mask).to(device),
            "hcoords": torch.from_numpy(tr_hc).to(device)}

    n = args.train_images
    steps_per_epoch = max(n // args.batch, 1)
    rng = np.random.RandomState(7)
    epoch_loss = []
    t0 = time.time()
    for epoch in range(args.epochs):
        trainer.set_learning_rate(state, trainer.lr_for_epoch(cfg, epoch))
        perm = rng.permutation(n)
        for s in range(steps_per_epoch):
            idx = perm[s * args.batch:(s + 1) * args.batch][:args.batch]
            if idx.shape[0] < args.batch:
                break
            metrics = study_step(state, data,
                                 torch.from_numpy(idx).to(device), bf16=True,
                                 vertex_loss_ratio=cfg.vertex_loss_ratio)
        epoch_loss.append(float(metrics["loss"]))
        if epoch % 10 == 0 or epoch == args.epochs - 1:
            print(f"epoch {epoch}: loss {epoch_loss[-1]:.4f} "
                  f"(seg {float(metrics['seg_loss']):.4f} "
                  f"ver {float(metrics['ver_loss']):.4f}) "
                  f"[{time.time() - t0:.0f}s]", flush=True)
    train_s = time.time() - t0

    # ---- eval: multi-class voting + per-class evaluators ----
    t0 = time.time()
    evaluators = [Evaluator(m, device=device) for m in metas]
    gen = torch.Generator(device).manual_seed(999)
    eb = min(args.test_images, 16)
    accs = []
    for s0 in range(0, args.test_images, eb):
        sl = slice(s0, min(s0 + eb, args.test_images))
        labels, kps = eval_forward(state.model,
                                   torch.from_numpy(te_img[sl]).to(device),
                                   C + 1, bf16=True, generator=gen)
        accs.append(np.mean(labels.cpu().numpy() == te_mask[sl]))
        kps = kps.cpu().numpy()                            # [b, C, vn, 2]
        Ks = np.broadcast_to(K.astype(np.float32), (kps.shape[0], 3, 3))
        for c in range(C):
            evaluators[c].evaluate_batch(kps[:, c], te_poses[sl, c], Ks)
    rows = []
    for c, ev in enumerate(evaluators):
        proj, add, cm = ev.average_precision(verbose=False)
        rows.append({"class": metas[c].name,
                     "symmetric": metas[c].symmetric,
                     "metric": "ADD-S" if metas[c].symmetric else "ADD",
                     "proj": round(proj, 4), "add": round(add, 4),
                     "cm5deg5": round(cm, 4)})
    eval_s = time.time() - t0

    os.makedirs(args.out_dir, exist_ok=True)
    torch.save({"net": state.model.state_dict(),
                "optim": state.optimizer.state_dict(),
                "epoch": args.epochs - 1},
               os.path.join(args.out_dir, "params.pth"))
    return {"seg_accuracy": round(float(np.mean(accs)), 4),
            "train_images": args.train_images,
            "test_images": args.test_images,
            "epochs": args.epochs, "hw": [h, w], "rows": rows,
            "epoch_loss": epoch_loss, "generate_s": generate_s,
            "train_s": train_s, "eval_s": eval_s,
            "launches": launch_counts()}


def main(argv=None) -> int:
    args = parse_args(argv)
    summary = run(args)
    for r in summary["rows"]:
        print(json.dumps(r), flush=True)
    print(json.dumps({"seg_accuracy": summary["seg_accuracy"]}), flush=True)
    with open(os.path.join(args.out_dir, "metrics.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
