"""Voting-envelope sensitivity study on a trained checkpoint (port of
tools/envelope_study.py, the same flags plus ``--device``).

For each envelope n it evaluates the test list of a LINEMOD tree with
``VoteParams(hyp_num=n, max_num=n)`` through ``TrainLoop.validate`` and
prints one JSON row of its 2D-projection, ADD and 5cm5deg rates (the JAX
tool's keys), then the sweep again under a heading:

  python -m pvnet_tpu_torch.envelope_study --cfg_file \\
      configs/synthetic_train.json --data_dir data/synthetic_occ --cls duck \\
      --envelopes 128,256,512,1024,2048 --weights assets/duck_ckpt.msgpack

``--weights`` takes a flax msgpack checkpoint (assets/duck_ckpt.msgpack,
read by utils/flax_msgpack.py) or a port ``.pth``; without it the study
evaluates the latest training checkpoint of ``{data_dir}/model/{cls}_
{model_name}``. ``--unc_hyp_nums`` sweeps the covariance pass's
hypotheses instead (at the first envelope; implies ``--uncertainty``).
``--vote_impl`` names the JAX count implementation: 'xla' and 'pallas'
are the port's float32 count (kernel K3), 'bf16' its bf16 mode. The
network runs in the recipe's dtype on ``--device`` (the card by default);
``--quant`` builds the recipe's model with int8 backbone stages
(``--quant_stages``, ``--quant_mode``, ``--quant_decoder``; 'static'
calibrates on the first 2 test batches), ``--quant_tail`` the packed
tail's int8 branch with ``--tail_depth`` > 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# JAX's --vote_impl -> the port's count mode (ops/voting.count_inliers)
VOTE_IMPLS = {"xla": None, "pallas": None, "bf16": "bf16"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg_file", default="configs/synthetic_train.json")
    ap.add_argument("--data_dir", default="data/synthetic_occ")
    ap.add_argument("--cls", default="duck")
    ap.add_argument("--envelopes", default="128,256,512,1024",
                    help="comma list of hyp_num=max_num settings")
    ap.add_argument("--uncertainty", action="store_true",
                    help="evaluate through the uncertainty-PnP path "
                         "(covariance-weighted solver)")
    ap.add_argument("--unc_hyp_nums", default=None,
                    help="comma list of uncertainty_hyp_num values to "
                         "sweep (implies --uncertainty; hyp_num/max_num "
                         "stay at the first --envelopes entry)")
    ap.add_argument("--num_threads", type=int, default=4)
    ap.add_argument("--quant", action="store_true",
                    help="int8 backbone stages (ops/quant_conv.py)")
    ap.add_argument("--quant_stages", default="2,3",
                    help="comma list of backbone stages to quantize with "
                         "--quant (0,1,2,3 = whole backbone)")
    ap.add_argument("--quant_mode", default="dynamic",
                    choices=("dynamic", "static"),
                    help="activation-scale scheme with --quant; 'static' "
                         "calibrates scalar scales on the first 2 test "
                         "batches (TrainLoop.calibrate_quant)")
    ap.add_argument("--quant_decoder", action="store_true",
                    help="with --quant: int8 the decoder fc/8s convs too")
    ap.add_argument("--quant_tail", action="store_true",
                    help="with --quant and --tail_depth>0: int8 the "
                         "packed-tail stage convs")
    ap.add_argument("--tail_depth", type=int, default=0,
                    choices=(0, 1, 2, 3),
                    help="packed decoder tail depth (0 = plain)")
    ap.add_argument("--vote_impl", default=None, choices=sorted(VOTE_IMPLS),
                    help="the JAX count implementation's name: 'xla' and "
                         "'pallas' count in float32 (K3), 'bf16' in K3's "
                         "bf16 mode")
    ap.add_argument("--weights", default=None,
                    help="flax msgpack (e.g. assets/duck_ckpt.msgpack) or "
                         "port .pth weights instead of the training "
                         "checkpoint")
    ap.add_argument("--device", default=None,
                    help="cuda (the default where there is a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.config import PathConfig, TrainConfig
    from pvnet_tpu_torch.data.linemod import LineModImageDB
    from pvnet_tpu_torch.eval.evaluator import Evaluator
    from pvnet_tpu_torch.parallel.mesh import _local_device
    from pvnet_tpu_torch.train.checkpoint import load_net
    from pvnet_tpu_torch.train.loop import TrainLoop

    device = _local_device(args.device)
    cfg = TrainConfig.from_json(args.cfg_file)
    if args.quant:
        cfg.quant_stages = tuple(int(x) for x in args.quant_stages.split(","))
        cfg.quant_decoder = args.quant_decoder
        cfg.quant_mode = args.quant_mode
    if device.type == "cuda" and not cfg.bf16:
        # full float32 convolutions and matmuls, as the JAX reference
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    paths = PathConfig(data_dir=args.data_dir)
    name = f"{args.cls}_{cfg.model_name}"
    loop = TrainLoop(cfg, os.path.join(paths.model_dir, name),
                     record_dir=os.path.join(paths.record_dir, name),
                     device=device, use_mesh=False)
    state = loop.init_state(args.weights)
    if args.weights:
        epoch = 1
        print(f"weights from {args.weights}")
    else:
        state, epoch = load_net(state, loop.model_dir)
        if epoch == 0:
            print("no checkpoint — train first", file=sys.stderr)
            return 1
        print(f"checkpoint epoch {epoch - 1}")

    db = LineModImageDB(args.cls, has_render_set=False, has_fuse_set=False,
                        paths=paths, device=device)
    loader = loop.make_val_loader(db.test_real_set, paths.linemod_dir,
                                  args.num_threads)
    if args.quant and args.quant_mode == "static":
        loop.calibrate_quant(state, loader)
        print("calibrated static int8 scales on 2 test batches")

    uncertainty = args.uncertainty or args.unc_hyp_nums is not None
    if args.unc_hyp_nums is not None:
        base = int(args.envelopes.split(",")[0])
        sweeps = [(base, int(u)) for u in args.unc_hyp_nums.split(",")]
    else:
        sweeps = [(int(x), None) for x in args.envelopes.split(",")]
    meta = loop.linemod_object_meta(args.cls, paths)
    rows = []
    for n, unc_n in sweeps:
        kw = dict(hyp_num=n, max_num=n)
        if unc_n is not None:
            kw["uncertainty_hyp_num"] = unc_n
        tag = f"env{n}" if unc_n is None else f"env{n}u{unc_n}"
        res = loop.validate(state, loader, epoch, prefix=tag,
                            evaluate_pose=True,
                            evaluator=Evaluator(meta, device=device),
                            uncertainty=uncertainty,
                            vote_params=pl.VoteParams(**kw),
                            tail_depth=args.tail_depth,
                            tail_quant=args.quant and args.quant_tail,
                            vote_impl=VOTE_IMPLS.get(args.vote_impl))
        rows.append({
            "hyp_num": n, "max_num": n,
            **({"uncertainty_hyp_num": unc_n} if unc_n is not None
               else {}),
            **({"vote_impl": args.vote_impl} if args.vote_impl else {}),
            "uncertainty": uncertainty,
            "proj": round(res[f"{tag}/scalar/projection_error"], 4),
            "add": round(res[f"{tag}/scalar/add"], 4),
            "cm5deg5": round(res[f"{tag}/scalar/cm"], 4),
        })
        print(json.dumps(rows[-1]), flush=True)
    loop.recorder.close()

    print("\nenvelope sweep:")
    for r in rows:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
