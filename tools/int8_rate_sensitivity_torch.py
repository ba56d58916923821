#!/usr/bin/env python3
"""How far the 64-image rates of the port's int8 model move with RANSAC's
draws and with float32-ulp changes of the network, on one CUDA card.

  python3 tools/int8_rate_sensitivity_torch.py [--seeds 6] \
      [--out chiprun_out/int8_sensitivity.json]

On chip_smoke.py phase (h)'s 64 images (generated by the port and checked
against the JAX renders' hashes), float32 at tail_depth 3 and f32 counts,
as chip_smoke.py phase (i) evaluates them, for these networks:

  float     the float model (phase (h)'s);
  port      int8 stages 0-3, static scales calibrated by the port
            (TrainLoop.calibrate_quant on images 1228-1235; phase (i)'s);
  jax       the same int8 model with JAX's calibrated scales
            (assets/duck_eval_occ64_int8.json through
            utils.weights.quant_from_flax);
  jax+ulp   JAX's scales each moved one float32 ulp up,
  jax-ulp   and down: the same network up to which activations on a
            rounding boundary of their int8 grid take which code, the
            kind of difference two frameworks' float32 sums make.

Each is evaluated plain and with uncertainty, with TrainLoop.validate's
own draws (seed 0) and with chip_smoke.seeded_draws 1..N-1 (phase (i)
holds the mean over seeds 0-2). Prints every run's three counts, each
image's ADD pass changes between networks at the same draws, and JAX's
references (assets/duck_eval_occ64*.json); writes every run's per-image
ADD distances as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--out", default=os.path.join(
        REPO, "chiprun_out", "int8_sensitivity.json"))
    args = p.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.data.dataset import eval_batches
    from pvnet_tpu_torch.eval.evaluator import Evaluator
    from pvnet_tpu_torch.ops import quant_conv
    from pvnet_tpu_torch.utils.weights import quant_from_flax

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ref, split, _ = cs.eval_split()
    with open(cs.INT8_REFERENCE) as f:
        ref8 = json.load(f)
    jax_quant = {f"{k}/act_absmax": v
                 for k, v in ref8["quant"]["act_absmax"].items()}
    params = pl.VoteParams()
    thresh = 0.1 * float(split["diameter"])

    def networks():
        loop, state = cs.eval_loop(False, dev)
        yield "float", loop, state
        loop, state = cs.eval_loop(False, dev, quant_stages=cs.QUANT_STAGES,
                                   quant_mode="static")
        loop.calibrate_quant(state, eval_batches(
            split, loop.cfg.test_batch_size), num_batches=1)
        yield "port", loop, state
        quant_from_flax(state.model, jax_quant)
        yield "jax", loop, state
        for name, step in (("jax+ulp", np.inf), ("jax-ulp", -np.inf)):
            quant_from_flax(state.model, jax_quant)
            for m in quant_conv.quant_convs(state.model).values():
                m.act_absmax = torch.tensor(float(np.nextafter(
                    np.float32(m.act_absmax.item()), np.float32(step))),
                    dtype=torch.float32, device=dev)
            yield name, loop, state

    runs = {}
    t0 = time.time()
    for name, loop, state in networks():
        for unc in (False, True):
            mode = "uncertainty" if unc else "plain"
            for seed in range(args.seeds):
                ev = Evaluator(loop.object_meta(split), device=dev)
                loop.validate(
                    state, eval_batches(split, loop.cfg.test_batch_size), 0,
                    evaluate_pose=True, uncertainty=unc, tail_depth=3,
                    evaluator=ev,
                    draws=None if seed == 0 else cs.seeded_draws(
                        seed, dev, params, unc))
                n = len(ev.add_dists)
                runs[(name, mode, seed)] = {
                    "add_m": [float(x) for x in ev.add_dists],
                    "counts": [int(sum(r)) for r in (
                        ev.projection_2d_recorder, ev.add_recorder,
                        ev.cm_degree_5_recorder)]}
    secs = time.time() - t0

    names = ["float", "port", "jax", "jax+ulp", "jax-ulp"]
    print(f"\n{n} images, ADD threshold {thresh:.5f} m; counts proj/ADD/"
          f"5cm5deg out of {n}; seed 0 = TrainLoop.validate's own draws; "
          f"{len(runs)} evaluations in {secs:.1f} s")
    for mode in ("plain", "uncertainty"):
        for name in names:
            cs_ = [runs[(name, mode, s)]["counts"] for s in
                   range(args.seeds)]
            add = [c[1] for c in cs_]
            print(f"{mode:11s} {name:8s} ADD by seed {add} (range "
                  f"{min(add)}-{max(add)}, mean {np.mean(add):.2f}); proj "
                  f"{[c[0] for c in cs_]}; 5cm5deg {[c[2] for c in cs_]}")
        for src, key in (("float", "duck_eval_occ64.json"),
                         ("int8 static", "duck_eval_occ64_int8.json")):
            r = ref if src == "float" else ref8
            js = r["runs"][mode]
            print(f"{mode:11s} JAX {src} ({key}) seeds "
                  f"{[x['seed'] for x in js]}: ADD "
                  f"{[round(x['add'] * n) for x in js]}, proj "
                  f"{[round(x['proj'] * n) for x in js]}, 5cm5deg "
                  f"{[round(x['cm'] * n) for x in js]}")
        # pass changes between networks at the same draws
        for a, b in (("jax", "jax+ulp"), ("jax", "jax-ulp"),
                     ("jax", "port"), ("float", "jax"), ("float", "port")):
            flips, near = [], []
            for s in range(args.seeds):
                da = np.array(runs[(a, mode, s)]["add_m"])
                db = np.array(runs[(b, mode, s)]["add_m"])
                f = (da < thresh) != (db < thresh)
                flips.append(int(f.sum()))
                near.extend(np.minimum(np.abs(da[f] / thresh - 1),
                                       np.abs(db[f] / thresh - 1)).tolist())
                rel = np.abs(db - da) / np.maximum(da, 1e-9)
            print(f"{mode:11s} {a} -> {b}: ADD pass changes by seed {flips}"
                  f"; a changed image's nearer ADD distance lies within "
                  f"{max(near) if near else 0:.1%} of the threshold; "
                  f"median per-image ADD change (last seed) "
                  f"{np.median(rel):.2%}")
        # JAX float per image (seed 0 of the fixture) against ours
        ja = np.array(ref["runs"][mode][0]["per_image"]["add_m"])
        fa = np.array(runs[("float", mode, 0)]["add_m"])
        f = (ja < thresh) != (fa < thresh)
        print(f"{mode:11s} JAX float seed 0 -> port float seed 0: "
              f"{int(f.sum())} ADD pass changes (different draws)")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"threshold_m": thresh, "indices": ref["indices"],
                   "runs": [{"network": k[0], "mode": k[1], "seed": k[2],
                             **v} for k, v in runs.items()]}, f)
    print(f"wrote {os.path.relpath(args.out, REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
