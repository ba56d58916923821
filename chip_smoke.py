#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (pvnet_tpu_torch) on one CUDA card.

  python3 chip_smoke.py

(``--parallel-worker OUT`` and ``--gloo-worker OUT`` are phase (q)'s ranks,
``--spatial-worker OUT`` and ``--spatial-gloo-worker OUT`` phase (r)'s,
started under torchrun by the script itself.)

Phases, each of which fails the run (non-zero exit) on any error:

(a) refuse to run without a CUDA device; print the card's name and power
    limit as nvidia-smi reports them;
(b) build the CUDA kernels from pvnet_tpu_torch/csrc with nvcc;
(c) hold each kernel against its plain PyTorch version on the card at the
    main path's shapes (K1: b=16, 480x640, C=18, a=16, bb=32; K3:
    hn=tn=512, vn=9, and the covariance pass's hn=1024; K2: the packed
    path's [16, 240, 320] score and [16, 240, 320, 80] field in float32
    and bfloat16, a=8, bb=16), K1 also at tn=1024 (a=32, bb=32), K1 and
    K2 also on a tie-heavy map (integer scores), K2 also at b=1 and b=64,
    and K3 also at tn=500, hn=37 and vn=1 with invalid slots; K3's bf16
    mode (count_inliers_bf16) against its plain bf16 version at the same
    shapes and at its own edges (forced pixel splits, hn=1, 513, 1025,
    70 000 pixels whose counts pass 16 bits), timed also at hn=1024:
    exact equality required (K1 and K2 bit for bit); time both
    with CUDA events, the timed launches queued behind a sleep kernel so
    that the events time the device: warm (the same inputs every launch,
    as the path finds them in the L2 cache) and cold (K1 and K2: the score
    rotated over copies that exceed the 50 MB L2; K3 and its bf16 mode:
    all inputs rotated); time an empty kernel the same way (the launch
    floor); at the voting variants' shapes, K3 at hn=4096 (vn=9, tn=1024),
    K3 at vn=1, tn=4096, hn=512 and K1 at tn=4096 (a=bb=64, C=2, 480 rows
    padded to 512), each exact and timed warm and cold;
(c') hold the row-shift kernels K4 (shift_lanes) and K5 (shift_sublanes)
    against their plain versions at the training path's shapes (K4: pass V
    [64, 640, 480] and pass H [64, 480, 640]; K5: [64, 480, 640]), float32
    and uint8, and K5 at [3, 53, 41], [2, 480, 130], [4, 1, 640] and
    [2, 2000, 41] in four dtypes: exact equality required; time kernel,
    plain version and torch.gather with a precomputed index (the library
    yardstick), K3's and K5's times beside those before their redesign;
(c'') the int8 convolution route (ops/quant_conv.conv_int8_acc: gathered
    taps through torch._int_mm) against its float64 plain version, int32
    accumulators equal exactly, at every distinct quantized convolution
    shape of the production preset at b=16, 480x640 (recorded from one
    forward of the int8 model through the packed tail's int8 branch),
    each timed beside cuDNN's bf16 and f32 convolution of the same shape;
(d) the serving path: load assets/duck_ckpt.msgpack with the port's
    reader, full float32 (no TF32), and answer 3 requests of 16 images (the
    fixture assets/duck_views_480x640.npz tiled, with per-image brightness
    jitter) through pvnet_tpu_torch.infer.infer_batch. Checks: finite poses
    of the right shape, K1's and K3's launch counts rose during those
    requests, the kernel path equals the plain path (on the CPU) given the
    same draws, and the well-visible fixture view is posed within 5 cm /
    5 deg. Prints per-stage milliseconds and the pose errors against ground
    truth;
(g) the packed serving path: 3 requests of 16 images through
    infer_batch(tail_depth=3) in float32, without and then with
    uncertainty. Checks: finite poses of the right shape; per variant K2
    launched exactly once per request, K1 never, K3 once per request (twice
    with uncertainty); view 0 within 5 cm / 5 deg; the packed field,
    unpacked, equals the plain forward's fields on the card (argmax on
    >= 99.9 % of pixels, values within 1e-3 of the field's max abs); from
    the same packed field, fgcnt and draws, the card path equals the CPU
    path in selection, hypotheses and counts (both passes), keypoints
    within 1e-2 px, poses (plain and uncertainty) within 0.05 deg / 1 mm.
    Prints request latency beside (d)'s and per-stage milliseconds;
(f) the training path: configs/synthetic_train.json (bf16, batch 16,
    Adam) from the duck checkpoint, the fixture's 2 views tiled to a
    device-resident uint8 set of 16, 3 warm-up and 10 timed steps of
    pvnet_tpu_torch.train.trainer.train_step_from_data at 480x640. Checks:
    a finite loss at every step; K4 launched exactly twice per timed step;
    with the same draws, the augmentation through K4 equals the
    augmentation through the plain shift bit for bit; one float32 step at
    b=2 (TF32 off) on the card within stated tolerances of the same step on
    the CPU (loss, gradients); a checkpoint the step saved loads through
    pvnet_tpu_torch.infer.load_model. Prints step ms, images/s, the
    augmentation's ms and share, and peak device memory;
(h) pose evaluation: generate the first 64 images that
    ``python -m pvnet_tpu_torch.train --test_model`` evaluates on README's
    synthetic occluded split (the test half of
    generate_synthetic_linemod(2048, occluder_prob=0.5, max_clutter=2,
    seed=0): images 1228-1291) with the port's generator, check them bit
    for bit against the hashes in assets/duck_eval_occ64.json (the JAX
    package's renders, tools/make_torch_eval_fixture.py), and evaluate
    assets/duck_ckpt.msgpack on them on the card through
    TrainLoop.validate + Evaluator: float32 at tail_depth 3 (the JAX
    reference's path) and 0 (the port's default), plain and with
    uncertainty, each rate within the stated tolerance of the JAX
    reference's (tolerance: the reference's spread over three RANSAC
    seeds, at least two images); the bf16 recipe's rates printed beside
    them. K1, K2 and K3 must launch during these evaluations. Two of the
    images evaluated on the card and on the CPU with the same draws, from
    the same fields (poses within (d)'s tolerances) and each with its own
    FCN (within the CPU tests' 1 deg / 15 mm), per-image errors within
    the tolerances that follow, and equal pass/fail except within 1e-3
    (relative) of a threshold. Prints the seconds of generation and evaluation and the
    evaluation's images/s;
(i) the production preset (tools/infer.py --cfg_file <recipe> --quant,
    bench.py's preset): configs/synthetic_train.json (bf16 FCN and tail),
    int8 stages 0-3 with static scales calibrated on a request's first 8
    images, tail_depth 3, bf16 counts (impl='bf16'); 3 + 3 requests of 16
    images through infer_batch without and with uncertainty. Checks:
    finite poses; per variant K2 once per request, K3's bf16 mode once
    (twice with uncertainty), K1 and K3's f32 mode never, the int8 route
    once per quantized convolution (19 per request); view 0 within 5 cm /
    5 deg; from the same packed field and draws the card path equals the
    CPU path as in (g). Prints latency and stage ms beside (g)'s and (d)'s.
    Then, on (h)'s 64 images, float32 with int8 static scales at
    tail_depth 3, plain and uncertainty, with the scales the port
    calibrates (TrainLoop.calibrate_quant on images 1228-1235) and with
    JAX's (utils.weights.quant_from_flax), each over three RANSAC seeds as
    the JAX reference: the mean of each rate over the seeds within the
    reference's range over its three seeds widened by two images
    (assets/duck_eval_occ64_int8.json); the bf16 preset's rates printed,
    and the largest relative difference between the port's calibrated
    scales and JAX's;
(j) the deployment path: the packed4 stem (the duck checkpoint, folded)
    against the conv7 model on 8 views at 480x640 in float32 (fields
    within rtol/atol 1e-4, equal selections), the stem convolution timed
    both ways; artifacts A (``python -m pvnet_tpu_torch.export
    --packed_stem --quant``: uint8 input, bf16, int8 stages 0-3 static,
    tail depth 3) and B (``--no-fused_tail --no-bf16 --uncertainty``)
    exported at b=8 by the CLI, both processes at once, loaded, their
    graphs holding exactly the expected pvnet_torch operators (A also the
    int8 route's torch._int_mm); one call each with its K1-K3 launches
    counted (A: K2 once, K3 once; B: K1 twice, K3 twice), the same seed
    twice identical, and against the direct estimate_poses with the
    program's weights and the same draws: every selection, hypothesis and
    count equal, keypoints within 1e-3 px, poses within 0.05 deg / 1 mm;
    then A served on 127.0.0.1 (pvnet_tpu_torch.serve): healthz, 3 lone
    requests, a JPEG body of view 0 at 360x480 (answered 200 with a
    finite pose: decoded and resized to 480x640 as PIL's BILINEAR resize,
    without PIL), 3 rounds of 8 concurrent .npy requests (fewer device
    calls than requests each round, view 0 within 5 cm / 5 deg), a bad
    payload answered 4xx. Prints export, load and call seconds, the artifacts' MB,
    and the served latencies beside the card's name and power limit;
(k) multi-object inference and the voting variants: 16 scenes of the
    duck, box and cylinder at 480x640 (data/multiclass.generate_split,
    LINEMOD_K, a fixed seed). (k1) make_multiclass_pose_pipeline on a
    stand-in model returning one-hot*10 logits and the ground-truth
    multi-class field: 3 requests, K1 and K3 exactly 3 launches each per
    request, every class with >= 400 visible pixels posed within 5 deg /
    2 cm; from these fields and the same draws the card equals the CPU in
    every class's selection, hypotheses and counts, keypoints within 1e-2
    px, poses within 0.05 deg / 1 mm. (k2) the real FCN (resnet18_8s,
    seg_dim=4, ver_dim=18, float32 without TF32, weights from a seeded
    generator), b=16: 3 requests with the same launch counts; from the
    card's fields and the same draws the card equals the CPU in every
    class's selection, hypotheses, counts and winner's inlier mask,
    keypoints within 1e-2 px where the refit's float32 estimate
    eps*cond(A)*|p| is at most 1e-3 px (A the normal matrix), poses within
    0.05 deg / 1 mm where those keypoints are held and PnP reprojects
    them within 1 px RMS (the rest printed with their inlier counts,
    determinants and conditions: a random network's fields make both
    ill-conditioned; (k1) holds every keypoint and pose); one request
    with impl='bf16' (K3's bf16 mode 3 times, equal to its plain bf16
    version); latency and stage ms (fcn; per class select, hypotheses +
    count, refine; one PnP over b*C beside C pnp_batch calls). (k3) on the
    duck fixture's ground-truth field (b=16): v2 (3 rounds), v4, v5,
    estimate_voting_distribution (hn=4096), generate_hypotheses_with_counts,
    center voting (tn=4096, vn=1, the centre's field), the vanishing point,
    motion voting (the offset field) and top-k selection, each on the card
    (its K1/K3 launches counted) and, with the same draws, on the CPU for
    the first 4 images: integers equal, points within 1e-2 px, covariances
    and variances within 1e-3 of their largest entry or 1e-4 px^2, v5's
    confidence (a count at 0.999 that last-bit differences of the refined
    points move) equal to the CPU's at the card's points; keypoints against
    the fixture's projections. (k4) 3 float32 multi-class train_steps at
    b=8 without augmentation (finite losses, targets from
    compute_vertex_targets_multiclass), and one at b=2 on the card against
    the CPU with (f)'s tolerances;
(l) the model family, training from the CLI and the study: (l1)
    resnet34_8s and resnet50_8s, their backbones from synthesized
    torchvision ImageNet checkpoints (utils/torchvision_manifest) loaded on
    the card through utils/weights.load_imagenet_backbone (every tensor
    equal to the file's), the heads seeded; forward ms in float32 (no TF32)
    and bf16 at b=16, 480x640; 3 plain requests of 16 images through
    infer_batch (K1 and K3 once each a request, counted), their latency
    and stage ms; on 2 images the FCN card vs CPU (argmax on >= 99.9 % of pixels,
    values within 1e-3 of their max abs) and (k2)'s rules from the card's
    fields (integers and inlier masks equal; keypoints and poses where
    well conditioned). (l2) ``python -m pvnet_tpu_torch.train --synthetic``
    in a process of its own: configs/synthetic_train.json with pose
    evaluation from epoch 0, 480x640, a 64-image split written as the JAX
    generator's LINEMOD tree and read back from its JPEGs (32 train, 6 val
    images), the backbone from a synthesized resnet18 checkpoint, 10
    epochs of 2 bf16 steps; its last line's launches (K4 twice a step, K1
    and K3 in the two pose evaluations) added in, finite losses; prints
    epoch seconds, step ms and generation seconds. (l3) the multi-class
    study at reduced depth (64 + 16 scenes, 10 epochs, 360x480) in this
    process: finite losses, the last epoch's below the first's, K1 and K3
    once per class in the evaluation; the per-class rates printed, not
    gated;
(m) LINEMOD from disk: assets/linemod_mini (a LINEMOD tree of 24 duck
    frames at 480x640, an Occlusion LINEMOD tree of 2 frames, 8 Truncation
    crops and cases/ at the decoder's edges; tools/make_torch_linemod_
    fixture.py) copied to a temporary directory (the databases write
    posedb/). (m1) every image file decoded on the card through
    data/image_io (the C entropy decoder and PNG unfilter, the CUDA pixel
    kernel) equal to the manifest's sha256 of the JAX readers' output;
    (m2) the C entropy decoder equal to the plain Python one on 2 frames,
    host ms a frame on one thread and frames/s on 8; (m3) the pixel kernel
    equal to its plain version on the 24 frames (b=24) and on random
    coefficients at 16 more geometries (extremes included), its launch
    plan's halo work, warm and cold ms at b=1, 8 and 24 beside the bound,
    plain ms, and one served JPEG request's decode split into host
    entropy decoding, upload, kernel and copy back; (m4) the port's
    LINEMOD, Occlusion and Truncation records against the JAX package's
    (RT to 1e-6, keypoints to 1e-4 px);
    (m5) ``python -m pvnet_tpu_torch.train --linemod_cls duck --init
    <duck checkpoint> --steps 6 --buckets 480x640`` in this process (the
    bf16 recipe, the 12 train frames repeated to a batch of 16): finite
    losses, K4 twice a step, the decode kernel launched; (m6)
    ``--test_model --occluded --truncated`` in float32 for RANSAC seeds 0,
    1 and 2: each set's three-seed mean of each rate within the JAX
    reference's range over its seeds widened by two images (the
    manifest), K1, K3 and one decode launch per JPEG;
(n) dataset preparation, on another copy of assets/linemod_mini, against
    assets/prepare_manifest.json (the sha256 of JAX's and PIL's outputs:
    JPEG and text bytes, PNG pixels, pickled arrays; written by
    tools/make_torch_prepare_fixture.py on the CPU): (n1) the C JPEG
    encoder (csrc/jpeg_encode.cu, host code) equal to its plain numpy
    version and to PIL's bytes on the 24 duck frames as decoded on the
    card and at 1x1, 17x3 and 37x53, its ms a frame on one host thread
    and frames/s on 8; (n2) ``python -m pvnet_tpu_torch.prepare --type
    truncated`` on the first 13 frames (frame 13 shows no duck), every
    crop, mask and info pickle equal to JAX's; (n3) ``--type render
    --linemod_cls duck --num 4`` equal to JAX's (16-bit depth PNGs), then
    ``python -m pvnet_tpu_torch.train --linemod_cls duck --steps 2`` (bf16,
    b=16) with those 4 render records in the train list: finite losses,
    K4 twice a step, the decode kernel launched; (n4) the seven other
    Occlusion LINEMOD classes made as moved copies of the duck, ``--type
    gen_mask`` (16 masks) and ``--type fps --linemod_cls duck`` equal to
    JAX's; (n5) data/synthetic.write_synthetic_linemod of 16 images with
    README's occluders (0.5, clutter 2) equal to JAX's tree, then ``train
    --test_model --synthetic`` on it (the tree found, not rewritten): its
    8 JPEG test frames decoded on the card, K1 and K3 launched, one decode
    launch a frame. Prints the encoder's ms a frame, the render and
    truncation seconds and (n3)'s step ms beside the card's name and
    power limit;
(o) the demo and visualization layer, the gather warps and the packed
    family, on assets/demo_mini (the duck's frame 0 of assets/linemod_mini
    under the names tools/demo.py reads; tools/make_torch_demo_fixture.py):
    (o1) ``python -m pvnet_tpu_torch.demo`` on the card with the GT field
    (K1 once, K3 once, the JPEG decoder once), then the same voting from
    the same fields and draws card vs CPU (selection, hypotheses and
    counts equal, keypoints within 1e-2 px, poses within 0.05 deg / 1 mm,
    corners within 1e-2 px), the pose error against GT printed and the
    written PNG decoded back equal to the drawing; (o2) the same with
    ``--checkpoint assets/duck_ckpt.msgpack`` in float32 (no TF32), the
    FCN also card vs CPU as in (l1); (o3) ``python -m
    pvnet_tpu_torch.visualize``: its six files, K1 and K3 three times
    each, and its calls (hypotheses with counts, v3, the covariance at hn
    4096, the uncertainty PnP) card vs CPU with the same draws (hypotheses
    and counts equal, points within 1e-2 px, covariances within 1e-3 of
    their largest entry or 1e-4 px^2, the pose within 0.05 deg / 1 mm);
    (o4) ``train --linemod_cls duck --test_model --save_inter_result`` on
    a copy of assets/linemod_mini: four files a batch, decoded back; (o5)
    a bf16 b=16 480x640 training step, then 2 timed ones, with the
    recipe's rotation widened to +-90 deg (the one-pass gather warps: K4
    never launched), and one f32 b=2 augmentation card vs CPU on the same
    draws (images within 1e-4 on all but 0.5 % of values, masks equal on
    >= 99 % of pixels, hcoords within rtol 1e-5); (o6) resnet34_8s and
    resnet50_8s with the packed4 stem (conv7 weights folded) and
    tail_depth 3, backbones from synthesized ImageNet checkpoints as in
    (l1): the packed field of 4 images against the plain forward ((g)'s
    tolerance), one 16-image request each (K2 once, K3 once) with its
    latency printed;
(p) the host-augmented training route (tools/train.py's default):
    (p1) every data/cv_ops call (the OpenCV arithmetic of the host
    augmentation: warps, resizes, blurs, colour conversions, line
    filters) at 480x640 on the card equals its CPU result bit for bit;
    (p2) a synthetic JPEG tree of 256 images written, and 8 samples of
    PoseDataset(augment=True) over it (configs/linemod_train.json's
    augmentation, frames decoded by jpeg_pixels) card vs CPU: the
    collated batches equal bit for bit, the draws the same; (p3) ``python
    -m pvnet_tpu_torch.train --synthetic`` with no route flag (the default
    recipe: resnet18_8s, bf16, b=32) for 2 epochs of 4 steps at 480x640:
    the route, step ms and the loader's wait a batch of the second epoch,
    K4 never launched, the decoder once a sample; the ms a sample through
    the dataset on the card (and of it the decode), and the device's idle
    share over one profiled host-augmented epoch; (p4) the same with
    ``--device_aug``: step ms, wait, K4 twice a step;
(q) data parallelism over torch.distributed, each part in processes of
    its own under ``python -m torch.distributed.run``: (q1) one rank, a
    world-size-1 NCCL group on the card: make_sharded_pose_pipeline on 3
    requests of 16 images, plain (tail_depth 0: K1, K3) and packed (3: K2,
    K3), f32, each equal to the unsharded pipeline's poses and keypoints
    with the same draws, K1 / K2 / K3 once a request; 3 sharded bf16
    --device_aug steps at b=16, 480x640 (synchronized BatchNorm,
    DistributedDataParallel), each from the state of an unsharded twin
    that takes the same step with the same draws: K4 twice a step, the
    loss within 1 %, the running statistics within 1 % of each tensor's
    largest value, the gradients within 10 % (bf16); (q2) ``python -m
    pvnet_tpu_torch.train`` under torchrun (NCCL, the fixture route, 2
    steps): K4 4 times, its rank-0 checkpoint without a ``module.``
    prefix loaded through infer.load_model; (q3) two gloo ranks sharing
    the card (CUDA tensors through gloo): one f32 step of the global batch
    of 16, 8 rows a rank, against one process on the whole batch (loss
    within 1e-4, statistics within 1e-4, gradients within 1e-2). Prints the
    sharded requests' latency beside the unsharded ones' and each part's
    seconds, with the card's name and power limit. One card shows no
    scaling, and none is measured;
(r) spatial partitioning (parallel/spatial.py), each part in processes
    of its own under ``python -m torch.distributed.run``, requests of 4
    images at 480x640 through make_spatial_pose_pipeline, f32 without
    TF32, each draw from a generator seeded alike on every rank: (r1) a
    world-size-1 NCCL group (a 1x1 mesh): 3 requests and one with
    uncertainty, each equal to the unsharded pipeline bit for bit; (r2)
    4 gloo ranks sharing the card, sp=4 (120 rows a rank): the same
    requests and one under bf16 autocast; (r3) the same ranks as a 2x2
    data x sp mesh, one request. Each rank launches K1 and K3 once a
    request (twice with uncertainty). In (r2) and (r3) the fields
    gathered from the ranks' slabs equal the unsharded forward's (masks
    but for pixels whose unsharded logits tie within 1e-4, vertex within
    1e-4 of its largest value; bf16: masks on >= 99.5 % of the pixels,
    vertex within 5 % of its largest value), the poses and keypoints
    equal the unsharded voting and PnP on those fields with the same
    draws bit for bit, and the unsharded pipeline's (its own fields)
    within the CPU tests' own-FCN pose tolerance. (r4) ``python -m pvnet_tpu_torch.envelope_study`` for 2
    envelopes on the first 16 of (h)'s images written as a LINEMOD tree,
    its rows printed beside the JAX reference's, a record. Prints each
    part's latency beside the unsharded one's and the near-tie counts;
(e) print the int8 route's JSON line and the kernels' (K1, K2, K3 and its
    bf16 mode with their cold times and (c)'s times at the variants'
    shapes; launches summed over the phases that drive their paths, (j)'s
    programs and server, (k), (l) and (m) included; the JPEG decoder's
    pixel kernel from (m); (n)'s, (o)'s, (p)'s, (q)'s and (r)'s launches
    added to each),
    then,
    as the last line,
    {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T_START = time.time()
REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "assets", "duck_views_480x640.npz")
EVAL_REFERENCE = os.path.join(REPO, "assets", "duck_eval_occ64.json")
INT8_REFERENCE = os.path.join(REPO, "assets", "duck_eval_occ64_int8.json")
RECIPE = os.path.join(REPO, "configs", "synthetic_train.json")
# the card's name and power limit, as nvidia-smi gives them (set by main)
SMI = None
QUANT_STAGES = (0, 1, 2, 3)
CKPT = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
BATCH, H, W, VN = 16, 480, 640, 9
N_REQUESTS = 3
WARMUP_STEPS, TIMED_STEPS = 3, 10
# H100 SXM peaks (NVIDIA data sheet; at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
# Instruction rate: 132 SMs x 4 schedulers x 32 lanes = 128 thread-
# instructions a cycle per SM at the ~1.98 GHz boost clock. The data
# sheet's 67 TFLOP/s float32 is this rate with an FMA counted as two
# operations; K3 is built with -fmad=false, so each multiply, add and
# compare is one instruction and this is its peak.
INSTR_PER_S = 132 * 128 * 1.98e9
# K3's instructions per (hypothesis, valid pixel, keypoint) pair: 13
# float32 multiplies and adds (dot 4, |h-c|^2 6, the two products 3), 2
# compares (d2 > eps; dot*|dot| > t2*d2*n2, which folds dot > 0 in) and
# one predicated count; the |n|^2 and valid tests are per pixel
K3_INSTR_PER_PAIR = 16
# K3's bf16 mode per (hypothesis, valid pixel, keypoint) pair: 11 bf16
# operations (dx, dy, two products and a sum for dot, two and one for d2,
# dot^2, t2*d2, *n2) and 3 compares; at the bf16x2 rate (two lanes an
# instruction) that is 2 * INSTR_PER_S operations a second
K3_BF16_OPS_PER_PAIR = 14
# H100 SXM dense int8 tensor-core peak (NVIDIA data sheet, 700 W)
INT8_OPS_PER_S = 1979e12
# device times at the main-path shapes before each kernel's Hopper
# redesign (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md's kernel table): K3
# (kernel, back to back), K5, K1, K2 (f32, bf16), K3's bf16 mode and the
# JPEG pixel kernel (24 frames and one at 480x640 4:2:0, warm)
BEFORE_MS = {"K3": 0.0832, "K3 back to back": 0.3455, "K5": 0.4453,
             "K1": 0.0383, "K2 f32": 0.0469, "K2 bf16": 0.0464,
             "K3 bf16": 0.1585, "jpeg_pixels b=24": 0.2195,
             "jpeg_pixels b=1": 0.0261}
# L2 cache of the H100: the cold timings rotate over inputs that exceed it
L2_BYTES = 50 * 2 ** 20
# device clock cycles of cuda_ms's head start: ~50 ms at the H100's clocks
SLEEP_CYCLES = 100_000_000


def cuda_ms(fn, iters: int = 50, head_start: bool = True) -> float:
    """Mean milliseconds of fn() on the current stream, after a warm-up,
    from CUDA events. With ``head_start`` the timed launches queue behind
    a sleep kernel of ~50 ms, so the events time the device's work: a
    kernel wrapper's Python and its launch cost tens of microseconds, as
    much as the smaller kernels, and back to back (head_start=False) the
    events time that host work instead. Work whose launches take the
    host longer than the head start to queue is still partly timed on the
    host's clock."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if head_start:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _nbytes(x) -> int:
    """Bytes of a tensor, or of the tensors of a (nested) tuple."""
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(t) for t in x)
    return x.numel() * x.element_size()


def cold_ms(fn, inputs) -> float:
    """cuda_ms of fn(x) with x rotated over ``inputs`` (tensors, or tuples
    of them), whose bytes together exceed the L2 cache, so that each launch
    reads its input from device memory."""
    import itertools
    nbytes = sum(_nbytes(x) for x in inputs)
    assert nbytes > L2_BYTES, nbytes
    it = itertools.cycle(inputs)
    return cuda_ms(lambda: fn(next(it)))


def same_selection(got, want, what: str) -> float:
    """K1's or K2's outputs equal the plain version's bit for bit; returns
    the max abs error (0.0)."""
    import torch
    torch.cuda.synchronize()
    err = 0.0
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.shape, y.shape)
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        assert torch.equal(x.view(bits.get(x.dtype, x.dtype)),
                           y.view(bits.get(y.dtype, y.dtype))), \
            f"{what} disagrees with its plain version"
        err = max(err, float((x.double() - y.double()).abs().max()))
    assert err == 0.0, f"{what}: max abs error {err}"
    return err


def request_images(views, request: int):
    """16 uint8 images: the fixture's views tiled, each with its own
    brightness offset in [-3, 3]."""
    import numpy as np
    rng = np.random.RandomState(1000 + request)
    idx = np.arange(BATCH) % len(views)
    jitter = rng.randint(-3, 4, (BATCH, 1, 1, 1))
    imgs = np.clip(views[idx].astype(np.int16) + jitter, 0, 255)
    return imgs.astype(np.uint8), idx


def check_kernels(dev, fixture):
    """Phase (c): each kernel against its plain version at main-path
    shapes. Returns the kernels' JSON entries (launches filled in later)."""
    import torch
    from pvnet_tpu_torch.ops import select_kernel, voting

    g = torch.Generator(device=dev).manual_seed(0)
    a, bb = voting._phase_grid(512)
    masks = torch.as_tensor(fixture["masks"], device=dev)
    mask = masks[torch.arange(BATCH, device=dev) % len(masks)]
    noise = torch.rand((BATCH, H, W), generator=g, device=dev)
    score = (mask != 0).float() * 2.0 + noise
    # a direction field pointing at random keypoints, with angular noise,
    # so that the inlier counts are those of a real vote
    kp = torch.rand((BATCH, VN, 2), generator=g, device=dev) \
        * torch.tensor([W, H], device=dev)
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    d = torch.stack([kp[..., 0, None, None] - xs, kp[..., 1, None, None] - ys],
                    dim=2)                                  # [b, vn, 2, h, w]
    d = d / d.norm(dim=2, keepdim=True).clamp(min=1e-3)
    field = (d + 0.05 * torch.randn(d.shape, generator=g, device=dev)
             ).reshape(BATCH, 2 * VN, H, W).contiguous()

    k1, k1_plain = (select_kernel.stratified_select_cmajor,
                    select_kernel.stratified_select_cmajor_plain)
    k1_err = same_selection(k1(score, field, a, bb),
                            k1_plain(score, field, a, bb), "K1")
    # also at tn=1024 (a=32, bb=32) and on a tie-heavy map (integer scores
    # 0, 1, 2: the first maximum in tile order must win)
    a2, bb2 = voting._phase_grid(1024)
    same_selection(k1(score, field, a2, bb2),
                   k1_plain(score, field, a2, bb2), "K1 at tn=1024")
    ties = torch.randint(0, 3, (BATCH, H, W), generator=g, device=dev).float()
    same_selection(k1(ties, field, a, bb), k1_plain(ties, field, a, bb),
                   "K1 on a tie-heavy map")
    k1_ms = cuda_ms(lambda: k1(score, field, a, bb))
    k1_b2b = cuda_ms(lambda: k1(score, field, a, bb), head_start=False)
    # the same mask with other noise: 5 score maps of 19.7 MB
    scores = [(mask != 0).float() * 2.0
              + torch.rand((BATCH, H, W), generator=g, device=dev)
              for _ in range(5)]
    k1_cold = cold_ms(lambda s: k1(s, field, a, bb), scores)
    del scores
    k1_plain_ms = cuda_ms(lambda: k1_plain(score, field, a, bb))
    floor_ms = cuda_ms(lambda: torch.cuda._sleep(0))
    print(f"launch floor (an empty kernel, timed the same way): "
          f"{floor_ms:.4f} ms", flush=True)
    print(f"K1 stratified_select_cmajor [b={BATCH}, C={2 * VN}, {H}x{W}, "
          f"a={a}, bb={bb}]: equal to plain (also at a={a2}, bb={bb2} and on "
          f"a tie-heavy map); kernel {k1_ms:.4f} ms warm (before the "
          f"redesign: {BEFORE_MS['K1']}), {k1_cold:.4f} ms cold, "
          f"{k1_b2b:.4f} ms back to back, without the head start; plain "
          f"{k1_plain_ms:.4f} ms", flush=True)

    # bound: K1 reads the score map once and the winners' field values,
    # and writes best, idx and dirs
    c = field.shape[1]
    k1_bytes = score.numel() * 4 + BATCH * a * bb * (c * 4 + 4 + 4 + c * 4)
    k1_bound = k1_bytes / HBM_BYTES_PER_S * 1e3
    print(f"K1 bound {k1_bound:.4f} ms ({k1_bytes / 1e6:.2f} MB at 3.35 "
          f"TB/s); no single PyTorch call computes it", flush=True)
    fg = voting.sample_foreground(mask, field, 512, noise=noise)
    k3 = check_k3(dev, g, fg)
    k3_bf16 = check_k3_bf16(dev, g, fg)
    k2 = check_k2(dev, g)
    k1 = {"name": "stratified_select_cmajor", "route": "cuda",
          "source": "pvnet_tpu_torch/csrc/stratified_select.cu",
          "replaces": "pvnet_tpu/ops/select_kernel.py:131",
          "launches": None, "max_abs_err": k1_err, "ms": k1_ms,
          "cold_ms": k1_cold, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
          "bound_by": "bytes", "library_ms": None}
    check_slice_shapes(dev, g, mask, field, k1, k3)
    return [k1, k3, k3_bf16, k2]


def check_slice_shapes(dev, g, mask, field, k1, k3):
    """Phase (c), the shapes the voting variants give K1 and K3: K3 at
    hn=4096 (vn=9, tn=1024: estimate_voting_distribution's one pass), K3
    at vn=1, tn=4096, hn=512 and K1 at tn=4096 (a=bb=64, C=2, the 480 rows
    padded to 512: ransac_voting_center's defaults). Each equal to its plain
    version exactly, timed warm and cold; the times go into the kernels'
    entries (``hn4096_ms``, ``vn1_tn4096_ms``, ``tn4096_ms`` and their
    cold times)."""
    import torch
    import torch.nn.functional as F
    from pvnet_tpu_torch.ops import select_kernel, voting

    def k3_exact(fg, hyps, what):
        got = voting.count_inliers(fg, hyps, 0.99)
        want = voting.count_inliers_plain(fg, hyps, 0.99)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"K3 {what} disagrees with plain"
        run = lambda a: voting.count_inliers(a[0], a[1], 0.99)  # noqa: E731
        warm = cuda_ms(lambda: run((fg, hyps)))
        cold = cold_ms(run, k3_copies(fg, hyps))
        plain = cuda_ms(lambda: voting.count_inliers_plain(fg, hyps, 0.99),
                        iters=5)
        pairs = int(fg.valid.sum()) * hyps.shape[1] * hyps.shape[2]
        bound = pairs * K3_INSTR_PER_PAIR / INSTR_PER_S * 1e3
        print(f"K3 {what}: equal to plain (max count {int(got.max())}); "
              f"kernel {warm:.4f} ms warm, {cold:.4f} ms cold; plain "
              f"{plain:.4f} ms; bound {bound:.4f} ms ({pairs / 1e6:.2f} M "
              f"pairs); {SMI}", flush=True)
        return warm, cold

    fg = voting.sample_foreground(mask, field, 1024, generator=g)
    hyps = voting.generate_hypotheses(fg, 4096, generator=g)
    k3["hn4096_ms"], k3["hn4096_cold_ms"] = k3_exact(
        fg, hyps, f"[b={BATCH}, hn=4096, vn={VN}, tn=1024]")
    center = field[:, :2].contiguous()                  # [b, 2, h, w]
    fg1 = voting.sample_foreground(mask, center, 4096, generator=g)
    assert int(fg1.count.min()) > 0
    hyps1 = voting.generate_hypotheses(fg1, 512, generator=g)
    k3["vn1_tn4096_ms"], k3["vn1_tn4096_cold_ms"] = k3_exact(
        fg1, hyps1, f"[b={BATCH}, hn=512, vn=1, tn=4096]")

    a, bb = voting._phase_grid(4096)
    pad = (-H) % a
    assert (a, bb, pad) == (64, 64, 32)
    scores = [F.pad((mask != 0).float() * 2.0
                    + torch.rand((BATCH, H, W), generator=g, device=dev),
                    (0, 0, 0, pad), value=-1.0) for _ in range(3)]
    fieldp = F.pad(center, (0, 0, 0, pad)).contiguous()  # [b, 2, 512, 640]
    k1f, k1p = (select_kernel.stratified_select_cmajor,
                select_kernel.stratified_select_cmajor_plain)
    same_selection(k1f(scores[0], fieldp, a, bb),
                   k1p(scores[0], fieldp, a, bb), "K1 at tn=4096")
    ms = cuda_ms(lambda: k1f(scores[0], fieldp, a, bb))
    cold = cold_ms(lambda s: k1f(s, fieldp, a, bb), scores)
    plain = cuda_ms(lambda: k1p(scores[0], fieldp, a, bb))
    nbytes = scores[0].numel() * 4 + BATCH * 4096 * (2 * 4 + 8 + 2 * 4)
    print(f"K1 [b={BATCH}, C=2, {H + pad}x{W} ({H} rows padded), a={a}, "
          f"bb={bb}]: equal to plain; kernel {ms:.4f} ms warm, {cold:.4f} "
          f"ms cold; plain {plain:.4f} ms; bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
          f"({nbytes / 1e6:.2f} MB); {SMI}", flush=True)
    k1["tn4096_ms"], k1["tn4096_cold_ms"] = ms, cold


def random_sample(dev, g, b, tn, vn):
    """A foreground sample of random rays with ~20 % invalid slots (not a
    prefix), as the GPU tests make them."""
    import torch
    from pvnet_tpu_torch.ops import voting
    coords = torch.rand((b, tn, 2), generator=g, device=dev) * 100
    dirs = torch.randn((b, tn, vn, 2), generator=g, device=dev)
    valid = torch.rand((b, tn), generator=g, device=dev) > 0.2
    dirs = dirs / dirs.norm(dim=-1, keepdim=True) * valid[..., None, None]
    count = valid.sum(1).to(torch.int32)
    return voting.ForegroundSample(coords, dirs, valid, count, count)


def check_k3(dev, g, fg):
    """K3 against its plain version, exactly: on the main path's sample
    (b=16, tn=512, vn=9, from a voting field) with hn=512 and with the
    covariance pass's hn=1024; on random samples with invalid slots at
    tn=500, hn=37 and vn=1. Times at the main-path shape: the kernel, back
    to back, without the pixel split (one block per group and hypothesis
    tile), and the plain version."""
    import torch
    from pvnet_tpu_torch.ops import kernel_lib, voting

    def exact(fg, hyps):
        got = voting.count_inliers(fg, hyps, 0.99)
        want = voting.count_inliers_plain(fg, hyps, 0.99)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == torch.int32
        assert got.shape == want.shape
        err = float((got - want).abs().max())
        assert err == 0.0, \
            f"K3 {tuple(hyps.shape)} disagrees with its plain version: {err}"
        return got, err

    hyps = voting.generate_hypotheses(fg, 512, generator=g)
    got, err = exact(fg, hyps)
    exact(fg, voting.generate_hypotheses(fg, 1024, generator=g))
    for b, tn, vn, hn in ((BATCH, 500, VN, 512), (BATCH, 512, VN, 37),
                          (4, 512, 1, 512)):
        hyp = torch.rand((b, hn, vn, 2), generator=g, device=dev) * 140 - 20
        exact(random_sample(dev, g, b, tn, vn), hyp)

    def run():
        return voting.count_inliers(fg, hyps, 0.99)
    ms, b2b = cuda_ms(run), cuda_ms(run, head_start=False)
    copies = k3_copies(fg, hyps)
    cold = cold_ms(lambda a: voting.count_inliers(a[0], a[1], 0.99), copies)
    del copies
    plain_ms = cuda_ms(lambda: voting.count_inliers_plain(fg, hyps, 0.99))
    lib, counts = kernel_lib.library(), torch.empty_like(got)
    assert all(t.is_contiguous() for t in (*fg[:3], hyps))
    nosplit_ms = cuda_ms(lambda: lib.pvnet_count_inliers(
        fg.coords.data_ptr(), fg.dirs.data_ptr(), fg.valid.data_ptr(),
        hyps.data_ptr(), counts.data_ptr(), BATCH, VN, 512, 512, 0.99 ** 2,
        512, torch.cuda.current_stream().cuda_stream))
    pairs = int(fg.valid.sum()) * 512 * VN
    nbytes = (fg.coords.numel() + fg.dirs.numel() + hyps.numel()
              + got.numel()) * 4 + fg.valid.numel()
    bound = max(pairs * K3_INSTR_PER_PAIR / INSTR_PER_S,
                nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"K3 count_inliers [b={BATCH}, hn=512, vn={VN}, tn=512] (max "
          f"count {int(got.max())}; also exact at hn=1024, tn=500, hn=37, "
          f"vn=1 with invalid slots): kernel {ms:.4f} ms (before the "
          f"redesign: {BEFORE_MS['K3']}), {cold:.4f} ms cold, back to back "
          f"{b2b:.4f} ms (before:"
          f" {BEFORE_MS['K3 back to back']}), without the pixel split "
          f"{nosplit_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{bound:.4f} ms ({pairs / 1e6:.2f} M pairs x "
          f"{K3_INSTR_PER_PAIR} instructions at "
          f"{INSTR_PER_S / 1e12:.1f} T/s); no single PyTorch call computes "
          f"it", flush=True)
    return {"name": "count_inliers", "route": "cuda",
            "source": "pvnet_tpu_torch/csrc/count_inliers.cu",
            "replaces": "pvnet_tpu/ops/voting.py:519",
            "launches": None, "max_abs_err": err, "ms": ms, "cold_ms": cold,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations", "library_ms": None}


def k3_copies(fg, hyps):
    """Copies of a K3 launch's inputs whose bytes together exceed the L2
    cache, for its cold time."""
    n = L2_BYTES // _nbytes((fg, hyps)) + 2
    return [(type(fg)(*(t.clone() for t in fg)), hyps.clone())
            for _ in range(n)]


def converging_sample(dev, g, tn):
    """One image, one keypoint: tn valid pixels whose rays all meet at one
    point, and 9 hypotheses around it (the first on it), so that counts
    pass 65 535."""
    import torch
    from pvnet_tpu_torch.ops import voting
    coords = torch.rand((1, tn, 2), generator=g, device=dev) * 300
    kp = torch.tensor([150.5, 149.25], device=dev)
    dirs = (kp - coords)[:, :, None, :]
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    valid = torch.ones((1, tn), dtype=torch.bool, device=dev)
    count = torch.full((1,), tn, dtype=torch.int32, device=dev)
    hyps = kp + torch.rand((1, 9, 1, 2), generator=g, device=dev) * 4 - 2
    hyps[0, 0, 0] = kp
    return voting.ForegroundSample(coords, dirs, valid, count, count), hyps


def check_k3_bf16(dev, g, fg):
    """K3's bf16 mode against its plain bf16 version, exactly: on the main
    path's sample with hn=512 and the covariance pass's hn=1024, on K3's
    edge shapes of phase (c) (random samples with invalid slots at tn=500,
    hn=37 and vn=1), at the bf16 kernel's own edges (pixels split across
    blocks at forced chunks, odd hn and hn past a block's hypotheses, and
    70 000 converging pixels whose counts pass 16 bits, split and in one
    block). Times warm, cold and back to back at the main-path shape, warm
    and cold at hn=1024, the C entry alone and the wrapper's centroid
    (both inside the times above), and the plain version."""
    import torch
    from pvnet_tpu_torch.ops import kernel_lib, voting

    lib = kernel_lib.library()
    t2, eps2 = (float(c) for c in voting._bf16_constants(0.99, "cpu"))

    def entry(fg, hyps, chunk, ctr, counts):
        """The C entry alone, with a forced pixel chunk (0: its own)."""
        b, hn, vn, _ = hyps.shape
        return lib.pvnet_count_inliers_bf16(
            fg.coords.data_ptr(), fg.dirs.data_ptr(), fg.valid.data_ptr(),
            hyps.data_ptr(), ctr.data_ptr(), counts.data_ptr(), b, vn,
            fg.coords.shape[1], hn, t2, eps2, chunk,
            torch.cuda.current_stream().cuda_stream)

    def exact(fg, hyps, chunk=0):
        if chunk:
            got = torch.full(hyps.shape[:3], -7, dtype=torch.int32,
                             device=dev)
            kernel_lib.check(entry(fg, hyps, chunk, voting._centroid(
                fg.coords, fg.valid), got), "pvnet_count_inliers_bf16")
        else:
            got = voting.count_inliers(fg, hyps, 0.99, impl="bf16")
        want = voting.count_inliers_plain_bf16(fg, hyps, 0.99)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype == torch.int32
        err = float((got - want).abs().max())
        assert err == 0.0 and torch.equal(got, want), \
            f"K3 bf16 {tuple(hyps.shape)} chunk {chunk} disagrees with " \
            f"its plain version"
        return got, err

    hyps = voting.generate_hypotheses(fg, 512, generator=g)
    got, err = exact(fg, hyps)
    hyps2 = voting.generate_hypotheses(fg, 1024, generator=g)
    exact(fg, hyps2)
    for chunk in (100, 129, 256):
        exact(fg, hyps, chunk)
    for b, tn, vn, hn in ((BATCH, 500, VN, 512), (BATCH, 512, VN, 37),
                          (4, 512, 1, 512), (BATCH, 512, VN, 1),
                          (BATCH, 512, VN, 513), (2, 512, VN, 1025)):
        hyp = torch.rand((b, hn, vn, 2), generator=g, device=dev) * 140 - 20
        exact(random_sample(dev, g, b, tn, vn), hyp)
    big, big_hyps = converging_sample(dev, g, 70000)
    big_counts, _ = exact(big, big_hyps)
    assert int(big_counts.max()) > 65535, int(big_counts.max())
    exact(big, big_hyps, 70000)
    f32 = voting.count_inliers(fg, hyps, 0.99)
    same = float((got == f32).float().mean())

    def run(h):
        return lambda: voting.count_inliers(fg, h, 0.99, impl="bf16")
    ms, ms2 = cuda_ms(run(hyps)), cuda_ms(run(hyps2))
    b2b = cuda_ms(run(hyps), head_start=False)
    colds = []
    for h in (hyps, hyps2):
        copies = k3_copies(fg, h)
        colds.append(cold_ms(lambda a: voting.count_inliers(
            a[0], a[1], 0.99, impl="bf16"), copies))
        del copies
    # the C entry alone, and the wrapper's centroid (its small kernels)
    counts, ctr = torch.empty_like(got), voting._centroid(fg.coords, fg.valid)
    assert all(t.is_contiguous() for t in (*fg[:3], hyps))
    kernel_ms = cuda_ms(lambda: entry(fg, hyps, 0, ctr, counts))
    assert torch.equal(counts, got)
    centroid_ms = cuda_ms(lambda: voting._centroid(fg.coords, fg.valid))
    plain_ms = cuda_ms(lambda: voting.count_inliers_plain_bf16(fg, hyps,
                                                               0.99))
    pairs = int(fg.valid.sum()) * 512 * VN
    nbytes = _nbytes((fg.coords, fg.dirs, fg.valid, hyps, got))
    bound = max(pairs * K3_BF16_OPS_PER_PAIR / (2 * INSTR_PER_S),
                nbytes / HBM_BYTES_PER_S) * 1e3
    print(f"K3 count_inliers bf16 mode [b={BATCH}, hn=512, vn={VN}, tn=512]"
          f" (equal to its plain version, also at hn=1024, tn=500, hn=37, "
          f"vn=1 with invalid slots, forced pixel chunks 100, 129, 256, "
          f"hn=1, 513, 1025, and at tn=70000 with counts up to "
          f"{int(big_counts.max())}; {same * 100:.2f} % of its counts equal "
          f"the f32 mode's): kernel {ms:.4f} ms warm (before the redesign: "
          f"{BEFORE_MS['K3 bf16']}), {colds[0]:.4f} ms cold, back to back "
          f"{b2b:.4f} ms; the C entry alone {kernel_ms:.4f} ms warm, the "
          f"wrapper's centroid {centroid_ms:.4f} ms; at hn=1024 {ms2:.4f} "
          f"ms warm, {colds[1]:.4f} ms cold; plain {plain_ms:.4f} ms; bound "
          f"{bound:.4f} ms "
          f"({pairs / 1e6:.2f} M pairs x {K3_BF16_OPS_PER_PAIR} bf16 "
          f"operations at {2 * INSTR_PER_S / 1e12:.1f} T/s, bf16x2); no "
          f"single PyTorch call computes it", flush=True)
    return {"name": "count_inliers_bf16", "route": "cuda",
            "source": "pvnet_tpu_torch/csrc/count_inliers.cu",
            "replaces": "pvnet_tpu/ops/voting.py:519",
            "computes": "pvnet_tpu/ops/voting.py:610",
            "launches": None, "max_abs_err": err, "ms": ms,
            "cold_ms": colds[0], "back_to_back_ms": b2b,
            "entry_ms": kernel_ms, "centroid_ms": centroid_ms,
            "hn1024_ms": ms2,
            "hn1024_cold_ms": colds[1], "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "operations", "library_ms": None}


def check_k2(dev, g):
    """K2 against its plain version at the packed path's shapes: score
    [16, 240, 320], an NHWC field [16, 240, 320, 80] in float32 and
    bfloat16, a=8, bb=16 (tn=512 pixels = 128 cells), and on a tie-heavy
    map; exact equality. Times warm and cold, and warm at b=1 and b=64."""
    import torch
    from pvnet_tpu_torch.ops import select_kernel, voting

    k2, k2_plain = (select_kernel.stratified_select,
                    select_kernel.stratified_select_plain)
    hp, wp, c = H // 2, W // 2, 4 * (2 + 2 * VN)
    a, bb = voting._phase_grid(512 // 4)

    def scores(b, n):
        return [((torch.rand((b, hp, wp), generator=g, device=dev) < 0.05)
                 .float() * 2.0
                 + torch.rand((b, hp, wp), generator=g, device=dev))
                for _ in range(n)]

    cold = scores(BATCH, 20)                    # 20 maps of 4.9 MB
    score = cold[0]
    ties = torch.randint(0, 3, (BATCH, hp, wp), generator=g,
                         device=dev).float()
    field32 = torch.randn((BATCH, hp, wp, c), generator=g, device=dev)
    err, times = 0.0, {}
    for field in (field32, field32.bfloat16()):
        dt = {torch.float32: "f32", torch.bfloat16: "bf16"}[field.dtype]
        err = max(err, same_selection(k2(score, field, a, bb),
                                      k2_plain(score, field, a, bb),
                                      f"K2 {dt}"))
        same_selection(k2(ties, field, a, bb), k2_plain(ties, field, a, bb),
                       f"K2 {dt} on a tie-heavy map")
        nbytes = (score.numel() * 4 + BATCH * a * bb * (4 + 4)
                  + 2 * BATCH * a * bb * c * field.element_size())
        times[dt] = (
            cuda_ms(lambda: k2(score, field, a, bb)),
            cold_ms(lambda s: k2(s, field, a, bb), cold),
            cuda_ms(lambda: k2(score, field, a, bb), head_start=False),
            cuda_ms(lambda: k2_plain(score, field, a, bb)),
            nbytes / HBM_BYTES_PER_S * 1e3, nbytes)
    del cold
    for dt, (ms, cold_t, b2b, plain_ms, bound, nbytes) in times.items():
        print(f"K2 stratified_select [b={BATCH}, {hp}x{wp}, C={c}, {dt}, "
              f"a={a}, bb={bb}]: equal to plain (also on a tie-heavy map); "
              f"kernel {ms:.4f} ms warm (before the redesign: "
              f"{BEFORE_MS['K2 ' + dt]}), "
              f"{cold_t:.4f} ms cold, {b2b:.4f} ms back to back; plain "
              f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({nbytes / 1e6:.2f} "
              f"MB: the score map, the winners' rows read and written, best "
              f"and idx, at 3.35 TB/s); no single PyTorch call computes it",
              flush=True)
    # how the time grows with the batch (float32, warm)
    by_batch = {}
    for b in (1, 64):
        s = scores(b, 1)[0]
        f = torch.randn((b, hp, wp, c), generator=g, device=dev)
        same_selection(k2(s, f, a, bb), k2_plain(s, f, a, bb), f"K2 b={b}")
        by_batch[b] = cuda_ms(lambda: k2(s, f, a, bb))
        del s, f
    print(f"K2 f32 warm by batch: b=1 {by_batch[1]:.4f} ms, b={BATCH} "
          f"{times['f32'][0]:.4f} ms, b=64 {by_batch[64]:.4f} ms (equal "
          f"to plain at each)", flush=True)
    ms, cold_t, _, plain_ms, bound, _ = times["f32"]
    return {"name": "stratified_select", "route": "cuda",
            "source": "pvnet_tpu_torch/csrc/stratified_select.cu",
            "replaces": "pvnet_tpu/ops/select_kernel.py:43",
            "launches": None, "max_abs_err": err, "ms": ms,
            "cold_ms": cold_t, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def check_row_shift(dev):
    """Phase (c'): K4 and K5 against their plain versions at the training
    path's shapes, float32 and uint8, exact; times of the kernel, the plain
    version and torch.gather with a precomputed int64 index."""
    import torch
    from pvnet_tpu_torch.ops import row_shift as RS

    g = torch.Generator(device=dev).manual_seed(3)
    planes = BATCH * 4
    cases = [("shift_lanes", RS.shift_lanes, RS.shift_lanes_plain, 2,
              (planes, W, H), "pass V"),
             ("shift_lanes", RS.shift_lanes, RS.shift_lanes_plain, 2,
              (planes, H, W), "pass H"),
             ("shift_sublanes", RS.shift_sublanes, RS.shift_sublanes_plain,
              1, (planes, H, W), "")]
    entries = {}
    for name, fn, plain, axis, shape, what in cases:
        n = shape[axis]
        s_shape = (shape[0], shape[1] if axis == 2 else shape[2])
        starts = torch.randint(-n, 2 * n, s_shape, generator=g, device=dev,
                               dtype=torch.int32)
        ar = torch.arange(n, device=dev)
        idx = torch.remainder(starts.long()[:, :, None] + ar if axis == 2
                              else starts.long()[:, None, :] + ar[:, None], n)
        for dtype in (torch.float32, torch.uint8):
            x = (torch.rand(shape, generator=g, device=dev) * 255).to(dtype)
            got, want = fn(x, starts), plain(x, starts)
            lib = torch.gather(x, axis, idx)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            assert err == 0.0 and torch.equal(got, want), \
                f"{name} {shape} {dtype} disagrees with its plain version"
            assert torch.equal(lib, want)
            if dtype != torch.float32:
                continue
            ms = cuda_ms(lambda: fn(x, starts))
            plain_ms = cuda_ms(lambda: plain(x, starts))
            lib_ms = cuda_ms(lambda: torch.gather(x, axis, idx))
            nbytes = x.numel() * 4 * 2 + starts.numel() * 4
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            before = ("" if axis == 2 else
                      f" (before the redesign: {BEFORE_MS['K5']})")
            print(f"{'K4' if axis == 2 else 'K5'} {name} {list(shape)} "
                  f"{what}: equal to plain (f32 and uint8); kernel "
                  f"{ms:.4f} ms{before}, plain {plain_ms:.4f} ms, torch.gather "
                  f"{lib_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB)", flush=True)
            if name not in entries:
                entries[name] = {
                    "name": name, "route": "cuda",
                    "source": "pvnet_tpu_torch/csrc/row_shift.cu",
                    "replaces": ("pvnet_tpu/ops/row_shift.py:68" if axis == 2
                                 else "pvnet_tpu/ops/row_shift.py:116"),
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": "bytes", "library_ms": lib_ms}
    # K5 where its strips can break: a ragged strip of four-byte columns,
    # one-byte columns with C % 4 != 0 (no word stores), H = 1, and
    # H = 2000, too tall for shared memory (the direct branch)
    for shape in ((3, 53, 41), (2, 480, 130), (4, 1, 640), (2, 2000, 41)):
        starts = torch.randint(-3 * shape[1], 3 * shape[1],
                               (shape[0], shape[2]), generator=g, device=dev,
                               dtype=torch.int32)
        for dtype in (torch.float32, torch.int32, torch.uint8, torch.int8):
            x = (torch.rand(shape, generator=g, device=dev) * 120).to(dtype)
            assert torch.equal(RS.shift_sublanes(x, starts),
                               RS.shift_sublanes_plain(x, starts)), \
                f"shift_sublanes {shape} {dtype} != its plain version"
    print("K5 shift_sublanes also equal to plain at [3, 53, 41], [2, 480, "
          "130], [4, 1, 640] and [2, 2000, 41] (the direct branch), float32, "
          "int32, uint8 and int8", flush=True)
    return [entries["shift_lanes"], entries["shift_sublanes"]]


def stage_ms(model, images_u8, pts, K, params, dev):
    """Per-stage milliseconds of one request, from CUDA events."""
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.ops import voting

    g = torch.Generator(device=dev).manual_seed(5)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    with torch.no_grad():
        x = torch.from_numpy(images_u8).to(dev)
        torch.cuda.synchronize()
        ev[0].record()
        mask, vertex = pl.predict_fields(model, pl.normalize_images(x))
        ev[1].record()
        fg = voting.sample_foreground(mask, vertex, params.max_num,
                                      generator=g)
        ev[2].record()
        hyps = voting.generate_hypotheses(fg, params.hyp_num, generator=g)
        counts = voting.count_inliers(fg, hyps, params.inlier_thresh)
        ev[3].record()
        kps = voting.vote_argmax_refine(fg, hyps, counts,
                                        params.inlier_thresh, params.min_num)
        ev[4].record()
        pl.poses_from_keypoints(pts, kps, K)
        ev[5].record()
        torch.cuda.synchronize()
    names = ("fcn", "select", "hypotheses+count", "refine", "pnp")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def check_poses(results, fixture):
    """Finite poses of the right shape, errors against ground truth by
    view, and the well-visible view 0 within 5 cm / 5 deg in at least
    half of its images."""
    import torch
    from pvnet_tpu_torch.ops.geometry import rotation_angle_deg

    rot_err, trans_err, views_of = [], [], []
    for est, idx in results:
        pose = est.pose.cpu()
        assert pose.shape == (BATCH, 3, 4) and est.kps.shape == (BATCH, VN, 2)
        assert torch.isfinite(pose).all() and torch.isfinite(est.kps).all()
        g_t = torch.as_tensor(fixture["poses"][idx])
        rot_err.append(rotation_angle_deg(pose[:, :, :3], g_t[:, :, :3]))
        trans_err.append((pose[:, :, 3] - g_t[:, :, 3]).norm(dim=-1))
        views_of.append(torch.as_tensor(idx))
    rot_err, trans_err = torch.cat(rot_err), torch.cat(trans_err)
    views_of = torch.cat(views_of)
    for v in range(len(fixture["images"])):
        sel = views_of == v
        print(f"view {v} ({int(fixture['masks'][v].sum())} visible px): "
              f"rotation error deg median {float(rot_err[sel].median()):.4f}"
              f" max {float(rot_err[sel].max()):.4f}; translation error m "
              f"median {float(trans_err[sel].median()):.5f} max "
              f"{float(trans_err[sel].max()):.5f}", flush=True)
    ok0 = ((rot_err < 5.0) & (trans_err < 0.05))[views_of == 0]
    assert ok0.float().mean() >= 0.5, \
        f"view 0 posed within 5 cm / 5 deg in only {int(ok0.sum())} of " \
        f"{len(ok0)} images"


def run_pipeline(dev, fixture, kernels):
    """Phase (d)."""
    import torch
    from pvnet_tpu_torch import infer, pipeline as pl
    from pvnet_tpu_torch.ops import pnp, select_kernel, voting
    from pvnet_tpu_torch.ops.geometry import rotation_angle_deg

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    model = infer.load_model(os.path.join(REPO, "assets",
                                          "duck_ckpt.msgpack"), VN, dev)
    print(f"loaded duck_ckpt.msgpack with the port's reader in "
          f"{time.time() - t0:.2f} s", flush=True)
    pts = torch.as_tensor(fixture["points_3d"], device=dev)
    K = torch.as_tensor(fixture["K"], device=dev)
    params = pl.VoteParams()
    gen = torch.Generator(device=dev).manual_seed(0)
    views = fixture["images"]

    # warm-up request (cuDNN autotuning, first launches), not counted
    infer.infer_batch(model, request_images(views, -1)[0], pts, K, params,
                      gen, tail_depth=0)
    torch.cuda.synchronize()

    select_kernel.stratified_select_cmajor.launches = 0
    select_kernel.stratified_select.launches = 0
    voting.count_inliers.launches = 0
    results, latencies = [], []
    for r in range(N_REQUESTS):
        imgs, idx = request_images(views, r)
        t0 = time.perf_counter()
        est = infer.infer_batch(model, imgs, pts, K, params, gen,
                                tail_depth=0)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        results.append((est, idx))
    launches = {"stratified_select_cmajor":
                select_kernel.stratified_select_cmajor.launches,
                "count_inliers": voting.count_inliers.launches}
    assert select_kernel.stratified_select.launches == 0
    print(f"{N_REQUESTS} requests of {BATCH} images at {H}x{W}: latency ms "
          f"{[round(x, 3) for x in latencies]}; kernel launches {launches}",
          flush=True)
    for k in kernels:
        if k["name"] in launches:
            k["launches"] = launches[k["name"]]

    check_poses(results, fixture)

    # the kernel path against the plain path, same fields and draws
    with torch.no_grad():
        imgs, _ = request_images(views, 0)
        mask, vertex = pl.predict_fields(model, pl.normalize_images(
            torch.from_numpy(imgs).to(dev)))
        noise = torch.rand((BATCH, H, W), generator=gen, device=dev)
        pair_u = torch.rand((BATCH, params.hyp_num, 2), generator=gen,
                            device=dev)
        outs = []
        for where in (dev, torch.device("cpu")):
            m, v = mask.to(where), vertex.to(where)
            fg = voting.sample_foreground(m, v, params.max_num,
                                          noise=noise.to(where))
            hyps = voting.generate_hypotheses(fg, params.hyp_num,
                                              pair_u=pair_u.to(where))
            counts = voting.count_inliers(fg, hyps, params.inlier_thresh)
            kps = voting.vote_argmax_refine(fg, hyps, counts,
                                            params.inlier_thresh,
                                            params.min_num)
            pose = pnp.pnp_batch(pts.to(where), kps, K.to(where))
            outs.append([t.cpu() for t in (*fg[:3], hyps, counts, kps,
                                           pose)])
    names = ("coords", "dirs", "valid", "hyps", "counts")
    for name, x, y in zip(names, outs[0], outs[1]):
        assert torch.equal(x, y), f"kernel path != plain path on {name}"
    kp_diff = float((outs[0][5] - outs[1][5]).abs().max())
    pose_gpu, pose_cpu = outs[0][6], outs[1][6]
    rot_diff = float(rotation_angle_deg(pose_gpu[:, :, :3],
                                        pose_cpu[:, :, :3]).max())
    t_diff = float((pose_gpu[:, :, 3] - pose_cpu[:, :, 3]).abs().max())
    print(f"kernel path vs plain path (CPU), same draws: selection, "
          f"hypotheses and counts equal; keypoints max diff {kp_diff:.3e} "
          f"px; poses max diff {rot_diff:.3e} deg, {t_diff:.3e} m",
          flush=True)
    # same winners; only the refine's and PnP's sums run in another order
    assert kp_diff < 1e-2 and rot_diff < 0.05 and t_diff < 1e-3

    stages = [stage_ms(model, request_images(views, r)[0], pts, K, params,
                       dev) for r in range(3)]
    med = {k: sorted(s[k] for s in stages)[1] for k in stages[0]}
    print(f"stage ms (median of 3 requests of {BATCH} images): "
          + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
          + f"; sum {sum(med.values()):.3f}", flush=True)
    return latencies, med


def packed_stage_ms(model, images_u8, pts, K, params, dev, uncertainty,
                    bf16=False, impl=None):
    """Per-stage milliseconds of one packed-path request (tail_depth 3,
    float32, or with bf16 the FCN under bfloat16 autocast and a bfloat16
    tail; ``impl`` the count's mode), from CUDA events."""
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.ops import packed_tail, voting

    g = torch.Generator(device=dev).manual_seed(6)
    names = ["fcn->8s", "packed tail", "select (K2)", "hypotheses+count",
             "refine"] + (["covariance"] if uncertainty else []) + ["pnp"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    with torch.no_grad():
        x = pl.normalize_images(torch.from_numpy(images_u8).to(dev))
        x = x.permute(0, 3, 1, 2).contiguous()
        torch.cuda.synchronize()
        ev[0].record()
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16):
            fm8, x4s, x2s = model(x, return_8s_features=True)
        ev[1].record()
        packed, fgcnt = packed_tail.packed_tail_deep3_from_model(
            model, fm8, x4s, x2s, x,
            dtype=torch.bfloat16 if bf16 else torch.float32)
        ev[2].record()
        fg = voting.sample_foreground_packed(packed, fgcnt, params.max_num,
                                             generator=g)
        ev[3].record()
        hyps = voting.generate_hypotheses(fg, params.hyp_num, generator=g)
        counts = voting.count_inliers(fg, hyps, params.inlier_thresh, impl)
        ev[4].record()
        kps = voting.vote_argmax_refine(fg, hyps, counts,
                                        params.inlier_thresh, params.min_num)
        ev[5].record()
        cov = None
        if uncertainty:
            _, cov = voting.estimate_voting_distribution_from_fg(
                fg, kps, params.uncertainty_hyp_num, params.inlier_thresh,
                generator=g, impl=impl)
            ev[6].record()
        pl.poses_from_keypoints(pts, kps, K, covar=cov)
        ev[-1].record()
        torch.cuda.synchronize()
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def run_packed(dev, fixture, kernels, plain_latencies):
    """Phase (g): the packed serving path, tail_depth 3 in float32, with
    and without uncertainty (see the module docstring)."""
    import torch
    from pvnet_tpu_torch import infer, pipeline as pl
    from pvnet_tpu_torch.ops import select_kernel, voting

    model = infer.load_model(os.path.join(REPO, "assets",
                                          "duck_ckpt.msgpack"), VN, dev)
    pts = torch.as_tensor(fixture["points_3d"], device=dev)
    K = torch.as_tensor(fixture["K"], device=dev)
    params = pl.VoteParams()
    gen = torch.Generator(device=dev).manual_seed(1)
    views = fixture["images"]
    counters = {"stratified_select": select_kernel.stratified_select,
                "stratified_select_cmajor":
                select_kernel.stratified_select_cmajor,
                "count_inliers": voting.count_inliers}
    k2_launches = 0
    for unc in (False, True):
        infer.infer_batch(model, request_images(views, -2)[0], pts, K,
                          params, gen, tail_depth=3, uncertainty=unc)
        torch.cuda.synchronize()                # warm-up, not counted
        for fn in counters.values():
            fn.launches = 0
        results, latencies = [], []
        for r in range(N_REQUESTS):
            imgs, idx = request_images(views, r)
            t0 = time.perf_counter()
            est = infer.infer_batch(model, imgs, pts, K, params, gen,
                                    tail_depth=3, uncertainty=unc)
            torch.cuda.synchronize()
            latencies.append((time.perf_counter() - t0) * 1e3)
            results.append((est, idx))
        launches = {k: fn.launches for k, fn in counters.items()}
        print(f"packed path (tail_depth 3, float32), uncertainty={unc}: "
              f"{N_REQUESTS} requests of {BATCH} images at {H}x{W}: latency"
              f" ms {[round(x, 3) for x in latencies]} (plain path, phase "
              f"(d): {[round(x, 3) for x in plain_latencies]}); kernel "
              f"launches {launches}", flush=True)
        assert launches == {"stratified_select": N_REQUESTS,
                            "stratified_select_cmajor": 0,
                            "count_inliers": N_REQUESTS * (1 + unc)}, \
            launches
        k2_launches += launches["stratified_select"]
        for est, _ in results:
            assert (est.fg_pixels > 0).all()
        check_poses(results, fixture)
    for k in kernels:
        if k["name"] == "stratified_select":
            k["launches"] = k2_launches

    # the packed field, unpacked, against the plain forward's fields
    imgs, _ = request_images(views, 0)
    packed, fgcnt = packed_against_plain(model, imgs, dev, "")

    # the card path against the CPU path from the same packed field,
    # fgcnt and draws
    packed_card_vs_cpu(packed, fgcnt, pts, K, params, gen, dev)

    meds = {}
    for unc in (False, True):
        stages = [packed_stage_ms(model, request_images(views, r)[0], pts, K,
                                  params, dev, unc) for r in range(3)]
        med = {k: sorted(s[k] for s in stages)[1] for k in stages[0]}
        print(f"packed path stage ms, uncertainty={unc} (median of 3 "
              f"requests of {BATCH} images): "
              + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
              + f"; sum {sum(med.values()):.3f}", flush=True)
        meds[unc] = med
    return meds


def packed_against_plain(model, imgs, dev, tag):
    """The depth-3 packed field of uint8 images [b, H, W, 3], unpacked,
    against the plain forward's fields on the card, float32: argmax equal
    on >= 99.9 % of pixels, values within 1e-3 of the field's max abs.
    Returns (packed, fgcnt)."""
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.ops import packed_tail

    b = imgs.shape[0]
    with torch.no_grad():
        x = pl.normalize_images(torch.from_numpy(imgs).to(dev))
        x = x.permute(0, 3, 1, 2).contiguous()
        packed, fgcnt = packed_tail.packed_tail_deep3_from_model(
            model, *model(x, return_8s_features=True), x,
            dtype=torch.float32)
        seg, ver = model(x)
        full = torch.cat([seg, ver], 1).permute(0, 2, 3, 1)
        hout = full.shape[-1]
        unpacked = packed.reshape(b, H // 2, W // 2, 2, 2, hout) \
            .permute(0, 1, 3, 2, 4, 5).reshape(b, H, W, hout)
        same = float((unpacked[..., :2].argmax(-1) == full[..., :2]
                      .argmax(-1)).float().mean())
        rel = float((unpacked - full).abs().max() / full.abs().max())
        del seg, ver, full, unpacked
    print(f"{tag}packed field unpacked vs the plain forward (card): argmax "
          f"equal on {same * 100:.4f} % of pixels; max abs difference "
          f"{rel:.3e} of the field's max abs", flush=True)
    assert same >= 0.999 and rel <= 1e-3
    return packed, fgcnt


def packed_card_vs_cpu(packed, fgcnt, pts, K, params, gen, dev, impl=None,
                       what="packed"):
    """From the same packed field, fgcnt and draws, the card path equals
    the CPU path in selection, hypotheses and counts (the voting's and the
    covariance pass's, in the count mode ``impl``), keypoints within
    1e-2 px, poses (plain and uncertainty) within 0.05 deg / 1 mm."""
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.ops import voting

    b = packed.shape[0]
    noise = torch.rand((b,) + tuple(packed.shape[1:3]), generator=gen,
                       device=dev)
    pair_u = torch.rand((b, params.hyp_num, 2), generator=gen, device=dev)
    cov_u = torch.rand((b, params.uncertainty_hyp_num, 2), generator=gen,
                       device=dev)
    outs = []
    with torch.no_grad():
        for where in (dev, torch.device("cpu")):
            fg = voting.sample_foreground_packed(
                packed.to(where), fgcnt.to(where), params.max_num,
                noise=noise.to(where))
            hyps = voting.generate_hypotheses(fg, params.hyp_num,
                                              pair_u=pair_u.to(where))
            counts = voting.count_inliers(fg, hyps, params.inlier_thresh,
                                          impl)
            kps = voting.vote_argmax_refine(fg, hyps, counts,
                                            params.inlier_thresh,
                                            params.min_num)
            cov_hyps = voting.generate_hypotheses(
                fg, params.uncertainty_hyp_num, pair_u=cov_u.to(where))
            cov_counts = voting.count_inliers(fg, cov_hyps,
                                              params.inlier_thresh, impl)
            _, cov = voting.estimate_voting_distribution_from_fg(
                fg, kps, params.uncertainty_hyp_num, params.inlier_thresh,
                pair_u=cov_u.to(where), impl=impl)
            p_w, K_w = pts.to(where), K.to(where)
            outs.append([t.cpu() for t in (
                *fg, hyps, counts, cov_hyps, cov_counts, kps,
                pl.poses_from_keypoints(p_w, kps, K_w),
                pl.poses_from_keypoints(p_w, kps, K_w, covar=cov))])
    names = ("coords", "dirs", "valid", "count", "total", "hyps", "counts",
             "covariance hyps", "covariance counts")
    for name, x, y in zip(names, outs[0], outs[1]):
        assert torch.equal(x, y), f"{what} card path != CPU path on {name}"
    kp_diff = float((outs[0][9] - outs[1][9]).abs().max())
    diffs = []
    for i in (10, 11):
        pg, pc = outs[0][i].double(), outs[1][i].double()
        # the geodesic angle from the chord |R1 - R2|_F: no arccos floor
        # (~0.02 deg) for float32 rotations a hair off orthonormal
        chord = (pg[:, :, :3] - pc[:, :, :3]).flatten(1).norm(dim=1)
        ang = torch.rad2deg(2 * torch.asin((chord / 8 ** 0.5).clamp(max=1)))
        diffs.append((float(ang.max()),
                      float((pg[:, :, 3] - pc[:, :, 3]).abs().max())))
    print(f"{what} card path vs CPU path, same field and draws"
          f"{'' if impl is None else ', ' + impl + ' counts'}: selection, "
          f"hypotheses and counts (both passes) equal; keypoints max diff "
          f"{kp_diff:.3e} px; poses max diff {diffs[0][0]:.3e} deg, "
          f"{diffs[0][1]:.3e} m; uncertainty poses {diffs[1][0]:.3e} deg, "
          f"{diffs[1][1]:.3e} m", flush=True)
    assert kp_diff < 1e-2
    assert all(r < 0.05 and t < 1e-3 for r, t in diffs), diffs


def run_training(dev, kernels):
    """Phase (f): the training path (see the module docstring)."""
    import tempfile

    import numpy as np
    import torch
    from pvnet_tpu_torch import infer
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.data import augment_device as AD
    from pvnet_tpu_torch.data.dataset import load_training_set
    from pvnet_tpu_torch.ops import row_shift as RS
    from pvnet_tpu_torch.train import trainer as TT
    from pvnet_tpu_torch.train.checkpoint import save_model
    from pvnet_tpu_torch.train.loop import TrainLoop

    cfg = TrainConfig.from_json(os.path.join(REPO, "configs",
                                             "synthetic_train.json"))
    assert cfg.bf16 and cfg.train_batch_size == BATCH
    ckpt = os.path.join(REPO, "assets", "duck_ckpt.msgpack")
    images, masks, hcoords = load_training_set(FIXTURE)
    tile = np.arange(BATCH) % len(images)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        loop = TrainLoop(cfg, os.path.join(tmp, "model"), device=dev,
                         buckets=[(H, W)])
        state = loop.init_state(init=ckpt)
        data = loop.build_device_dataset(images[tile], masks[tile],
                                         hcoords[tile])
        ids = torch.arange(BATCH, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step():
            return TT.train_step_from_data(
                state, data, ids, generator=gen, aug_cfg=cfg.aug_cfg,
                aug_hw=(H, W), bf16=cfg.bf16)

        for _ in range(WARMUP_STEPS):     # cuDNN autotuning, first launches
            assert torch.isfinite(step()["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        RS.shift_lanes.launches = 0
        RS.shift_sublanes.launches = 0
        step_ms, losses = [], []
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            met = step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
        launches = {"shift_lanes": RS.shift_lanes.launches,
                    "shift_sublanes": RS.shift_sublanes.launches}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        assert all(np.isfinite(losses)), losses
        assert launches["shift_lanes"] == 2 * TIMED_STEPS, launches
        for k in kernels:
            if k["name"] in launches:
                k["launches"] = launches[k["name"]]
        med = sorted(step_ms)[len(step_ms) // 2]
        print(f"{TIMED_STEPS} bf16 training steps, b={BATCH}, {H}x{W}: "
              f"step ms median {med:.3f} min {min(step_ms):.3f} max "
              f"{max(step_ms):.3f}; {BATCH / med * 1e3:.1f} images/s; "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; peak device "
              f"memory {peak_gb:.2f} GB; kernel launches {launches}",
              flush=True)

        # the augmentation alone, and through K4 vs the plain shift
        raw = {k: v[ids] for k, v in data.items()}
        draws = AD.sample_draws(BATCH, cfg.aug_cfg, gen, dev)
        aug_ms = cuda_ms(lambda: TT.apply_device_aug(
            raw, cfg.aug_cfg, (H, W), draws=draws), iters=10)
        got = TT.apply_device_aug(raw, cfg.aug_cfg, (H, W), draws=draws)
        kernel_fn = RS.shift_lanes
        RS.shift_lanes = RS.shift_lanes_plain
        try:
            want = TT.apply_device_aug(raw, cfg.aug_cfg, (H, W), draws=draws)
        finally:
            RS.shift_lanes = kernel_fn
        for k in ("image", "mask", "hcoords"):
            assert torch.equal(got[k], want[k]), \
                f"augmentation through K4 != through the plain shift: {k}"
        print(f"augmentation b={BATCH} {H}x{W}: {aug_ms:.3f} ms "
              f"({aug_ms / med * 100:.1f} % of the median step); through "
              f"K4 equal to through the plain shift (image, mask, hcoords)",
              flush=True)

        # a checkpoint of the step loads through the inference entry point
        path = save_model(state, 0, loop.model_dir)
        served = infer.load_model(path, VN, dev)
        for (name, a), b in zip(state.model.state_dict().items(),
                                served.state_dict().values()):
            assert torch.equal(a, b), f"checkpoint round trip changed {name}"
        print(f"checkpoint {os.path.basename(path)} loads through "
              f"infer.load_model, weights equal", flush=True)
        del state, served, data, raw, got, want
    torch.cuda.empty_cache()
    check_f32_step_against_cpu(dev, images, masks, hcoords, cfg, ckpt)


def check_f32_step_against_cpu(dev, images, masks, hcoords, cfg, ckpt):
    """One float32 step at b=2, 480x640, TF32 off, on the card and on the
    CPU from the same weights and draws. Tolerance: the two augmentations
    differ by an ulp of cos/sin here and there (a few pixels may flip), and
    the sums run in another order, so the loss within rtol 1e-3, each
    gradient within 3e-2 of its norm and all of them within 5e-3 (the
    tolerances tests/test_torch_train_step.py holds the port to against
    JAX on the CPU)."""
    import numpy as np
    import torch
    from pvnet_tpu_torch.data import augment_device as AD
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.train import trainer as TT
    from pvnet_tpu_torch.utils.weights import load_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    draws = AD.sample_draws(2, cfg.aug_cfg, torch.Generator().manual_seed(7),
                            "cpu")
    out = []
    for where in (dev, torch.device("cpu")):
        model = build_model("resnet18_8s", ver_dim=2 * VN)
        load_weights(model, ckpt)
        state = TT.create_train_state(model.to(where), cfg)
        data = {k: torch.from_numpy(v).to(where) for k, v in
                (("image", images), ("mask", masks), ("hcoords", hcoords))}
        t0 = time.perf_counter()
        met = TT.train_step_from_data(
            state, data, torch.arange(2, device=where),
            draws=AD.AugDraws(*(t.to(where) for t in draws)),
            aug_cfg=cfg.aug_cfg, aug_hw=(H, W), bf16=False)
        loss = float(met["loss"])
        secs = time.perf_counter() - t0
        out.append((loss, {n: p.grad.detach().double().cpu()
                           for n, p in model.named_parameters()}, secs))
    (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = out
    rel = {n: float((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm())
           for n in g_cpu}
    total = float(sum(((g_gpu[n] - g_cpu[n]) ** 2).sum() for n in g_cpu)
                  ** 0.5 / sum((g ** 2).sum() for g in g_cpu.values())
                  ** 0.5)
    worst = max(rel, key=rel.get)
    print(f"f32 step b=2 {H}x{W} (TF32 off), card vs CPU: loss {l_gpu:.7f} "
          f"vs {l_cpu:.7f}; gradients: worst tensor {worst} "
          f"{rel[worst]:.2e} of its norm, all {total:.2e} (card "
          f"{s_gpu:.2f} s, CPU {s_cpu:.2f} s)", flush=True)
    assert abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu)
    assert rel[worst] < 3e-2 and total < 5e-3


def rate_tolerance(ref) -> float:
    """Phase (h)'s tolerance on a rate: the largest spread (max - min) of
    any rate of the JAX reference over its RANSAC seeds, and never less
    than two images of the subset."""
    spread = max(max(r[m] for r in runs) - min(r[m] for r in runs)
                 for runs in ref["runs"].values()
                 for m in ("proj", "add", "cm"))
    return max(spread, 2.0 / len(ref["indices"]))


def eval_draws(b, params, uncertainty, tail_depth, dev):
    """One batch's draws for TrainLoop.eval_pipeline's fwd, from a CPU
    generator, on ``dev``."""
    import torch
    g = torch.Generator().manual_seed(7)
    hw = (H, W) if tail_depth == 0 else (H // 2, W // 2)
    d = {"noise": torch.rand((b,) + hw, generator=g),
         "pair_u": torch.rand((b, params.hyp_num, 2), generator=g)}
    if uncertainty:
        d["cov_pair_u"] = torch.rand((b, params.uncertainty_hyp_num, 2),
                                     generator=g)
        if tail_depth == 0:
            d["cov_noise"] = torch.rand((b, H, W), generator=g)
    return {k: v.to(dev) for k, v in d.items()}


def eval_loop(bf16, device, **recipe):
    """A TrainLoop of the synthetic recipe in the given dtype (and the
    recipe fields ``recipe``) on ``device`` and its state with the duck
    checkpoint's weights."""
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.train.loop import TrainLoop
    cfg = TrainConfig.from_json(RECIPE)
    cfg.bf16 = bf16
    for k, v in recipe.items():
        setattr(cfg, k, v)
    loop = TrainLoop(cfg, model_dir="", device=device)
    return loop, loop.init_state(CKPT)


def eval_split():
    """Phase (h)'s 64 images, generated by the port and checked against
    the JAX renders' hashes; (reference, split, seconds)."""
    import hashlib
    import numpy as np
    from pvnet_tpu_torch.data.synthetic import (evaluation_order,
                                                generate_synthetic_linemod)
    with open(EVAL_REFERENCE) as f:
        ref = json.load(f)
    sp = ref["split"]
    order = evaluation_order(sp["num_images"])[:len(ref["indices"])]
    assert order.tolist() == ref["indices"], "split arithmetic changed"
    workers = min(8, len(os.sched_getaffinity(0)))
    t0 = time.time()
    split = generate_synthetic_linemod(
        sp["num_images"], seed=sp["seed"], occluder_prob=sp["occluder_prob"],
        max_clutter=sp["max_clutter"], render=order, workers=workers)
    gen_s = time.time() - t0
    perm = np.searchsorted(split["index"], order)   # -> evaluation order
    for k in ("images", "masks", "poses", "index"):
        split[k] = split[k][perm]
    for k, want in ref["sha256"].items():
        got = hashlib.sha256(np.ascontiguousarray(split[k]).tobytes())
        assert got.hexdigest() == want, \
            f"generated {k} differ from the JAX package's renders"
    n = len(split["images"])
    print(f"generated images {order[0]}-{order[-1]} of the split (the first "
          f"{n} the test half evaluates) in {gen_s:.2f} s with {workers} "
          f"workers; images, masks and poses bit-equal to the JAX renders "
          f"(sha256); visible target px median "
          f"{int(np.median(split['masks'].reshape(n, -1).sum(1)))}",
          flush=True)
    return ref, split, gen_s


def eval_rates(dev, split, ref) -> float:
    """Phase (h)'s six evaluations on the card, the kernels' launches in
    them, and the float32 rates against the JAX reference; returns the
    evaluations' seconds."""
    import torch
    from pvnet_tpu_torch.data.dataset import eval_batches
    from pvnet_tpu_torch.eval.evaluator import Evaluator
    from pvnet_tpu_torch.ops import select_kernel, voting

    n = len(split["images"])
    tol = rate_tolerance(ref)
    for name in ("stratified_select_cmajor", "stratified_select"):
        getattr(select_kernel, name).launches = 0
    voting.count_inliers.launches = 0
    rates, eval_s = {}, 0.0
    for bf16, tail_depth in ((False, 3), (False, 0), (True, 0)):
        loop, state = eval_loop(bf16, dev)
        for unc in (False, True):
            ev = Evaluator(loop.object_meta(split), device=dev)
            torch.cuda.synchronize()
            t1 = time.time()
            loop.validate(state, eval_batches(split, loop.cfg.test_batch_size),
                          0, evaluate_pose=True, uncertainty=unc,
                          tail_depth=tail_depth, evaluator=ev)
            torch.cuda.synchronize()
            secs = time.time() - t1
            eval_s += secs
            key = (f"{'bf16' if bf16 else 'f32'} tail_depth {tail_depth} "
                   f"{'uncertainty' if unc else 'plain'}")
            rates[key] = ev.average_precision(verbose=False)
            print(f"(h) {key}: proj {rates[key][0]:.4f} add "
                  f"{rates[key][1]:.4f} 5cm5deg {rates[key][2]:.4f} "
                  f"({n} images in {secs:.2f} s, {n / secs:.1f} images/s)",
                  flush=True)
    launches = {"stratified_select_cmajor":
                select_kernel.stratified_select_cmajor.launches,
                "stratified_select": select_kernel.stratified_select.launches,
                "count_inliers": voting.count_inliers.launches}
    print(f"(h) kernel launches during the evaluations: {launches}",
          flush=True)
    assert all(v > 0 for v in launches.values()), launches

    for mode in ("plain", "uncertainty"):
        runs = ref["runs"][mode]
        jax_rates = [[r[m] for r in runs] for m in ("proj", "add", "cm")]
        print(f"(h) JAX reference {mode} (CPU, f32, tail_depth "
              f"{ref['tail_depth']}, seeds {[r['seed'] for r in runs]}): "
              f"proj {jax_rates[0]} add {jax_rates[1]} 5cm5deg "
              f"{jax_rates[2]}; README (full split, TPU, bf16, JPEG "
              f"inputs): {ref['readme'][mode]}; tolerance {tol:.4f}",
              flush=True)
        for td in (3, 0):
            got = rates[f"f32 tail_depth {td} {mode}"]
            for m, g, js in zip(("proj", "add", "cm"), got, jax_rates):
                assert min(js) - tol <= g <= max(js) + tol, \
                    f"f32 tail_depth {td} {mode} {m} {g} outside " \
                    f"[{min(js) - tol}, {max(js) + tol}]"
    return eval_s


def eval_card_vs_cpu(dev, split):
    """Two of phase (h)'s images evaluated on the card and on the CPU with
    the same draws (float32, the port's default tail_depth 0): from the
    same fields (the card's FCN), within (d)'s tolerances; and each side
    with its own FCN, within the tolerances of the CPU tests
    (tests/test_torch_pipeline.py: fields ~1e-6 apart move a boundary
    pixel, and with it the vote, by up to ~1 px)."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.data.dataset import eval_batches
    from pvnet_tpu_torch.eval import metrics as M
    from pvnet_tpu_torch.eval.evaluator import Evaluator
    from pvnet_tpu_torch.ops.geometry import rotation_angle_deg

    cpu = torch.device("cpu")
    sub = {k: split[k][:2] if k in ("images", "masks", "poses", "index")
           else split[k] for k in split}
    batch = next(eval_batches(sub, 2))
    params = pl.VoteParams()
    loops = {where: eval_loop(False, where) for where in (dev, cpu)}
    with torch.no_grad():
        model = loops[dev][1].model.eval()
        mask, vertex = pl.predict_fields(model, pl.normalize_images(
            torch.from_numpy(batch["image"]).to(dev)))

    def evaluate(where, unc, own_fcn):
        loop, state = loops[where]
        draws = eval_draws(2, params, unc, 0, where)
        if own_fcn:
            kp = loop.eval_pipeline((H, W), unc)(
                state.model, pl.normalize_images(
                    torch.from_numpy(batch["image"]).to(where)), **draws)
        elif unc:
            kp = pl.keypoints_with_covariance(
                mask.to(where), vertex.to(where), params, draws["noise"],
                draws["pair_u"], draws["cov_noise"], draws["cov_pair_u"])
        else:
            kp = pl.keypoints_from_fields(mask.to(where), vertex.to(where),
                                          params, draws["noise"],
                                          draws["pair_u"])
        ev = Evaluator(loop.object_meta(split), device=where)
        pose = (ev.evaluate_uncertainty_batch(*kp, batch["pose"], batch["K"])
                if unc else ev.evaluate_batch(kp, batch["pose"], batch["K"]))
        pp = torch.as_tensor(pose)
        trans_cm, rot_deg = M.cm_degree_errors(
            pp, torch.as_tensor(batch["pose"]))
        return pp, ev, trans_cm.numpy(), rot_deg.numpy()

    # (d)'s tolerances on poses from the same fields, 0.05 deg / 1 mm, and
    # what follows from them for the errors against ground truth: ADD by
    # the translation plus 0.05 deg over the object's 0.18 m, proj by
    # ~1.5 px for 1 mm at 0.4 m and f = 572 px; with each side's own FCN,
    # test_torch_pipeline.py's 1 deg / 15 mm and what follows from those
    bounds = {False: (0.05, 1e-3, 1.2e-3, 2.0), True: (1.0, 0.015, 0.018,
                                                       25.0)}
    for own_fcn in (False, True):
        for unc in (False, True):
            (pg_, eg, tg, rg), (pc_, ec, tc, rc) = (
                evaluate(where, unc, own_fcn) for where in (dev, cpu))
            rot_diff = float(rotation_angle_deg(pg_[:, :, :3],
                                                pc_[:, :, :3]).max())
            t_diff = float((pg_[:, :, 3] - pc_[:, :, 3]).norm(dim=-1).max())
            add_diff = float(np.abs(np.subtract(eg.add_dists,
                                                ec.add_dists)).max())
            proj_diff = float(np.abs(np.subtract(eg.proj_mean_diffs,
                                                 ec.proj_mean_diffs)).max())
            print(f"(h) 2 images card vs CPU, same draws, "
                  f"{'each its own FCN' if own_fcn else 'same fields'}, "
                  f"{'uncertainty' if unc else 'plain'}: poses max diff "
                  f"{rot_diff:.3e} deg, {t_diff:.3e} m; ADD {add_diff:.3e} "
                  f"m, proj {proj_diff:.3e} px, trans "
                  f"{float(np.abs(tg - tc).max()):.3e} cm, rot "
                  f"{float(np.abs(rg - rc).max()):.3e} deg; errors vs GT "
                  f"(card): ADD {np.round(eg.add_dists, 5).tolist()} m, "
                  f"proj {np.round(eg.proj_mean_diffs, 3).tolist()} px",
                  flush=True)
            rot_tol, t_tol, add_tol, proj_tol = bounds[own_fcn]
            assert rot_diff < rot_tol and t_diff < t_tol
            assert add_diff < add_tol and proj_diff < proj_tol
            assert np.abs(tg - tc).max() < 100 * t_tol
            assert np.abs(rg - rc).max() < rot_tol
            thresholds = ((eg.add_recorder, ec.add_recorder, eg.add_dists,
                           0.1 * float(split["diameter"])),
                          (eg.projection_2d_recorder,
                           ec.projection_2d_recorder, eg.proj_mean_diffs,
                           5.0),
                          (eg.cm_degree_5_recorder, ec.cm_degree_5_recorder,
                           None, None))
            for rec_g, rec_c, vals, thr in thresholds:
                for i, (a, b) in enumerate(zip(rec_g, rec_c)):
                    if a == b:
                        continue
                    near = (abs(vals[i] / thr - 1) < 1e-3 if thr else
                            abs(tg[i] / 5.0 - 1) < 1e-3
                            or abs(rg[i] / 5.0 - 1) < 1e-3)
                    assert near, f"card and CPU disagree on image {i}'s pass"


def run_evaluation(dev):
    """Phase (h)."""
    ref, split, gen_s = eval_split()
    eval_s = eval_rates(dev, split, ref)
    eval_card_vs_cpu(dev, split)
    n = len(split["images"])
    print(f"(h) generation {gen_s:.2f} s, evaluation {eval_s:.2f} s "
          f"({6 * n / eval_s:.1f} images/s over the six passes)",
          flush=True)
    return split


def check_int8_route(dev, fixture):
    """Phase (c''): the int8 convolution route (gathered taps through
    torch._int_mm) against its float64 plain version, int32 accumulators
    equal exactly, at every distinct quantized convolution shape of the
    preset at b=16, 480x640: recorded from one forward of the int8 model
    (stages 0-3) through the packed tail with its int8 branch. Each timed
    beside cuDNN's bf16 and f32 (TF32 off) convolution of the same shape,
    the library yardsticks, and the whole conv2d_int8 (scale, quantize,
    route, dequantize) from a bf16 input."""
    import torch
    import torch.nn.functional as F
    from pvnet_tpu_torch import infer, pipeline as pl
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.ops import quant_conv as Q

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = infer.load_model(CKPT, VN, dev, TrainConfig.from_json(RECIPE),
                             quant_stages=QUANT_STAGES, quant_mode="dynamic")
    x = pl.normalize_images(torch.from_numpy(
        request_images(fixture["images"], -3)[0]).to(dev))
    shapes, route = {}, Q.conv_int8_acc

    def record(q, w_q, stride=1, padding=0, dilation=1):
        key = (tuple(q.shape), tuple(w_q.shape), Q._pair(stride),
               Q._pair(padding), Q._pair(dilation))
        shapes.setdefault(key, 0)
        shapes[key] += 1
        return route(q, w_q, stride, padding, dilation)

    # the route counts its launches on the module's conv_int8_acc, which
    # is ``record`` while it records
    record.launches = 0
    Q.conv_int8_acc = record
    try:
        with torch.no_grad():
            pl.fused_tail_foreground(model, x, 512, dtype=torch.bfloat16,
                                     tail_depth=3, fcn_bf16=True,
                                     tail_quant=True)
    finally:
        Q.conv_int8_acc = route
    del model, x
    g = torch.Generator(device=dev).manual_seed(11)
    entries = []
    for (qs, ws, stride, pad, dil), uses in shapes.items():
        q = torch.randint(-127, 128, qs, generator=g, device=dev,
                          dtype=torch.int8)
        w_q = torch.randint(-127, 128, ws, generator=g, device=dev,
                            dtype=torch.int8)
        t0 = time.time()
        want = Q.conv_int8_acc_plain(q, w_q, stride, pad, dil)
        torch.cuda.synchronize()
        plain_s = time.time() - t0
        got = route(q, w_q, stride, pad, dil)
        assert got.dtype == torch.int32 and torch.equal(got, want), \
            f"int8 route {qs} x {ws} disagrees with its plain version"
        del want
        xb = (q.float() * 0.01).to(torch.bfloat16)
        wf = w_q.float() * 0.01
        args = (stride, pad, dil)
        route_ms = cuda_ms(lambda: route(q, w_q, *args), iters=10)
        qconv_ms = cuda_ms(lambda: Q.conv2d_int8(xb, wf, *args), iters=10)
        bf16_ms = cuda_ms(lambda: F.conv2d(xb, wf.to(torch.bfloat16), None,
                                           *args), iters=10)
        xf = xb.float()
        f32_ms = cuda_ms(lambda: F.conv2d(xf, wf, None, *args), iters=10)
        m, n = got.shape[0] * got.shape[2] * got.shape[3], ws[0]
        k = ws[1] * ws[2] * ws[3]
        ops = 2 * m * n * k
        nbytes = q.numel() + w_q.numel() + got.numel() * 4
        bound = max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        print(f"int8 route {list(qs)} * {list(ws)} stride {stride[0]} pad "
              f"{pad[0]} dilation {dil[0]} (M={m}, K={k}, N={n}; {uses} "
              f"per forward): equal to float64 plain ({plain_s:.2f} s); "
              f"route {route_ms:.4f} ms, conv2d_int8 {qconv_ms:.4f} ms; "
              f"cuDNN bf16 {bf16_ms:.4f} ms, f32 {f32_ms:.4f} ms; bound "
              f"{bound:.4f} ms ({ops / 1e12:.3f} T int8 ops at 1979 T/s, "
              f"{nbytes / 1e6:.1f} MB)", flush=True)
        entries.append({"input": list(qs), "weight": list(ws),
                        "stride": stride[0], "padding": pad[0],
                        "dilation": dil[0], "per_forward": uses,
                        "max_abs_err": 0.0, "route_ms": route_ms,
                        "conv2d_int8_ms": qconv_ms, "cudnn_bf16_ms": bf16_ms,
                        "cudnn_f32_ms": f32_ms, "bound_ms": bound})
        del q, w_q, got, xb, wf, xf
    torch.cuda.empty_cache()
    return entries


def preset_model(dev, views):
    """The production preset's model: configs/synthetic_train.json (bf16),
    int8 stages 0-3 with static scales calibrated on a request's first 8
    images, as ``python -m pvnet_tpu_torch.infer --cfg_file ... --quant``
    builds it."""
    from pvnet_tpu_torch import infer
    from pvnet_tpu_torch.config import TrainConfig
    cfg = TrainConfig.from_json(RECIPE)
    assert cfg.bf16
    model = infer.load_model(CKPT, VN, dev, cfg, quant_stages=QUANT_STAGES,
                             quant_mode="static")
    n = infer.calibrate_static(model, request_images(views, 0)[0], bf16=True)
    assert n == 8
    return model


def run_preset(dev, fixture, kernels, plain_stages, packed_stages, split):
    """Phase (i): the production preset (see the module docstring)."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import infer, pipeline as pl
    from pvnet_tpu_torch.ops import packed_tail, quant_conv, select_kernel
    from pvnet_tpu_torch.ops import voting

    views = fixture["images"]
    model = preset_model(dev, views)
    n_qconv = len(quant_conv.quant_convs(model))
    pts = torch.as_tensor(fixture["points_3d"], device=dev)
    K = torch.as_tensor(fixture["K"], device=dev)
    params = pl.VoteParams()
    gen = torch.Generator(device=dev).manual_seed(2)
    counters = {"stratified_select": select_kernel.stratified_select,
                "stratified_select_cmajor":
                select_kernel.stratified_select_cmajor,
                "count_inliers": voting.count_inliers,
                "count_inliers_bf16": voting.count_inliers_bf16,
                "int8 route": quant_conv.conv_int8_acc}
    preset = dict(tail_depth=3, bf16=True, impl="bf16")
    bf16_launches = 0
    for unc in (False, True):
        infer.infer_batch(model, request_images(views, -2)[0], pts, K,
                          params, gen, uncertainty=unc, **preset)
        torch.cuda.synchronize()                # warm-up, not counted
        for fn in counters.values():
            fn.launches = 0
        results, lat = [], []
        for r in range(N_REQUESTS):
            imgs, idx = request_images(views, r)
            t0 = time.perf_counter()
            est = infer.infer_batch(model, imgs, pts, K, params, gen,
                                    uncertainty=unc, **preset)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            results.append((est, idx))
        launches = {k: fn.launches for k, fn in counters.items()}
        print(f"(i) preset (bf16, int8 stages 0-3 static, tail_depth 3, "
              f"bf16 counts), uncertainty={unc}: {N_REQUESTS} requests of "
              f"{BATCH} images at {H}x{W}: latency ms "
              f"{[round(x, 3) for x in lat]}; kernel launches {launches}",
              flush=True)
        assert launches == {
            "stratified_select": N_REQUESTS, "stratified_select_cmajor": 0,
            "count_inliers": 0, "count_inliers_bf16": N_REQUESTS * (1 + unc),
            "int8 route": N_REQUESTS * n_qconv}, launches
        bf16_launches += launches["count_inliers_bf16"]
        for est, _ in results:
            assert (est.fg_pixels > 0).all()
        check_poses(results, fixture)
    for k in kernels:
        if k["name"] == "count_inliers_bf16":       # on this path only
            k["launches"] = bf16_launches

    # the card path against the CPU path from the same packed field
    with torch.no_grad():
        x = pl.normalize_images(torch.from_numpy(
            request_images(views, 0)[0]).to(dev))
        x = x.permute(0, 3, 1, 2).contiguous()
        with torch.autocast("cuda", dtype=torch.bfloat16):
            fg_feats = model(x, return_8s_features=True)
        packed, fgcnt = packed_tail.packed_tail_deep3_from_model(
            model, *fg_feats, x, dtype=torch.bfloat16)
        del fg_feats
    packed_card_vs_cpu(packed, fgcnt, pts, K, params, gen, dev, impl="bf16",
                       what="(i) preset")
    del packed, fgcnt

    meds = {}
    for unc in (False, True):
        stages = [packed_stage_ms(model, request_images(views, r)[0], pts, K,
                                  params, dev, unc, bf16=True, impl="bf16")
                  for r in range(3)]
        meds[unc] = {k: sorted(s[k] for s in stages)[1] for k in stages[0]}
        print(f"(i) preset stage ms, uncertainty={unc} (median of 3 requests "
              f"of {BATCH} images), beside (g) f32 packed: "
              + ", ".join(f"{k} {v:.3f} ({packed_stages[unc][k]:.3f})"
                          for k, v in meds[unc].items())
              + f"; sum {sum(meds[unc].values()):.3f} "
              f"({sum(packed_stages[unc].values()):.3f}); plain (d) sum "
              f"{sum(plain_stages.values()):.3f}, its fcn "
              f"{plain_stages['fcn']:.3f}", flush=True)
    del model
    torch.cuda.empty_cache()
    preset_rates(dev, split)


def seeded_draws(seed: int, dev, params, uncertainty: bool):
    """TrainLoop.validate's ``draws`` at tail_depth 3 for RANSAC seed
    ``seed``: each batch's selection noise and pair draws from a CPU
    generator seeded (seed, batch), on ``dev``."""
    import torch

    def draws(bidx, b, h, w):
        g = torch.Generator().manual_seed(1000 * seed + bidx)
        d = {"noise": torch.rand((b, h // 2, w // 2), generator=g),
             "pair_u": torch.rand((b, params.hyp_num, 2), generator=g)}
        if uncertainty:
            d["cov_pair_u"] = torch.rand(
                (b, params.uncertainty_hyp_num, 2), generator=g)
        return {k: v.to(dev) for k, v in d.items()}
    return draws


def preset_rates(dev, split):
    """Phase (i) on phase (h)'s 64 images: float32 with int8 static scales
    at tail_depth 3, plain and uncertainty, once with the scales the port
    calibrates (TrainLoop.calibrate_quant on its first batch of 8, images
    1228-1235) and once with JAX's (utils.weights.quant_from_flax), each
    with three RANSAC seeds as the JAX reference has (seed 0 is validate's
    own generator, 1 and 2 seeded_draws); the mean of each rate over the
    three seeds within the JAX reference's range over its three seeds,
    widened by two images (assets/duck_eval_occ64_int8.json). A single
    seed's rate is not held alone: one seed moves ADD by up to 7 of the 64
    images here, the float model's too (tools/int8_rate_sensitivity_torch.py).
    The bf16 preset's rates (bf16 counts, seed 0) printed; the port's
    calibrated scales against JAX's."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.data.dataset import eval_batches
    from pvnet_tpu_torch.eval.evaluator import Evaluator
    from pvnet_tpu_torch.utils.weights import (_flatten,
                                               flax_quant_from_model,
                                               quant_from_flax)

    with open(INT8_REFERENCE) as f:
        ref = json.load(f)
    assert ref["indices"] == [int(i) for i in split["index"]], \
        "phase (h)'s images are not the int8 reference's"
    n = len(split["images"])
    tol = 2.0 / n
    params = pl.VoteParams()
    theirs = ref["quant"]["act_absmax"]

    def evaluate(loop, state, unc, impl=None, seed=0):
        ev = Evaluator(loop.object_meta(split), device=dev)
        loop.validate(state, eval_batches(split, loop.cfg.test_batch_size),
                      0, evaluate_pose=True, uncertainty=unc, tail_depth=3,
                      vote_impl=impl, evaluator=ev,
                      draws=None if seed == 0 else seeded_draws(
                          seed, dev, params, unc))
        return ev.average_precision(verbose=False)

    def calibrated(bf16):
        loop, state = eval_loop(bf16, dev, quant_stages=QUANT_STAGES,
                                quant_mode="static")
        loop.calibrate_quant(state, eval_batches(
            split, loop.cfg.test_batch_size), num_batches=1)
        return loop, state

    loop, state = calibrated(False)
    ours = {k[:-len("/act_absmax")]: float(v) for k, v in
            _flatten(flax_quant_from_model(state.model)).items()}
    assert set(ours) == set(theirs)
    rel = {k: abs(ours[k] - theirs[k]) / theirs[k] for k in ours}
    worst = max(rel, key=rel.get)
    print(f"(i) calibrated act_absmax (f32, images "
          f"{ref['quant']['calibration_indices'][0]}-"
          f"{ref['quant']['calibration_indices'][-1]}) vs JAX's: largest "
          f"relative difference {rel[worst]:.3e} at {worst}; first conv "
          f"{rel[min(rel)]:.3e}", flush=True)
    for scales in ("port", "JAX"):
        if scales == "JAX":
            quant_from_flax(state.model, {f"{k}/act_absmax": v
                                          for k, v in theirs.items()})
        for unc in (False, True):
            mode = "uncertainty" if unc else "plain"
            runs = ref["runs"][mode]
            t1 = time.time()
            got = np.array([evaluate(loop, state, unc, seed=s)
                            for s in (0, 1, 2)])
            secs = time.time() - t1
            mean = got.mean(0)
            print(f"(i) f32 + int8 static ({scales}'s scales), tail_depth "
                  f"3, f32 counts, {mode}, seeds 0/1/2 ({3 * n} images in "
                  f"{secs:.2f} s):", flush=True)
            for j, m in enumerate(("proj", "add", "cm")):
                js = [r[m] for r in runs]
                print(f"(i)   {m}: {[round(x * n) for x in got[:, j]]} of "
                      f"{n}, mean {mean[j]:.4f}; JAX f32 + int8 static "
                      f"(CPU) seeds {[r['seed'] for r in runs]}: "
                      f"{[round(x * n) for x in js]}; tolerance {tol:.4f}",
                      flush=True)
                assert min(js) - tol <= mean[j] <= max(js) + tol, \
                    f"int8 ({scales}'s scales) {mode} {m}: mean " \
                    f"{mean[j]} outside [{min(js) - tol}, {max(js) + tol}]"
    del loop, state
    loop, state = calibrated(True)
    for unc in (False, True):
        got = evaluate(loop, state, unc, "bf16")
        print(f"(i) bf16 preset + int8 static, tail_depth 3, bf16 counts, "
              f"{'uncertainty' if unc else 'plain'}, seed 0: proj "
              f"{got[0]:.4f} add {got[1]:.4f} 5cm5deg {got[2]:.4f}",
              flush=True)
    del loop, state
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase (j): the deployment path
# ---------------------------------------------------------------------------

# the two artifacts of phase (j): their export flags, the pvnet_torch
# operators their graphs must hold, and the kernel launches of one call
ARTIFACTS = {
    "A": (["--packed_stem", "--quant"], ["count_inliers", "select_nhwc"],
          {"stratified_select": 1, "stratified_select_cmajor": 0,
           "count_inliers": 1, "count_inliers_bf16": 0}),
    "B": (["--no-fused_tail", "--no-bf16", "--uncertainty"],
          ["count_inliers", "select_cmajor"],
          {"stratified_select": 0, "stratified_select_cmajor": 2,
           "count_inliers": 2, "count_inliers_bf16": 0}),
}
EXPORT_BATCH = 8
EXPORT_SEED = 11
EXPORT_DIR = os.path.join(REPO, "export_out", "chip_smoke")


def kernel_counters():
    """{kernel name: the wrapper whose ``.launches`` counts it} of K1-K3."""
    from pvnet_tpu_torch.ops import select_kernel, voting
    return {"stratified_select": select_kernel.stratified_select,
            "stratified_select_cmajor":
            select_kernel.stratified_select_cmajor,
            "count_inliers": voting.count_inliers,
            "count_inliers_bf16": voting.count_inliers_bf16}


def add_launches(kernels, launches):
    for k in kernels:
        k["launches"] += launches.get(k["name"], 0)


class OpRecorder:
    """Within the block, records every call of a pvnet_torch operator:
    (name, inputs, outputs), in order."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        calls = self.calls = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if str(func).startswith("pvnet_torch."):
                    calls.append((str(func), args, out))
                return out
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)


def check_stem(dev, views):
    """(j) the packed4 stem at full width: the folded model against the
    conv7 model on 8 views in float32, and the stem convolution timed both
    ways."""
    import torch
    import torch.nn.functional as F
    from pvnet_tpu_torch import infer, pipeline as pl
    from pvnet_tpu_torch.models.resnet import space_to_depth2, \
        space_to_depth2_cm
    from pvnet_tpu_torch.ops import voting

    model7 = infer.load_model(CKPT, VN, dev)
    model4 = infer.load_model(CKPT, VN, dev, stem="packed4")
    u8 = torch.from_numpy(request_images(views, 0)[0][:EXPORT_BATCH]).to(dev)
    x = pl.normalize_images(u8)
    packed = pl.normalize_packed_u8(u8)
    assert torch.equal(packed, space_to_depth2(x)), \
        "normalize_packed_u8 != space_to_depth2(normalize_images)"
    xc = x.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        out7 = model7(xc)
        out4 = model4(packed.permute(0, 3, 1, 2).contiguous())
    errs = []
    for name, a, b in zip(("seg", "ver"), out4, out7):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        errs.append(f"{name} max abs diff {float((a - b).abs().max()):.3e}")
    noise = torch.rand(out7[0].shape[:1] + out7[0].shape[2:], device=dev)
    fgs = [voting.sample_foreground(torch.argmax(seg, 1), ver, 512, noise)
           for seg, ver in (out7, out4)]
    for name in ("coords", "valid", "count", "total"):
        assert torch.equal(getattr(fgs[0], name), getattr(fgs[1], name)), \
            f"packed4 stem: selection's {name} differs from conv7's"
    w7 = model7.resnet18_8s.conv1.weight
    w4 = model4.resnet18_8s.conv1.weight
    xp = F.pad(space_to_depth2_cm(xc), (2, 1, 2, 1)).contiguous()
    torch.testing.assert_close(F.conv2d(xp, w4),
                               F.conv2d(xc, w7, stride=2, padding=3),
                               rtol=1e-4, atol=1e-4)
    t7 = cuda_ms(lambda: F.conv2d(xc, w7, stride=2, padding=3))
    t4 = cuda_ms(lambda: F.conv2d(xp, w4))
    t4p = cuda_ms(lambda: F.conv2d(F.pad(space_to_depth2_cm(xc),
                                         (2, 1, 2, 1)), w4))
    print(f"(j) packed4 stem vs conv7, duck checkpoint, {EXPORT_BATCH} views"
          f" at {H}x{W}, float32: {', '.join(errs)} (rtol/atol 1e-4); "
          f"selections equal", flush=True)
    print(f"(j) stem convolution (cuDNN, float32, no TF32), [{EXPORT_BATCH}, "
          f"3, {H}, {W}] -> 64 channels at {H // 2}x{W // 2}: 7x7/2 on 3 "
          f"channels {t7:.4f} ms; 4x4/1 on the 12 packed channels "
          f"{t4:.4f} ms ({t4p:.4f} ms with the pack and pad); "
          f"{SMI}", flush=True)
    del model7, model4, out7, out4


def export_artifacts():
    """Export artifacts A and B with the CLI, both processes at once;
    returns {name: (directory, process seconds, the CLI's report)}."""
    import shutil
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    procs, logs, t0 = {}, {}, time.time()
    try:
        for name, (flags, _, _) in ARTIFACTS.items():
            out = os.path.join(EXPORT_DIR, name)
            logs[name] = open(out + ".log", "w")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "pvnet_tpu_torch.export", "--out_dir",
                 out, "--checkpoint", CKPT, "--points_3d", FIXTURE,
                 "--batch", str(EXPORT_BATCH), "--height", str(H),
                 "--width", str(W), *flags], cwd=REPO, stdout=logs[name],
                stderr=subprocess.STDOUT)
        done = {}
        while len(done) < len(procs):
            for name, p in procs.items():
                if name not in done and p.poll() is not None:
                    done[name] = time.time() - t0
            assert time.time() - t0 < 600, "export took over 600 s"
            time.sleep(0.2)
    finally:
        for name, p in procs.items():
            if p.poll() is None:
                p.kill()
            p.wait()
            logs[name].close()
    result = {}
    for name, p in procs.items():
        out = os.path.join(EXPORT_DIR, name)
        with open(out + ".log") as f:
            text = f.read()
        assert p.returncode == 0, f"export of {name} failed:\n{text[-3000:]}"
        report = [ln for ln in text.splitlines() if ln.startswith("exported")]
        result[name] = (out, done[name], report[-1])
    return result


def check_artifact(dev, name, out, fixture, kernels):
    """(j) one artifact: load it, check its operators, one counted call,
    the same seed twice, and the call against the direct estimate_poses
    with the same draws and weights. Returns the loaded artifact."""
    import torch
    from pvnet_tpu_torch import export, pipeline as pl
    from pvnet_tpu_torch.ops.geometry import rotation_angle_deg

    _, want_ops, want_launches = ARTIFACTS[name]
    t0 = time.time()
    art = export.load_artifact(out)
    load_s = time.time() - t0
    mb = os.path.getsize(os.path.join(out, export.PROGRAM)) / 1e6
    ops = export.graph_ops(art.program)
    assert export.custom_ops(art.program) == want_ops, \
        export.custom_ops(art.program)
    assert art.manifest["custom_ops"] == want_ops
    if name == "A":                                 # the int8 route
        assert ops.get("aten._int_mm.default", 0) > 0, "no int8 product"
    m = art.manifest
    u8 = request_images(fixture["images"], 7)[0][:EXPORT_BATCH]
    images = (torch.from_numpy(u8) if m["input_dtype"] == "uint8"
              else pl.normalize_images(torch.from_numpy(u8)))
    art.call(images, EXPORT_SEED)                   # warm-up, not counted
    torch.cuda.synchronize()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    pose, kps = art.call(images, EXPORT_SEED)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: fn.launches for k, fn in counters.items()}
    assert launches == want_launches, (name, launches)
    add_launches(kernels, launches)
    pose2, kps2 = art.call(images, EXPORT_SEED)
    assert torch.equal(pose, pose2) and torch.equal(kps, kps2), \
        f"artifact {name}: the same seed gave another pose"
    assert pose.shape == (EXPORT_BATCH, 3, 4) and torch.isfinite(pose).all()

    # the program against the eager pipeline: same weights, same draws
    model = export.eager_model(art)
    pts = torch.as_tensor(m["points_3d"], device=dev)
    K = torch.as_tensor(m["K"], device=dev)
    draws = dict(zip(m["draws"], art.draws(EXPORT_SEED)))
    with OpRecorder() as got:
        art.call(images, EXPORT_SEED)
    with OpRecorder() as want:
        est = pl.estimate_poses(model, images.to(dev), pts, K,
                                pl.VoteParams(), **draws,
                                **export.pipeline_options(m))
    assert [c[0] for c in got.calls] == [c[0] for c in want.calls], \
        ([c[0] for c in got.calls], [c[0] for c in want.calls])
    for (op, a_in, a_out), (_, b_in, b_out) in zip(got.calls, want.calls):
        outs = a_out if isinstance(a_out, tuple) else (a_out,)
        wants = b_out if isinstance(b_out, tuple) else (b_out,)
        # a selection's outputs; a count's hypotheses and counts
        pairs = list(zip(outs, wants))
        if "count_inliers" in op:
            pairs.append((a_in[3], b_in[3]))
        for x, y in pairs:
            assert torch.equal(x, y), f"artifact {name}: {op} differs"
    kp_diff = float((kps - est.kps).abs().max())
    rot = float(rotation_angle_deg(pose[:, :, :3], est.pose[:, :, :3]).max())
    t_diff = float((pose[:, :, 3] - est.pose[:, :, 3]).norm(dim=-1).max())
    print(f"(j) artifact {name} ({' '.join(ARTIFACTS[name][0])}): "
          f"{mb:.1f} MB, loaded in {load_s:.1f} s; operators {want_ops}, "
          f"{sum(ops.values())} graph nodes; one call of {EXPORT_BATCH} "
          f"images {call_ms:.1f} ms, launches {launches}; the same seed "
          f"twice identical; against the direct estimate_poses with the "
          f"same draws: the outputs of its {len(got.calls)} operator calls "
          f"(selections; hypotheses and counts) equal, "
          f"keypoints max diff {kp_diff:.3e} px, poses {rot:.3e} deg, "
          f"{t_diff:.3e} m", flush=True)
    assert kp_diff < 1e-3 and rot < 0.05 and t_diff < 1e-3
    return art


def post_pose(url, image, timeout=120.0):
    """POST an [h, w, 3] array as .npy; returns (reply, seconds)."""
    import io
    import urllib.request
    import numpy as np
    buf = io.BytesIO()
    np.save(buf, image)
    req = urllib.request.Request(
        url + "/pose", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npy"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        reply = json.loads(r.read())
    return reply, time.perf_counter() - t0


def serve_artifact(dev, out, art, fixture, kernels):
    """(j) artifact A behind the HTTP server on 127.0.0.1: healthz, a lone
    request, 8 concurrent requests (3 rounds each), a bad payload."""
    import socket
    import threading
    import urllib.error
    import urllib.request
    import numpy as np
    import torch
    from pvnet_tpu_torch import serve

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    url = f"http://127.0.0.1:{port}"
    started = threading.Event()
    thread = threading.Thread(
        target=serve.serve, args=(out, "127.0.0.1", port, 10.0, started),
        kwargs={"artifact": art}, daemon=True)
    thread.start()
    assert started.wait(300), "the server did not start"
    batcher = started.batcher
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["batch"] == EXPORT_BATCH
        views = fixture["images"]
        lone = []
        for r in range(N_REQUESTS):
            reply, sec = post_pose(url, request_images(views, 20 + r)[0][0])
            assert np.isfinite(np.asarray(reply["pose"])).all()
            lone.append(sec * 1e3)
        # a JPEG body of another size (view 0 at 3/4 scale): decoded and
        # resized as PIL's BILINEAR, without PIL (data/resample)
        from pvnet_tpu_torch.data.image_io import encode_jpeg
        from pvnet_tpu_torch.data.resample import resize_bilinear
        from pvnet_tpu_torch.ops.geometry import rotation_angle_deg
        small = resize_bilinear(views[0], H * 3 // 4, W * 3 // 4)
        req = urllib.request.Request(
            url + "/pose", data=encode_jpeg(small, dev),
            headers={"Content-Type": "image/jpeg"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            jpeg_code, reply = r.status, json.loads(r.read())
        jpeg_ms = (time.perf_counter() - t0) * 1e3
        jpeg_pose = torch.tensor(reply["pose"], dtype=torch.float64)
        assert jpeg_code == 200 and torch.isfinite(jpeg_pose).all(), reply
        gt0 = torch.as_tensor(fixture["poses"][0], dtype=torch.float64)
        jpeg_err = (float(rotation_angle_deg(jpeg_pose[None, :, :3],
                                             gt0[None, :, :3])[0]),
                    float((jpeg_pose[:, 3] - gt0[:, 3]).norm()))
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        rounds, calls, results = [], [], []
        for r in range(N_REQUESTS):
            imgs, idx = request_images(views, 30 + r)
            imgs, idx = imgs[:EXPORT_BATCH], idx[:EXPORT_BATCH]
            replies, secs = [None] * EXPORT_BATCH, [0.0] * EXPORT_BATCH
            errors = []

            def worker(i):
                try:
                    replies[i], secs[i] = post_pose(url, imgs[i])
                except Exception as e:              # reported below
                    errors.append(repr(e))
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(EXPORT_BATCH)]
            c0 = batcher.calls
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not errors and all(replies), errors
            calls.append(batcher.calls - c0)
            rounds.append(sorted(secs)[len(secs) // 2] * 1e3)
            results.append((torch.tensor(np.array(
                [rep["pose"] for rep in replies]), dtype=torch.float32),
                idx))
        launches = {k: fn.launches for k, fn in counters.items()}
        add_launches(kernels, launches)
        assert all(c < EXPORT_BATCH for c in calls), calls
        check_served_poses(results, fixture)
        bad = urllib.request.Request(
            url + "/pose", data=b"not an array",
            headers={"Content-Type": "application/x-npy"})
        try:
            urllib.request.urlopen(bad, timeout=30)
            raise AssertionError("a bad payload was answered")
        except urllib.error.HTTPError as e:
            assert 400 <= e.code < 500, e.code
            bad_code = e.code
    finally:
        started.server.shutdown()
        thread.join(timeout=60)
    print(f"(j) serving A on 127.0.0.1 (batch {EXPORT_BATCH}, window 10 ms):"
          f" healthz ok; lone request latency ms "
          f"{[round(x, 3) for x in lone]} (median "
          f"{sorted(lone)[1]:.3f}); 8 concurrent requests, 3 rounds: "
          f"median latency ms {[round(x, 3) for x in rounds]}, device "
          f"calls {calls}; launches {launches}; a bad payload got "
          f"{bad_code}; a {small.shape[0]}x{small.shape[1]} JPEG body got "
          f"{jpeg_code} in {jpeg_ms:.1f} ms, resized on the server, view 0 "
          f"posed {jpeg_err[0]:.3f} deg / {jpeg_err[1] * 100:.3f} cm from "
          f"its ground truth; {SMI}", flush=True)


def check_served_poses(results, fixture):
    """The served poses: finite, and the well-visible view 0 within 5 cm
    / 5 deg in at least half of its requests (as check_poses)."""
    import torch
    from pvnet_tpu_torch.ops.geometry import rotation_angle_deg
    rot, trans, views_of = [], [], []
    for pose, idx in results:
        assert torch.isfinite(pose).all()
        g_t = torch.as_tensor(fixture["poses"][idx])
        rot.append(rotation_angle_deg(pose[:, :, :3], g_t[:, :, :3]))
        trans.append((pose[:, :, 3] - g_t[:, :, 3]).norm(dim=-1))
        views_of.append(torch.as_tensor(idx))
    rot, trans, views_of = torch.cat(rot), torch.cat(trans), \
        torch.cat(views_of)
    ok0 = ((rot < 5.0) & (trans < 0.05))[views_of == 0]
    print(f"(j) served poses, view 0: rotation error deg median "
          f"{float(rot[views_of == 0].median()):.4f}, translation error m "
          f"median {float(trans[views_of == 0].median()):.5f}", flush=True)
    assert ok0.float().mean() >= 0.5, \
        f"view 0 served within 5 cm / 5 deg in only {int(ok0.sum())} of " \
        f"{len(ok0)} requests"


def run_deployment(dev, fixture, kernels):
    """Phase (j): the packed4 stem, artifacts A and B exported, loaded and
    checked, and A served (see the module docstring)."""
    import shutil
    import torch

    check_stem(dev, fixture["images"])
    torch.cuda.empty_cache()
    exported = export_artifacts()
    for name, (out, secs, report) in exported.items():
        print(f"(j) export {name}: {report} (process {secs:.1f} s, both "
              f"exports at once)", flush=True)
    try:
        check_artifact(dev, "B", exported["B"][0], fixture, kernels)
        torch.cuda.empty_cache()
        art = check_artifact(dev, "A", exported["A"][0], fixture, kernels)
        serve_artifact(dev, exported["A"][0], art, fixture, kernels)
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)


# --- phase (k): multi-object inference and the voting variants --------------

MC_SCENES = 16          # (k1), (k2): scenes of 3 classes at 480x640
MC_SEED = 17
MC_MIN_VISIBLE = 400    # (k1): classes with fewer visible pixels are skipped
MC_TRAIN_BATCH = 8      # (k4)
VARIANT_CPU_IMAGES = 4  # (k3): the CPU repeats the first 4 of 16 images


def reset_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def stand_in_model(seg, field):
    """A model returning fixed seg logits [b, C+1, h, w] and a fixed
    channel-major field, whatever its input: the ground-truth stand-in of
    JAX's test_multiclass_pose_pipeline_api."""
    import torch

    class StandIn(torch.nn.Module):
        def forward(self, x):
            return seg, field
    return StandIn()


def multiclass_scenes():
    """(k1)'s scenes: data/multiclass.generate_split of the duck, box and
    cylinder at 480x640, LINEMOD_K, seed MC_SEED."""
    from pvnet_tpu_torch.config import LINEMOD_K
    from pvnet_tpu_torch.data import multiclass as MC
    classes = MC.build_class_set()
    metas = [MC.class_meta(*c) for c in classes]
    t0 = time.time()
    images, masks, hcoords, poses = MC.generate_split(
        classes, metas, MC_SCENES, LINEMOD_K, H, W, MC_SEED)
    vis = {m.name: [int((masks == c + 1).sum((1, 2)).min()),
                    int((masks == c + 1).sum((1, 2)).max())]
           for c, m in enumerate(metas)}
    print(f"(k) {MC_SCENES} multi-class scenes at {H}x{W} in "
          f"{time.time() - t0:.1f} s; visible pixels per class [min, max] "
          f"{vis}", flush=True)
    return metas, LINEMOD_K.astype("float32"), images, masks, hcoords, poses


def pose_errors(pred, gt):
    """(rotation deg, translation m) of poses [..., 3, 4] on the CPU, in
    float64. The angle is 2 asin(|R1 - R2|_F / sqrt(8)), the geodesic
    angle for rotations: the arccos of (trace(R1 R2^T) - 1) / 2 reads
    0.02-0.04 deg between a float32 rotation and itself, its rows being
    orthonormal only to float32 rounding."""
    import torch
    pred, gt = pred.cpu().double(), gt.cpu().double()
    chord = (pred[..., :3] - gt[..., :3]).flatten(-2).norm(dim=-1)
    rot = torch.rad2deg(2 * torch.asin((chord / 8 ** 0.5).clamp(max=1.0)))
    return rot, (pred[..., 3] - gt[..., 3]).norm(dim=-1)


def run_multiclass_gt(dev, scenes, kernels):
    """(k1) the multi-class pipeline on the ground-truth stand-in: K1 and
    K3 once per class per request, every class with >= MC_MIN_VISIBLE
    visible pixels posed within 5 deg / 2 cm."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.data.vertex import compute_vertex_targets_multiclass

    metas, K, images, masks, hcoords, poses = scenes
    C = len(metas)
    masks_t = torch.from_numpy(masks).to(dev)
    field = compute_vertex_targets_multiclass(
        masks_t, torch.from_numpy(hcoords).to(dev))
    seg = torch.nn.functional.one_hot(masks_t.long(), C + 1).permute(
        0, 3, 1, 2).float() * 10.0
    pts = np.stack([m.points_3d for m in metas])
    run = pl.make_multiclass_pose_pipeline(stand_in_model(seg, field), pts,
                                           K, pl.VoteParams(), device=dev)
    x = pl.normalize_images(torch.from_numpy(images).to(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    run(x, gen)                                             # warm-up
    torch.cuda.synchronize()
    reset_counters()
    lat, results = [], []
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        results.append(run(x, gen))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    counts = read_counters()
    assert counts == {"stratified_select": 0,
                      "stratified_select_cmajor": C * N_REQUESTS,
                      "count_inliers": C * N_REQUESTS,
                      "count_inliers_bf16": 0}, counts
    add_launches(kernels, counts)
    vis = torch.from_numpy((masks[:, None] == np.arange(1, C + 1)[None, :,
                            None, None]).sum((2, 3)))       # [b, C]
    sel = vis >= MC_MIN_VISIBLE
    gt = torch.from_numpy(poses)
    for p, _ in results:
        assert p.shape == (MC_SCENES, C, 3, 4) and torch.isfinite(p).all()
        rot, trans = pose_errors(p, gt)
        bad = sel & ~((rot < 5.0) & (trans < 0.02))
        assert not bad.any(), \
            f"(k1) {int(bad.sum())} classes off by more than 5 deg / 2 cm: " \
            f"rot {rot[bad].tolist()} trans {trans[bad].tolist()}"
    print(f"(k1) {N_REQUESTS} multi-class requests of {MC_SCENES} scenes "
          f"({C} classes, ground-truth stand-in) at {H}x{W}: latency ms "
          f"{[round(v, 3) for v in lat]}; launches {counts}; "
          f"{int(sel.sum())} of {sel.numel()} (image, class) pairs with >= "
          f"{MC_MIN_VISIBLE} visible px, all within 5 deg / 2 cm: rotation "
          f"deg median {float(rot[sel].median()):.4f} max "
          f"{float(rot[sel].max()):.4f}, translation m median "
          f"{float(trans[sel].median()):.5f} max "
          f"{float(trans[sel].max()):.5f}; {SMI}", flush=True)
    card_vs_cpu("(k1)", masks_t, field, C, pts, K, gen, dev, strict=True)


def card_vs_cpu(tag, labels, vertex, C, pts, K, gen, dev, strict):
    """The multi-class vote and PnP on the card and on the CPU from the
    same labels, field and draws: every class's selection, hypotheses,
    counts and winner's inlier mask equal; keypoints within 1e-2 px where
    the refit is well conditioned (see :func:`refit_conditioning`), poses
    within 0.05 deg / 1 mm (float64 angles) where every keypoint of the
    pair is held and PnP is well posed (the CPU pose reprojects the CPU
    keypoints within 1 px RMS). With ``strict`` every keypoint and pose is
    held. Returns (noise, pair_u) for reuse."""
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.ops import voting

    params = pl.VoteParams()
    b = labels.shape[0]
    noise = torch.rand((C, b, H, W), generator=gen, device=dev)
    pair_u = torch.rand((C, b, params.hyp_num, 2), generator=gen,
                        device=dev)
    pts_t, K_t = torch.from_numpy(pts), torch.from_numpy(K)
    with torch.no_grad():
        layer = voting.ransac_voting_multiclass(
            labels, vertex, C + 1, params.hyp_num, params.inlier_thresh,
            params.max_num, params.min_num, noise=noise, pair_u=pair_u)
        outs = [multiclass_parts(labels.to(where), vertex.to(where), C,
                                 params, noise.to(where), pair_u.to(where),
                                 pts_t.to(where), K_t.to(where))
                for where in (dev, torch.device("cpu"))]
    (parts_g, kps_g, pose_g), (parts_c, kps_c, pose_c) = outs
    assert torch.equal(layer, kps_g), "ransac_voting_multiclass != its parts"
    names = ("coords", "dirs", "valid", "hyps", "counts")
    for c in range(C):
        for name, a, b_ in zip(names, parts_g[c], parts_c[c]):
            assert torch.equal(a.cpu(), b_), \
                f"{tag} class {c + 1}: card != CPU on {name}"
    inl, det, cond = refit_conditioning(parts_g, parts_c,
                                        params.inlier_thresh)
    diff = (kps_g.cpu() - kps_c).abs().amax(-1)             # [b, C, vn]
    norm = kps_c.double().norm(dim=-1)
    est = torch.where(cond.isinf(), cond, EPS32 * cond * norm)   # px
    held = est <= 1e-3
    w = int(diff.argmax())
    at = (w // (C * VN), w // VN % C + 1, w % VN)
    print(f"{tag} card vs CPU, same fields and draws: selections, "
          f"hypotheses, counts and the winners' inlier masks equal for every "
          f"class; keypoints max diff {float(diff.max()):.3e} px at (image, "
          f"class, keypoint) {at}: {int(inl.flatten()[w])} inliers, normal "
          f"matrix det {float(det.flatten()[w]):.4e}, condition "
          f"{float(cond.flatten()[w]):.4e}, {float(norm.flatten()[w]):.1f} px "
          f"from the origin, float32 estimate eps*cond*|p| "
          f"{float(est.flatten()[w]):.3e} px; median condition "
          f"{float(cond.median()):.3e}, median keypoint "
          f"{float(norm.median()):.1f} px from the origin; "
          f"{int(held.sum())} of {held.numel()} keypoints with estimate <= "
          f"1e-3 px, held within 1e-2 px (max diff "
          f"{float(diff[held].max()) if held.any() else 0.0:.3e}); "
          f"diff / estimate max "
          f"{float((diff / est)[est > 0].max()):.3e}", flush=True)
    assert (diff[held] < 1e-2).all(), f"{tag} well-conditioned keypoints " \
        f"off by {float(diff[held].max()):.3e} px"

    rot, trans = pose_errors(pose_g, pose_c)
    rms = reprojection_rms(pose_c, pts_t, kps_c, K_t)       # [b, C]
    posed = held.all(-1) & (rms <= 1.0)
    with torch.no_grad():
        pose_cg = pl.multiclass_poses_from_keypoints(pts_t, kps_g.cpu(), K_t)
    rot_same, trans_same = pose_errors(pose_g, pose_cg)
    w = int(rot.argmax())
    print(f"{tag} poses max diff {float(rot.max()):.3e} deg, "
          f"{float(trans.max()):.3e} m (worst pair (image, class) "
          f"{(w // C, w % C + 1)}: CPU pose reprojects its keypoints at "
          f"{float(rms.flatten()[w]):.3e} px RMS); reprojection RMS median "
          f"{float(rms.median()):.3e} px; {int(posed.sum())} of "
          f"{posed.numel()} pairs well posed and held within 0.05 deg / 1 mm "
          f"(max {float(rot[posed].max()) if posed.any() else 0.0:.3e} deg, "
          f"{float(trans[posed].max()) if posed.any() else 0.0:.3e} m); PnP "
          f"on the CPU from the card's keypoints against the card's pose: "
          f"max {float(rot_same.max()):.3e} deg, "
          f"{float(trans_same.max()):.3e} m", flush=True)
    assert (rot[posed] < 0.05).all() and (trans[posed] < 1e-3).all(), \
        f"{tag} well-posed poses differ"
    if strict:
        assert bool(held.all()) and bool(posed.all()), \
            f"{tag}: {int((~held).sum())} keypoints ill-conditioned, " \
            f"{int((~posed).sum())} pairs not held"
    return noise, pair_u


EPS32 = 2.0 ** -23      # float32's unit roundoff


def refit_conditioning(parts_g, parts_c, thresh):
    """The WLS refit's inputs at every (image, class, keypoint), [b, C, vn]
    each: the winner's inlier count, the determinant of its normal matrix
    A = sum n n^T (float64; n = (dy, -dx) of each inlier's field vector,
    unit on a ground-truth field, of any length from a network) and A's
    condition number (inf where A is singular: the refit keeps the
    winner). The
    float32 refit on two devices sums A and A^T b in other orders, so its
    keypoints differ by about eps32 * cond(A) * |p|. Asserts the card's
    winner inlier masks equal the CPU's: no pixel flips at the cosine
    threshold."""
    import torch
    from pvnet_tpu_torch.ops import voting
    inl, det, cond = [], [], []
    for pg, pc in zip(parts_g, parts_c):
        masks = []
        for coords, dirs, valid, hyps, counts in (pg, pc):
            fg = voting.ForegroundSample(coords, dirs, valid, None, None)
            masks.append(voting.inliers_for_points(
                fg, voting._winner_points(hyps, counts), thresh).cpu())
        assert torch.equal(*masks), "winner inlier masks: card != CPU"
        dirs = pc[1].double()                               # [b, tn, vn, 2]
        n = torch.stack([dirs[..., 1], -dirs[..., 0]], -1).transpose(1, 2)
        A = torch.einsum("bvt,bvti,bvtj->bvij", masks[1].double(), n, n)
        lam = torch.linalg.eigvalsh(A)                      # ascending
        inl.append(masks[1].sum(-1))
        det.append(torch.linalg.det(A))
        cond.append(torch.where(lam[..., 0] > 0,
                                lam[..., 1] / lam[..., 0].clamp(min=1e-300),
                                torch.full_like(lam[..., 0], float("inf"))))
    return (torch.stack(inl, 1), torch.stack(det, 1), torch.stack(cond, 1))


def reprojection_rms(poses, pts, kps, K):
    """RMS px by which poses [b, C, 3, 4] reproject pts [C, vn, 3] onto kps
    [b, C, vn, 2] through K [3, 3], float64 -> [b, C]."""
    import torch
    poses, pts, kps, K = (t.cpu().double() for t in (poses, pts, kps, K))
    cam = torch.einsum("bcij,cvj->bcvi", poses[..., :3], pts) \
        + poses[..., None, :, 3]
    uv = cam @ K.T
    proj = uv[..., :2] / uv[..., 2:]
    return (proj - kps).pow(2).sum(-1).mean(-1).sqrt()


def multiclass_parts(labels, vertex, C, params, noise, pair_u, pts, K,
                     impl=None):
    """ransac_voting_multiclass's v3 form spelled out class by class, with
    its intermediate tensors, then the one PnP: [(coords, dirs, valid,
    hyps, counts) per class], kps [b, C, vn, 2], poses [b, C, 3, 4]."""
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.ops import voting
    vertex = vertex.float().contiguous()
    parts, kps = [], []
    for c in range(1, C + 1):
        fg = voting.sample_foreground(labels == c, vertex, params.max_num,
                                      noise=noise[c - 1])
        hyps = voting.generate_hypotheses(fg, params.hyp_num,
                                          pair_u=pair_u[c - 1])
        counts = voting.count_inliers(fg, hyps, params.inlier_thresh, impl)
        kps.append(voting.vote_argmax_refine(fg, hyps, counts,
                                             params.inlier_thresh,
                                             params.min_num))
        parts.append((*fg[:3], hyps, counts))
    kps = torch.stack(kps, dim=1)
    return parts, kps, pl.multiclass_poses_from_keypoints(pts, kps, K)


def multiclass_stage_ms(model, x, C, pts, K, params, dev):
    """One multi-class request's stages by CUDA events: fcn; per class
    select, hypotheses+count, refine; one PnP over b*C; and beside them C
    pnp_batch calls on the same keypoints."""
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.ops import pnp, voting

    g = torch.Generator(device=dev).manual_seed(9)

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    out = {}
    with torch.no_grad():
        torch.cuda.synchronize()
        e0 = event()
        labels, vertex = pl.predict_fields(model, x)
        vertex = vertex.contiguous()
        out["fcn (+ the field's one copy)"] = (e0, event())
        kps = []
        for c in range(1, C + 1):
            a = event()
            fg = voting.sample_foreground(labels == c, vertex,
                                          params.max_num, generator=g)
            b_ = event()
            hyps = voting.generate_hypotheses(fg, params.hyp_num,
                                              generator=g)
            counts = voting.count_inliers(fg, hyps, params.inlier_thresh)
            c_ = event()
            kps.append(voting.vote_argmax_refine(
                fg, hyps, counts, params.inlier_thresh, params.min_num))
            out[f"class {c} select"] = (a, b_)
            out[f"class {c} hypotheses+count"] = (b_, c_)
            out[f"class {c} refine"] = (c_, event())
        kps = torch.stack(kps, dim=1)
        a = event()
        pl.multiclass_poses_from_keypoints(pts, kps, K)
        b_ = event()
        out[f"pnp (one call, {kps.shape[0] * C} problems)"] = (a, b_)
        for c in range(C):
            pnp.pnp_batch(pts[c], kps[:, c], K)
        out[f"pnp ({C} pnp_batch calls)"] = (b_, event())
        torch.cuda.synchronize()
    return {k: s.elapsed_time(e) for k, (s, e) in out.items()}


def run_multiclass_fcn(dev, scenes, kernels):
    """(k2) the multi-class pipeline with the real FCN (resnet18_8s,
    seg_dim=4, ver_dim=18, float32 without TF32, weights from a seeded
    generator): 3 requests, launches, card vs CPU from the same fields and
    draws, one request with bf16 counts, stage ms."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.models.resnet import init_weights
    from pvnet_tpu_torch.ops import voting

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    metas, K, images = scenes[:3]
    C = len(metas)
    model = build_model("resnet18_8s", ver_dim=2 * VN, seg_dim=C + 1)
    init_weights(model, torch.Generator().manual_seed(3))
    model = model.to(dev).eval()
    pts = np.stack([m.points_3d for m in metas])
    params = pl.VoteParams()
    run = pl.make_multiclass_pose_pipeline(model, pts, K, params,
                                           device=dev)
    x = pl.normalize_images(torch.from_numpy(images).to(dev))
    gen = torch.Generator(device=dev).manual_seed(2)
    run(x, gen)                                             # warm-up
    torch.cuda.synchronize()
    reset_counters()
    lat = []
    for _ in range(N_REQUESTS):
        t0 = time.perf_counter()
        p, _ = run(x, gen)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        assert p.shape == (MC_SCENES, C, 3, 4)
    counts = read_counters()
    assert counts == {"stratified_select": 0,
                      "stratified_select_cmajor": C * N_REQUESTS,
                      "count_inliers": C * N_REQUESTS,
                      "count_inliers_bf16": 0}, counts
    add_launches(kernels, counts)
    print(f"(k2) {N_REQUESTS} multi-class requests, resnet18_8s seg_dim="
          f"{C + 1} (seeded weights, float32), b={MC_SCENES}, {H}x{W}: "
          f"latency ms {[round(v, 3) for v in lat]}; launches {counts}",
          flush=True)

    # card vs CPU from the card's fields and the same draws: the integers
    # and inlier masks are held, keypoints and poses where well conditioned
    with torch.no_grad():
        labels, vertex = pl.predict_fields(model, x)
    noise, pair_u = card_vs_cpu("(k2)", labels, vertex, C, pts, K, gen, dev,
                                strict=False)
    pts_t, K_t = torch.from_numpy(pts), torch.from_numpy(K)

    # one request with bf16 counts: K3's bf16 mode once per class
    run_bf16 = pl.make_multiclass_pose_pipeline(model, pts, K, params,
                                                impl="bf16", device=dev)
    reset_counters()
    run_bf16(x, gen)
    torch.cuda.synchronize()
    counts_bf16 = read_counters()
    assert counts_bf16 == {"stratified_select": 0,
                           "stratified_select_cmajor": C,
                           "count_inliers": 0,
                           "count_inliers_bf16": C}, counts_bf16
    add_launches(kernels, counts_bf16)
    with torch.no_grad():
        parts_b, _, _ = multiclass_parts(labels, vertex, C, params, noise,
                                         pair_u, pts_t.to(dev),
                                         K_t.to(dev), impl="bf16")
        for c, (coords, dirs, valid, hyps, counts) in enumerate(parts_b):
            fg = voting.ForegroundSample(coords, dirs, valid, None, None)
            want = voting.count_inliers_plain_bf16(fg, hyps,
                                                   params.inlier_thresh)
            assert torch.equal(counts, want), \
                f"(k2) class {c + 1}: K3's bf16 mode != its plain version"
    print(f"(k2) one request with impl='bf16': launches {counts_bf16}; "
          f"K3's bf16 counts equal to the plain bf16 version for every "
          f"class", flush=True)

    stages = [multiclass_stage_ms(model, x, C, pts_t.to(dev), K_t.to(dev),
                                  params, dev) for _ in range(3)]
    med = {k: sorted(s[k] for s in stages)[1] for k in stages[0]}
    print(f"(k2) stage ms (median of 3 requests of {MC_SCENES} images, "
          f"{C} classes; {SMI}): " + ", ".join(
              f"{k} {v:.3f}" for k, v in med.items()), flush=True)


def variant_layers(fixture, dev, g):
    """(k3)'s inputs on ``dev`` and its layers: {name: (fn(where, n)
    -> tuple of tensors, kernels the layer launches)}, each fn running the
    layer on the first n images with draws made once here."""
    import numpy as np
    import torch
    from pvnet_tpu_torch.data.vertex import compute_vertex_targets
    from pvnet_tpu_torch.ops import voting

    idx = np.arange(BATCH) % len(fixture["masks"])
    mask = torch.from_numpy(fixture["masks"][idx]).to(dev)
    cam = np.einsum("bij,nj->bni", fixture["poses"][idx, :, :3],
                    fixture["points_3d"]) + fixture["poses"][idx, None, :, 3]
    uv = cam @ fixture["K"].T
    hc = np.concatenate([uv[..., :2] / uv[..., 2:],
                         np.ones_like(uv[..., :1])], -1).astype(np.float32)
    hc = torch.from_numpy(hc).to(dev)                       # [b, vn, 3]
    field = compute_vertex_targets(mask, hc)                # [b, 18, h, w]
    center = field[:, 2 * VN - 2:].contiguous()             # the centre
    offsets = compute_vertex_targets(mask, hc, use_motion=True)

    def u(*shape):
        return torch.rand((BATCH, *shape), generator=g, device=dev)
    d = {"noise": u(H, W), "flat": u(H * W), "p1024": u(1024, 2),
         "p512": u(512, 2), "p4096": u(4096, 2), "pvp": u(1024, VN, 2)}

    def at(where, n):
        t = {k: v[:n].to(where) for k, v in d.items()}
        return (mask[:n].to(where), field[:n].to(where),
                center[:n].to(where), offsets[:n].to(where), t)

    def topk(where, n):
        m, f, _, _, t = at(where, n)
        return tuple(voting.sample_foreground(m, f, 1024, noise=t["flat"],
                                              method="topk"))

    def v2(where, n):
        m, f, _, _, t = at(where, n)
        return (voting.ransac_voting_v2(m, f, refine_iter_num=3,
                                        noise=t["noise"],
                                        pair_u=t["p1024"]),)

    def v4(where, n):
        m, f, _, _, t = at(where, n)
        return voting.ransac_voting_v4(m, f, noise=t["noise"],
                                       pair_u=t["p1024"])

    def v5(where, n):
        m, f, _, _, t = at(where, n)
        return voting.ransac_voting_v5(m, f, noise=t["noise"],
                                       pair_u=t["p1024"])

    def v5_confidence_at(kps, n):
        """v5's confidence on the CPU at the given refined points: a count
        of inliers at 0.999, which the refit's last-bit differences can
        move; at the card's points it must equal the card's."""
        m, f, _, _, t = at(torch.device("cpu"), n)
        fg = voting.sample_foreground(m, f, 1024, noise=t["noise"])
        inl = voting.inliers_for_points(fg, kps.cpu(), 0.999)
        return inl.sum(-1).to(torch.float32) \
            / fg.count.clamp(min=1).to(torch.float32)[:, None]

    def dist(where, n):
        m, f, _, _, t = at(where, n)
        return voting.estimate_voting_distribution(m, f, noise=t["noise"],
                                                   pair_u=t["p4096"])

    def counts(where, n):
        m, f, _, _, t = at(where, n)
        return voting.generate_hypotheses_with_counts(
            m, f, noise=t["noise"], pair_u=t["p512"])

    def ctr(where, n):
        m, _, c, _, t = at(where, n)
        return voting.ransac_voting_center(m, c, noise=t["noise"],
                                           pair_u=t["p512"])

    def vanish(where, n):
        m, f, _, _, t = at(where, n)
        return (voting.ransac_voting_vanish_point(m, f, noise=t["noise"],
                                                  pair_u=t["pvp"]),)

    def motion(where, n):
        m, _, _, o, t = at(where, n)
        return (voting.ransac_motion_voting(m, o, noise=t["noise"]),)

    k1k3 = ("stratified_select_cmajor", "count_inliers")
    layers = {"sample_foreground(method='topk')": (topk, ()),
              "v2 (refine_iter_num=3)": (v2, k1k3), "v4": (v4, k1k3),
              "v5": (v5, k1k3),
              "estimate_voting_distribution (hn=4096)": (dist, k1k3),
              "generate_hypotheses_with_counts": (counts, k1k3),
              "center (tn=4096, vn=1)": (ctr, k1k3),
              "vanishing point": (vanish, ("stratified_select_cmajor",)),
              "motion": (motion, ("stratified_select_cmajor",))}
    return layers, hc, v5_confidence_at


def compare_variant(name, got, want):
    """Card against CPU for one layer's outputs: integer and bool tensors
    equal; the top-k selection and the center's instance mask equal; points
    within 1e-2 px; covariances and variances within 1e-3 of their largest
    entry or 1e-4 px^2 (the points' tolerance squared), whichever is
    larger; v5's confidence only printed here (the caller holds it); unit
    vanishing points within 1e-4 and their pixels within 1e-2 px. Returns
    the largest float difference."""
    import torch
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.cpu()
        assert a.shape == b.shape and a.dtype == b.dtype, (name, i)
        if not a.dtype.is_floating_point:
            assert torch.equal(a, b), f"(k3) {name} output {i}: card != CPU"
            continue
        diff = float((a - b).abs().max()) if a.numel() else 0.0
        worst = max(worst, diff)
        scale = float(b.abs().max()) if b.numel() else 0.0
        if i == 1 and name.startswith(("estimate", "v4")):
            # px^2: on a clean field these are rounding-sized, so the
            # floor is the square of the points' 1e-2 px
            ok = diff <= max(1e-3 * scale, 1e-4)
        elif i == 1 and name.startswith("v5"):
            ok = True               # held at the card's points (run_variants)
        elif name.startswith("vanishing"):
            px = (a[..., :2] / a[..., 2:] - b[..., :2] / b[..., 2:]).abs()
            ok = diff <= 1e-4 and float(px.max()) < 1e-2
        elif name.startswith("sample") or i == 1 and name.startswith("cen"):
            ok = diff == 0.0
        else:
            ok = diff < 1e-2
        assert ok, f"(k3) {name} output {i}: card vs CPU diff {diff}"
    return worst


def run_variants(dev, fixture, kernels):
    """(k3) the voting variants on the duck fixture's ground-truth field
    at b=16, 480x640: each on the card (its K1/K3 launches counted) and,
    on the first VARIANT_CPU_IMAGES images with the same draws, on the
    CPU; the keypoints against the fixture's projections."""
    import torch

    g = torch.Generator(device=dev).manual_seed(4)
    layers, hc, v5_confidence_at = variant_layers(fixture, dev, g)
    n_cpu = VARIANT_CPU_IMAGES
    for name, (fn, needs) in layers.items():
        fn(dev, BATCH)                                      # warm-up
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        got = fn(dev, BATCH)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counters()
        for k in needs:
            assert counts[k] >= 1, f"(k3) {name} launched no {k}: {counts}"
        add_launches(kernels, counts)
        t0 = time.perf_counter()
        want = fn(torch.device("cpu"), n_cpu)
        cpu_s = time.perf_counter() - t0
        worst = compare_variant(name, [t[:n_cpu] for t in got], want)
        msg = ""
        if name.startswith("v5"):
            conf = v5_confidence_at(got[0][:n_cpu], n_cpu)
            assert torch.equal(got[1][:n_cpu].cpu(), conf), \
                "(k3) v5: the card's confidence != the CPU's at its points"
            msg = f"; confidence equal to the CPU's at the card's points " \
                  f"(at the CPU's own, max diff " \
                  f"{float((got[1][:n_cpu].cpu() - want[1]).abs().max()):.4f})"
        if name.startswith(("v2", "v4", "v5", "motion")):
            err = float((got[0] - hc[..., :2]).norm(dim=-1).median())
            msg += f"; keypoints median {err:.4f} px from the projections"
            assert err < 0.5, (name, err)
        elif name.startswith("center"):
            err = float((got[0] - hc[:, -1, :2]).norm(dim=-1).max())
            msg = f"; centre max {err:.4f} px off, win ratio min " \
                  f"{float(got[2].min()):.3f}"
            assert err < 1.0, (name, err)
        elif name.startswith("vanishing"):
            px = got[0][..., :2] / got[0][..., 2:]
            err = float((px - hc[..., :2]).norm(dim=-1).median())
            msg = f"; x/z, y/z median {err:.4f} px from the projections"
            assert err < 0.5, (name, err)
        print(f"(k3) {name}: b={BATCH} on the card {ms:.3f} ms (host clock),"
              f" launches {counts}; card = CPU on {n_cpu} images (largest "
              f"float diff {worst:.3e}; CPU {cpu_s:.2f} s){msg}", flush=True)


def run_multiclass_training(dev, scenes):
    """(k4) multi-class training: 3 float32 train_steps at b=8, 480x640 on
    the generated scenes without augmentation, targets from
    compute_vertex_targets_multiclass; then one step at b=2 on the card
    and on the CPU with phase (f)'s tolerances."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.models.resnet import init_weights
    from pvnet_tpu_torch.train import trainer as TT

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    metas, _, images, masks, hcoords, _ = scenes
    C = len(metas)

    def batch(n, where):
        return {"image": pl.normalize_images(torch.from_numpy(images[:n]))
                .permute(0, 3, 1, 2).contiguous().to(where),
                "mask": torch.from_numpy(masks[:n]).to(where),
                "hcoords": torch.from_numpy(hcoords[:n]).to(where)}

    def state_on(where):
        model = build_model("resnet18_8s", ver_dim=2 * VN, seg_dim=C + 1)
        init_weights(model, torch.Generator().manual_seed(5))
        return TT.create_train_state(model.to(where), TrainConfig())

    calls = []
    targets = TT.compute_vertex_targets_multiclass

    def counted(*args, **kw):
        calls.append(1)
        return targets(*args, **kw)
    TT.compute_vertex_targets_multiclass = counted
    try:
        state, data = state_on(dev), batch(MC_TRAIN_BATCH, dev)
        step_ms, losses = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            met = TT.train_step(state, data)
            losses.append(float(met["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        TT.compute_vertex_targets_multiclass = targets
    assert len(calls) == 3 and all(np.isfinite(losses)), (calls, losses)
    print(f"(k4) 3 float32 multi-class train steps, b={MC_TRAIN_BATCH}, "
          f"{H}x{W}, seg_dim={C + 1}: losses {[round(v, 5) for v in losses]}"
          f", step ms {[round(v, 1) for v in step_ms]}; targets from "
          f"compute_vertex_targets_multiclass each step", flush=True)
    del state, data
    torch.cuda.empty_cache()

    out = []
    for where in (dev, torch.device("cpu")):
        state = state_on(where)
        met = TT.train_step(state, batch(2, where))
        out.append((float(met["loss"]),
                    {n: p.grad.detach().double().cpu()
                     for n, p in state.model.named_parameters()}))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out
    rel = {n: float((g_gpu[n] - g_cpu[n]).norm() / g_cpu[n].norm())
           for n in g_cpu}
    total = float(sum(((g_gpu[n] - g_cpu[n]) ** 2).sum() for n in g_cpu)
                  ** 0.5 / sum((g ** 2).sum() for g in g_cpu.values())
                  ** 0.5)
    worst = max(rel, key=rel.get)
    print(f"(k4) f32 multi-class step b=2 (TF32 off), card vs CPU: loss "
          f"{l_gpu:.7f} vs {l_cpu:.7f}; gradients: worst tensor {worst} "
          f"{rel[worst]:.2e} of its norm, all {total:.2e}", flush=True)
    assert abs(l_gpu - l_cpu) <= 1e-3 * abs(l_cpu)
    assert rel[worst] < 3e-2 and total < 5e-3


def run_multiclass(dev, fixture, kernels):
    """Phase (k): multi-object inference and the voting variants (see the
    module docstring)."""
    import torch
    scenes = multiclass_scenes()
    for part in (run_multiclass_gt, run_multiclass_fcn):
        part(dev, scenes, kernels)
        torch.cuda.empty_cache()
    run_variants(dev, fixture, kernels)
    torch.cuda.empty_cache()
    run_multiclass_training(dev, scenes)
    torch.cuda.empty_cache()


# --- phase (l): the model family, --synthetic training, the study ----------

FAMILY = ("resnet34_8s", "resnet50_8s")   # (l1)
DEVICE = "cuda"                           # (l2)'s --device
FAMILY_SEED = 23
FAMILY_CPU_IMAGES = 2                     # (l1): card vs CPU
SYNTH_IMAGES, SYNTH_EPOCHS = 64, 10       # (l2): 32 train images, 2 steps
STUDY_ARGS = ["--train_images", "64", "--test_images", "16", "--epochs",
              "10", "--height", "360", "--width", "480"]      # (l3)


def synthesized_backbone(arch, path, seed):
    """A torchvision-layout ImageNet checkpoint of ``arch`` drawn from
    ``seed`` (utils/torchvision_manifest.synthesize_state_dict), saved to
    ``path``; returns it as tensors."""
    import torch
    from pvnet_tpu_torch.utils.torchvision_manifest import \
        synthesize_state_dict
    sd = {k: torch.from_numpy(v)
          for k, v in synthesize_state_dict(arch, seed).items()}
    torch.save(sd, path)
    return sd


def run_family_model(dev, fixture, kernels, network, tmp):
    """(l1) one deeper network: its backbone from a synthesized ImageNet
    checkpoint loaded on the card (the heads seeded), forward ms in f32
    and bf16 at b=16, 3 plain serving requests with their launches and
    stage ms, and card vs CPU on 2 images by (k2)'s rules."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import infer, pipeline as pl
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.models.resnet import init_weights
    from pvnet_tpu_torch.utils.weights import load_imagenet_backbone

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = network.split("_")[0]
    path = os.path.join(tmp, f"{arch}.pth")
    sd = synthesized_backbone(arch, path, FAMILY_SEED)
    model = build_model(network, ver_dim=2 * VN)
    init_weights(model, torch.Generator().manual_seed(FAMILY_SEED))
    model = model.to(dev).eval()
    load_imagenet_backbone(model, path, arch=arch)
    own = model.backbone.state_dict()
    n = 0
    for k, v in sd.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        assert own[k].device.type == dev.type, k
        assert torch.equal(own[k].cpu(), v), \
            f"(l1) {network}: {k} differs from the checkpoint"
        n += 1
    n_params = sum(p.numel() for p in model.parameters())

    x = pl.normalize_images(torch.from_numpy(
        request_images(fixture["images"], 0)[0]).to(dev)).permute(
            0, 3, 1, 2).contiguous()
    with torch.no_grad():
        f32_ms = cuda_ms(lambda: model(x), iters=10)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            bf16_ms = cuda_ms(lambda: model(x), iters=10)
    print(f"(l1) {network} ({n_params / 1e6:.2f} M parameters): {n} "
          f"backbone tensors loaded on the card from a synthesized "
          f"{arch} ImageNet checkpoint, equal to the file's; forward at "
          f"b={BATCH}, {H}x{W}: f32 (no TF32) {f32_ms:.3f} ms, bf16 "
          f"{bf16_ms:.3f} ms; {SMI}", flush=True)

    pts = torch.as_tensor(fixture["points_3d"], device=dev)
    K = torch.as_tensor(fixture["K"], device=dev)
    params = pl.VoteParams()
    gen = torch.Generator(device=dev).manual_seed(FAMILY_SEED)
    views = fixture["images"]
    infer.infer_batch(model, request_images(views, -1)[0], pts, K, params,
                      gen)                                  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    latencies = []
    for r in range(N_REQUESTS):
        t0 = time.perf_counter()
        est = infer.infer_batch(model, request_images(views, r)[0], pts, K,
                                params, gen)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        assert est.pose.shape == (BATCH, 3, 4)
        assert torch.isfinite(est.pose).all()
    counts = read_counters()
    assert counts == {"stratified_select": 0,
                      "stratified_select_cmajor": N_REQUESTS,
                      "count_inliers": N_REQUESTS,
                      "count_inliers_bf16": 0}, counts
    add_launches(kernels, counts)
    stages = [stage_ms(model, request_images(views, r)[0], pts, K, params,
                       dev) for r in range(3)]
    med = {k: sorted(s[k] for s in stages)[1] for k in stages[0]}
    print(f"(l1) {network}: {N_REQUESTS} plain requests of {BATCH} images, "
          f"latency ms {[round(v, 3) for v in latencies]}, launches "
          f"{counts}; stage ms (median of 3) "
          + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
          + f"; {SMI}", flush=True)

    # card vs CPU: the FCN on 2 images, then (k2)'s rules from the card's
    # fields
    imgs = torch.from_numpy(request_images(views, 2)[0][:FAMILY_CPU_IMAGES])
    with torch.no_grad():
        seg_g, ver_g = model(pl.normalize_images(imgs.to(dev)).permute(
            0, 3, 1, 2).contiguous())
        cpu = build_model(network, ver_dim=2 * VN)
        cpu.load_state_dict({k: v.cpu()
                             for k, v in model.state_dict().items()})
        seg_c, ver_c = cpu.eval()(pl.normalize_images(imgs).permute(
            0, 3, 1, 2).contiguous())
    agree = float((seg_g.argmax(1).cpu() == seg_c.argmax(1)).double()
                  .mean())
    errs = [float((g.cpu() - c).abs().max() / c.abs().max())
            for g, c in ((seg_g, seg_c), (ver_g, ver_c))]
    print(f"(l1) {network} FCN card vs CPU on {FAMILY_CPU_IMAGES} images "
          f"(f32, no TF32): argmax agrees on {agree:.6f} of the pixels, "
          f"seg / ver max diff {errs[0]:.2e} / {errs[1]:.2e} of their max "
          f"abs", flush=True)
    assert agree >= 0.999 and max(errs) < 1e-3, (agree, errs)
    card_vs_cpu(f"(l1) {network}", seg_g.argmax(1), ver_g, 1,
                fixture["points_3d"][None].astype(np.float32),
                fixture["K"].astype(np.float32), gen, dev, strict=False)
    del model, cpu
    torch.cuda.empty_cache()


def run_synthetic_training(tmp, kernels):
    """(l2) ``python -m pvnet_tpu_torch.train --synthetic`` in a process of
    its own: configs/synthetic_train.json (bf16, b=16) with pose
    evaluation from epoch 0, 480x640, a 64-image split, the backbone from
    a synthesized resnet18 checkpoint; 10 epochs of 2 steps. Checks: the
    step count, K4 twice a step, K1 and K3 in the validations, finite
    losses."""
    import numpy as np
    with open(RECIPE) as f:
        recipe = json.load(f)
    recipe.update(eval_epoch=True, eval_epoch_begin=0)
    cfg_file = os.path.join(tmp, "recipe.json")
    with open(cfg_file, "w") as f:
        json.dump(recipe, f)
    pth = os.path.join(tmp, "resnet18.pth")
    synthesized_backbone("resnet18", pth, FAMILY_SEED)
    cmd = [sys.executable, "-m", "pvnet_tpu_torch.train", "--synthetic",
           "--device_data", "--cfg_file", cfg_file,
           "--synthetic_images", str(SYNTH_IMAGES),
           "--epochs", str(SYNTH_EPOCHS), "--buckets", f"{H}x{W}",
           "--imagenet_pth", pth, "--data_dir", os.path.join(tmp, "data"),
           "--model_dir", os.path.join(tmp, "model"), "--device", DEVICE]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
    assert proc.returncode == 0, f"(l2) the training CLI exited " \
        f"{proc.returncode}"
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    epochs = summary["epochs"]
    steps = sum(e["steps"] for e in epochs)
    losses = [x for e in epochs for x in e["losses"]]
    launches = summary["launches"]
    pose_evals = [line for line in proc.stdout.splitlines()
                  if line.startswith("ADD metric")]
    batch = recipe["train_batch_size"]
    per_epoch = max(summary["train_images"], batch) // batch
    assert len(epochs) == SYNTH_EPOCHS, epochs
    assert steps == per_epoch * SYNTH_EPOCHS, epochs
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert launches["shift_lanes"] == 2 * steps, launches
    assert launches["stratified_select_cmajor"] >= 1, launches
    assert launches["count_inliers"] >= 1, launches
    assert len(pose_evals) == 2, pose_evals     # epochs 0 and 5
    add_launches(kernels, launches)
    step_ms = [e["seconds"] / e["steps"] * 1e3 for e in epochs]
    print(f"(l2) python -m pvnet_tpu_torch.train --synthetic: "
          f"{summary['train_images']} train / {summary['val_images']} val "
          f"images at {H}x{W}, generated in {summary['generate_s']:.2f} s; "
          f"{steps} {'bf16' if recipe['bf16'] else 'f32'} steps of "
          f"b={batch} from the synthesized resnet18 "
          f"backbone; epoch s {[round(e['seconds'], 3) for e in epochs]}; "
          f"step ms (epoch s / steps, epoch 0 with cuDNN's tuning) "
          f"{[round(v, 1) for v in step_ms]}; loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; pose evaluations {pose_evals}; launches "
          f"{launches}; the process took {wall:.1f} s; {SMI}", flush=True)


def run_study(dev, tmp, kernels):
    """(l3) the multi-class study at reduced depth (64 + 16 scenes, 10
    epochs, 360x480), in this process: finite losses, the last epoch's
    below the first's, K1 and K3 once per class in the evaluation; the
    rates printed."""
    import numpy as np
    from pvnet_tpu_torch import multiclass_study as MS
    out = os.path.join(tmp, "study")
    reset_counters()
    t0 = time.time()
    assert MS.main(STUDY_ARGS + ["--out_dir", out, "--device",
                                 str(dev)]) == 0
    wall = time.time() - t0
    counts = read_counters()
    with open(os.path.join(out, "metrics.json")) as f:
        metrics = json.load(f)
    loss = metrics["epoch_loss"]
    assert all(np.isfinite(loss)) and loss[-1] < loss[0], loss
    assert counts["stratified_select_cmajor"] == 3, counts
    assert counts["count_inliers"] == 3, counts
    add_launches(kernels, counts)
    print(f"(l3) the study ({' '.join(STUDY_ARGS)}): epoch loss "
          f"{[round(v, 4) for v in loss]}; seg accuracy "
          f"{metrics['seg_accuracy']}; per class (2D, ADD(-S), 5cm5deg) "
          + "; ".join(f"{r['class']} {r['metric']} {r['proj']} {r['add']} "
                      f"{r['cm5deg5']}" for r in metrics["rows"])
          + f"; generation {metrics['generate_s']:.1f} s, training "
          f"{metrics['train_s']:.1f} s, evaluation {metrics['eval_s']:.1f} "
          f"s, in all {wall:.1f} s; launches {counts}; {SMI}", flush=True)


def run_family(dev, fixture, kernels):
    """Phase (l): the model family, --synthetic training and the study
    (see the module docstring)."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        for network in FAMILY:
            run_family_model(dev, fixture, kernels, network, tmp)
        run_synthetic_training(tmp, kernels)
        run_study(dev, tmp, kernels)
    torch.cuda.empty_cache()


# --- phase (m): LINEMOD from disk --------------------------------------------

LINEMOD_MINI = os.path.join(REPO, "assets", "linemod_mini")
M_STEPS = 6               # (m4): training steps of the CLI
M_SEEDS = (0, 1, 2)       # (m5): RANSAC seeds of --test_model
M_POOL = 8                # (m2): host threads of the entropy decoder
# the decode kernel's arithmetic in 32-bit operations (the least it
# needs, the bound's count; kept as it was when the bound was first
# written, so that its shares compare across kernels): per 8x8 block, 64
# dequantizing multiplies and 16 one-dimensional passes of 12 multiplies,
# 32 adds and subtracts, 8 rounding adds and 8 shifts, and 128
# saturations; per output pixel, each upsampled chroma sample 9
# operations (h2v2: two column sums of a multiply and an add, the weighted
# sum, its bias and shift, four index clamps) and the colour conversion 15
# (three products, five adds, three shifts, three clamps and the gray
# copy's select)
DECODE_OPS_PER_BLOCK = 64 + 16 * (12 + 32 + 8 + 8) + 128
DECODE_OPS_PER_CHROMA = 9
DECODE_OPS_PER_PIXEL = 15
# the kernel's halo work in the same operations: one 8-point pass with its
# saturations 68, one output of a pass alone (csrc/jpeg_decode.cu's
# idct_edge: 7 for the even part, 12 for the odd, the sum, rounding and
# shift, the saturation) 23; a halo row block 64 dequantizing multiplies,
# 8 one-output column passes and a row pass; a halo column block 64, 8
# column passes and 8 one-output row passes; a corner 64 and 9 one-output
# passes
DECODE_HALO_OPS = (64 + 8 * 23 + 68, 64 + 8 * 68 + 8 * 23, 64 + 9 * 23)
# (m3): batch sizes timed (one frame is what serving and the streamed
# training routes launch)
M3_BATCHES = (1, 8, 24)


def reset_all_counters():
    """Every kernel wrapper's launch count (K1-K5 and the JPEG decoder's
    pixel stage) to 0."""
    from pvnet_tpu_torch.ops import kernel_lib
    for fn in kernel_lib.launch_counters().values():
        fn.launches = 0


def read_all_counters():
    from pvnet_tpu_torch.ops import kernel_lib
    return kernel_lib.launch_counts()


def decode_bound_ms(geo, batch: int):
    """(bound ms, 'bytes' or 'operations') of jpeg_pixels on ``batch``
    images of geometry ``geo``: int16 coefficients and int32 tables read
    once and uint8 RGB written once over the memory rate, against
    DECODE_OPS_* over the instruction rate."""
    nbytes = batch * (geo.total_blocks() * 64 * 2 + geo.nc * 64 * 4
                      + geo.height * geo.width * 3)
    pixels = geo.height * geo.width
    ops = batch * (geo.total_blocks() * DECODE_OPS_PER_BLOCK
                   + pixels * ((geo.nc - 1) * DECODE_OPS_PER_CHROMA
                               + DECODE_OPS_PER_PIXEL))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def decode_halo_share(geo, batch: int) -> float:
    """The kernel's halo work over its own blocks' at ``geo`` in a launch
    of ``batch`` images, in the operations of DECODE_OPS_PER_BLOCK and
    DECODE_HALO_OPS, from the launch plan's block counts
    (image_io.tile_blocks)."""
    from pvnet_tpu_torch.data import image_io as IO
    own, rows, cols, corners = IO.tile_blocks(geo, batch)
    halo = sum(n * w for n, w in zip((rows, cols, corners), DECODE_HALO_OPS))
    return halo / (own * DECODE_OPS_PER_BLOCK)


def served_decode_split(dev, blob, reps: int = 20):
    """Medians (ms, host clock after a synchronize) of one served JPEG
    request's decode (serve.py's decode_rgb_bytes): host entropy decoding,
    the upload of coefficients and tables, the pixel kernel's launch to
    its end, the RGB frame's copy back, and the whole of it."""
    import statistics
    import torch
    from pvnet_tpu_torch.data import image_io as IO
    parts = {k: [] for k in ("entropy", "upload", "kernel", "readback",
                             "whole")}
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = IO.jpeg_coefficients_native(blob)
        t1 = time.perf_counter()
        coef = torch.from_numpy(c.coef[None]).to(dev)
        qt = torch.from_numpy(c.qt[None]).to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rgb = IO.jpeg_pixels(coef, qt, c.geometry)[0]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        rgb.cpu()
        t4 = time.perf_counter()
        IO.decode_rgb_bytes(blob, "request", dev).cpu()
        t5 = time.perf_counter()
        for v, dt in zip(parts.values(), (t1 - t0, t2 - t1, t3 - t2,
                                          t4 - t3, t5 - t4)):
            v.append(dt * 1e3)
    # the first round warms up
    return {k: statistics.median(v[1:]) for k, v in parts.items()}


def check_decoder(dev, root, manifest):
    """(m1)-(m3): every file of the tree decoded on the card equal to the
    manifest's sha256 of the JAX readers' output; the C entropy decoder
    against the plain Python one on 2 files (coefficients and tables); the
    CUDA pixel stage against its plain PyTorch version on all 24 frames
    (exact); host and device times. Returns the kernel's JSON entry."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import numpy as np
    import torch
    from pvnet_tpu_torch.data import image_io as IO

    t0 = time.time()
    for rel, e in sorted(manifest["files"].items()):
        p = os.path.join(root, rel)
        a = (IO.read_rgb(p, dev).cpu().numpy() if e["reader"] == "rgb"
             else IO.read_mask(p, dev))
        got = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
        assert got == e["sha256"] and list(a.shape) == e["shape"], \
            f"(m1) {rel} decoded on the card differs from the JAX reader's"
    torch.cuda.synchronize()
    print(f"(m1) {len(manifest['files'])} files of {LINEMOD_MINI} decoded "
          f"on the card (C entropy decoder and PNG unfilter, CUDA pixel "
          f"stage), each equal to the sha256 of the JAX package's "
          f"read_rgb_np / read_mask_np output, in {time.time() - t0:.2f} s",
          flush=True)
    frames = sorted(os.path.join(root, rel) for rel in manifest["files"]
                    if rel.startswith(os.path.join("LINEMOD", "duck",
                                                   "JPEGImages")))
    blobs = [open(p, "rb").read() for p in frames]
    for p, blob in zip(frames[:2], blobs[:2]):
        a = IO.jpeg_coefficients_plain(blob, p)
        b = IO.jpeg_coefficients_native(blob, p)
        assert a.geometry == b.geometry and np.array_equal(a.coef, b.coef) \
            and np.array_equal(a.qt, b.qt), f"(m2) {p}: C != Python"
    coefs = [IO.jpeg_coefficients_native(b) for b in blobs]
    geo = coefs[0].geometry
    assert all(c.geometry == geo for c in coefs)
    n = len(coefs)
    coef = torch.from_numpy(np.stack([c.coef for c in coefs])).to(dev)
    qt = torch.from_numpy(np.stack([c.qt for c in coefs])).to(dev)
    got = IO.jpeg_pixels(coef, qt, geo)
    want = IO.jpeg_pixels_plain(coef, qt, geo)
    torch.cuda.synchronize()
    err = float((got.int() - want.int()).abs().max())
    assert err == 0.0 and torch.equal(got, want), \
        "(m3) the CUDA pixel stage differs from its plain version"
    # host: the C entropy decoder alone, then on a pool of threads
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        for b in blobs:
            IO.jpeg_coefficients_native(b)
    host_ms = (time.perf_counter() - t0) / (reps * n) * 1e3
    with ThreadPoolExecutor(M_POOL) as pool:
        list(pool.map(IO.jpeg_coefficients_native, blobs))
        t0 = time.perf_counter()
        list(pool.map(IO.jpeg_coefficients_native, blobs * 4 * reps))
        pool_fps = 4 * reps * n / (time.perf_counter() - t0)
    plain_ms = cuda_ms(lambda: IO.jpeg_pixels_plain(coef, qt, geo), iters=5)
    print(f"(m2) C entropy decoder == plain Python (coefficients, tables) "
          f"on {frames[0]} and {frames[1]}; host entropy decoding "
          f"{host_ms:.3f} ms per {geo.height}x{geo.width} frame on one "
          f"thread, {pool_fps:.1f} frames/s on {M_POOL} threads", flush=True)
    print(f"(m3) jpeg_pixels (CUDA) == jpeg_pixels_plain on the {n} frames "
          f"({geo.height}x{geo.width}, sampling h={list(geo.h)} "
          f"v={list(geo.v)}), exact; plain {plain_ms:.4f} ms for {n}; the "
          f"launch plan's halo work {decode_halo_share(geo, 1):.1%} of the "
          f"own blocks' at b=1, {decode_halo_share(geo, n):.1%} at b={n} "
          f"(blocks own, row, column, corner a frame: "
          f"{IO.tile_blocks(geo, 1)}, {IO.tile_blocks(geo, n)})", flush=True)
    # warm: 50 launches on the same inputs; cold: the inputs rotated over
    # copies past the L2 (the output stays one tensor)
    times = {}
    for b in M3_BATCHES:
        args = coef[:b].contiguous(), qt[:b].contiguous()
        warm = cuda_ms(lambda: IO.jpeg_pixels(*args, geo), iters=50)
        copies = [(args[0].clone(), args[1].clone())
                  for _ in range(L2_BYTES // _nbytes(args) + 1)]
        res = torch.empty((b, geo.height, geo.width, 3), dtype=torch.uint8,
                          device=dev)
        cold = cold_ms(lambda x: IO.jpeg_pixels(*x, geo, out=res), copies)
        del copies
        bound, by = decode_bound_ms(geo, b)
        times[b] = warm, cold, bound, by
        before = BEFORE_MS.get(f"jpeg_pixels b={b}")
        print(f"(m3) jpeg_pixels b={b}: warm {warm:.4f} ms "
              f"({bound / warm:.1%} of the bound), cold {cold:.4f} ms "
              f"({bound / cold:.1%}); bound {bound:.4f} ms ({by})"
              + (f"; before the redesign {before}" if before else "")
              + f"; {SMI}", flush=True)
    split = served_decode_split(dev, blobs[0])
    print(f"(m3) one served JPEG request's decode ({geo.height}x"
          f"{geo.width}, host clock, medians of 20): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in split.items())
          + f"; the kernel's device time {times[1][0]:.4f} ms", flush=True)
    ms, cold, bound, by = times[n]
    return {"name": "jpeg_pixels", "route": "cuda",
            "source": "pvnet_tpu_torch/csrc/jpeg_decode.cu",
            "replaces": "pvnet_tpu/data/linemod.py:43",
            "launches": 0, "max_abs_err": err, "ms": ms, "cold_ms": cold,
            "one_frame_ms": times[1][0], "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


# (m3): geometries of the pixel kernel besides the frames' 4:2:0 480x640:
# (height, width, h factors, v factors); the last with coefficients and
# tables at their extremes (the 16-bit wrap and both saturations)
DECODE_GEOMETRIES = [(37, 53, (1, 1, 1), (1, 1, 1)),
                     (37, 53, (2, 1, 1), (1, 1, 1)),
                     (37, 53, (2, 1, 1), (2, 1, 1)),
                     (17, 3, (2, 1, 1), (2, 1, 1)),
                     (9, 2, (2, 1, 1), (1, 1, 1)),
                     (1, 1, (2, 1, 1), (2, 1, 1)),
                     (61, 83, (1,), (1,)),
                     (40, 72, (2, 2, 2), (1, 1, 1)),
                     (481, 647, (2, 1, 1), (2, 1, 1)),
                     (480, 640, (2, 1, 1), (1, 1, 1)),
                     (480, 640, (1, 1, 1), (1, 1, 1)),
                     (480, 640, (1,), (1,)),
                     (32, 32, (2, 2, 2), (2, 2, 2)),
                     (24, 2100, (2, 1, 1), (2, 1, 1)),
                     (17, 2100, (2, 1, 1), (1, 1, 1)),
                     (256, 256, (2, 1, 1), (2, 1, 1))]


def check_decoder_geometries(dev):
    """(m3) jpeg_pixels against its plain version on random coefficients
    at DECODE_GEOMETRIES, b=3, exact; the last also at the extremes."""
    import torch
    from pvnet_tpu_torch.data import image_io as IO
    g = torch.Generator().manual_seed(12)
    for i, (h, w, hs, vs) in enumerate(DECODE_GEOMETRIES):
        geo = IO.JpegGeometry(h, w, hs, vs)
        for extreme in ((False, True) if i == len(DECODE_GEOMETRIES) - 1
                        else (False,)):
            n = geo.total_blocks()
            if extreme:
                coef = torch.randint(-32768, 32768, (3, n, 64), generator=g)
                qt = torch.randint(1, 65536, (3, geo.nc, 64), generator=g)
            else:
                coef = (torch.randn(3, n, 64, generator=g)
                        * torch.linspace(300, 5, 64)).round()
                coef[..., 0] = torch.randint(-1024, 1024, (3, n),
                                             generator=g)
                qt = torch.randint(1, 100, (3, geo.nc, 64), generator=g)
            coef = coef.to(torch.int16).to(dev)
            qt = qt.to(torch.int32).to(dev)
            got = IO.jpeg_pixels(coef, qt, geo)
            want = IO.jpeg_pixels_plain(coef, qt, geo)
            assert torch.equal(got, want), \
                f"(m3) jpeg_pixels != plain at {geo}, extreme={extreme}"
    print(f"(m3) jpeg_pixels == jpeg_pixels_plain also on random "
          f"coefficients at {len(DECODE_GEOMETRIES)} geometries (4:4:4, "
          f"4:2:2, 4:2:0, gray, 1 to 3 pixels wide, 481x647, tiles 16 MCUs "
          f"wide, 256x256 also at int16 and 16-bit table extremes), b=3",
          flush=True)


def check_records(root, manifest):
    """(m4): the port's LINEMOD, Occlusion and Truncation records against
    the JAX package's in the manifest (RT to 1e-6, keypoints to 1e-4 px)."""
    import numpy as np
    from pvnet_tpu_torch.config import PathConfig
    from pvnet_tpu_torch.data.linemod import (LineModImageDB,
                                              OcclusionLineModImageDB,
                                              TruncatedLineModImageDB)
    paths = PathConfig(data_dir=root)
    db = LineModImageDB("duck", has_render_set=False, has_fuse_set=False,
                        paths=paths)
    sets = {"real": db.real_set, "test": db.test_real_set + db.val_real_set,
            "occluded": OcclusionLineModImageDB("duck",
                                                paths=paths).test_real_set,
            "truncated": TruncatedLineModImageDB("duck", paths=paths).set}
    worst = {}
    for name, recs in sets.items():
        want = manifest["records"][name]
        assert [r["rgb_pth"] for r in recs] == \
            [w["rgb_pth"] for w in want], f"(m4) {name}: other records"
        rt = kp = 0.0
        for r, w in zip(recs, want):
            rt = max(rt, float(np.abs(np.asarray(r["RT"], np.float64)
                                      - w["RT"]).max()))
            for k in ("corners", "farthest", "center", "small_bbox"):
                kp = max(kp, float(np.abs(np.asarray(r[k], np.float64)
                                          - w[k]).max()))
        assert rt <= 1e-6 and kp <= 1e-4, (name, rt, kp)
        worst[name] = (len(recs), rt, kp)
    print("(m4) records equal the JAX package's (count, max |RT| diff, max "
          "keypoint px diff): " + "; ".join(
              f"{k} {v[0]}, {v[1]:.2e}, {v[2]:.2e}"
              for k, v in worst.items()), flush=True)


def run_quiet(main, argv):
    """``main(argv)`` of a CLI in this process; returns its standard output
    (the exit code must be 0)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0, buf.getvalue()[-3000:]
    return buf.getvalue()


def run_cli(argv):
    """python -m pvnet_tpu_torch.train ``argv`` in this process; returns
    the JSON object of its last line and the seconds it took."""
    from pvnet_tpu_torch.train import __main__ as T
    t0 = time.time()
    out = run_quiet(T.main, argv)
    wall = time.time() - t0
    return json.loads(out.strip().splitlines()[-1]), wall, out


def linemod_training(dev, root, tmp, kernels):
    """(m5): ``--linemod_cls duck --data_dir <tree> --init <duck ckpt>
    --steps 6 --buckets 480x640`` (the bf16 recipe, b=16: the 12 train
    frames repeated to one batch); finite losses, K4 twice a step, the
    decode kernel launched for the device set and the validations."""
    import numpy as np
    reset_all_counters()
    summary, wall, _ = run_cli([
        "--linemod_cls", "duck", "--data_dir", root, "--init", CKPT,
        "--steps", str(M_STEPS), "--buckets", f"{H}x{W}", "--model_dir",
        os.path.join(tmp, "model"), "--cfg_file", RECIPE, "--device_data",
        "--device", str(dev)])
    counts = read_all_counters()
    losses = [x for e in summary["epochs"] for x in e["losses"]]
    steps = sum(e["steps"] for e in summary["epochs"])
    assert steps == M_STEPS and len(losses) == steps, summary["epochs"]
    assert all(np.isfinite(losses)), losses
    assert counts["shift_lanes"] == 2 * steps, counts
    assert counts["jpeg_pixels"] >= 1, counts
    add_launches(kernels, counts)
    print(f"(m5) python -m pvnet_tpu_torch.train --linemod_cls duck: "
          f"{summary['train_images']} train records, "
          f"{summary['val_images']} val, {steps} bf16 steps at {H}x{W}; "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; epoch s "
          f"{[round(e['seconds'], 3) for e in summary['epochs']]}; "
          f"launches {counts}; {wall:.1f} s in all", flush=True)


def linemod_rates(dev, root, tmp, manifest, kernels):
    """(m6): ``--test_model --occluded --truncated`` with the duck
    checkpoint in float32 for RANSAC seeds 0, 1 and 2; each set's mean
    rates within the JAX reference's range over its seeds widened by two
    images; K1, K3 and the decode kernel launched."""
    import numpy as np
    with open(RECIPE) as f:
        recipe = json.load(f)
    recipe["bf16"] = False
    cfg_file = os.path.join(tmp, "f32.json")
    with open(cfg_file, "w") as f:
        json.dump(recipe, f)
    runs = {}
    reset_all_counters()
    t0 = time.time()
    for seed in M_SEEDS:
        out, _, _ = run_cli([
            "--test_model", "--linemod_cls", "duck", "--data_dir", root,
            "--init", CKPT, "--occluded", "--truncated", "--cfg_file",
            cfg_file, "--vote_seed", str(seed), "--model_dir",
            os.path.join(tmp, "model_test"), "--device", str(dev)])
        for name, r in out["sets"].items():
            runs.setdefault(name, []).append(r)
    wall = time.time() - t0
    counts = read_all_counters()
    # one launch per JPEG of the test list and of the crops (the
    # Occlusion frames are PNG), per seed
    jpegs = len(manifest["records"]["test"]) + len(
        manifest["records"]["truncated"])
    assert counts["stratified_select_cmajor"] >= 1, counts
    assert counts["count_inliers"] >= 1, counts
    assert counts["jpeg_pixels"] == len(M_SEEDS) * jpegs, counts
    add_launches(kernels, counts)
    names = {"val": "test", "occ_val": "occluded", "trun_test": "truncated"}
    assert set(runs) == set(names), runs.keys()
    for name, ref_name in names.items():
        ref = manifest["rates"][ref_name]
        n = ref["images"]
        tol = 2.0 / n
        got = np.array([[r[m] for m in ("proj", "add", "cm")]
                        for r in runs[name]])
        assert all(r["images"] == n for r in runs[name])
        mean = got.mean(0)
        for j, m in enumerate(("proj", "add", "cm")):
            js = [r[m] for r in ref["runs"]]
            print(f"(m6) {name} ({n} images) {m}: seeds {list(M_SEEDS)} "
                  f"{[round(x * n) for x in got[:, j]]} of {n}, mean "
                  f"{mean[j]:.4f}; JAX (CPU) seeds "
                  f"{[round(x * n) for x in js]}; tolerance {tol:.4f}",
                  flush=True)
            assert min(js) - tol <= mean[j] <= max(js) + tol, \
                f"(m6) {name} {m}: mean {mean[j]} outside " \
                f"[{min(js) - tol}, {max(js) + tol}]"
    per_s = sum(r["images"] for rs in runs.values() for r in rs) / sum(
        r["evaluate_s"] for rs in runs.values() for r in rs)
    print(f"(m6) --test_model f32, tail_depth 0, seeds {list(M_SEEDS)}: "
          f"{wall:.1f} s for three runs, {per_s:.1f} images/s in the "
          f"evaluations; launches {counts}; {SMI}", flush=True)


def run_linemod(dev, kernels):
    """Phase (m): the LINEMOD read path from disk (see the module
    docstring)."""
    import shutil
    import tempfile
    import torch
    with open(os.path.join(LINEMOD_MINI, "manifest.json")) as f:
        manifest = json.load(f)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        root = os.path.join(tmp, "data")
        shutil.copytree(LINEMOD_MINI, root)   # the databases write posedb/
        kernels.append(check_decoder(dev, root, manifest))
        check_decoder_geometries(dev)
        check_records(root, manifest)
        linemod_training(dev, root, tmp, kernels)
        linemod_rates(dev, root, tmp, manifest, kernels)
    torch.cuda.empty_cache()


# --- phase (n): dataset preparation ------------------------------------------

N_RENDER = 4              # (n3): views of --type render
N_STEPS = 2               # (n3): bf16 training steps with the render set
N_SYNTH = 16              # (n5): images of the synthetic tree
N_SYNTH_OCC = (0.5, 2)    # (n5): README's occluder probability and clutter
N_ENCODE_EDGES = ((1, 1), (17, 3), (37, 53))      # (n1): edge geometries
N_ENCODE_SEED = 13
PREPARE_MANIFEST = os.path.join(REPO, "assets", "prepare_manifest.json")
# (n4): the seven other Occlusion LINEMOD classes are copies of the duck,
# each moved by its own offset (metres) in the camera frame
OCC_OFFSETS = {"ape": (-0.06, -0.04, 0.00), "can": (0.06, -0.04, 0.02),
               "cat": (-0.06, 0.04, 0.04), "driller": (0.06, 0.04, -0.02),
               "eggbox": (0.00, -0.05, 0.03), "glue": (0.03, 0.00, -0.03),
               "holepuncher": (-0.03, 0.02, 0.01)}
OCC_NUMBERS = {"ape": "001", "can": "004", "cat": "005", "driller": "006",
               "duck": "007", "eggbox": "008", "glue": "009",
               "holepuncher": "010"}


# (n2): the frames truncated (frame 13 of the 24 shows no duck, where
# crop_instance fails in JAX's generator and the port's alike)
N_TRUNC_FRAMES = 13


def truncation_tree(src, dst):
    """A LINEMOD tree under ``dst`` with the duck's mesh, LINEMOD_ORIG
    files and first N_TRUNC_FRAMES frames and masks of the tree ``src``:
    what (n2) truncates."""
    import shutil
    cls_dir = os.path.join(dst, "LINEMOD", "duck")
    for sub in ("JPEGImages", "mask"):
        os.makedirs(os.path.join(cls_dir, sub))
    shutil.copy(os.path.join(src, "LINEMOD", "duck", "duck.ply"), cls_dir)
    shutil.copytree(os.path.join(src, "LINEMOD_ORIG"),
                    os.path.join(dst, "LINEMOD_ORIG"))
    for k in range(N_TRUNC_FRAMES):
        for sub, name in (("JPEGImages", f"{k:06}.jpg"),
                          ("mask", f"{k:04}.png")):
            shutil.copy(os.path.join(src, "LINEMOD", "duck", sub, name),
                        os.path.join(cls_dir, sub))


def occlusion_scene(root):
    """Make the Occlusion LINEMOD tree under ``root`` (which has the duck's)
    hold all eight classes, as ``--type gen_mask`` needs: each other class
    gets the duck's mesh, xyz model and pose files, its centre moved by
    OCC_OFFSETS, so that the eight objects occlude each other."""
    import shutil
    occ = os.path.join(root, "OCCLUSION_LINEMOD")
    duck_poses = os.path.join(occ, "poses", "Duck")
    for cls, off in OCC_OFFSETS.items():
        d = os.path.join(root, "LINEMOD", cls)
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(root, "LINEMOD", "duck", "duck.ply"),
                    os.path.join(d, f"{cls}.ply"))
        d = os.path.join(occ, "models", cls.title())
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(occ, "models", "Duck", "007.xyz"),
                    os.path.join(d, f"{OCC_NUMBERS[cls]}.xyz"))
        d = os.path.join(occ, "poses", cls.title())
        os.makedirs(d, exist_ok=True)
        for name in sorted(os.listdir(duck_poses)):
            with open(os.path.join(duck_poses, name)) as f:
                lines = f.read().split("\n")
            row = lines.index("center:") + 1
            t = [float(v) + o for v, o in zip(lines[row].split(), off)]
            lines[row] = " ".join(f"{v:.9f}" for v in t)
            with open(os.path.join(d, name), "w") as f:
                f.write("\n".join(lines))


def file_digest(path, read_mask=None):
    """The sha256 that assets/prepare_manifest.json holds for a file of
    phase (n): of a PNG its decoded pixels (int32, what
    np.asarray(Image.open(p), np.int32) gives; ``read_mask`` decodes), of
    a pickle its arrays (dtype, shape and bytes of each, a list in its
    order, a dict by sorted key), of any other file its bytes."""
    import hashlib
    import pickle
    import numpy as np
    h = hashlib.sha256()
    if path.endswith(".png"):
        a = np.ascontiguousarray(read_mask(path), np.int32)
        h.update(str(a.shape).encode() + a.tobytes())
    elif path.endswith(".pkl"):
        with open(path, "rb") as f:
            obj = pickle.load(f)
        items = obj if isinstance(obj, list) else [obj[k]
                                                    for k in sorted(obj)]
        for a in items:
            a = np.ascontiguousarray(a)
            h.update(str(a.dtype).encode() + str(a.shape).encode()
                     + a.tobytes())
    else:
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def tree_digests(root, sub, read_mask):
    """{path relative to root: file_digest} of every file under root/sub
    (posedb/ caches excepted)."""
    out = {}
    for d, _, files in os.walk(os.path.join(root, sub)):
        for f in files:
            p = os.path.join(d, f)
            rel = os.path.relpath(p, root)
            if "posedb" not in rel.split(os.sep):
                out[rel] = file_digest(p, read_mask)
    return dict(sorted(out.items()))


def encode_edge_images():
    """(n1)'s edge images: {'HxW': uint8 [h, w, 3] noise} from one seed."""
    import numpy as np
    rng = np.random.RandomState(N_ENCODE_SEED)
    return {f"{h}x{w}": rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in N_ENCODE_EDGES}


def check_encoder(dev, root, manifest):
    """(n1): the C encoder against its plain version, byte for byte, and
    both against PIL's bytes (the manifest's sha256), on the 24 duck
    frames as decoded on the card and on the edge images; host ms a frame
    on one thread and frames/s on M_POOL threads. Returns the C encoder's
    ms a frame."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    from pvnet_tpu_torch.data import image_io as IO
    want = manifest["encode"]
    frames = {f: IO.read_rgb(os.path.join(root, "LINEMOD", "duck",
                                          "JPEGImages", f), dev).cpu().numpy()
              for f in sorted(want["frames"])}
    cases = [(f, a, want["frames"][f]) for f, a in frames.items()]
    cases += [(k, a, want["edges"][k])
              for k, a in encode_edge_images().items()]
    t_plain = 0.0
    for name, a, sha in cases:
        got = IO.encode_jpeg(a, dev)
        t0 = time.perf_counter()
        plain = IO.jpeg_encode_plain(a)
        t_plain += time.perf_counter() - t0
        assert got == plain, f"(n1) {name}: C encoder != plain encoder"
        assert hashlib.sha256(got).hexdigest() == sha, \
            f"(n1) {name}: the encoder's bytes differ from PIL's"
    imgs = list(frames.values())
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        for a in imgs:
            IO.jpeg_encode_native(a)
    ms = (time.perf_counter() - t0) / (reps * len(imgs)) * 1e3
    with ThreadPoolExecutor(M_POOL) as pool:
        list(pool.map(IO.jpeg_encode_native, imgs))
        t0 = time.perf_counter()
        list(pool.map(IO.jpeg_encode_native, imgs * 4 * reps))
        fps = 4 * reps * len(imgs) / (time.perf_counter() - t0)
    h, w = imgs[0].shape[:2]
    print(f"(n1) C JPEG encoder == plain encoder == PIL's bytes (sha256) on "
          f"the {len(imgs)} duck frames decoded on the card and at "
          f"{', '.join(want['edges'])}; C {ms:.3f} ms per {h}x{w} frame on "
          f"one host thread, {fps:.1f} frames/s on {M_POOL} threads; plain "
          f"{t_plain / len(cases) * 1e3:.1f} ms a case; {SMI}", flush=True)
    return ms


def check_digests(got, want, what):
    assert sorted(got) == sorted(want), \
        f"{what}: other files {sorted(set(got) ^ set(want))[:6]}"
    bad = [k for k in want if got[k] != want[k]]
    assert not bad, f"{what}: {len(bad)} files differ from JAX's, e.g. " \
        f"{bad[:4]}"


def run_prepare_cli(argv):
    """python -m pvnet_tpu_torch.prepare ``argv`` in this process; returns
    the seconds it took."""
    import contextlib
    import io
    from pvnet_tpu_torch import prepare
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = prepare.main(argv)
    assert rc == 0, f"prepare {argv} exited {rc}"
    return time.time() - t0


def generated_frame_ms(dev, occ, clutter, frames=4):
    """(render ms, encode ms) of one generated frame of the synthetic tree
    on one host thread: the z-buffer render of the duck with its
    distractors, and its JPEG encoding on ``dev``; means over ``frames``."""
    import numpy as np
    from pvnet_tpu_torch.config import LINEMOD_K
    from pvnet_tpu_torch.data import image_io as IO
    from pvnet_tpu_torch.data import synthetic as S
    rng = np.random.RandomState(1)
    dmeshes = [S.make_distractor_mesh(rng) for _ in range(8)]
    mesh = S.make_duck_mesh()
    render = encode = 0.0
    for _ in range(frames):
        pose = S.sample_object_pose(rng)
        distractors = S.sample_distractors(pose, rng, dmeshes, occ, clutter)
        t0 = time.perf_counter()
        rgb, _ = S.render_synthetic_view(mesh, pose, LINEMOD_K, H, W, rng,
                                         distractors)
        t1 = time.perf_counter()
        IO.encode_jpeg(rgb, dev)
        render += t1 - t0
        encode += time.perf_counter() - t1
    return render / frames * 1e3, encode / frames * 1e3


def run_preparation(dev, kernels):
    """Phase (n): dataset preparation on a copy of assets/linemod_mini (see
    the module docstring)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from pvnet_tpu_torch.data import image_io as IO
    from pvnet_tpu_torch.data.synthetic import write_synthetic_linemod
    with open(PREPARE_MANIFEST) as f:
        manifest = json.load(f)

    def read_mask(p):
        return IO.read_mask(p, dev)

    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        root = os.path.join(tmp, "data")
        shutil.copytree(LINEMOD_MINI, root)
        enc_ms = check_encoder(dev, root, manifest)
        # (n2)
        trunc = os.path.join(tmp, "trunc")
        truncation_tree(root, trunc)
        trunc_s = run_prepare_cli(["--type", "truncated", "--data_dir", trunc,
                                   "--device", str(dev)])
        check_digests(tree_digests(trunc, "LINEMOD/truncated", read_mask),
                      manifest["truncated"], "(n2) --type truncated")
        print(f"(n2) python -m pvnet_tpu_torch.prepare --type truncated: "
              f"{N_TRUNC_FRAMES} frames cropped in {trunc_s:.2f} s; "
              f"{len(manifest['truncated'])} files equal JAX's (JPEG bytes, "
              f"PNG pixels, pickled pose and K)", flush=True)
        # (n3)
        render_s = run_prepare_cli(["--type", "render", "--linemod_cls",
                                    "duck", "--num", str(N_RENDER),
                                    "--data_dir", root, "--device", str(dev)])
        check_digests(tree_digests(root, "LINEMOD/renders", read_mask),
                      manifest["render"], "(n3) --type render")
        reset_all_counters()
        summary, wall, _ = run_cli([
            "--linemod_cls", "duck", "--data_dir", root, "--init", CKPT,
            "--steps", str(N_STEPS), "--buckets", f"{H}x{W}", "--model_dir",
            os.path.join(tmp, "model"), "--cfg_file", RECIPE,
            "--device_data", "--device", str(dev)])
        counts = read_all_counters()
        losses = [x for e in summary["epochs"] for x in e["losses"]]
        steps = sum(e["steps"] for e in summary["epochs"])
        with open(os.path.join(root, "LINEMOD", "duck", "train.txt")) as f:
            n_real = sum(1 for line in f if line.strip())
        assert summary["train_images"] == N_RENDER + n_real, summary
        assert steps == N_STEPS and len(losses) == steps, summary["epochs"]
        assert all(np.isfinite(losses)), losses
        assert counts["shift_lanes"] == 2 * steps, counts
        assert counts["jpeg_pixels"] >= 1, counts
        add_launches(kernels, counts)
        step_ms = [e["seconds"] / e["steps"] * 1e3 for e in summary["epochs"]]
        print(f"(n3) --type render --num {N_RENDER}: rendered in "
              f"{render_s:.2f} s, {len(manifest['render'])} files equal "
              f"JAX's (16-bit depth PNGs by their pixels); --linemod_cls duck "
              f"with the render set: {summary['train_images']} train records "
              f"({N_RENDER} render + {n_real} real), {steps} bf16 steps at "
              f"{H}x{W}, loss {losses[0]:.5f} -> {losses[-1]:.5f}, epoch ms "
              f"a step {[round(v, 1) for v in step_ms]} (the first with "
              f"cuDNN's tuning); launches {counts}; {wall:.1f} s; {SMI}",
              flush=True)
        # (n4)
        occlusion_scene(root)
        mask_s = run_prepare_cli(["--type", "gen_mask", "--data_dir", root,
                                  "--device", str(dev)])
        check_digests(tree_digests(root, "OCCLUSION_LINEMOD/masks_gen",
                                   read_mask),
                      manifest["gen_mask"], "(n4) --type gen_mask")
        fps_s = run_prepare_cli(["--type", "fps", "--linemod_cls", "duck",
                                 "--data_dir", root, "--device", str(dev)])
        check_digests({k: file_digest(os.path.join(root, k))
                       for k in manifest["fps"]}, manifest["fps"],
                      "(n4) --type fps")
        print(f"(n4) --type gen_mask: {len(manifest['gen_mask'])} masks of "
              f"8 classes equal JAX's in {mask_s:.2f} s; --type fps: "
              f"farthest.txt equal in {fps_s:.2f} s", flush=True)
        # (n5)
        occ, clutter = N_SYNTH_OCC
        synth_dir = os.path.join(tmp, "synth")
        synth = os.path.join(synth_dir, "synthetic_occ")
        t0 = time.time()
        write_synthetic_linemod(synth, "duck", num_images=N_SYNTH,
                                occluder_prob=occ, max_clutter=clutter,
                                device=dev,
                                workers=len(os.sched_getaffinity(0)))
        synth_s = time.time() - t0
        check_digests(tree_digests(synth, "", read_mask),
                      manifest["synthetic"], "(n5) write_synthetic_linemod")
        render_ms, encode_ms = generated_frame_ms(dev, occ, clutter)
        reset_all_counters()
        out, wall, _ = run_cli([
            "--test_model", "--synthetic", "--synthetic_images",
            str(N_SYNTH), "--synthetic_occluder_prob", str(occ),
            "--synthetic_clutter", str(clutter), "--init", CKPT,
            "--data_dir", synth_dir, "--model_dir",
            os.path.join(tmp, "model_test"), "--cfg_file", RECIPE,
            "--device", str(dev)])
        counts = read_all_counters()
        rates = out["sets"]["val"]
        n_test = N_SYNTH - max(1, int(N_SYNTH * 0.5))
        assert out["generate_s"] == 0.0, out      # the tree was there
        assert rates["images"] == n_test, rates
        assert counts["stratified_select_cmajor"] >= 1, counts
        assert counts["count_inliers"] >= 1, counts
        assert counts["jpeg_pixels"] == n_test, counts
        add_launches(kernels, counts)
        print(f"(n5) write_synthetic_linemod({N_SYNTH} images, occluder_prob "
              f"{occ}, clutter {clutter}): {len(manifest['synthetic'])} files "
              f"equal JAX's tree, written in {synth_s:.2f} s; one generated "
              f"{H}x{W} frame on one host thread: render {render_ms:.1f} ms, "
              f"JPEG encoding {encode_ms:.2f} ms ("
              f"{100 * encode_ms / (render_ms + encode_ms):.1f} %); --synthetic "
              f"--test_model on its {n_test} JPEG test frames: proj "
              f"{rates['proj']:.4f} add {rates['add']:.4f} cm "
              f"{rates['cm']:.4f}; launches {counts}; {wall:.1f} s",
              flush=True)
        print(f"(n) encoder {enc_ms:.3f} ms a frame; render {render_s:.2f} s "
              f"for {N_RENDER} views; truncation {trunc_s:.2f} s for "
              f"{N_TRUNC_FRAMES} frames; {SMI}", flush=True)
    torch.cuda.empty_cache()


# --- phase (o): the demo, the gallery, intermediate results, the gather
# warp route, the packed tail and stem behind resnet34/50 --------------------

DEMO_DIR = os.path.join(REPO, "assets", "demo_mini")
O_HYP = 512               # (o1)-(o3): the tools' --hyp_num
O_SEED = 29
O_ROT = 90.0              # (o5): the recipe's rotation range, +-degrees
O_STEPS = 2               # (o5): timed bf16 training steps


def demo_draws(dev, gen, h, w, hn):
    import torch
    return (torch.rand((1, h, w), generator=gen, device=dev),
            torch.rand((1, hn, 2), generator=gen, device=dev))


def held_poses(tag, pose_g, pose_c):
    """Card and CPU poses within 0.05 deg / 1 mm (float64 angles)."""
    import torch
    rot, trans = pose_errors(torch.as_tensor(pose_g), torch.as_tensor(pose_c))
    assert float(rot.max()) < 0.05 and float(trans.max()) < 1e-3, \
        f"{tag}: poses differ by {float(rot.max()):.3e} deg, " \
        f"{float(trans.max()):.3e} m"
    return float(rot.max()), float(trans.max())


def demo_card_vs_cpu(tag, data, mask, vertex, dev, gen):
    """tools/demo.py's voting and PnP (demo.run_demo) on the card and on
    the CPU from the same fields and draws: selection, hypotheses and
    counts equal, keypoints within 1e-2 px, poses within 0.05 deg / 1 mm,
    corners within 1e-2 px."""
    import torch
    from pvnet_tpu_torch import demo
    from pvnet_tpu_torch.ops import voting

    noise, pair = demo_draws(dev, gen, H, W, O_HYP)
    outs, parts = [], []
    with torch.no_grad():
        for where in (dev, torch.device("cpu")):
            m, v = mask.to(where), vertex.float().to(where)
            nz, pu = noise.to(where), pair.to(where)
            fg = voting.sample_foreground(m, v, 1024, nz)
            hyps = voting.generate_hypotheses(fg, O_HYP, pu)
            counts = voting.count_inliers(fg, hyps, 0.99)
            parts.append([t.cpu() for t in (*fg[:3], hyps, counts)])
            outs.append(demo.run_demo(data, m, v, O_HYP, noise=nz,
                                      pair_u=pu))
    for name, a, b in zip(("coords", "dirs", "valid", "hyps", "counts"),
                          *parts):
        assert torch.equal(a, b), f"{tag}: card != CPU on {name}"
    g, c = outs
    kd = float(abs(g["kps"] - c["kps"]).max())
    cd = float(abs(g["corners_pred"] - c["corners_pred"]).max())
    rot, trans = held_poses(tag, g["pose"], c["pose"])
    print(f"{tag} card vs CPU, same fields and draws: selection, hypotheses "
          f"and counts equal; keypoints max diff {kd:.3e} px, pose "
          f"{rot:.3e} deg / {trans:.3e} m, corners {cd:.3e} px", flush=True)
    assert kd < 1e-2 and cd < 1e-2
    return g


def run_demo_phase(dev, tmp, kernels, tag, checkpoint=None):
    """(o1) / (o2): ``python -m pvnet_tpu_torch.demo`` on the card (its
    launches counted: K1 and K3 once, the JPEG decoder once), then the
    same voting card vs CPU, the GT pose error, and the written PNG
    decoded back against the drawing."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import demo, pipeline as pl
    from pvnet_tpu_torch.data.image_io import read_rgb
    from pvnet_tpu_torch.infer import load_model
    from pvnet_tpu_torch.utils import viz

    out_png = os.path.join(tmp, f"demo_{tag[1:3]}.png")
    argv = ["--demo_dir", DEMO_DIR, "--device", str(dev), "--output",
            out_png, "--seed", str(O_SEED)]
    if checkpoint:
        argv += ["--checkpoint", checkpoint]
    reset_all_counters()
    t0 = time.perf_counter()
    printed = run_quiet(demo.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_all_counters()
    assert counts["stratified_select_cmajor"] == 1, counts
    assert counts["count_inliers"] == 1, counts
    assert counts["jpeg_pixels"] == 1, counts
    add_launches(kernels, counts)
    lines = printed.strip().splitlines()
    assert lines[0].startswith("pose error: "), printed

    data = demo.load_demo(DEMO_DIR, dev)
    mask, vertex = demo.demo_fields(data, dev, checkpoint)
    if checkpoint:
        # the FCN card vs CPU on the frame, as (l1)
        with torch.no_grad():
            cpu = load_model(checkpoint, VN, "cpu")
            mask_c, vertex_c = pl.predict_fields(
                cpu, pl.normalize_images(data["rgb_t"].cpu()[None]))
        agree = float((mask.cpu() == mask_c).double().mean())
        rel = float((vertex.cpu() - vertex_c).abs().max()
                    / vertex_c.abs().max())
        print(f"{tag} FCN card vs CPU (f32, no TF32): mask equal on "
              f"{agree:.6f} of the pixels, field max diff {rel:.2e} of its "
              f"max abs", flush=True)
        assert agree >= 0.999 and rel < 1e-3
    demo_card_vs_cpu(tag, data, mask, vertex, dev,
                     torch.Generator(device=dev).manual_seed(O_SEED + 1))
    # the CLI's own result again (same seed): its PNG decodes to the drawing
    out = demo.run_demo(data, mask, vertex, O_HYP,
                        torch.Generator(device=dev).manual_seed(O_SEED))
    drawn = viz.visualize_bounding_box(data["rgb"], out["corners_pred"],
                                       out["corners_gt"])
    assert np.array_equal(read_rgb(out_png, dev).cpu().numpy(), drawn), \
        f"{tag}: the written PNG does not decode to the drawing"
    ang, trans, px = demo.pose_errors(out["pose"], data["pose"],
                                      out["corners_pred"], out["corners_gt"])
    print(f"{tag} python -m pvnet_tpu_torch.demo "
          f"{'--checkpoint ' + os.path.basename(checkpoint) if checkpoint else '(GT field)'}"
          f" on the card: {lines[0]}; {wall:.2f} s with the model's load; "
          f"launches {counts}; the PNG decodes to the drawing; {SMI}",
          flush=True)
    assert np.isfinite([ang, trans, px]).all()
    return ang, trans


def run_gallery_phase(dev, tmp, kernels):
    """(o3): ``python -m pvnet_tpu_torch.visualize`` on the card: the six
    files, K1 and K3 three times each, then the gallery's calls card vs
    CPU with the same draws."""
    import numpy as np
    import torch
    from pvnet_tpu_torch import demo, visualize
    from pvnet_tpu_torch.data.image_io import read_rgb

    out_dir = os.path.join(tmp, "gallery")
    reset_all_counters()
    t0 = time.perf_counter()
    printed = run_quiet(visualize.main, [
        "--demo_dir", DEMO_DIR, "--device", str(dev), "--out_dir", out_dir,
        "--seed", str(O_SEED)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_all_counters()
    assert counts["stratified_select_cmajor"] == 3, counts
    assert counts["count_inliers"] == 3, counts
    add_launches(kernels, counts)
    for name in visualize.GALLERY:
        img = read_rgb(os.path.join(out_dir, name), dev)
        assert img.shape[0] == H, (name, img.shape)

    data = demo.load_demo(DEMO_DIR, dev)
    mask, vertex = demo.demo_fields(data, dev)
    gen = torch.Generator(device=dev).manual_seed(O_SEED + 2)
    draws = {}
    for name, hn in (("hyp", O_HYP), ("vote", O_HYP), ("cov", 4096)):
        draws[f"{name}_noise"], draws[f"{name}_pair"] = demo_draws(
            dev, gen, H, W, hn)
    outs = []
    with torch.no_grad():
        for where in (dev, torch.device("cpu")):
            outs.append(visualize.run_gallery(
                data, mask.to(where), vertex.to(where), O_HYP,
                draws={k: v.to(where) for k, v in draws.items()}))
    g, c = outs
    for k in ("hyps", "counts"):
        assert np.array_equal(g[k], c[k]), f"(o3) card != CPU on {k}"
    kd = float(max(abs(g[k] - c[k]).max() for k in ("kps", "mean")))
    cov_tol = max(1e-3 * float(abs(c["cov"]).max()), 1e-4)
    cd = float(abs(g["cov"] - c["cov"]).max())
    rot, trans = held_poses("(o3)", g["pose"], c["pose"])
    ang, tr, _ = demo.pose_errors(g["pose"], data["pose"], g["corners_pred"],
                                  g["corners_gt"])
    print(f"(o3) python -m pvnet_tpu_torch.visualize on the card: "
          f"{len(visualize.GALLERY)} files, {wall:.2f} s; launches {counts}; "
          f"card vs CPU with the same draws: hypotheses and counts equal, "
          f"keypoints / means max diff {kd:.3e} px, covariance {cd:.3e} "
          f"(tolerance {cov_tol:.1e}), uncertainty pose {rot:.3e} deg / "
          f"{trans:.3e} m; pose error against GT {ang:.3f} deg, "
          f"{tr * 100:.3f} cm; {printed.strip().splitlines()[0]}; {SMI}",
          flush=True)
    assert kd < 1e-2 and cd <= cov_tol


def run_save_inter(dev, tmp, kernels):
    """(o4): ``train --test_model --save_inter_result`` on a copy of
    assets/linemod_mini's duck: four files a batch, decoded back."""
    import pickle
    import shutil
    import numpy as np
    from pvnet_tpu_torch.data.image_io import read_mask, read_rgb

    root = os.path.join(tmp, "lm")
    shutil.copytree(LINEMOD_MINI, root)
    inter = os.path.join(tmp, "save_result")
    reset_all_counters()
    out, wall, _ = run_cli([
        "--linemod_cls", "duck", "--data_dir", root, "--init", CKPT,
        "--test_model", "--device", str(dev), "--cfg_file", RECIPE,
        "--model_dir", os.path.join(tmp, "m_inter"), "--save_inter_result",
        "--save_inter_dir", inter])
    counts = read_all_counters()
    add_launches(kernels, counts)
    n = out["sets"]["val"]["images"]
    batches = -(-n // 8)
    names = sorted(os.listdir(inter))
    assert len(names) == 4 * batches, names
    for b in range(batches):
        for kind in ("mask_pr", "mask_gt"):
            m = read_mask(os.path.join(inter, f"{b}_{kind}.png"), dev)
            assert m.shape == (H, W) and set(np.unique(m)) <= {0, 255}
        assert read_rgb(os.path.join(inter, f"{b}_rgb.png"),
                        dev).shape == (H, W, 3)
        with open(os.path.join(inter, f"{b}_pose.pkl"), "rb") as f:
            pose = pickle.load(f)
        assert pose.shape == (3, 4) and np.isfinite(pose).all()
    assert counts["stratified_select_cmajor"] == batches, counts
    print(f"(o4) --test_model --save_inter_result on {n} frames of "
          f"assets/linemod_mini (bf16 recipe): {len(names)} files for "
          f"{batches} batches, each decoded back; rates {out['sets']['val']}"
          f"; {wall:.2f} s; launches {counts}", flush=True)


def run_gather_route(dev, kernels):
    """(o5): bf16 b=16 training steps at 480x640 with the recipe's
    augmentation rotating +-90 deg (the one-pass gather warps), and one
    f32 b=2 augmentation card vs CPU on the same draws."""
    import dataclasses
    import tempfile
    import numpy as np
    import torch
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.data import augment_device as AD
    from pvnet_tpu_torch.data.dataset import load_training_set
    from pvnet_tpu_torch.train import trainer as TT
    from pvnet_tpu_torch.train.loop import TrainLoop

    cfg = TrainConfig.from_json(RECIPE)
    cfg.aug_cfg = dataclasses.replace(cfg.aug_cfg, rot_ang_min=-O_ROT,
                                      rot_ang_max=O_ROT)
    images, masks, hcoords = load_training_set(FIXTURE)
    tile = np.arange(BATCH) % len(images)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        loop = TrainLoop(cfg, os.path.join(tmp, "model"), device=dev,
                         buckets=[(H, W)])
        state = loop.init_state(init=CKPT)
        data = loop.build_device_dataset(images[tile], masks[tile],
                                         hcoords[tile])
        ids = torch.arange(BATCH, device=dev)
        gen = torch.Generator(device=dev).manual_seed(O_SEED)

        def step():
            return TT.train_step_from_data(
                state, data, ids, generator=gen, aug_cfg=cfg.aug_cfg,
                aug_hw=(H, W), bf16=cfg.bf16)

        assert torch.isfinite(step()["loss"])          # first launches
        torch.cuda.synchronize()
        reset_all_counters()
        step_ms, losses = [], []
        for _ in range(O_STEPS):
            t0 = time.perf_counter()
            met = step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(met["loss"]))
        counts = read_all_counters()
        assert np.isfinite(losses).all(), losses
        assert counts["shift_lanes"] == 0 and counts["shift_sublanes"] == 0
        add_launches(kernels, counts)
        raw = {k: v[ids] for k, v in data.items()}
        draws = AD.sample_draws(BATCH, cfg.aug_cfg, gen, dev)
        aug_ms = cuda_ms(lambda: TT.apply_device_aug(
            raw, cfg.aug_cfg, (H, W), draws=draws), iters=10)
        del state, data, raw
    print(f"(o5) {O_STEPS} bf16 training steps, b={BATCH}, {H}x{W}, "
          f"rotation +-{O_ROT:g} deg (gather warps): step ms "
          f"{[round(x, 3) for x in step_ms]}; augmentation {aug_ms:.3f} ms; "
          f"losses {[round(x, 5) for x in losses]}; launches {counts} (the "
          f"gather route launches no kernel of the port); {SMI}",
          flush=True)

    # one f32 b=2 augmentation card vs CPU, uint8 input (the packed-word
    # warp), the same draws
    d = AD.sample_draws(2, cfg.aug_cfg, torch.Generator().manual_seed(O_SEED),
                        "cpu")
    outs = []
    for where in (dev, torch.device("cpu")):
        outs.append([t.cpu() for t in AD.augment_batch(
            torch.from_numpy(images[:2]).to(where),
            torch.from_numpy(masks[:2]).to(where),
            torch.from_numpy(hcoords[:2]).to(where), (H, W), cfg.aug_cfg,
            draws=AD.AugDraws(*(t.to(where) for t in d)))])
    (ig, mg, hg), (ic, mc, hc) = outs
    off = float(((ig - ic).abs() > 1e-4).double().mean())
    same_mask = float((mg == mc).double().mean())
    print(f"(o5) f32 b=2 augmentation, card vs CPU on the same draws: image "
          f"max diff {float((ig - ic).abs().max()):.3e} (share above 1e-4: "
          f"{off:.2e}), mask equal on {same_mask:.6f} of the pixels, "
          f"hcoords max diff {float((hg - hc).abs().max()):.3e}", flush=True)
    assert off <= 0.005 and same_mask >= 0.99
    assert torch.allclose(hg, hc, rtol=1e-5, atol=1e-4)
    torch.cuda.empty_cache()


def run_packed_family(dev, fixture, tmp, kernels, network):
    """(o6): ``network`` with the packed4 stem (the conv7 weights folded)
    and the depth-3 packed tail: backbone from a synthesized ImageNet
    checkpoint as in (l1), heads seeded; the packed field against the
    plain forward on the card; one warm-up and one timed 16-image request
    (K2 once, K3 once)."""
    import torch
    from pvnet_tpu_torch import infer, pipeline as pl
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.models.resnet import init_weights
    from pvnet_tpu_torch.utils.weights import (fold_stem_state_dict,
                                               load_imagenet_backbone)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = network.split("_")[0]
    path = os.path.join(tmp, f"{arch}.pth")
    synthesized_backbone(arch, path, FAMILY_SEED)
    conv7 = build_model(network, ver_dim=2 * VN)
    init_weights(conv7, torch.Generator().manual_seed(FAMILY_SEED))
    load_imagenet_backbone(conv7, path, arch=arch)
    model = build_model(network, ver_dim=2 * VN, stem="packed4")
    model.load_state_dict(fold_stem_state_dict(conv7.state_dict()))
    model = model.to(dev).eval()
    del conv7
    views = fixture["images"]
    imgs = request_images(views, 0)[0]
    packed_against_plain(model, imgs[:4], dev, f"(o6) {network} packed4, ")
    pts = torch.as_tensor(fixture["points_3d"], device=dev)
    K = torch.as_tensor(fixture["K"], device=dev)
    params = pl.VoteParams()
    gen = torch.Generator(device=dev).manual_seed(FAMILY_SEED)
    infer.infer_batch(model, request_images(views, -1)[0], pts, K, params,
                      gen, tail_depth=3, packed_stem=True)   # warm-up
    torch.cuda.synchronize()
    reset_all_counters()
    t0 = time.perf_counter()
    est = infer.infer_batch(model, imgs, pts, K, params, gen, tail_depth=3,
                            packed_stem=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_all_counters()
    assert counts["stratified_select"] == 1 and \
        counts["count_inliers"] == 1, counts
    assert counts["stratified_select_cmajor"] == 0, counts
    assert est.pose.shape == (BATCH, 3, 4) and torch.isfinite(est.pose).all()
    add_launches(kernels, counts)
    print(f"(o6) {network}, packed4 stem, tail_depth 3, f32: one request of "
          f"{BATCH} images at {H}x{W}: {ms:.3f} ms; launches {counts}; "
          f"{SMI}", flush=True)
    del model
    torch.cuda.empty_cache()


def run_visualization(dev, fixture, kernels):
    """Phase (o) (see the module docstring)."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        t = {}
        t0 = time.time()
        run_demo_phase(dev, tmp, kernels, "(o1)")
        t["o1"] = time.time() - t0
        run_demo_phase(dev, tmp, kernels, "(o2)", checkpoint=CKPT)
        t["o2"] = time.time() - t0 - sum(t.values())
        run_gallery_phase(dev, tmp, kernels)
        t["o3"] = time.time() - t0 - sum(t.values())
        run_save_inter(dev, tmp, kernels)
        t["o4"] = time.time() - t0 - sum(t.values())
        run_gather_route(dev, kernels)
        t["o5"] = time.time() - t0 - sum(t.values())
        for network in FAMILY:
            run_packed_family(dev, fixture, tmp, kernels, network)
        t["o6"] = time.time() - t0 - sum(t.values())
    print("(o) seconds by part: " + ", ".join(
        f"{k} {v:.1f}" for k, v in t.items()), flush=True)
    torch.cuda.empty_cache()


# --- phase (p): the host-augmented training route ---------------------------
P_RECIPE = os.path.join(REPO, "configs", "linemod_train.json")  # (p): the
# train CLI's default recipe, named
P_IMAGES = 256            # (p): the synthetic tree; 128 train frames
P_EPOCHS = 2              # (p3)/(p4): epoch 0 warms up, epoch 1 is timed
P_CHECK = 8               # (p2): samples held card vs CPU
P_TIMED = 32              # (p3): samples timed through the dataset
P_SEED = 3


def cv_ops_cases(mask):
    """(name, fn) of every data/cv_ops call at 480x640, as the host route
    makes them: the fused path's warps (rotation about the instance,
    1/ratio, crop offset) to the sampler's sizes, v1's and v2's resizes,
    the blur sizes, the colour conversions, add_noise's line kernels."""
    import numpy as np
    from pvnet_tpu_torch.data import cv_ops as C
    hs, ws = np.nonzero(mask)
    R = C.get_rotation_matrix_2d((float(ws.mean()), float(hs.mean())), 17.3,
                                 1)
    M = R / 0.93
    M[:, 2] -= (31.0, -12.0)
    line = np.zeros((15, 15))
    line[7, :] = 1 / 15
    col = np.zeros((9, 9))
    col[:, 4] = 1 / 9
    cases = [(f"warp_affine linear {w}x{h}",
              lambda f, m, w=w, h=h: C.warp_affine(f, M, (w, h)))
             for h, w in ((480, 640), (256, 344))]
    cases += [
        ("warp_affine nearest int32", lambda f, m: C.warp_affine(
            m, M, (640, 480), C.INTER_NEAREST)),
        ("warp_affine nearest uint8", lambda f, m: C.warp_affine(
            m.to(f.dtype), M, (640, 480), C.INTER_NEAREST)),
        ("resize linear down", lambda f, m: C.resize(f, (512, 384))),
        ("resize linear up", lambda f, m: C.resize(f[:400, :500], (640, 480))),
        ("resize nearest int32", lambda f, m: C.resize(
            m, (512, 384), C.INTER_NEAREST))]
    cases += [(f"gaussian_blur {k}", lambda f, m, k=k: C.gaussian_blur(f, k))
              for k in (3, 5, 7, 9)]
    cases += [
        ("rgb_to_gray", lambda f, m: C.rgb_to_gray(f)),
        ("rgb_to_hsv", lambda f, m: C.rgb_to_hsv(f)),
        ("hsv_to_rgb", lambda f, m: C.hsv_to_rgb(C.rgb_to_hsv(f))),
        ("filter2d 15 row", lambda f, m: C.filter2d(f, line)),
        ("filter2d 9 column", lambda f, m: C.filter2d(f, col))]
    return cases


def check_cv_ops(dev, fixture):
    """(p1): each cv_ops call on the card equals its CPU result on the
    same 480x640 frame and mask; its ms on the card (host clock around 10
    calls and a synchronize)."""
    import torch
    frame = torch.from_numpy(fixture["images"][0])
    mask = torch.from_numpy(fixture["masks"][0].astype("int32"))
    fd, md = frame.to(dev), mask.to(dev)
    times = []
    for name, fn in cv_ops_cases(mask.numpy()):
        want = fn(frame, mask)
        got = fn(fd, md)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.equal(got.cpu(), want), f"(p1) {name}: card != CPU"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn(fd, md)
        torch.cuda.synchronize()
        times.append(f"{name} {(time.perf_counter() - t0) * 100:.3f}")
    print(f"(p1) data/cv_ops at 480x640: every call equal on the card and on "
          f"the CPU; ms a call on the card: {'; '.join(times)}", flush=True)


def host_batch_card_vs_cpu(dev, prefix, records, cfg):
    """(p2): P_CHECK samples of PoseDataset(augment=True) at 480x640 in
    order, seed P_SEED, on the card (frames decoded by jpeg_pixels) and on
    the CPU: the collated batches equal, the draws the same."""
    import numpy as np
    import torch
    from pvnet_tpu_torch.data.dataset import PoseDataset, collate
    batches, rngs = [], []
    reset_all_counters()
    for where in (dev, torch.device("cpu")):
        ds = PoseDataset(records, prefix, cfg.vote_type, augment=True,
                         aug_cfg=cfg.aug_cfg, seed=P_SEED, device=where)
        batches.append(collate([ds[(i, H, W)] for i in range(P_CHECK)]))
        rngs.append(ds.rng.get_state())
        if len(batches) == 1:
            counts = read_all_counters()
    (g, c) = batches
    assert counts["jpeg_pixels"] == P_CHECK, counts
    assert g["image"].device == dev
    assert torch.equal(g["image"].cpu(), c["image"]), "(p2) image"
    for k in ("mask", "vertex_weights", "hcoords", "pose"):
        assert np.array_equal(g[k], c[k]), f"(p2) {k}"
    assert np.array_equal(rngs[0][1], rngs[1][1]) and rngs[0][2] == rngs[1][2]
    print(f"(p2) PoseDataset(augment=True) on the synthetic JPEG tree: "
          f"{P_CHECK} samples at {H}x{W} (configs/linemod_train.json's "
          f"augmentation, seed {P_SEED}) equal on the card and on the CPU: "
          f"the normalized images bit for bit, masks, vertex_weights, "
          f"hcoords, the RandomState after them; jpeg_pixels {P_CHECK}x",
          flush=True)
    return counts


def host_sample_ms(dev, prefix, records, cfg):
    """(ms a sample through PoseDataset(augment=True), of it the decode)
    on the card, P_TIMED samples, one thread, synchronized."""
    import torch
    from pvnet_tpu_torch.data.dataset import PoseDataset
    from pvnet_tpu_torch.data.image_io import read_mask, read_rgb
    ds = PoseDataset(records, prefix, cfg.vote_type, augment=True,
                     aug_cfg=cfg.aug_cfg, seed=P_SEED, device=dev)
    ds[(0, H, W)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(P_TIMED):
        ds[(i % len(records), H, W)]
    torch.cuda.synchronize()
    sample = (time.perf_counter() - t0) * 1e3 / P_TIMED
    t0 = time.perf_counter()
    for i in range(P_TIMED):
        r = records[i % len(records)]
        read_rgb(os.path.join(prefix, r["rgb_pth"]), dev)
        read_mask(os.path.join(prefix, r["dpt_pth"]), dev)
    torch.cuda.synchronize()
    return sample, (time.perf_counter() - t0) * 1e3 / P_TIMED


def profiled_host_epoch(dev, prefix, records, cfg, tmp):
    """The device's idle share over one host-augmented epoch (4 steps of
    the recipe's b=32 after a warm-up step): torch.profiler's device time
    summed over the window's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from pvnet_tpu_torch.train.loop import TrainLoop
    loop = TrainLoop(cfg, os.path.join(tmp, "m_prof"), buckets=[(H, W)],
                     device=dev)
    state = loop.init_state(CKPT)
    loader, _ = loop.make_loaders(records, [], prefix)
    loop.train_epoch(state, loader, 0, max_steps=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, steps = loop.train_epoch(state, loader, 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) / 1e3
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU)
    return steps, wall_ms, busy


def run_host_route(dev, fixture, kernels):
    """Phase (p): the host-augmented training route (see the module
    docstring)."""
    import tempfile
    import numpy as np
    import torch
    from pvnet_tpu_torch.config import PathConfig, TrainConfig
    from pvnet_tpu_torch.data.synthetic import write_synthetic_linemod
    from pvnet_tpu_torch.train import __main__ as T

    check_cv_ops(dev, fixture)
    cfg = TrainConfig.from_json(P_RECIPE)
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        data_dir = os.path.join(tmp, "data")
        t0 = time.time()
        write_synthetic_linemod(os.path.join(data_dir, "synthetic"), "duck",
                                num_images=P_IMAGES, device=dev,
                                workers=len(os.sched_getaffinity(0)))
        gen_s = time.time() - t0
        paths = PathConfig(data_dir=os.path.join(data_dir, "synthetic"))
        train, _ = T.linemod_train_val(cfg, "duck", paths, dev)
        prefix = paths.linemod_dir
        counts = host_batch_card_vs_cpu(dev, prefix, train, cfg)
        add_launches(kernels, counts)

        # (p3) and (p4): the CLI on the tree, no route flag, then
        # --device_aug; epoch 1 timed
        routes = {}
        for flags, route in (([], "host aug"), (["--device_aug"],
                                                 "device aug")):
            reset_all_counters()
            summary, wall, _ = run_cli([
                "--synthetic", "--synthetic_images", str(P_IMAGES),
                "--data_dir", data_dir, "--init", CKPT, "--cfg_file",
                P_RECIPE, "--epochs", str(P_EPOCHS), "--buckets", f"{H}x{W}",
                "--model_dir",
                os.path.join(tmp, f"m_{route[:4]}"), "--device", str(dev)]
                + flags)
            counts = read_all_counters()
            add_launches(kernels, counts)
            epochs = summary["epochs"]
            steps = [e["steps"] for e in epochs]
            losses = [x for e in epochs for x in e["losses"]]
            per_epoch = len(train) // cfg.train_batch_size
            assert summary["route"] == route and summary["generate_s"] == 0
            assert steps == [per_epoch] * P_EPOCHS and per_epoch >= 4, steps
            assert np.isfinite(losses).all(), losses
            if route == "host aug":
                assert counts["shift_lanes"] == 0, counts
                assert counts["jpeg_pixels"] >= sum(steps) * \
                    cfg.train_batch_size, counts
            else:
                assert counts["shift_lanes"] == 2 * sum(steps), counts
            last = epochs[-1]
            routes[route] = (last["seconds"] / last["steps"] * 1e3,
                             last["wait_s"] / last["steps"] * 1e3,
                             losses, counts, wall)
        sample_ms, decode_ms = host_sample_ms(dev, prefix, train, cfg)
        steps, wall_ms, busy = profiled_host_epoch(dev, prefix, train, cfg,
                                                   tmp)
    for route, (step_ms, wait_ms, losses, counts, wall) in routes.items():
        print(f"(p{3 if route == 'host aug' else 4}) python -m "
              f"pvnet_tpu_torch.train --synthetic"
              f"{'' if route == 'host aug' else ' --device_aug'} "
              f"(configs/linemod_train.json: resnet18_8s, bf16, b=32) on "
              f"{len(train)} train frames at {H}x{W}, {P_EPOCHS} epochs of "
              f"{len(losses) // P_EPOCHS} steps: route {route}; epoch 1 step "
              f"ms {step_ms:.1f}, loader wait ms a batch {wait_ms:.1f}; loss "
              f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches {counts}; "
              f"{wall:.1f} s; {SMI}", flush=True)
    print(f"(p3) host augmentation on the card, one thread: "
          f"{sample_ms:.2f} ms a sample (decode, fused warp, blur, jitter, "
          f"normalization), of it {decode_ms:.2f} ms decoding; the synthetic "
          f"tree ({P_IMAGES} images) written in {gen_s:.1f} s; profiled "
          f"host-augmented epoch of {steps} steps: device busy {busy:.1f} ms "
          f"of {wall_ms:.1f} ms, idle share {1 - busy / wall_ms:.3f} (the "
          f"profiler slows the host); {SMI}", flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase (q): data parallelism over torch.distributed
# ---------------------------------------------------------------------------

Q_TIMEOUT = 300           # seconds a torchrun command of (q) may take
Q_STEPS = 3               # (q1): sharded bf16 steps
Q3_DEVICE = "cuda:0"      # (q3): the device both gloo ranks share


def torchrun(args, nproc: int, tmp: str, timeout: float = Q_TIMEOUT):
    """``python -m torch.distributed.run --nproc_per_node nproc`` + args on
    127.0.0.1 (a free port, a 120 s process-group timeout); a non-zero exit
    fails the phase with the processes' last output."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(nproc), "--master_addr", "127.0.0.1", "--master_port",
           str(port), *args]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout,
                          env=dict(os.environ, PVNET_PG_TIMEOUT="120",
                                   TMPDIR=tmp))
    if proc.returncode != 0:
        print(proc.stdout[-6000:], proc.stderr[-6000:], file=sys.stderr)
    assert proc.returncode == 0, f"{' '.join(args[:2])} under torchrun " \
        f"exited {proc.returncode}"
    return proc, time.time() - t0


def q_batch(dev):
    """(q1), (q3): the fixture's views tiled to a raw batch of BATCH."""
    import numpy as np
    import torch
    from pvnet_tpu_torch.data.dataset import load_training_set
    images, masks, hcoords = load_training_set(FIXTURE)
    tile = np.arange(BATCH) % len(images)
    return {"image": torch.from_numpy(images[tile]).to(dev),
            "mask": torch.from_numpy(masks[tile]).to(dev),
            "hcoords": torch.from_numpy(hcoords[tile]).to(dev),
            "ignore": torch.zeros(BATCH, device=dev)}


def q_model(dev, cfg):
    import torch
    from pvnet_tpu_torch.config import model_kwargs
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.utils.weights import load_weights
    model = build_model(cfg.network, ver_dim=2 * VN, seg_dim=2,
                        **model_kwargs(cfg))
    load_weights(model, CKPT)
    return model.to(dev)


def q_stats(model):
    """The running statistics of every BatchNorm, by name."""
    return {k: v.detach().float().clone()
            for k, v in model.state_dict().items() if "running" in k}


def q_stats_err(got, want) -> float:
    """The largest difference of two sets of running statistics, each
    relative to its tensor's largest value."""
    return max(float((got[k] - w).abs().max() / w.abs().max().clamp(
        min=1e-30)) for k, w in want.items())


def parallel_pipeline(mesh, dev, fixture):
    """(q1) make_sharded_pose_pipeline on 3 requests of 16 images, plain
    (tail_depth 0) and packed (tail_depth 3), f32: each equal to the
    unsharded pipeline's poses and keypoints given the same draws; the
    sharded requests' launches and latency (host clock, after a
    synchronize) beside the unsharded ones'."""
    import torch
    from pvnet_tpu_torch import infer
    from pvnet_tpu_torch import pipeline as pl
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = infer.load_model(CKPT, VN, dev)
    pts, K = fixture["points_3d"], fixture["K"]
    pts_t = torch.as_tensor(pts, device=dev)
    K_t = torch.as_tensor(K, device=dev)
    params = pl.VoteParams()
    out = {}
    for name, depth in (("plain", 0), ("packed", 3)):
        fused = depth > 0
        run = pl.make_sharded_pose_pipeline(
            mesh, model, pts, K, params, fused_tail=fused, tail_depth=3,
            tail_dtype=torch.float32)
        shapes = pl.draw_shapes(BATCH, H, W, params, False, fused)
        sharded_ms, plain_ms, counts = [], [], {}
        for r in range(-1, N_REQUESTS):           # -1: a warm-up request
            imgs, _ = request_images(fixture["images"], 40 + r)
            x = pl.normalize_images(torch.from_numpy(imgs).to(dev))
            g = torch.Generator(device=dev).manual_seed(300 + r)
            draws = {k: torch.rand(s, generator=g, device=dev)
                     for k, s in shapes.items()}
            torch.cuda.synchronize()
            reset_all_counters()
            t0 = time.perf_counter()
            pose, kps = run(x, draws=draws)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = read_all_counters()
            t0 = time.perf_counter()
            est = pl.estimate_poses(model, x, pts_t, K_t, params,
                                    fused_tail=fused, tail_depth=3,
                                    tail_dtype=torch.float32, **draws)
            torch.cuda.synchronize()
            one_ms = (time.perf_counter() - t0) * 1e3
            assert torch.equal(pose, est.pose) and torch.equal(kps, est.kps), \
                f"(q1) {name}: the sharded request differs from the " \
                f"unsharded one"
            assert torch.isfinite(pose).all()
            if r < 0:
                continue
            sharded_ms.append(ms)
            plain_ms.append(one_ms)
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
        k_sel = "stratified_select" if fused else "stratified_select_cmajor"
        assert counts[k_sel] == N_REQUESTS, counts
        assert counts["count_inliers"] == N_REQUESTS, counts
        other = ("stratified_select_cmajor" if fused
                 else "stratified_select")
        assert counts[other] == 0, counts
        out[name] = {"sharded_ms": sharded_ms, "unsharded_ms": plain_ms,
                     "launches": counts}
    return out


def parallel_steps(mesh, dev, cfg, batch, steps: int):
    """(q1), (q3) ``steps`` sharded device-augmentation steps of the
    recipe over ``mesh`` (synchronized BatchNorm, DDP), each from the
    weights and Adam state of an unsharded twin, which takes the same
    step on the whole batch with the same draws: the sharded step's K4
    launches, loss and running statistics against the twin's (and on the
    main rank the gradients)."""
    import torch
    from pvnet_tpu_torch.data.augment_device import sample_draws
    from pvnet_tpu_torch.parallel import convert_sync, replicate
    from pvnet_tpu_torch.train import trainer as TT
    one = TT.create_train_state(q_model(dev, cfg), cfg)
    two = TT.create_train_state(
        convert_sync(replicate(q_model(dev, cfg), mesh), mesh), cfg)
    step = TT.make_sharded_train_step(mesh, aug_cfg=cfg.aug_cfg,
                                      aug_hw=(H, W), bf16=cfg.bf16)
    rows = []
    for s in range(steps):
        two.model.load_state_dict(one.model.state_dict())
        two.optimizer.load_state_dict(one.optimizer.state_dict())
        g = torch.Generator(device=dev).manual_seed(70 + s)
        draws = sample_draws(BATCH, cfg.aug_cfg, g, dev)
        torch.cuda.synchronize()
        reset_all_counters()
        t0 = time.perf_counter()
        met = step(two, batch, draws=draws)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_all_counters()
        want = TT.train_step(one, batch, draws=draws, aug_cfg=cfg.aug_cfg,
                             aug_hw=(H, W), bf16=cfg.bf16)
        assert launches["shift_lanes"] == 2, launches
        grads = {k: p.grad for k, p in one.model.named_parameters()}
        num = sum(float(((p.grad - grads[k]) ** 2).sum())
                  for k, p in two.model.named_parameters())
        den = sum(float((g_ ** 2).sum()) for g_ in grads.values())
        rows.append({"ms": ms, "loss": float(met["loss"]),
                     "loss_one": float(want["loss"]),
                     "stats_err": q_stats_err(q_stats(two.model),
                                              q_stats(one.model)),
                     "grad_err": (num / den) ** 0.5, "launches": launches})
    return rows


def parallel_worker(out_path):
    """(q1) in a process of its own under torchrun, world size 1: an NCCL
    group on cuda:LOCAL_RANK; the sharded pipeline and bf16 steps."""
    import torch
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.ops import kernel_lib
    from pvnet_tpu_torch.parallel import init_process_group
    t0 = time.time()
    mesh = init_process_group("cuda")
    assert mesh.group is not None and mesh.size == 1, mesh
    assert torch.distributed.get_backend() == "nccl"
    kernel_lib.library()
    import numpy as np
    with np.load(FIXTURE) as z:
        pipe = parallel_pipeline(mesh, mesh.device,
                                 {k: z[k] for k in z.files})
    cfg = TrainConfig.from_json(RECIPE)
    assert cfg.bf16 and cfg.train_batch_size == BATCH
    steps = parallel_steps(mesh, mesh.device, cfg, q_batch(mesh.device),
                           Q_STEPS)
    for row in steps:                  # bf16: one step from equal states
        assert abs(row["loss"] / row["loss_one"] - 1) < 1e-2, row
        assert row["stats_err"] < 1e-2 and row["grad_err"] < 1e-1, row
    with open(out_path, "w") as f:
        json.dump({"pipeline": pipe, "steps": steps, "backend": "nccl",
                   "seconds": time.time() - t0}, f)
    torch.distributed.destroy_process_group()
    return 0


def gloo_worker(out_path):
    """(q3) one of two gloo ranks sharing cuda:0: one f32 sharded step of
    the recipe's global batch of 16 against the unsharded step on rank 0."""
    import torch
    from pvnet_tpu_torch.config import TrainConfig
    from pvnet_tpu_torch.ops import kernel_lib
    from pvnet_tpu_torch.parallel import all_reduce_sum, init_process_group
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_process_group(Q3_DEVICE, backend="gloo")
    assert mesh.size == 2 and mesh.device == torch.device(Q3_DEVICE)
    if mesh.device.type == "cuda":
        kernel_lib.library()
    cfg = TrainConfig.from_json(RECIPE)
    cfg.bf16 = False
    dev = mesh.device
    from pvnet_tpu_torch.data.augment_device import sample_draws
    from pvnet_tpu_torch.parallel import convert_sync, replicate
    from pvnet_tpu_torch.train import trainer as TT
    batch = q_batch(dev)
    two = TT.create_train_state(
        convert_sync(replicate(q_model(dev, cfg), mesh), mesh), cfg)
    g = torch.Generator(device=dev).manual_seed(90)
    draws = sample_draws(BATCH, cfg.aug_cfg, g, dev)
    reset_all_counters()
    met = TT.make_sharded_train_step(mesh, aug_cfg=cfg.aug_cfg,
                                     aug_hw=(H, W))(two, batch, draws=draws)
    launches = read_all_counters()
    assert launches["shift_lanes"] == 2, launches
    lanes = all_reduce_sum(torch.tensor([float(launches["shift_lanes"])],
                                        device=dev), mesh)
    row = {"loss": float(met["loss"]), "launches": launches,
           "shift_lanes_all_ranks": float(lanes)}
    if mesh.is_main:
        one = TT.create_train_state(q_model(dev, cfg), cfg)
        want = TT.train_step(one, batch, draws=draws, aug_cfg=cfg.aug_cfg,
                             aug_hw=(H, W))
        grads = {k: p.grad for k, p in one.model.named_parameters()}
        num = sum(float(((p.grad - grads[k]) ** 2).sum())
                  for k, p in two.model.named_parameters())
        den = sum(float((g_ ** 2).sum()) for g_ in grads.values())
        row.update(loss_one=float(want["loss"]),
                   stats_err=q_stats_err(q_stats(two.model),
                                         q_stats(one.model)),
                   grad_err=(num / den) ** 0.5)
        assert abs(row["loss"] / row["loss_one"] - 1) < 1e-4, row
        assert row["stats_err"] < 1e-4 and row["grad_err"] < 1e-2, row
        with open(out_path, "w") as f:
            json.dump(row, f)
    torch.distributed.destroy_process_group()
    return 0


def run_parallel(dev, fixture, kernels):
    """Phase (q): (q1) the sharded pipeline and steps in a world-1 NCCL
    group, (q2) the train CLI under torchrun, its rank-0 checkpoint
    through infer.load_model, (q3) two gloo ranks sharing the card."""
    import tempfile
    import torch
    from pvnet_tpu_torch import infer
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        out = os.path.join(tmp, "q1.json")
        _, q1_s = torchrun([os.path.join(REPO, "chip_smoke.py"),
                            "--parallel-worker", out], 1, tmp)
        with open(out) as f:
            q1 = json.load(f)
        for name in ("plain", "packed"):
            p = q1["pipeline"][name]
            add_launches(kernels, p["launches"])
            print(f"(q1) make_sharded_pose_pipeline, NCCL world 1, {name} "
                  f"(tail_depth {3 if name == 'packed' else 0}, f32): "
                  f"{N_REQUESTS} requests of {BATCH} at {H}x{W} equal to "
                  f"the unsharded pipeline's poses and keypoints; latency ms "
                  f"sharded {[round(x, 3) for x in p['sharded_ms']]}, "
                  f"unsharded {[round(x, 3) for x in p['unsharded_ms']]}; "
                  f"launches {p['launches']}; {SMI}", flush=True)
        for row in q1["steps"]:
            add_launches(kernels, row["launches"])
        print(f"(q1) {Q_STEPS} sharded bf16 --device_aug steps at b={BATCH}"
              f", {H}x{W} (synchronized BatchNorm, DDP), each from the "
              f"unsharded twin's state: ms "
              f"{[round(r['ms'], 1) for r in q1['steps']]}; loss "
              f"{[round(r['loss'], 6) for r in q1['steps']]} vs "
              f"{[round(r['loss_one'], 6) for r in q1['steps']]}; running "
              f"statistics rel err "
              f"{[float('%.3g' % r['stats_err']) for r in q1['steps']]}; "
              f"gradient rel err "
              f"{[float('%.3g' % r['grad_err']) for r in q1['steps']]}; K4 2 "
              f"a step; the worker took {q1['seconds']:.1f} s, the command "
              f"{q1_s:.1f} s; {SMI}", flush=True)

        model_dir = os.path.join(tmp, "q2")
        proc, q2_s = torchrun(
            ["-m", "pvnet_tpu_torch.train", "--cfg_file", RECIPE,
             "--data", FIXTURE, "--buckets", f"{H}x{W}", "--init", CKPT,
             "--steps", "2", "--model_dir", model_dir, "--device", "cuda"],
            1, tmp)
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
        assert summary["world_size"] == 1, summary
        assert summary["launches"]["shift_lanes"] == 4, summary
        losses = [x for e in summary["epochs"] for x in e["losses"]]
        assert len(losses) == 2 and all(map(lambda v: v == v, losses))
        add_launches(kernels, summary["launches"])
        net = torch.load(os.path.join(model_dir, "0.pth"),
                         map_location="cpu", weights_only=True)["net"]
        assert not any(k.startswith("module.") for k in net)
        model = infer.load_model(os.path.join(model_dir, "0.pth"), VN, dev)
        with torch.no_grad():
            seg, ver = model(torch.zeros(1, 3, H, W, device=dev))
        assert torch.isfinite(seg).all() and torch.isfinite(ver).all()
        print(f"(q2) torchrun --nproc_per_node 1 -m pvnet_tpu_torch.train "
              f"(NCCL, the fixture route, bf16 b={BATCH}, 2 steps): losses "
              f"{[round(x, 5) for x in losses]}, launches "
              f"{summary['launches']}; its rank-0 checkpoint (no module. "
              f"prefix) loaded through infer.load_model; {q2_s:.1f} s; {SMI}",
              flush=True)

        out = os.path.join(tmp, "q3.json")
        _, q3_s = torchrun([os.path.join(REPO, "chip_smoke.py"),
                            "--gloo-worker", out], 2, tmp)
        with open(out) as f:
            q3 = json.load(f)
        add_launches(kernels, {"shift_lanes":
                               int(q3["shift_lanes_all_ranks"])})
        print(f"(q3) two gloo ranks sharing {torch.cuda.get_device_name(0)}"
              f": one f32 --device_aug step of b={BATCH} (8 rows a rank) "
              f"against one process on the whole batch: loss "
              f"{q3['loss']:.7f} vs {q3['loss_one']:.7f}, running "
              f"statistics rel err {q3['stats_err']:.3g}, gradient rel err "
              f"{q3['grad_err']:.3g}; K4 launches on both ranks "
              f"{int(q3['shift_lanes_all_ranks'])}; {q3_s:.1f} s; {SMI}",
              flush=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase (r): spatial partitioning, one image's rows over an sp axis
# ---------------------------------------------------------------------------

R_BATCH = 4               # (r): images a request
R_SP = 4                  # (r2): sp ranks sharing the card, 120 rows each
R_DEVICE = "cuda:0"       # (r2), (r3): the device the gloo ranks share
R_NEAR_TIE = 1e-4         # a mask pixel may differ from the unsharded one
#                           where the unsharded logits tie within this
R_ENVELOPES = "128,512"   # (r4): the envelope study's sweep
R_ENV_FRAMES = 16         # (r4): the first frames of (h)'s split


def spatial_check(model, x, pose, kps, mask, ver, draws, rows, pts, K,
                  params, unc, bf16, exact):
    """One sharded request on the main rank, against the unsharded forward
    and pipeline on the whole batch with the same draws. ``mask`` and
    ``ver`` are the fields gathered from every rank's slab, ``rows`` the
    main rank's data group's rows of the batch.

    ``exact`` (one shard): poses and keypoints equal the unsharded
    pipeline's bit for bit. Otherwise: the group's poses and keypoints
    equal, bit for bit, the unsharded voting and PnP on the gathered
    fields with the same draws; in float32 the fields equal the unsharded
    forward's (masks but for pixels whose unsharded logits tie within
    R_NEAR_TIE; vertex within 1e-4 of the field's largest value: the
    slabs' convolutions take other cuDNN algorithms than the whole
    image's, 1.4e-4 apart at a largest value of 15.5 in float32 without
    TF32),
    and against the unsharded pipeline on its own fields the poses are
    within tests/test_torch_pipeline.py's own-FCN 1 deg / 15 mm with 80 %
    of the keypoints within 0.05 px (fields 1e-5 apart hand a few votes
    to a neighbouring hypothesis, whose refined point can lie pixels
    away; the largest distance is printed); bf16: masks equal on
    >= 99.5 % of the pixels, vertex within 5 % of its largest value.
    Returns the differences and the unsharded request's ms."""
    import torch
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.ops.geometry import rotation_angle_deg
    with torch.no_grad(), pl._bf16_autocast(x.device.type, bf16):
        seg_r, ver_r = model(x.permute(0, 3, 1, 2).contiguous())
    seg_r, ver_r = seg_r.float(), ver_r.float()
    diff = mask != seg_r.argmax(1)
    gap = (seg_r[:, 0] - seg_r[:, 1]).abs()
    pts_t = torch.as_tensor(pts, device=x.device)
    K_t = torch.as_tensor(K, device=x.device)
    torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    est = pl.estimate_poses(model, x, pts_t, K_t, params, uncertainty=unc,
                            fcn_bf16=bf16, **draws)
    torch.cuda.synchronize(x.device)
    one_ms = (time.perf_counter() - t0) * 1e3
    kp_err = (kps - est.kps).norm(dim=-1)
    rot = rotation_angle_deg(pose[..., :3].double(),
                             est.pose[..., :3].double())
    row = {"mask_diffs": int(diff.sum()),
           "near_ties": int((gap < R_NEAR_TIE).sum()),
           "vertex_err": float((ver.float() - ver_r).abs().max()),
           "vertex_max": float(ver_r.abs().max()),
           "kp_px": float(kp_err.max()),
           "kp_within_005": float((kp_err < 5e-2).float().mean()),
           "rot_deg": float(rot.max()),
           "t_mm": float((pose[..., 3] - est.pose[..., 3]).norm(dim=-1)
                         .max()) * 1e3, "unsharded_ms": one_ms}
    assert torch.isfinite(pose).all() and torch.isfinite(kps).all()
    if exact:
        assert torch.equal(pose, est.pose) and torch.equal(kps, est.kps), row
        return row
    d = {k: v[rows] for k, v in draws.items()}
    m, v = mask[rows], ver[rows].float()
    if unc:
        kps_f, cov = pl.keypoints_with_covariance(
            m, v, params, d["noise"], d["pair_u"], d["cov_noise"],
            d["cov_pair_u"])
    else:
        kps_f = pl.keypoints_from_fields(m, v, params, d["noise"],
                                         d["pair_u"])
        cov = None
    pose_f = pl.poses_from_keypoints(pts_t, kps_f, K_t, covar=cov)
    assert torch.equal(kps[rows], kps_f) and torch.equal(pose[rows],
                                                         pose_f), row
    if bf16:
        assert row["mask_diffs"] <= 5e-3 * mask.numel(), row
        assert row["vertex_err"] <= 0.05 * row["vertex_max"], row
    else:
        assert bool((gap[diff] < R_NEAR_TIE).all()), row
        assert row["vertex_err"] <= 1e-4 * row["vertex_max"], row
        assert row["kp_within_005"] >= 0.8, row
        assert row["rot_deg"] < 1.0 and row["t_mm"] < 15.0, row
    return row


def spatial_requests(world, smesh, fixture, variants):
    """make_spatial_pose_pipeline over ``smesh`` on requests of R_BATCH
    images at HxW, after a warm-up request: ``variants`` [(name,
    uncertainty, bf16, requests)]. Each request's draws come from a
    generator seeded alike on every rank; its latency (host clock, every
    rank synchronized before it) and this rank's K1 / K3 launches (once a
    request, twice with uncertainty); the fields gathered from the ranks'
    slabs and the poses checked on the main rank (spatial_check). Returns
    {name: {"sharded_ms", "checks", "launches"}}: on the main rank; the
    launches summed over every rank."""
    import torch
    from pvnet_tpu_torch import infer
    from pvnet_tpu_torch import pipeline as pl
    from pvnet_tpu_torch.parallel import (all_gather_rows, all_reduce_sum,
                                          barrier, make_spatial_field_fn,
                                          make_spatial_pose_pipeline)
    from pvnet_tpu_torch.parallel.spatial import gather_dim
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = smesh.device
    model = infer.load_model(CKPT, VN, dev)
    pts, K = fixture["points_3d"], fixture["K"]
    params = pl.VoteParams()
    exact = smesh.sp.size == 1 and smesh.data.size == 1
    out = {}
    for name, unc, bf16, n in variants:
        run = make_spatial_pose_pipeline(smesh, model, pts, K, params,
                                         uncertainty=unc, fcn_bf16=bf16)
        fields = make_spatial_field_fn(smesh, model, fcn_bf16=bf16)
        shapes = pl.draw_shapes(R_BATCH, H, W, params, unc, False)
        ms, checks, counts = [], [], {}
        for r in range(-1, n):                      # -1: a warm-up request
            imgs, _ = request_images(fixture["images"], 60 + r)
            x = pl.normalize_images(torch.from_numpy(imgs[:R_BATCH]).to(dev))
            g = torch.Generator(device=dev).manual_seed(600 + r)
            draws = pl.draw_votes(shapes, g)
            barrier(world)
            torch.cuda.synchronize(dev)
            reset_all_counters()
            t0 = time.perf_counter()
            pose, kps = run(x, draws=draws)
            torch.cuda.synchronize(dev)
            t = (time.perf_counter() - t0) * 1e3
            got = read_all_counters()
            want = 2 if unc else 1
            assert got["stratified_select_cmajor"] == want, (name, got)
            assert got["count_inliers"] == want, (name, got)
            mask, ver = fields(x)
            mask = all_gather_rows(gather_dim(mask, smesh.sp, 1), smesh.data)
            ver = all_gather_rows(gather_dim(ver, smesh.sp, 2), smesh.data)
            if world.is_main:
                row = spatial_check(model, x, pose, kps, mask, ver, draws,
                                    smesh.data.rows(R_BATCH), pts, K,
                                    params, unc, bf16, exact)
            if r < 0:
                continue
            ms.append(t)
            if world.is_main:
                checks.append(row)
            for k, v in got.items():
                counts[k] = counts.get(k, 0) + v
        names = sorted(counts)
        total = all_reduce_sum(torch.tensor(
            [float(counts[k]) for k in names], device=dev), world)
        out[name] = {"sharded_ms": ms, "checks": checks, "launches": {
            k: int(v) for k, v in zip(names, total.tolist())}}
    return out


def spatial_worker(out_path):
    """(r1) in a process of its own under torchrun, world size 1: an NCCL
    group on cuda:LOCAL_RANK, a 1x1 (data, sp) mesh; 3 requests and one
    with uncertainty, each equal to the unsharded pipeline bit for bit."""
    import numpy as np
    import torch
    from pvnet_tpu_torch.ops import kernel_lib
    from pvnet_tpu_torch.parallel import init_process_group, make_spatial_mesh
    t0 = time.time()
    world = init_process_group("cuda")
    assert world.group is not None and world.size == 1, world
    assert torch.distributed.get_backend() == "nccl"
    kernel_lib.library()
    smesh = make_spatial_mesh(sp=1)
    with np.load(FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    res = spatial_requests(world, smesh, fixture,
                           [("plain", False, False, N_REQUESTS),
                            ("uncertainty", True, False, 1)])
    with open(out_path, "w") as f:
        json.dump({"requests": res, "seconds": time.time() - t0}, f)
    torch.distributed.destroy_process_group()
    return 0


def spatial_gloo_worker(out_path):
    """(r2), (r3): one of R_SP gloo ranks sharing R_DEVICE: sp=R_SP (H/R_SP
    rows a rank), 3 f32 requests, one with uncertainty and one under bf16
    autocast; then a 2x2 data x sp mesh of the same ranks, one request."""
    import numpy as np
    import torch
    from pvnet_tpu_torch.ops import kernel_lib
    from pvnet_tpu_torch.parallel import init_process_group, make_spatial_mesh
    t0 = time.time()
    world = init_process_group(R_DEVICE, backend="gloo")
    assert world.size == R_SP and world.device == torch.device(R_DEVICE)
    if world.device.type == "cuda":
        kernel_lib.library()
    with np.load(FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    sp = make_spatial_mesh(sp=R_SP, device=R_DEVICE)
    res = {"sp": spatial_requests(world, sp, fixture, [
        ("plain", False, False, N_REQUESTS), ("uncertainty", True, False, 1),
        ("bf16", False, True, 1)])}
    mesh22 = make_spatial_mesh(sp=2, device=R_DEVICE)
    assert (mesh22.data.size, mesh22.sp.size) == (2, 2)
    res["2x2"] = spatial_requests(world, mesh22, fixture,
                                  [("plain", False, False, 1)])
    if world.is_main:
        with open(out_path, "w") as f:
            json.dump({"requests": res, "seconds": time.time() - t0}, f)
    torch.distributed.destroy_process_group()
    return 0


def print_spatial(tag, what, res):
    for name, p in res.items():
        c = p["checks"]
        print(f"{tag} make_spatial_pose_pipeline, {what}, {name}: "
              f"{len(p['sharded_ms'])} requests of {R_BATCH} at {H}x{W}; "
              f"latency ms sharded {[round(x, 3) for x in p['sharded_ms']]}"
              f", unsharded {[round(r['unsharded_ms'], 3) for r in c]}; "
              f"mask pixels apart from the unsharded forward "
              f"{[r['mask_diffs'] for r in c]} (unsharded logits within "
              f"{R_NEAR_TIE} of a tie: {[r['near_ties'] for r in c]}); "
              f"vertex err {[float('%.3g' % r['vertex_err']) for r in c]} "
              f"(field max {max(r['vertex_max'] for r in c):.3f}); against "
              f"the unsharded pipeline: keypoints within 0.05 px "
              f"{[round(r['kp_within_005'], 3) for r in c]}, the farthest "
              f"px {[float('%.3g' % r['kp_px']) for r in c]}, deg "
              f"{[float('%.3g' % r['rot_deg']) for r in c]}, mm "
              f"{[float('%.3g' % r['t_mm']) for r in c]}; launches on all "
              f"ranks {p['launches']}; {SMI}", flush=True)


def reference_rates(ref, split, n, mode="plain"):
    """The JAX reference's seed-0 rates (2D projection < 5 px, ADD < 10 %
    of the diameter, 5 cm 5 deg) over the first ``n`` of (h)'s images,
    from its per-image errors."""
    import numpy as np
    e = {k: np.asarray(v[:n]) for k, v in
         ref["runs"][mode][0]["per_image"].items()}
    return (float((e["proj_px"] < 5).mean()),
            float((e["add_m"] < 0.1 * float(split["diameter"])).mean()),
            float(((e["trans_cm"] < 5) & (e["rot_deg"] < 5)).mean()))


def spatial_envelope_study(dev, split, tmp, kernels):
    """(r4) ``python -m pvnet_tpu_torch.envelope_study`` (in this process)
    on a LINEMOD tree of the first R_ENV_FRAMES of (h)'s images (their
    JPEG round trip, data/synthetic.write_linemod_views), f32, tail_depth
    3, R_ENVELOPES: its rows beside the JAX reference's rates on those
    images (raw renders, 512 hypotheses) as a record, not a gate."""
    from pvnet_tpu_torch import envelope_study
    from pvnet_tpu_torch.data.synthetic import write_linemod_views
    import numpy as np
    first = {k: split[k][:R_ENV_FRAMES] for k in ("images", "masks", "poses")}
    # LineModImageDB reads frames 0..n-1: the images renumbered in order
    first["index"] = np.arange(R_ENV_FRAMES)
    root = os.path.join(tmp, "envelope")
    t0 = time.time()
    write_linemod_views(root, first, {"test": range(R_ENV_FRAMES)},
                        device=dev)
    write_s = time.time() - t0
    with open(RECIPE) as f:
        recipe = json.load(f)
    recipe["bf16"] = False
    recipe_path = os.path.join(tmp, "envelope_recipe.json")
    with open(recipe_path, "w") as f:
        json.dump(recipe, f)
    reset_all_counters()
    t0 = time.time()
    out = run_quiet(envelope_study.main, [
        "--cfg_file", recipe_path, "--data_dir", root, "--cls", "duck",
        "--envelopes", R_ENVELOPES, "--weights", CKPT, "--tail_depth", "3",
        "--num_threads", "4", "--device", str(dev)])
    study_s = time.time() - t0
    launches = read_all_counters()
    add_launches(kernels, launches)
    rows = [json.loads(line) for line in
            out.partition("envelope sweep:")[2].splitlines()
            if line.startswith("{")]
    assert [r["hyp_num"] for r in rows] == [
        int(n) for n in R_ENVELOPES.split(",")], out[-2000:]
    with open(EVAL_REFERENCE) as f:
        ref = json.load(f)
    jax16 = reference_rates(ref, split, R_ENV_FRAMES)
    jpeg = [[r[m] for m in ("proj", "add", "cm")]
            for r in ref["runs_jpeg"]["plain"]]
    print(f"(r4) envelope study, f32, tail_depth 3, on the first "
          f"{R_ENV_FRAMES} of (h)'s images as JPEG frames (tree written in "
          f"{write_s:.1f} s, the study {study_s:.1f} s): "
          f"{json.dumps(rows)}; the JAX reference on the same images as raw "
          f"renders (512 hypotheses, seed 0) proj/add/5cm5deg "
          f"{[round(v, 4) for v in jax16]}, on the 64 JPEG frames over seeds "
          f"0-2 {jpeg}; a record, not a gate; launches {launches}; {SMI}",
          flush=True)


def run_spatial(dev, fixture, kernels, split):
    """Phase (r): (r1) the spatial pipeline in a world-1 NCCL group, (r2)
    and (r3) R_SP gloo ranks sharing the card (sp=R_SP, then a 2x2 data x
    sp mesh), (r4) the envelope study on (h)'s first images."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        out = os.path.join(tmp, "r1.json")
        _, r1_s = torchrun([os.path.join(REPO, "chip_smoke.py"),
                            "--spatial-worker", out], 1, tmp)
        with open(out) as f:
            r1 = json.load(f)
        for p in r1["requests"].values():
            add_launches(kernels, p["launches"])
        print_spatial("(r1)", "NCCL world 1, a 1x1 mesh (equal to the "
                      "unsharded pipeline bit for bit)", r1["requests"])
        print(f"(r1) the worker took {r1['seconds']:.1f} s, the command "
              f"{r1_s:.1f} s", flush=True)

        out = os.path.join(tmp, "r2.json")
        _, r2_s = torchrun([os.path.join(REPO, "chip_smoke.py"),
                            "--spatial-gloo-worker", out], R_SP, tmp)
        with open(out) as f:
            r2 = json.load(f)
        for part in r2["requests"].values():
            for p in part.values():
                add_launches(kernels, p["launches"])
        gpu = torch.cuda.get_device_name(0)
        print_spatial("(r2)", f"{R_SP} gloo ranks sharing {gpu}, sp={R_SP} "
                      f"({H // R_SP} rows a rank)", r2["requests"]["sp"])
        print_spatial("(r3)", f"{R_SP} gloo ranks sharing {gpu}, a 2x2 data "
                      f"x sp mesh", r2["requests"]["2x2"])
        print(f"(r2), (r3): the workers took {r2['seconds']:.1f} s, the "
              f"command {r2_s:.1f} s; one card with gloo ranks stages every "
              f"halo through the host: a record, not a speed figure",
              flush=True)
        spatial_envelope_study(dev, split, tmp, kernels)
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    workers = {"--parallel-worker": parallel_worker,
               "--gloo-worker": gloo_worker,
               "--spatial-worker": spatial_worker,
               "--spatial-gloo-worker": spatial_gloo_worker}
    if len(sys.argv) == 3 and sys.argv[1] in workers:
        sys.path.insert(0, REPO)         # (q)'s and (r)'s ranks (torchrun)
        return workers[sys.argv[1]](sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    global SMI
    SMI = smi[0]
    sys.path.insert(0, REPO)
    import numpy as np
    from pvnet_tpu_torch.ops import kernel_lib

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        seconds[name] = time.time() - t0
        return out

    lib = phase("(b) build", kernel_lib.build)
    kernel_lib.library()
    print(f"built {os.path.relpath(lib, REPO)} in {seconds['(b) build']:.2f}"
          f" s", flush=True)

    with np.load(FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    kernels = (phase("(c) K1, K2, K3", check_kernels, dev, fixture)
               + phase("(c') K4, K5", check_row_shift, dev))
    int8_route = phase("(c'') int8 route", check_int8_route, dev, fixture)
    latencies, plain_stages = phase("(d) serving", run_pipeline, dev,
                                    fixture, kernels)
    packed_stages = phase("(g) packed serving", run_packed, dev, fixture,
                          kernels, latencies)
    phase("(f) training", run_training, dev, kernels)
    split = phase("(h) evaluation", run_evaluation, dev)
    phase("(i) preset", run_preset, dev, fixture, kernels, plain_stages,
          packed_stages, split)
    phase("(j) deployment", run_deployment, dev, fixture, kernels)
    phase("(k) multi-object, variants", run_multiclass, dev, fixture,
          kernels)
    phase("(l) model family, training, study", run_family, dev, fixture,
          kernels)
    phase("(m) LINEMOD from disk", run_linemod, dev, kernels)
    phase("(n) dataset preparation", run_preparation, dev, kernels)
    phase("(o) demo, gallery, gather warps, packed family",
          run_visualization, dev, fixture, kernels)
    phase("(p) host-augmented training", run_host_route, dev, fixture,
          kernels)
    phase("(q) data parallelism", run_parallel, dev, fixture, kernels)
    phase("(r) spatial partitioning", run_spatial, dev, fixture, kernels,
          split)
    print("seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; whole run {time.time() - T_START:.1f}", flush=True)
    for k in kernels:
        if k["name"] != "shift_sublanes":     # K5: on no path of the system
            assert k["launches"] > 0, f"{k['name']} never launched on its path"

    print(json.dumps({"int8_route": int8_route}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
