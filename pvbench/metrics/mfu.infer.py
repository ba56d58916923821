"""The whole batch's share of the card's peak: the FCN's FLOPs of every
image posed in the traced window (pvbench/flops.py, counted for the
cell's configuration's network: 144.88 GFLOP a 480x640 image through
Resnet18_8s, 385.5 through Resnet50_8s), over the window, against the
published dense peak of the configuration's FCN precision (float32
outside the tensor cores 67 TFLOP/s; bfloat16 989), at the card's power
limit. Compute bound by construction."""
UNIT = "%"
LAYER = "Whole batch: pipeline.estimate_poses"
MOVES = "poses_per_s"


def read(rec):
    if not rec.get("batches") or not rec.get("window_s"):
        return None
    done = rec["batches"] * rec["batch"] * rec["fcn_flops"]
    return 100.0 * done / rec["window_s"] / rec["fcn_peak"]
