"""The whole step's share of the card's peak: 3x the forward FLOPs of
every step in the traced window at its (h, w) and batch
(pvbench/flops.py), over the window, against the published dense
bfloat16 peak (989 TFLOP/s), at the card's power limit. Compute bound by
construction."""
UNIT = "%"
LAYER = "Whole step: train/trainer.py"
MOVES = "train_imgs_per_s"


def read(rec):
    if not rec.get("step_flops") or not rec.get("window_s"):
        return None
    return 100.0 * sum(rec["step_flops"]) / rec["window_s"] / \
        rec["bf16_peak"]
