"""Kernel K4 ``shift_lanes`` against its roofline: for the profiled
steps, the least time of its two launches a step (bytes read once and
written once, with the row starts, over 3.35 TB/s; it does no arithmetic,
so bytes bind), over the kernel's time in the trace."""
from pvbench import flops

UNIT = "%"
LAYER = "Kernel K4 shift_lanes"
MOVES = "train_imgs_per_s"


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    secs, n = tr.seconds_matching("shift_lanes_kernel")
    if not n or secs <= 0:
        return None
    src_h, src_w = rec["src_hw"]
    nbytes = sum(flops.k4_step_bytes(rec["batch"], src_h, src_w, h)
                 for h, _ in rec["profiled_sizes"])
    return 100.0 * nbytes / flops.HBM_BYTES_PER_S / secs
