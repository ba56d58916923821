"""Kernel K3 ``count_inliers`` (float32 counts) against its roofline:
the least time the card could take for each launch in the profiled
stretch, max(algorithm FLOPs / 67 TFLOP/s, bytes once in and out /
3.35 TB/s) from pvbench/flops.py (compute binds at these shapes), over
the kernel's time in the trace."""
from pvbench import flops

UNIT = "%"
LAYER = "Kernel K3 count_inliers"
MOVES = "poses_per_s"


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    secs, n = tr.seconds_matching("count_inliers_kernel")
    if not n or secs <= 0:
        return None
    v = rec["vote"]
    work, nbytes = flops.k3_work(rec["batch"], rec["vn"], v["hyp_num"],
                                 v["max_num"])
    bound, _ = flops.bound_seconds(work, nbytes, rec["f32_peak"])
    return 100.0 * n * bound / secs
