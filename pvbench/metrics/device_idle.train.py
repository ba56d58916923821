"""Share of the traced run's window in which the card ran no kernel,
copy or fill: the device's busy seconds a step from a stretch profiled
with torch.profiler's device activity alone (no CPU activity, no spans;
the union of its intervals), times the window's steps, against the
window's host clock, which no profiler slowed (pvbench/trace.py)."""
from pvbench import trace

UNIT = "%"
LAYER = "Device"
MOVES = "train_imgs_per_s"


def read(rec):
    busy = trace.window_busy_s(rec)
    if busy is None or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - busy / rec["window_s"])
