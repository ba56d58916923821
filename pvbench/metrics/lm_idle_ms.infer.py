"""Milliseconds a batch that the device idles before work launched inside
the Levenberg-Marquardt refine: gaps in the stretch profiled with CPU
activity whose next device operation was launched inside the program's
``pnp.lm`` span (pvbench/program_spans.py)."""
from pvbench import program_spans as ps

UNIT = "ms"
LAYER = "PnP: ops/pnp.py"
MOVES = "poses_per_s"


def read(rec):
    return ps.idle_ms(rec, "pnp.lm")
