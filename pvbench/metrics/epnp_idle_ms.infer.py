"""Milliseconds a batch that the device idles before work launched inside
EPnP: gaps between device operations in the stretch profiled with CPU
activity whose next operation was launched inside the program's
``pnp.epnp`` span, the program's clock aligned to the trace's by the
``fcn`` and ``voting`` spans (pvbench/program_spans.py)."""
from pvbench import program_spans as ps

UNIT = "ms"
LAYER = "PnP: ops/pnp.py"
MOVES = "poses_per_s"


def read(rec):
    return ps.idle_ms(rec, "pnp.epnp")
