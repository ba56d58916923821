"""Host synchronizations of the CUDA device a batch inside PnP: the
program's ``host_syncs`` counter summed over its ``pnp`` span and the
spans inside it (``pnp.epnp``, ``pnp.lm``), over the batches of the
stretch profiled with CPU activity (pvbench/program_spans.py). Each one
drains the device's queue; a count that repeats exactly."""
from pvbench import program_spans as ps

UNIT = "syncs"
LAYER = "PnP: ops/pnp.py"
MOVES = "poses_per_s"


def read(rec):
    return ps.mean_inside(rec, "pnp", rec.get("profiled"),
                          ps.counter_of("host_syncs"))
