"""Milliseconds a batch that the host spends in the Levenberg-Marquardt
refine: the program's ``pnp.lm`` span (ops/pnp.py ``lm_multi_start``, 4
starts of 16 iterations a problem) on the host clock, over the batches of
``estimate_poses`` in the stretch profiled with device activity alone,
which slows the host less than the one with CPU activity. The span opens
after PnP's first host synchronization, which waits for the FCN and the
voting, so it holds none of that wait (pvbench/program_spans.py)."""
from pvbench import program_spans as ps

UNIT = "ms"
LAYER = "PnP: ops/pnp.py"
MOVES = "poses_per_s"


def read(rec):
    return ps.mean_inside(rec, "pnp", rec.get("idle_units"),
                          ps.host_ms_of("pnp.lm"), last=True)
