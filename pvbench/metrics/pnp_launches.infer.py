"""Device operations (kernels, copies, fills) that PnP launches a batch:
those whose launch lies inside the ``pnp`` span in the profiled stretch,
over its batches."""
UNIT = "launches"
LAYER = "PnP: ops/pnp.py"
MOVES = "poses_per_s"


def read(rec):
    tr, n = rec.get("trace"), rec.get("profiled")
    if tr is None or not n:
        return None
    count = tr.launched_in("pnp")
    return count / n if count else None
