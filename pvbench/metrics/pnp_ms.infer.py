"""Milliseconds a batch spends in PnP: ``pipeline.poses_from_keypoints``
(ops/pnp.py: EPnP and Levenberg-Marquardt), on the host clock between two
synchronizations, the mean over the traced window's batches."""
UNIT = "ms"
LAYER = "PnP: ops/pnp.py"
MOVES = "poses_per_s"


def read(rec):
    ms = rec.get("host_ms", {}).get("pnp")
    return sum(ms) / len(ms) if ms else None
