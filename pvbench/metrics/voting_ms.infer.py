"""Milliseconds a batch spends voting: ``pipeline.keypoints_from_fields``
(ops/voting.py: selection through K1, hypotheses, counts through K3, the
refine) and the foreground count, CUDA events around it, the mean over
the traced window's batches."""
UNIT = "ms"
LAYER = "Voting: ops/voting.py"
MOVES = "poses_per_s"


def read(rec):
    ms = rec.get("spans_ms", {}).get("voting")
    return sum(ms) / len(ms) if ms else None
