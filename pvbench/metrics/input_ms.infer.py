"""Milliseconds a batch spends in upload and normalization: the host
batch copied to the card and ``pipeline.normalize_images``, CUDA events
around them, the mean over the traced window's batches."""
UNIT = "ms"
LAYER = "Entry: upload and pipeline.normalize_images"
MOVES = "poses_per_s"


def read(rec):
    ms = rec.get("spans_ms", {}).get("input")
    return sum(ms) / len(ms) if ms else None
