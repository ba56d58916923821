"""Milliseconds a batch spends in the FCN: ``pipeline.predict_fields``
(models/pvnet.py, models/resnet.py; cuDNN) under the configuration's
autocast, CUDA events around it, the mean over the traced window's
batches."""
UNIT = "ms"
LAYER = "FCN: models/pvnet.py, models/resnet.py"
MOVES = "poses_per_s"


def read(rec):
    ms = rec.get("spans_ms", {}).get("fcn")
    return sum(ms) / len(ms) if ms else None
