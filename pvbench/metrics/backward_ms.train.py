"""Milliseconds a step on the card in the backward pass: the program's
``train.backward`` span (``loss.backward()``) by its CUDA events, over the
cycle of steps profiled with device activity alone
(pvbench/program_spans.py)."""
from pvbench import program_spans as ps

UNIT = "ms"
LAYER = "Whole step: train/trainer.py"
MOVES = "train_imgs_per_s"


def read(rec):
    return ps.mean_inside(rec, "train.step", rec.get("idle_units"),
                          ps.device_ms_of("train.backward"), last=True)
