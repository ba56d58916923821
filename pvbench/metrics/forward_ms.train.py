"""Milliseconds a step on the card in the forward pass and the loss: the
program's ``train.forward`` span (trainer.batch_loss: vertex targets, the
FCN under the recipe's autocast, the losses) by its CUDA events, over the
cycle of steps profiled with device activity alone
(pvbench/program_spans.py)."""
from pvbench import program_spans as ps

UNIT = "ms"
LAYER = "Whole step: train/trainer.py"
MOVES = "train_imgs_per_s"


def read(rec):
    return ps.mean_inside(rec, "train.step", rec.get("idle_units"),
                          ps.device_ms_of("train.forward"), last=True)
