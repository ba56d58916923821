"""Faults planted in the program for the checks that ``correct`` has to
fail (pvbench/control.py on the card, pvbench/tests on the CPU). Each is a
context manager that patches the program's public functions underneath
the timed path and restores them on exit.

- ``altered``: the voting's keypoints come out moved by 1.5 px (an answer
  altered where it is produced).
- ``half_batch``: the pose path poses only the first half of each batch
  and returns zeros for the rest; a training step takes its loss over the
  first half of the batch.
- ``pnp_quarter``: PnP gives each row of the last quarter of a batch the
  pose of the row before it (finite, plausible and wrong; the masks and
  the keypoints stay right).
- ``voting_quarter``: the voting gives each row of the last quarter of a
  batch the keypoints of the row before it (the masks stay right).
- ``unchanged``: the optimizer's step leaves every parameter as it was.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def altered():
    from pvnet_tpu_torch import pipeline
    real = pipeline.keypoints_from_fields

    def moved(*a, **k):
        return real(*a, **k) + 1.5

    with _patched(pipeline, "keypoints_from_fields", moved):
        yield


@contextlib.contextmanager
def half_batch():
    import torch
    from pvnet_tpu_torch import pipeline
    from pvnet_tpu_torch.train import trainer
    real_est, real_kp = pipeline.estimate_poses, pipeline.keypoints_from_fields
    real_loss = trainer.batch_loss

    def est(model, images, *a, **k):
        n = images.shape[0] // 2
        for key in ("noise", "pair_u"):
            if k.get(key) is not None:
                k[key] = k[key][:n]
        out = real_est(model, images[:n], *a, **k)
        return pipeline.PoseEstimate(*(torch.cat(
            [t, torch.zeros_like(t)])[:images.shape[0]] for t in out))

    def kps(mask, vertex, params=pipeline.VoteParams(), noise=None,
            pair_u=None, *a, **k):
        out = real_kp(mask, vertex, params, noise, pair_u, *a, **k)
        out[out.shape[0] // 2:] = 0
        return out

    def loss(model, batch, *a, **k):
        n = batch["image"].shape[0] // 2
        return real_loss(model, {key: v[:n] for key, v in batch.items()},
                         *a, **k)

    with _patched(pipeline, "estimate_poses", est), \
            _patched(pipeline, "keypoints_from_fields", kps), \
            _patched(trainer, "batch_loss", loss):
        yield


def _last_quarter_from_row_before(out):
    q = out.shape[0] - out.shape[0] // 4
    out = out.clone()
    out[q:] = out[q - 1:-1].clone()
    return out


@contextlib.contextmanager
def pnp_quarter():
    from pvnet_tpu_torch import pipeline
    real = pipeline.poses_from_keypoints

    def poses(*a, **k):
        return _last_quarter_from_row_before(real(*a, **k))

    with _patched(pipeline, "poses_from_keypoints", poses):
        yield


@contextlib.contextmanager
def voting_quarter():
    from pvnet_tpu_torch import pipeline
    real = pipeline.keypoints_from_fields

    def kps(*a, **k):
        return _last_quarter_from_row_before(real(*a, **k))

    with _patched(pipeline, "keypoints_from_fields", kps):
        yield


@contextlib.contextmanager
def unchanged():
    import torch

    def step(self, closure=None):
        return None

    with _patched(torch.optim.Adam, "step", step):
        yield


FAULTS = {"altered": altered, "half_batch": half_batch,
          "pnp_quarter": pnp_quarter, "voting_quarter": voting_quarter,
          "unchanged": unchanged}
