"""The numbers that decide ``correct``, each held against its limit.

Offline pose cells: a sample of the answers finished in the window, drawn
from the seed, against the plain reference run on the same images with
the same draws.

- ``fg_gap``: the foreground pixel counts apart, summed over the sample,
  over the reference's sum (the FCN's mask).
- ``kp_median_px``: the median distance between the program's and the
  reference's keypoints (the FCN's field and the voting).
- ``pose_median_px``: the median over the sample of the mean distance
  between the object's keypoints projected by the program's pose and by
  the reference's least-squares pose from the reference's keypoints
  (PnP, end to end; a distance in the image, so that a near-symmetric
  object's two basins of equal reprojection error read alike where the
  keypoints do).
- ``kp_mean_px`` and ``pose_mean_px``: the same distances averaged over
  every sampled keypoint and answer, leaving out the widest 1/32 (2 of
  64 answers): a fault in part of a batch, such as wrong poses for a
  quarter of its rows, moves a mean where it leaves a median be, while
  the rare answer on which the program's and the reference's PnP end in
  different minima (several px on one answer in a few seeds) is left
  out.

Training cells: the reference follows the program's first steps from the
same initial weights, batches and draws.

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: over the leaves, the largest gap between the norms of
  the program's first gradient (Adam's first moment after one step, over
  1 - beta1) and the reference's, over the larger of the reference leaf's
  norm and the median leaf's.
- ``delta_gap``: the same of each leaf's change over the steps, leaving
  out the leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone under Adam).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def offline_readings(prog: dict, ref: dict, pose_px: np.ndarray) -> dict:
    """prog / ref: {"kps" [n, vn, 2], "fg" [n]} as numpy; pose_px [n] the
    mean keypoint distance between the two poses' projections."""
    fg_p, fg_r = prog["fg"].astype(np.float64), ref["fg"].astype(np.float64)
    d = np.linalg.norm(prog["kps"].astype(np.float64)
                       - ref["kps"].astype(np.float64), axis=-1)

    def stat(fn, x):
        return float(fn(x)) if np.isfinite(x).all() else float("inf")

    return {"fg_gap": float(np.abs(fg_p - fg_r).sum() / max(fg_r.sum(), 1)),
            "kp_median_px": stat(np.median, d),
            "pose_median_px": stat(np.median, pose_px),
            "kp_mean_px": stat(trimmed_mean, d),
            "pose_mean_px": stat(trimmed_mean, pose_px)}


def trimmed_mean(x: np.ndarray, part: int = 32) -> float:
    """The mean of ``x`` leaving out its widest 1/``part`` (rounded
    down)."""
    x = np.sort(np.asarray(x, np.float64).ravel())
    return float(x[:len(x) - len(x) // part].mean())


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> float:
    med = float(np.median([ref[k] for k in keep]))
    return float(max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                     for k in keep))


def train_readings(prog: dict, ref: dict) -> dict:
    """prog / ref: {"loss": [per step], "grad_norm": {leaf: norm},
    "delta_norm": {leaf: norm}}."""
    lp, lr = np.asarray(prog["loss"]), np.asarray(ref["loss"])
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr))) \
        if np.isfinite(lp).all() else float("inf")
    leaves = sorted(ref["grad_norm"])
    med = float(np.median([ref["grad_norm"][k] for k in leaves]))
    moving = [k for k in leaves if ref["grad_norm"][k] >= 1e-3 * med]
    steps = {f"loss_gap_step{i + 1}": float(abs(a - b) / abs(b))
             for i, (a, b) in enumerate(zip(lp, lr))}
    return {**steps, "loss_gap": loss_gap,
            "grad_gap": _leaf_gap(prog["grad_norm"], ref["grad_norm"],
                                  leaves),
            "delta_gap": _leaf_gap(prog["delta_norm"], ref["delta_norm"],
                                   moving)}


def leaf_norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in t.items()}


def judge(readings: dict, limits: dict) -> bool:
    """Every reading finite and at or under its limit."""
    return all(np.isfinite(readings[k]) and readings[k] <= limits[k]
               for k in limits)


def lines(readings: dict, limits: dict) -> List[str]:
    return [f"check {k}: {readings[k]!r} limit {limits[k]!r}"
            for k in limits]
