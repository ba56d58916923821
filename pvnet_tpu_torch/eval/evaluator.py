"""Accumulating pose evaluator (ref lib/utils/evaluation_utils.py:64-226).

PyTorch port of pvnet_tpu/eval/evaluator.py. Per-object metadata arrives
as an :class:`ObjectMeta` (keypoints, mesh points, diameter, symmetry
flag), so the evaluator serves LINEMOD, its occlusion and truncation
splits and the synthetic split alike. Per image:

    voted 2D keypoints (+ covariance)  ->  PnP  ->  ADD(-S) / 2D-proj / 5cm5deg

PnP runs on the device of the keypoints it is given (the card on the
evaluation path); the metrics run on ``device`` in chunks of
``_FLUSH_CHUNK`` images, lazily, when a recorder list or the rates are
read. Only the accumulation lists live on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.eval import metrics as M
from pvnet_tpu_torch.pipeline import poses_from_keypoints


@dataclass
class ObjectMeta:
    """Static per-class evaluation metadata.

    Attributes:
      points_3d:  [vn, 3] canonical 3D keypoints (FPS + centre,
                  ref VotingType.get_pts_3d, linemod_dataset.py:142-169).
      model_pts:  [n, 3] mesh vertices for the ADD / projection metrics.
      diameter:   object diameter in metres (ref data_utils.py:111-118).
      symmetric:  use ADD-S (glue/eggbox, ref config.py:70).
      name:       class name (reporting only).
    """
    points_3d: np.ndarray
    model_pts: np.ndarray
    diameter: float
    symmetric: bool = False
    name: str = ""


def _f32(x, device) -> torch.Tensor:
    """float32 tensor; a tensor stays on its device, an array goes to
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


class Evaluator:
    """Accumulates per-image pose metrics; thresholds as the reference
    (ADD < 0.1*diameter, proj < 5 px, 5 cm & 5 deg)."""

    # chunk size of the deferred metric computation: bounds the [chunk,
    # tile, n_model_pts] distance tensors of the symmetric-ADD search
    _FLUSH_CHUNK = 32

    def __init__(self, meta: ObjectMeta, add_percentage: float = 0.1,
                 proj_threshold: float = 5.0, device="cpu"):
        self.meta = meta
        self.add_percentage = add_percentage
        self.proj_threshold = proj_threshold
        self.device = torch.device(device)
        self._projection_2d_recorder: List[bool] = []
        self._add_recorder: List[bool] = []
        self._cm_degree_5_recorder: List[bool] = []
        self._proj_mean_diffs: List[float] = []
        self._add_dists: List[float] = []
        self._pending: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._model = _f32(meta.model_pts, self.device)

    # Metric lists are computed lazily in chunks of _FLUSH_CHUNK images;
    # reading any of them flushes first.
    @property
    def projection_2d_recorder(self) -> List[bool]:
        self._flush()
        return self._projection_2d_recorder

    @property
    def add_recorder(self) -> List[bool]:
        self._flush()
        return self._add_recorder

    @property
    def cm_degree_5_recorder(self) -> List[bool]:
        self._flush()
        return self._cm_degree_5_recorder

    @property
    def proj_mean_diffs(self) -> List[float]:
        self._flush()
        return self._proj_mean_diffs

    @property
    def add_dists(self) -> List[float]:
        self._flush()
        return self._add_dists

    # -- pose estimation front-ends --------------------------------------
    def _solve(self, kps_2d, Ks, covar=None) -> np.ndarray:
        """PnP of a batch, kps [b, vn, 2] and Ks [b, 3, 3] (covar
        [b, vn, 2, 2] for the uncertainty-weighted solver, whose guard
        zeroes degenerate keypoints), on the keypoints' device."""
        kps = _f32(kps_2d, self.device)
        dev = kps.device
        pts3d = _f32(self.meta.points_3d, dev)
        Ks = _f32(Ks, dev)
        cov = None if covar is None else _f32(covar, dev)
        with torch.no_grad():
            pose = poses_from_keypoints(pts3d, kps, Ks, covar=cov)
        return pose.cpu().numpy()

    def evaluate(self, kps_2d, pose_gt, K) -> np.ndarray:
        """Plain path (ref evaluation_utils.py:143-163): kps [vn, 2]."""
        pose = self._solve(_f32(kps_2d, self.device)[None],
                           _f32(K, self.device)[None])[0]
        self._record(pose, pose_gt, K)
        return pose

    def evaluate_uncertainty(self, mean_2d, covar, pose_gt, K) -> np.ndarray:
        """Uncertainty path (ref evaluation_utils.py:165-201): mean
        [vn, 2], covar [vn, 2, 2]."""
        pose = self._solve(_f32(mean_2d, self.device)[None],
                           _f32(K, self.device)[None],
                           _f32(covar, self.device)[None])[0]
        self._record(pose, pose_gt, K)
        return pose

    def evaluate_pose(self, pose_pred, pose_gt, K) -> None:
        """Record metrics for an externally computed pose."""
        self._record(pose_pred, pose_gt, K)

    # -- batched front-ends (one PnP solve per batch) ---------------------
    def evaluate_batch(self, kps_2d, poses_gt, Ks) -> np.ndarray:
        """Plain path over a batch: kps [b, vn, 2], poses_gt [b, 3, 4],
        Ks [b, 3, 3]."""
        poses = self._solve(kps_2d, Ks)
        self._record_batch(poses, poses_gt, Ks)
        return poses

    def evaluate_uncertainty_batch(self, mean_2d, covar, poses_gt,
                                   Ks) -> np.ndarray:
        """Uncertainty path over a batch: covar [b, vn, 2, 2]."""
        poses = self._solve(mean_2d, Ks, covar)
        self._record_batch(poses, poses_gt, Ks)
        return poses

    # -- internals --------------------------------------------------------
    @staticmethod
    def _host(x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float32)

    def _record(self, pose_pred, pose_gt, K):
        self._pending.append((self._host(pose_pred), self._host(pose_gt),
                              self._host(K)))

    def _record_batch(self, poses, poses_gt, Ks):
        poses_gt, Ks = self._host(poses_gt), self._host(Ks)
        for i in range(poses.shape[0]):
            self._record(poses[i], poses_gt[i], Ks[i])

    def _flush(self):
        while self._pending:
            chunk = self._pending[:self._FLUSH_CHUNK]
            self._pending = self._pending[self._FLUSH_CHUNK:]
            pp, pg, Ks = (torch.as_tensor(np.stack([c[i] for c in chunk]),
                                          device=self.device)
                          for i in range(3))
            if self.meta.symmetric:
                add = M.add_error_sym(pp, pg, self._model)
            else:
                add = M.add_error(pp, pg, self._model)
            proj = M.projection_error(pp, pg, self._model, Ks)
            trans_cm, rot_deg = M.cm_degree_errors(pp, pg)
            add, proj, trans_cm, rot_deg = (
                x.cpu().numpy() for x in (add, proj, trans_cm, rot_deg))
            for i in range(len(chunk)):
                add_val = float(add[i])
                self._add_dists.append(add_val)
                self._add_recorder.append(
                    add_val < self.meta.diameter * self.add_percentage)
                proj_val = float(proj[i])
                self._proj_mean_diffs.append(proj_val)
                self._projection_2d_recorder.append(
                    proj_val < self.proj_threshold)
                self._cm_degree_5_recorder.append(
                    float(trans_cm[i]) < 5.0 and float(rot_deg[i]) < 5.0)

    def save_proj_diffs(self, path: str = "tmp.npy") -> str:
        """Dump the raw per-image mean projection errors, as the
        reference's np.save('tmp.npy', ...) (ref evaluation_utils.py:220)."""
        np.save(path, np.asarray(self.proj_mean_diffs, np.float64))
        return path

    def average_precision(self, verbose: bool = True
                          ) -> Tuple[float, float, float]:
        """(2D-proj rate, ADD rate, 5cm5deg rate), NaN where nothing was
        recorded (ref evaluation_utils.py:219-226)."""
        self._flush()

        def rate(rec: List[bool]) -> float:
            return float(np.mean(rec)) if rec else float("nan")

        proj, add, cm = (rate(self._projection_2d_recorder),
                         rate(self._add_recorder),
                         rate(self._cm_degree_5_recorder))
        if verbose:
            print(f"2d projections metric: {proj}")
            print(f"ADD metric: {add}")
            print(f"5 cm 5 degree metric: {cm}")
        return proj, add, cm
