"""Training data on the host: the multi-resolution batch sampler, copied
from pvnet_tpu/data/dataset.py (``ImageSizeBatchSampler``, pure numpy), and
the reader of a training set stored as one .npz.

The rest of that module (``PoseDataset``, ``Prefetcher``, reading the
LINEMOD layout from disk) is not ported yet: the port trains from arrays
held on the device (train/loop.TrainLoop.build_device_dataset).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from pvnet_tpu_torch.config import AugConfig
from pvnet_tpu_torch.data.pose_transforms import project_np


class ImageSizeBatchSampler:
    """One random (h, w) per batch (ref linemod_dataset.py:293-336).

    ``buckets`` (a small list of (h, w)) restricts the sizes a batch may
    take; ``buckets=None`` draws from the reference's full 8-px grid.
    """

    def __init__(self, indices: Sequence[int], batch_size: int,
                 drop_last: bool = False,
                 aug_cfg: Optional[AugConfig] = None,
                 buckets: Optional[List[Tuple[int, int]]] = None,
                 shuffle: bool = True, seed: int = 0):
        self.indices = list(indices)
        self.batch_size = batch_size
        self.drop_last = drop_last
        cfg = aug_cfg or AugConfig()
        self.cfg = cfg
        self.buckets = buckets
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.hint = (cfg.hmax - cfg.hmin) // cfg.size_int + 1
        self.wint = (cfg.wmax - cfg.wmin) // cfg.size_int + 1

    def generate_height_width(self) -> Tuple[int, int]:
        if self.buckets is not None:
            return self.buckets[self.rng.randint(len(self.buckets))]
        hi = self.rng.randint(0, self.hint)
        wi = self.rng.randint(0, self.wint)
        return (self.cfg.hmin + hi * self.cfg.size_int,
                self.cfg.wmin + wi * self.cfg.size_int)

    def __iter__(self) -> Iterator[List[Tuple[int, int, int]]]:
        order = list(self.indices)
        if self.shuffle:
            self.rng.shuffle(order)
        batch = []
        h, w = self.generate_height_width()
        for idx in order:
            batch.append((idx, h, w))
            if len(batch) == self.batch_size:
                yield batch
                batch = []
                h, w = self.generate_height_width()
        if batch and not self.drop_last:
            yield batch

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def load_training_set(path: str) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """(images uint8 [n, h, w, 3], masks uint8 [n, h, w], hcoords float32
    [n, k, 3]) from an .npz in the layout of tools/make_torch_fixture.py
    (images, masks, poses [n, 3, 4], points_3d [k, 3], K [3, 3]): the
    keypoint targets are the projections of points_3d, homogeneous."""
    with np.load(path) as z:
        images, masks = z["images"], z["masks"]
        poses, pts, K = z["poses"], z["points_3d"], z["K"]
    kp = np.stack([project_np(pts.astype(np.float64), pose.astype(np.float64),
                              K.astype(np.float64)) for pose in poses])
    hcoords = np.concatenate([kp, np.ones(kp.shape[:2] + (1,))], -1)
    return (images.astype(np.uint8), masks.astype(np.uint8),
            hcoords.astype(np.float32))
