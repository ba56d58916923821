"""Data on the host: the multi-resolution batch sampler, copied from
pvnet_tpu/data/dataset.py (``ImageSizeBatchSampler``, pure numpy), the
reader of a training set stored as one .npz, and the batches of an
evaluation split held as arrays.

The rest of that module (``PoseDataset``, ``Prefetcher``, reading the
LINEMOD layout from disk) is not ported yet: the port trains from arrays
held on the device (train/loop.TrainLoop.build_device_dataset) and
evaluates arrays (:func:`eval_batches`).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

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


def keypoint_targets(poses: np.ndarray, points_3d: np.ndarray,
                     K: np.ndarray) -> np.ndarray:
    """hcoords float32 [n, k, 3]: the projections of points_3d [k, 3] under
    each pose [n, 3, 4] with K [3, 3], homogeneous (the keypoint fields of
    the JAX package's image records, data/linemod._project_record)."""
    kp = np.stack([project_np(points_3d.astype(np.float64),
                              pose.astype(np.float64), K.astype(np.float64))
                   for pose in poses])
    return np.concatenate([kp, np.ones(kp.shape[:2] + (1,))],
                          -1).astype(np.float32)


def load_training_set(path: str) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """(images uint8 [n, h, w, 3], masks uint8 [n, h, w], hcoords float32
    [n, k, 3]) from an .npz in the layout of tools/make_torch_fixture.py
    (images, masks, poses [n, 3, 4], points_3d [k, 3], K [3, 3]): the
    keypoint targets are the projections of points_3d, homogeneous."""
    with np.load(path) as z:
        images, masks = z["images"], z["masks"]
        hcoords = keypoint_targets(z["poses"], z["points_3d"], z["K"])
    return images.astype(np.uint8), masks.astype(np.uint8), hcoords


def eval_batches(split: Dict[str, np.ndarray], batch_size: int
                 ) -> Iterator[Dict[str, np.ndarray]]:
    """Validation batches of a split in the fixture's layout (images,
    masks, poses, points_3d and K [3, 3], or per image [n, 3, 3]), in
    order, the last one short: what the JAX package's unaugmented
    PoseDataset and unshuffled sampler yield, with the image still uint8.
    Each batch: image uint8 [b, h, w, 3], mask uint8 [b, h, w], hcoords
    [b, k, 3], pose [b, 3, 4], K [b, 3, 3]."""
    n = len(split["images"])
    K = np.asarray(split["K"], np.float32)
    Ks = np.broadcast_to(K, (n, 3, 3)) if K.ndim == 2 else K
    for i in range(0, n, batch_size):
        sl = slice(i, i + batch_size)
        poses = np.asarray(split["poses"][sl], np.float32)
        hcoords = np.stack([keypoint_targets(poses[j:j + 1],
                                             split["points_3d"], Ks[i + j])[0]
                            for j in range(len(poses))])
        yield {"image": split["images"][sl], "mask": split["masks"][sl],
               "hcoords": hcoords, "pose": poses,
               "K": np.ascontiguousarray(Ks[sl])}
