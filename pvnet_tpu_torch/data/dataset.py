"""Data on the host, ported from pvnet_tpu/data/dataset.py: the vote-type
registry (``VotingType``), per-record samples of the LINEMOD layout
(``PoseDataset``: host-augmented and normalized at the sampler's size,
plain normalized, or raw full-frame uint8 pixels for the device
augmentation), their batches (``collate``), the threaded look-ahead over
them (``Prefetcher``), the multi-resolution batch sampler
(``ImageSizeBatchSampler``), and the port's own readers: a record list
decoded onto the device in one go (:func:`load_device_set`, the
counterpart of JAX's ``TrainLoop.build_device_dataset``), a training set
stored as one .npz, and the batches of an evaluation split held as arrays.

Frames are decoded by data/image_io (the port's own JPEG/PNG decoder; on a
CUDA device its C entropy decoder and CUDA pixel kernel) onto the
dataset's device, where the host augmentation's pixel work runs too
(data/augment, OpenCV's arithmetic through data/cv_ops); its draws and
geometry run on the host from the dataset's ``RandomState``, in JAX's
order.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.config import (AugConfig, IMAGENET_MEAN, IMAGENET_STD,
                                    LINEMOD_CLS_NAMES)
from pvnet_tpu_torch.data import augment as A
from pvnet_tpu_torch.data.image_io import (DECODE_THREADS, decode_rgb_into,
                                           image_size, read_mask, read_rgb)
from pvnet_tpu_torch.data.pose_transforms import project_np
from pvnet_tpu_torch.data.vertex import compute_vertex_targets_np


class VotingType:
    """Vote-type registry (ref linemod_dataset.py:83-169)."""
    BB8 = "BB8"
    BB8C = "BB8C"
    BB8S = "BB8S"
    Farthest = "Farthest"
    Farthest4 = "Farthest4"
    Farthest12 = "Farthest12"
    Farthest16 = "Farthest16"
    Farthest20 = "Farthest20"

    _FARTHEST_KEY = {
        Farthest: "farthest", Farthest4: "farthest4",
        Farthest12: "farthest12", Farthest16: "farthest16",
        Farthest20: "farthest20",
    }
    _FARTHEST_NUM = {
        Farthest: 8, Farthest4: 4, Farthest12: 12, Farthest16: 16,
        Farthest20: 20,
    }

    @classmethod
    def vote_num(cls, vote_type: str) -> int:
        """Keypoint count incl. center (ref train_linemod.py:38-59)."""
        if vote_type == cls.BB8:
            return 8
        if vote_type in (cls.BB8C, cls.BB8S):
            return 9
        return cls._FARTHEST_NUM[vote_type] + 1

    @classmethod
    def get_data_pts_2d(cls, vote_type: str, data: dict) -> np.ndarray:
        """Homogeneous 2D target keypoints from an image record
        (ref :94-140)."""
        if vote_type == cls.BB8:
            cor = data["corners"].copy()
            return np.concatenate(
                [cor, np.ones([8, 1], np.float32)], 1).astype(np.float32)
        if vote_type == cls.BB8C:
            pts = np.concatenate([data["corners"].copy(),
                                  data["center"].copy()], 0)
        elif vote_type == cls.BB8S:
            pts = np.concatenate([data["small_bbox"].copy(),
                                  data["center"].copy()], 0)
        else:
            far = data[cls._FARTHEST_KEY[vote_type]].copy()
            pts = np.concatenate([far, data["center"].copy()], 0)
        return np.concatenate(
            [pts, np.ones([pts.shape[0], 1], np.float32)],
            1).astype(np.float32)

    @classmethod
    def get_pts_3d(cls, vote_type: str, class_type: str,
                   modeldb) -> np.ndarray:
        """Canonical 3D keypoints for PnP (ref :142-169), from a
        data/linemod.LineModModelDB."""
        if vote_type == cls.BB8:
            return modeldb.get_corners_3d(class_type)
        if vote_type == cls.BB8C:
            base = modeldb.get_corners_3d(class_type)
        elif vote_type == cls.BB8S:
            base = modeldb.get_small_bbox(class_type)
        else:
            base = modeldb.get_farthest_3d(class_type,
                                           cls._FARTHEST_NUM[vote_type])
        return np.concatenate(
            [base, modeldb.get_centers_3d(class_type)[None, :]], 0)


@dataclass
class Sample:
    """One prepared sample: raw full-frame pixels for the device
    augmentation (``out_hw`` set), or the normalized image (host-augmented
    at the sampler's size with ``augment``)."""
    rgb: torch.Tensor         # [h, w, 3] on the dataset's device: uint8
                              # raw, else float32 ImageNet-normalized
    mask: np.ndarray          # [h, w] 0/1: uint8 raw, else int32
    hcoords: np.ndarray       # [k, 3] float32 homogeneous 2D keypoints
    pose: np.ndarray          # [3, 4] float32
    K: Optional[np.ndarray] = None      # [3, 3] per-image intrinsics
    vertex: Optional[np.ndarray] = None  # [h, w, 2k] if computed on host
    ignore_vertex: bool = False         # zero the vertex loss weight
                                        # (fuse set, ref :242)
    out_hw: Optional[Tuple[int, int]] = None   # the sampler's target size
                                               # (raw mode)


def _record_mask_i32(mask: np.ndarray, rec: dict) -> np.ndarray:
    if rec["rnd_typ"] == "real" and mask.ndim == 3:
        mask = np.asarray(np.sum(mask, 2) > 0, np.int32)
    if rec["rnd_typ"] == "fuse":
        mask = np.asarray(
            mask == (LINEMOD_CLS_NAMES.index(rec["cls_typ"]) + 1), np.int32)
    mask = mask.astype(np.int32)
    if mask.max() > 1:
        mask = (mask > 0).astype(np.int32)
    return mask


def record_mask(mask: np.ndarray, rec: dict) -> np.ndarray:
    """The training mask of a record's decoded mask file, uint8 0/1 (JAX
    PoseDataset, pvnet_tpu/data/dataset.py:184-191): a real record's
    colour mask is its non-black pixels, a fuse record's mask the pixels of
    its class's label (class index + 1), any other value above 1 is
    foreground."""
    return np.ascontiguousarray(_record_mask_i32(mask, rec), np.uint8)


class PoseDataset:
    """Load + augment one record (JAX PoseDataset, ref
    LineModDatasetRealAug :174-290), with the JAX package's arguments: the
    frame decoded onto ``device``, the mask by the record's rule, the vote
    type's 2D keypoints, the pose, and with ``use_intrinsic`` the record's
    own K.

    ``raw``: full-frame uint8 pixels for the device augmentation. Else the
    image comes back ImageNet-normalized in float32, host-augmented to the
    sampler's (h, w) with ``augment`` (``_augmentation``; ``fast_aug``
    takes the one-warp path where the recipe allows it), and with
    ``host_vertex`` with its vertex targets. The draws come from one
    ``RandomState(seed)`` of the dataset, in JAX's order; the Prefetcher's
    threads share it, so only one thread reproduces JAX's draws.
    ``cache_images`` keeps the decoded frames and masks."""

    def __init__(self, imagedb: Sequence[dict], data_prefix: str,
                 vote_type: str = VotingType.Farthest,
                 augment: bool = False,
                 aug_cfg: Optional[AugConfig] = None,
                 use_intrinsic: bool = False, use_motion: bool = False,
                 host_vertex: bool = False, seed: int = 0,
                 fast_aug: bool = True, raw: bool = False,
                 cache_images: bool = False, device="cpu"):
        self.imagedb = list(imagedb)
        self.data_prefix = data_prefix
        self.vote_type = vote_type
        self.augment = augment
        self.cfg = aug_cfg or AugConfig()
        self.use_intrinsic = use_intrinsic
        self.use_motion = use_motion
        self.host_vertex = host_vertex
        self.fast_aug = fast_aug
        self.raw = raw
        self.cache_images = cache_images
        self._cache: dict = {}
        self.rng = np.random.RandomState(seed)
        self.device = torch.device(device)
        # on the device: a CUDA division by a host scalar multiplies by
        # its reciprocal, which can round otherwise than numpy's division
        self._255 = torch.tensor(255.0, device=self.device)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)

    def __len__(self) -> int:
        return len(self.imagedb)

    def _read(self, index: int, rec: dict):
        if self.cache_images and index in self._cache:
            return self._cache[index]
        rgb = read_rgb(os.path.join(self.data_prefix, rec["rgb_pth"]),
                       self.device)
        mask = _record_mask_i32(read_mask(os.path.join(
            self.data_prefix, rec["dpt_pth"]), self.device), rec)
        if self.cache_images:
            self._cache[index] = (rgb, mask)
        return rgb, mask

    def __getitem__(self, index_hw: Tuple[int, int, int]) -> Sample:
        """index_hw = (index, target_h, target_w), the batch sampler's
        tuple (ref :200-201)."""
        index, height, width = index_hw
        rec = self.imagedb[index]
        rgb, mask = self._read(index, rec)
        pose = rec["RT"].astype(np.float32)
        hcoords = VotingType.get_data_pts_2d(self.vote_type, rec)
        K = rec["K"].astype(np.float32) if self.use_intrinsic else None
        ignore = (rec["rnd_typ"] == "fuse"
                  and self.cfg.ignore_fuse_ms_vertex)

        if self.raw:
            return Sample(rgb=rgb, mask=np.ascontiguousarray(mask, np.uint8),
                          hcoords=hcoords, pose=pose, K=K,
                          ignore_vertex=ignore, out_hw=(height, width))

        if self.augment:
            rgb, mask, hcoords = self._augmentation(rgb, mask, hcoords,
                                                    height, width)
            if self.cfg.blur and self.rng.random() < 0.5:
                rgb = A.blur_image(rgb, int(self.rng.choice([3, 5, 7, 9])))
            if self.cfg.jitter:
                rgb = A.color_jitter(rgb, self.cfg.brightness,
                                     self.cfg.contrast, self.cfg.saturation,
                                     self.cfg.hue, self.rng)
        rgb = rgb.to(torch.float32) / self._255
        rgb = (rgb - self._mean) / self._std
        if self.augment and self.cfg.use_mask_out \
                and self.rng.random() < 0.1:
            rgb = rgb * torch.from_numpy(
                np.ascontiguousarray(mask[:, :, None], np.float32)).to(
                    rgb.device)

        vertex = None
        if self.host_vertex:
            vertex = compute_vertex_targets_np(mask, hcoords,
                                               self.use_motion)
        return Sample(rgb=rgb, mask=np.ascontiguousarray(mask),
                      hcoords=hcoords.astype(np.float32), pose=pose, K=K,
                      vertex=vertex, ignore_vertex=ignore)

    def _augmentation(self, img, mask, hcoords, height, width):
        """(ref :254-290; JAX dataset.py:222-261)"""
        cfg, rng = self.cfg, self.rng
        foreground = int(np.sum(mask))
        if cfg.mask and rng.random() < 0.5 and foreground > 0:
            img, mask = A.mask_out_instance(img, mask, cfg.min_mask,
                                            cfg.max_mask, rng)
        if foreground > 0:
            if (self.fast_aug and cfg.rotation and cfg.crop
                    and cfg.use_old and np.sum(mask) > 0):
                img, mask, hcoords = A.fused_rotate_crop_resize(
                    img, mask, hcoords, height, width, cfg.rot_ang_min,
                    cfg.rot_ang_max, cfg.overlap_ratio,
                    cfg.resize_ratio_min, cfg.resize_ratio_max, rng)
                if cfg.flip and rng.random() < 0.5:
                    img, mask, hcoords = A.flip(img, mask, hcoords)
                return img, mask, hcoords
            if cfg.rotation:
                img, mask, hcoords = A.rotate_instance(
                    img, mask, hcoords, cfg.rot_ang_min, cfg.rot_ang_max,
                    rng)
            if cfg.crop:
                if cfg.use_old:
                    img, mask, hcoords = A.crop_resize_instance_v1(
                        img, mask, hcoords, height, width,
                        cfg.overlap_ratio, cfg.resize_ratio_min,
                        cfg.resize_ratio_max, rng)
                else:
                    img, mask, hcoords = A.crop_resize_instance_v2(
                        img, mask, hcoords, height, width,
                        cfg.overlap_ratio, cfg.resize_hmin, cfg.resize_hmax,
                        cfg.resize_wmin, cfg.resize_wmax, rng)
        else:
            img, mask = A.crop_or_padding_to_fixed_size(img, mask, height,
                                                        width, rng)
        if cfg.flip and rng.random() < 0.5:
            img, mask, hcoords = A.flip(img, mask, hcoords)
        return img, mask, hcoords


def collate(samples: List[Sample]) -> Dict[str, object]:
    """A batch (JAX collate): image [b, h, w, 3] (a tensor on the
    dataset's device), mask, hcoords, pose and, with per-image intrinsics,
    K. Raw samples: uint8 image and mask, out_hw and ignore. Else: float32
    image, int32 mask, vertex_weights = (mask > 0) * (1 - ignore)
    [b, h, w, 1] and, with host vertex targets, vertex."""
    raw = samples[0].out_hw is not None
    batch = {
        "image": torch.stack([s.rgb for s in samples]),
        "mask": np.stack([s.mask for s in samples]).astype(
            np.uint8 if raw else np.int32),
        "hcoords": np.stack([s.hcoords for s in samples]),
        "pose": np.stack([s.pose for s in samples]),
    }
    ignore = np.array([s.ignore_vertex for s in samples], np.float32)
    if raw:
        batch["out_hw"] = np.asarray(samples[0].out_hw, np.int32)
        batch["ignore"] = ignore
    else:
        batch["vertex_weights"] = ((batch["mask"] > 0)[..., None]
                                   * (1.0 - ignore)[:, None, None, None]
                                   ).astype(np.float32)
    if samples[0].K is not None:
        batch["K"] = np.stack([s.K for s in samples])
    if samples[0].vertex is not None:
        batch["vertex"] = np.stack([s.vertex for s in samples])
    return batch


LOAD_CHUNK = 256    # frames decoded at a time by load_device_set


def load_device_set(records: Sequence[dict], data_prefix: str,
                    vote_type: str = VotingType.Farthest,
                    aug_cfg: Optional[AugConfig] = None, device="cpu"
                    ) -> Dict[str, torch.Tensor]:
    """Decode a whole record list onto ``device`` (the counterpart of JAX's
    ``TrainLoop.build_device_dataset``, pvnet_tpu/train/loop.py:181-211):
    image uint8 [N, h, w, 3], mask uint8 [N, h, w], hcoords float32
    [N, k, 3] and ignore float32 [N], every frame of the first one's size
    (raises otherwise). Frames are decoded LOAD_CHUNK at a time, so that
    at most one chunk's coefficients are held at once (they take 2-4x the
    pixels' bytes)."""
    device = torch.device(device)
    cfg = aug_cfg or AugConfig()
    n = len(records)
    if n == 0:
        raise ValueError("no records")
    paths = [os.path.join(data_prefix, r["rgb_pth"]) for r in records]
    h, w = image_size(paths[0])
    images = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    masks = np.empty((n, h, w), np.uint8)

    def mask_of(i):
        m = record_mask(read_mask(os.path.join(
            data_prefix, records[i]["dpt_pth"]), device), records[i])
        if m.shape != (h, w):
            raise ValueError(f"uniform image sizes needed; the mask of "
                             f"record {i} is {m.shape}, frames {(h, w)}")
        masks[i] = m

    with ThreadPoolExecutor(DECODE_THREADS) as pool:
        for i in range(0, n, LOAD_CHUNK):
            sl = slice(i, min(n, i + LOAD_CHUNK))
            try:
                decode_rgb_into(paths[sl], images[sl])
            except ValueError as e:
                raise ValueError(f"uniform image sizes needed: {e}") from e
            list(pool.map(mask_of, range(sl.start, sl.stop)))
    hcoords = np.stack([VotingType.get_data_pts_2d(vote_type, r)
                        for r in records]).astype(np.float32)
    ignore = np.array([r["rnd_typ"] == "fuse" and cfg.ignore_fuse_ms_vertex
                       for r in records], np.float32)
    return {"image": images, "mask": torch.from_numpy(masks).to(device),
            "hcoords": torch.from_numpy(hcoords).to(device),
            "ignore": torch.from_numpy(ignore).to(device)}


class Prefetcher:
    """Threaded look-ahead over (dataset, batch sampler) producing collated
    batches (JAX Prefetcher; the reference's 12 DataLoader workers)."""

    def __init__(self, dataset: PoseDataset, batch_sampler,
                 num_threads: int = 4, prefetch: int = 4):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        batch_queue: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        index_queue: "queue.Queue" = queue.Queue()
        batches = list(self.batch_sampler)
        for i, b in enumerate(batches):
            index_queue.put((i, b))
        results: Dict[int, dict] = {}
        stop = threading.Event()

        def put(item):
            # a bounded put that gives up once the consumer has gone: a
            # blocking put would pin a worker on a full queue forever when
            # the caller stops iterating early
            while not stop.is_set():
                try:
                    batch_queue.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            while not stop.is_set():
                try:
                    i, spec = index_queue.get_nowait()
                except queue.Empty:
                    return
                try:
                    put((i, collate([self.dataset[s] for s in spec])))
                except BaseException as e:   # propagate, never deadlock
                    put((i, e))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            next_i = 0
            received = 0
            while received < len(batches):
                i, batch = batch_queue.get()
                if isinstance(batch, BaseException):
                    raise RuntimeError(
                        f"prefetch worker failed on batch {i}") from batch
                received += 1
                results[i] = batch
                while next_i in results:
                    yield results.pop(next_i)
                    next_i += 1
        finally:
            # on exhaustion, an exception or the consumer's close: release
            # the workers and their queued batches
            stop.set()
            while any(t.is_alive() for t in threads):
                try:
                    batch_queue.get_nowait()
                except queue.Empty:
                    time.sleep(0.01)
            results.clear()


def record_loader(records: Sequence[dict], data_prefix: str,
                  vote_type: str, batch_size: int,
                  aug_cfg: Optional[AugConfig] = None,
                  use_intrinsic: bool = False, device="cpu",
                  num_threads: int = 4) -> Prefetcher:
    """The validation / test loader of a record list: raw samples in
    order, ``batch_size`` a batch, the last one short (tools/train.py's
    unshuffled PoseDataset + ImageSizeBatchSampler + Prefetcher)."""
    ds = PoseDataset(records, data_prefix, vote_type, aug_cfg=aug_cfg,
                     use_intrinsic=use_intrinsic, raw=True, device=device)
    sampler = ImageSizeBatchSampler(range(len(ds)), batch_size,
                                    aug_cfg=aug_cfg, shuffle=False)
    return Prefetcher(ds, sampler, num_threads=num_threads)


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
