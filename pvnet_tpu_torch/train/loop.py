"""The training loops and the validation pass (ref
tools/train_linemod.py:132-253, 305-347), ported from
pvnet_tpu/train/loop.py (``TrainLoop``). Per epoch: the learning rate from
the schedule, the steps, a scalar record every ``loss_rec_step`` steps, a
checkpoint, and on the JAX loop's schedule the validation pass (loss
meters, and pose evaluation: FCN -> voting -> PnP -> ADD(-S) /
2D-projection / 5cm5deg, :meth:`TrainLoop.validate`).

The steps take one of JAX's three routes (:meth:`TrainLoop.fit_records`
branches on ``cfg.device_aug`` / ``cfg.device_data`` as JAX's ``fit``):

- host augmentation (neither flag, tools/train.py's default): the
  Prefetcher's threads load, augment and normalize each sample
  (data/dataset.PoseDataset(augment=True)) and :meth:`TrainLoop.train_epoch`
  streams the batches into the step;
- ``device_aug``: :meth:`TrainLoop.train_epoch` streams raw uint8 batches
  and the step augments them on the device;
- ``device_data`` (implies ``device_aug``): the whole training set lives
  on the device as uint8 frames, each step gathers its minibatch there by
  index and augments it there (:meth:`TrainLoop.train_epoch_from_data`).

The model is built from the recipe's int8 options (config.model_kwargs):
training runs float, the evaluation int8, with static scales from
:meth:`TrainLoop.calibrate_quant` once it has run and per-image scales
before.

A run starts from the JAX loop's He fan-out draw, from an ImageNet
backbone (``imagenet_pth``: the reference's standard init, the heads
fresh) and/or from the weights of a checkpoint (``init``).

The training set comes as LINEMOD records read from disk
(:meth:`TrainLoop.fit_records`: ``train_db``, ``val_db``, ``data_prefix``,
as the JAX loop's ``fit`` takes them; frames decoded by data/image_io) or
as arrays (:meth:`TrainLoop.fit`: the ``--data`` fixture route, held on
the device). :meth:`TrainLoop.validate` writes the intermediate results of
``--save_inter_result`` (``save_inter_dir``) as the JAX loop does.

Data parallelism (``use_mesh=True``, the JAX loop's default): under an
initialized process group (parallel.init_process_group, one process per
device) the loop trains over the group's mesh. The state is replicated
from rank 0 and its BatchNorm layers synchronized (parallel.convert_sync);
the steps are trainer's ``make_sharded_*``. Every rank runs the same
sampler (seeded alike: the same sizes and global batches) and takes its
rows: of each ``idx`` on the resident set, or, streamed, its own loader
builds only its rows of each batch (the host augmentation's draws then
come from ``RandomState(seed + rank)``). ``cfg.train_batch_size`` is the
global batch. Checkpoints, the record log and the validation pass are
rank 0's. Without a group the mesh has world size 1 and no group, and
the same steps make no collective call: the one-device loop.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from pvnet_tpu_torch import pipeline as pl_mod
from pvnet_tpu_torch.config import (LINEMOD_K, SYMMETRIC_CLS_NAMES,
                                    PathConfig, TrainConfig,
                                    VOTE_TYPE_TO_NUM, model_kwargs)
from pvnet_tpu_torch.data.dataset import (ImageSizeBatchSampler, PoseDataset,
                                          Prefetcher, VotingType,
                                          eval_batches, load_device_set,
                                          record_loader)
from pvnet_tpu_torch.data.augment_device import AugDraws
from pvnet_tpu_torch.data.image_io import write_png
from pvnet_tpu_torch.data.linemod import LineModModelDB
from pvnet_tpu_torch.eval.evaluator import Evaluator, ObjectMeta
from pvnet_tpu_torch.models.pvnet import build_model
from pvnet_tpu_torch.models.resnet import init_weights
from pvnet_tpu_torch.ops import quant_conv
from pvnet_tpu_torch.parallel import Mesh, make_mesh, replicate
from pvnet_tpu_torch.train import trainer as trainer_mod
from pvnet_tpu_torch.train.checkpoint import load_model, save_model
from pvnet_tpu_torch.train.recorder import AverageMeter, Recorder
from pvnet_tpu_torch.utils.viz import imagenet_to_uint8
from pvnet_tpu_torch.utils.weights import (load_imagenet_backbone,
                                           load_weights)

_METRICS = ("loss", "seg_loss", "ver_loss", "precision", "recall")


class _RankRows:
    """A batch sampler's global batches, cut to this rank's rows."""

    def __init__(self, sampler, mesh):
        self.sampler, self.mesh = sampler, mesh

    def __len__(self):
        return len(self.sampler)

    def __iter__(self):
        for batch in self.sampler:
            yield batch[self.mesh.rows(len(batch))]


class TrainLoop:
    """End-to-end trainer for one object class, on one device or data
    parallel over a process group (``use_mesh``, the module docstring)."""

    def __init__(self, cfg: TrainConfig, model_dir: str,
                 record_dir: Optional[str] = None,
                 buckets: Optional[List[Tuple[int, int]]] = None,
                 device="cuda", use_mesh: bool = True):
        self.cfg = cfg
        self.vote_num = VOTE_TYPE_TO_NUM[cfg.vote_type]
        self.model_dir = model_dir
        self.mesh = (make_mesh(device) if use_mesh
                     else Mesh(0, 1, torch.device(device)))
        self.is_main = self.mesh.is_main
        self.recorder = Recorder(record_dir if self.is_main else None)
        self.buckets = buckets
        self.device = self.mesh.device
        self.mesh.rows(cfg.train_batch_size)          # raises if uneven
        # per trained epoch: {epoch, steps, seconds, losses (every step's)}
        self.epoch_log: List[Dict] = []

    # -- state ------------------------------------------------------------
    def init_state(self, init: Optional[str] = None,
                   imagenet_pth: Optional[str] = None
                   ) -> trainer_mod.TrainState:
        """A fresh train state: He fan-out weights drawn from cfg.seed;
        with ``imagenet_pth`` the backbone from a torchvision ImageNet
        checkpoint, its arch read off cfg.network as the JAX loop does
        (resnet18_8s -> resnet18); then with ``init`` all weights from it
        (a flax msgpack or a port ``.pth``). The model has the recipe's
        int8 options (float in training)."""
        model = build_model(self.cfg.network, ver_dim=self.vote_num * 2,
                            seg_dim=2, **model_kwargs(self.cfg))
        init_weights(model, torch.Generator().manual_seed(self.cfg.seed))
        if imagenet_pth:
            load_imagenet_backbone(model, imagenet_pth,
                                   arch=self.cfg.network.split("_")[0])
        if init:
            load_weights(model, init)
        return trainer_mod.create_train_state(replicate(model, self.mesh),
                                              self.cfg)

    def resume(self, state: trainer_mod.TrainState
               ) -> Tuple[trainer_mod.TrainState, int]:
        """Continue from the latest checkpoint in model_dir when
        cfg.resume (ref train_linemod.py:307-308); else start at epoch 0."""
        if not self.cfg.resume:
            return state, 0
        return load_model(state, self.model_dir, epoch=-1)

    # -- data -------------------------------------------------------------
    def build_device_dataset(self, images: np.ndarray, masks: np.ndarray,
                             hcoords: np.ndarray,
                             ignore: Optional[np.ndarray] = None
                             ) -> Dict[str, torch.Tensor]:
        """Park the training set on the device: images [N, h, w, 3] uint8,
        masks [N, h, w] uint8, hcoords [N, k, 3] float32, ignore [N]
        (1 drops an image's vertex loss; default 0)."""
        n = len(images)
        if ignore is None:
            ignore = np.zeros((n,), np.float32)
        arrays = {"image": np.asarray(images, np.uint8),
                  "mask": np.asarray(masks, np.uint8),
                  "hcoords": np.asarray(hcoords, np.float32),
                  "ignore": np.asarray(ignore, np.float32)}
        for k, v in arrays.items():
            if len(v) != n:
                raise ValueError(f"{k} has {len(v)} records, images {n}")
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in arrays.items()}

    def build_device_dataset_from_records(self, records, data_prefix: str
                                          ) -> Dict[str, torch.Tensor]:
        """Decode a record list onto the device (JAX
        ``build_device_dataset``): frames, masks by the records' rules,
        the vote type's keypoints, the fuse records' ignore flags; every
        frame of one size."""
        return load_device_set(records, data_prefix, self.cfg.vote_type,
                               self.cfg.aug_cfg, self.device)

    # -- steps ------------------------------------------------------------
    def _epoch(self, batches, step, size: int, epoch: int,
               max_steps: Optional[int]) -> int:
        """Run ``step(idx, batch)`` -> metrics over an epoch's batches (or
        its first ``max_steps``). Metrics are read back to the host only
        at record steps; the epoch's seconds, steps, losses and seconds
        spent waiting for the next batch go to :attr:`epoch_log`."""
        meters = {k: AverageMeter() for k in _METRICS}
        begin = time.time()
        pending, losses = [], []
        steps, wait = 0, 0.0
        it = iter(batches)
        try:
            for idx in range(size):
                if max_steps is not None and steps >= max_steps:
                    break
                t0 = time.time()
                batch = next(it, None)
                wait += time.time() - t0
                if batch is None:
                    break
                pending.append(step(idx, batch))
                steps += 1
                if idx % self.cfg.loss_rec_step == 0:
                    for met in pending:
                        for k, m in meters.items():
                            m.update(float(met[k]))
                        losses.append(float(met["loss"]))
                    pending.clear()
                    self.recorder.rec_loss_batch(
                        {f"train/scalar/{k}": m.avg
                         for k, m in meters.items()},
                        epoch * size + idx, epoch)
                    for m in meters.values():
                        m.reset()
        finally:
            close = getattr(it, "close", None)
            if close is not None:       # release a Prefetcher's threads
                close()
        losses += [float(met["loss"]) for met in pending]
        seconds = time.time() - begin
        self.epoch_log.append({"epoch": epoch, "steps": steps,
                               "seconds": seconds, "wait_s": wait,
                               "losses": losses})
        print(f"epoch {epoch} training cost {seconds:.1f} s "
              f"({steps} steps)", flush=True)
        return steps

    def train_epoch_from_data(self, state, data, sampler, epoch: int,
                              max_steps: Optional[int] = None):
        """One epoch (or its first ``max_steps`` steps) of device-data
        training; the sampler yields (index, h, w) batches."""
        seed = np.random.SeedSequence([self.cfg.seed, 7919 * (epoch + 1)])
        gen = torch.Generator(self.device).manual_seed(
            int(seed.generate_state(1)[0]))
        kw = dict(vertex_loss_ratio=self.cfg.vertex_loss_ratio,
                  use_motion=self.cfg.motion_model, aug_cfg=self.cfg.aug_cfg,
                  bf16=self.cfg.bf16)

        def step(idx, batch_ihw):
            # a copy from pinned memory does not wait for the device's queue
            ids = torch.tensor([i for i, _, _ in batch_ihw],
                               dtype=torch.int64)
            if self.device.type == "cuda":
                ids = ids.pin_memory()
            ids = ids.to(self.device, non_blocking=True)
            aug_hw = (batch_ihw[0][1], batch_ihw[0][2])
            return trainer_mod.make_sharded_train_step_from_data(
                self.mesh, aug_hw=aug_hw, **kw)(state, data, ids, gen)
        steps = self._epoch(sampler, step, len(sampler), epoch, max_steps)
        return state, steps

    def train_epoch(self, state, loader, epoch: int,
                    max_steps: Optional[int] = None,
                    draws: Optional[Callable[[int, int], AugDraws]] = None):
        """One epoch (or its first ``max_steps`` steps) over a loader's
        batches (JAX's ``train_epoch``, pvnet_tpu/train/loop.py:253-304).
        A host-augmented batch (data.dataset.collate's non-raw branch)
        goes to the step as it is; a raw one (``cfg.device_aug``) is
        augmented on the device, step ``idx``'s draws from a generator
        seeded with the ``idx``-th pair of
        ``SeedSequence([seed, 7919 * (epoch + 1)])`` (JAX's per-step
        keys), or ``draws(idx, b)`` where given. Data parallel, the loader
        yields this rank's rows; ``b`` and the draws are the global
        batch's."""
        size = len(loader)
        keys = np.random.SeedSequence(
            [self.cfg.seed, 7919 * (epoch + 1)]).generate_state(
                2 * size).astype(np.uint64).reshape(size, 2)
        kw = dict(vertex_loss_ratio=self.cfg.vertex_loss_ratio,
                  use_motion=self.cfg.motion_model, bf16=self.cfg.bf16)

        mesh = self.mesh

        def step(idx, batch):
            if "out_hw" not in batch:
                dev = trainer_mod.host_batch(batch, self.device)
                return trainer_mod.make_sharded_train_step(
                    mesh, **kw)(state, dev, local=True)
            dev = {"image": batch["image"].to(self.device)}
            for k in ("mask", "hcoords", "ignore"):
                dev[k] = torch.from_numpy(batch[k]).to(self.device)
            b = len(batch["hcoords"]) * mesh.size
            if draws is not None:
                extra = {"draws": draws(idx, b)}
            else:
                k0, k1 = keys[idx % size]
                extra = {"generator": torch.Generator(
                    self.device).manual_seed(int(k0 << 32 | k1))}
            aug_hw = tuple(int(x) for x in batch["out_hw"])
            return trainer_mod.make_sharded_train_step(
                mesh, aug_cfg=self.cfg.aug_cfg, aug_hw=aug_hw,
                **kw)(state, dev, local=True, **extra)
        steps = self._epoch(loader, step, size, epoch, max_steps)
        return state, steps

    # -- validation -------------------------------------------------------
    def _images(self, batch) -> torch.Tensor:
        """A loader batch's uint8 images (an array, or a tensor from a
        record loader), normalized, [b, h, w, 3] on the loop's device."""
        image = batch["image"]
        if not torch.is_tensor(image):
            image = torch.from_numpy(np.ascontiguousarray(image))
        return pl_mod.normalize_images(image.to(self.device))

    def calibrate_quant(self, state, loader: Iterable[Dict[str, np.ndarray]],
                        num_batches: int = 2) -> Dict[str, torch.Tensor]:
        """Calibrate the model's static int8 activation scales
        (quant_mode='static') on the first ``num_batches`` loader batches,
        in the recipe's dtype (JAX TrainLoop.calibrate_quant). The scales
        stay in the model's QuantConv2d buffers, where every later
        validate() / eval_pipeline() reads them; returns them by module."""
        images = []
        for bidx, batch in enumerate(loader):
            if bidx >= num_batches:
                break
            images.append(self._images(batch).permute(0, 3, 1, 2)
                          .contiguous())
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.cfg.bf16):
            return quant_conv.calibrate(state.model, images)

    def eval_pipeline(self, hw: Tuple[int, int], uncertainty: bool,
                      vote_params: Optional[pl_mod.VoteParams] = None,
                      tail_depth: int = 0, tail_quant: bool = False,
                      vote_impl: Optional[str] = None) -> Callable:
        """The forward + vote of the pose evaluation for images of size
        ``hw``: fwd(model, image, generator, **draws) -> keypoints
        [b, vn, 2], or (mean, cov [b, vn, 2, 2]) with uncertainty, on
        normalized images [b, h, w, 3]. The FCN runs in the recipe's dtype
        (bf16 autocast when cfg.bf16), voting in float32.

        tail_depth 0 is the plain full-resolution path; 1-3 run the packed
        tail of that depth (pipeline.fused_tail_foreground) in the recipe's
        dtype, and fall back to 0 where h or w is not a multiple of 8 (the
        truncated split's crops), as the JAX loop does; ``tail_quant`` runs
        its stage convolutions in int8. ``vote_impl`` is the count's mode
        (None float32, 'bf16'). ``draws`` are the optional noise / pair_u /
        cov_noise / cov_pair_u of pipeline.estimate_keypoints."""
        if tail_depth > 0 and (hw[0] % 8 or hw[1] % 8):
            tail_depth = 0
        params = vote_params or pl_mod.VoteParams()
        bf16 = self.cfg.bf16

        def fwd(model, image, generator=None, **draws):
            model.eval()        # frozen BatchNorm statistics (train=False)
            kps, cov, _ = pl_mod.estimate_keypoints(
                model, image, params, generator=generator,
                uncertainty=uncertainty, fused_tail=tail_depth > 0,
                tail_depth=tail_depth,
                tail_dtype=torch.bfloat16 if bf16 else torch.float32,
                fcn_bf16=bf16, impl=vote_impl, tail_quant=tail_quant,
                **draws)
            return (kps, cov) if uncertainty else kps

        return fwd

    def validate(self, state, loader: Iterable[Dict[str, np.ndarray]],
                 epoch: int, prefix: str = "val",
                 evaluate_pose: bool = False, uncertainty: bool = False,
                 use_camera_intrinsic: bool = False,
                 evaluator: Optional[Evaluator] = None,
                 vote_params: Optional[pl_mod.VoteParams] = None,
                 tail_depth: int = 0, tail_quant: bool = False,
                 vote_impl: Optional[str] = None,
                 draws: Optional[Callable[..., Dict[str, torch.Tensor]]]
                 = None, vote_seed: int = 0,
                 save_inter_dir: Optional[str] = None) -> Dict[str, float]:
        """(ref val() :177-253) The loss meters of every batch (trainer's
        eval_step) and, with evaluate_pose, the poses of every image
        through the evaluator; returns the averaged scalars, the three
        rates among them.

        ``loader`` yields batches of data.dataset.eval_batches or of a
        record loader (data.dataset.record_loader). Poses use LINEMOD_K
        for every image unless use_camera_intrinsic (then the batch's own
        K). The draws come from a generator seeded ``vote_seed`` on the
        loop's device, or from ``draws(bidx, b, h, w)`` where given (a
        dict of tensors for :meth:`eval_pipeline`'s fwd). The loss meters'
        forward takes per-image int8 scales, as the JAX loop's applies
        without the calibrated collection; the poses use the calibrated
        ones. With ``save_inter_dir`` (and evaluate_pose) each batch's
        first image's masks, image and pose go there
        (:meth:`save_inter`)."""
        meters = {k: AverageMeter() for k in _METRICS}
        gen = torch.Generator(self.device).manual_seed(vote_seed)
        begin = time.time()
        for bidx, batch in enumerate(loader):
            image = self._images(batch)
            dev = {"image": image.permute(0, 3, 1, 2).contiguous(),
                   "mask": torch.from_numpy(np.asarray(batch["mask"],
                                                       np.int32))
                   .to(self.device),
                   "hcoords": torch.from_numpy(batch["hcoords"])
                   .to(self.device)}
            with quant_conv.uncalibrated(state.model):
                metrics = trainer_mod.eval_step(
                    state, dev, self.cfg.vertex_loss_ratio,
                    self.cfg.motion_model, self.cfg.bf16)
            for k, m in meters.items():
                m.update(float(metrics[k]))

            if evaluate_pose and evaluator is not None:
                b, h, w = dev["mask"].shape
                fwd = self.eval_pipeline((h, w), uncertainty, vote_params,
                                         tail_depth, tail_quant, vote_impl)
                Ks = (batch["K"] if use_camera_intrinsic
                      else np.broadcast_to(LINEMOD_K, (b, 3, 3)))
                extra = draws(bidx, b, h, w) if draws is not None else {}
                out = fwd(state.model, image, gen, **extra)
                if uncertainty:
                    evaluator.evaluate_uncertainty_batch(*out, batch["pose"],
                                                         Ks)
                else:
                    evaluator.evaluate_batch(out, batch["pose"], Ks)

                if save_inter_dir is not None:
                    self.save_inter(save_inter_dir, bidx, state, batch,
                                    image)

        losses = {f"{prefix}/scalar/{k}": m.avg for k, m in meters.items()}
        if evaluate_pose and evaluator is not None:
            proj, add, cm = evaluator.average_precision(verbose=True)
            losses[f"{prefix}/scalar/projection_error"] = proj
            losses[f"{prefix}/scalar/add"] = add
            losses[f"{prefix}/scalar/cm"] = cm
        self.recorder.rec_loss_batch(losses, epoch, epoch, prefix)
        print(f"epoch {epoch} {prefix} cost {time.time() - begin:.1f} s",
              flush=True)
        return losses

    def save_inter(self, out_dir: str, idx: int, state, batch,
                   image: torch.Tensor) -> None:
        """Write the first image of a validation batch as JAX's
        ``_save_inter`` does (ref train_linemod.py:221-229,
        --save_inter_result): ``{idx}_mask_pr.png`` (the plain
        predict_fields' argmax of the normalized ``image`` [b, h, w, 3], in
        the recipe's dtype, per-image int8 scales as the JAX loop's
        variables without the quant collection), ``{idx}_mask_gt.png``
        (both 0/255), ``{idx}_rgb.png`` (the normalized image mapped back,
        utils/viz.imagenet_to_uint8) and ``{idx}_pose.pkl`` (the batch's
        first pose)."""
        os.makedirs(out_dir, exist_ok=True)
        model = state.model
        model.eval()
        with torch.no_grad(), quant_conv.uncalibrated(model), \
                pl_mod._bf16_autocast(self.device.type, self.cfg.bf16):
            mask_pr, _ = pl_mod.predict_fields(model, image[:1])
        write_png(os.path.join(out_dir, f"{idx}_mask_pr.png"),
                  (mask_pr[0].cpu().numpy() * 255).astype(np.uint8))
        write_png(os.path.join(out_dir, f"{idx}_mask_gt.png"),
                  (np.asarray(batch["mask"][0]) * 255).astype(np.uint8))
        write_png(os.path.join(out_dir, f"{idx}_rgb.png"),
                  imagenet_to_uint8(image[0].cpu().numpy()))
        with open(os.path.join(out_dir, f"{idx}_pose.pkl"), "wb") as f:
            pickle.dump(np.asarray(batch["pose"][0]), f)

    def object_meta(self, split: Dict[str, np.ndarray],
                    cls_name: str = "duck") -> ObjectMeta:
        """The evaluator's metadata of a split's object (points_3d,
        model_pts, diameter; ADD-S for the symmetric classes)."""
        return ObjectMeta(
            points_3d=np.asarray(split["points_3d"], np.float32),
            model_pts=np.asarray(split["model_pts"], np.float32),
            diameter=float(split["diameter"]),
            symmetric=cls_name in SYMMETRIC_CLS_NAMES, name=cls_name)

    def linemod_object_meta(self, cls_name: str,
                            paths: PathConfig) -> ObjectMeta:
        """The evaluator's metadata of a LINEMOD class (JAX
        ``TrainLoop.object_meta``): the vote type's 3D keypoints, the mesh,
        the diameter; ADD-S for the symmetric classes."""
        modeldb = LineModModelDB(paths)
        return ObjectMeta(
            points_3d=VotingType.get_pts_3d(
                self.cfg.vote_type, cls_name, modeldb).astype(np.float32),
            model_pts=modeldb.get_ply_model(cls_name).astype(np.float32),
            diameter=modeldb.get_diameter(cls_name),
            symmetric=cls_name in SYMMETRIC_CLS_NAMES, name=cls_name)

    # -- orchestration ----------------------------------------------------
    def _sampler(self, n: int) -> ImageSizeBatchSampler:
        """The training batch sampler of an n-record set (drop_last)."""
        sampler = ImageSizeBatchSampler(
            range(n), self.cfg.train_batch_size, drop_last=True,
            aug_cfg=self.cfg.aug_cfg, buckets=self.buckets,
            seed=self.cfg.seed)
        if len(sampler) == 0:
            raise ValueError(f"{n} images make no batch of "
                             f"{self.cfg.train_batch_size}")
        return sampler

    def make_loaders(self, train_db, val_db, data_prefix: str,
                     num_threads: int = 4) -> Tuple[Prefetcher, Prefetcher]:
        """(train loader, val loader) of JAX's ``make_loaders``
        (pvnet_tpu/train/loop.py:467-485): the training set host-augmented
        (or raw for cfg.device_aug), its frames on the loop's device, one
        RandomState(cfg.seed) for its draws, drop_last batches of the
        recipe's size and the loop's buckets. Data parallel: this rank's
        rows of each batch, draws from RandomState(cfg.seed + rank)."""
        train_set = PoseDataset(train_db, data_prefix, self.cfg.vote_type,
                                augment=not self.cfg.device_aug,
                                aug_cfg=self.cfg.aug_cfg,
                                use_motion=self.cfg.motion_model,
                                seed=self.cfg.seed + self.mesh.rank,
                                raw=self.cfg.device_aug,
                                cache_images=self.cfg.cache_images,
                                device=self.device)
        sampler = _RankRows(self._sampler(len(train_set)), self.mesh)
        train_loader = Prefetcher(train_set, sampler,
                                  num_threads=num_threads)
        return train_loader, self.make_val_loader(val_db, data_prefix,
                                                  num_threads)

    def make_val_loader(self, val_db, data_prefix: str,
                        num_threads: int = 4) -> Prefetcher:
        """The validation loader (JAX's ``make_val_loader``): the records in
        order, ``test_batch_size`` a batch, raw frames that
        :meth:`validate` normalizes on the device."""
        return record_loader(val_db, data_prefix, self.cfg.vote_type,
                             self.cfg.test_batch_size, self.cfg.aug_cfg,
                             device=self.device, num_threads=num_threads)

    def fit(self, images: np.ndarray, masks: np.ndarray, hcoords: np.ndarray,
            init: Optional[str] = None, imagenet_pth: Optional[str] = None,
            epochs: Optional[int] = None,
            max_steps: Optional[int] = None,
            val: Optional[Dict[str, np.ndarray]] = None
            ) -> trainer_mod.TrainState:
        """Full training run on a set held on the device (the ``--data``
        fixture route), with resume and a checkpoint per epoch
        (ref train_net() :305-347), from :meth:`init_state`'s weights
        (``init``, ``imagenet_pth``); stops after ``max_steps`` steps in
        all when given, saving the epoch it stopped in. With a validation split
        ``val`` (the fixture's layout plus model_pts and diameter), the
        validation pass runs on the JAX loop's schedule: with pose
        evaluation every ``eval_inter`` epochs from ``eval_epoch_begin``
        when cfg.eval_epoch, the loss meters alone every ``val_inter``
        epochs and after the last epoch."""
        state = self.init_state(init, imagenet_pth)
        data = self.build_device_dataset(images, masks, hcoords)
        sampler = self._sampler(len(data["image"]))

        def run(state, epoch, left):
            return self.train_epoch_from_data(state, data, sampler, epoch,
                                              left)[1]

        def validate(state, epoch, do_eval):
            self.validate(state, eval_batches(val, self.cfg.test_batch_size),
                          epoch, evaluate_pose=do_eval,
                          evaluator=(Evaluator(self.object_meta(val),
                                               device=self.device)
                                     if do_eval else None))
        return self._fit(state, run, epochs, max_steps,
                         validate if val is not None else None)

    def fit_records(self, train_db, val_db, data_prefix: str, cls_name: str,
                    paths: PathConfig, init: Optional[str] = None,
                    imagenet_pth: Optional[str] = None,
                    epochs: Optional[int] = None,
                    max_steps: Optional[int] = None,
                    num_threads: int = 4) -> trainer_mod.TrainState:
        """:meth:`fit` from LINEMOD records (JAX ``TrainLoop.fit``,
        pvnet_tpu/train/loop.py:510-559), on the route of cfg.device_aug /
        cfg.device_data (the module docstring): ``train_db`` read from
        ``data_prefix`` by :meth:`make_loaders`' training loader, or decoded
        onto the device with device_data (which needs device_aug, as
        there); ``val_db`` read batch by batch for the validation pass, the
        evaluator's metadata from the class's models under ``paths``."""
        if self.cfg.device_data and not self.cfg.device_aug:
            raise ValueError("device_data requires device_aug (vertex "
                             "targets are computed on device post-warp)")
        state = self.init_state(init, imagenet_pth)
        if self.cfg.device_data:
            data = self.build_device_dataset_from_records(train_db,
                                                          data_prefix)
            sampler = self._sampler(len(train_db))
            val_loader = self.make_val_loader(val_db, data_prefix,
                                              num_threads)

            def run(state, epoch, left):
                return self.train_epoch_from_data(state, data, sampler,
                                                  epoch, left)[1]
        else:
            loader, val_loader = self.make_loaders(train_db, val_db,
                                                   data_prefix, num_threads)

            def run(state, epoch, left):
                return self.train_epoch(state, loader, epoch, left)[1]

        def validate(state, epoch, do_eval):
            self.validate(state, val_loader, epoch, evaluate_pose=do_eval,
                          evaluator=(Evaluator(
                              self.linemod_object_meta(cls_name, paths),
                              device=self.device) if do_eval else None))
        return self._fit(state, run, epochs, max_steps,
                         validate if val_db else None)

    def _fit(self, state, run_epoch, epochs, max_steps, validate
             ) -> trainer_mod.TrainState:
        """The epochs of :meth:`fit` and :meth:`fit_records`:
        ``run_epoch(state, epoch, max_steps)`` trains one and returns its
        steps; ``validate(state, epoch, evaluate_pose)`` runs the
        validation pass where given. Data parallel, rank 0 alone saves and
        validates (in eval mode the model makes no collective call); the other
        ranks wait for it at the next step's collectives."""
        state, begin_epoch = self.resume(state)
        end_epoch = epochs if epochs is not None else self.cfg.epoch_num
        left = max_steps
        for epoch in range(begin_epoch, end_epoch):
            trainer_mod.set_learning_rate(
                state, trainer_mod.lr_for_epoch(self.cfg, epoch))
            steps = run_epoch(state, epoch, left)
            if self.is_main:
                save_model(state, epoch, self.model_dir,
                           keep=self.cfg.checkpoint_keep)
            do_eval = (self.cfg.eval_epoch
                       and epoch % self.cfg.eval_inter == 0
                       and epoch >= self.cfg.eval_epoch_begin)
            if validate is not None and self.is_main and (
                    do_eval or epoch % self.cfg.val_inter == 0
                    or epoch == end_epoch - 1):
                validate(state, epoch, do_eval)
            if left is not None:
                left -= steps
                if left <= 0:
                    break
        self.recorder.close()
        return state
