"""The offline pose loop: batches of uint8 frames uploaded, normalized and
posed back to back, one batch in flight (a closed loop), as an evaluation
or annotation job runs ``python -m pvnet_tpu_torch.infer``.

The timed call is the program's ``pipeline.estimate_poses`` on the batch
that ``pipeline.normalize_images`` made of the upload, with the voting's
draws made here from the seed; the poses, keypoints and foreground counts
come back to the host at the end of each batch. A ``--trace 1`` run calls
the same public pieces that ``estimate_poses`` is made of, one span each
(upload and normalize, ``predict_fields`` under the configuration's
autocast, ``keypoints_from_fields``, ``poses_from_keypoints``).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from pvbench import check, flops, inputs, spec, trace
from pvbench.reference import fcn as ref_fcn
from pvbench.reference import lowp, msgpack
from pvbench.reference import pnp as ref_pnp
from pvbench.reference import voting as ref_voting

WARM = 1 << 30          # the draws' index of the warm-up batch
SEEDED = "seeded"       # a configuration's "weights" drawn from the seed
CALIBRATION = 16        # frames of the seeded weights' BatchNorm pass
WIDTHS = ("fcdim", "s8dim", "s4dim", "s2dim", "raw_dim")


def set_precision(cfg: dict) -> None:
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])


def widths(cfg: dict) -> dict:
    """The configuration's head and decoder widths, as build_model takes
    them."""
    return {k: cfg[k] for k in WIDTHS}


def load_by_name(model: torch.nn.Module, params: dict) -> None:
    """Load ``params`` by name into ``model``: every tensor used, every
    tensor but BatchNorm's step counters given."""
    missing, unexpected = model.load_state_dict(params, strict=False)
    if unexpected or any("num_batches_tracked" not in k for k in missing):
        raise RuntimeError(f"weights do not fit the model: missing "
                           f"{missing}, unexpected {unexpected}")


def normalized(images_u8: torch.Tensor, device) -> torch.Tensor:
    """uint8 [n, h, w, 3] -> the reference's ImageNet-normalized float32
    [n, 3, h, w] on ``device``."""
    mean = torch.tensor((0.485, 0.456, 0.406), device=device)
    std = torch.tensor((0.229, 0.224, 0.225), device=device)
    x = images_u8.to(device).float() / 255.0
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()


def unit_quartiles(ends) -> dict:
    """The quartiles of the times of a window's batches or steps (from
    their end times), for the run's diagnostic line."""
    d = np.diff(np.concatenate([[0.0], ends]))
    q = np.quantile(d, [0.0, 0.25, 0.5, 0.75, 1.0])
    return {f"unit {k}": float(v) for k, v in zip(
        ("min", "q1", "median", "q3", "max"), q)}


class Offline:
    """One process's offline pose job for a cell."""

    def __init__(self, cell: dict, device):
        self.cell, self.cfg, self.mix = cell, cell["cfg"], cell["mix"]
        self.device = torch.device(device)
        self.vote = self.cfg["vote"]
        self.model = None

    # -- set-up ------------------------------------------------------------
    def load_program(self) -> None:
        """The program's model from the configuration's checkpoint; seeded
        weights come with the inputs (:meth:`load_inputs`)."""
        from pvnet_tpu_torch import infer
        set_precision(self.cfg)
        fx = inputs.fixture()
        if self.cfg["weights"] != SEEDED:
            self.model = infer.load_model(
                os.path.join(spec.ROOT, self.cfg["weights"]),
                self.cfg["num_keypoints"], self.device, self.train_config(),
                **widths(self.cfg))
        self.pts = torch.as_tensor(fx["points_3d"], device=self.device)
        self.K = torch.as_tensor(fx["K"], device=self.device)

    def train_config(self):
        from pvnet_tpu_torch.config import TrainConfig
        return TrainConfig(network=self.cfg["network"],
                           bf16=self.cfg["fcn_bf16"])

    def load_inputs(self, seed: int) -> None:
        self.seed = seed
        self.pool = inputs.offline_pool(seed, self.mix, self.device)
        self.order = inputs.batch_order(seed, len(self.pool), 1 << 16)
        if self.cfg["weights"] == SEEDED:
            self.load_seeded(seed)

    def load_seeded(self, seed: int) -> None:
        """Seeded weights: the recipe's law over the configuration's
        shapes (inputs.init_params), BatchNorm statistics from one float32
        train-mode pass of the reference over the first ``CALIBRATION``
        frames of the first pooled batch (reference/fcn.calibrate); the
        program loads them by name (strict), and the reference keeps the
        same tensors on the host."""
        from pvnet_tpu_torch.config import model_kwargs
        from pvnet_tpu_torch.models.pvnet import build_model
        p = inputs.init_params(ref_fcn.conv_shapes(self.cfg),
                               ref_fcn.bn_names(self.cfg), seed, self.device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ref_fcn.calibrate(p, normalized(self.pool[0][:CALIBRATION],
                                        self.device), self.cfg)
        set_precision(self.cfg)
        self.model = None
        model = build_model(self.cfg["network"],
                            ver_dim=2 * self.cfg["num_keypoints"],
                            seg_dim=2, **model_kwargs(self.train_config()),
                            **widths(self.cfg))
        load_by_name(model, p)
        self.model = model.to(self.device).eval()
        self.ref_params = {k: v.cpu() for k, v in p.items()}

    def draws(self, i: int):
        b, h, w = self.pool[0].shape[:3]
        return inputs.vote_draws(self.seed, i, b, h, w,
                                 self.vote["hyp_num"], self.device)

    # -- one batch ---------------------------------------------------------
    def batch(self, i: int, spans: trace.Spans):
        """Pose the i-th batch; returns (pose, kps, fg) on the host."""
        from pvnet_tpu_torch import pipeline as pl
        params = pl.VoteParams(hyp_num=self.vote["hyp_num"],
                               inlier_thresh=self.vote["inlier_thresh"],
                               max_num=self.vote["max_num"],
                               min_num=self.vote["min_num"])
        bf16 = bool(self.cfg["fcn_bf16"])
        host = self.pool[self.order[i % len(self.order)]]
        with spans("draws"):
            noise, pair_u = self.draws(i)
        with torch.no_grad():
            if not spans.on:
                x = pl.normalize_images(host.to(self.device))
                est = pl.estimate_poses(self.model, x, self.pts, self.K,
                                        params, noise=noise, pair_u=pair_u,
                                        fcn_bf16=bf16)
                pose, kps, fg = est.pose, est.kps, est.fg_pixels
            else:
                with spans("input"):
                    x = pl.normalize_images(host.to(self.device))
                with spans("fcn"):
                    with torch.autocast(self.device.type,
                                        dtype=torch.bfloat16, enabled=bf16):
                        mask, vertex = pl.predict_fields(self.model, x)
                    vertex = vertex.float()
                with spans("voting"):
                    kps = pl.keypoints_from_fields(mask, vertex, params,
                                                   noise=noise,
                                                   pair_u=pair_u)
                    fg = (mask != 0).flatten(1).sum(1).to(torch.int32)
                with spans("pnp", host_clock=True):
                    pose = pl.poses_from_keypoints(self.pts, kps, self.K)
        with spans("readback"):
            return pose.cpu(), kps.cpu(), fg.cpu()

    # -- the run -----------------------------------------------------------
    def run(self, seconds: float, traced: bool, t_start: float) -> dict:
        spans = trace.Spans(traced)
        self.batch(WARM, trace.Spans(False))
        if traced:
            self.batch(WARM, spans)
            spans.pending.clear()
            spans.host_ms.clear()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        setup_s = time.time() - t_start
        outs, i, ends = [], 0, []
        t0 = time.perf_counter()
        while True:
            outs.append(self.batch(i, spans))
            i += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        window = ends[-1]
        b = self.pool[0].shape[0]
        res = {"setup_s": setup_s, "window_s": window, "batches": i,
               "attempted": i * b, "unit_s": unit_quartiles(ends)}
        pose = torch.cat([o[0] for o in outs]).numpy()
        res["failed"] = int((~np.isfinite(pose).reshape(len(pose), -1)
                             .all(1)).sum())
        res["e2e"] = {"poses_per_s": i * b / window}
        res["prog"] = {"pose": pose,
                       "kps": torch.cat([o[1] for o in outs]).numpy(),
                       "fg": torch.cat([o[2] for o in outs]).numpy()}
        if traced:
            spans.read()
            prof_spans = trace.Spans(True)
            n_prof = self.mix["profile_batches"]
            res["trace"] = trace.profiled(lambda: [
                self.batch(i + k, prof_spans) for k in range(n_prof)])
            n_idle = self.mix["idle_batches"]
            res["device_trace"] = trace.profiled(lambda: [
                self.batch(i + n_prof + k, trace.Spans(False))
                for k in range(n_idle)], cpu=False)
            res["record"] = self.record(spans, res, n_prof)
        if self.device.type == "cuda":
            res["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        return res

    def record(self, spans, res, n_prof) -> dict:
        b, h, w = self.pool[0].shape[:3]
        prec = "bfloat16" if self.cfg["fcn_bf16"] else "float32"
        return {"spans_ms": dict(spans.ms), "host_ms": dict(spans.host_ms),
                "trace": res.get("trace"), "profiled": n_prof,
                "device_trace": res.get("device_trace"),
                "idle_units": self.mix["idle_batches"],
                "window_units": res["batches"],
                "window_s": res["window_s"], "batches": res["batches"],
                "batch": b, "fcn_flops": flops.fcn_flops(h, w, self.cfg),
                "fcn_peak": flops.PEAK_FLOPS[prec],
                "f32_peak": flops.PEAK_FLOPS["float32"],
                "vn": self.cfg["num_keypoints"], "vote": self.vote}

    # -- the comparison ----------------------------------------------------
    def sample(self, seed: int, n_done: int) -> np.ndarray:
        """The answers compared: ``check.sample`` of those finished, drawn
        from the seed, in order."""
        n = min(self.cell["check"]["sample"], n_done)
        rng = np.random.default_rng(inputs.subseed(seed, 8))
        return np.sort(rng.choice(n_done, n, replace=False))

    def sampled_inputs(self, idx: np.ndarray):
        """(uint8 images [n, h, w, 3], noise, pair_u) of answers ``idx``."""
        b = self.pool[0].shape[0]
        imgs, noise, pair = [], [], []
        for j in np.unique(idx // b):
            rows = torch.as_tensor(idx[idx // b == j] % b)
            nz, pu = self.draws(int(j))
            imgs.append(self.pool[self.order[j]][rows])
            noise.append(nz[rows.to(nz.device)])
            pair.append(pu[rows.to(pu.device)])
        return torch.cat(imgs), torch.cat(noise), torch.cat(pair)

    def free_program(self) -> None:
        self.model = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, images, noise, pair_u, control: Optional[str] = None,
                  block: int = 16) -> dict:
        """The plain reference's keypoints and foreground counts for
        ``images`` (float32, TF32 off), or with ``control`` its
        lower-precision twin's, with its least-squares poses."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if self.cfg["weights"] == SEEDED:
            p = {k: v.to(self.device) for k, v in self.ref_params.items()}
        else:
            p = ref_fcn.params_from_flax(msgpack.load(
                os.path.join(spec.ROOT, self.cfg["weights"])), self.device,
                self.cfg)
        conv = lowp.CONTROLS[control] if control else \
            torch.nn.functional.conv2d
        kps, fg = [], []
        with torch.no_grad():
            for s in range(0, len(images), block):
                x = normalized(images[s:s + block], self.device)
                seg, ver = ref_fcn.forward(p, x, self.cfg, conv=conv)
                k, f = ref_voting.vote(
                    seg.argmax(1), ver, noise[s:s + block].to(self.device),
                    pair_u[s:s + block].to(self.device), **self.vote)
                kps.append(k.cpu())
                fg.append(f.cpu())
        out = {"kps": torch.cat(kps).numpy(), "fg": torch.cat(fg).numpy()}
        fx = inputs.fixture()
        out["pose"] = ref_pnp.solve(
            torch.as_tensor(fx["points_3d"], device=self.device),
            torch.as_tensor(out["kps"], device=self.device),
            torch.as_tensor(fx["K"], device=self.device)).cpu().numpy()
        return out

    def pose_px(self, pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
        """Mean distance [n] between the object's keypoints projected by
        two sets of poses (inf where either is not finite)."""
        fx = inputs.fixture()
        pts = torch.as_tensor(fx["points_3d"], dtype=torch.float64)
        K = torch.as_tensor(fx["K"], dtype=torch.float64)

        def proj(pose):
            p = torch.as_tensor(pose, dtype=torch.float64)
            return ref_pnp.project(pts, p[:, :, :3], p[:, :, 3], K)

        d = (proj(pose_a) - proj(pose_b)).norm(dim=-1).mean(-1).numpy()
        return np.where(np.isfinite(d), d, np.inf)

    def readings(self, prog: dict, idx: np.ndarray,
                 control: Optional[str] = None) -> dict:
        """The comparison of answers ``idx`` of ``prog`` (or, with
        ``control``, of the control in the program's place)."""
        images, noise, pair_u = self.sampled_inputs(idx)
        ref = self.reference(images, noise, pair_u)
        if control:
            mine = self.reference(images, noise, pair_u, control)
        else:
            mine = {k: v[idx] for k, v in prog.items()}
        return check.offline_readings(mine, ref,
                                      self.pose_px(mine["pose"], ref["pose"]))
