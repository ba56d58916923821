"""The training loop on the device-data route: the whole training set held
on the card, each step gathering its rows, augmenting them on the card
(kernel K4) and running forward, loss, backward and Adam, as
``python -m pvnet_tpu_torch.train --device_data`` does.

The timed call is the program's ``trainer.train_step_from_data``, with the
rows and the augmentation draws made here from the seed. Steps walk whole cycles of the traffic's sizes,
each cycle in its own seeded order; set-up runs the first cycle, whose
first ``check_steps`` steps the reference follows. A ``--trace 1`` run
calls the public pieces of the step: ``trainer.apply_device_aug`` and
``trainer.train_step`` on the augmented batch.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from pvbench import check, flops, inputs, trace
from pvbench.offline import load_by_name, widths
from pvbench.reference import fcn as ref_fcn
from pvbench.reference import lowp
from pvbench.reference import train as ref_train


class Training:
    """One process's training job for a cell on one card."""

    def __init__(self, cell: dict, device):
        self.cell, self.cfg, self.mix = cell, cell["cfg"], cell["mix"]
        self.recipe = self.cfg["train"]
        self.device = torch.device(device)
        self.b = self.mix["batch"]

    def init_params(self, seed: int):
        return inputs.init_params(ref_fcn.conv_shapes(self.cfg),
                                  ref_fcn.bn_names(self.cfg), seed,
                                  self.device)

    # -- set-up ------------------------------------------------------------
    def load(self, seed: int) -> None:
        from pvnet_tpu_torch.config import TrainConfig
        from pvnet_tpu_torch.models.pvnet import build_model
        from pvnet_tpu_torch.train import trainer
        self.seed = seed
        torch.backends.cudnn.allow_tf32 = bool(self.recipe["tf32"])
        torch.backends.cuda.matmul.allow_tf32 = False
        self.tcfg = TrainConfig.from_dict({
            "network": self.cfg["network"], "lr": self.recipe["lr"],
            "train_batch_size": self.b, "bf16": self.recipe["bf16"],
            "vertex_loss_ratio": self.recipe["vertex_loss_ratio"],
            "aug_cfg": self.recipe["aug_cfg"]})
        model = build_model(self.cfg["network"], ver_dim=self.cfg["ver_dim"],
                            seg_dim=self.cfg["seg_dim"],
                            **widths(self.cfg)).to(self.device)
        load_by_name(model, self.init_params(seed))
        self.state = trainer.create_train_state(model, self.tcfg)
        self.data = inputs.frames(self.mix["set_frames"], seed, 9, self.mix,
                                  self.device)
        self.rows = inputs.row_order(seed, self.mix["set_frames"],
                                     self.device)

    def idx(self, i: int) -> torch.Tensor:
        n = self.rows.numel()
        s = (i * self.b) % n
        return self.rows[(torch.arange(self.b, device=self.device) + s) % n]

    # -- one step ----------------------------------------------------------
    def step(self, i: int, hw, spans: trace.Spans):
        from pvnet_tpu_torch.data.augment_device import AugDraws
        from pvnet_tpu_torch.train import trainer
        aug, ratio, bf16 = (self.tcfg.aug_cfg, self.tcfg.vertex_loss_ratio,
                            self.tcfg.bf16)
        with spans("draws"):
            idx = self.idx(i)
            draws = AugDraws(**inputs.aug_draws(self.seed, i, self.b,
                                                self.recipe["aug_cfg"],
                                                self.device))
        if not spans.on:
            return trainer.train_step_from_data(
                self.state, self.data, idx, draws=draws,
                vertex_loss_ratio=ratio, aug_cfg=aug, aug_hw=hw, bf16=bf16)
        batch = {k: self.data[k][idx] for k in ("image", "mask", "hcoords")}
        with spans("augment"):
            batch = trainer.apply_device_aug(batch, aug, hw, draws)
        with spans("step"):
            return trainer.train_step(self.state, batch,
                                      vertex_loss_ratio=ratio, bf16=bf16)

    # -- the run -----------------------------------------------------------
    def run(self, seconds: float, traced: bool, t_start: float) -> dict:
        model, opt = self.state.model, self.state.optimizer
        off = trace.Spans(False)
        cycle0 = inputs.size_cycle(self.seed, 0, self.mix)
        k = self.mix["check_steps"]
        if len(cycle0) < k:
            raise ValueError(f"a cycle of {len(cycle0)} sizes is shorter "
                             f"than the {k} checked steps")
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        losses, grad_norm = [], None
        self.check_batches = []
        beta1 = opt.param_groups[0]["betas"][0]
        for i, hw in enumerate(cycle0):
            if i < k:
                idx = self.idx(i)
                self.check_batches.append({
                    "image": self.data["image"][idx].clone(),
                    "mask": self.data["mask"][idx].clone(),
                    "hcoords": self.data["hcoords"][idx].clone(),
                    "draws": inputs.aug_draws(self.seed, i, self.b,
                                              self.recipe["aug_cfg"],
                                              self.device),
                    "out_hw": hw})
            m = self.step(i, hw, off)
            if i < k:
                losses.append(float(m["loss"]))
            if i == 0:
                # an optimizer that kept no state moved nothing: 0
                grad_norm = check.leaf_norms({
                    n: opt.state[p].get("exp_avg", torch.zeros(1)) / (
                        1 - beta1) for n, p in model.named_parameters()})
            if i == k - 1:
                delta_norm = check.leaf_norms({
                    n: p.detach() - p0[n] for n, p in model.named_parameters()})
                del p0
        if traced:                      # the traced path's shapes, once
            for hw in cycle0:
                self.step(len(cycle0), hw, trace.Spans(True))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        setup_s = time.time() - t_start
        spans = trace.Spans(traced)
        step_losses, sizes, i, cyc = [], [], len(cycle0), 1
        t0 = time.perf_counter()
        while True:
            for hw in inputs.size_cycle(self.seed, cyc, self.mix):
                step_losses.append(self.step(i, hw, spans)["loss"])
                sizes.append(hw)
                i += 1
            cyc += 1
            over = time.perf_counter() - t0 >= seconds
            if self.device.type == "cuda":      # one cycle in flight
                torch.cuda.synchronize(self.device)
            if over:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - t0
        losses_w = torch.stack([x.float() for x in step_losses]).cpu()
        res = {"setup_s": setup_s, "window_s": window, "steps": len(sizes),
               "attempted": len(sizes),
               "failed": int((~torch.isfinite(losses_w)).sum()),
               "e2e": {"train_imgs_per_s": len(sizes) * self.b / window},
               "prog": {"loss": losses, "grad_norm": grad_norm,
                        "delta_norm": delta_norm}}
        if traced:
            spans.read()
            n_prof = self.mix["profile_steps"]
            prof_sizes = inputs.size_cycle(self.seed, cyc, self.mix)[:n_prof]
            prof_spans = trace.Spans(True)
            res["trace"] = trace.profiled(lambda: [
                self.step(i + j, hw, prof_spans)
                for j, hw in enumerate(prof_sizes)])
            i += len(prof_sizes)
            idle_sizes = inputs.size_cycle(self.seed, cyc + 1, self.mix)
            res["device_trace"] = trace.profiled(lambda: [
                self.step(i + j, hw, trace.Spans(False))
                for j, hw in enumerate(idle_sizes)], cpu=False)
            res["record"] = self.record(spans, res, sizes, prof_sizes)
            res["record"]["idle_units"] = len(idle_sizes)
        if self.device.type == "cuda":
            res["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
                self.device)
        return res

    def record(self, spans, res, sizes, prof_sizes) -> dict:
        return {"spans_ms": dict(spans.ms), "trace": res["trace"],
                "device_trace": res["device_trace"],
                "window_units": len(sizes),
                "window_s": res["window_s"], "sizes": sizes,
                "profiled_sizes": prof_sizes, "batch": self.b,
                "src_hw": tuple(self.data["image"].shape[1:3]),
                "step_flops": [flops.train_step_flops(h, w, self.b, self.cfg)
                               for h, w in sizes],
                "bf16_peak": flops.PEAK_FLOPS["bfloat16"]}

    # -- the comparison ----------------------------------------------------
    def free_program(self) -> None:
        self.state = None
        self.data = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: Optional[str] = None) -> dict:
        """The plain reference (float32, TF32 off) through the checked
        steps from the same initial weights, or with ``control`` its
        lower-precision twin."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        p0 = self.init_params(self.seed)
        params = {k: v.clone() for k, v in p0.items()}
        conv = lowp.CONTROLS[control] if control else \
            torch.nn.functional.conv2d
        out = ref_train.run(params, self.check_batches, self.cfg, conv)
        names = ref_train.trainable(params)
        return {"loss": out["loss"],
                "grad_norm": check.leaf_norms(out["grad"]),
                "delta_norm": check.leaf_norms(
                    {k: out["params"][k] - p0[k] for k in names})}

    def readings(self, prog: dict, control: Optional[str] = None) -> dict:
        ref = self.reference()
        mine = self.reference(control) if control else prog
        return check.train_readings(mine, ref)
