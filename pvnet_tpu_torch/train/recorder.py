"""Metrics recording: console + append-only JSONL + optional TensorBoard.

Port of pvnet_tpu/train/recorder.py (ref lib/utils/net_utils.py:133-239):
scalars always go to the console and to ``{rec_dir}/log.jsonl``;
TensorBoard is a sink when asked for (``use_tensorboard=True``) and only
where ``torch.utils.tensorboard`` imports. It is off by default: where
TensorFlow is installed that import loads it, seconds of start-up. The
image summaries of the JAX module (colourized segmentation and vector
field grids) are not ported.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from typing import Dict, Optional


class AverageMeter:
    """Running average (ref net_utils.py:133-149)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class Recorder:
    """Scalar sink (ref net_utils.py:152-239)."""

    def __init__(self, rec_dir: Optional[str] = None,
                 use_tensorboard: bool = False):
        self.rec_dir = rec_dir
        self.jsonl_path = None
        self.writer = None
        if rec_dir is not None:
            os.makedirs(rec_dir, exist_ok=True)
            self.jsonl_path = os.path.join(rec_dir, "log.jsonl")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self.writer = SummaryWriter(log_dir=rec_dir)

    def rec_loss_batch(self, losses: Dict[str, float], step: int, epoch: int,
                       prefix: str = "train") -> None:
        """Scalar group (ref net_utils.py:185-200)."""
        msg = f"{prefix} epoch {epoch} step {step}"
        for k, v in losses.items():
            msg += f" {k.split('/')[-1]} {float(v):.8f}"
        print(msg, flush=True)
        if self.jsonl_path:
            rec = OrderedDict(ts=time.time(), prefix=prefix, epoch=epoch,
                              step=step)
            rec.update({k: float(v) for k, v in losses.items()})
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.writer is not None:
            for k, v in losses.items():
                self.writer.add_scalar(k, float(v), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()
