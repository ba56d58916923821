"""BatchNorm over the global batch of a data-parallel step.

JAX's sharded step normalizes with the statistics of the whole batch
(XLA all-reduces them, pvnet_tpu/train/trainer.py:258-259), and flax
tracks the *biased* running variance. :class:`SyncBatchNorm2d` does both
over a :class:`~pvnet_tpu_torch.parallel.mesh.Mesh`: PyTorch's
``nn.SyncBatchNorm`` refuses CPU tensors (so gloo tests could not run
it), and its ``convert_sync_batchnorm`` would put back PyTorch's unbiased
running-variance update.

In training, each rank takes its rows' per-channel mean and biased
variance in float32 (also under bf16 autocast; float64 stays float64) and
their count; one all-reduce of a [ranks, 2C+1] buffer gives every rank
all of them, which it merges in rank order into the global mean and
biased variance (the parallel-variance rule: the count-weighted variances
plus the spread of the means). The output is normalized with those, and
the running statistics move as in models/resnet.BatchNorm2d. The backward
all-reduces the two per-channel sums the input gradient needs (of dy and
of dy * (x - mean)); the weight and bias gradients stay local, and the
data-parallel wrapper averages them with the rest. In eval mode, and
without a process group, it is BatchNorm2d and communicates nothing.

On a CUDA tensor the passes over the activation are PyTorch's fused
batch-norm operators, which read bf16 as it is and accumulate in float32:
one for the local statistics (batch_norm_stats), one to normalize
(batch_norm_elemt), two in the backward (batch_norm_backward_reduce,
batch_norm_backward_elemt); only the per-channel merge is written out
here. They have no CPU kernels, so on the CPU the same arithmetic runs as
plain tensor operations in float32.
"""
from __future__ import annotations

import torch
from torch import nn

from pvnet_tpu_torch.models.resnet import BatchNorm2d
from pvnet_tpu_torch.parallel.mesh import Mesh, all_reduce_sum


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _merge(stats: torch.Tensor, c: int):
    """Rank order's [ranks, 2C+1] rows of (mean, biased variance, count)
    -> the global batch's mean, biased variance and count."""
    counts = stats[:, 2 * c:]                       # [ranks, 1]
    n = counts.sum()
    share = counts / n
    mean = (stats[:, :c] * share).sum(0)
    var = ((stats[:, c:2 * c] + (stats[:, :c] - mean) ** 2) * share).sum(0)
    return mean, var, n


class _SyncBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, mesh: Mesh):
        c = x.shape[1]
        x = x.contiguous()
        acc = torch.promote_types(x.dtype, torch.float32)
        if x.is_cuda:
            # eps 0: the local variance comes back exactly; its invstd is
            # 0 where the variance is 0
            mean_l, invstd_l = torch.batch_norm_stats(x, 0.0)
            var_l = torch.where(invstd_l > 0, invstd_l.pow(-2), 0.0)
        else:
            var_l, mean_l = torch.var_mean(x.to(acc), dim=(0, 2, 3),
                                           unbiased=False)
        # the count filled on the device: a Python number stored into a
        # CUDA tensor is a copy from the host that waits for the device
        stats = mean_l.new_zeros((mesh.size, 2 * c + 1))
        stats[mesh.rank] = torch.cat([mean_l, var_l,
                                      mean_l.new_full((1,), x.numel() // c)])
        all_reduce_sum(stats, mesh)
        mean, var, n = _merge(stats, c)
        invstd = torch.rsqrt(var + eps)
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(momentum * mean)
            running_var.mul_(1 - momentum).add_(momentum * var)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mesh, ctx.n = mesh, n
        if x.is_cuda:
            return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)
        scale = invstd if weight is None else invstd * weight.to(acc)
        y = (x.to(acc) - _channel(mean)) * _channel(scale)
        if bias is not None:
            y = y + _channel(bias.to(acc))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd = ctx.saved_tensors
        c = x.shape[1]
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dy = dy.contiguous()
        if x.is_cuda:
            sum_dy, sum_dy_xmu, dw, db = torch.batch_norm_backward_reduce(
                dy, x, mean, invstd, weight, need_x, need_w, need_b)
        else:
            dyf = dy.to(mean.dtype)
            xmu = x.to(mean.dtype) - _channel(mean)
            sum_dy = dyf.sum((0, 2, 3))
            sum_dy_xmu = (dyf * xmu).sum((0, 2, 3))
            dw = (sum_dy_xmu * invstd).to(weight.dtype) if need_w else None
            db = sum_dy.to(weight.dtype) if need_b else None
        dx = None
        if need_x:
            sums = all_reduce_sum(torch.cat([sum_dy, sum_dy_xmu]),
                                  ctx.mesh)
            if x.is_cuda:
                dx = torch.batch_norm_backward_elemt(
                    dy, x, mean, invstd, weight, sums[:c], sums[c:],
                    ctx.n.to(torch.int32).reshape(1))
            else:
                scale = (invstd if weight is None
                         else invstd * weight.to(mean.dtype))
                dx = (_channel(scale)
                      * (dyf - _channel(sums[:c] / ctx.n)
                         - xmu * _channel(invstd ** 2 * sums[c:] / ctx.n))
                      ).to(x.dtype)
        return (dx, dw if need_w else None, db if need_b else None,
                None, None, None, None, None)


class SyncBatchNorm2d(BatchNorm2d):
    """:class:`~pvnet_tpu_torch.models.resnet.BatchNorm2d` whose training
    statistics are the global batch's over ``mesh`` (the module
    docstring); the same parameters, buffers and state_dict keys. Made by
    :func:`convert_sync`."""

    mesh: Mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.mesh.group is None:
            return super().forward(x)
        return _SyncBatchNorm.apply(x, self.weight, self.bias,
                                    self.running_mean, self.running_var,
                                    self.eps, self.momentum, self.mesh)


def convert_sync(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Turn every port BatchNorm2d of ``model`` (backbone blocks, the
    Bottleneck's three, decoder, detector and heads alike) into a
    :class:`SyncBatchNorm2d` over ``mesh``, in place: the modules, their
    parameters and buffers stay the same objects (an optimizer made
    before keeps working). Another BatchNorm class raises: it would keep
    per-rank statistics."""
    for m in model.modules():
        if isinstance(m, BatchNorm2d):
            m.__class__ = SyncBatchNorm2d
            m.mesh = mesh
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            raise TypeError(f"convert_sync takes the port's BatchNorm2d; "
                            f"got {type(m).__name__}")
    return model
