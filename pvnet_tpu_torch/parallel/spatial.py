"""Spatial partitioning: one image's rows over the ranks of an ``sp`` axis
(port of pvnet_tpu/parallel/spatial.py, the same function names).

The JAX module jits the FCN under a row sharding and lets XLA's SPMD
partitioner split every convolution and insert the halo exchanges. Torch
has no such partitioner, so the port writes them: :func:`row_sharded`
makes a copy of the model (sharing its parameters) in which every
operator that reads neighbouring rows runs on this rank's rows
``[s*H/S, (s+1)*H/S)`` of every image and fetches the rows it reads from
the other shards, so that each rank's result equals the unsharded
forward's on its rows:

- a convolution taller than one row (``nn.Conv2d``, the packed stem's
  ``PadConv2d``, ``QuantConv2d``) fetches ``p_top`` rows above its slab and
  ``max(0, d*(k-1) - p_top - s + 1)`` below, from its own ``kernel_size``,
  ``stride``, ``padding`` and ``dilation``; zeros stand for the rows past
  the image's true edges, and it runs with no H padding;
- ``nn.MaxPool2d`` the same, with -inf past the image's edges;
- the decoder's align-corners bilinear upsample (``PVNet.upsample``)
  computes each output row ``Y`` from the global heights, input row
  ``Y*(H_in-1)/(H_out-1)``, and fetches the 1-2 rows it reads beyond its
  slab, a number that differs from shard to shard;
- a ``QuantConv2d`` in 'dynamic' mode takes each image's activation scale
  from the maximum over all shards, as XLA's partitioner does.

BatchNorm in eval mode, the activations, the 1x1 convolutions (strided
too: every shard's first row is even), ``torch.cat`` of the skips and the
argmax are local. The halos move through ``all_reduce`` of a zero-filled
buffer of slots in which each rank writes the rows the others read, as
bytes (an exact sum: every byte has one writer), the only collective
besides ``broadcast`` that gloo takes for CUDA tensors; so the same code
runs on CPU gloo ranks, on gloo ranks sharing one card and on NCCL across
cards. A halo wider than a shard is fetched from as many shards as it
spans. The model must be in eval mode: the JAX functions are inference
only.

Voting and PnP touch ~10^3 pixels, so :func:`make_spatial_pose_pipeline`
gathers the fields over ``sp`` (one exchange along H, the JAX module's
``with_sharding_constraint``) and votes and solves replicated on every
``sp`` rank. A 2D ``(data, sp)`` mesh (:func:`make_spatial_mesh`) splits
the batch over ``data`` and each image's rows over ``sp``:

  mesh = make_spatial_mesh(sp=2)                  # under torchrun, 4 ranks
  run = make_spatial_pose_pipeline(mesh, model, pts3d, K)
  pose, kps = run(images, generator)              # images [b, h, w, 3]
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from pvnet_tpu_torch.models.resnet import PadConv2d
from pvnet_tpu_torch.ops.quant_conv import QuantConv2d
from pvnet_tpu_torch.parallel.mesh import Mesh, _local_device, all_gather_rows

# the FCN's output stride: each shard's rows must split into whole 8x8
# cells (JAX spatial.py:55-57)
ROW_ALIGN = 8


@dataclass(frozen=True)
class SpatialMesh:
    """This rank's place on a 2D ``(data, sp)`` mesh (JAX's
    ``make_mesh((D, S), ('data', 'sp'))``): ``data`` is the group of the
    ranks that hold the same rows of other images (its rank is this rank's
    data index), ``sp`` the group that holds the rows of the same images
    (its rank is this rank's row shard)."""
    data: Mesh
    sp: Mesh

    @property
    def device(self) -> torch.device:
        return self.sp.device


def make_spatial_mesh(sp: Optional[int] = None, device=None) -> SpatialMesh:
    """The ``(data, sp)`` mesh over the initialized world (JAX's
    ``make_mesh((D, S), ('data', 'sp'))``): ``sp`` ranks a data group
    (default: the whole world), the ``sp`` ranks of one group contiguous
    (global rank ``d*S + s``). Every rank makes every group, in the same
    order, as ``dist.new_group`` requires. Without a process group it is a
    1x1 mesh and nothing communicates."""
    dev = _local_device(device)
    if not dist.is_initialized():
        if sp not in (None, 1):
            raise ValueError(f"sp={sp} without a process group")
        one = Mesh(0, 1, dev, None)
        return SpatialMesh(one, one)
    world, rank = dist.get_world_size(), dist.get_rank()
    S = world if sp is None else sp
    if S < 1 or world % S:
        raise ValueError(f"sp={S} does not divide the world of {world}")
    D = world // S
    data_groups = [dist.new_group([d * S + s for d in range(D)])
                   for s in range(S)]
    sp_groups = [dist.new_group(list(range(d * S, (d + 1) * S)))
                 for d in range(D)]
    d, s = divmod(rank, S)
    return SpatialMesh(Mesh(d, D, dev, data_groups[s] if D > 1 else None),
                       Mesh(s, S, dev, sp_groups[d] if S > 1 else None))


def _sum_bytes(buf: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """All-reduce ``buf`` (contiguous; each byte written by one rank, zero
    on the others) over the mesh as bytes: every value arrives bit for
    bit, whatever its dtype."""
    dist.all_reduce(buf.view(torch.uint8), group=mesh.group)
    return buf


def gather_dim(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order (a row
    slab's rows gathered into the image's)."""
    if mesh.group is None:
        return t
    n = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = mesh.size * n
    buf = t.new_zeros(shape)
    buf.narrow(dim, mesh.rank * n, n).copy_(t)
    return _sum_bytes(buf, mesh)


def _runs(rows: List[int]) -> List[Tuple[int, int]]:
    """Sorted rows as (start, length) runs of consecutive rows."""
    out = []
    for r in rows:
        if out and out[-1][0] + out[-1][1] == r:
            out[-1] = (out[-1][0], out[-1][1] + 1)
        else:
            out.append((r, 1))
    return out


class Rows:
    """The row exchanges of one ``sp`` group: each rank holds rows
    ``[s*h, (s+1)*h)`` of the images' feature maps [n, c, h, w]."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._up: Dict[tuple, tuple] = {}

    def halo(self, x: torch.Tensor, need: List[Tuple[int, int]],
             fill: float) -> torch.Tensor:
        """Global rows ``need[s]`` = [lo, hi) of ``x`` for this rank ``s``
        (every rank passes every rank's range, the same on all), rows
        outside the image filled with ``fill``. One all-reduce carries the
        rows that a rank reads from another; none when no rank does."""
        S, s = self.mesh.size, self.mesh.rank
        n, c, h, w = x.shape
        H = h * S
        send = []            # per owner q: its rows another rank reads
        for q in range(S):
            rows = set()
            for r, (lo, hi) in enumerate(need):
                if r != q:
                    rows.update(range(max(lo, q * h), min(hi, (q + 1) * h)))
            send.append(sorted(rows))
        offs = np.cumsum([0] + [len(v) for v in send]).tolist()
        buf = None
        if offs[-1]:
            buf = x.new_zeros((n, c, offs[-1], w))
            at = offs[s]
            for start, k in _runs(send[s]):
                buf.narrow(2, at, k).copy_(x.narrow(2, start - s * h, k))
                at += k
            _sum_bytes(buf, self.mesh)
        lo, hi = need[s]
        pieces, g = [], lo
        while g < hi:
            if g < 0 or g >= H:
                end = min(hi, 0) if g < 0 else hi
                pieces.append(x.new_full((n, c, end - g, w), fill))
            else:
                q = g // h
                end = min(hi, (q + 1) * h)
                if q == s:
                    pieces.append(x.narrow(2, g - q * h, end - g))
                else:
                    pieces.append(buf.narrow(2, offs[q] + send[q].index(g),
                                             end - g))
            g = end
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, 2)

    def window(self, x: torch.Tensor, top: int, bottom: int,
               fill: float) -> torch.Tensor:
        """This rank's rows with ``top`` rows above and ``bottom`` below."""
        h = x.shape[2]
        return self.halo(x, [(r * h - top, (r + 1) * h + bottom)
                             for r in range(self.mesh.size)], fill)

    def max_over_shards(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the group."""
        buf = t.new_zeros((self.mesh.size,) + tuple(t.shape))
        buf[self.mesh.rank] = t
        return _sum_bytes(buf, self.mesh).amax(0)

    def _upsample_plan(self, hi: int, ho: int, wi: int, wo: int, device):
        """Index and weight tensors of this rank's rows of an align-corners
        upsample of [H_in, wi] -> [H_out, wo], H = S * the local height,
        with PyTorch's arithmetic (a float32 scale (in-1)/(out-1), source
        ``scale * dst``, the lower neighbour by truncation, the upper one
        clamped)."""
        key = (hi, ho, wi, wo, device)
        if key not in self._up:
            S, s = self.mesh.size, self.mesh.rank

            def axis(n_in, n_out):
                scale = (np.float32(n_in - 1) / np.float32(n_out - 1)
                         if n_out > 1 else np.float32(0))
                src = scale * np.arange(n_out, dtype=np.float32)
                i0 = src.astype(np.int64)
                i1 = np.minimum(i0 + 1, n_in - 1)
                return i0, i1, (src - i0.astype(np.float32)).astype(
                    np.float32)

            y0, y1, ly = axis(hi * S, ho * S)
            x0, x1, lx = axis(wi, wo)
            need = [(int(y0[r * ho:(r + 1) * ho].min()),
                     int(y1[r * ho:(r + 1) * ho].max()) + 1)
                    for r in range(S)]
            mine = slice(s * ho, (s + 1) * ho)
            lo = need[s][0]

            def t(a):
                return torch.as_tensor(a, device=device)
            self._up[key] = (need, t(y0[mine] - lo), t(y1[mine] - lo),
                             t(ly[mine])[:, None], t(x0), t(x1), t(lx))
        return self._up[key]

    def upsample(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """``PVNet.upsample`` on a row slab: this rank's ``h`` rows of the
        align-corners upsample of the whole image to S*h rows, computed in
        float32 as PyTorch's kernel does (each row from its two columns'
        blend, then the two rows' blend) and returned in ``x``'s dtype."""
        need, i0, i1, ly, c0, c1, lx = self._upsample_plan(
            x.shape[2], h, x.shape[3], w, x.device)
        xs = self.halo(x, need, 0.0).float()
        xw = xs[..., c0] * (1 - lx) + xs[..., c1] * lx
        return (xw[:, :, i0] * (1 - ly) + xw[:, :, i1] * ly).to(x.dtype)


def _pads(m: nn.Conv2d) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) zero padding of a convolution."""
    if isinstance(m, PadConv2d):
        return m.pad
    ph, pw = m.padding
    return pw, pw, ph, ph


def _bottom(k: int, s: int, d: int, top: int) -> int:
    """Rows below a slab that a window of k rows (dilation d, stride s,
    ``top`` rows above) reads, so that it yields slab/s rows."""
    return max(0, d * (k - 1) - top - s + 1)


class RowConv2d(nn.Module):
    """A convolution (``nn.Conv2d``, ``PadConv2d``, ``QuantConv2d``) on a
    row slab: its halo fetched, no H padding, the W padding its own; an
    int8 one in eval mode with every shard's scale the image's."""

    def __init__(self, conv: nn.Conv2d, rows: Rows):
        super().__init__()
        self.conv, self.rows = conv, rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.conv
        left, right, top, _ = _pads(m)
        quant = isinstance(m, QuantConv2d) and not m.training
        if quant:
            s_x = m.activation_scale(x, self.rows.max_over_shards)
        h = x.shape[2]
        x = self.rows.window(x, top, _bottom(m.kernel_size[0], m.stride[0],
                                             m.dilation[0], top), 0.0)
        if left != right:
            x = F.pad(x, (left, right))
            left = 0
        if quant:
            y = m.int8_conv(x, s_x, (0, left))
        else:
            y = F.conv2d(x, m.weight, m.bias, m.stride, (0, left),
                         m.dilation, m.groups)
        if y.shape[2] * m.stride[0] != h:
            raise ValueError(f"{m} splits a slab of {h} rows into "
                             f"{y.shape[2]}")
        return y


class RowMaxPool2d(nn.Module):
    """``nn.MaxPool2d`` on a row slab: its halo fetched, -inf past the
    image's edges."""

    def __init__(self, pool: nn.MaxPool2d, rows: Rows):
        super().__init__()
        self.pool, self.rows = pool, rows

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pool
        k, s, pad, d = (v if isinstance(v, int) else v[0] for v in (
            p.kernel_size, p.stride, p.padding, p.dilation))
        pw = p.padding if isinstance(p.padding, int) else p.padding[1]
        h = x.shape[2]
        x = self.rows.window(x, pad, _bottom(k, s, d, pad), float("-inf"))
        y = F.max_pool2d(x, p.kernel_size, p.stride, (0, pw), p.dilation,
                         p.ceil_mode)
        if y.shape[2] * s != h:
            raise ValueError(f"{p} splits a slab of {h} rows into "
                             f"{y.shape[2]}")
        return y


def row_sharded(module: nn.Module, rows: Rows) -> nn.Module:
    """A copy of ``module``'s tree (sharing its parameters and buffers)
    that runs on row slabs: each convolution taller than a row, or int8,
    a :class:`RowConv2d`, each max pool a :class:`RowMaxPool2d`, and a
    model's ``upsample`` :meth:`Rows.upsample`."""
    if isinstance(module, nn.Conv2d):
        if (module.kernel_size[0] > 1 or _pads(module)[2] or isinstance(
                module, QuantConv2d)):
            return RowConv2d(module, rows)
        return module
    if isinstance(module, nn.MaxPool2d):
        return RowMaxPool2d(module, rows)
    new = copy.copy(module)
    new.__dict__["_modules"] = {
        k: None if v is None else row_sharded(v, rows)
        for k, v in module._modules.items()}
    if callable(getattr(module, "upsample", None)):
        new.__dict__["upsample"] = rows.upsample
    return new


def _image_height(images: torch.Tensor) -> int:
    """The image height of a batch [b, h, w, 3], or of a packed4 stem's
    packed batch [b, h/2, w/2, 12]."""
    return images.shape[1] * (2 if images.shape[-1] == 12 else 1)


def check_height(H: int, sp: int) -> None:
    """Refuse an image height that the ``sp`` shards cannot split into
    whole output cells: H % (8*sp) != 0 (for a packed4 stem's input, H/2 %
    (4*sp), the same condition)."""
    step = ROW_ALIGN * sp
    if sp > 1 and H % step:
        raise ValueError(
            f"an image of {H} rows does not split over {sp} sp ranks: the "
            f"height must be a multiple of {ROW_ALIGN}*{sp} = {step}; the "
            f"least valid height from {H} up is {-(-H // step) * step}")


def _my_rows(images: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
    """This rank's images (its data group's rows of the batch) and of each
    its row slab, on its device."""
    images = torch.as_tensor(images)
    check_height(_image_height(images), mesh.sp.size)
    x = images[mesh.data.rows(images.shape[0])]
    h = x.shape[1] // mesh.sp.size
    return x[:, mesh.sp.rank * h:(mesh.sp.rank + 1) * h].to(mesh.device)


def spatial_fields(model: nn.Module, x: torch.Tensor, rows: Rows,
                   fcn_bf16: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``pipeline.predict_fields`` on a row slab ``x`` [n, h, w, 3] (or a
    packed [n, h/2, w/2, 12]) of images whose rows lie over ``rows``'
    group: (mask [n, h, w], vertex [n, vn*2, h, w]), this rank's rows of
    the unsharded result. With one shard it is ``predict_fields`` itself."""
    from pvnet_tpu_torch import pipeline as pl
    if model.training:
        raise ValueError("the row-sharded forward is inference only: put "
                         "the model in eval mode")
    net = model if rows.mesh.size == 1 else row_sharded(model, rows)
    with torch.no_grad(), pl._bf16_autocast(x.device.type, fcn_bf16):
        return pl.predict_fields(net, x)


def make_spatial_field_fn(mesh: SpatialMesh, model: nn.Module,
                          fcn_bf16: bool = False):
    """Row-sharded FCN forward only (JAX's ``make_spatial_field_fn``):
    f(images) -> (mask [n, H/S, W], vertex [n, ver_dim, H/S, W]), where
    ``images`` is the global batch [B, H, W, 3] normalized (or packed for
    a packed4 stem), ``n`` this rank's data group's rows of it and the
    rows this rank's ``sp`` shard, as JAX's ``P(data, sp)`` outputs.
    fcn_bf16=True runs the FCN under bfloat16 autocast. Raises unless H %
    (8*S) == 0."""
    rows = Rows(mesh.sp)

    def run(images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return spatial_fields(model, _my_rows(images, mesh), rows, fcn_bf16)
    return run


def make_spatial_pose_pipeline(mesh: SpatialMesh, model: nn.Module,
                               points_3d, K, params=None,
                               uncertainty: bool = False,
                               impl: Optional[str] = None,
                               fcn_bf16: bool = False):
    """Image -> pose with the FCN sharded over image rows (JAX's
    ``make_spatial_pose_pipeline``): the row-sharded FCN, the fields
    gathered over ``sp`` (one exchange along H), then voting (K1, K3) and
    PnP replicated on every ``sp`` rank for its data group's images, the
    covariance path (K3 at ``params.uncertainty_hyp_num``, the
    uncertainty-weighted PnP) with ``uncertainty``.

    Returns run(images, generator=None, draws=None) -> (pose [B, 3, 4],
    kps [B, vn, 2]) of the whole global batch on every rank. ``images``
    is the global batch (see :func:`make_spatial_field_fn`); the draws are
    the global batch's, as in ``pipeline.estimate_poses_sharded``:
    ``draws`` by the names of ``pipeline.draw_shapes``, or drawn in its
    order from ``generator``, seeded alike on every rank. Each data group
    votes its rows with its rows of the draws, so the result equals the
    unsharded pipeline's on the whole batch with the same draws."""
    from pvnet_tpu_torch import pipeline as pl
    params = params or pl.VoteParams()
    device = mesh.device
    points_3d = torch.as_tensor(np.asarray(points_3d, np.float32),
                                device=device)
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    fields = make_spatial_field_fn(mesh, model, fcn_bf16)

    @pl._no_grad
    def run(images: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            draws: Optional[Dict[str, torch.Tensor]] = None):
        images = torch.as_tensor(images)
        b, H = images.shape[0], _image_height(images)
        W = images.shape[2] * (H // images.shape[1])
        mask, vertex = fields(images)
        mask = gather_dim(mask, mesh.sp, 1)
        vertex = gather_dim(vertex, mesh.sp, 2).float()
        shapes = pl.draw_shapes(b, H, W, params, uncertainty, False)
        if draws is None:
            draws = pl.draw_votes(shapes, generator, device=device)
        rows = mesh.data.rows(b)
        d = {k: draws[k][rows].to(device) for k in shapes}
        if uncertainty:
            kps, cov = pl.keypoints_with_covariance(
                mask, vertex, params, d["noise"], d["pair_u"],
                d["cov_noise"], d["cov_pair_u"], impl=impl)
        else:
            kps = pl.keypoints_from_fields(mask, vertex, params, d["noise"],
                                           d["pair_u"], impl=impl)
            cov = None
        pose = pl.poses_from_keypoints(points_3d, kps, K, covar=cov)
        return (all_gather_rows(pose, mesh.data),
                all_gather_rows(kps, mesh.data))

    return run
