"""Data parallelism over a ``torch.distributed`` process group, one
process per GPU (the port of pvnet_tpu/parallel).

The JAX package declares a device mesh and lets XLA insert the
collectives; here every process owns one device, holds a replica of the
model, takes its contiguous rows of each global batch, and the gradients,
BatchNorm statistics and metrics are all-reduced explicitly: NCCL between
GPUs, gloo between CPU processes (``mesh.init_process_group`` picks the
backend from the device). Without a process group everything runs as one
process of world size 1 and makes no collective call.

``pvnet_tpu/parallel/spatial.py`` (one image's rows over a TPU slice,
halo exchanges inserted by XLA's SPMD partitioner) is not ported: torch
has no such partitioner, and one GPU shows nothing of it.
"""

from pvnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_gather_rows, all_reduce_mean, all_reduce_sum, barrier,
    init_process_group, make_global_mesh, make_mesh, rank_zero_first,
    replicate, replicate_global, shard_batch, shard_batch_global)
from pvnet_tpu_torch.parallel.sync_bn import (  # noqa: F401
    SyncBatchNorm2d, convert_sync)
