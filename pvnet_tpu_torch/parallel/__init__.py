"""Data parallelism over a ``torch.distributed`` process group, one
process per GPU (the port of pvnet_tpu/parallel).

The JAX package declares a device mesh and lets XLA insert the
collectives; here every process owns one device, holds a replica of the
model, takes its contiguous rows of each global batch, and the gradients,
BatchNorm statistics and metrics are all-reduced explicitly: NCCL between
GPUs, gloo between CPU processes (``mesh.init_process_group`` picks the
backend from the device). Without a process group everything runs as one
process of world size 1 and makes no collective call.

Spatial partitioning (``spatial.py``, the port of
``pvnet_tpu/parallel/spatial.py``) splits each image's rows over the
ranks of an ``sp`` axis of a 2D ``(data, sp)`` mesh, with the halo
exchanges that XLA's SPMD partitioner inserts for the JAX package written
out for each convolution, max pool and upsample.
"""

from pvnet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_gather_rows, all_reduce_mean, all_reduce_sum, barrier,
    init_process_group, make_global_mesh, make_mesh, rank_zero_first,
    replicate, replicate_global, shard_batch, shard_batch_global)
from pvnet_tpu_torch.parallel.sync_bn import (  # noqa: F401
    SyncBatchNorm2d, convert_sync)
from pvnet_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialMesh, make_spatial_field_fn, make_spatial_mesh,
    make_spatial_pose_pipeline)
