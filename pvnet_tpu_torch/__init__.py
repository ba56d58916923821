"""pvnet_tpu_torch — the PyTorch + CUDA port of pvnet_tpu.

Single-object inference, image -> 6DoF pose, on an NVIDIA Hopper GPU:
a ResNet18-8s PVNet forward (its decoder tail optionally on a packed
half-resolution lattice), stratified foreground selection (CUDA kernels),
shared-pair hypothesis generation, inlier counting (CUDA kernel), a
weighted-least-squares keypoint refine and a batched EPnP +
Levenberg-Marquardt pose solve, optionally weighted by each keypoint's
hypothesis covariance. And training on a device-resident set:
augmentation on the device (its separable warp shifts rows with a CUDA
kernel), vertex targets, the ResNet18-8s forward/backward under bf16
autocast, and Adam. And pose evaluation (ADD(-S), 2D projection, 5cm5deg)
on a synthetic occluded split that the port generates itself.

Module names mirror ``pvnet_tpu`` so each function's JAX counterpart is
found under the same path. The package imports ``torch`` and ``numpy``
only; it never imports JAX, flax, msgpack, PIL or ``pvnet_tpu``.

Subpackages
-----------
- ``pvnet_tpu_torch.models`` : PVNet ResNet18-8s.
- ``pvnet_tpu_torch.ops``    : geometry, voting, PnP, the packed tail, row
  shifts, the kernel wrappers, and (numpy) FPS and the mesh rasterizer.
- ``pvnet_tpu_torch.data``   : device augmentation, vertex targets, the
  batch sampler, PLY meshes, the synthetic split generator and tree
  writer, JPEG/PNG decoding and writing, the LINEMOD databases and the
  render-set and truncated-set generators.
- ``pvnet_tpu_torch.eval``   : pose metrics and the accumulating
  evaluator.
- ``pvnet_tpu_torch.train``  : losses, the train step, checkpoints, the
  recorder, the loop and its validation pass; ``python -m
  pvnet_tpu_torch.train`` trains, and evaluates with ``--test_model``;
  ``python -m pvnet_tpu_torch.prepare`` prepares datasets
  (tools/prepare.py).
- ``pvnet_tpu_torch.utils``  : the flax-msgpack checkpoint reader and the
  weight mapping both ways.
- ``pvnet_tpu_torch.csrc``   : the CUDA C++ kernel sources.
"""

__version__ = "0.1.0"
