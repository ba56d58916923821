"""Training data: device augmentation, vertex targets, the batch sampler
and the keypoint projection (counterparts of pvnet_tpu/data/*)."""
