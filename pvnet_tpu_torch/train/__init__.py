"""Training: losses, the train step, checkpoints, the recorder and the
device-data loop (counterparts of pvnet_tpu/train/*)."""
