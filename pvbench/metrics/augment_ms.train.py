"""Milliseconds a step spends augmenting on the card:
``trainer.apply_device_aug`` (data/augment_device.py: the separable warp
through K4, blur, jitter), CUDA events around it, the mean over the
traced window's steps (on each card its own rows)."""
UNIT = "ms"
LAYER = "Augmentation: data/augment_device.py"
MOVES = "train_imgs_per_s"


def read(rec):
    ms = rec.get("spans_ms", {}).get("augment")
    return sum(ms) / len(ms) if ms else None
