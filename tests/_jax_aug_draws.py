"""Shared by the port's augmentation and training tests: the random values
that pvnet_tpu.data.augment_device.augment_batch draws from a key, rebuilt
by repeating its key splits (augment_device.py:67, 578, 586-587, 511,
621, 633, 637), as the port's AugDraws; and a small raw batch cut from the
committed fixture."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pvnet_tpu_torch.data.augment_device import AugDraws
from pvnet_tpu_torch.data.pose_transforms import project_np

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "duck_views_480x640.npz")


def jax_draws(key, b: int, cfg) -> AugDraws:
    k_warp, k_flip, k_blur, k_jit, k_sel = jax.random.split(key, 5)
    warp = []
    for wk in jax.random.split(k_warp, b):
        k_rot, k_ratio, k_hbeg, k_wbeg = jax.random.split(wk, 4)
        warp.append([
            jax.random.uniform(k_rot, (), minval=cfg.rot_ang_min,
                               maxval=cfg.rot_ang_max),
            jax.random.uniform(k_ratio, (), minval=cfg.resize_ratio_min,
                               maxval=cfg.resize_ratio_max),
            jax.random.uniform(k_hbeg, ()), jax.random.uniform(k_wbeg, ())])
    warp = np.asarray(warp, np.float32)
    kb, kc, ks, kh = jax.random.split(k_jit, 4)

    def factor(k, amount):
        if amount <= 0:
            return np.ones((b,), np.float32)
        return np.asarray(jax.random.uniform(
            k, (b,), minval=max(0.0, 1 - amount), maxval=1 + amount))

    hue = (np.asarray(jax.random.uniform(kh, (b,), minval=-cfg.hue,
                                         maxval=cfg.hue))
           if cfg.hue > 0 else np.zeros((b,), np.float32))
    def t(a):
        return torch.from_numpy(np.array(a))
    return AugDraws(
        deg=t(warp[:, 0]), ratio=t(warp[:, 1]), u_h=t(warp[:, 2]),
        u_w=t(warp[:, 3]),
        flip=t(np.asarray(jax.random.bernoulli(k_flip, 0.5, (b,)))),
        blur_size=t(np.asarray(jax.random.randint(k_sel, (b,), 0, 4))
                    .astype(np.int64)),
        blur=t(np.asarray(jax.random.bernoulli(k_blur, 0.5, (b,)))),
        brightness=t(factor(kb, cfg.brightness)),
        contrast=t(factor(kc, cfg.contrast)),
        saturation=t(factor(ks, cfg.saturation)), hue=t(hue))


def raw_batch(h: int = 64, w: int = 80, y0: int = 200, x0: int = 280):
    """The fixture's two views cut to [y0:y0+h, x0:x0+w] (the duck lies
    inside), with hcoords [2, 9, 3] from its poses: uint8 images, uint8
    masks, float32 hcoords, as numpy arrays."""
    with np.load(FIXTURE) as z:
        images = z["images"][:, y0:y0 + h, x0:x0 + w]
        masks = z["masks"][:, y0:y0 + h, x0:x0 + w]
        poses, pts, K = z["poses"], z["points_3d"], z["K"].copy()
    K[0, 2] -= x0
    K[1, 2] -= y0
    kp = np.stack([project_np(pts, p, K) for p in poses])
    hcoords = np.concatenate([kp, np.ones(kp.shape[:2] + (1,))], -1)
    return (np.ascontiguousarray(images), np.ascontiguousarray(masks),
            hcoords.astype(np.float32))


def to_jnp(*arrays):
    return [jnp.asarray(a) for a in arrays]
