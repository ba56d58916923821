"""The one generator of the benchmark's inputs, from ``--seed`` and a
traffic file's parameters.

Frames come from the repository's fixture of two 480x640 renders of the
duck (``assets/duck_views_480x640.npz``: images, masks, poses, the 9
keypoints and LINEMOD's K, read in place as the weights are), each copy moved by a seeded whole-pixel shift (zeros
where it leaves the frame; the mask and the keypoints move with it) and
scaled by a seeded brightness factor. Every draw comes from a
``torch.Generator`` on the card seeded from ``--seed`` and a tag, so that
the same seed gives the same frames, draws and order, and another seed
the same amount of work in another order.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import torch

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "duck_views_480x640.npz")


def subseed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of ``--seed`` (any whole number)."""
    words = [int(seed) % (1 << 63)] + [int(t) for t in tags]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, *tags))


def fixture() -> Dict[str, np.ndarray]:
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def keypoints_2d(fx: dict) -> np.ndarray:
    """[views, 9, 3] homogeneous image keypoints of the fixture's poses."""
    pts = fx["points_3d"].astype(np.float64)
    out = []
    for pose in fx["poses"].astype(np.float64):
        cam = pts @ pose[:, :3].T + pose[:, 3]
        uv = cam @ fx["K"].astype(np.float64).T
        out.append(np.concatenate([uv[:, :2] / uv[:, 2:], np.ones((len(pts),
                                                                   1))], 1))
    return np.stack(out).astype(np.float32)


def frames(n: int, seed: int, tag: int, mix: dict, device,
           chunk: int = 128) -> Dict[str, torch.Tensor]:
    """``n`` jittered copies of the fixture's views on ``device``: image
    uint8 [n, H, W, 3], mask uint8 [n, H, W], hcoords float32 [n, 9, 3].
    ``mix``: shift_x, shift_y (largest shift in pixels), brightness [lo,
    hi]; optionally crop [y0, x0, h, w], a window of the views (small
    frames for tests on the CPU)."""
    fx = fixture()
    views = np.concatenate([fx["images"], fx["masks"][..., None]], -1)
    kp = keypoints_2d(fx)
    if mix.get("crop"):
        y0, x0, h, w = mix["crop"]
        views = views[:, y0:y0 + h, x0:x0 + w]
        kp = kp - np.array([x0, y0, 0], np.float32)
    V, H, W, _ = views.shape
    src = torch.from_numpy(np.ascontiguousarray(views)).to(device)
    kp = torch.from_numpy(kp).to(device)
    g = generator(device, seed, tag)
    view = torch.randint(0, V, (n,), generator=g, device=device)
    dx = torch.randint(-mix["shift_x"], mix["shift_x"] + 1, (n,),
                       generator=g, device=device)
    dy = torch.randint(-mix["shift_y"], mix["shift_y"] + 1, (n,),
                       generator=g, device=device)
    lo, hi = mix["brightness"]
    bright = lo + (hi - lo) * torch.rand((n,), generator=g, device=device)
    image = torch.empty((n, H, W, 3), dtype=torch.uint8, device=device)
    mask = torch.empty((n, H, W), dtype=torch.uint8, device=device)
    # each frame is a window of the zero-padded view: one strided copy
    sy, sx = mix["shift_y"], mix["shift_x"]
    pad = torch.zeros((V, H + 2 * sy, W + 2 * sx, 4), dtype=torch.uint8,
                      device=device)
    pad[:, sy:sy + H, sx:sx + W] = src
    y0 = (sy - dy).tolist()
    x0 = (sx - dx).tolist()
    vs = view.tolist()
    buf = torch.empty((chunk, H, W, 4), dtype=torch.uint8, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        for j in range(s, e):
            buf[j - s].copy_(pad[vs[j], y0[j]:y0[j] + H, x0[j]:x0[j] + W])
        rgb = buf[:e - s, ..., :3].float() * bright[s:e, None, None, None]
        image[s:e] = rgb.round().clamp(0, 255).to(torch.uint8)
        mask[s:e] = buf[:e - s, ..., 3]
    hcoords = kp[view].clone()
    hcoords[..., 0] += dx[:, None].float()
    hcoords[..., 1] += dy[:, None].float()
    return {"image": image, "mask": mask, "hcoords": hcoords}


def offline_pool(seed: int, mix: dict, device) -> List[torch.Tensor]:
    """``pool_batches`` distinct batches of ``batch`` frames, in pinned
    host memory, as a loader hands them to the pose job."""
    b, k = mix["batch"], mix["pool_batches"]
    imgs = frames(b * k, seed, 1, mix, device)["image"]
    pool = []
    for i in range(k):
        host = torch.empty(imgs[i * b:(i + 1) * b].shape, dtype=torch.uint8,
                           pin_memory=torch.device(device).type == "cuda")
        host.copy_(imgs[i * b:(i + 1) * b])
        pool.append(host)
    return pool


def batch_order(seed: int, n_pool: int, n: int) -> List[int]:
    """Which pool batch the i-th request takes, for i < n."""
    rng = np.random.default_rng(subseed(seed, 2))
    return [int(i) for i in rng.integers(0, n_pool, n)]


def vote_draws(seed: int, i: int, b: int, h: int, w: int, hyp_num: int,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The i-th batch's voting draws: (noise [b, h, w], pair_u [b, hyp_num,
    2]), uniform in [0, 1)."""
    g = generator(device, seed, 3, i)
    noise = torch.rand((b, h, w), generator=g, device=device)
    pair_u = torch.rand((b, hyp_num, 2), generator=g, device=device)
    return noise, pair_u


def aug_draws(seed: int, i: int, b: int, aug: dict, device
              ) -> Dict[str, torch.Tensor]:
    """The i-th step's augmentation draws, each [b], with the recipe's
    distributions: rotation uniform in [rot_ang_min, rot_ang_max] degrees,
    resize ratio in [resize_ratio_min, resize_ratio_max], crop uniforms,
    flip and blur each with probability 1/2, the blur's size index in
    {0..3}, brightness, contrast and saturation factors in [1 - a, 1 + a]
    (the lower end at least 0), hue in [-hue, hue]."""
    g = generator(device, seed, 4, i)

    def u(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((b,), generator=g, device=device)

    def factor(a):
        return u(max(0.0, 1 - a), 1 + a) if a > 0 else torch.ones(
            (b,), device=device)

    return {"deg": u(aug["rot_ang_min"], aug["rot_ang_max"]),
            "ratio": u(aug["resize_ratio_min"], aug["resize_ratio_max"]),
            "u_h": u(), "u_w": u(), "flip": u() < 0.5,
            "blur_size": torch.randint(0, 4, (b,), generator=g,
                                       device=device),
            "blur": u() < 0.5,
            "brightness": factor(aug["brightness"]),
            "contrast": factor(aug["contrast"]),
            "saturation": factor(aug["saturation"]),
            "hue": u(-aug["hue"], aug["hue"]) if aug["hue"] > 0
            else torch.zeros((b,), device=device)}


def size_cycle(seed: int, cycle: int, mix: dict) -> List[Tuple[int, int]]:
    """The (h, w) of the steps of one cycle: every pair of ``sizes_h`` x
    ``sizes_w`` once, in an order drawn from the seed and the cycle's
    index."""
    sizes = [(h, w) for h in mix["sizes_h"] for w in mix["sizes_w"]]
    rng = np.random.default_rng(subseed(seed, 5, cycle))
    return [sizes[i] for i in rng.permutation(len(sizes))]


def row_order(seed: int, n_rows: int, device) -> torch.Tensor:
    """A seeded order of the training set's rows (int64, on the card)."""
    return torch.randperm(n_rows, generator=generator(device, seed, 6),
                          device=device)


def init_params(shapes: Dict[str, Tuple[int, ...]],
                bns: List[Tuple[str, int]], seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """The recipe's initialization, drawn on the card in one call: every
    convolution kernel He fan-out truncated normal (std sqrt(2 / fan_out)
    / 0.8796 within two deviations, flax's variance_scaling(2, 'fan_out',
    'truncated_normal')), biases 0; BatchNorm scale 1, offset 0, running
    mean 0 and variance 1. float32, the type the recipe trains in."""
    kernels = [k for k, s in shapes.items() if len(s) == 4]
    total = sum(int(np.prod(shapes[k])) for k in kernels)
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                generator=generator(device, seed, 7))
    out, at = {}, 0
    for k in kernels:
        s = shapes[k]
        n = int(np.prod(s))
        std = (2.0 / (s[0] * s[2] * s[3])) ** 0.5 / 0.87962566103423978
        out[k] = (flat[at:at + n] * std).reshape(s)
        at += n
    for k, s in shapes.items():
        if len(s) == 1:
            out[k] = torch.zeros(s, device=device)
    for name, c in bns:
        out[f"{name}.weight"] = torch.ones(c, device=device)
        out[f"{name}.bias"] = torch.zeros(c, device=device)
        out[f"{name}.running_mean"] = torch.zeros(c, device=device)
        out[f"{name}.running_var"] = torch.ones(c, device=device)
    return out
