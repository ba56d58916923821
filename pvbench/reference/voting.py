"""RANSAC keypoint voting (PVNet's ransac_voting_layer_v3) in plain
PyTorch, with the draws handed in.

1. Foreground sample of ``tn`` pixels: the image's pixels fall into tn
   buckets by phase (y mod a, x mod bb), a * bb = tn with a the largest
   divisor of tn not above sqrt(tn); each bucket keeps the foreground pixel
   of highest ``noise`` (none if it has no foreground). The kept pixels,
   in bucket order, form the sample; its count is the number kept.
2. Hypotheses: for each of hn rows of ``pair_u`` [b, hn, 2] the sample
   slots floor(u * count) (at most count - 1) of both columns; the lines
   through each pixel along its normal to the predicted direction meet at
   the hypothesis (0 where |det| < 1e-6).
3. Counts: a sample pixel c with direction n votes for hypothesis h of a
   keypoint where d = h - c satisfies n . d > 0 and (n . d)^2 > t^2 |d|^2
   |n|^2, with |d|^2 and |n|^2 above 1e-12 (cosine above t, written
   without a square root).
4. The first hypothesis with the most votes wins; the keypoint is the
   least-squares intersection of its voters' lines (the winner itself when
   the normal equations are singular, det <= 1e-8); zeros for an image
   with fewer than ``min_num`` foreground pixels.
"""
from __future__ import annotations

import torch


def phase_grid(tn: int):
    a = int(tn ** 0.5)
    while tn % a:
        a -= 1
    return a, tn // a


def sample(mask: torch.Tensor, vertex: torch.Tensor, noise: torch.Tensor,
           tn: int):
    """mask [b, h, w], vertex [b, 2vn, h, w] (x0, y0, x1, y1, ...), noise
    [b, h, w] -> (coords [b, tn, 2] (x, y), dirs [b, tn, vn, 2], valid
    [b, tn], count [b], total [b]); the kept pixels first, in bucket
    order."""
    b, h, w = mask.shape
    vn = vertex.shape[1] // 2
    a, bb = phase_grid(tn)
    hp, wp = -(-h // a) * a, -(-w // bb) * bb
    fg = mask != 0
    score = torch.full((b, hp, wp), -1.0, device=mask.device)
    score[:, :h, :w] = torch.where(fg, noise + 2.0, noise)
    # [b, a, bb, hp/a * wp/bb]: bucket (p, q) holds rows p, p+a, ... and
    # columns q, q+bb, ...
    buckets = score.reshape(b, hp // a, a, wp // bb, bb).permute(
        0, 2, 4, 1, 3).reshape(b, tn, -1)
    arg = buckets.argmax(-1)                   # the first maximum
    best = torch.gather(buckets, 2, arg[..., None])[..., 0]
    valid = best >= 2.0
    p = torch.arange(tn, device=mask.device)
    ys = (arg // (wp // bb)) * a + p // bb
    xs = (arg % (wp // bb)) * bb + p % bb
    ysc, xsc = ys.clamp(max=h - 1), xs.clamp(max=w - 1)
    bi = torch.arange(b, device=mask.device)[:, None]
    dirs = vertex[bi, :, ysc, xsc].reshape(b, tn, vn, 2).float()
    dirs = dirs * valid[..., None, None]
    coords = torch.stack([xs, ys], -1).float()
    order = torch.sort((~valid).to(torch.int8), dim=1, stable=True).indices
    coords = torch.gather(coords, 1, order[..., None].expand(-1, -1, 2))
    dirs = torch.gather(dirs, 1, order[..., None, None].expand(-1, -1, vn,
                                                               2))
    valid = torch.gather(valid, 1, order)
    return coords, dirs, valid, valid.sum(1), fg.flatten(1).sum(1)


def hypotheses(coords, dirs, count, pair_u):
    """[b, hn, vn, 2] intersections of the pairs' lines."""
    b, tn, vn, _ = dirs.shape
    n = count.clamp(min=1)[:, None, None]
    slot = torch.minimum((pair_u * n).to(torch.int64), n - 1)  # [b, hn, 2]
    bi = torch.arange(b, device=coords.device)[:, None]
    c0, c1 = coords[bi, slot[..., 0]], coords[bi, slot[..., 1]]  # [b,hn,2]
    d0, d1 = dirs[bi, slot[..., 0]], dirs[bi, slot[..., 1]]   # [b,hn,vn,2]
    # normals (dy, -dx); line i: n_i . p = n_i . c_i
    n0 = torch.stack([d0[..., 1], -d0[..., 0]], -1)
    n1 = torch.stack([d1[..., 1], -d1[..., 0]], -1)
    r0 = (n0 * c0[:, :, None]).sum(-1)
    r1 = (n1 * c1[:, :, None]).sum(-1)
    det = n1[..., 0] * n0[..., 1] - n0[..., 0] * n1[..., 1]
    ok = det.abs() >= 1e-6
    safe = torch.where(ok, det, torch.ones_like(det))
    y = (n1[..., 0] * r0 - n0[..., 0] * r1) / safe
    x = -(n1[..., 1] * r0 - n0[..., 1] * r1) / safe
    return torch.where(ok[..., None], torch.stack([x, y], -1), 0.0)


def voters(coords, dirs, valid, pts, thresh):
    """Whether each sample pixel votes for each point: pts [b, k, vn, 2]
    -> bool [b, k, vn, tn]."""
    d = pts[:, :, :, None, :] - coords[:, None, None, :, :]
    n = dirs.permute(0, 2, 1, 3)[:, None]                  # [b,1,vn,tn,2]
    dot = (d * n).sum(-1)
    d2 = (d * d).sum(-1)
    n2 = (n * n).sum(-1)
    return ((dot > 0) & (dot * dot > thresh * thresh * d2 * n2)
            & (d2 > 1e-12) & (n2 > 1e-12) & valid[:, None, None, :])


def counts(coords, dirs, valid, hyps, thresh, chunk=32):
    out = [voters(coords, dirs, valid, hyps[:, s:s + chunk], thresh).sum(-1)
           for s in range(0, hyps.shape[1], chunk)]
    return torch.cat(out, 1)                                # [b, hn, vn]


def refine(coords, dirs, valid, win, thresh):
    """Least-squares intersection of the lines of each winner's voters."""
    inl = voters(coords, dirs, valid, win[:, None], thresh)[:, 0]  # b,vn,tn
    n = torch.stack([dirs[..., 1], -dirs[..., 0]], -1).permute(0, 2, 1, 3)
    n = n * inl[..., None]                                  # [b, vn, tn, 2]
    rhs = (n * coords[:, None]).sum(-1)                     # [b, vn, tn]
    a00 = (n[..., 0] ** 2).sum(-1)
    a01 = (n[..., 0] * n[..., 1]).sum(-1)
    a11 = (n[..., 1] ** 2).sum(-1)
    b0 = (n[..., 0] * rhs).sum(-1)
    b1 = (n[..., 1] * rhs).sum(-1)
    det = a00 * a11 - a01 * a01
    safe = torch.where(det.abs() > 1e-8, det, torch.ones_like(det))
    x = (a11 * b0 - a01 * b1) / safe
    y = (a00 * b1 - a01 * b0) / safe
    return torch.where((det.abs() > 1e-8)[..., None],
                       torch.stack([x, y], -1), win)


def vote(mask, vertex, noise, pair_u, hyp_num=512, inlier_thresh=0.99,
         max_num=512, min_num=5):
    """Keypoints [b, vn, 2] and each image's foreground pixels [b]."""
    coords, dirs, valid, count, total = sample(mask, vertex, noise, max_num)
    hyps = hypotheses(coords, dirs, count, pair_u[:, :hyp_num])
    c = counts(coords, dirs, valid, hyps, inlier_thresh)
    win_idx = c.argmax(1)                                   # [b, vn]
    win = torch.gather(hyps, 1, win_idx[:, None, :, None].expand(
        -1, 1, -1, 2))[:, 0]
    kps = refine(coords, dirs, valid, win, inlier_thresh)
    kps = torch.where((total >= min_num)[:, None, None], kps, 0.0)
    return kps, total
