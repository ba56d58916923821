"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card, at shapes the main path does not reach (ragged tiles, tiny grids,
ties, widths that are no multiple of 32 or 128, every dtype the row-shift
kernels move) — chip_smoke.py covers the main-path shapes.

Skips without a card. The GPU host has no JAX, and tests/conftest.py
imports JAX, so run this file there without the conftest:

  python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import os

import numpy as np
import pytest
import torch

from pvnet_tpu_torch.ops import row_shift as RS
from pvnet_tpu_torch.ops import select_kernel as SK
from pvnet_tpu_torch.ops import voting as V

from _select_maps import KINDS, first_max_tiles, tie_map

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


# (b, h, w, a, bb) where the kernel's branches part: a = 1, ty_n = 1,
# tx_n = 1; bb from 1 to 64 on the vector path (w % 4 == 0: shuffles where
# bb divides 128, shared atomics alone at bb = 3, 40) and the scalar path
# (w % 4 != 0: shuffles where bb divides 32); more column groups than
# threads (w = 1100, 1280); bb > 4096 (the phases split over blocks)
_GRIDS = [(2, 5, 64, 1, 8), (2, 8, 64, 8, 8), (2, 16, 40, 4, 40),
          (2, 6, 20, 2, 1), (2, 6, 24, 3, 3), (1, 12, 192, 6, 16),
          (3, 8, 640, 4, 32), (2, 4, 1280, 2, 64), (2, 6, 120, 3, 40),
          (2, 6, 45, 3, 3), (2, 9, 70, 3, 14), (2, 4, 66, 2, 2),
          (2, 3, 33, 1, 1), (1, 3, 1100, 1, 4), (1, 2, 8200, 1, 4100),
          (1, 1, 8193, 1, 8193)]


@pytest.mark.parametrize("b,c,h,w,a,bb", [
    (1, 2, 16, 32, 4, 8), (2, 6, 20, 24, 4, 8), (3, 18, 48, 96, 16, 32),
    (2, 4, 64, 64, 8, 8), (1, 1, 8, 8, 8, 8)]
    + [(b, 3, h, w, a, bb) for b, h, w, a, bb in _GRIDS])
def test_select_kernel_equals_plain(cuda, b, c, h, w, a, bb):
    g = torch.Generator().manual_seed(b * h + w)
    score = (torch.rand(b, h, w, generator=g)
             + 2.0 * (torch.rand(b, h, w, generator=g) < 0.3)).to(cuda)
    field = torch.randn(b, c, h, w, generator=g).to(cuda)
    before = SK.stratified_select_cmajor.launches
    got = SK.stratified_select_cmajor(score, field, a, bb)
    want = SK.stratified_select_cmajor_plain(score, field, a, bb)
    torch.cuda.synchronize()
    assert SK.stratified_select_cmajor.launches == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_select_kernel_ties_pick_first_tile(cuda):
    score = torch.full((2, 32, 64), 2.5, device=cuda)
    field = torch.randn(2, 3, 32, 64, device=cuda)
    best, idx, dirs = SK.stratified_select_cmajor(score, field, 8, 16)
    assert (idx == 0).all()
    assert torch.equal(dirs, SK.stratified_select_cmajor_plain(
        score, field, 8, 16)[2])


def test_select_kernel_rejects_what_it_cannot_take(cuda):
    score = torch.rand(1, 16, 32, device=cuda)
    field = torch.rand(1, 2, 16, 32, device=cuda)
    with pytest.raises(TypeError):
        SK.stratified_select_cmajor(score.double(), field.double(), 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        SK.stratified_select_cmajor(score, field.transpose(2, 3).contiguous()
                                    .transpose(2, 3), 4, 8)


def _sample(cuda, b, tn, vn, seed):
    rng = np.random.RandomState(seed)
    coords = rng.uniform(0, 100, (b, tn, 2)).astype(np.float32)
    dirs = rng.randn(b, tn, vn, 2).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    valid = rng.rand(b, tn) > 0.2
    dirs *= valid[:, :, None, None]
    count = valid.sum(1).astype(np.int32)
    return V.ForegroundSample(*(torch.tensor(x, device=cuda) for x in (
        coords, dirs, valid, count, count)))


# the main path (hn=tn=512, vn=9), the covariance pass (hn=1024), tn and
# hn that fill no tile, one keypoint, more hypotheses than one block holds
@pytest.mark.parametrize("b,tn,vn,hn,thresh", [
    (2, 100, 3, 130, 0.95), (1, 1, 1, 5, 0.99), (2, 512, 9, 512, 0.99),
    (3, 300, 2, 1, 0.9), (1, 257, 4, 129, 0.999), (4, 512, 9, 1024, 0.99),
    (2, 500, 9, 512, 0.99), (2, 512, 9, 37, 0.99), (3, 200, 1, 300, 0.99),
    (1, 1000, 2, 1500, 0.95)])
def test_count_kernel_equals_plain(cuda, b, tn, vn, hn, thresh):
    fg = _sample(cuda, b, tn, vn, tn + hn)
    hyps = torch.empty(b, hn, vn, 2, device=cuda).uniform_(-20, 120)
    before = V.count_inliers.launches
    got = V.count_inliers(fg, hyps, thresh)
    want = V.count_inliers_plain(fg, hyps, thresh)
    torch.cuda.synchronize()
    assert V.count_inliers.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _near_boundary(fg, hyps, thresh):
    """Valid pairs whose cosine test holds or fails by less than 1e-6 of
    its right side, in float64."""
    c = fg.coords.double().cpu()[:, None, :, None, :]      # [b,1,tn,1,2]
    n = fg.dirs.double().cpu()[:, None]                     # [b,1,tn,vn,2]
    h = hyps.double().cpu()[:, :, None]                     # [b,hn,1,vn,2]
    dot = ((h - c) * n).sum(-1)
    rhs = thresh ** 2 * ((h - c) ** 2).sum(-1) * (n ** 2).sum(-1)
    near = (dot > 0) & ((dot * dot - rhs).abs() <= 1e-6 * rhs)
    return int((near & fg.valid.cpu()[:, None, :, None]).sum())


def test_count_kernel_on_the_cosine_boundary(cuda):
    # every hypothesis lies at exactly the threshold angle from some
    # pixel's ray, at distances from 0.5 to 200 px, so thousands of pairs
    # sit within an ulp or two of the boundary: where a multiply-add were
    # contracted into an FMA, they would move (ROADMAP fault F4)
    rng = np.random.RandomState(4)
    b, tn, vn, hn, thresh = 2, 300, 3, 600, 0.99
    fg = _sample(cuda, b, tn, vn, 4)
    c = fg.coords.cpu().double()
    n = fg.dirs.cpu().double()
    src = rng.randint(0, tn, (b, hn))
    ang = np.arccos(thresh) * rng.choice([-1.0, 1.0], (b, hn, 1))
    rot = torch.tensor(np.stack([np.cos(ang), np.sin(ang)], -1))
    bi = np.arange(b)[:, None]
    ray = n[bi, src]                                        # [b, hn, vn, 2]
    ray = torch.stack([ray[..., 0] * rot[..., 0] - ray[..., 1] * rot[..., 1],
                       ray[..., 0] * rot[..., 1] + ray[..., 1] * rot[..., 0]],
                      -1)
    dist = torch.tensor(rng.uniform(0.5, 200.0, (b, hn, 1, 1)))
    hyps = (c[bi, src][:, :, None, :] + dist * ray).float().to(cuda)
    hyps[0, :5] = fg.coords[0, :5, None, :]                 # d2 == 0
    assert _near_boundary(fg, hyps, thresh) > 1000
    got = V.count_inliers(fg, hyps, thresh)
    want = V.count_inliers_plain(
        V.ForegroundSample(*(t.cpu() for t in fg)), hyps.cpu(), thresh)
    assert torch.equal(got.cpu(), want)


def test_count_kernel_on_a_learned_field(cuda):
    # the duck checkpoint's own field on the fixture's views (the F4 case
    # of test_torch_pipeline.py at full resolution): many hypotheses sit
    # near the keypoints and tie on their counts, so boundary pixels decide
    # winners
    import os

    from pvnet_tpu_torch import infer, pipeline as PL
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with np.load(os.path.join(repo, "assets", "duck_views_480x640.npz")) as z:
        images = torch.from_numpy(z["images"]).to(cuda)
    model = infer.load_model(os.path.join(repo, "assets", "duck_ckpt.msgpack"),
                             9, cuda)
    g = torch.Generator(cuda).manual_seed(0)
    with torch.no_grad():
        mask, vertex = PL.predict_fields(model, PL.normalize_images(images))
        fg = V.sample_foreground(mask, vertex, 512, generator=g)
        hyps = V.generate_hypotheses(fg, 512, generator=g)
    assert _near_boundary(fg, hyps, 0.99) > 0
    got = V.count_inliers(fg, hyps, 0.99)
    want = V.count_inliers_plain(
        V.ForegroundSample(*(t.cpu() for t in fg)), hyps.cpu(), 0.99)
    assert torch.equal(got.cpu(), want) and int(want.max()) > 100


@pytest.mark.parametrize("chunk", [1, 7, 8, 100, 127, 129, 300, 1000])
def test_count_kernel_pixel_splits(cuda, chunk):
    # blocks that split the pixels at chunks that fill no tile, or tiles
    # their chunk does not divide, add exact partial counts
    from pvnet_tpu_torch.ops import kernel_lib
    b, tn, vn, hn = 2, 700, 3, 600
    fg = _sample(cuda, b, tn, vn, chunk)
    hyps = torch.empty(b, hn, vn, 2, device=cuda).uniform_(-20, 120)
    counts = torch.full((b, hn, vn), -7, dtype=torch.int32, device=cuda)
    err = kernel_lib.library().pvnet_count_inliers(
        fg.coords.data_ptr(), fg.dirs.data_ptr(), fg.valid.data_ptr(),
        hyps.data_ptr(), counts.data_ptr(), b, vn, tn, hn, 0.99 ** 2, chunk,
        torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(err, "pvnet_count_inliers")
    assert torch.equal(counts, V.count_inliers_plain(fg, hyps, 0.99))


def test_count_kernel_empty_batch_and_no_pixels(cuda):
    before = V.count_inliers.launches
    fg = _sample(cuda, 0, 64, 3, 0)
    got = V.count_inliers(fg, torch.zeros(0, 16, 3, 2, device=cuda), 0.99)
    assert got.shape == (0, 16, 3)
    fg = _sample(cuda, 2, 0, 3, 0)
    got = V.count_inliers(fg, torch.rand(2, 16, 3, 2, device=cuda), 0.99)
    assert got.shape == (2, 16, 3) and (got == 0).all()
    assert V.count_inliers.launches == before


def test_count_kernel_takes_views(cuda):
    # a sample whose tensors are not contiguous is copied, not refused
    fg = _sample(cuda, 2, 64, 3, 1)
    hyps = torch.empty(2, 3, 40, 2, device=cuda).uniform_(0, 100)
    view = V.ForegroundSample(
        fg.coords.transpose(0, 1).contiguous().transpose(0, 1),
        fg.dirs, fg.valid, fg.count, fg.total)
    assert torch.equal(V.count_inliers(view, hyps.transpose(1, 2), 0.99),
                       V.count_inliers_plain(fg, hyps.transpose(1, 2), 0.99))


def test_voting_on_cuda_equals_cpu_selection_and_counts(cuda):
    g = torch.Generator().manual_seed(0)
    mask = torch.zeros(2, 60, 90, dtype=torch.int64)
    mask[:, 10:50, 20:70] = 1
    field = torch.randn(2, 6, 60, 90, generator=g)
    noise = torch.rand(2, 60, 90, generator=g)
    pair_u = torch.rand(2, 128, 2, generator=g)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        fg = V.sample_foreground(mask.to(dev), field.to(dev), 256,
                                 noise=noise.to(dev))
        hyps = V.generate_hypotheses(fg, 128, pair_u=pair_u.to(dev))
        outs.append([t.cpu() for t in (*fg, hyps,
                                       V.count_inliers(fg, hyps, 0.99))])
    for x, y in zip(*outs):
        assert torch.equal(x, y)


# --- K2 (stratified_select.cu, NHWC field) ----------------------------------

# C odd, C = 80 (the packed path's 4*(2+18)), a*bb above one block of 128
# threads, the packed path's own grid, a single tile per phase, rows of
# 16 bytes (f32 C = 4, bf16 C = 8: 16-byte copies where C * element size
# is a multiple of 16), and K1's branch grids
@pytest.mark.parametrize("b,h,w,c,a,bb", [
    (2, 16, 32, 3, 4, 8), (3, 24, 48, 80, 8, 16), (1, 32, 64, 5, 16, 16),
    (2, 40, 96, 18, 8, 32), (1, 8, 8, 1, 8, 8), (2, 30, 40, 80, 30, 40),
    (2, 24, 64, 4, 8, 16), (2, 24, 64, 8, 8, 16)]
    + [(b, h, w, 3, a, bb) for b, h, w, a, bb in _GRIDS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_nhwc_kernel_equals_plain(cuda, b, h, w, c, a, bb, dtype):
    g = torch.Generator().manual_seed(b * h + w + c)
    score = (torch.rand(b, h, w, generator=g)
             + 2.0 * (torch.rand(b, h, w, generator=g) < 0.3)).to(cuda)
    field = torch.randn(b, h, w, c, generator=g).to(dtype).to(cuda)
    before = SK.stratified_select.launches
    got = SK.stratified_select(score, field, a, bb)
    want = SK.stratified_select_plain(score, field, a, bb)
    torch.cuda.synchronize()
    assert SK.stratified_select.launches == before + 1
    assert got[2].dtype == dtype
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_select_nhwc_kernel_empty_batch_and_ties(cuda):
    best, idx, dirs = SK.stratified_select(
        torch.rand(0, 16, 32, device=cuda), torch.rand(0, 16, 32, 4,
                                                       device=cuda), 4, 8)
    assert best.shape == (0, 4, 8) and dirs.shape == (0, 4, 8, 4)
    score = torch.full((2, 32, 64), 2.5, device=cuda)
    field = torch.randn(2, 32, 64, 7, device=cuda)
    _, idx, dirs = SK.stratified_select(score, field, 8, 16)
    assert (idx == 0).all()
    assert torch.equal(dirs, field[:, :8, :16])


def test_select_nhwc_kernel_rejects_what_it_cannot_take(cuda):
    score = torch.rand(1, 16, 32, device=cuda)
    field = torch.rand(1, 16, 32, 4, device=cuda)
    with pytest.raises(TypeError):
        SK.stratified_select(score, field.half(), 4, 8)
    with pytest.raises(TypeError):
        SK.stratified_select(score.double(), field, 4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        SK.stratified_select(score, torch.rand(1, 16, 4, 32, device=cuda)
                             .transpose(2, 3), 4, 8)
    with pytest.raises(ValueError, match="score on"):
        SK.stratified_select(score.cpu(), field, 4, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_sampling_on_cuda_equals_cpu(cuda, dtype):
    # a 30x44 lattice: tn=256 -> (8, 8) cells, so both axes are padded
    g = torch.Generator().manual_seed(1)
    rows = torch.randn(2, 30, 44, 4, 8, generator=g)
    rows[..., 1] = rows[..., 0] + torch.where(
        torch.rand(2, 30, 44, 4, generator=g) < 0.4, 1.0, -1.0)
    fgcnt = (rows[..., 1] > rows[..., 0]).sum(-1).float()
    packed = rows.reshape(2, 30, 44, 32).to(dtype)
    noise = torch.rand(2, 30, 44, generator=g)
    pair_u = torch.rand(2, 128, 2, generator=g)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        before = SK.stratified_select.launches
        fg = V.sample_foreground_packed(packed.to(dev), fgcnt.to(dev), 256,
                                        noise=noise.to(dev))
        assert SK.stratified_select.launches == before + (dev == cuda)
        hyps = V.generate_hypotheses(fg, 128, pair_u=pair_u.to(dev))
        outs.append([t.cpu() for t in (*fg, hyps,
                                       V.count_inliers(fg, hyps, 0.99))])
    for x, y in zip(*outs):
        assert torch.equal(x, y)


# --- K1 and K2: the tie rule, unaligned inputs, batch sizes, NaN, -0 -------

_LAYOUTS = ["cmajor", "f32", "bf16"]      # K1; K2 with a float32 / bf16 field


def _bits(x):
    """The tensor's bit patterns (so that -0.0 and 0.0 differ)."""
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _field(layout, score, c, seed=0):
    b, h, w = score.shape
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(b, h, w, c, generator=g)
    if layout == "cmajor":
        f = f.permute(0, 3, 1, 2).contiguous()
    elif layout == "bf16":
        f = f.bfloat16()
    return f.to(score.device)


def _selects_like_plain(layout, score, field, a, bb):
    """The kernel (K1 for the "cmajor" layout, else K2) equals its plain
    version bit for bit, in one launch."""
    if layout == "cmajor":
        fn, plain = (SK.stratified_select_cmajor,
                     SK.stratified_select_cmajor_plain)
    else:
        fn, plain = SK.stratified_select, SK.stratified_select_plain
    before = fn.launches
    got = fn(score, field, a, bb)
    want = plain(score, field, a, bb)
    torch.cuda.synchronize()
    assert fn.launches == before + (score.shape[0] > 0)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))
    return got


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("a,bb", [(8, 8), (4, 32)])
@pytest.mark.parametrize("kind", KINDS)
def test_select_tie_maps(cuda, kind, a, bb, layout):
    score = torch.from_numpy(tie_map(kind, 2, 24, 256, a, bb,
                                     seed=len(kind) + a)).to(cuda)
    _, idx, _ = _selects_like_plain(layout, score, _field(layout, score, 3),
                                    a, bb)
    assert np.array_equal(idx.cpu().numpy(),
                          first_max_tiles(score.cpu().numpy(), a, bb))


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("h,w,a,bb", [(15, 45, 5, 9), (16, 64, 4, 16)])
def test_select_unaligned_score(cuda, h, w, a, bb, layout):
    # a score that does not start on 16 bytes takes the scalar path even
    # where w % 4 == 0: the [1:] slice of a [b+1, h, w] tensor (h*w odd),
    # and a view one element into a flat buffer
    b = 2
    if h * w % 2:
        score = torch.rand(b + 1, h, w, device=cuda)[1:]
    else:
        score = torch.rand(b * h * w + 1, device=cuda)[1:].view(b, h, w)
    assert score.is_contiguous() and score.data_ptr() % 16
    _selects_like_plain(layout, score, _field(layout, score, 3), a, bb)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_nhwc_unaligned_field(cuda, dtype):
    # an 80-channel field one element into its buffer: element by element
    score = torch.rand(2, 24, 64, device=cuda)
    n = 2 * 24 * 64 * 80
    field = torch.randn(n + 1, device=cuda).to(dtype)[1:].view(2, 24, 64, 80)
    assert field.data_ptr() % 16
    _selects_like_plain("nhwc", score, field, 8, 16)


@pytest.mark.parametrize("layout", _LAYOUTS)
@pytest.mark.parametrize("b", [0, 64])
def test_select_batch_sizes(cuda, b, layout):
    score = torch.rand(b, 48, 64, device=cuda)
    best, idx, dirs = _selects_like_plain(
        layout, score, _field(layout, score, 3), 8, 16)
    assert best.shape == idx.shape == (b, 8, 16) and dirs.shape[0] == b


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_select_never_picks_nan(cuda, layout):
    # the kernel, like the Pallas kernels, passes over a NaN score: it
    # equals the plain version on the map with NaN read as -inf (no bucket
    # is NaN throughout, so no winner's score is NaN)
    g = torch.Generator().manual_seed(5)
    score = torch.rand(2, 24, 256, generator=g)
    score[torch.rand(2, 24, 256, generator=g) < 0.1] = float("nan")
    score = score.to(cuda)
    field = _field(layout, score, 3)
    got = (SK.stratified_select_cmajor if layout == "cmajor"
           else SK.stratified_select)(score, field, 8, 8)
    want = _selects_like_plain(
        layout, torch.where(score.isnan(), float("-inf"), score), field, 8, 8)
    for x, y in zip(got, want):
        assert torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("layout", _LAYOUTS)
def test_select_signed_zeros_tie(cuda, layout):
    # -0.0 and 0.0 tie, as '>' sees them: tile 0 wins and its score comes
    # back with its sign
    g = torch.Generator().manual_seed(6)
    score = torch.where(torch.rand(2, 24, 256, generator=g) < 0.5, -0.0, 0.0)
    score = score.to(cuda)
    _, idx, _ = _selects_like_plain(layout, score, _field(layout, score, 3),
                                    8, 8)
    assert (idx == 0).all()


# --- K4 / K5 (row_shift.cu) -------------------------------------------------

def _shift_input(cuda, shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.float32:
        return torch.rand(shape, generator=g).to(cuda)
    return torch.randint(0, 120, shape, generator=g).to(dtype).to(cuda)


_SHIFT_DTYPES = [torch.float32, torch.int32, torch.uint8, torch.int8]


@pytest.mark.parametrize("dtype", _SHIFT_DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 37), (3, 5, 100),
                                   (2, 7, 129), (4, 3, 640), (1, 2, 1000)])
def test_shift_lanes_kernel_equals_plain(cuda, shape, dtype):
    P, R, C = shape
    x = _shift_input(cuda, shape, dtype, C)
    g = torch.Generator().manual_seed(R)
    for s in (torch.randint(-3 * C, 3 * C, (P, R), generator=g),
              torch.zeros(P, R, dtype=torch.int64),
              torch.full((P, R), C - 1)):
        s = s.to(torch.int32).to(cuda)
        before = RS.shift_lanes.launches
        got = RS.shift_lanes(x, s)
        want = RS.shift_lanes_plain(x, s)
        torch.cuda.synchronize()
        assert RS.shift_lanes.launches == before + 1
        assert got.dtype == dtype and torch.equal(got, want)


# strips of 32 four-byte or 128 one-byte columns: widths on both sides of
# a strip boundary, C % 4 != 0 (no word stores), H below the block's 8
# warps, H = 480 (60 KB of shared memory), and H = 2000, whose strip does
# not fit shared memory (the direct branch)
@pytest.mark.parametrize("dtype", _SHIFT_DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 37, 1), (3, 53, 41),
                                   (2, 480, 130), (1, 33, 257), (5, 7, 128),
                                   (2, 11, 31), (2, 9, 32), (2, 5, 33),
                                   (1, 3, 127), (1, 4, 129), (2, 1, 130),
                                   (1, 6, 256), (2, 480, 640),
                                   (1, 2000, 41), (1, 2000, 132)])
def test_shift_sublanes_kernel_equals_plain(cuda, shape, dtype):
    P, H, C = shape
    x = _shift_input(cuda, shape, dtype, H)
    g = torch.Generator().manual_seed(C)
    for s in (torch.randint(-3 * H, 3 * H, (P, C), generator=g),
              torch.zeros(P, C, dtype=torch.int64),
              torch.full((P, C), H - 1)):
        s = s.to(torch.int32).to(cuda)
        before = RS.shift_sublanes.launches
        got = RS.shift_sublanes(x, s)
        want = RS.shift_sublanes_plain(x, s)
        torch.cuda.synchronize()
        assert RS.shift_sublanes.launches == before + 1
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype,offset", [
    (torch.uint8, 1), (torch.uint8, 4), (torch.int8, 2), (torch.float32, 1),
    (torch.int32, 2)])
def test_shift_sublanes_kernel_takes_unaligned_planes(cuda, dtype, offset):
    # a contiguous view that starts off a 16-byte boundary stages element
    # by element
    shape = (3, 45, 260)
    flat = _shift_input(cuda, (offset + 3 * 45 * 260,), dtype, offset)
    x = flat[offset:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    s = torch.randint(-90, 90, (3, 260), device=cuda, dtype=torch.int32)
    assert torch.equal(RS.shift_sublanes(x, s), RS.shift_sublanes_plain(x, s))


def test_shift_kernels_take_wide_starts(cuda):
    x = torch.rand(2, 3, 50, device=cuda)
    s = torch.full((2, 3), 50 * 2**40 + 7, dtype=torch.int64, device=cuda)
    assert torch.equal(RS.shift_lanes(x, s),
                       RS.shift_lanes_plain(x, torch.full_like(s, 7)))


@pytest.mark.parametrize("starts_dtype", [torch.int8, torch.uint8,
                                          torch.int16])
def test_shift_kernels_take_narrow_starts(cuda, starts_dtype):
    # n = 640 is past the range of the narrow types; the plain version
    # widens its starts first, so must the wrapper
    n = 640
    x = _shift_input(cuda, (2, 3, n), torch.float32, 0)
    info = torch.iinfo(starts_dtype)
    lo, hi = max(info.min, -3 * n), min(info.max, 3 * n)
    g = torch.Generator().manual_seed(1)
    s = torch.randint(lo, hi + 1, (2, 3), generator=g).to(starts_dtype)
    s = s.to(cuda)
    assert torch.equal(RS.shift_lanes(x, s), RS.shift_lanes_plain(x, s))
    xt = x.transpose(1, 2).contiguous()                     # [2, n, 3]
    assert torch.equal(RS.shift_sublanes(xt, s),
                       RS.shift_sublanes_plain(xt, s))


def test_shift_kernels_reject_what_they_cannot_take(cuda):
    x = torch.rand(2, 4, 16, device=cuda)
    s = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        RS.shift_lanes(x.double(), s)
    with pytest.raises(TypeError):
        RS.shift_sublanes(x.half(), torch.zeros(2, 16, dtype=torch.int32,
                                                device=cuda))
    with pytest.raises(ValueError, match="starts on"):
        RS.shift_lanes(x, s.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        RS.shift_lanes(x.transpose(1, 2).contiguous().transpose(1, 2), s)


def test_augmentation_with_the_kernel_equals_the_plain_shift(cuda,
                                                             monkeypatch):
    from pvnet_tpu_torch.config import AugConfig
    from pvnet_tpu_torch.data import augment_device as AD
    g = torch.Generator().manual_seed(0)
    image = torch.randint(0, 256, (2, 60, 80, 3), generator=g,
                          dtype=torch.uint8).to(cuda)
    mask = torch.zeros(2, 60, 80, dtype=torch.uint8, device=cuda)
    mask[:, 20:40, 30:60] = 1
    hcoords = torch.tensor([[[40.0, 30.0, 1.0]]] * 2, device=cuda)
    cfg = AugConfig()
    draws = AD.sample_draws(2, cfg, torch.Generator(cuda).manual_seed(1),
                            cuda)
    before = RS.shift_lanes.launches
    got = AD.augment_batch(image, mask, hcoords, (48, 64), cfg, draws=draws)
    assert RS.shift_lanes.launches == before + 2
    monkeypatch.setattr(RS, "shift_lanes", RS.shift_lanes_plain)
    want = AD.augment_batch(image, mask, hcoords, (48, 64), cfg, draws=draws)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_augmentation_never_waits_for_the_device(cuda):
    # a host-to-device copy of a constant, or a read back, would block the
    # host until the queue drains and leave the card idle meanwhile
    from pvnet_tpu_torch.config import AugConfig
    from pvnet_tpu_torch.data import augment_device as AD
    image = torch.zeros(2, 60, 80, 3, dtype=torch.uint8, device=cuda)
    mask = torch.zeros(2, 60, 80, dtype=torch.uint8, device=cuda)
    mask[:, 20:40, 30:60] = 1
    hcoords = torch.ones(2, 1, 3, device=cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    cfg = AugConfig()
    AD.augment_batch(image, mask, hcoords, (48, 64), cfg, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        AD.augment_batch(image, mask, hcoords, (48, 64), cfg, generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("u8", [True, False])
def test_gather_augmentation_never_waits_for_the_device(cuda, u8):
    # the one-pass gather warps of a +-90 deg recipe: uint8 input takes
    # the packed-word warp, float input the float one; neither may block
    # the host, and neither launches K4
    import dataclasses
    from pvnet_tpu_torch.config import AugConfig
    from pvnet_tpu_torch.data import augment_device as AD
    dtype = torch.uint8 if u8 else torch.float32
    image = torch.zeros(2, 60, 80, 3, dtype=dtype, device=cuda)
    mask = torch.zeros(2, 60, 80, dtype=torch.uint8, device=cuda)
    mask[:, 20:40, 30:60] = 1
    hcoords = torch.ones(2, 1, 3, device=cuda)
    gen = torch.Generator(cuda).manual_seed(0)
    cfg = dataclasses.replace(AugConfig(), rot_ang_min=-90.0,
                              rot_ang_max=90.0)
    AD.augment_batch(image, mask, hcoords, (48, 64), cfg, generator=gen)
    torch.cuda.synchronize()
    before = RS.shift_lanes.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = AD.augment_batch(image, mask, hcoords, (48, 64), cfg,
                               generator=gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert RS.shift_lanes.launches == before
    assert out[0].shape == (2, 3, 48, 64) and out[1].dtype == torch.int32


# --- K3's bfloat16 mode ------------------------------------------------------

# the main path (hn=tn=512, vn=9), the covariance pass (hn=1024), tn and
# hn that fill no tile, one keypoint, one pixel, invalid slots throughout
@pytest.mark.parametrize("b,tn,vn,hn", [
    (2, 512, 9, 512), (4, 512, 9, 1024), (2, 500, 9, 512), (2, 512, 9, 37),
    (3, 200, 1, 300), (1, 1, 1, 5), (2, 100, 3, 130), (1, 1000, 2, 1500)])
def test_count_bf16_kernel_equals_plain(cuda, b, tn, vn, hn):
    fg = _sample(cuda, b, tn, vn, tn + hn + 1)
    hyps = torch.empty(b, hn, vn, 2, device=cuda).uniform_(-20, 120)
    before = V.count_inliers_bf16.launches
    got = V.count_inliers(fg, hyps, 0.99, impl="bf16")
    want = V.count_inliers_plain_bf16(fg, hyps, 0.99)
    torch.cuda.synchronize()
    assert V.count_inliers_bf16.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_count_bf16_kernel_on_pixels_equals_the_cpu(cuda):
    # pixel coordinates (integers) make the centroid exact on any device,
    # so the card's kernel equals the CPU's plain version
    fg = _sample(cuda, 3, 512, 9, 5)
    fg = fg._replace(coords=fg.coords.floor() * 4.0)
    hyps = torch.empty(3, 512, 9, 2, device=cuda).uniform_(-20, 420)
    got = V.count_inliers_bf16(fg, hyps, 0.99)
    want = V.count_inliers_plain_bf16(
        V.ForegroundSample(*(t.cpu() for t in fg)), hyps.cpu(), 0.99)
    assert torch.equal(got.cpu(), want)


def test_count_bf16_kernel_on_the_cosine_boundary(cuda):
    # hypotheses at exactly the threshold angle from some pixel's ray: in
    # bfloat16 many pairs round onto either side of the test; a contracted
    # multiply-add or a skipped rounding would move them
    rng = np.random.RandomState(6)
    b, tn, vn, hn, thresh = 2, 300, 3, 600, 0.99
    fg = _sample(cuda, b, tn, vn, 6)
    c, n = fg.coords.cpu().double(), fg.dirs.cpu().double()
    src = rng.randint(0, tn, (b, hn))
    ang = np.arccos(thresh) * rng.choice([-1.0, 1.0], (b, hn, 1))
    rot = torch.tensor(np.stack([np.cos(ang), np.sin(ang)], -1))
    bi = np.arange(b)[:, None]
    ray = n[bi, src]
    ray = torch.stack([ray[..., 0] * rot[..., 0] - ray[..., 1] * rot[..., 1],
                       ray[..., 0] * rot[..., 1] + ray[..., 1] * rot[..., 0]],
                      -1)
    dist = torch.tensor(rng.uniform(0.5, 200.0, (b, hn, 1, 1)))
    hyps = (c[bi, src][:, :, None, :] + dist * ray).float().to(cuda)
    hyps[0, :5] = fg.coords[0, :5, None, :]                 # d2 == 0
    assert _near_boundary(fg, hyps, thresh) > 1000
    got = V.count_inliers_bf16(fg, hyps, thresh)
    assert torch.equal(got, V.count_inliers_plain_bf16(fg, hyps, thresh))
    # and the mode is not the float32 count
    assert not torch.equal(got, V.count_inliers(fg, hyps, thresh))


def test_count_bf16_kernel_empty_batch_and_no_pixels(cuda):
    before = V.count_inliers_bf16.launches
    fg = _sample(cuda, 0, 64, 3, 0)
    got = V.count_inliers_bf16(fg, torch.zeros(0, 16, 3, 2, device=cuda),
                               0.99)
    assert got.shape == (0, 16, 3)
    fg = _sample(cuda, 2, 0, 3, 0)
    got = V.count_inliers_bf16(fg, torch.rand(2, 16, 3, 2, device=cuda),
                               0.99)
    assert got.shape == (2, 16, 3) and (got == 0).all()
    assert V.count_inliers_bf16.launches == before


def _count_bf16_entry(fg, hyps, chunk):
    """K3's bf16 mode through its C entry with a forced pixel chunk (0:
    the entry's own choice), with the wrapper's centroid and constants."""
    from pvnet_tpu_torch.ops import kernel_lib
    b, hn, vn, _ = hyps.shape
    ctr = V._centroid(fg.coords, fg.valid)
    t2, eps2 = (float(c) for c in V._bf16_constants(0.99, "cpu"))
    counts = torch.full((b, hn, vn), -7, dtype=torch.int32,
                        device=hyps.device)
    err = kernel_lib.library().pvnet_count_inliers_bf16(
        fg.coords.data_ptr(), fg.dirs.data_ptr(), fg.valid.data_ptr(),
        hyps.data_ptr(), ctr.data_ptr(), counts.data_ptr(), b, vn,
        fg.coords.shape[1], hn, t2, eps2, chunk,
        torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(err, "pvnet_count_inliers_bf16")
    return counts


@pytest.mark.parametrize("chunk", [1, 7, 8, 100, 127, 129, 300, 1000])
def test_count_bf16_kernel_pixel_splits(cuda, chunk):
    # blocks that split the pixels at chunks that fill no staged tile, or
    # tiles their chunk does not divide, add exact partial counts
    b, tn, vn, hn = 2, 700, 3, 600
    fg = _sample(cuda, b, tn, vn, chunk + 1)
    hyps = torch.empty(b, hn, vn, 2, device=cuda).uniform_(-20, 120)
    assert torch.equal(_count_bf16_entry(fg, hyps, chunk),
                       V.count_inliers_plain_bf16(fg, hyps, 0.99))


# a lane packs two hypotheses: an odd hn leaves one half empty, and hn
# that is no multiple of a block's hypotheses leaves lanes empty
@pytest.mark.parametrize("hn", [1, 3, 37, 511, 513, 1023, 1025, 1537])
def test_count_bf16_kernel_odd_hypothesis_counts(cuda, hn):
    fg = _sample(cuda, 3, 300, 4, hn)
    hyps = torch.empty(3, hn, 4, 2, device=cuda).uniform_(-20, 120)
    got = V.count_inliers_bf16(fg, hyps, 0.99)
    assert got.shape == (3, hn, 4)
    assert torch.equal(got, V.count_inliers_plain_bf16(fg, hyps, 0.99))


@pytest.mark.parametrize("chunk", [0, 70000])
def test_count_bf16_kernel_counts_past_16_bits(cuda, chunk):
    # 70 000 pixels whose rays all meet at one point: the hypotheses there
    # count more than 65 535 inliers, in one block (chunk 70 000) or split
    rng = np.random.RandomState(7)
    tn = 70000
    coords = rng.uniform(0, 300, (1, tn, 2)).astype(np.float32)
    kp = np.array([150.5, 149.25], np.float32)
    dirs = (kp - coords)[:, :, None, :]
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    valid = np.ones((1, tn), bool)
    count = np.array([tn], np.int32)
    fg = V.ForegroundSample(*(torch.tensor(x, device=cuda) for x in (
        coords, dirs.astype(np.float32), valid, count, count)))
    hyps = torch.tensor(kp + rng.uniform(-2, 2, (1, 9, 1, 2)),
                        dtype=torch.float32, device=cuda)
    hyps[0, 0, 0] = torch.tensor(kp)
    want = V.count_inliers_plain_bf16(fg, hyps, 0.99)
    assert int(want.max()) > 65535
    assert torch.equal(_count_bf16_entry(fg, hyps, chunk), want)


def test_count_bf16_kernel_invalid_image_beside_a_full_one(cuda):
    fg = _sample(cuda, 2, 400, 3, 8)
    valid = torch.zeros_like(fg.valid)
    valid[1] = True
    count = valid.sum(1).to(torch.int32)
    fg = fg._replace(valid=valid, count=count, total=count)
    hyps = torch.empty(2, 300, 3, 2, device=cuda).uniform_(-20, 120)
    got = V.count_inliers_bf16(fg, hyps, 0.99)
    assert (got[0] == 0).all() and int(got[1].max()) > 0
    assert torch.equal(got, V.count_inliers_plain_bf16(fg, hyps, 0.99))


def test_count_bf16_kernel_drops_short_rays(cuda):
    # valid pixels whose ray has n2 <= eps2 (zero, 1e-7, 1e-6: just under
    # and about at bf16(1e-12)) count for no hypothesis
    fg = _sample(cuda, 2, 300, 3, 9)
    dirs = fg.dirs.clone()
    dirs[:, 0::3] = 0.0
    dirs[:, 1::3] *= 1e-7
    dirs[:, 2::6] *= 1e-6
    fg = fg._replace(dirs=dirs)
    hyps = torch.empty(2, 200, 3, 2, device=cuda).uniform_(-20, 120)
    got = V.count_inliers_bf16(fg, hyps, 0.99)
    assert torch.equal(got, V.count_inliers_plain_bf16(fg, hyps, 0.99))


def _symmetric_sample(cuda, b, vn, seed):
    """Integer pixels symmetric about 0, (0, 0) among them, so that the
    centroid is exactly 0; a fifth of the rays with a 1e-20 component."""
    rng = np.random.RandomState(seed)
    half = rng.randint(-60, 61, (b, 150, 2)).astype(np.float32)
    coords = np.concatenate([half, -half, np.zeros((b, 1, 2), np.float32)],
                            1)
    tn = coords.shape[1]
    dirs = rng.randn(b, tn, vn, 2).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    tiny = rng.rand(b, tn, vn) < 0.2
    dirs[..., 0] = np.where(tiny, 1e-20 * np.sign(dirs[..., 0]),
                            dirs[..., 0])
    valid = np.ones((b, tn), bool)
    count = np.full((b,), tn, np.int32)
    return V.ForegroundSample(*(torch.tensor(x, device=cuda) for x in (
        coords, dirs, valid, count, count)))


def test_count_bf16_kernel_near_the_centroid(cuda):
    # hypotheses within 1e-20 of the centroid: dx = hx - 0 at the pixel on
    # the centroid, and dx * dx, dx * nx underflow into bf16 subnormals
    fg = _symmetric_sample(cuda, 2, 3, 10)
    assert float(V._centroid(fg.coords, fg.valid).abs().max()) == 0.0
    g = torch.Generator().manual_seed(10)
    hyps = torch.randn(2, 260, 3, 2, generator=g).to(cuda) * 1e-20
    hyps[:, 130:] = torch.randn(2, 130, 3, 2, generator=g).to(cuda) * 30
    got = V.count_inliers_bf16(fg, hyps, 0.99)
    assert torch.equal(got, V.count_inliers_plain_bf16(fg, hyps, 0.99))


def test_count_bf16_kernel_signed_zeros(cuda):
    # +0 and -0 in pixels, rays and hypotheses (recentred on a centroid of
    # 0): d2 = 0 pairs and dot = -0 must count for nothing
    fg = _symmetric_sample(cuda, 2, 3, 11)
    coords = fg.coords.clone()
    coords[:, -1] = -0.0
    coords[:, 0, 0] = -0.0
    coords[:, 150, 0] = 0.0          # the pair stays symmetric
    dirs = fg.dirs.clone()
    dirs[:, 1::4, :, 0] = -0.0
    dirs[:, 2::4, :, 1] = 0.0
    fg = fg._replace(coords=coords, dirs=dirs)
    hyps = torch.randn(2, 64, 3, 2, device=cuda) * 20
    hyps[:, 0::4] = 0.0
    hyps[:, 1::4] = -0.0
    hyps[:, 2::4, :, 0] = -0.0
    got = V.count_inliers_bf16(fg, hyps, 0.99)
    assert torch.equal(got, V.count_inliers_plain_bf16(fg, hyps, 0.99))


def test_count_bf16_kernel_behind_the_pixel(cuda):
    # hypotheses on each pixel's ray line, ahead of it and behind it: the
    # product test holds for both, only dot > 0 parts them (the kernel
    # folds it into dot * |dot| > t2 * d2 * n2)
    rng = np.random.RandomState(12)
    b, tn, vn, hn = 2, 300, 3, 400
    fg = _sample(cuda, b, tn, vn, 12)
    c, n = fg.coords.cpu(), fg.dirs.cpu()
    src = torch.tensor(rng.randint(0, tn, (b, hn)))
    dist = torch.tensor(rng.uniform(0.5, 100.0, (b, hn, 1, 1))
                        * rng.choice([-1.0, 1.0], (b, hn, 1, 1)),
                        dtype=torch.float32)
    bi = torch.arange(b)[:, None]
    hyps = (c[bi, src][:, :, None, :] + dist * n[bi, src]).to(cuda)
    got = V.count_inliers_bf16(fg, hyps, 0.99)
    want = V.count_inliers_plain_bf16(fg, hyps, 0.99)
    assert torch.equal(got, want)
    behind = (dist[..., 0, 0] < 0).to(cuda)
    ahead = ~behind & fg.valid[bi.to(cuda), src.to(cuda)]
    # each hypothesis ahead of a valid pixel counts at least that pixel
    assert (want[ahead] >= 1).all()


# --- the int8 convolution route (gathered taps through torch._int_mm) --------

# (cin, cout, k, stride, dilation, padding, h, w) of every quantized
# convolution of the serving preset at 480x640 (b=2 here): layer1-layer4's
# 3x3 convs at their dilations, the 1x1 downsample convs, the decoder's fc
# and 8s convs, and the packed tail's lattice and skip convs per stage
_INT8_SHAPES = [
    (64, 64, 3, 1, 1, 1, 120, 160), (64, 128, 3, 2, 1, 1, 120, 160),
    (128, 128, 3, 1, 1, 1, 60, 80), (64, 128, 1, 2, 1, 0, 120, 160),
    (128, 256, 3, 1, 2, 2, 60, 80), (256, 256, 3, 1, 2, 2, 60, 80),
    (128, 256, 1, 1, 1, 0, 60, 80), (256, 512, 3, 1, 4, 4, 60, 80),
    (512, 512, 3, 1, 4, 4, 60, 80), (256, 512, 1, 1, 1, 0, 60, 80),
    (512, 256, 3, 1, 1, 1, 60, 80), (384, 128, 3, 1, 1, 1, 60, 80),
    (512, 256, 2, 1, 1, 0, 61, 81), (64, 256, 4, 2, 1, 1, 120, 160),
    (256, 128, 2, 1, 1, 0, 121, 161), (64, 128, 4, 2, 1, 1, 240, 320),
    (128, 128, 2, 1, 1, 0, 241, 321)]


@pytest.mark.parametrize("cin,cout,k,stride,dil,pad,h,w", _INT8_SHAPES)
def test_int8_route_equals_plain(cuda, cin, cout, k, stride, dil, pad, h, w):
    from pvnet_tpu_torch.ops import quant_conv as Q
    g = torch.Generator(cuda).manual_seed(cin + cout + h)
    q = torch.randint(-127, 128, (2, cin, h, w), generator=g, device=cuda,
                      dtype=torch.int8)
    w_q = torch.randint(-127, 128, (cout, cin, k, k), generator=g,
                        device=cuda, dtype=torch.int8)
    before = Q.conv_int8_acc.launches
    got = Q.conv_int8_acc(q, w_q, stride, pad, dil)
    want = Q.conv_int8_acc_plain(q, w_q, stride, pad, dil)
    torch.cuda.synchronize()
    assert Q.conv_int8_acc.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_int8_conv_on_the_card_equals_the_cpu(cuda):
    from pvnet_tpu_torch.ops import quant_conv as Q
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 64, 30, 40, generator=g)
    x[1] *= 50.0
    w = torch.randn(128, 64, 3, 3, generator=g) * 0.1
    got = Q.conv2d_int8(x.to(cuda), w.to(cuda), 1, 2, 2)
    assert torch.equal(got.cpu(), Q.conv2d_int8(x, w, 1, 2, 2))


def test_int8_route_rejects_what_int_mm_cannot_take(cuda):
    from pvnet_tpu_torch.ops import quant_conv as Q
    q = torch.zeros(2, 3, 16, 16, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):     # K = 27
        Q.conv_int8_acc(q, torch.zeros(8, 3, 3, 3, dtype=torch.int8,
                                       device=cuda), 1, 1)
    q = torch.zeros(1, 8, 4, 4, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="16 rows"):            # M = 16
        Q.conv_int8_acc(q, torch.zeros(8, 8, 1, 1, dtype=torch.int8,
                                       device=cuda))
    with pytest.raises(TypeError):
        Q.conv_int8_acc(q.float(), torch.zeros(8, 8, 1, 1, device=cuda))


# ---------------------------------------------------------------------------
# The registered operators (torch.ops.pvnet_torch.*), as an exported
# program calls them
# ---------------------------------------------------------------------------

def _op_cases(dev):
    """(operator, arguments) for each of K1-K3's operators at a small
    shape, the tensors on ``dev``."""
    g = torch.Generator().manual_seed(9)
    score = (torch.rand(2, 16, 32, generator=g)
             + 2.0 * (torch.rand(2, 16, 32, generator=g) < 0.3))
    fg = _sample("cpu", 2, 200, 3, 9)
    hyps = torch.empty(2, 130, 3, 2).uniform_(-20, 120, generator=g)
    ctr = V._centroid(fg.coords, fg.valid)
    t2, eps2 = V._bf16_floats(0.99)
    ops = torch.ops.pvnet_torch
    cases = [
        (ops.select_cmajor, (score, torch.randn(2, 5, 16, 32, generator=g),
                             4, 8)),
        (ops.select_nhwc, (score, torch.randn(2, 16, 32, 7, generator=g),
                           4, 8)),
        (ops.select_nhwc, (score, torch.randn(2, 16, 32, 7, generator=g)
                           .bfloat16(), 4, 8)),
        (ops.count_inliers, (fg.coords, fg.dirs, fg.valid, hyps, 0.99)),
        (ops.count_inliers_bf16, (fg.coords, fg.dirs, fg.valid, hyps, ctr,
                                  t2, eps2)),
    ]
    return [(op, tuple(a.to(dev) if torch.is_tensor(a) else a
                       for a in args)) for op, args in cases]


@pytest.mark.parametrize("case", range(5))
def test_registered_operator_cuda_equals_plain(cuda, case):
    op, args = _op_cases(cuda)[case]
    _, cpu_args = _op_cases("cpu")[case]
    counters = {"select_cmajor": SK.stratified_select_cmajor,
                "select_nhwc": SK.stratified_select,
                "count_inliers": V.count_inliers,
                "count_inliers_bf16": V.count_inliers_bf16}
    counter = counters[op._qualified_op_name.split("::")[1]]
    before = counter.launches
    got = op(*args)
    want = op(*cpu_args)                    # the CPU implementation: plain
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for x, y in zip(got, want):
        assert x.is_cuda and x.dtype == y.dtype and torch.equal(x.cpu(), y)


@pytest.mark.parametrize("case", range(5))
def test_registered_operator_fake_shapes(cuda, case):
    from torch._subclasses.fake_tensor import FakeTensorMode
    op, args = _op_cases(cuda)[case]
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_args = tuple(mode.from_tensor(a) if torch.is_tensor(a) else a
                          for a in args)
        fake = op(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.device) == (r.shape, r.dtype, r.device)


# --- the voting variants' shapes and paths ------------------------------------

@pytest.mark.parametrize("b,tn,vn,hn", [(2, 1024, 9, 4096), (4, 4096, 1, 512),
                                        (1, 4096, 1, 4096)])
def test_count_kernel_at_the_variants_shapes(cuda, b, tn, vn, hn):
    """K3 at estimate_voting_distribution's hn=4096 and at center voting's
    vn=1, tn=4096 (hn=512 by default)."""
    fg = _sample(cuda, b, tn, vn, seed=hn + tn)
    g = torch.Generator().manual_seed(tn)
    hyps = (torch.rand(b, hn, vn, 2, generator=g) * 140 - 20).to(cuda)
    before = V.count_inliers.launches
    got = V.count_inliers(fg, hyps, 0.99)
    want = V.count_inliers_plain(fg, hyps, 0.99)
    torch.cuda.synchronize()
    assert V.count_inliers.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,c", [(2, 480, 2), (1, 512, 18), (3, 100, 2)])
def test_select_kernel_at_tn4096(cuda, b, h, c):
    """K1 at tn=4096 (a=bb=64) through sample_foreground: rows padded to a
    multiple of 64 (480 -> 512), the phase grid 64x64."""
    g = torch.Generator().manual_seed(h)
    mask = (torch.rand(b, h, 640, generator=g) < 0.4).to(torch.uint8)
    field = torch.randn(b, c, h, 640, generator=g)
    noise = torch.rand(b, h, 640, generator=g)
    before = SK.stratified_select_cmajor.launches
    got = V.sample_foreground(mask.to(cuda), field.to(cuda), 4096,
                              noise=noise.to(cuda))
    want = V.sample_foreground(mask, field, 4096, noise=noise)
    torch.cuda.synchronize()
    assert SK.stratified_select_cmajor.launches == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("layout", ["cmajor", "nhwc"])
def test_topk_selection_on_cuda_equals_cpu_on_ties(cuda, layout):
    """Top-k selection on a tie-heavy noise map (4 distinct values): the
    stable sort puts the lower index first on the card as on the CPU."""
    g = torch.Generator().manual_seed(1)
    b, h, w, vn = 2, 120, 160, 3
    mask = (torch.rand(b, h, w, generator=g) < 0.3).to(torch.uint8)
    noise = torch.randint(0, 4, (b, h * w), generator=g).float() * 2 ** -23
    field = torch.randn(b, 2 * vn, h, w, generator=g)
    if layout == "nhwc":
        field = field.permute(0, 2, 3, 1).reshape(b, h, w, vn, 2)
    got = V.sample_foreground(mask.to(cuda), field.to(cuda), 1000,
                              noise=noise.to(cuda), method="topk")
    want = V.sample_foreground(mask, field, 1000, noise=noise,
                               method="topk")
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("refine_iter_num,method", [
    (None, "stratified"), (2, "stratified"), (None, "topk")])
def test_multiclass_voting_on_cuda_equals_cpu(cuda, refine_iter_num,
                                              method):
    """ransac_voting_multiclass on the card against the CPU with the same
    per-class draws: K1 (stratified) and K3 once per class; keypoints
    within 1e-2 px (the refits sum in another order)."""
    from pvnet_tpu_torch.data.vertex import compute_vertex_targets_multiclass
    g = torch.Generator().manual_seed(2)
    b, h, w, C, vn, hn = 2, 96, 128, 3, 9, 256
    mask = torch.zeros(b, h, w, dtype=torch.uint8)
    for c in range(C):
        mask[:, 10:40, 10 + 38 * c:40 + 38 * c] = c + 1
    hc = torch.cat([torch.rand(b, C, vn, 2, generator=g) * 100,
                    torch.ones(b, C, vn, 1)], -1)
    field = compute_vertex_targets_multiclass(mask, hc)
    shape = (C, b, h, w) if method == "stratified" else (C, b, h * w)
    noise = torch.rand(shape, generator=g)
    pair = torch.rand(C, b, hn, 2, generator=g)
    before = (SK.stratified_select_cmajor.launches, V.count_inliers.launches)
    got = V.ransac_voting_multiclass(
        mask.to(cuda), field.to(cuda), C + 1, hyp_num=hn, max_num=512,
        refine_iter_num=refine_iter_num, noise=noise.to(cuda),
        pair_u=pair.to(cuda), select_method=method)
    want = V.ransac_voting_multiclass(
        mask, field, C + 1, hyp_num=hn, max_num=512,
        refine_iter_num=refine_iter_num, noise=noise, pair_u=pair,
        select_method=method)
    torch.cuda.synchronize()
    k1 = C if method == "stratified" else 0
    assert (SK.stratified_select_cmajor.launches - before[0],
            V.count_inliers.launches - before[1]) == (k1, C)
    assert got.shape == (b, C, vn, 2)
    assert float((got.cpu() - want).abs().max()) < 1e-2
    assert float((want - hc[..., :2]).abs().max()) < 0.1


# --- the model family (ResNet34 / ResNet50 backbones, ImageNet init) ---------

def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _seeded(network, seed=0):
    from pvnet_tpu_torch.models.pvnet import build_model
    from pvnet_tpu_torch.models.resnet import init_weights
    model = build_model(network, ver_dim=18)
    return init_weights(model, torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("network", ["resnet34_8s", "resnet50_8s",
                                     "resnet50_8s_2o"])
def test_family_forward_on_cuda_equals_cpu(cuda, network):
    """The deeper backbones' forward in float32 (TF32 off) at 64x64, b=2,
    card against CPU within tests/test_torch_model.py's tolerance."""
    _no_tf32()
    model = _seeded(network).eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("arch", ["resnet18", "resnet34", "resnet50"])
def test_load_imagenet_backbone_onto_a_cuda_model(cuda, arch):
    """The synthesized checkpoint's tensors land on the card unchanged;
    the heads keep their values."""
    from pvnet_tpu_torch.utils.torchvision_manifest import \
        synthesize_state_dict
    from pvnet_tpu_torch.utils.weights import load_imagenet_backbone
    sd = synthesize_state_dict(arch, seed=2)
    model = _seeded(f"{arch}_8s").to(cuda)
    heads = {k: v.clone() for k, v in model.state_dict().items()
             if not k.startswith(f"{arch}_8s.") or ".fc." in k}
    load_imagenet_backbone(model, sd, arch=arch)
    own = model.backbone.state_dict()
    for k, v in sd.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        assert own[k].is_cuda and torch.equal(own[k].cpu(),
                                              torch.from_numpy(v)), k
    after = model.state_dict()
    for k, v in heads.items():
        assert torch.equal(after[k], v), k


def test_resnet50_train_step_on_cuda_equals_cpu(cuda):
    """One resnet50_8s train step at 64x64, b=2, card against CPU. The
    loss within phase (f)'s rtol 1e-3. The gradients: at this random init
    a float32 gradient lies ~2 % from the float64 one on any device
    (tests/test_torch_model_family.py), more than phase (f)'s bounds,
    which hold a well-conditioned step from the duck checkpoint. So the
    step runs in float64 on both sides, every gradient within 1e-6 of its
    norm, and the card's float32 gradient must lie no farther from the
    float64 one than 4x the CPU's float32 gradient does."""
    from pvnet_tpu_torch.train import trainer as TT
    _no_tf32()
    g = torch.Generator().manual_seed(3)
    b, h, w = 2, 64, 64
    yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    batch = {"image": torch.randn(b, 3, h, w, generator=g),
             "mask": torch.stack([((yy - 30 - 4 * i) ** 2 + (xx - 34) ** 2
                                   < 300).int() for i in range(b)]),
             "hcoords": torch.cat([torch.rand(b, 9, 2, generator=g) * w,
                                   torch.ones(b, 9, 1)], -1)}
    base = _seeded("resnet50_8s", seed=4)

    def step(where, dtype):
        model = _seeded("resnet50_8s", seed=4).to(where, dtype)
        model.load_state_dict(base.state_dict())
        model.train()
        loss, _ = TT.batch_loss(model, {
            k: (v.to(where, dtype) if v.is_floating_point() else v.to(where))
            for k, v in batch.items()}, 1.0, False, False)
        loss.backward()
        return float(loss.detach()), {n: p.grad.double().cpu()
                             for n, p in model.named_parameters()}

    def dist(a, ref):
        return float(sum(((a[n] - ref[n]) ** 2).sum() for n in ref) ** 0.5
                     / sum((r ** 2).sum() for r in ref.values()) ** 0.5)
    l64c, g64c = step("cpu", torch.float64)
    l64g, g64g = step(cuda, torch.float64)
    assert abs(l64g - l64c) <= 1e-9 * abs(l64c)
    for n in g64c:
        assert float((g64g[n] - g64c[n]).norm() / g64c[n].norm()) < 1e-6, n
    l32c, g32c = step("cpu", torch.float32)
    l32g, g32g = step(cuda, torch.float32)
    assert abs(l32g - l32c) <= 1e-3 * abs(l32c)
    assert dist(g32g, g64c) <= 4 * dist(g32c, g64c)


# -- the JPEG decoder's pixel kernel (csrc/jpeg_decode.cu) --------------------

_JPEG_GEOMETRIES = [(37, 53, (1, 1, 1), (1, 1, 1)),
                    (37, 53, (2, 1, 1), (1, 1, 1)),
                    (37, 53, (2, 1, 1), (2, 1, 1)),
                    (17, 3, (2, 1, 1), (2, 1, 1)),
                    (9, 2, (2, 1, 1), (1, 1, 1)),
                    (1, 1, (2, 1, 1), (2, 1, 1)),
                    (61, 83, (1,), (1,)),
                    (40, 72, (2, 2, 2), (1, 1, 1)),
                    (65, 130, (2, 1, 1), (2, 1, 1)),
                    (480, 640, (2, 1, 1), (2, 1, 1)),
                    (481, 647, (2, 1, 1), (2, 1, 1)),
                    (480, 640, (2, 1, 1), (1, 1, 1)),
                    (480, 640, (1, 1, 1), (1, 1, 1)),
                    (480, 640, (1,), (1,)),
                    (32, 32, (2, 2, 2), (2, 2, 2)),
                    (33, 47, (2, 1, 2), (2, 1, 2)),
                    (24, 2100, (2, 1, 1), (2, 1, 1)),
                    (17, 2100, (2, 1, 1), (1, 1, 1))]
_MINI = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "linemod_mini")


def _coefficients(geo, b, extreme, seed):
    g = torch.Generator().manual_seed(seed)
    n = geo.total_blocks()
    if extreme:
        coef = torch.randint(-32768, 32768, (b, n, 64), generator=g)
        qt = torch.randint(1, 65536, (b, geo.nc, 64), generator=g)
    else:
        coef = (torch.randn(b, n, 64, generator=g)
                * torch.linspace(300, 5, 64)).round()
        coef[..., 0] = torch.randint(-1024, 1024, (b, n), generator=g)
        qt = torch.randint(1, 100, (b, geo.nc, 64), generator=g)
    return coef.to(torch.int16), qt.to(torch.int32)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("h,w,hs,vs", _JPEG_GEOMETRIES)
def test_jpeg_pixels_matches_plain(cuda, h, w, hs, vs, extreme):
    """Every sampling the kernel takes, tiles cut by the image's edge
    (481x647: the tile divides neither side), planes 1 and 2 samples wide
    (libjpeg's box upsampling), tiles 16 MCUs wide (2100 wide), b=3; with
    extreme coefficients and 16-bit tables the dequantizing wrap and
    both saturations. Exact."""
    from pvnet_tpu_torch.data import image_io as IO
    geo = IO.JpegGeometry(h, w, hs, vs)
    coef, qt = _coefficients(geo, 3, extreme, h * w)
    want = IO.jpeg_pixels_plain(coef, qt, geo)
    before = IO.jpeg_pixels.launches
    got = IO.jpeg_pixels(coef.to(cuda), qt.to(cuda), geo)
    torch.cuda.synchronize()
    assert IO.jpeg_pixels.launches == before + 1
    assert torch.equal(got.cpu(), want)
    out = torch.full((3, h, w, 3), 7, dtype=torch.uint8, device=cuda)
    IO.jpeg_pixels(coef.to(cuda), qt.to(cuda), geo, out=out)
    assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("b", [1, 24])
def test_jpeg_pixels_batch_sizes(cuda, b):
    """480x640 4:2:0 at the serving route's one frame and the 24-frame
    batch of the dataset reads, exact."""
    from pvnet_tpu_torch.data import image_io as IO
    geo = IO.JpegGeometry(480, 640, (2, 1, 1), (2, 1, 1))
    coef, qt = _coefficients(geo, b, False, b)
    got = IO.jpeg_pixels(coef.to(cuda), qt.to(cuda), geo)
    assert torch.equal(got.cpu(), IO.jpeg_pixels_plain(coef, qt, geo))


@pytest.mark.parametrize("h,w,hs,vs", [(37, 53, (2, 1, 1), (2, 1, 1)),
                                       (61, 83, (1,), (1,)),
                                       (480, 640, (2, 1, 1), (2, 1, 1))])
def test_jpeg_pixels_into_a_slice_at_an_offset(cuda, h, w, hs, vs):
    """``out=`` a slice of a larger tensor, at batch offsets and at odd
    byte offsets (the 16-byte stores' head and tail), and coefficients and
    tables at addresses off 16 bytes: the bytes around the slice stay as
    they were."""
    from pvnet_tpu_torch.data import image_io as IO
    geo = IO.JpegGeometry(h, w, hs, vs)
    coef, qt = _coefficients(geo, 3, True, 5)
    want = IO.jpeg_pixels_plain(coef, qt, geo)
    big = torch.full((5, h, w, 3), 7, dtype=torch.uint8, device=cuda)
    IO.jpeg_pixels(coef.to(cuda), qt.to(cuda), geo, out=big[1:4])
    assert torch.equal(big[1:4].cpu(), want)
    assert (big[0] == 7).all() and (big[4] == 7).all()
    n = want.numel()
    for off in (1, 5, 13):
        flat = torch.full((n + 32,), 7, dtype=torch.uint8, device=cuda)
        c = torch.zeros(coef.numel() + 8, dtype=torch.int16, device=cuda)
        c = c[off % 8:off % 8 + coef.numel()].view(coef.shape)
        c.copy_(coef)
        q = torch.zeros(qt.numel() + 4, dtype=torch.int32, device=cuda)
        q = q[off % 4:off % 4 + qt.numel()].view(qt.shape)
        q.copy_(qt)
        IO.jpeg_pixels(c, q, geo, out=flat[off:off + n].view(want.shape))
        assert torch.equal(flat[off:off + n].view(want.shape).cpu(), want)
        assert (flat[:off] == 7).all() and (flat[off + n:] == 7).all()


def test_jpeg_pixels_refuses(cuda):
    """What the kernel does not take raises: a sampling outside 4:4:4,
    4:2:2 and 4:2:0 (component 0 not the largest; a 1x2 ratio), a batch
    past the grid's 65535, int32 coefficients, an ``out`` on the CPU."""
    from pvnet_tpu_torch.data import image_io as IO
    for hs, vs in (((1, 2, 1), (1, 1, 1)), ((2, 2, 1), (2, 1, 2))):
        geo = IO.JpegGeometry(32, 32, hs, vs)
        coef, qt = _coefficients(geo, 1, False, 0)
        with pytest.raises(IO.ImageDecodeError, match="sampling|largest"):
            IO.jpeg_pixels(coef.to(cuda), qt.to(cuda), geo)
    geo = IO.JpegGeometry(8, 8, (1,), (1,))
    coef = torch.zeros((IO.MAX_BATCH + 1, 1, 64), dtype=torch.int16,
                       device=cuda)
    qt = torch.ones((IO.MAX_BATCH + 1, 1, 64), dtype=torch.int32,
                    device=cuda)
    with pytest.raises(IO.ImageDecodeError, match="at most 65535"):
        IO.jpeg_pixels(coef, qt, geo)
    geo = IO.JpegGeometry(16, 16, (1, 1, 1), (1, 1, 1))
    coef, qt = _coefficients(geo, 1, False, 0)
    with pytest.raises(TypeError):
        IO.jpeg_pixels(coef.int().to(cuda), qt.to(cuda), geo)
    with pytest.raises(ValueError, match="out must be"):
        IO.jpeg_pixels(coef.to(cuda), qt.to(cuda), geo,
                       out=torch.empty((1, 16, 16, 3), dtype=torch.uint8))


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(_MINI,
                                                                "cases"))))
def test_jpeg_cases_decode_as_the_plain_decoder(cuda, name):
    """assets/linemod_mini/cases (4:4:4, 4:2:2, 4:2:0 at odd sizes, gray,
    restart markers, files cut mid-scan): the C entropy decoder gives the
    plain Python one's coefficients and tables, and the card's decode the
    CPU's pixels."""
    from pvnet_tpu_torch.data import image_io as IO
    path = os.path.join(_MINI, "cases", name)
    data = open(path, "rb").read()
    a = IO.jpeg_coefficients_plain(data, path)
    b = IO.jpeg_coefficients_native(data, path)
    assert a.geometry == b.geometry
    np.testing.assert_array_equal(a.coef, b.coef)
    np.testing.assert_array_equal(a.qt, b.qt)
    assert torch.equal(IO.read_rgb(path, cuda).cpu(), IO.read_rgb(path))


def test_png_unfilter_matches_plain(cuda):
    """The C unfilter against the plain one on rows filtered with every
    filter type (tests/_png_rows.py) and on the tree's masks and
    Occlusion frames (PIL picks a filter per row)."""
    from _png_rows import filtered_stream
    from pvnet_tpu_torch.data import image_io as IO
    for bpp in (1, 3, 4):
        rows = np.random.RandomState(bpp).randint(
            0, 256, (10, 6 * bpp + 1), np.int64).astype(np.uint8)
        raw = filtered_stream(rows, bpp)
        np.testing.assert_array_equal(
            IO.png_unfilter_native(raw, 10, rows.shape[1], bpp), rows)
    paths = [os.path.join(d, f) for d, _, fs in os.walk(_MINI) for f in fs
             if f.endswith(".png")]
    assert len(paths) >= 30
    for p in paths:
        data = open(p, "rb").read()
        np.testing.assert_array_equal(
            IO.decode_png(data, p, native=True).samples,
            IO.decode_png(data, p, native=False).samples, err_msg=p)


def test_png_unfilter_two_byte_samples(cuda, tmp_path):
    """16-bit gray PNGs (the render set's depth maps): the C unfilter on
    2-byte samples equals the plain one, and read_mask on the card the
    CPU's."""
    from _png_rows import filtered_stream
    from pvnet_tpu_torch.data import image_io as IO
    rows = np.random.RandomState(2).randint(0, 256, (10, 2 * 37)).astype(
        np.uint8)
    raw = filtered_stream(rows, 2)
    np.testing.assert_array_equal(
        IO.png_unfilter_native(raw, 10, rows.shape[1], 2), rows)
    d16 = np.random.RandomState(3).randint(0, 65536, (31, 47)).astype(
        np.uint16)
    p = str(tmp_path / "0_depth.png")
    IO.write_png(p, d16)
    np.testing.assert_array_equal(IO.read_mask(p, cuda), d16)
    np.testing.assert_array_equal(IO.read_mask(p, cuda), IO.read_mask(p))


@pytest.mark.parametrize("h,w", [(1, 1), (17, 3), (37, 53), (33, 31),
                                 (2, 2), (480, 640)])
def test_jpeg_encoder_c_equals_plain(cuda, h, w):
    """The C encoder (csrc/jpeg_encode.cu, taken for a CUDA device) writes
    the plain numpy encoder's bytes, on noise and on a checkerboard (the
    largest coefficients)."""
    from pvnet_tpu_torch.data import image_io as IO
    noise = np.random.RandomState(h * w).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    checker = ((np.indices((h, w)).sum(0) % 2) * 255).astype(np.uint8)
    checker = np.repeat(checker[..., None], 3, -1)
    for a in (noise, checker):
        got = IO.encode_jpeg(a, cuda)
        assert got == IO.jpeg_encode_plain(a)
        assert torch.equal(IO.decode_rgb_bytes(got, device=cuda).cpu(),
                           IO.decode_rgb_bytes(got))


def test_synthetic_tree_on_the_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """write_synthetic_linemod with the card's encoder writes the files the
    CPU's plain encoder writes."""
    from pvnet_tpu_torch.data import synthetic as TS
    K = TS.LINEMOD_K.copy()
    K[:2] /= 4
    monkeypatch.setattr(TS, "LINEMOD_K", K)
    roots = {}
    for dev in (cuda, "cpu"):
        roots[str(dev)] = str(tmp_path / str(dev).replace(":", "_"))
        TS.write_synthetic_linemod(roots[str(dev)], "duck", num_images=4,
                                   image_hw=(120, 160), occluder_prob=0.5,
                                   max_clutter=2, device=dev)
    a, b = roots.values()
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert len(files) == 4 * 4 + 6
    for f in files:
        assert open(os.path.join(a, f), "rb").read() == \
            open(os.path.join(b, f), "rb").read(), f


def test_pnp_host_syncs_are_counted(cuda):
    """pipeline.poses_from_keypoints (pnp_batch inside the ``pnp`` span)
    on the card, recorded under the sync debug mode "error": no host
    synchronization anywhere in it (the EPnP and LM kernels take every
    input where it lies and allocate nothing), so every span's
    ``host_syncs`` is 0; the same poses on every call; and the sync debug
    mode off again afterwards."""
    import warnings

    from pvnet_tpu_torch import pipeline as PL
    from pvnet_tpu_torch.utils import profiling as TP
    g = torch.Generator().manual_seed(0)
    pts = (torch.randn(9, 3, generator=g) * 0.05).to(cuda)
    K = torch.tensor([[572.4, 0.0, 325.3], [0.0, 573.6, 242.0],
                      [0.0, 0.0, 1.0]]).to(cuda)
    kps = (torch.rand(16, 9, 2, generator=g) * 400 + 100).to(cuda)
    want = PL.poses_from_keypoints(pts, kps, K)
    TP.RECORDER.drain()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with warnings.catch_warnings(record=True) as shown:
            warnings.simplefilter("always")
            with TP.recording():
                got = [PL.poses_from_keypoints(pts, kps, K)
                       for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert not shown, [str(w.message) for w in shown]
    assert torch.cuda.get_sync_debug_mode() == 0
    for pose in got:
        assert torch.equal(pose, want)
    spans = TP.RECORDER.drain()
    assert [s["name"] for s in spans] == ["pnp", "pnp.epnp", "pnp.lm"] * 2
    syncs = [{s["name"]: s["counters"].get("host_syncs", 0)
              for s in spans[k:k + 3]} for k in (0, 3)]
    print("host_syncs by span:", syncs)
    assert syncs[0] == syncs[1] == {"pnp": 0, "pnp.epnp": 0, "pnp.lm": 0}


# --- PnP: the EPnP and LM kernels (csrc/pnp.cu) against the plain functions

_LINEMOD_K = [[572.4114, 0.0, 325.2611], [0.0, 573.57043, 242.04899],
              [0.0, 0.0, 1.0]]


def pnp_problems(N, seed, kind="spread"):
    """N seeded PnP problems of one object's 9 keypoints on the CPU:
    (pts3d [9, 3], kps [N, 9, 2], K [3, 3], Ks [N, 3, 3]), the keypoints
    projected by random poses (rotations up to 0.9 pi, depth 0.4-1.2 m)
    with Ks and moved by Gaussian noise of 0.5 px. ``kind`` "spread":
    points in a 16 cm cube; "near_planar": a 10 cm square 1 mm thick. Ks:
    K with each image's focal lengths and principal point moved by up to
    5 % (solved with the shared K, the keypoints carry that error too)."""
    from pvnet_tpu_torch.ops.geometry import project, rodrigues
    rng = np.random.RandomState(seed)
    n = 9
    if kind == "near_planar":
        pts = np.c_[rng.uniform(-0.05, 0.05, (n, 2)), rng.randn(n) * 1e-3]
    else:
        pts = rng.uniform(-0.08, 0.08, (n, 3))
    w = rng.randn(N, 3)
    w *= rng.uniform(0, 0.9 * np.pi, (N, 1)) / np.linalg.norm(w, axis=1,
                                                            keepdims=True)
    t = np.c_[rng.uniform(-0.1, 0.1, (N, 2)), rng.uniform(0.4, 1.2, (N, 1))]
    pose = torch.cat([rodrigues(torch.tensor(w, dtype=torch.float32)),
                      torch.tensor(t, dtype=torch.float32)[..., None]], -1)
    pts = torch.tensor(pts, dtype=torch.float32)
    K = torch.tensor(_LINEMOD_K)
    Ks = K.repeat(N, 1, 1)
    Ks[:, :2] *= torch.tensor(rng.uniform(0.95, 1.05, (N, 2, 1)),
                              dtype=torch.float32)
    kps = project(pts.expand(N, n, 3), pose, Ks) + torch.tensor(
        rng.randn(N, n, 2) * 0.5, dtype=torch.float32)
    return pts, kps, K, Ks


def reprojection_gap(a, b, pts, K):
    """Per problem, the mean distance (px) between the keypoints projected
    by poses a and by poses b [N, 3, 4]."""
    from pvnet_tpu_torch.ops.geometry import project
    pts = pts.expand(a.shape[0], *pts.shape[-2:])
    return (project(pts, a, K) - project(pts, b, K)).norm(dim=-1).mean(-1)


def plain_pnp(pts, kps, K, weights=None, w3=None):
    """The plain functions' PnP (EPnP, then the 4-start LM) on any
    device: pnp_batch's without weights, uncertainty_pnp's with them."""
    from pvnet_tpu_torch.ops import pnp as P
    pts = pts.expand(kps.shape[0], *pts.shape)
    pose0 = P.epnp_plain(pts, kps, K, weights)
    return P.lm_multi_start_plain(pose0, pts, kps, K,
                                  P.identity_w3(pts) if w3 is None else w3,
                                  16)


def held(gap, gap_cpu, trim):
    """The kernels' poses against the plain functions': gap and gap_cpu
    (px) from the plain functions on the card and on the CPU. The median
    gap at most 1e-3; and each problem within 0.02 of one of the two plain
    results (the same arithmetic compiled for the host reads 2e-3 to 6e-3
    at most: LM iterates that stop at slightly different points of a flat
    valley; where cuSOLVER's eigenvectors lead the plain EPnP on the card
    to another start than LAPACK's on the CPU, the two plain results part
    by up to ~0.5 px, and the kernel sides with one); or, with ``trim``
    (near-planar sets, whose flip ambiguity 16 LM iterations do not always
    settle, so that the plain version itself moves past 1e-2 px on ~1 % of
    problems when its keypoints move by 1e-7 relative), the mean gap of
    all but the worst 1 % at most 0.1 (0.008-0.023 for the host build)."""
    med = float(gap.median())
    if not trim:
        worst = float(torch.minimum(gap, gap_cpu).max())
        return med <= 1e-3 and worst <= 0.02, (med, worst)
    gap = gap.sort().values
    kept = float(gap[:len(gap) - len(gap) // 100].mean())
    return med <= 1e-3 and kept <= 0.1, (med, kept)


@pytest.mark.parametrize("kind,per_image,N", [("spread", False, 1024),
                                              ("spread", True, 1024),
                                              ("near_planar", False, 256)])
def test_pnp_kernels_against_the_plain_functions(cuda, kind, per_image, N):
    from pvnet_tpu_torch.ops import pnp as P
    pts, kps, K, Ks = pnp_problems(N, 22 + N + per_image, kind)
    K = Ks if per_image else K
    pts, kps, K = pts.to(cuda), kps.to(cuda), K.to(cuda)
    before = P.epnp.launches + P.lm_multi_start.launches
    got = P.pnp_batch(pts, kps, K)
    again = P.pnp_batch(pts, kps, K)
    torch.cuda.synchronize()
    assert P.epnp.launches + P.lm_multi_start.launches == before + 4
    assert torch.equal(got, again)                 # deterministic
    want = plain_pnp(pts, kps, K)
    want_cpu = plain_pnp(pts.cpu(), kps.cpu(), K.cpu()).to(cuda)
    ok, stats = held(reprojection_gap(got, want, pts, K),
                     reprojection_gap(got, want_cpu, pts, K),
                     trim=kind == "near_planar")
    print(kind, per_image, "median, max / trimmed mean px:", stats)
    assert ok, stats
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("weighted", [False, True])
def test_lm_kernel_against_the_plain_lm(cuda, weighted):
    """The LM kernel alone from the plain EPnP's poses: the plain LM's
    arithmetic up to the order of sums."""
    from pvnet_tpu_torch.ops import pnp as P
    pts, kps, K, _ = pnp_problems(1024, 5, "spread")
    pts = pts.expand(1024, 9, 3).to(cuda)
    kps, K = kps.to(cuda), K.to(cuda)
    g = torch.Generator().manual_seed(1)
    w3 = None
    if weighted:
        w3 = torch.stack([torch.rand(1024, 9, generator=g) + 0.5,
                          torch.rand(1024, 9, generator=g) * 0.4 - 0.2,
                          torch.rand(1024, 9, generator=g) + 0.5],
                         -1).to(cuda)
        w3[:, 3] = 0.0
    pose0 = P.epnp_plain(pts, kps, K)
    got = P.lm_multi_start(pose0, pts, kps, K, w3, 16)
    want = P.lm_multi_start_plain(pose0, pts, kps, K,
                                  P.identity_w3(pts) if w3 is None else w3,
                                  16)
    gap = reprojection_gap(got, want, pts, K)
    print("LM kernel vs plain LM, median / max px:", float(gap.median()),
          float(gap.max()))
    assert float(gap.median()) <= 1e-4


@pytest.mark.parametrize("version", [1, 2])
def test_uncertainty_pnp_kernels_against_the_plain_functions(cuda, version):
    """uncertainty_pnp_batch (2x2 weight rows) and uncertainty_pnp_v2_batch
    (covariances) through the kernels, one keypoint of each problem given
    zero weight (a degenerate covariance), against the plain functions on
    the same weights."""
    from pvnet_tpu_torch.ops import pnp as P
    from pvnet_tpu_torch.ops.geometry import inv_sqrtm_2x2
    pts, kps, K, _ = pnp_problems(1024, 9, "spread")
    g = torch.Generator().manual_seed(2)
    M = torch.randn(1024, 9, 2, 2, generator=g)
    cov = M @ M.transpose(-1, -2) + 0.1 * torch.eye(2)
    cov[:, 4] = 0.0
    pts, kps, K, cov = pts.to(cuda), kps.to(cuda), K.to(cuda), cov.to(cuda)
    before = P.epnp.launches + P.lm_multi_start.launches
    if version == 1:
        W = inv_sqrtm_2x2(cov)
        w3 = torch.stack([W[..., 0, 0], W[..., 0, 1], W[..., 1, 1]], -1)
        w3[:, 4] = 0.0
        got = P.uncertainty_pnp_batch(kps, w3, pts, K)
        weights = w3[..., 0] + w3[..., 2]
    else:
        got = P.uncertainty_pnp_v2_batch(kps, cov, pts, K)
        weights, w3 = P.covariance_weights(cov)
    torch.cuda.synchronize()
    assert P.epnp.launches + P.lm_multi_start.launches == before + 2
    want = plain_pnp(pts, kps, K, weights, w3)
    want_cpu = plain_pnp(pts.cpu(), kps.cpu(), K.cpu(), weights.cpu(),
                         w3.cpu()).to(cuda)
    ok, stats = held(reprojection_gap(got, want, pts, K),
                     reprojection_gap(got, want_cpu, pts, K), trim=False)
    print(f"uncertainty v{version} median, max px:", stats)
    assert ok, stats


def test_pnp_kernels_take_every_caller_and_refuse_what_they_cannot(cuda):
    from pvnet_tpu_torch import pipeline as PL
    from pvnet_tpu_torch.ops import pnp as P
    pts, kps, K, Ks = pnp_problems(6, 3, "spread")
    # multiclass: b * C problems with each class's keypoints, K shared and
    # per image
    pts_c = torch.stack([pts, pts.flip(0)])                 # [C=2, 9, 3]
    kps_c = torch.stack([kps, kps], 1)                      # [6, 2, 9, 2]
    for KK in (K, Ks):
        before = P.epnp.launches + P.lm_multi_start.launches
        got = PL.multiclass_poses_from_keypoints(
            pts_c.to(cuda), kps_c.to(cuda), KK.to(cuda))
        assert P.epnp.launches + P.lm_multi_start.launches == before + 2
        want = PL.multiclass_poses_from_keypoints(pts_c, kps_c, KK)
        assert got.shape == want.shape == (6, 2, 3, 4)
        assert float(reprojection_gap(got[:, 0].cpu(), want[:, 0], pts,
                                      KK).median()) <= 1e-3
    # n = 4 (the least EPnP takes) and an empty batch
    got = P.pnp_batch(pts[:4].to(cuda), kps[:, :4].to(cuda), K.to(cuda))
    assert got.shape == (6, 3, 4) and torch.isfinite(got).all()
    assert P.pnp_batch(pts.to(cuda), kps[:0].to(cuda),
                       K.to(cuda)).shape == (0, 3, 4)
    # more points than the kernels hold; float64
    many = P.KERNEL_MAX_POINTS + 1
    with pytest.raises(ValueError, match="points a problem"):
        P.pnp_batch(torch.rand(many, 3, device=cuda),
                    torch.rand(2, many, 2, device=cuda), K.to(cuda))
    with pytest.raises(TypeError):
        P.pnp_batch(pts.double().to(cuda), kps.double().to(cuda),
                    K.double().to(cuda))
