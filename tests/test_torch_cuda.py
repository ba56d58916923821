"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card, at shapes the main path does not reach (ragged tiles, tiny grids,
ties, widths that are no multiple of 32 or 128, every dtype the row-shift
kernels move) — chip_smoke.py covers the main-path shapes.

Skips without a card. The GPU host has no JAX, and tests/conftest.py
imports JAX, so run this file there without the conftest:

  python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
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
