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

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,c,h,w,a,bb", [
    (1, 2, 16, 32, 4, 8), (2, 6, 20, 24, 4, 8), (3, 18, 48, 96, 16, 32),
    (2, 4, 64, 64, 8, 8), (1, 1, 8, 8, 8, 8)])
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


@pytest.mark.parametrize("b,tn,vn,hn,thresh", [
    (2, 100, 3, 130, 0.95), (1, 1, 1, 5, 0.99), (2, 512, 9, 512, 0.99),
    (3, 300, 2, 1, 0.9), (1, 257, 4, 129, 0.999)])
def test_count_kernel_equals_plain(cuda, b, tn, vn, hn, thresh):
    fg = _sample(cuda, b, tn, vn, tn + hn)
    hyps = torch.empty(b, hn, vn, 2, device=cuda).uniform_(-20, 120)
    before = V.count_inliers.launches
    got = V.count_inliers(fg, hyps, thresh)
    want = V.count_inliers_plain(fg, hyps, thresh)
    torch.cuda.synchronize()
    assert V.count_inliers.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


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
# threads, the packed path's own grid, a single tile per phase
@pytest.mark.parametrize("b,h,w,c,a,bb", [
    (2, 16, 32, 3, 4, 8), (3, 24, 48, 80, 8, 16), (1, 32, 64, 5, 16, 16),
    (2, 40, 96, 18, 8, 32), (1, 8, 8, 1, 8, 8), (2, 30, 40, 80, 30, 40)])
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


@pytest.mark.parametrize("dtype", _SHIFT_DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 37, 1), (3, 53, 41),
                                   (2, 480, 130), (1, 33, 257), (5, 7, 128)])
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
