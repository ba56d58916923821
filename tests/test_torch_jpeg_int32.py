"""The JPEG pixel kernel's 32-bit islow IDCT (csrc/jpeg_decode.cu) against
the plain version, on the CPU.

The kernel runs both passes of jpeg_idct_islow in unsigned 32-bit sums
that wrap, and descales the final sum as a signed number. The model below
repeats its arithmetic in its order, every intermediate reduced to 32 bits
as the registers hold it, and must equal ``idct_islow_plain`` (int64
throughout): on the inputs that drive each output furthest from zero, on
drawn int16 blocks with 16-bit tables, and for the one-output form the
kernel uses for halo rows and columns. tests/test_torch_image_io.py holds
``jpeg_pixels_plain`` against the JAX package's reader, which closes the
chain from this model to JAX. Also the kernel's launch plan as
``image_io.tile_blocks`` mirrors it.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pvnet_tpu_torch.data import image_io as IO

M32 = 0xFFFFFFFF


def _u32(x):
    return x & M32


def _mul(a, k):
    """a * k modulo 2^32. A negative k stands for the register's
    (0u - |k|), whose product has the same low 32 bits."""
    return _u32(a * k)


def _sext16(x):
    x = x & 0xFFFF
    return _u32(x - ((x >> 15) << 16))


def _descale(v, shift):
    v = _u32(v + (1 << (shift - 1)))
    return (v - ((v >> 31) << 32)) >> shift


def _idct_even(x0, x2, x4, x6):
    z1 = _mul(_u32(x2 + x6), 4433)
    tmp2 = _u32(z1 - _mul(x6, 15137))
    tmp3 = _u32(z1 + _mul(x2, 6270))
    tmp0 = _u32(_u32(x0 + x4) << 13)
    tmp1 = _u32(_u32(x0 - x4) << 13)
    return [_u32(tmp0 + tmp3), _u32(tmp1 + tmp2), _u32(tmp1 - tmp2),
            _u32(tmp0 - tmp3)]


def _idct_odd(x1, x3, x5, x7):
    z5 = _mul(_u32(_u32(_u32(x7 + x3) + x5) + x1), 9633)
    z1 = _mul(_u32(x7 + x1), -7373)
    z2 = _mul(_u32(x5 + x3), -20995)
    z3 = _u32(_mul(_u32(x7 + x3), -16069) + z5)
    z4 = _u32(_mul(_u32(x5 + x1), -3196) + z5)
    return [_u32(_u32(_mul(x1, 12299) + z1) + z4),
            _u32(_u32(_mul(x3, 25172) + z2) + z3),
            _u32(_u32(_mul(x5, 16819) + z2) + z4),
            _u32(_u32(_mul(x7, 2446) + z1) + z3)]


def _idct_full(x, shift):
    """The kernel's 8-point pass on x[0..7] (u32 tensors) -> 8 descaled
    outputs."""
    e = _idct_even(x[0], x[2], x[4], x[6])
    o = _idct_odd(x[1], x[3], x[5], x[7])
    out = [None] * 8
    for k in range(4):
        out[k] = _descale(_u32(e[k] + o[k]), shift)
        out[7 - k] = _descale(_u32(e[k] - o[k]), shift)
    return out


def _idct_edge(x, last, shift):
    """The kernel's idct_edge: output 7 (last) or 0 alone."""
    e = _u32(_u32(_u32(x[0] + x[4]) << 13) + _mul(_u32(x[2] + x[6]), 4433))
    e = _u32(e + _mul(x[2], 6270))
    o = _u32(_mul(x[1], 12299) + _mul(_u32(x[7] + x[1]), -7373))
    o = _u32(o + _mul(_u32(x[5] + x[1]), -3196))
    o = _u32(o + _mul(_u32(_u32(_u32(x[7] + x[3]) + x[5]) + x[1]), 9633))
    return _descale(_u32(e - o) if last else _u32(e + o), shift)


def kernel_idct(coef: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """The kernel's dequantize + two passes on int16 blocks [..., 64] and
    tables [..., 64] (natural order) -> uint8 [..., 8, 8]."""
    c = coef.to(torch.int64).reshape(coef.shape[:-1] + (8, 8)) & 0xFFFF
    q = (qt.to(torch.int64).expand(coef.shape)
         .reshape(coef.shape[:-1] + (8, 8)) & 0xFFFF)
    x = _sext16(c * q)                          # dequantized, wrapped
    cols = _idct_full([x[..., r, :] for r in range(8)], 11)
    ws = torch.stack(cols, -2).clamp(-32768, 32767)
    rows = _idct_full([_u32(ws[..., :, k]) for k in range(8)], 18)
    return (torch.stack(rows, -1).clamp(-128, 127) + 128).to(torch.uint8)


def _adversarial():
    """[16, 8] inputs: for each output k and direction, 32767 where k's
    weight has that sign and -32768 where it has the other."""
    eye = torch.eye(8, dtype=torch.int64)
    # the pass's sums before the descale, linear in the inputs: column i
    # of `w` is the sums for unit input i (descale by 1 bit of 2 * x)
    sums = [_exact_sums(eye[i]) for i in range(8)]
    w = torch.stack(sums, 1)                        # [out, in]
    pats = []
    for k in range(8):
        for sign in (1, -1):
            pats.append(torch.where(sign * w[k] > 0, 32767, -32768))
    return torch.stack(pats), w


def _exact_sums(x):
    """jpeg_idct_islow's 8 output sums on int64 inputs x[8], before the
    rounding constant and the shift (IO._idct_1d with shift 1 on 2 x,
    whose rounding constant 1 vanishes in the floor)."""
    return torch.stack(IO._idct_1d([2 * v for v in x], 1))


def test_output_sums_fit_in_31_bits():
    """Every output sum of either pass, rounding constant included, lies
    within 0.935 * 2^31 of zero for inputs in [-32768, 32767]: the
    argument that makes wrapping 32-bit sums exact."""
    pats, w = _adversarial()
    worst = 0
    for shift in (11, 18):
        sums = (pats @ w.T) + (1 << (shift - 1))        # [16, 8]
        worst = max(worst, int(sums.abs().max()))
    assert worst < 0.935 * 2 ** 31, worst / 2 ** 31


@pytest.mark.parametrize("shift", [11, 18])
def test_one_pass_on_extreme_inputs(shift):
    """The 32-bit pass, full and one-output, equals the exact int64 pass
    on the sign patterns that maximize and minimize each output."""
    pats, _ = _adversarial()
    x = [pats[:, i] for i in range(8)]
    want = IO._idct_1d(x, shift)
    got = _idct_full([_u32(v) for v in x], shift)
    for k in range(8):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(_idct_edge([_u32(v) for v in x], False, shift),
                       want[0])
    assert torch.equal(_idct_edge([_u32(v) for v in x], True, shift),
                       want[7])


def _tables_for(values):
    """int16 coefficients and 16-bit tables whose products wrap to
    ``values`` (32767 or -32768): every other entry through the wrap
    (-1 x 32769, 1 x 32768), the rest with a table entry of 1."""
    wrap = torch.arange(values.numel()).reshape(values.shape) % 2 == 1
    coef = torch.where(wrap, torch.where(values > 0, -1, 1), values)
    qt = torch.where(wrap, torch.where(values > 0, 32769, 32768), 1)
    return coef.to(torch.int16), qt.to(torch.int32)


def test_kernel_idct_on_adversarial_blocks():
    """Blocks whose dequantized columns (pass 1) or saturated rows (pass 2)
    are the extreme sign patterns, with 16-bit tables: the 32-bit model
    equals idct_islow_plain."""
    pats, _ = _adversarial()
    # pass 1: every column of the block is the pattern
    cols = pats[:, :, None].expand(16, 8, 8).reshape(16, 64)
    c1, q1 = _tables_for(cols)
    # pass 2: column j's DC alone, at pattern[j]: the column pass
    # saturates to it on every row, so every row of the intermediate is
    # the pattern
    dc = torch.zeros(16, 8, 8, dtype=torch.int64)
    dc[:, 0, :] = pats
    c2, q2 = _tables_for(dc.reshape(16, 64))
    c2 = torch.where(dc.reshape(16, 64) == 0, 0, c2).to(torch.int16)
    for coef, qt in ((c1, q1), (c2, q2)):
        assert torch.equal(kernel_idct(coef, qt),
                           IO.idct_islow_plain(coef, qt))
    ws = torch.stack(_idct_full(
        [_sext16(c2.to(torch.int64).reshape(16, 8, 8)[:, r, :]
                 * q2.reshape(16, 8, 8)[:, r, :]) for r in range(8)], 11),
        1).clamp(-32768, 32767)
    assert torch.equal(ws, pats[:, None, :].expand(16, 8, 8))


@settings(max_examples=200, deadline=None, database=None, derandomize=True)
@given(st.lists(st.integers(-32768, 32767), min_size=256, max_size=256),
       st.lists(st.integers(1, 65535), min_size=64, max_size=64))
def test_kernel_idct_on_drawn_blocks(coef, qt):
    """Four drawn int16 blocks with one drawn 16-bit table."""
    coef = torch.tensor(coef, dtype=torch.int16).reshape(4, 64)
    qt = torch.tensor(qt, dtype=torch.int32)
    assert torch.equal(kernel_idct(coef, qt), IO.idct_islow_plain(coef, qt))


def test_kernel_idct_on_random_blocks_and_edges():
    """10 000 random blocks over the full int16 and table ranges, and the
    one-output form against both passes' outputs 0 and 7."""
    rng = np.random.RandomState(17)
    coef = torch.tensor(rng.randint(-32768, 32768, (10000, 64)),
                        dtype=torch.int16)
    qt = torch.tensor(rng.randint(1, 65536, (10000, 64)), dtype=torch.int32)
    assert torch.equal(kernel_idct(coef, qt), IO.idct_islow_plain(coef, qt))
    x = [_u32(torch.tensor(rng.randint(-32768, 32768, 10000)))
         for _ in range(8)]
    for shift in (11, 18):
        full = _idct_full(x, shift)
        assert torch.equal(_idct_edge(x, False, shift), full[0])
        assert torch.equal(_idct_edge(x, True, shift), full[7])


@pytest.mark.parametrize("geo,batch,blocks", [
    ((40, 72, (2, 1, 1), (2, 1, 1)), 1, (90, 20, 48, 32)),
    ((480, 640, (2, 1, 1), (2, 1, 1)), 1, (7200, 2240, 840, 784)),
    ((480, 640, (2, 1, 1), (2, 1, 1)), 24, (7200, 1120, 840, 392)),
    ((481, 647, (2, 1, 1), (2, 1, 1)), 1, (7626, 2460, 744, 720)),
    ((480, 640, (2, 1, 1), (1, 1, 1)), 1, (9600, 0, 1680, 0)),
    ((480, 640, (1, 1, 1), (1, 1, 1)), 1, (14400, 0, 0, 0)),
    ((480, 640, (1,), (1,)), 24, (4800, 0, 0, 0)),
    ((24, 2100, (2, 1, 1), (2, 1, 1)), 1, (1584, 0, 64, 0)),
    ((3, 4, (2, 1, 1), (2, 1, 1)), 1, (6, 0, 0, 0)),
])
def test_tile_blocks(geo, batch, blocks):
    """The launch plan's blocks: besides the own ones, at 4:2:0 and 4:2:2
    only the halo blocks' edge rows and columns (no 8x8 halo block in
    full), fewer rows where a large batch makes the tiles 4 MCU rows
    tall; none at 4:4:4, gray, or where box upsampling needs no halo."""
    assert IO.tile_blocks(IO.JpegGeometry(*geo), batch) == blocks
