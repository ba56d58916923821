"""JPEG and PNG decoding and writing without PIL or cv2: the port's
counterparts of pvnet_tpu/data/linemod.py's ``read_rgb_np`` (:43) and
``read_mask_np`` (:56), and of the PIL saves of its data generators.

The JAX package reads frames with ``cv2.imread`` (libjpeg-turbo, libpng)
and masks with PIL. The GPU host has neither, so the port decodes itself,
reproducing libjpeg's own integer algorithms so that its output equals
``read_rgb_np`` byte for byte:

- entropy decoding of baseline and extended-sequential Huffman JPEG
  (SOF0/SOF1), 8-bit, 1 or 3 components, restart markers; a stream that
  runs out of data behaves as jdhuff.c ``decode_mcu`` once
  ``insufficient_data`` is set (the MCU in which the data ends is decoded
  on zero bits, every later block of the scan stays zero);
- dequantization and jidctint.c ``jpeg_idct_islow`` (CONST_BITS 13,
  PASS1_BITS 2) with the overflow rules of libjpeg-turbo's SIMD version
  of it, which is what cv2 runs on x86-64: the dequantized coefficient
  wraps to 16 bits, the column pass's output saturates to 16 bits and the
  output saturates to 0..255. On well-formed data that equals jidctint.c's
  range-limit table; on corrupt data (|x| >= 512 before the level shift)
  jidctint.c's RANGE_MASK wraps where the SIMD code saturates, and cv2's
  output follows the saturation (tests/test_torch_image_io.py holds
  truncated files of both kinds);
- jdsample.c ``h2v1_fancy_upsample`` / ``h2v2_fancy_upsample`` (the
  alternating +1/+2 and +8/+7 biases; first and last rows and columns
  replicated, as libjpeg's context rows do), box upsampling where a plane
  is at most 2 samples wide (libjpeg's own rule);
- jdcolor.c ``ycc_rgb_convert`` with ``build_ycc_rgb_table``'s fixed-point
  tables (SCALEBITS 16).

The work is split between host and device. On the host: marker parsing,
Huffman decoding to int16 coefficients, and PNG row unfiltering. On the
device: dequantize + IDCT + upsample + colour conversion of a batch of
images (:func:`jpeg_pixels`, the CUDA kernel of csrc/jpeg_decode.cu),
written straight into a uint8 device tensor. The host stages are C++ in
the same source, reached through ctypes (which releases the GIL, so a
thread pool decodes many files at once).

Each stage has a plain version beside it: a Python entropy decoder and
PNG unfilter (:func:`jpeg_coefficients_plain`, :func:`png_unfilter_plain`)
and a PyTorch version of the pixel stage in integer arithmetic
(:func:`jpeg_pixels_plain`). On the CPU the port uses these. On a CUDA
device the C and CUDA code always run, and a failed build or launch
raises; nothing falls back to PIL or cv2.

PNG: ``zlib`` inflates, the unfilter undoes filter types 0-4, for bit
depths 1, 2, 4 and 8 and colour types 0, 2, 3, 4 and 6, and gray (colour
type 0) at bit depth 16, big-endian, as the JAX package's renderer writes
its depth maps (not interlaced). :func:`read_rgb` returns what
``cv2.imread(p, IMREAD_COLOR)`` gives in RGB order (palette expanded,
alpha dropped, gray repeated to three channels, gray below 8 bits scaled
to 0-255, 16-bit gray shifted down by 8 bits); :func:`read_mask` what
``np.asarray(Image.open(p), np.int32)`` gives (palette indices, 0/1 for a
1-bit image, the 16-bit values of a 16-bit image, the channels of a
colour image).

Writing, for dataset preparation (the JAX package writes with PIL):
:func:`encode_jpeg` / :func:`write_jpeg` give, byte for byte, the file
``PIL.Image.fromarray(a).save(p)`` writes for a ``.jpg`` (libjpeg-turbo at
its defaults: JFIF header, quality 75 on the standard tables, 4:2:0 for
RGB with libjpeg's h2v2 downsampling, the islow forward DCT, quantization
by reciprocal, the standard Huffman tables). The plain version is numpy
(:func:`jpeg_encode_plain`); the C version is host code in
csrc/jpeg_encode.cu (:func:`jpeg_encode_native`), chosen as the decoder's
are: on a CUDA device the C code runs or the call raises, on the CPU the
plain version. :func:`encode_png` / :func:`write_png` write 8-bit gray,
8-bit RGB and 16-bit gray PNGs with stdlib ``zlib``, which PIL decodes to
the pixels given (the bytes differ from PIL's own files).
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pvnet_tpu_torch.ops import kernel_lib

# -- JPEG constants (ITU T.81; libjpeg jutils.c / jidctint.c / jdcolor.c) ----

# zigzag position -> natural (row-major) position, with libjpeg's 16 extra
# entries of 63 that absorb a run past the end of a corrupt block
NATURAL_ORDER = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
] + [63] * 16, np.int64)

_SOF_NAMES = {
    0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)",
    0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13 (arithmetic differential sequential)",
    0xCE: "SOF14 (arithmetic differential progressive)",
    0xCF: "SOF15 (arithmetic differential lossless)",
}

# jidctint.c's fixed-point constants (CONST_BITS 13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172

# jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


FIX_1_40200, FIX_1_77200 = _fix(1.40200), _fix(1.77200)
FIX_0_71414, FIX_0_34414 = _fix(0.71414), _fix(0.34414)


class ImageDecodeError(ValueError):
    """A file the decoder does not take (format, SOF type, sampling) or
    cannot parse."""


@dataclass(frozen=True)
class JpegGeometry:
    """What the pixel stage needs to know about a JPEG besides its
    coefficients: the image size and each component's sampling factors
    (a single-component image always has 1x1)."""
    height: int
    width: int
    h: Tuple[int, ...]
    v: Tuple[int, ...]

    @property
    def nc(self) -> int:
        return len(self.h)

    def blocks(self) -> List[Tuple[int, int]]:
        """(rows, columns) of 8x8 blocks of each component's plane, padded
        to whole MCUs."""
        hmax, vmax = max(self.h), max(self.v)
        mcux = -(-self.width // (8 * hmax))
        mcuy = -(-self.height // (8 * vmax))
        return [(mcuy * vc, mcux * hc) for hc, vc in zip(self.h, self.v)]

    def total_blocks(self) -> int:
        return sum(r * c for r, c in self.blocks())

    def downsampled(self) -> List[Tuple[int, int]]:
        """(height, width) of each component's real samples (libjpeg's
        downsampled_height / downsampled_width)."""
        hmax, vmax = max(self.h), max(self.v)
        return [(-(-self.height * vc // vmax), -(-self.width * hc // hmax))
                for hc, vc in zip(self.h, self.v)]


@dataclass
class JpegCoefficients:
    """One decoded scan set: ``coef`` int16 [total_blocks, 64] in natural
    order, component 0's plane first, each plane's blocks row-major;
    ``qt`` int32 [nc, 64] each component's quantization table in natural
    order."""
    geometry: JpegGeometry
    coef: np.ndarray
    qt: np.ndarray


def _u16(data: bytes, pos: int) -> int:
    return (data[pos] << 8) | data[pos + 1]


def _check_sampling(name: str, h: Sequence[int], v: Sequence[int]) -> None:
    hmax, vmax = max(h), max(v)
    if (h[0], v[0]) != (hmax, vmax):
        raise ImageDecodeError(f"{name}: the first component must have the "
                               f"largest sampling factors; got h={list(h)} "
                               f"v={list(v)}")
    for hc, vc in zip(h[1:], v[1:]):
        ratio = (hmax // hc, vmax // vc)
        if hmax % hc or vmax % vc or ratio not in ((1, 1), (2, 1), (2, 2)):
            raise ImageDecodeError(
                f"{name}: sampling h={list(h)} v={list(v)} not supported "
                "(4:4:4, 4:2:2 h2v1 and 4:2:0 h2v2 are)")


class _HuffTable:
    """A canonical Huffman table as a 16-bit lookahead: entry p of ``sym``
    and ``size`` decode the code that prefixes the 16 bits p; a prefix that
    is no code of 16 bits or fewer decodes as libjpeg's jpeg_huff_decode
    does (17 bits consumed, symbol 0)."""

    def __init__(self, counts: Sequence[int], symbols: Sequence[int]):
        sym = [0] * 65536
        size = [17] * 65536
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                if hi > 65536:
                    break
                s = symbols[k]
                sym[lo:hi] = [s] * (hi - lo)
                size[lo:hi] = [length] * (hi - lo)
                code += 1
                k += 1
            code <<= 1
        self.sym, self.size = sym, size


def _scan_segments(data: bytes, pos: int) -> Tuple[List[bytes], int, int]:
    """The entropy-coded data from ``pos``: its restart intervals with
    stuffed bytes removed, and where it ends (the marker that ends it, or
    the end of the file). Returns (segments, end position, marker or -1)."""
    segments, cur = [], bytearray()
    n = len(data)
    i = pos
    while True:
        j = data.find(b"\xff", i)
        if j < 0:
            cur += data[i:]
            segments.append(bytes(cur))
            return segments, n, -1
        cur += data[i:j]
        k = j + 1
        while k < n and data[k] == 0xFF:       # fill bytes before a marker
            k += 1
        if k >= n:
            segments.append(bytes(cur))
            return segments, n, -1
        c = data[k]
        if c == 0:
            cur.append(0xFF)
            i = k + 1
        elif 0xD0 <= c <= 0xD7:
            segments.append(bytes(cur))
            cur = bytearray()
            i = k + 1
        else:
            segments.append(bytes(cur))
            return segments, k - 1, c


class _BitReader:
    """Bits of one restart interval, then zero bits without end; ``short``
    becomes True once a read consumes a bit past the real data (jdhuff.c's
    ``insufficient_data``)."""

    def __init__(self, seg: bytes):
        self.buf = seg + b"\0" * 8
        self.nbits = 8 * len(seg)
        self.pos = 0
        self.short = False

    def _peek32(self) -> int:
        p = self.pos
        byte = p >> 3
        if byte + 4 > len(self.buf):
            self.buf += b"\0" * 64
        return (int.from_bytes(self.buf[byte:byte + 4], "big")
                << (p & 7)) & 0xFFFFFFFF

    def huff(self, table: _HuffTable) -> int:
        look = self._peek32() >> 16
        n = table.size[look]
        self.pos += n
        if self.pos > self.nbits:
            self.short = True
        return table.sym[look] if n <= 16 else 0

    def bits(self, s: int) -> int:
        r = self._peek32() >> (32 - s)
        self.pos += s
        if self.pos > self.nbits:
            self.short = True
        return r


def _extend(r: int, s: int) -> int:
    """HUFF_EXTEND: an s-bit value r as a signed coefficient."""
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


def _wrap16(x: int) -> int:
    return ((x + 32768) & 0xFFFF) - 32768


def _parse_jpeg(data: bytes, name: str, decode: bool):
    """Walk the markers of a JPEG. With ``decode`` False stop at the frame
    header and return its geometry; else entropy-decode every scan and
    return :class:`JpegCoefficients`."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise ImageDecodeError(f"{name}: not a JPEG file (no SOI)")
    pos = 2
    qtabs: dict = {}
    dc_tabs: dict = {}
    ac_tabs: dict = {}
    restart = 0
    frame = None
    comp_q: list = []
    latched: dict = {}
    coef = None
    offsets: list = []
    n = len(data)
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1                  # garbage between markers is skipped
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:                 # EOI
            break
        if m in (0x01,) or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > n:
            break
        length = _u16(data, pos)
        seg = data[pos + 2:pos + length]
        if length < 2 or len(seg) < length - 2:
            raise ImageDecodeError(f"{name}: truncated marker segment "
                                   f"0xFF{m:02X}")
        pos += length
        if m in _SOF_NAMES:
            if m not in (0xC0, 0xC1):
                raise ImageDecodeError(f"{name}: {_SOF_NAMES[m]} JPEG is "
                                       "not supported (SOF0/SOF1 only)")
            if seg[0] != 8:
                raise ImageDecodeError(f"{name}: {seg[0]}-bit JPEG is not "
                                       "supported (8-bit only)")
            height, width, nc = _u16(seg, 1), _u16(seg, 3), seg[5]
            if height == 0 or width == 0:
                raise ImageDecodeError(f"{name}: empty image or DNL height")
            if nc not in (1, 3):
                raise ImageDecodeError(f"{name}: {nc} components (1 or 3 "
                                       "supported)")
            ids = [seg[6 + 3 * c] for c in range(nc)]
            h = [seg[7 + 3 * c] >> 4 for c in range(nc)]
            v = [seg[7 + 3 * c] & 15 for c in range(nc)]
            comp_q = [seg[8 + 3 * c] & 3 for c in range(nc)]
            if nc == 1:
                h, v = [1], [1]
            _check_sampling(name, h, v)
            frame = (JpegGeometry(height, width, tuple(h), tuple(v)), ids)
            if not decode:
                return frame[0]
            geo = frame[0]
            sizes = [r * c for r, c in geo.blocks()]
            offsets = list(np.cumsum([0] + sizes[:-1]))
            coef = np.zeros((sum(sizes), 64), np.int16)
        elif m == 0xDB:               # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 3
                i += 1
                if pq:
                    vals = struct.unpack(">64H", seg[i:i + 128])
                    i += 128
                else:
                    vals = tuple(seg[i:i + 64])
                    i += 64
                table = np.zeros(64, np.int32)
                table[NATURAL_ORDER[:64]] = vals
                qtabs[tq] = table
        elif m == 0xC4:               # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 3
                counts = list(seg[i + 1:i + 17])
                total = sum(counts)
                symbols = list(seg[i + 17:i + 17 + total])
                i += 17 + total
                (ac_tabs if tc else dc_tabs)[th] = _HuffTable(counts,
                                                              symbols)
        elif m == 0xDD:               # DRI
            restart = _u16(seg, 0)
        elif m == 0xDA:               # SOS
            if frame is None:
                raise ImageDecodeError(f"{name}: scan before the frame "
                                       "header")
            geo, ids = frame
            ns = seg[0]
            comps, tabs = [], []
            for j in range(ns):
                cid, t = seg[1 + 2 * j], seg[2 + 2 * j]
                if cid not in ids:
                    raise ImageDecodeError(f"{name}: scan names unknown "
                                           f"component {cid}")
                c = ids.index(cid)
                comps.append(c)
                if (t >> 4) & 3 not in dc_tabs or t & 3 not in ac_tabs:
                    raise ImageDecodeError(f"{name}: scan uses an undefined "
                                           "Huffman table")
                tabs.append((dc_tabs[(t >> 4) & 3], ac_tabs[t & 3]))
                if c not in latched:
                    if comp_q[c] not in qtabs:
                        raise ImageDecodeError(f"{name}: component {cid} "
                                               "has no quantization table")
                    latched[c] = qtabs[comp_q[c]].copy()
            segments, pos, _ = _scan_segments(data, pos)
            _decode_scan(geo, comps, tabs, restart, segments, coef, offsets)
    if frame is None or coef is None:
        raise ImageDecodeError(f"{name}: no frame header (SOF) found")
    geo = frame[0]
    qt = np.stack([latched.get(c, np.zeros(64, np.int32))
                   for c in range(geo.nc)])
    return JpegCoefficients(geo, coef, qt)


def _decode_scan(geo: JpegGeometry, comps, tabs, restart: int,
                 segments: List[bytes], coef: np.ndarray, offsets) -> None:
    """Huffman-decode one sequential scan into ``coef`` (jdhuff.c
    decode_mcu_slow, restarts as process_restart). A scan of one
    component walks its blocks one by one; an interleaved scan walks MCUs
    of h x v blocks of each component."""
    blocks = geo.blocks()
    if len(comps) == 1:
        dh, dw = geo.downsampled()[comps[0]]
        mcus_x, mcus_y = -(-dw // 8), -(-dh // 8)
        units = {comps[0]: (1, 1)}
    else:
        mcus_x = -(-geo.width // (8 * max(geo.h)))
        mcus_y = -(-geo.height // (8 * max(geo.v)))
        units = {c: (geo.v[c], geo.h[c]) for c in comps}
    natural = NATURAL_ORDER.tolist()
    seg_i = 0
    reader = _BitReader(segments[0] if segments else b"")
    pred = {c: 0 for c in comps}
    left = restart
    for mcu in range(mcus_x * mcus_y):
        if restart:
            if left == 0:
                seg_i += 1
                reader = _BitReader(segments[seg_i] if seg_i < len(segments)
                                    else b"")
                if seg_i >= len(segments):
                    reader.short = True       # no restart marker: no data
                pred = {c: 0 for c in comps}
                left = restart
            left -= 1
        if reader.short:
            continue
        my, mx = divmod(mcu, mcus_x)
        for c, (dc, ac) in zip(comps, tabs):
            nv, nh = units[c]
            for by in range(nv):
                for bx in range(nh):
                    row, col = my * nv + by, mx * nh + bx
                    blk = coef[offsets[c] + row * blocks[c][1] + col]
                    # a corrupt table's category is cut to 16 bits
                    s = min(reader.huff(dc), 16)
                    if s:
                        s = _extend(reader.bits(s), s)
                    pred[c] += s
                    blk[0] = _wrap16(pred[c])
                    k = 1
                    while k < 64:
                        rs = reader.huff(ac)
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            blk[natural[k]] = _wrap16(
                                _extend(reader.bits(s), s))
                        else:
                            if r != 15:
                                break
                            k += 15
                        k += 1


def jpeg_header(data: bytes, name: str = "<bytes>") -> JpegGeometry:
    """The geometry of a JPEG from its frame header (raises for what the
    decoder does not take)."""
    return _parse_jpeg(data, name, decode=False)


def jpeg_coefficients_plain(data: bytes,
                            name: str = "<bytes>") -> JpegCoefficients:
    """Plain (Python) entropy decoder: the coefficients and quantization
    tables of a JPEG."""
    return _parse_jpeg(data, name, decode=True)


def jpeg_coefficients_native(data: bytes,
                             name: str = "<bytes>") -> JpegCoefficients:
    """The C entropy decoder of csrc/jpeg_decode.cu (host code, ctypes):
    the same result as :func:`jpeg_coefficients_plain`."""
    geo = jpeg_header(data, name)
    coef = np.empty((geo.total_blocks(), 64), np.int16)
    qt = np.empty((geo.nc, 64), np.int32)
    _native_decode(data, name, coef, qt)
    return JpegCoefficients(geo, coef, qt)


_NATIVE_ERRORS = {-1: "not a JPEG file", -2: "unsupported JPEG",
                  -3: "corrupt JPEG header", -4: "output too small"}


def _native_decode(data: bytes, name: str, coef: np.ndarray,
                   qt: np.ndarray) -> None:
    lib = kernel_lib.library()
    err = lib.pvnet_jpeg_entropy_decode(
        data, len(data), coef.ctypes.data, coef.shape[0],
        qt.ctypes.data)
    if err != 0:
        raise ImageDecodeError(
            f"{name}: {_NATIVE_ERRORS.get(err, 'decode error')} ({err})")


# -- the pixel stage ------------------------------------------------------

def _idct_1d(x, shift: int):
    """One 8-point pass of jpeg_idct_islow on int64 tensors x[0..7] (the
    column pass with shift CONST_BITS - PASS1_BITS, the row pass with
    CONST_BITS + PASS1_BITS + 3); returns the 8 descaled outputs."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    rnd = 1 << (shift - 1)
    return [(v + rnd) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct_islow_plain(blocks: torch.Tensor, qt: torch.Tensor) -> torch.Tensor:
    """Dequantize and jpeg_idct_islow with the SIMD version's overflow
    rules (module docstring): coefficients int16 [..., 64] and quantization
    tables [..., 64] (natural order, broadcast) -> samples uint8
    [..., 8, 8]."""
    x = blocks.to(torch.int64) * qt.to(torch.int64)
    x = (((x + 32768) & 0xFFFF) - 32768).reshape(blocks.shape[:-1] + (8, 8))
    cols = _idct_1d([x[..., r, :] for r in range(8)],
                    CONST_BITS - PASS1_BITS)
    ws = torch.stack(cols, -2).clamp(-32768, 32767)     # [..., row, col]
    rows = _idct_1d([ws[..., :, c] for c in range(8)],
                    CONST_BITS + PASS1_BITS + 3)
    return (torch.stack(rows, -1).clamp(-128, 127) + 128).to(torch.uint8)


def _upsample_index(n_out: int, n_in: int, device):
    """Per output position: the nearer and farther input sample (clamped
    to the real samples, as libjpeg's replicated edges) and whether the
    position is the odd one of its pair."""
    o = torch.arange(n_out, device=device)
    near = o >> 1
    odd = o & 1
    far = torch.where(odd == 1, near + 1, near - 1).clamp(0, n_in - 1)
    return near.clamp(max=n_in - 1), far, odd


def upsample_plain(plane: torch.Tensor, ry: int, rx: int, out_h: int,
                   out_w: int) -> torch.Tensor:
    """libjpeg's upsampling of a component plane [B, dh, dw] (int64, real
    samples only) by (ry, rx) in {(1, 1), (1, 2), (2, 2)} to
    [B, out_h, out_w]: fancy (triangle) filtering, box where the plane is
    at most 2 samples wide."""
    B, dh, dw = plane.shape
    if (ry, rx) == (1, 1):
        return plane[:, :out_h, :out_w]
    dev = plane.device
    if dw <= 2:
        ys = torch.arange(out_h, device=dev) // ry
        xs = torch.arange(out_w, device=dev) // rx
        return plane[:, ys][:, :, xs]
    xn, xf, xodd = _upsample_index(out_w, dw, dev)
    if ry == 1:
        near = plane[:, :out_h][:, :, xn]
        far = plane[:, :out_h][:, :, xf]
        return (3 * near + far + 1 + xodd) >> 2
    yn, yf, _ = _upsample_index(out_h, dh, dev)
    colsum = 3 * plane[:, yn] + plane[:, yf]            # [B, out_h, dw]
    return (3 * colsum[:, :, xn] + colsum[:, :, xf] + 8 - xodd) >> 4


def ycc_to_rgb_plain(y: torch.Tensor, cb: torch.Tensor,
                     cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c ycc_rgb_convert on int64 planes -> uint8 [..., 3]."""
    x_cb, x_cr = cb - 128, cr - 128
    r = y + ((FIX_1_40200 * x_cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-FIX_0_34414 * x_cb + ONE_HALF - FIX_0_71414 * x_cr)
             >> SCALEBITS)
    b = y + ((FIX_1_77200 * x_cb + ONE_HALF) >> SCALEBITS)
    return torch.stack([r, g, b], -1).clamp(0, 255).to(torch.uint8)


def jpeg_pixels_plain(coef: torch.Tensor, qt: torch.Tensor,
                      geo: JpegGeometry) -> torch.Tensor:
    """Plain PyTorch version of :func:`jpeg_pixels`, in integer
    arithmetic: coefficients int16 [B, total_blocks, 64] and quantization
    tables [B, nc, 64] of images of one geometry -> RGB uint8
    [B, height, width, 3]. Runs on any device."""
    B = coef.shape[0]
    H, W = geo.height, geo.width
    hmax, vmax = max(geo.h), max(geo.v)
    planes = []
    off = 0
    for c, ((br, bc), (dh, dw)) in enumerate(zip(geo.blocks(),
                                                 geo.downsampled())):
        blk = coef[:, off:off + br * bc]
        off += br * bc
        s = idct_islow_plain(blk, qt[:, c:c + 1])      # [B, n, 8, 8]
        s = (s.reshape(B, br, bc, 8, 8).permute(0, 1, 3, 2, 4)
             .reshape(B, br * 8, bc * 8)[:, :dh, :dw].to(torch.int64))
        planes.append(upsample_plain(s, vmax // geo.v[c], hmax // geo.h[c],
                                     H, W))
    if geo.nc == 1:
        return planes[0].to(torch.uint8)[..., None].expand(
            B, H, W, 3).contiguous()
    return ycc_to_rgb_plain(*planes)


def _check_pixels(coef: torch.Tensor, qt: torch.Tensor,
                  geo: JpegGeometry) -> None:
    if coef.dim() != 3 or coef.shape[1:] != (geo.total_blocks(), 64):
        raise ValueError(f"coef must be [B, {geo.total_blocks()}, 64]; got "
                         f"{tuple(coef.shape)}")
    if qt.shape != (coef.shape[0], geo.nc, 64):
        raise ValueError(f"qt must be [{coef.shape[0]}, {geo.nc}, 64]; got "
                         f"{tuple(qt.shape)}")
    if coef.dtype != torch.int16:
        raise TypeError(f"coef must be int16, got {coef.dtype}")
    if qt.device != coef.device:
        raise ValueError(f"coef on {coef.device}, qt on {qt.device}")
    _check_sampling("jpeg_pixels", geo.h, geo.v)


# csrc/jpeg_decode.cu: a thread block owns 4x4 MCUs and IDCTs them, with a
# ring of one block around each upsampled component, into shared memory
TILE_MCUS, MAX_TILE_BLOCKS = 4, 136


def tile_blocks(geo: JpegGeometry) -> int:
    """Blocks the kernel IDCTs for one tile of this geometry."""
    hmax, vmax = max(geo.h), max(geo.v)
    return sum((TILE_MCUS * hc + (2 if hmax > hc else 0))
               * (TILE_MCUS * vc + (2 if vmax > vc else 0))
               for hc, vc in zip(geo.h, geo.v))


def jpeg_pixels(coef: torch.Tensor, qt: torch.Tensor, geo: JpegGeometry,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequantize + islow IDCT + fancy upsampling + YCbCr->RGB of a batch
    of JPEGs of one geometry: coef int16 [B, total_blocks, 64], qt
    [B, nc, 64] -> uint8 [B, height, width, 3] (into ``out`` where given,
    a contiguous uint8 tensor of that shape, e.g. a slice of a device
    dataset). A CUDA tensor launches the kernel of csrc/jpeg_decode.cu
    (counted in ``.launches``) or raises; a CPU tensor takes
    :func:`jpeg_pixels_plain`."""
    _check_pixels(coef, qt, geo)
    B = coef.shape[0]
    shape = (B, geo.height, geo.width, 3)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.uint8
                            or not out.is_contiguous()
                            or out.device != coef.device):
        raise ValueError(f"out must be a contiguous uint8 {shape} tensor on "
                         f"{coef.device}")
    if coef.device.type == "cpu":
        res = jpeg_pixels_plain(coef, qt, geo)
        if out is None:
            return res
        out.copy_(res)
        return out
    kernel_lib.check_device(coef)
    if tile_blocks(geo) > MAX_TILE_BLOCKS:
        raise ImageDecodeError(
            f"sampling h={list(geo.h)} v={list(geo.v)}: a tile needs "
            f"{tile_blocks(geo)} blocks, the kernel holds {MAX_TILE_BLOCKS}")
    if out is None:
        out = torch.empty(shape, dtype=torch.uint8, device=coef.device)
    if B == 0:
        return out
    coef = coef.contiguous()
    qt = qt.to(torch.int32).contiguous()
    h = list(geo.h) + [1] * (3 - geo.nc)
    v = list(geo.v) + [1] * (3 - geo.nc)
    kernel_lib.launch("pvnet_jpeg_pixels", coef.device, coef.data_ptr(),
                      qt.data_ptr(), out.data_ptr(), B, geo.height,
                      geo.width, geo.nc, h[0], v[0], h[1], v[1], h[2], v[2])
    jpeg_pixels.launches += 1
    return out


jpeg_pixels.launches = 0


# -- PNG ------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@dataclass
class PngImage:
    """Unfiltered samples of a PNG: ``samples`` [h, w, channels], uint8
    (palette indices for colour type 3, values as stored for bit depths
    below 8) or uint16 at bit depth 16, with the header fields and the
    palette [n, 3]."""
    samples: np.ndarray
    color_type: int
    bit_depth: int
    palette: Optional[np.ndarray]


def _png_chunks(data: bytes, name: str):
    if data[:8] != _PNG_SIG:
        raise ImageDecodeError(f"{name}: not a PNG file")
    pos, n = 8, len(data)
    ihdr, plte, idat = None, None, []
    while pos + 8 <= n:
        length = struct.unpack(">I", data[pos:pos + 4])[0]
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ImageDecodeError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ImageDecodeError(f"{name}: interlaced PNG is not supported")
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or (
            ctype in (2, 4, 6) and depth != 8) or (
            depth == 16 and ctype != 0):
        raise ImageDecodeError(f"{name}: PNG colour type {ctype} at bit "
                               f"depth {depth} is not supported")
    if ctype == 3 and plte is None:
        raise ImageDecodeError(f"{name}: palette PNG without PLTE")
    return w, h, depth, ctype, plte, b"".join(idat)


def png_unfilter_plain(raw: bytes, height: int, row_bytes: int,
                       bpp: int) -> np.ndarray:
    """Undo PNG filter types 0-4 (plain Python): ``raw`` is the inflated
    stream, one filter byte and ``row_bytes`` bytes per row; ``bpp`` the
    bytes per complete pixel (at least 1). Returns uint8
    [height, row_bytes]."""
    stride = row_bytes + 1
    if len(raw) < stride * height:
        raise ImageDecodeError(f"PNG data too short: {len(raw)} bytes for "
                               f"{height} rows of {row_bytes}")
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int64)
    for y in range(height):
        ftype = raw[y * stride]
        cur = np.frombuffer(raw, np.uint8, row_bytes,
                            y * stride + 1).astype(np.int64)
        if ftype == 0:
            row = cur
        elif ftype == 2:
            row = (cur + prev) & 255
        elif ftype == 1:
            row = cur.copy()
            for i in range(bpp):              # a running sum per byte lane
                row[i::bpp] = np.cumsum(cur[i::bpp]) & 255
        elif ftype in (3, 4):
            c, p = cur.tolist(), prev.tolist()
            r = [0] * row_bytes
            for i in range(row_bytes):
                a = r[i - bpp] if i >= bpp else 0
                up = p[i]
                if ftype == 3:
                    pred = (a + up) >> 1
                else:
                    ul = p[i - bpp] if i >= bpp else 0
                    est = a + up - ul
                    pa, pb, pc = abs(est - a), abs(est - up), abs(est - ul)
                    pred = a if pa <= pb and pa <= pc else (
                        up if pb <= pc else ul)
                r[i] = (c[i] + pred) & 255
            row = np.asarray(r, np.int64)
        else:
            raise ImageDecodeError(f"PNG filter type {ftype} is invalid")
        out[y] = row
        prev = row
    return out


def png_unfilter_native(raw: bytes, height: int, row_bytes: int,
                        bpp: int) -> np.ndarray:
    """The C unfilter of csrc/jpeg_decode.cu (host code): the same result
    as :func:`png_unfilter_plain`."""
    out = np.empty((height, row_bytes), np.uint8)
    err = kernel_lib.library().pvnet_png_unfilter(
        raw, len(raw), height, row_bytes, bpp, out.ctypes.data)
    if err != 0:
        raise ImageDecodeError(f"PNG data invalid ({err}): {len(raw)} bytes "
                               f"for {height} rows of {row_bytes}")
    return out


def decode_png(data: bytes, name: str = "<bytes>",
               native: bool = False) -> PngImage:
    """Inflate and unfilter a PNG (the C unfilter with ``native``)."""
    w, h, depth, ctype, plte, idat = _png_chunks(data, name)
    ch = _PNG_CHANNELS[ctype]
    row_bytes = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    try:
        raw = zlib.decompress(idat)
    except zlib.error as e:
        raise ImageDecodeError(f"{name}: PNG data does not inflate: {e}")
    unfilter = png_unfilter_native if native else png_unfilter_plain
    rows = unfilter(raw, h, row_bytes, bpp)
    if depth == 16:                       # big-endian 2-byte samples
        rows = rows.reshape(h, w * ch, 2).astype(np.uint16)
        rows = (rows[..., 0] << 8) | rows[..., 1]
    elif depth < 8:
        bits = np.unpackbits(rows, axis=1)[:, :w * depth]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits.reshape(h, w, depth) * weights).sum(-1).astype(
            np.uint8)
    samples = rows.reshape(h, w, ch)
    return PngImage(samples, ctype, depth, plte)


def png_to_rgb(img: PngImage) -> np.ndarray:
    """cv2.imread(IMREAD_COLOR)'s pixels (in RGB order) of a decoded PNG."""
    s = img.samples
    if img.color_type == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(img.palette)] = img.palette[:256]
        return pal[s[..., 0]]
    if img.color_type in (0, 4):
        g = s[..., 0]
        if img.bit_depth == 16:
            g = (g >> 8).astype(np.uint8)
        elif img.bit_depth < 8:
            g = (g * (255 // ((1 << img.bit_depth) - 1))).astype(np.uint8)
        return np.repeat(g[..., None], 3, -1)
    return np.ascontiguousarray(s[..., :3])


def png_to_mask(img: PngImage) -> np.ndarray:
    """``np.asarray(Image.open(p), np.int32)`` of a decoded PNG: palette
    indices, 0/1 for 1-bit gray, gray below 8 bits scaled as PIL's
    unpackers scale it, 16-bit gray as stored, the channels of a colour
    image."""
    s = img.samples.astype(np.int32)
    if img.color_type == 0 and img.bit_depth == 1:
        return s[..., 0]
    if img.color_type == 0 and img.bit_depth < 8:
        return s[..., 0] * (255 // ((1 << img.bit_depth) - 1))
    if img.color_type in (0, 3):
        return s[..., 0]
    return s


# -- files ----------------------------------------------------------------

def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _is_png(data: bytes) -> bool:
    return data[:8] == _PNG_SIG


def _native(device) -> bool:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def read_rgb(path: str, device="cpu") -> torch.Tensor:
    """A JPEG or PNG file as RGB uint8 [h, w, 3] on ``device``: what
    pvnet_tpu/data/linemod.py ``read_rgb_np`` returns. On a CUDA device the
    C entropy decoder and the CUDA pixel kernel run; on the CPU their
    plain versions."""
    return decode_rgb_bytes(_read(path), path, device)


def read_mask(path: str, device="cpu") -> np.ndarray:
    """A PNG mask as int32 (what ``read_mask_np`` returns); with a CUDA
    ``device`` the C unfilter runs, on the CPU the plain one."""
    data = _read(path)
    if not _is_png(data):
        raise ImageDecodeError(f"{path}: masks are read from PNG files")
    return png_to_mask(decode_png(data, path, native=_native(device)))


def _decode_one(path: str, native: bool):
    """Host stage of one file: ('jpeg', JpegCoefficients) or ('rgb',
    uint8 [h, w, 3])."""
    data = _read(path)
    if _is_png(data):
        return "rgb", png_to_rgb(decode_png(data, path, native=native))
    if native:
        return "jpeg", jpeg_coefficients_native(data, path)
    return "jpeg", jpeg_coefficients_plain(data, path)


# host threads of the entropy decoding and unfiltering of many files
DECODE_THREADS = 8


def decode_rgb_into(paths: Sequence[str], out: torch.Tensor) -> None:
    """Decode ``paths`` into ``out`` uint8 [len(paths), h, w, 3] (every
    file h x w): host stages on a pool of DECODE_THREADS, then one pixel
    kernel launch per geometry among the JPEGs."""
    native = _native(out.device)
    n = len(paths)
    if tuple(out.shape) != (n,) + tuple(out.shape[1:]) or out.dim() != 4:
        raise ValueError(f"out must be [{n}, h, w, 3]; got "
                         f"{tuple(out.shape)}")
    if n > 1:
        with ThreadPoolExecutor(min(DECODE_THREADS, n)) as pool:
            parts = list(pool.map(lambda p: _decode_one(p, native), paths))
    else:
        parts = [_decode_one(p, native) for p in paths]
    hw = tuple(out.shape[1:3])
    groups: dict = {}
    for i, (kind, val) in enumerate(parts):
        size = ((val.geometry.height, val.geometry.width) if kind == "jpeg"
                else val.shape[:2])
        if tuple(size) != hw:
            raise ValueError(f"{paths[i]} is {size[0]}x{size[1]}, expected "
                             f"{hw[0]}x{hw[1]} (uniform sizes required)")
        if kind == "rgb":
            out[i].copy_(torch.from_numpy(val))
        else:
            groups.setdefault(val.geometry, []).append(i)
    for geo, idx in groups.items():
        coef = torch.from_numpy(np.stack([parts[i][1].coef for i in idx]))
        qt = torch.from_numpy(np.stack([parts[i][1].qt for i in idx]))
        if native:
            coef = coef.pin_memory().to(out.device, non_blocking=True)
            qt = qt.to(out.device)
        contiguous = idx == list(range(idx[0], idx[0] + len(idx)))
        if contiguous:
            jpeg_pixels(coef, qt, geo, out=out[idx[0]:idx[0] + len(idx)])
        else:
            out[torch.as_tensor(idx, device=out.device)] = jpeg_pixels(
                coef, qt, geo)


def decode_rgb_bytes(data: bytes, name: str = "<bytes>",
                     device="cpu") -> torch.Tensor:
    """A JPEG or PNG held in memory as RGB uint8 [h, w, 3] on ``device``
    (the C and CUDA stages on a CUDA device, the plain ones on the
    CPU)."""
    native = _native(device)
    if _is_png(data):
        return torch.from_numpy(png_to_rgb(decode_png(data, name, native))
                                ).to(device)
    c = (jpeg_coefficients_native if native
         else jpeg_coefficients_plain)(data, name)
    coef = torch.from_numpy(c.coef[None]).to(device)
    qt = torch.from_numpy(c.qt[None]).to(device)
    return jpeg_pixels(coef, qt, c.geometry)[0]


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of a JPEG or PNG file from its header."""
    data = _read(path)
    if _is_png(data):
        w, h = struct.unpack(">II", data[16:24])
        return h, w
    geo = jpeg_header(data, path)
    return geo.height, geo.width


def decode_rgb_batch(paths: Sequence[str], device="cpu") -> torch.Tensor:
    """RGB uint8 [n, h, w, 3] on ``device`` of files of one size."""
    if not paths:
        raise ValueError("no files")
    h, w = image_size(paths[0])
    out = torch.empty((len(paths), h, w, 3), dtype=torch.uint8,
                      device=device)
    decode_rgb_into(paths, out)
    return out


# -- writing: JPEG as PIL writes it, PNG through zlib ------------------------

# libjpeg's standard quantization tables (jcparam.c, natural order), scaled
# to quality 75 (jpeg_set_quality: scale factor 50, clamped to 1..255)
_STD_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64), np.array([
        17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
        + [99] * 32, np.int64))
QUALITY_75_TABLES = tuple(np.clip((t * 50 + 50) // 100, 1, 255)
                          for t in _STD_QUANT)

# the standard Huffman tables (jstdhuff.c): code counts by length, symbols
_DC_BITS = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
            (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0))
_DC_VALS = bytes(range(12))
_AC_BITS = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
            (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77))
_AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))
_ZIGZAG = NATURAL_ORDER[:64]

# jccolor.c rgb_ycc_start's weights; Cb and Cr round with ONE_HALF - 1
_RGB_Y = (_fix(0.29900), _fix(0.58700), _fix(0.11400))
_RGB_CB = (-_fix(0.16874), -_fix(0.33126), _fix(0.50000))
_RGB_CR = (_fix(0.50000), -_fix(0.41869), -_fix(0.08131))
_CBCR_ROUND = (128 << SCALEBITS) + ONE_HALF - 1


def _reciprocal(divisor: int) -> Tuple[int, int, int]:
    """jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM: (recip, corr,
    shift) with round(x / divisor) = ((x + corr) * recip) >> shift for
    x >= 0."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq, r = fq >> 1, r - 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, first: bool):
    """One 8-point pass of jfdctint.c jpeg_fdct_islow over the int64
    arrays d[0..7] (rows: outputs scaled up by 2**PASS1_BITS; columns:
    that scaling removed)."""
    t0, t7 = d[0] + d[7], d[0] - d[7]
    t1, t6 = d[1] + d[6], d[1] - d[6]
    t2, t5 = d[2] + d[5], d[2] - d[5]
    t3, t4 = d[3] + d[4], d[3] - d[4]
    t10, t13 = t0 + t3, t0 - t3
    t11, t12 = t1 + t2, t1 - t2
    out = [None] * 8
    if first:
        out[0], out[4] = (t10 + t11) << PASS1_BITS, (t10 - t11) << PASS1_BITS
        n = CONST_BITS - PASS1_BITS
    else:
        out[0] = _descale(t10 + t11, PASS1_BITS)
        out[4] = _descale(t10 - t11, PASS1_BITS)
        n = CONST_BITS + PASS1_BITS
    z1 = (t12 + t13) * FIX_0_541196100
    out[2] = _descale(z1 + t13 * FIX_0_765366865, n)
    out[6] = _descale(z1 - t12 * FIX_1_847759065, n)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * FIX_1_175875602
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    out[7] = _descale(t4 * FIX_0_298631336 + z1 + z3, n)
    out[5] = _descale(t5 * FIX_2_053119869 + z2 + z4, n)
    out[3] = _descale(t6 * FIX_3_072711026 + z2 + z3, n)
    out[1] = _descale(t7 * FIX_1_501321110 + z1 + z4, n)
    return out


def _fdct_quantize(plane: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Level shift, jpeg_fdct_islow and quantization of every 8x8 block of
    a plane (int64 [8 * rows, 8 * cols]) -> [rows, cols, 64] in natural
    order."""
    h, w = plane.shape
    blk = (plane - 128).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    rows = np.stack(_fdct_1d([blk[..., c] for c in range(8)], True), -1)
    coef = np.stack(_fdct_1d([rows[..., r, :] for r in range(8)], False),
                    -2).reshape(h // 8, w // 8, 64)
    recip, corr, shift = (np.array(v, np.int64) for v in zip(
        *[_reciprocal(int(q) * 8) for q in table]))
    q = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -q, q)


def _pad_edges(a: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(a, ((0, h - a.shape[0]), (0, w - a.shape[1])), mode="edge")


def _huff_codes(bits, vals) -> Tuple[np.ndarray, np.ndarray]:
    """(code, size) [256] of a canonical Huffman table by symbol."""
    code = np.zeros(256, np.int64)
    size = np.zeros(256, np.int64)
    c = k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            code[vals[k]], size[vals[k]] = c, length
            c, k = c + 1, k + 1
        c <<= 1
    return code, size


def _magnitude_bits(v: np.ndarray) -> np.ndarray:
    """Bits of |v| (JPEG's magnitude category)."""
    a = np.abs(v)
    n = np.zeros(a.shape, np.int64)
    while a.any():
        n += a > 0
        a = a >> 1
    return n


def _entropy_code(zz: np.ndarray, dcdiff: np.ndarray,
                  tab: np.ndarray) -> bytes:
    """jchuff.c encode_one_block over blocks in scan order (zigzag
    coefficients int64 [N, 64], DC differences [N], Huffman table 0/1 of
    each block) with the standard tables, vectorized: every code and its
    extra bits become (value, length) items ordered by (block, position),
    then one bit stream, the last byte padded with 1 bits and every 0xFF
    followed by a stuffed 0x00."""
    dc = [_huff_codes(_DC_BITS[t], _DC_VALS) for t in (0, 1)]
    ac = [_huff_codes(_AC_BITS[t], _AC_VALS[t]) for t in (0, 1)]
    dc_code, dc_size = (np.stack([dc[0][i], dc[1][i]]) for i in (0, 1))
    ac_code, ac_size = (np.stack([ac[0][i], ac[1][i]]) for i in (0, 1))
    n = zz.shape[0]
    blocks = np.arange(n)
    stride = 65 * 8               # a block's keys: 8 slots per position
    keys, vals, lens = [], [], []

    def emit(key, val, length):
        keys.append(key)
        vals.append(val)
        lens.append(length)

    nb = _magnitude_bits(dcdiff)
    emit(blocks * stride, dc_code[tab, nb], dc_size[tab, nb])
    emit(blocks * stride + 1,
         np.where(dcdiff < 0, dcdiff - 1, dcdiff) & ((1 << nb) - 1), nb)
    bi, ki = np.nonzero(zz[:, 1:])
    k = ki + 1
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    run = k - np.where(first, 0, np.concatenate([[0], k[:-1]])) - 1
    v = zz[bi, k]
    nb = _magnitude_bits(v)
    t = tab[bi]
    for j in range(3):            # ZRL codes: 16 zeros each
        m = (run >> 4) > j
        emit(bi[m] * stride + k[m] * 8 + j, ac_code[t[m], 0xF0],
             ac_size[t[m], 0xF0])
    sym = ((run & 15) << 4) | nb
    emit(bi * stride + k * 8 + 4, ac_code[t, sym], ac_size[t, sym])
    emit(bi * stride + k * 8 + 5, np.where(v < 0, v - 1, v) & ((1 << nb) - 1),
         nb)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)
    m = last < 63                 # EOB after the last nonzero coefficient
    emit(blocks[m] * stride + 64 * 8, ac_code[tab[m], 0], ac_size[tab[m], 0])
    order = np.argsort(np.concatenate(keys))
    vals = np.concatenate(vals)[order]
    lens = np.concatenate(lens)[order]
    total = int(lens.sum())
    item = np.repeat(np.arange(len(lens)), lens)
    bit = np.arange(total) - (np.cumsum(lens) - lens)[item]
    stream = (vals[item] >> (lens[item] - 1 - bit)) & 1
    stream = np.concatenate([stream, np.ones(-total % 8, np.int64)])
    by = np.packbits(stream.astype(np.uint8))
    ff = by == 0xFF
    out = np.repeat(by, 1 + ff)
    out[(np.cumsum(1 + ff) - 1)[ff]] = 0
    return out.tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _jpeg_headers(h: int, w: int) -> bytes:
    """SOI through SOS as libjpeg writes them for PIL's defaults (YCbCr,
    4:2:0: luma 2x2 on table 0, chroma 1x1 on table 1)."""
    out = b"\xff\xd8" + _segment(
        0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in (0, 1):
        out += _segment(0xDB, bytes([t]) + bytes(
            QUALITY_75_TABLES[t][_ZIGZAG].astype(np.uint8)))
    out += _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                    + b"\x01\x22\x00\x02\x11\x01\x03\x11\x01")
    for t in (0, 1):
        out += _segment(0xC4, bytes([t] + list(_DC_BITS[t])) + _DC_VALS)
        out += _segment(0xC4, bytes([0x10 | t] + list(_AC_BITS[t]))
                        + _AC_VALS[t])
    return out + _segment(0xDA, b"\x03\x01\x00\x02\x11\x03\x11"
                          b"\x00\x3f\x00")


def _check_encode(pixels: np.ndarray) -> np.ndarray:
    a = np.asarray(pixels)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"JPEG encoding takes RGB uint8 [h, w, 3]; got "
                         f"{a.dtype} {a.shape}")
    if not (1 <= a.shape[0] <= 65535 and 1 <= a.shape[1] <= 65535):
        raise ValueError(f"JPEG image size {a.shape[:2]} out of range")
    return np.ascontiguousarray(a)


def jpeg_encode_plain(pixels: np.ndarray) -> bytes:
    """Plain (numpy) JPEG encoder: the file PIL writes for ``pixels``
    RGB uint8 [h, w, 3] at its defaults."""
    a = _check_encode(pixels).astype(np.int64)
    H, W = a.shape[:2]
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    y = (_RGB_Y[0] * r + _RGB_Y[1] * g + _RGB_Y[2] * b + ONE_HALF) >> 16
    mx, my = -(-W // 16), -(-H // 16)
    lwb, lhb = -(-W // 8), -(-H // 8)
    yq = _fdct_quantize(_pad_edges(y, 16 * my, 16 * mx), QUALITY_75_TABLES[0])
    # jccoefct.c's dummy blocks past the luma plane: zero, with the DC of
    # the block to the left (right edge) or of the MCU's upper-right block
    # (bottom row)
    if lwb % 2:
        yq[:, lwb] = 0
        yq[:, lwb, 0] = yq[:, lwb - 1, 0]
    if lhb % 2:
        yq[lhb] = 0
        yq[lhb, 0::2, 0] = yq[lhb, 1::2, 0] = yq[lhb - 1, 1::2, 0]
    chroma = []
    for wts in (_RGB_CB, _RGB_CR):
        c = (wts[0] * r + wts[1] * g + wts[2] * b + _CBCR_ROUND) >> 16
        # h2v2_downsample of the image padded to even rows and 16 * mx
        # columns; the prep controller then replicates the last row
        c = _pad_edges(c, 2 * -(-H // 2), 16 * mx)
        s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
        s = (s + np.tile([1, 2], 4 * mx)) >> 2
        chroma.append(_fdct_quantize(_pad_edges(s, 8 * my, 8 * mx),
                                     QUALITY_75_TABLES[1]))
    yq = yq.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(
        my, mx, 4, 64)
    mcus = np.concatenate([yq, chroma[0][:, :, None], chroma[1][:, :, None]],
                          2).reshape(-1, 64)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    dc = mcus[:, 0]
    dcdiff = np.empty_like(dc)
    for ci in range(3):
        d = dc[comp == ci]
        dcdiff[comp == ci] = d - np.concatenate([[0], d[:-1]])
    return (_jpeg_headers(H, W) + _entropy_code(
        mcus[:, _ZIGZAG], dcdiff, (comp > 0).astype(np.int64)) + b"\xff\xd9")


def jpeg_encode_native(pixels: np.ndarray) -> bytes:
    """The C encoder of csrc/jpeg_encode.cu (host code, ctypes; the GIL is
    released while it runs): the same bytes as :func:`jpeg_encode_plain`."""
    a = _check_encode(pixels)
    h, w = a.shape[:2]
    # a block codes in at most ~210 bytes, twice that with stuffing
    cap = 6 * 420 * -(-h // 16) * -(-w // 16) + 2048
    out = np.empty(cap, np.uint8)
    n = ctypes.c_long(0)
    err = kernel_lib.library().pvnet_jpeg_encode(
        a.ctypes.data, h, w, out.ctypes.data, cap, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"pvnet_jpeg_encode failed ({err}) on {a.shape}")
    return out[:n.value].tobytes()


def encode_jpeg(pixels: np.ndarray, device="cpu") -> bytes:
    """The JPEG file PIL writes for ``pixels`` (RGB uint8 [h, w, 3]): with
    a CUDA ``device`` through the C encoder (which must build), on the CPU
    through the plain one."""
    if _native(device):
        return jpeg_encode_native(pixels)
    return jpeg_encode_plain(pixels)


def write_jpeg(path: str, pixels: np.ndarray, device="cpu") -> None:
    """Write :func:`encode_jpeg`'s file to ``path``."""
    data = encode_jpeg(pixels, device)
    with open(path, "wb") as f:
        f.write(data)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """A PNG of ``pixels``: uint8 [h, w] (8-bit gray), uint8 [h, w, 3]
    (RGB) or uint16 [h, w] (16-bit gray, stored big-endian), every row
    with filter type 0, deflated by zlib."""
    a = np.asarray(pixels)
    if a.dtype == np.uint8 and a.ndim == 2:
        depth, ctype = 8, 0
    elif a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        depth, ctype = 8, 2
    elif a.dtype == np.uint16 and a.ndim == 2:
        depth, ctype = 16, 0
    else:
        raise ValueError(f"PNG writing takes uint8 [h, w], uint8 [h, w, 3] "
                         f"or uint16 [h, w]; got {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                              0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write :func:`encode_png`'s file to ``path``."""
    data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)
