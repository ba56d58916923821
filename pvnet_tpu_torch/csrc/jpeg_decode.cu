// JPEG decoding for the port's LINEMOD read path: the host stages (marker
// parsing, Huffman entropy decoding, PNG row unfiltering) as C++ host code
// with a plain C interface, and the device stage (dequantize + islow IDCT
// + fancy upsampling + YCbCr->RGB) as one CUDA kernel over a batch.
//
// Replaces: no TPU kernel. The JAX package decodes with cv2.imread and PIL
// (pvnet_tpu/data/linemod.py: read_rgb_np, read_mask_np), which the GPU
// host does not have. The arithmetic is libjpeg-turbo's, so the output
// equals cv2's byte for byte (pvnet_tpu_torch/data/image_io.py holds the
// plain versions and says which libjpeg routines each step reproduces).
//
// What bounds the kernel on the H100: device-memory bytes and its integer
// instructions alike, in principle. At 480x640 4:2:0 a frame is 0.92 MB of
// int16 coefficients in and 0.92 MB of RGB out, 0.55 us at 3.35 TB/s, and
// about 18 M 32-bit operations (chip_smoke.py's DECODE_OPS_*), 0.55 us at
// the card's instruction rate. In practice a thread block's life is a
// chain of dependent steps (its copies in, two transform passes, the
// planes' edges, pixels, the copy out), and a frame is only 1200 MCUs:
// the kernel is bound by that latency, a few microseconds a block, far
// more than by either rate, so a block must carry enough work to pay for
// it and enough blocks must be resident to overlap it.
//
// Design (each point answers one bound of the earlier, 64-bit kernel):
// - 32-bit arithmetic. Both passes of jpeg_idct_islow run in unsigned
//   32-bit sums that may wrap; their inputs are 16-bit (the dequantized
//   coefficient after its wrap, the column pass's output after its
//   saturation), so every output sum stays within 0.935 * 2^31 and the
//   wrapped sum is libjpeg's 64-bit one; only the final descale is signed
//   (tests/test_torch_jpeg_int32.py models it on the CPU). The column
//   pass's output is int16 in shared memory, in place of the coefficients.
// - No 8x8 halo block is recomputed. The triangle filter reads one chroma
//   sample beyond each tile edge; of a halo block the kernel computes only
//   that edge: above and below the tile one row (its column pass one
//   output of eight, its row pass one row), left and right one column (its
//   column pass, then one output of each row), at a corner one sample. At
//   480x640 4:2:0 that adds 19 % to the own blocks' transform work (14 %
//   at b=24, where tiles are 4 MCU rows tall) where the earlier ring of
//   whole blocks added 42 %. Thread-block clusters that hand each other
//   their edge columns through distributed shared memory were built and
//   measured first: less work, but their barrier cost more than the
//   columns save (PERF.md).
// - A grid sized to the card: a tile is ceil(mcux / 8) MCUs wide (at most
//   16) and 2 MCU rows tall, 4 where that still leaves 8 x 132 blocks, so
//   one 480x640 frame is 120 blocks (one an SM) and 24 frames 1536; a
//   warp per 8 blocks of a tile, 32 registers a thread, shared memory
//   dynamic and sized from the geometry (27 KB at 480x640 4:2:0, b=1).
// - Coalesced traffic and short chains: the tables and each tile's own
//   blocks go to shared memory by cp.async in 16-byte pieces before
//   anything else (a warp's instruction covering four blocks), the halo
//   blocks once the tile's slot groups are known; each warp then
//   transforms its own blocks with no block barrier between the passes;
//   pixels are computed 8 to a thread, with the sampling a template
//   parameter (one kernel per pattern) and no division per pixel; the
//   tile's RGB rows are staged in shared memory and written with 16-byte
//   stores on 16-byte boundaries.
#include <stdint.h>
#include <string.h>

#include <vector>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Host: JPEG entropy decoding (jdhuff.c decode_mcu_slow semantics)
// ---------------------------------------------------------------------------

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLook = 9;   // lookahead bits of the fast table

enum {
  kOk = 0,
  kNotJpeg = -1,
  kUnsupported = -2,
  kCorrupt = -3,
  kTooSmall = -4,
};

// A canonical Huffman table (jdhuff.c jpeg_make_d_derived_tbl): maxcode
// and valoffset per length, and a 9-bit lookahead of (length << 8 | symbol)
// for the short codes (0: longer than 9 bits or no code).
struct Huff {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  uint16_t look[1 << kLook];

  void build(const uint8_t* counts, const uint8_t* symbols, int total) {
    memset(huffval, 0, sizeof(huffval));
    memcpy(huffval, symbols, total > 256 ? 256 : total);
    int code = 0, p = 0;
    int huffcode[257];
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < counts[l - 1] && p < 256; i++) huffcode[p++] = code++;
      code <<= 1;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l - 1]) {
        valoffset[l] = p - huffcode[p];
        p += counts[l - 1];
        if (p > 256) p = 256;
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLook; l++) {
      for (int i = 0; i < counts[l - 1] && p < 256; i++, p++) {
        int bits = huffcode[p] << (kLook - l);
        for (int k = 0; k < (1 << (kLook - l)); k++)
          if (bits + k < (1 << kLook))
            look[bits + k] = (uint16_t)((l << 8) | huffval[p]);
      }
    }
    defined = true;
  }
};

// Bits of one restart interval (stuffing removed), then zero bits without
// end; `shortfall` is set once a read consumes a bit past the real data.
struct Bits {
  const uint8_t* buf = nullptr;
  size_t nbytes = 0;
  size_t pos = 0;
  bool shortfall = false;

  // the 32 bits from bit `pos` on (zero past the end)
  uint32_t peek32() const {
    const size_t byte = pos >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 5; i++)
      w = (w << 8) | (byte + i < nbytes ? buf[byte + i] : 0u);
    return (uint32_t)(w >> (8 - (pos & 7)));
  }
  void consume(int n) {
    pos += n;
    if (pos > 8 * nbytes) shortfall = true;
  }
  int huff(const Huff& t) {
    uint32_t w = peek32();
    uint16_t e = t.look[w >> (32 - kLook)];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    uint32_t p16 = w >> 16;
    for (int l = 1; l <= 16; l++) {
      int32_t code = (int32_t)(p16 >> (16 - l));
      if (code <= t.maxcode[l]) {
        consume(l);
        return t.huffval[(code + t.valoffset[l]) & 0xFF];
      }
    }
    consume(17);   // no code of 16 bits or fewer: jpeg_huff_decode's 0
    return 0;
  }
  int get(int s) {
    uint32_t r = peek32() >> (32 - s);
    consume(s);
    return (int)r;
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

inline int16_t wrap16(int x) { return (int16_t)(uint16_t)(x & 0xFFFF); }

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

struct Frame {
  int H = 0, W = 0, nc = 0;
  int id[3], h[3], v[3], tq[3];
  int bw[3], bh[3], dw[3], dh[3];
  long off[3];
  long total = 0;
};

void frame_layout(Frame& f) {
  if (f.nc == 1) f.h[0] = f.v[0] = 1;
  int hmax = 1, vmax = 1;
  for (int c = 0; c < f.nc; c++) {
    hmax = f.h[c] > hmax ? f.h[c] : hmax;
    vmax = f.v[c] > vmax ? f.v[c] : vmax;
  }
  int mcux = (f.W + 8 * hmax - 1) / (8 * hmax);
  int mcuy = (f.H + 8 * vmax - 1) / (8 * vmax);
  long off = 0;
  for (int c = 0; c < f.nc; c++) {
    f.bw[c] = mcux * f.h[c];
    f.bh[c] = mcuy * f.v[c];
    f.dw[c] = (f.W * f.h[c] + hmax - 1) / hmax;
    f.dh[c] = (f.H * f.v[c] + vmax - 1) / vmax;
    f.off[c] = off;
    off += (long)f.bw[c] * f.bh[c];
  }
  f.total = off;
}

// The entropy-coded data from pos: stuffing removed into `out`, restart
// intervals delimited in `starts`; returns where the data ends (the 0xFF of
// the marker that ends it, or n).
size_t scan_data(const uint8_t* d, size_t n, size_t pos,
                 std::vector<uint8_t>& out, std::vector<size_t>& starts) {
  out.clear();
  starts.assign(1, 0);
  size_t i = pos;
  while (i < n) {
    uint8_t c = d[i];
    if (c != 0xFF) {
      out.push_back(c);
      i++;
      continue;
    }
    size_t k = i + 1;
    while (k < n && d[k] == 0xFF) k++;
    if (k >= n) return n;
    if (d[k] == 0) {
      out.push_back(0xFF);
      i = k + 1;
    } else if (d[k] >= 0xD0 && d[k] <= 0xD7) {
      starts.push_back(out.size());
      i = k + 1;
    } else {
      return k - 1;
    }
  }
  return n;
}

void decode_scan(const Frame& f, const int* comps, int ns,
                 const Huff* const* dc, const Huff* const* ac, int restart,
                 const std::vector<uint8_t>& data,
                 const std::vector<size_t>& starts, int16_t* coef) {
  int mcus_x, mcus_y;
  if (ns == 1) {
    int c = comps[0];
    mcus_x = (f.dw[c] + 7) / 8;
    mcus_y = (f.dh[c] + 7) / 8;
  } else {
    int hmax = 1, vmax = 1;
    for (int c = 0; c < f.nc; c++) {
      hmax = f.h[c] > hmax ? f.h[c] : hmax;
      vmax = f.v[c] > vmax ? f.v[c] : vmax;
    }
    mcus_x = (f.W + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (f.H + 8 * vmax - 1) / (8 * vmax);
  }
  size_t seg = 0;
  auto open = [&](Bits& b, size_t s) {
    b = Bits();
    if (s >= starts.size()) {
      b.shortfall = true;
      return;
    }
    size_t end = s + 1 < starts.size() ? starts[s + 1] : data.size();
    b.buf = data.data() + starts[s];
    b.nbytes = end - starts[s];
  };
  Bits bits;
  open(bits, 0);
  int pred[3] = {0, 0, 0};
  int left = restart;
  long total = (long)mcus_x * mcus_y;
  for (long mcu = 0; mcu < total; mcu++) {
    if (restart) {
      if (left == 0) {
        open(bits, ++seg);
        pred[0] = pred[1] = pred[2] = 0;
        left = restart;
      }
      left--;
    }
    if (bits.shortfall) continue;
    long my = mcu / mcus_x, mx = mcu % mcus_x;
    for (int j = 0; j < ns; j++) {
      int c = comps[j];
      int nv = ns == 1 ? 1 : f.v[c], nh = ns == 1 ? 1 : f.h[c];
      for (int by = 0; by < nv; by++) {
        for (int bx = 0; bx < nh; bx++) {
          long row = my * nv + by, col = mx * nh + bx;
          int16_t* blk = coef + (f.off[c] + row * f.bw[c] + col) * 64;
          int s = bits.huff(*dc[j]);
          if (s > 16) s = 16;     // a corrupt table's category
          if (s) s = extend(bits.get(s), s);
          pred[c] += s;
          blk[0] = wrap16(pred[c]);
          for (int k = 1; k < 64; k++) {
            int rs = bits.huff(*ac[j]);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = wrap16(extend(bits.get(s), s));
            } else {
              if (r != 15) break;
              k += 15;
            }
          }
        }
      }
    }
  }
}

int parse_jpeg(const uint8_t* d, size_t n, int16_t* coef, long nblocks,
               int32_t* qt_out) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kNotJpeg;
  size_t pos = 2;
  int32_t qtab[4][64];
  bool qdef[4] = {false, false, false, false};
  static thread_local Huff dct[4], act[4];
  for (int i = 0; i < 4; i++) dct[i].defined = act[i].defined = false;
  int restart = 0;
  bool have_frame = false;
  bool latched[3] = {false, false, false};
  Frame f;
  std::vector<uint8_t> data;
  std::vector<size_t> starts;
  while (pos < n) {
    if (d[pos] != 0xFF) {
      pos++;
      continue;
    }
    while (pos < n && d[pos] == 0xFF) pos++;
    if (pos >= n) break;
    int m = d[pos++];
    if (m == 0xD9) break;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (pos + 2 > n) break;
    size_t length = u16(d + pos);
    if (length < 2 || pos + length > n) return kCorrupt;
    const uint8_t* seg = d + pos + 2;
    size_t len = length - 2;
    pos += length;
    if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      if (m != 0xC0 && m != 0xC1) return kUnsupported;
      if (len < 6 || seg[0] != 8) return kUnsupported;
      f.H = u16(seg + 1);
      f.W = u16(seg + 3);
      f.nc = seg[5];
      if (f.H == 0 || f.W == 0 || (f.nc != 1 && f.nc != 3)) return kUnsupported;
      if (len < 6 + 3 * (size_t)f.nc) return kCorrupt;
      for (int c = 0; c < f.nc; c++) {
        f.id[c] = seg[6 + 3 * c];
        f.h[c] = seg[7 + 3 * c] >> 4;
        f.v[c] = seg[7 + 3 * c] & 15;
        f.tq[c] = seg[8 + 3 * c] & 3;
        if (f.h[c] < 1 || f.v[c] < 1) return kCorrupt;
      }
      frame_layout(f);
      if (f.total != nblocks) return kTooSmall;
      memset(coef, 0, sizeof(int16_t) * 64 * (size_t)nblocks);
      have_frame = true;
    } else if (m == 0xDB) {
      size_t i = 0;
      while (i < len) {
        int pq = seg[i] >> 4, tq = seg[i] & 3;
        i++;
        if (i + (pq ? 128 : 64) > len) return kCorrupt;
        for (int k = 0; k < 64; k++) {
          int val = pq ? u16(seg + i + 2 * k) : seg[i + k];
          qtab[tq][kNatural[k]] = val;
        }
        i += pq ? 128 : 64;
        qdef[tq] = true;
      }
    } else if (m == 0xC4) {
      size_t i = 0;
      while (i + 17 <= len) {
        int tc = seg[i] >> 4, th = seg[i] & 3;
        int total = 0;
        for (int k = 0; k < 16; k++) total += seg[i + 1 + k];
        if (i + 17 + total > len) return kCorrupt;
        (tc ? act : dct)[th].build(seg + i + 1, seg + i + 17, total);
        i += 17 + total;
      }
    } else if (m == 0xDD) {
      if (len < 2) return kCorrupt;
      restart = u16(seg);
    } else if (m == 0xDA) {
      if (!have_frame || len < 1) return kCorrupt;
      int ns = seg[0];
      if (ns < 1 || ns > f.nc || len < 1 + 2 * (size_t)ns) return kCorrupt;
      int comps[3];
      const Huff* dcs[3];
      const Huff* acs[3];
      for (int j = 0; j < ns; j++) {
        int cid = seg[1 + 2 * j], t = seg[2 + 2 * j];
        int c = -1;
        for (int k = 0; k < f.nc; k++)
          if (f.id[k] == cid) c = k;
        if (c < 0) return kCorrupt;
        comps[j] = c;
        if (!dct[(t >> 4) & 3].defined || !act[t & 3].defined) return kCorrupt;
        dcs[j] = &dct[(t >> 4) & 3];
        acs[j] = &act[t & 3];
        if (!latched[c]) {
          if (!qdef[f.tq[c]]) return kCorrupt;
          memcpy(qt_out + 64 * c, qtab[f.tq[c]], sizeof(int32_t) * 64);
          latched[c] = true;
        }
      }
      pos = scan_data(d, n, pos, data, starts);
      decode_scan(f, comps, ns, dcs, acs, restart, data, starts, coef);
    }
  }
  if (!have_frame) return kCorrupt;
  for (int c = 0; c < f.nc; c++)
    if (!latched[c]) memset(qt_out + 64 * c, 0, sizeof(int32_t) * 64);
  return kOk;
}

#ifdef __CUDACC__   // the host stages above also build with a C++ compiler
// ---------------------------------------------------------------------------
// Device: dequantize + islow IDCT + upsampling + YCbCr->RGB
// ---------------------------------------------------------------------------

constexpr int kRowTiles = 8;       // tiles across an MCU row
constexpr int kMaxTileMcus = 16;   // MCUs of a tile along x
constexpr int kMinTileRows = 2, kMaxTileRows = 4;   // MCU rows of a tile
constexpr int kFillBlocks = 8 * 132;   // blocks that keep the card full
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 4;     // resident blocks: 32 registers a thread
constexpr int kSlot = 144;         // bytes of a block in shared memory: 8 rows
                                   // of 16, padded to 9 x 16 so that the
                                   // column pass's words meet no bank twice
constexpr int kPad = 8;            // plane columns left of a tile's own
                                   // samples (its left border: kPad - 1)
constexpr int kGroups = 27;        // slot groups: 3 components x 9 kinds

// what a slot needs along one axis of its block: every row (column), or
// only the first or the last one (the edge of a halo block next to the tile)
enum { kEvery = 0, kFirst = 1, kLast = 2 };
// a chroma component's upsampling: none, h2v1 or h2v2
enum { kNone = 0, kH2V1 = 1, kH2V2 = 2 };

struct Geo {
  int H, W, hmax, vmax, total, mcux, mcuy;
  int tx, ty;              // MCUs of a tile along x, MCU rows of a tile
  int h[3], v[3], bw[3], dw[3], dh[3], off[3];
  int upx[3], upy[3];      // fancy upsampling along x / y: a halo is needed
  int box[3];              // libjpeg's box upsampling (plane <= 2 wide)
  // shared memory, byte offsets from the dynamic base: the tables at 0,
  // the slots, a plane per component (8 ty v_c + 2 rows of pitch[c], the
  // tile's samples from column kPad on) and the RGB rows
  int plane[3], pitch[3];
  int slots, stage, stage_pitch;
};

__device__ __forceinline__ int sat16(int x) {
  return min(max(x, -32768), 32767);
}

__device__ __forceinline__ uint32_t to_sample(int x) {
  return (uint32_t)(min(max(x, -128), 127) + 128);
}

__device__ __forceinline__ uint32_t sext16(uint32_t x) {
  return (uint32_t)(int32_t)(int16_t)(uint16_t)x;
}

__device__ __forceinline__ uint32_t hi16(uint32_t x) {
  return (uint32_t)((int32_t)x >> 16);
}

template <int S>
__device__ __forceinline__ int descale(uint32_t v) {
  return (int32_t)(v + (1u << (S - 1))) >> S;
}

// One 8-point pass of jpeg_idct_islow in 32-bit registers, as its even part
// e (tmp10, tmp11, tmp12, tmp13) and odd part o (t3, t2, t1, t0): output k
// is e[k] + o[k], output 7 - k is e[k] - o[k]. The sums are unsigned and
// wrap modulo 2^32; for inputs in [-32768, 32767] every output sum, the
// rounding constant included, lies within 0.935 * 2^31 of zero, so the
// wrapped sum is libjpeg's 64-bit one and only the descale is signed.
__device__ __forceinline__ void idct_even(uint32_t x0, uint32_t x2,
                                          uint32_t x4, uint32_t x6,
                                          uint32_t e[4]) {
  const uint32_t z1 = (x2 + x6) * 4433u;     // FIX_0_541196100
  const uint32_t tmp2 = z1 - x6 * 15137u;    // FIX_1_847759065
  const uint32_t tmp3 = z1 + x2 * 6270u;     // FIX_0_765366865
  const uint32_t tmp0 = (x0 + x4) << 13, tmp1 = (x0 - x4) << 13;
  e[0] = tmp0 + tmp3;
  e[1] = tmp1 + tmp2;
  e[2] = tmp1 - tmp2;
  e[3] = tmp0 - tmp3;
}

__device__ __forceinline__ void idct_odd(uint32_t x1, uint32_t x3,
                                         uint32_t x5, uint32_t x7,
                                         uint32_t o[4]) {
  const uint32_t z5 = (x7 + x3 + x5 + x1) * 9633u;  // FIX_1_175875602
  const uint32_t z1 = (x7 + x1) * (0u - 7373u);     // FIX_0_899976223
  const uint32_t z2 = (x5 + x3) * (0u - 20995u);    // FIX_2_562915447
  const uint32_t z3 = (x7 + x3) * (0u - 16069u) + z5;  // FIX_1_961570560
  const uint32_t z4 = (x5 + x1) * (0u - 3196u) + z5;   // FIX_0_390180644
  o[0] = x1 * 12299u + z1 + z4;              // FIX_1_501321110
  o[1] = x3 * 25172u + z2 + z3;              // FIX_3_072711026
  o[2] = x5 * 16819u + z2 + z4;              // FIX_2_053119869
  o[3] = x7 * 2446u + z1 + z3;               // FIX_0_298631336
}

// Output 0 (first) or 7 (last) of the same pass alone: the sum equals the
// full pass's, modulo 2^32 and so exactly.
__device__ __forceinline__ uint32_t idct_edge(const uint32_t* x, bool last) {
  const uint32_t e = ((x[0] + x[4]) << 13) + (x[2] + x[6]) * 4433u +
                     x[2] * 6270u;
  const uint32_t o = x[1] * 12299u + (x[7] + x[1]) * (0u - 7373u) +
                     (x[5] + x[1]) * (0u - 3196u) +
                     (x[7] + x[3] + x[5] + x[1]) * 9633u;
  return last ? e - o : e + o;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// (row, column) cells of a grid `cols` wide, visited by thread t in steps
// of n: one division on entry, carries after it
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int t, int n, int cols_) : cols(cols_) {
    r = t / cols;
    c = t - r * cols;
    dr = n / cols;
    dc = n - dr * cols;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      r++;
    }
  }
};

// 8 samples from 4-byte-aligned p
__device__ __forceinline__ void load8(const uint8_t* p, int s[8]) {
  const uint32_t a = *(const uint32_t*)p, b = *(const uint32_t*)(p + 4);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    s[k] = (a >> (8 * k)) & 255;
    s[k + 4] = (b >> (8 * k)) & 255;
  }
}

// samples at p[-1 .. 4], p 4-byte aligned
__device__ __forceinline__ void load6(const uint8_t* p, int s[6]) {
  const uint32_t a = *(const uint32_t*)p;
  s[0] = p[-1];
#pragma unroll
  for (int k = 0; k < 4; k++) s[k + 1] = (a >> (8 * k)) & 255;
  s[5] = p[4];
}

// Component c's samples under the 8 pixels (yl, xl .. xl + 7) of the tile,
// upsampled as libjpeg does: jdsample.c h2v1 / h2v2_fancy_upsample (the
// plane's borders hold the halo blocks' edge samples or the replicated
// edge), or box upsampling where the plane is at most 2 samples wide.
template <int K>
__device__ __forceinline__ void upsample8(const Geo& g, const uint8_t* sm,
                                          int c, int yl, int xl, int s[8]) {
  const uint8_t* pl = sm + g.plane[c];
  const int pitch = g.pitch[c];
  if (K == kNone) {
    load8(pl + (yl + 1) * pitch + kPad + xl, s);
    return;
  }
  const int ys = K == kH2V2 ? yl >> 1 : yl;
  const uint8_t* near = pl + (ys + 1) * pitch + kPad + (xl >> 1);
  if (g.box[c]) {
#pragma unroll
    for (int k = 0; k < 8; k++) s[k] = near[k >> 1];
    return;
  }
  int n[6];
  load6(near, n);
  if (K == kH2V1) {
#pragma unroll
    for (int m = 0; m < 4; m++) {
      s[2 * m] = (3 * n[m + 1] + n[m] + 1) >> 2;
      s[2 * m + 1] = (3 * n[m + 1] + n[m + 2] + 2) >> 2;
    }
    return;
  }
  int f[6];
  load6(near + ((yl & 1) ? pitch : -pitch), f);
#pragma unroll
  for (int j = 0; j < 6; j++) n[j] = 3 * n[j] + f[j];  // column sums
#pragma unroll
  for (int m = 0; m < 4; m++) {
    s[2 * m] = (3 * n[m + 1] + n[m] + 8) >> 4;
    s[2 * m + 1] = (3 * n[m + 1] + n[m + 2] + 7) >> 4;
  }
}

__device__ __forceinline__ uint32_t clamp255(int x) {
  return (uint32_t)min(max(x, 0), 255);
}

// jdcolor.c ycc_rgb_convert (SCALEBITS 16): R | G << 8 | B << 16
__device__ __forceinline__ uint32_t ycc_rgb(int y, int cb, int cr) {
  const int xcb = cb - 128, xcr = cr - 128;
  const int r = y + ((91881 * xcr + 32768) >> 16);
  const int gg = y + ((-22554 * xcb + 32768 - 46802 * xcr) >> 16);
  const int b = y + ((116130 * xcb + 32768) >> 16);
  return clamp255(r) | clamp255(gg) << 8 | clamp255(b) << 16;
}

// A tile's slots: the tile's own blocks of each component, then its halo
// blocks: the columns of blocks left and right of the tile (pass 1 in
// full, one sample of each row in pass 2), and the rows of blocks above
// and below it and the four corners (one output of pass 1's columns, that
// row alone in pass 2). They come in 27
// groups: 0-2 the components' own blocks, 3-8 the halo columns (both
// taking every column of pass 1), 9-26 the halo rows and corners (one row
// of it). A warp holds them in its lanes (lane l: group l's first slot,
// component, block offset from the tile's own first block, row width and
// needs), every warp alike, and finds a slot's group by a binary search
// over the lanes.
struct Groups {
  int base, c, dx, dy, w, need;
  int ns;   // slots of the tile
};

__device__ __forceinline__ Groups tile_groups(const Geo& g, int mx0, int ntx,
                                              int my0, int nty, int nc) {
  const int l = threadIdx.x & 31;
  const int kind = l < 3 ? 0 : (l < 9 ? 1 + (l - 3) % 2 : 3 + (l - 9) % 6);
  Groups r;
  r.c = l < 3 ? l : (l < 9 ? (l - 3) / 2 : (l - 9) / 6);
  r.dx = r.dy = r.need = 0;
  r.w = 1;
  int count = 0;
  if (l < kGroups && r.c < nc) {
    const int c = r.c;
    const int nbx = ntx * g.h[c], nby = nty * g.v[c];
    const int sx0 = mx0 * g.h[c] * 8, sy0 = my0 * g.v[c] * 8;
    const bool top = g.upy[c] && sy0 > 0;
    const bool bot = g.upy[c] && sy0 + 8 * nby < g.dh[c];
    const bool left = g.upx[c] && sx0 > 0;
    const bool right = g.upx[c] && sx0 + 8 * nbx < g.dw[c];
    switch (kind) {
      case 0: count = nbx * nby; r.w = nbx; break;
      case 1: count = left ? nby : 0; r.dx = -1; r.need = kLast << 2; break;
      case 2:
        count = right ? nby : 0; r.dx = nbx; r.need = kFirst << 2;
        break;
      case 3:
        count = top ? nbx : 0; r.dy = -1; r.w = nbx; r.need = kLast;
        break;
      case 4:
        count = bot ? nbx : 0; r.dy = nby; r.w = nbx; r.need = kFirst;
        break;
      case 5:
        count = left && top; r.dx = -1; r.dy = -1;
        r.need = kLast | kLast << 2;
        break;
      case 6:
        count = right && top; r.dx = nbx; r.dy = -1;
        r.need = kLast | kFirst << 2;
        break;
      case 7:
        count = left && bot; r.dx = -1; r.dy = nby;
        r.need = kFirst | kLast << 2;
        break;
      default:
        count = right && bot; r.dx = nbx; r.dy = nby;
        r.need = kFirst | kFirst << 2;
        break;
    }
  }
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(~0u, incl, d);
    if (l >= d) incl += o;
  }
  r.base = incl - count;
  r.ns = __shfl_sync(~0u, incl, kGroups - 1);
  return r;
}

// Slot s of the tile (every lane of the warp calls it): its block's index
// in the image, the plane offset of the block's sample (0, 0), and its
// component and needs.
struct Slot {
  int blk, dst, meta;
};

__device__ __forceinline__ Slot slot_at(const Geo& g, const Groups& gr, int s,
                                        int mx0, int my0) {
  int k = 0;   // the last group whose first slot is at most s
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    const int b = __shfl_sync(~0u, gr.base, min(k + step, kGroups - 1));
    if (k + step < kGroups && b <= s) k += step;
  }
  const int c = __shfl_sync(~0u, gr.c, k), w = __shfl_sync(~0u, gr.w, k);
  const int dx = __shfl_sync(~0u, gr.dx, k), dy = __shfl_sync(~0u, gr.dy, k);
  const int idx = s - __shfl_sync(~0u, gr.base, k);
  const int need = __shfl_sync(~0u, gr.need, k);
  const int ry = idx / w;
  const int sdy = dy + ry, sdx = dx + (idx - ry * w);
  Slot r;
  r.blk = g.off[c] + (my0 * g.v[c] + sdy) * g.bw[c] + mx0 * g.h[c] + sdx;
  r.dst = g.plane[c] + (8 * sdy + 1) * g.pitch[c] + kPad + 8 * sdx;
  r.meta = c | need << 2;
  return r;
}

// Shared memory: the images' quantization tables, one block per slot
// (coefficients, then the column pass's output in place), a plane per
// component with a one-sample border, and the tile's RGB rows.
template <int NC, int K1, int K2>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
jpeg_pixels_kernel(const int16_t* __restrict__ coef,
                   const int32_t* __restrict__ qt, uint8_t* __restrict__ out,
                   const __grid_constant__ Geo g) {
  extern __shared__ __align__(16) uint8_t sm[];
  uint8_t* slots = sm + g.slots;
  const int32_t* qs = (const int32_t*)sm;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int img = blockIdx.z, my0 = blockIdx.y * g.ty;
  const int mx0 = blockIdx.x * g.tx;
  const int ntx = min(g.tx, g.mcux - mx0), nty = min(g.ty, g.mcuy - my0);
  const int16_t* cimg = coef + (size_t)img * g.total * 64;

  // The tables and the tile's own blocks first (slots 0 .. nown - 1,
  // component by component, rows of blocks in order), by cp.async in
  // 16-byte pieces, a warp's instruction covering four blocks
  const int n0 = ntx * nty * g.h[0] * g.v[0];
  const int n1 = NC > 1 ? ntx * nty * g.h[1] * g.v[1] : 0;
  const int nown = n0 + n1 + (NC > 2 ? ntx * nty * g.h[2] * g.v[2] : 0);
  for (int i = tid; i < NC * 16; i += nt)
    cp_async16(sm + 16 * i, qt + (size_t)img * NC * 64 + 4 * i);
  for (int i = tid; i < 8 * nown; i += nt) {
    const int s = i >> 3;
    const int c = s < n0 ? 0 : (s < n0 + n1 ? 1 : 2);
    const int idx = s - (c == 0 ? 0 : (c == 1 ? n0 : n0 + n1));
    const int nbx = ntx * g.h[c], dy = idx / nbx;
    const int blk = g.off[c] + (my0 * g.v[c] + dy) * g.bw[c] + mx0 * g.h[c] +
                    idx - dy * nbx;
    cp_async16(slots + s * kSlot + (i & 7) * 16,
               cimg + (size_t)blk * 64 + (i & 7) * 8);
  }
  // then the halo blocks, once the groups say which
  const Groups gr = tile_groups(g, mx0, ntx, my0, nty, NC);
  const int ns = gr.ns;
  for (int base = nown + 32 * warp; base < ns; base += 32 * nwarps) {
    const Slot sl = slot_at(g, gr, base + lane, mx0, my0);
#pragma unroll
    for (int j = 0; j < 8; j++) {
      const int k = 4 * j + (lane >> 3);
      const int blk = __shfl_sync(~0u, sl.blk, k);
      if (base + k < ns)
        cp_async16(slots + (base + k) * kSlot + (lane & 7) * 16,
                   cimg + (size_t)blk * 64 + (lane & 7) * 8);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The transforms, each warp on its own chunks of 8 slots with no block
  // barrier. Pass 1 a lane per (slot, pair of columns): dequantize with the
  // SIMD code's 16-bit wrap, the column pass, saturated to 16 bits, in
  // place. Pass 2 a lane per (slot, row): the row pass, saturated to
  // 0..255, into the component's plane (a halo block: only the row next to
  // the tile, or only its edge sample of each row, into the border).
  for (int chunk = warp; 8 * chunk < ns; chunk += nwarps) {
    const Slot sl = slot_at(g, gr, 8 * chunk + (lane & 7), mx0, my0);
    uint8_t* cs = slots + 8 * chunk * kSlot;
    {
      const int k = lane >> 2, p = lane & 3;
      const int meta = __shfl_sync(~0u, sl.meta, k);
      if (8 * chunk + k < ns) {
        const int c = meta & 3, nr = (meta >> 2) & 3;
        // the pair's two columns one after the other (16-bit stores leave
        // the other column's half of each word as it was)
        const uint32_t* words = (const uint32_t*)(cs + k * kSlot) + p;
        const int32_t* q = qs + c * 64 + 2 * p;
#pragma unroll 1
        for (int half = 0; half < 2; half++) {
          int16_t* col = (int16_t*)(cs + k * kSlot) + 2 * p + half;
          uint32_t x[8];
#pragma unroll
          for (int r = 0; r < 8; r++)
            x[r] = sext16((words[4 * r] >> (16 * half)) *
                          (uint32_t)q[8 * r + half]);
          if (nr == kEvery) {
            uint32_t e[4], o[4];
            idct_even(x[0], x[2], x[4], x[6], e);
            idct_odd(x[1], x[3], x[5], x[7], o);
#pragma unroll
            for (int m = 0; m < 4; m++) {
              col[8 * m] = (int16_t)sat16(descale<11>(e[m] + o[m]));
              col[8 * (7 - m)] = (int16_t)sat16(descale<11>(e[m] - o[m]));
            }
          } else {
            const bool last = nr == kLast;
            col[8 * (last ? 7 : 0)] =
                (int16_t)sat16(descale<11>(idct_edge(x, last)));
          }
        }
      }
    }
    __syncwarp();
#pragma unroll 1
    for (int j = 0; j < 2; j++) {
      const int k = (lane >> 3) + 4 * j, r = lane & 7;
      const int meta = __shfl_sync(~0u, sl.meta, k);
      const int dsto = __shfl_sync(~0u, sl.dst, k);
      const int nr = (meta >> 2) & 3, ncol = (meta >> 4) & 3;
      if (8 * chunk + k >= ns ||
          (nr != kEvery && r != (nr == kFirst ? 0 : 7)))
        continue;
      const uint4 wv = *(const uint4*)(cs + k * kSlot + r * 16);
      const uint32_t xs[8] = {sext16(wv.x), hi16(wv.x), sext16(wv.y),
                              hi16(wv.y), sext16(wv.z), hi16(wv.z),
                              sext16(wv.w), hi16(wv.w)};
      const int c = meta & 3;
      const int at = dsto + r * g.pitch[c];
      if (ncol == kEvery) {
        uint32_t e[4], o[4];
        idct_even(xs[0], xs[2], xs[4], xs[6], e);
        idct_odd(xs[1], xs[3], xs[5], xs[7], o);
        uint32_t v[8];
#pragma unroll
        for (int m = 0; m < 4; m++) {
          v[m] = to_sample(descale<18>(e[m] + o[m]));
          v[7 - m] = to_sample(descale<18>(e[m] - o[m]));
        }
        *(uint2*)(sm + at) =
            make_uint2(v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24,
                       v[4] | v[5] << 8 | v[6] << 16 | v[7] << 24);
      } else {
        const bool last = ncol == kLast;
        sm[at + (last ? 7 : 0)] =
            (uint8_t)to_sample(descale<18>(idct_edge(xs, last)));
      }
    }
  }
  __syncthreads();

  // Edge replication: the plane's samples past the image's real ones (the
  // left and top border at the image's edge, the column dw and the row dh)
  // take the nearest real sample, as libjpeg's clamped neighbours do
  bool fixed = false;
#pragma unroll
  for (int c = 1; c < NC; c++) {
    if (!(g.upx[c] || g.upy[c])) continue;
    const int ow = ntx * g.h[c] * 8, oh = 8 * nty * g.v[c];
    const int pitch = g.pitch[c];
    const int sx0 = mx0 * g.h[c] * 8, sy0 = my0 * g.v[c] * 8;
    const int fl = g.upx[c] && sx0 == 0 ? -1 : -2;
    const int fr = g.upx[c] && g.dw[c] - sx0 <= ow ? g.dw[c] - sx0 : -2;
    const int ft = g.upy[c] && sy0 == 0 ? -1 : -2;
    const int fb = g.upy[c] && g.dh[c] - sy0 <= oh ? g.dh[c] - sy0 : -2;
    if (fl == -2 && fr == -2 && ft == -2 && fb == -2) continue;
    fixed = true;
    uint8_t* pl = sm + g.plane[c] + pitch + kPad;   // sample (0, 0)
    const int ncols = 2 * (oh + 2);
    for (int i = tid; i < ncols + 2 * (ow + 2); i += nt) {
      int row, cc;
      if (i < ncols) {
        cc = (i & 1) ? fr : fl;
        row = (i >> 1) - 1;
        if (cc == -2) continue;
      } else {
        row = ((i - ncols) & 1) ? fb : ft;
        cc = ((i - ncols) >> 1) - 1;
        if (row == -2) continue;
      }
      const int sr = row == ft ? 0 : (row == fb ? fb - 1 : row);
      const int sc = cc == fl ? 0 : (cc == fr ? fr - 1 : cc);
      pl[row * pitch + cc] = pl[sr * pitch + sc];
    }
  }
  if (fixed) __syncthreads();

  // Pixels, a thread per 8 of a row: luma, the chroma upsampled, the colour
  // conversion, 24 bytes into the tile's RGB rows
  const int tw = ntx * 8 * g.hmax, th = 8 * nty * g.vmax;
  const int X0 = mx0 * 8 * g.hmax, Y0 = my0 * 8 * g.vmax;
  {
    for (Walk it(tid, nt, tw >> 3); it.r < th; it.next()) {
      const int yl = it.r, xl = it.c * 8;
      if (Y0 + yl >= g.H || X0 + xl >= g.W) continue;
      int y[8];
      load8(sm + g.plane[0] + (yl + 1) * g.pitch[0] + kPad + xl, y);
      uint32_t px[8];
      if (NC == 1) {
#pragma unroll
        for (int k = 0; k < 8; k++) px[k] = (uint32_t)y[k] * 0x010101u;
      } else {
        int cb[8], cr[8];
        upsample8<K1>(g, sm, 1, yl, xl, cb);
        upsample8<K2>(g, sm, 2, yl, xl, cr);
#pragma unroll
        for (int k = 0; k < 8; k++) px[k] = ycc_rgb(y[k], cb[k], cr[k]);
      }
      uint2* st = (uint2*)(sm + g.stage + yl * g.stage_pitch + 3 * xl);
      st[0] = make_uint2(__byte_perm(px[0], px[1], 0x4210),
                         __byte_perm(px[1], px[2], 0x5421));
      st[1] = make_uint2(__byte_perm(px[2], px[3], 0x6542),
                         __byte_perm(px[4], px[5], 0x4210));
      st[2] = make_uint2(__byte_perm(px[5], px[6], 0x5421),
                         __byte_perm(px[6], px[7], 0x6542));
    }
  }
  __syncthreads();

  // The RGB rows to device memory: 16-byte stores on 16-byte boundaries
  // (the staged bytes shifted into place), single bytes before the first
  // boundary and after the last
  {
    const int rows = min(th, g.H - Y0), nbytes = min(tw, g.W - X0) * 3;
    uint8_t* oimg = out + (size_t)img * g.H * g.W * 3;
    for (Walk it(tid, nt, (nbytes >> 4) + 1); it.r < rows; it.next()) {
      uint8_t* gd = oimg + ((size_t)(Y0 + it.r) * g.W + X0) * 3;
      const uint8_t* sr = sm + g.stage + it.r * g.stage_pitch;
      const int head =
          min((int)((16 - ((uintptr_t)gd & 15)) & 15), nbytes);
      const int body = (nbytes - head) >> 4;
      if (it.c < body) {
        const int so = head + 16 * it.c, sh = (so & 3) * 8;
        const uint32_t* w = (const uint32_t*)(sr + (so & ~3));
        uint4 v;
        v.x = __funnelshift_r(w[0], w[1], sh);
        v.y = __funnelshift_r(w[1], w[2], sh);
        v.z = __funnelshift_r(w[2], w[3], sh);
        v.w = __funnelshift_r(w[3], w[4], sh);
        *(uint4*)(gd + so) = v;
      } else if (it.c == body) {
        for (int b = 0; b < head; b++) gd[b] = sr[b];
        for (int b = head + 16 * body; b < nbytes; b++) gd[b] = sr[b];
      }
    }
  }
}

#endif  // __CUDACC__

}  // namespace

// Entropy-decode a JPEG held in memory (data, n bytes) into coef int16
// [nblocks, 64] (natural order, component planes padded to whole MCUs,
// row-major blocks, component 0 first) and qt int32 [nc, 64] (natural
// order). Returns 0, or -1 not a JPEG, -2 unsupported (SOF type,
// precision, component count), -3 corrupt headers, -4 nblocks does not
// match the frame. Host code; thread-safe.
extern "C" int pvnet_jpeg_entropy_decode(const uint8_t* data, size_t n,
                                         int16_t* coef, int nblocks,
                                         int32_t* qt) {
  return parse_jpeg(data, n, coef, nblocks, qt);
}

// Undo PNG filters 0-4 of `height` rows of 1 + row_bytes bytes in raw
// (n bytes) into out [height, row_bytes]; bpp bytes per complete pixel
// (at least 1). Returns 0, -1 if raw is too short, -2 on a filter type
// above 4. Host code; thread-safe.
extern "C" int pvnet_png_unfilter(const uint8_t* raw, size_t n, int height,
                                  int row_bytes, int bpp, uint8_t* out) {
  const size_t stride = (size_t)row_bytes + 1;
  if (n < stride * (size_t)height) return -1;
  for (int y = 0; y < height; y++) {
    const uint8_t* cur = raw + y * stride + 1;
    const int ftype = raw[y * stride];
    uint8_t* o = out + (size_t)y * row_bytes;
    const uint8_t* up = y ? o - row_bytes : nullptr;
    for (int i = 0; i < row_bytes; i++) {
      const int a = i >= bpp ? o[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = (up && i >= bpp) ? up[i - bpp] : 0;
      int pred;
      switch (ftype) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -2;
      }
      o[i] = (uint8_t)(cur[i] + pred);
    }
  }
  return 0;
}

#ifdef __CUDACC__
namespace {

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// jpeg_pixels_kernel for the component count and the two chroma
// components' upsampling
const void* pick_kernel(int nc, int k1, int k2) {
  static const void* const kKernels[9] = {
      (const void*)jpeg_pixels_kernel<3, kNone, kNone>,
      (const void*)jpeg_pixels_kernel<3, kNone, kH2V1>,
      (const void*)jpeg_pixels_kernel<3, kNone, kH2V2>,
      (const void*)jpeg_pixels_kernel<3, kH2V1, kNone>,
      (const void*)jpeg_pixels_kernel<3, kH2V1, kH2V1>,
      (const void*)jpeg_pixels_kernel<3, kH2V1, kH2V2>,
      (const void*)jpeg_pixels_kernel<3, kH2V2, kNone>,
      (const void*)jpeg_pixels_kernel<3, kH2V2, kH2V1>,
      (const void*)jpeg_pixels_kernel<3, kH2V2, kH2V2>};
  if (nc == 1) return (const void*)jpeg_pixels_kernel<1, kNone, kNone>;
  return kKernels[3 * k1 + k2];
}

}  // namespace

// coef int16 [B, total, 64] and qt int32 [B, nc, 64], both 16-byte
// aligned -> out uint8 [B, H, W, 3], images of one geometry: nc 1 or 3,
// component 0
// with the largest sampling factors (at most 2), each other component's
// ratio to it 1x1, 2x1 or 2x2. Returns cudaErrorInvalidValue for anything
// else (and for B outside 1..65535), else the launch's error code.
//
// The launch plan (data/image_io.py's tile_blocks mirrors it): a tile is
// tx = min(ceil(mcux / 8), 16) MCUs wide and ty MCU rows tall, ty 2, or 4
// where that still leaves 8 x 132 blocks or more; a warp for each 8 slots
// of the largest tile or each 32 groups of 8 pixels, whichever are more,
// 2 to 16.
extern "C" int pvnet_jpeg_pixels(const int16_t* coef, const int32_t* qt,
                                 uint8_t* out, int B, int H, int W, int nc,
                                 int h0, int v0, int h1, int v1, int h2,
                                 int v2, cudaStream_t stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || H < 1 || W < 1 || (nc != 1 && nc != 3))
    return bad;
  Geo g = {};
  g.H = H;
  g.W = W;
  const int hs[3] = {h0, h1, h2}, vs[3] = {v0, v1, v2};
  g.hmax = g.vmax = 1;
  for (int c = 0; c < nc; c++) {
    if (hs[c] < 1 || vs[c] < 1) return bad;
    g.h[c] = hs[c];
    g.v[c] = vs[c];
    g.hmax = hs[c] > g.hmax ? hs[c] : g.hmax;
    g.vmax = vs[c] > g.vmax ? vs[c] : g.vmax;
  }
  if (g.h[0] != g.hmax || g.v[0] != g.vmax || g.hmax > 2 || g.vmax > 2)
    return bad;
  g.mcux = (W + 8 * g.hmax - 1) / (8 * g.hmax);
  const int mcuy = (H + 8 * g.vmax - 1) / (8 * g.vmax);
  g.mcuy = mcuy;
  int kind[3] = {kNone, kNone, kNone};
  for (int c = 0; c < nc; c++) {
    g.bw[c] = g.mcux * g.h[c];
    g.dw[c] = (W * g.h[c] + g.hmax - 1) / g.hmax;
    g.dh[c] = (H * g.v[c] + g.vmax - 1) / g.vmax;
    g.off[c] = g.total;
    g.total += g.bw[c] * mcuy * g.v[c];
    const int rx = g.hmax / g.h[c], ry = g.vmax / g.v[c];
    if (g.hmax % g.h[c] || g.vmax % g.v[c]) return bad;
    if (rx == 2) kind[c] = ry == 1 ? kH2V1 : kH2V2;
    else if (ry != 1) return bad;
    g.box[c] = kind[c] != kNone && g.dw[c] <= 2;
    g.upx[c] = kind[c] != kNone && !g.box[c];
    g.upy[c] = kind[c] == kH2V2 && !g.box[c];
  }
  g.tx = (g.mcux + kRowTiles - 1) / kRowTiles;
  if (g.tx > kMaxTileMcus) g.tx = kMaxTileMcus;
  const int gx = (g.mcux + g.tx - 1) / g.tx;
  // MCU rows of a tile: kMinTileRows, doubled while kFillBlocks blocks or
  // more remain (up to kMaxTileRows)
  g.ty = kMinTileRows;
  while (2 * g.ty <= kMaxTileRows &&
         (long)gx * ((mcuy + 2 * g.ty - 1) / (2 * g.ty)) * B >= kFillBlocks)
    g.ty *= 2;
  // slots of the largest tile, halo columns and corners on both sides
  int slots = 0;
  for (int c = 0; c < nc; c++) {
    const int own = g.tx * g.ty * g.h[c] * g.v[c];
    const int cols = g.upx[c] ? 2 * g.ty * g.v[c] : 0;
    const int edge = (g.upy[c] ? 2 * g.tx * g.h[c] : 0) +
                     (g.upx[c] && g.upy[c] ? 4 : 0);
    slots += own + cols + edge;
  }
  const int groups8 = 8 * g.ty * g.vmax * g.tx * g.hmax;   // groups of 8
  int warps = (slots + 7) / 8 > (groups8 + 31) / 32 ? (slots + 7) / 8
                                                    : (groups8 + 31) / 32;
  warps = warps < 2 ? 2 : (warps > kMaxThreads / 32 ? kMaxThreads / 32 : warps);
  const int threads = 32 * warps;
  int at = round_up(nc * 64 * 4, 16);   // the tables
  g.slots = at;
  at += kSlot * 8 * ((slots + 7) / 8);
  for (int c = 0; c < nc; c++) {
    g.pitch[c] = round_up(kPad + g.tx * g.h[c] * 8 + 1, 8);
    g.plane[c] = at;
    at += round_up((8 * g.ty * g.v[c] + 2) * g.pitch[c], 16);
  }
  g.stage_pitch = round_up(3 * g.tx * 8 * g.hmax, 16) + 16;
  g.stage = at;
  at += 8 * g.ty * g.vmax * g.stage_pitch;
  const int smem = at;

  const void* fn = pick_kernel(nc, kind[1], kind[2]);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {(void*)&coef, (void*)&qt, (void*)&out, (void*)&g};
  err = cudaLaunchKernel(fn, dim3(gx, (mcuy + g.ty - 1) / g.ty, B),
                         dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
