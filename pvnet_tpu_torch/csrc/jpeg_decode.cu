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
// What bounds the kernel on the H100: device-memory bytes in principle
// (int16 coefficients in, 2 bytes a coefficient; uint8 RGB out; at
// 480x640 4:2:0 0.92 MB each way, ~0.55 us a frame at 3.35 TB/s), but this
// first kernel is simple and exact rather than fast: it keeps libjpeg's
// 64-bit intermediates (JLONG) and recomputes the chroma blocks of a
// one-block halo around each tile, so it is bound by its integer
// instructions.
//
// Design: a thread block owns a tile of 4x4 MCUs of one image (64x64
// pixels at 4:2:0). It IDCTs the tile's blocks of every component, plus a
// ring of one block around the tile for each component that is
// upsampled (the triangle filter reads one sample beyond the tile on each
// side), in two passes through shared memory: pass 1 one thread per
// (block, column), pass 2 one thread per (block, row) writing uint8
// samples into a shared plane per component. Then each thread takes
// pixels of the tile: the luma sample, the chroma samples upsampled with
// libjpeg's biases (edges replicated by clamping the sample coordinates
// to the component's real samples), the colour conversion, and three
// bytes written to the output.
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

constexpr int kTileMcu = 4;     // a tile is kTileMcu x kTileMcu MCUs
constexpr int kMaxBlocks = 136; // 4:2:0: 64 luma + 2 x 36 chroma with halo
constexpr int kPlane = 64 * 64; // bytes of one component's tile plane
constexpr int kThreads = 256;

// jidctint.c's constants (CONST_BITS 13, PASS1_BITS 2)
constexpr long long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                    F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                    F1961 = 16069, F2053 = 16819, F2562 = 20995,
                    F3072 = 25172;

struct Geo {
  int H, W, nc, hmax, vmax, total;
  int h[3], v[3], bw[3], bh[3], dw[3], dh[3], off[3];
};

// One 8-point pass of jpeg_idct_islow on x[0..7] (stride `s`), descaled
// by `shift`, into o[0..7].
__device__ __forceinline__ void idct8(const long long* x, long long* o,
                                      int shift) {
  long long z2 = x[2], z3 = x[6];
  long long z1 = (z2 + z3) * F0541;
  long long tmp2 = z1 + z3 * -F1847;
  long long tmp3 = z1 + z2 * F0765;
  long long tmp0 = (x[0] + x[4]) * 8192;   // << CONST_BITS
  long long tmp1 = (x[0] - x[4]) * 8192;
  long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  long long t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  long long a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  long long z5 = (a3 + a4) * F1175;
  t0 *= F0298;
  t1 *= F2053;
  t2 *= F3072;
  t3 *= F1501;
  a1 *= -F0899;
  a2 *= -F2562;
  a3 = a3 * -F1961 + z5;
  a4 = a4 * -F0390 + z5;
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  const long long rnd = 1LL << (shift - 1);
  o[0] = (tmp10 + t3 + rnd) >> shift;
  o[7] = (tmp10 - t3 + rnd) >> shift;
  o[1] = (tmp11 + t2 + rnd) >> shift;
  o[6] = (tmp11 - t2 + rnd) >> shift;
  o[2] = (tmp12 + t1 + rnd) >> shift;
  o[5] = (tmp12 - t1 + rnd) >> shift;
  o[3] = (tmp13 + t0 + rnd) >> shift;
  o[4] = (tmp13 - t0 + rnd) >> shift;
}

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
jpeg_pixels_kernel(const int16_t* __restrict__ coef,
                   const int32_t* __restrict__ qt, uint8_t* __restrict__ out,
                   Geo g) {
  __shared__ int32_t ws[kMaxBlocks * 64];
  __shared__ uint8_t plane[3][kPlane];
  const int img = blockIdx.z;
  // per component: the tile's nominal block origin (a halo block may lie
  // outside the plane), its size in blocks, and its first block in the
  // flat list
  int ox[3], oy[3], nx[3], ny[3], base[3];
  int nblk = 0;
  for (int c = 0; c < g.nc; c++) {
    int hx = g.hmax / g.h[c] > 1 ? 1 : 0, hy = g.vmax / g.v[c] > 1 ? 1 : 0;
    ox[c] = blockIdx.x * kTileMcu * g.h[c] - hx;
    oy[c] = blockIdx.y * kTileMcu * g.v[c] - hy;
    nx[c] = kTileMcu * g.h[c] + 2 * hx;
    ny[c] = kTileMcu * g.v[c] + 2 * hy;
    base[c] = nblk;
    nblk += nx[c] * ny[c];
  }
  const int16_t* cimg = coef + (size_t)img * g.total * 64;
  const int32_t* qimg = qt + (size_t)img * g.nc * 64;

  // pass 1: one thread per (block, column), dequantized with the SIMD
  // code's 16-bit wrap, output saturated to 16 bits
  for (int item = threadIdx.x; item < nblk * 8; item += blockDim.x) {
    int b = item >> 3, col = item & 7;
    int c = g.nc - 1;
    while (b < base[c]) c--;
    int lb = b - base[c];
    int gbx = ox[c] + lb % nx[c], gby = oy[c] + lb / nx[c];
    if (gbx < 0 || gby < 0 || gbx >= g.bw[c] || gby >= g.bh[c]) continue;
    const int16_t* blk =
        cimg + ((size_t)g.off[c] + (size_t)gby * g.bw[c] + gbx) * 64;
    long long x[8], o[8];
#pragma unroll
    for (int r = 0; r < 8; r++) {
      int dq = (int)blk[r * 8 + col] * qimg[c * 64 + r * 8 + col];
      x[r] = (long long)(int16_t)(uint16_t)(dq & 0xFFFF);
    }
    idct8(x, o, 11);
#pragma unroll
    for (int r = 0; r < 8; r++)
      ws[b * 64 + r * 8 + col] = (int32_t)clampll(o[r], -32768, 32767);
  }
  __syncthreads();

  // pass 2: one thread per (block, row), output saturated to 0..255
  for (int item = threadIdx.x; item < nblk * 8; item += blockDim.x) {
    int b = item >> 3, row = item & 7;
    int c = g.nc - 1;
    while (b < base[c]) c--;
    int lb = b - base[c];
    int lbx = lb % nx[c], lby = lb / nx[c];
    int gbx = ox[c] + lbx, gby = oy[c] + lby;
    if (gbx < 0 || gby < 0 || gbx >= g.bw[c] || gby >= g.bh[c]) continue;
    long long x[8], o[8];
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = ws[b * 64 + row * 8 + k];
    idct8(x, o, 18);
    uint8_t* dst = plane[c] + (lby * 8 + row) * (nx[c] * 8) + lbx * 8;
#pragma unroll
    for (int k = 0; k < 8; k++)
      dst[k] = (uint8_t)(clampll(o[k], -128, 127) + 128);
  }
  __syncthreads();

  // pixels: upsample (edges replicated by clamping to the real samples)
  // and convert
  const int tw = kTileMcu * 8 * g.hmax, th = kTileMcu * 8 * g.vmax;
  const int px0 = blockIdx.x * tw, py0 = blockIdx.y * th;
  uint8_t* oimg = out + (size_t)img * g.H * g.W * 3;
  for (int p = threadIdx.x; p < tw * th; p += blockDim.x) {
    int X = px0 + p % tw, Y = py0 + p / tw;
    if (X >= g.W || Y >= g.H) continue;
    int s[3];
    for (int c = 0; c < g.nc; c++) {
      const uint8_t* pl = plane[c];
      const int pw = nx[c] * 8, sx0 = ox[c] * 8, sy0 = oy[c] * 8;
      const int rx = g.hmax / g.h[c], ry = g.vmax / g.v[c];
#define SAMPLE(yy, xx) ((int)pl[((yy) - sy0) * pw + ((xx) - sx0)])
      if (rx == 1 && ry == 1) {
        s[c] = SAMPLE(Y, X);
      } else if (g.dw[c] <= 2) {              // libjpeg's box upsampling
        s[c] = SAMPLE(Y / ry, X / rx);
      } else {
        const int xn = X >> 1, xodd = X & 1;
        const int xf = clampi(xodd ? xn + 1 : xn - 1, 0, g.dw[c] - 1);
        if (ry == 1) {                        // h2v1_fancy_upsample
          s[c] = (3 * SAMPLE(Y, xn) + SAMPLE(Y, xf) + 1 + xodd) >> 2;
        } else {                              // h2v2_fancy_upsample
          const int yn = Y >> 1, yodd = Y & 1;
          const int yf = clampi(yodd ? yn + 1 : yn - 1, 0, g.dh[c] - 1);
          const int cn = 3 * SAMPLE(yn, xn) + SAMPLE(yf, xn);
          const int cf = 3 * SAMPLE(yn, xf) + SAMPLE(yf, xf);
          s[c] = (3 * cn + cf + 8 - xodd) >> 4;
        }
      }
#undef SAMPLE
    }
    uint8_t* o = oimg + ((size_t)Y * g.W + X) * 3;
    if (g.nc == 1) {
      o[0] = o[1] = o[2] = (uint8_t)s[0];
      continue;
    }
    // jdcolor.c ycc_rgb_convert (SCALEBITS 16)
    const int y = s[0], xcb = s[1] - 128, xcr = s[2] - 128;
    const int r = y + ((91881 * xcr + 32768) >> 16);
    const int gg = y + ((-22554 * xcb + 32768 - 46802 * xcr) >> 16);
    const int b = y + ((116130 * xcb + 32768) >> 16);
    o[0] = (uint8_t)clampi(r, 0, 255);
    o[1] = (uint8_t)clampi(gg, 0, 255);
    o[2] = (uint8_t)clampi(b, 0, 255);
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
// coef int16 [B, total, 64], qt int32 [B, nc, 64] -> out uint8
// [B, H, W, 3], images of one geometry (nc 1 or 3; per component sampling
// factors h_c, v_c with component 0 the largest and ratios 1x1, 2x1 or
// 2x2, checked by the wrapper).
extern "C" int pvnet_jpeg_pixels(const int16_t* coef, const int32_t* qt,
                                 uint8_t* out, int B, int H, int W, int nc,
                                 int h0, int v0, int h1, int v1, int h2,
                                 int v2, cudaStream_t stream) {
  Geo g;
  g.H = H;
  g.W = W;
  g.nc = nc;
  const int hs[3] = {h0, h1, h2}, vs[3] = {v0, v1, v2};
  g.hmax = g.vmax = 1;
  for (int c = 0; c < nc; c++) {
    g.h[c] = hs[c];
    g.v[c] = vs[c];
    g.hmax = hs[c] > g.hmax ? hs[c] : g.hmax;
    g.vmax = vs[c] > g.vmax ? vs[c] : g.vmax;
  }
  if (g.hmax > 2 || g.vmax > 2) return (int)cudaErrorInvalidValue;
  const int mcux = (W + 8 * g.hmax - 1) / (8 * g.hmax);
  const int mcuy = (H + 8 * g.vmax - 1) / (8 * g.vmax);
  int off = 0;
  for (int c = 0; c < nc; c++) {
    g.bw[c] = mcux * g.h[c];
    g.bh[c] = mcuy * g.v[c];
    g.dw[c] = (W * g.h[c] + g.hmax - 1) / g.hmax;
    g.dh[c] = (H * g.v[c] + g.vmax - 1) / g.vmax;
    g.off[c] = off;
    off += g.bw[c] * g.bh[c];
  }
  g.total = off;
  int nblk = 0;
  for (int c = 0; c < nc; c++)
    nblk += (kTileMcu * g.h[c] + (g.hmax > g.h[c] ? 2 : 0)) *
            (kTileMcu * g.v[c] + (g.vmax > g.v[c] ? 2 : 0));
  if (nblk > kMaxBlocks) return (int)cudaErrorInvalidValue;
  dim3 grid((mcux + kTileMcu - 1) / kTileMcu, (mcuy + kTileMcu - 1) / kTileMcu,
            B);
  jpeg_pixels_kernel<<<grid, kThreads, 0, stream>>>(coef, qt, out, g);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__
