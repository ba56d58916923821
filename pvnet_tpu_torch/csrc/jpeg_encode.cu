// Baseline JPEG encoding for the port's dataset preparation: host code
// with a plain C interface (no device code; it sits in csrc/ so that the
// kernel build compiles and links it with the decoder).
//
// Replaces: no TPU kernel. The JAX package writes its generated frames
// with PIL (Image.fromarray(rgb).save(path) for a .jpg: libjpeg-turbo with
// its defaults), which the GPU host does not have. The output is that
// file byte for byte: SOI, the JFIF APP0 header (version 1.01, no
// density unit, 1x1), quality 75 on libjpeg's standard tables, one DQT
// per table, SOF0, one DHT per standard Huffman table, one interleaved
// scan, EOI. The arithmetic is libjpeg-turbo's:
//  - jccolor.c rgb_ycc_convert (SCALEBITS 16, Cb and Cr rounded with
//    ONE_HALF - 1);
//  - the prep controller's edge replication and jcsample.c
//    h2v2_downsample (bias 1, 2, 1, 2, ... along a row) for 4:2:0;
//  - jfdctint.c jpeg_fdct_islow (CONST_BITS 13, PASS1_BITS 2);
//  - jcdctmgr.c quantization by reciprocal (compute_reciprocal: divisor
//    8 * q, a reciprocal, a correction and a shift);
//  - jccoefct.c's dummy blocks past the right and bottom edges of the
//    luma plane (zero AC, DC copied from the block before);
//  - jchuff.c's encoding with the standard tables, and the final byte
//    padded with 1 bits.
// data/image_io.py holds the plain numpy version of the same steps.
#include <stdint.h>
#include <string.h>

#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kStdQuant[2][64] = {
    {16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

const uint8_t kDcBits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// jfdctint.c's constants (CONST_BITS 13)
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

// jccolor.c's fixed-point weights (SCALEBITS 16)
constexpr int64_t kOneHalf = 1 << 15, kCbCrOffset = (int64_t)128 << 16;
constexpr int64_t kRY = 19595, kGY = 38470, kBY = 7471, kRCb = 11059,
                  kGCb = 21709, kBCb = 32768, kGCr = 27439, kBCr = 5329;

struct Huff {
  uint16_t code[256];
  uint8_t size[256];
};

void build_huff(const uint8_t* bits, const uint8_t* vals, Huff* h) {
  memset(h, 0, sizeof(*h));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    for (int i = 0; i < bits[len - 1]; i++, k++) {
      h->code[vals[k]] = (uint16_t)code++;
      h->size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

// jcdctmgr.c compute_reciprocal for a 16-bit DCTELEM: the quotient of
// x by `divisor`, rounded, is ((x + corr) * recip) >> shift
struct Divisor {
  int64_t recip, corr;
  int shift;
};

Divisor reciprocal(int divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) b++;
  int r = 16 + b;
  int64_t fq = ((int64_t)1 << r) / divisor;
  const int64_t fr = ((int64_t)1 << r) % divisor;
  int64_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// One 8-point pass of jpeg_fdct_islow over d[0], d[s], ..., d[7s]
void fdct_pass(int64_t* d, int s, bool first) {
  const int64_t t0 = d[0] + d[7 * s], t7 = d[0] - d[7 * s];
  const int64_t t1 = d[s] + d[6 * s], t6 = d[s] - d[6 * s];
  const int64_t t2 = d[2 * s] + d[5 * s], t5 = d[2 * s] - d[5 * s];
  const int64_t t3 = d[3 * s] + d[4 * s], t4 = d[3 * s] - d[4 * s];
  const int64_t t10 = t0 + t3, t13 = t0 - t3;
  const int64_t t11 = t1 + t2, t12 = t1 - t2;
  int n;
  if (first) {
    d[0] = (t10 + t11) * (1 << kPass1Bits);
    d[4 * s] = (t10 - t11) * (1 << kPass1Bits);
    n = kConstBits - kPass1Bits;
  } else {
    d[0] = descale(t10 + t11, kPass1Bits);
    d[4 * s] = descale(t10 - t11, kPass1Bits);
    n = kConstBits + kPass1Bits;
  }
  int64_t z1 = (t12 + t13) * F0541;
  d[2 * s] = descale(z1 + t13 * F0765, n);
  d[6 * s] = descale(z1 - t12 * F1847, n);
  z1 = t4 + t7;
  int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
  const int64_t z5 = (z3 + z4) * F1175;
  const int64_t a4 = t4 * F0298, a5 = t5 * F2053, a6 = t6 * F3072,
                a7 = t7 * F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 = z3 * -F1961 + z5;
  z4 = z4 * -F0390 + z5;
  d[7 * s] = descale(a4 + z1 + z3, n);
  d[5 * s] = descale(a5 + z2 + z4, n);
  d[3 * s] = descale(a6 + z2 + z3, n);
  d[s] = descale(a7 + z1 + z4, n);
}

// FDCT and quantization of the 8x8 block at (bx, by) of a padded plane
// (stride `w`); writes the quantized coefficients in natural order
void transform_block(const std::vector<int16_t>& plane, int w, int by,
                     int bx, const Divisor* div, int32_t* q) {
  int64_t d[64];
  for (int r = 0; r < 8; r++)
    for (int c = 0; c < 8; c++)
      d[r * 8 + c] = plane[(size_t)(by * 8 + r) * w + bx * 8 + c] - 128;
  for (int r = 0; r < 8; r++) fdct_pass(d + r * 8, 1, true);
  for (int c = 0; c < 8; c++) fdct_pass(d + c, 8, false);
  for (int i = 0; i < 64; i++) {
    const int64_t x = d[i];
    const int64_t t = x < 0 ? -x : x;
    const int64_t v = ((t + div[i].corr) * div[i].recip) >> div[i].shift;
    q[i] = (int32_t)(x < 0 ? -v : v);
  }
}

struct Writer {
  uint8_t* out;
  long cap, n = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool full = false;

  void byte(uint8_t b) {
    if (n < cap) out[n] = b;
    else full = true;
    n++;
  }
  void bytes(const uint8_t* p, int len) {
    for (int i = 0; i < len; i++) byte(p[i]);
  }
  void u16(int v) {
    byte((uint8_t)(v >> 8));
    byte((uint8_t)v);
  }
  void marker(int m, int len) {
    byte(0xFF);
    byte((uint8_t)m);
    u16(len + 2);
  }
  // entropy-coded bits, with a 0x00 stuffed after every 0xFF
  void bits(uint32_t v, int size) {
    if (size == 0) return;
    acc = (acc << size) | (v & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      const uint8_t b = (uint8_t)(acc >> (nbits - 8));
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits % 8) bits(0x7F, 8 - nbits % 8);
  }
};

int nbits_of(int32_t v) {
  uint32_t a = v < 0 ? -v : v;
  int n = 0;
  while (a) {
    n++;
    a >>= 1;
  }
  return n;
}

void encode_block(Writer& w, const int32_t* q, int dc_pred, const Huff& dc,
                  const Huff& ac) {
  int32_t diff = q[0] - dc_pred;
  int nb = nbits_of(diff);
  w.bits(dc.code[nb], dc.size[nb]);
  w.bits((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    const int32_t v = q[kZigzag[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    nb = nbits_of(v);
    const int sym = (run << 4) | nb;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits((uint32_t)(v < 0 ? v - 1 : v), nb);
    run = 0;
  }
  if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

// A plane of `h` x `w` samples padded by replicating its last column and
// row to `ph` x `pw`
void replicate_edges(std::vector<int16_t>& p, int h, int w, int ph, int pw) {
  for (int y = 0; y < h; y++)
    for (int x = w; x < pw; x++)
      p[(size_t)y * pw + x] = p[(size_t)y * pw + w - 1];
  for (int y = h; y < ph; y++)
    memcpy(&p[(size_t)y * pw], &p[(size_t)(h - 1) * pw], pw * sizeof(int16_t));
}

}  // namespace

// Encode `rgb` uint8 [height, width, 3] as the baseline JPEG that PIL
// writes at its defaults (quality 75, 4:2:0) into out (cap bytes) and its
// length into *len. Returns 0, -1 for a size out of range, or -2 if cap is
// too small. Host code; thread-safe.
extern "C" int pvnet_jpeg_encode(const uint8_t* rgb, int height, int width,
                                 uint8_t* out, long cap, long* len) {
  if (height < 1 || width < 1 || height > 65535 || width > 65535) return -1;
  int qt[2][64];
  Divisor div[2][64];
  Huff dc[2], ac[2];
  for (int t = 0; t < 2; t++) {
    for (int i = 0; i < 64; i++) {
      int v = (kStdQuant[t][i] * 50 + 50) / 100;   // quality 75: scale 50
      qt[t][i] = v < 1 ? 1 : (v > 255 ? 255 : v);
      div[t][i] = reciprocal(qt[t][i] * 8);
    }
    build_huff(kDcBits[t], kDcVals, &dc[t]);
    build_huff(kAcBits[t], kAcVals[t], &ac[t]);
  }

  Writer w{out, cap};
  static const uint8_t kJfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0,
                                    0,   1,   0,   1,   0, 0};
  w.byte(0xFF);
  w.byte(0xD8);
  w.marker(0xE0, 14);
  w.bytes(kJfif, 14);
  for (int t = 0; t < 2; t++) {
    w.marker(0xDB, 65);
    w.byte((uint8_t)t);
    for (int k = 0; k < 64; k++) w.byte((uint8_t)qt[t][kZigzag[k]]);
  }
  static const uint8_t kComps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  w.marker(0xC0, 15);
  w.byte(8);
  w.u16(height);
  w.u16(width);
  w.byte(3);
  w.bytes(kComps, 9);
  for (int t = 0; t < 2; t++) {
    w.marker(0xC4, 1 + 16 + 12);
    w.byte((uint8_t)t);
    w.bytes(kDcBits[t], 16);
    w.bytes(kDcVals, 12);
    int nac = 0;
    for (int i = 0; i < 16; i++) nac += kAcBits[t][i];
    w.marker(0xC4, 1 + 16 + nac);
    w.byte((uint8_t)(0x10 | t));
    w.bytes(kAcBits[t], 16);
    w.bytes(kAcVals[t], nac);
  }
  static const uint8_t kScan[10] = {3, 1, 0, 2, 0x11, 3, 0x11, 0, 63, 0};
  w.marker(0xDA, 10);
  w.bytes(kScan, 10);

  const int H = height, W = width;
  int32_t q[64];
  // luma padded to whole MCUs (16x16); chroma downsampled from the
  // image padded to even rows and 16 * mcux columns, then padded to
  // 8 * mcuy rows
  const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  const int lwb = (W + 7) / 8, lhb = (H + 7) / 8;
  const int pw = 16 * mcux, ph = 16 * mcuy;
  const int cw = 8 * mcux, ch = 8 * mcuy, chh = (H + 1) / 2;
  std::vector<int16_t> y((size_t)ph * pw), cbf((size_t)H * W),
      crf((size_t)H * W), cb((size_t)ch * cw), cr((size_t)ch * cw);
  for (int r = 0; r < H; r++)
    for (int c = 0; c < W; c++) {
      const uint8_t* p = rgb + ((size_t)r * W + c) * 3;
      const int64_t R = p[0], G = p[1], B = p[2];
      y[(size_t)r * pw + c] =
          (int16_t)((kRY * R + kGY * G + kBY * B + kOneHalf) >> 16);
      cbf[(size_t)r * W + c] = (int16_t)(
          (-kRCb * R - kGCb * G + kBCb * B + kCbCrOffset + kOneHalf - 1) >> 16);
      crf[(size_t)r * W + c] = (int16_t)(
          (kBCb * R - kGCr * G - kBCr * B + kCbCrOffset + kOneHalf - 1) >> 16);
    }
  replicate_edges(y, H, W, ph, pw);
  for (int cy = 0; cy < chh; cy++) {
    const int r0 = 2 * cy, r1 = 2 * cy + 1 < H ? 2 * cy + 1 : H - 1;
    for (int cx = 0; cx < cw; cx++) {
      const int c0 = 2 * cx < W ? 2 * cx : W - 1;
      const int c1 = 2 * cx + 1 < W ? 2 * cx + 1 : W - 1;
      const int bias = 1 + (cx & 1);
      cb[(size_t)cy * cw + cx] = (int16_t)(
          (cbf[(size_t)r0 * W + c0] + cbf[(size_t)r0 * W + c1] +
           cbf[(size_t)r1 * W + c0] + cbf[(size_t)r1 * W + c1] + bias) >> 2);
      cr[(size_t)cy * cw + cx] = (int16_t)(
          (crf[(size_t)r0 * W + c0] + crf[(size_t)r0 * W + c1] +
           crf[(size_t)r1 * W + c0] + crf[(size_t)r1 * W + c1] + bias) >> 2);
    }
  }
  replicate_edges(cb, chh, cw, ch, cw);
  replicate_edges(cr, chh, cw, ch, cw);
  int pred[3] = {0, 0, 0};
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++) {
      int32_t dcs[4];
      for (int i = 0; i < 4; i++) {
        const int by = 2 * my + i / 2, bx = 2 * mx + i % 2;
        if (by < lhb && bx < lwb) {
          transform_block(y, pw, by, bx, div[0], q);
        } else {
          // jccoefct.c's dummy blocks: zero, DC from the block before
          // (right edge: the block to the left; bottom row: the last
          // block of the MCU's upper row)
          memset(q, 0, sizeof(q));
          q[0] = by < lhb ? dcs[i - 1] : dcs[1];
        }
        dcs[i] = q[0];
        encode_block(w, q, pred[0], dc[0], ac[0]);
        pred[0] = q[0];
      }
      for (int c = 1; c < 3; c++) {
        transform_block(c == 1 ? cb : cr, cw, my, mx, div[1], q);
        encode_block(w, q, pred[c], dc[1], ac[1]);
        pred[c] = q[0];
      }
    }
  w.flush();
  w.byte(0xFF);
  w.byte(0xD9);
  *len = w.n;
  return w.full ? -2 : 0;
}
