// RANSAC inlier counting (kernel K3).
//
// Replaces: pvnet_tpu/ops/voting.py: _count_kernel, called through
// count_inliers_pallas; the same O(hn*vn*tn) loop as the reference's CUDA
// voting_for_hypothesis_kernel. For each (image, keypoint, hypothesis) it
// counts the valid pixels whose ray passes
//   dot > 0  and  dot^2 > t^2 * d^2 * n^2  and  d^2 > 1e-12  and  n^2 > 1e-12
// (the multiplication-only form of the cosine test). The [hn, vn, tn]
// inlier tensor is never stored.
//
// What bounds it on the H100: the instruction rate. The inputs are small
// (37.7 M pairs at the main path's b=16, vn=9, hn=tn=512 read 1.2 MB), and
// every pair costs 16 instructions that cannot be fused: 13 float32
// multiplies and adds (no FMA: -fmad=false and the explicit rounding
// below), 2 compares and a predicated count. The SMs start 132 x 128
// thread-instructions a cycle, ~33.5 T/s at ~1.98 GHz.
//
// What the design does about it:
// - Nothing per pair that can be done per pixel or per hypothesis. The
//   block stages a tile of pixels into shared memory and computes each
//   pixel's features once while staging, from the sample's own tensors
//   (coords [b, tn, 2], dirs [b, tn, vn, 2], valid [b, tn]):
//   (nx, ny, c.n, n2e) and (cx, cy, |c|^2). n2e is |n|^2, or NaN where the
//   pixel is invalid or |n|^2 <= 1e-12, so that the pair's product
//   compare fails there; dot > 0 folds into dot * |dot| > t^2 d^2 n^2,
//   whose right side is >= 0 whenever d^2 > 1e-12. Each thread holds the
//   (hx, hy, |h|^2) of its hypotheses in registers.
// - Register tiles: each thread owns R = 4 hypotheses of one (image,
//   keypoint) group and keeps R counts in registers, so one staged pixel,
//   read as two float4 broadcasts, serves R pairs.
// - A grid that fills the card: blocks of 128 threads x 4 hypotheses,
//   and the pixels split across blocks until there are about two waves
//   of blocks (144 groups x 1 tile would leave a ragged quarter wave on
//   132 SMs, and no block would overlap another's staging). Split blocks
//   add integer partial counts with atomicAdd into an output the entry
//   point zeroes on the same stream first: integer addition is
//   order-free, so the counts stay exact and deterministic.
// - Staging overlaps compute: the next tile's global loads are started
//   before the current tile's pairs, and land in the second buffer.
// The arithmetic is spelled with __fmul_rn/__fadd_rn/__fsub_rn in the
// order of pvnet_tpu/ops/voting.py: _pixel_features and _inlier_terms so
// that no multiply-add is contracted into an FMA: a contracted FMA rounds
// differently and moves pixels that lie on the cosine boundary, and the
// counts would then stop matching the plain version exactly.
//
// The bfloat16 mode (count_inliers_bf16_kernel, C entry
// pvnet_count_inliers_bf16) computes what pvnet_tpu/ops/voting.py:
// count_inliers_xla_bf16 computes (an XLA function there, a mode of K3
// here): coordinates recentred in float32 on each image's foreground
// centroid (computed by the caller) and rounded to bfloat16, the
// difference form dx = hx - cx, dot = dx*nx + dy*ny, d2 = dx^2 + dy^2,
// n2 = nx^2 + ny^2, and the test
//   dot > 0 & dot^2 > t2*d2*n2 & d2 > eps2 & n2 > eps2 & valid
// with every operation rounded to bfloat16, so that it equals
// voting.count_inliers_plain_bf16 bit for bit. The plain version's eager
// bf16 operation computes in float32 and rounds; float32's 24 significand
// bits are >= 2 * 8 + 2, so that double rounding equals one rounding of
// the exact result, subnormals included, which is what mul/add/sub
// .rn.bf16x2 do (tests/test_torch_voting.py: eager_bf16_ops_round_once).
//
// What bounds it: the instruction rate, as the float32 mode; 11 bf16
// operations a pair that cannot be fused, and the test. What the design
// does about it:
// - bf16x2, no conversion in the pair loop. A lane packs two hypotheses
//   of one group into the halves of hx and hy, recentred and rounded once
//   at load; staging writes each pixel's (cx, cy, nx, ny) and n2e (NaN
//   where excluded) broadcast into both halves. Per two pairs: the 11
//   operations as HMUL2/HADD2/HFMA2 (ptxas issues about 40 % of them on
//   the MMA pipe as HFMA2.MMA), |dot| as one more, two HSET2 masks
//   (lhs > rhs, d2 > eps2; dot > 0 folds into dot * |dot| > rhs, exact
//   because rhs >= +0 or NaN wherever d2 > eps2), one LOP3, and half an
//   IADD3 into two 16-bit counters in one register, flushed into 32-bit
//   counts after every 32-pixel slice. cuobjdump (tools/tune_k3_bf16.py):
//   8.38 instructions a pair, against 40.75 in the kernel this replaced
//   (one hypothesis a thread, each rounding a float32 operation, an
//   F2F.BF16.F32 and a shift back: 44 conversions in 163 instructions for
//   4 pairs).
// - Register tiles: R = 2 packed pairs a thread (4 hypotheses), so one
//   staged pixel (one broadcast LDS.128 and a quarter of one) serves 4
//   pairs. R = 4 gives 8.06 instructions a pair but half the warps, and
//   measured slower at hn = 512 and 1024 on the H100.
// - Warps split the pixels inside a block: 4 warps hold the block's 128
//   hypotheses, each takes 32 pixels of every 128-pixel tile, and the
//   block adds their counts in shared memory at the end. The main path's
//   grid (576 blocks of 4 warps at hn = 512) fills the card without
//   splitting the pixels across blocks, so the counts are written once:
//   no zeroing launch, no atomics. A grid of fewer than BF_WARPS_PER_SM
//   warps an SM still splits them across blocks as the float32 mode
//   does, with integer atomicAdd into counts zeroed on the stream.
// - Staging overlaps compute: the next tile's global loads are started
//   before the current tile's pairs, and land in the second buffer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int R = 4;                     // hypotheses per thread
constexpr int HYPS = THREADS * R;        // hypotheses per block
constexpr int TILE = THREADS;            // pixels per staged tile
constexpr int MIN_CHUNK = 32;            // fewest pixels a split block takes
constexpr float EPS = 1e-12f;

// Count one (hypothesis, pixel) pair: a = (nx, ny, cn, n2e),
// c = (cx, cy, c2, -).
__device__ __forceinline__ void count_pair(float hx, float hy, float h2,
                                           const float4& a, const float4& c,
                                           float t2, int& cnt) {
  // dot = hx*nx + hy*ny - cn
  const float dot =
      __fsub_rn(__fadd_rn(__fmul_rn(hx, a.x), __fmul_rn(hy, a.y)), a.z);
  // d2 = h2 - 2*(hx*cx + hy*cy) + c2
  const float hc = __fadd_rn(__fmul_rn(hx, c.x), __fmul_rn(hy, c.y));
  const float d2 = __fadd_rn(__fsub_rn(h2, __fmul_rn(2.0f, hc)), c.z);
  const float lhs = __fmul_rn(dot, fabsf(dot));
  const float rhs = __fmul_rn(__fmul_rn(t2, d2), a.w);
  // cnt += (d2 > 1e-12) && (lhs > rhs), as two compares and a predicated add
  asm("{\n\t.reg .pred p, q;\n\t"
      "setp.gt.f32 p, %1, %2;\n\t"
      "setp.gt.and.f32 q, %3, %4, p;\n\t"
      "@q add.s32 %0, %0, 1;\n\t}"
      : "+r"(cnt)
      : "f"(d2), "f"(EPS), "f"(lhs), "f"(rhs));
}

// One pixel's raw inputs, fetched a tile ahead.
struct RawPixel {
  float2 c, n;
  bool ok;
};

__global__ void __launch_bounds__(THREADS)
count_inliers_kernel(const float2* __restrict__ coords,
                     const float2* __restrict__ dirs,
                     const uint8_t* __restrict__ valid,
                     const float2* __restrict__ hyps, int* __restrict__ out,
                     int vn, int tn, int hn, int htiles, int chunk, float t2,
                     int accumulate) {
  __shared__ float4 sp[2][TILE][2];
  const int g = blockIdx.x / htiles;        // image * vn + keypoint
  const int h0 = (blockIdx.x - g * htiles) * HYPS + threadIdx.x;
  const int bi = g / vn;
  const int v = g - bi * vn;
  const int t_begin = blockIdx.y * chunk;
  const int t_end = min(t_begin + chunk, tn);

  float hx[R], hy[R], h2[R];
  int cnt[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int h = h0 + j * THREADS;
    float2 hp = make_float2(0.f, 0.f);
    if (h < hn) hp = hyps[((size_t)bi * hn + h) * vn + v];
    hx[j] = hp.x;
    hy[j] = hp.y;
    h2[j] = __fadd_rn(__fmul_rn(hp.x, hp.x), __fmul_rn(hp.y, hp.y));
    cnt[j] = 0;
  }

  const float2* cg = coords + (size_t)bi * tn;
  const float2* dg = dirs + (size_t)bi * tn * vn + v;
  const uint8_t* vg = valid + (size_t)bi * tn;
  auto fetch = [&](int t0) {
    const int t = t0 + (int)threadIdx.x;
    RawPixel p{make_float2(0.f, 0.f), make_float2(0.f, 0.f), false};
    if (t < t_end) {
      p.c = cg[t];
      p.n = dg[(size_t)t * vn];
      p.ok = vg[t] != 0;
    }
    return p;
  };
  // features of the pixel in the order of _pixel_features; slots past the
  // chunk's end get n2e = NaN and never count
  auto put = [&](int buf, const RawPixel& p) {
    const float cn =
        __fadd_rn(__fmul_rn(p.c.x, p.n.x), __fmul_rn(p.c.y, p.n.y));
    const float c2 =
        __fadd_rn(__fmul_rn(p.c.x, p.c.x), __fmul_rn(p.c.y, p.c.y));
    const float n2 =
        __fadd_rn(__fmul_rn(p.n.x, p.n.x), __fmul_rn(p.n.y, p.n.y));
    const float n2e = (p.ok && n2 > EPS) ? n2 : __int_as_float(0x7fc00000);
    sp[buf][threadIdx.x][0] = make_float4(p.n.x, p.n.y, cn, n2e);
    sp[buf][threadIdx.x][1] = make_float4(p.c.x, p.c.y, c2, 0.f);
  };

  put(0, fetch(t_begin));
  __syncthreads();
  int buf = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += TILE) {
    const bool more = t0 + TILE < t_end;
    RawPixel next{};
    if (more) next = fetch(t0 + TILE);
    const int n8 = (min(TILE, t_end - t0) + 7) & ~7;   // NaN-padded to 8
    const float4* s = &sp[buf][0][0];
    for (int t = 0; t < n8; t += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 a = s[2 * (t + u)];
        const float4 c = s[2 * (t + u) + 1];
#pragma unroll
        for (int j = 0; j < R; ++j) count_pair(hx[j], hy[j], h2[j], a, c, t2,
                                               cnt[j]);
      }
    }
    if (more) put(buf ^ 1, next);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int h = h0 + j * THREADS;
    if (h >= hn) continue;
    int* o = out + ((size_t)bi * hn + h) * vn + v;
    if (!accumulate)
      *o = cnt[j];
    else if (cnt[j])
      atomicAdd(o, cnt[j]);
  }
}

// Round to the nearest bfloat16 (ties to even), back in a float.
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The bfloat16 mode's shape: threads per block (whole warps) and packed
// hypothesis pairs per thread (R). The macros let tools/tune_k3_bf16.py
// build other shapes from this source.
#ifndef K3_BF16_THREADS
#define K3_BF16_THREADS 128
#endif
#ifndef K3_BF16_R
#define K3_BF16_R 2
#endif
constexpr int BF_THREADS = K3_BF16_THREADS;
constexpr int BF_WARPS = BF_THREADS / 32;
constexpr int BR = K3_BF16_R;
constexpr int BF_HYPS = 32 * 2 * BR;       // hypotheses per block
constexpr int BF_TILE = BF_THREADS;        // pixels per staged tile
// warps per SM that hide the pair loop's latency: a grid with fewer
// splits its pixels across blocks
constexpr int BF_WARPS_PER_SM = 16;
static_assert(BF_THREADS % 32 == 0, "whole warps");

// Two bf16 lanes per 32-bit register, low half first. Each operation is
// rounded once, to nearest even, and carries .rn so that ptxas never
// contracts a multiply and an add into one fma.
__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t babs2(uint32_t a) {
  uint32_t d;
  asm("abs.bf16x2 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}
// 0xFFFF in each half where a > b (false for NaN), else 0
__device__ __forceinline__ uint32_t bgt2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t both_halves(uint32_t bits) {
  return bits | (bits << 16);
}

// The pairs of two hypotheses (hx, hy: one per half) with one staged
// pixel p = (cx, cy, nx, ny) and ne = n2 or NaN, each broadcast into both
// halves: 0x0001 in each half whose pair is an inlier. The order of
// count_inliers_plain_bf16; dot > 0 is folded into dot * |dot| > rhs,
// exact because rhs = t2 * d2 * n2 is >= +0 or NaN wherever d2 > eps2.
__device__ __forceinline__ uint32_t inlier_pair2(uint32_t hx, uint32_t hy,
                                                 const uint4& p, uint32_t ne,
                                                 uint32_t t2, uint32_t eps2) {
  const uint32_t dx = bsub2(hx, p.x);
  const uint32_t dy = bsub2(hy, p.y);
  const uint32_t dot = badd2(bmul2(dx, p.z), bmul2(dy, p.w));
  const uint32_t d2 = badd2(bmul2(dx, dx), bmul2(dy, dy));
  const uint32_t lhs = bmul2(dot, babs2(dot));
  const uint32_t rhs = bmul2(bmul2(t2, d2), ne);
  return bgt2(lhs, rhs) & bgt2(d2, eps2) & 0x00010001u;
}

__global__ void __launch_bounds__(BF_THREADS)
count_inliers_bf16_kernel(const float2* __restrict__ coords,
                          const float2* __restrict__ dirs,
                          const uint8_t* __restrict__ valid,
                          const float2* __restrict__ hyps,
                          const float2* __restrict__ ctr,
                          int* __restrict__ out, int vn, int tn, int hn,
                          int htiles, int chunk, float t2f, float eps2f,
                          int accumulate) {
  __shared__ uint4 sv[2][BF_TILE];                    // (cx, cy, nx, ny)
  __shared__ __align__(16) uint32_t sn[2][BF_TILE];   // n2, or NaN
  __shared__ int part[BF_WARPS][BF_HYPS];             // each warp's counts
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x / htiles;          // image * vn + keypoint
  const int hb = (blockIdx.x - g * htiles) * BF_HYPS;
  const int bi = g / vn;
  const int v = g - bi * vn;
  const int t_begin = blockIdx.y * chunk;
  const int t_end = min(t_begin + chunk, tn);
  const float2 c0 = ctr[bi];
  const uint32_t t2 = both_halves(bf16_bits(t2f));      // exact: bf16 values
  const uint32_t eps2 = both_halves(bf16_bits(eps2f));

  // every warp holds the block's hypotheses: lane's pair j holds
  // hb + lane + 64j (low half) and + 32 (high half); past hn they count
  // unread
  uint32_t hx[BR], hy[BR], acc[BR];
  int cnt[BR][2];
#pragma unroll
  for (int j = 0; j < BR; ++j) {
    uint32_t x[2], y[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int h = hb + lane + (2 * j + k) * 32;
      float2 hp = c0;
      if (h < hn) hp = hyps[((size_t)bi * hn + h) * vn + v];
      x[k] = bf16_bits(__fsub_rn(hp.x, c0.x));
      y[k] = bf16_bits(__fsub_rn(hp.y, c0.y));
      cnt[j][k] = 0;
    }
    hx[j] = x[0] | (x[1] << 16);
    hy[j] = y[0] | (y[1] << 16);
    acc[j] = 0;
  }

  const float2* cg = coords + (size_t)bi * tn;
  const float2* dg = dirs + (size_t)bi * tn * vn + v;
  const uint8_t* vg = valid + (size_t)bi * tn;
  auto fetch = [&](int t0) {
    const int t = t0 + (int)threadIdx.x;
    RawPixel p{make_float2(0.f, 0.f), make_float2(0.f, 0.f), false};
    if (t < t_end) {
      p.c = cg[t];
      p.n = dg[(size_t)t * vn];
      p.ok = vg[t] != 0;
    }
    return p;
  };
  // the pixel's bf16 terms, each operation rounded as the plain version
  // rounds it (one float32 operation on bf16 values, then rounded, equals
  // the bf16 operation); slots past the chunk's end get NaN
  auto put = [&](int buf, const RawPixel& p) {
    const float nx = rb(p.n.x), ny = rb(p.n.y);
    const float n2 = rb(__fadd_rn(rb(__fmul_rn(nx, nx)),
                                  rb(__fmul_rn(ny, ny))));
    const bool ok = p.ok && n2 > eps2f;
    sv[buf][threadIdx.x] = make_uint4(
        both_halves(bf16_bits(__fsub_rn(p.c.x, c0.x))),
        both_halves(bf16_bits(__fsub_rn(p.c.y, c0.y))),
        both_halves(bf16_bits(nx)), both_halves(bf16_bits(ny)));
    sn[buf][threadIdx.x] = ok ? both_halves(bf16_bits(n2)) : 0x7fc07fc0u;
  };

  put(0, fetch(t_begin));
  __syncthreads();
  int buf = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += BF_TILE) {
    const bool more = t0 + BF_TILE < t_end;
    RawPixel next{};
    if (more) next = fetch(t0 + BF_TILE);
    // the warp's 32 pixels of the tile, NaN-padded to 4
    const int n4 = (max(0, min(32, t_end - t0 - warp * 32)) + 3) & ~3;
    const uint4* s = sv[buf] + warp * 32;
    const uint4* e4 = reinterpret_cast<const uint4*>(sn[buf] + warp * 32);
    for (int t = 0; t < n4; t += 4) {
      const uint4 e = e4[t >> 2];
      const uint32_t ne[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint4 p = s[t + u];
#pragma unroll
        for (int j = 0; j < BR; ++j)
          acc[j] += inlier_pair2(hx[j], hy[j], p, ne[u], t2, eps2);
      }
    }
    // the 16-bit halves hold at most 32 counts: flush each tile
#pragma unroll
    for (int j = 0; j < BR; ++j) {
      cnt[j][0] += (int)(acc[j] & 0xffffu);
      cnt[j][1] += (int)(acc[j] >> 16);
      acc[j] = 0;
    }
    if (more) put(buf ^ 1, next);
    __syncthreads();
    buf ^= 1;
  }

  // add the warps' counts of each hypothesis (integers: in any order)
#pragma unroll
  for (int j = 0; j < BR; ++j)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      part[warp][lane + (2 * j + k) * 32] = cnt[j][k];
  __syncthreads();
  for (int i = threadIdx.x; i < BF_HYPS; i += BF_THREADS) {
    const int h = hb + i;
    if (h >= hn) continue;
    int c = 0;
#pragma unroll
    for (int w = 0; w < BF_WARPS; ++w) c += part[w][i];
    int* o = out + ((size_t)bi * hn + h) * vn + v;
    if (!accumulate)
      *o = c;
    else if (c)
      atomicAdd(o, c);
  }
}

// Blocks of count_inliers_kernel that one SM holds at once, and the SM
// count, on the current device (cached per device).
void device_slots(int* sms, int* per_sm) {
  static int cache[64][2];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64 || cache[dev][0] == 0) {
    cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm,
                                                  count_inliers_kernel,
                                                  THREADS, 0);
    if (dev >= 0 && dev < 64) {
      cache[dev][0] = *sms;
      cache[dev][1] = *per_sm;
    }
    return;
  }
  *sms = cache[dev][0];
  *per_sm = cache[dev][1];
}

// Pixels per block for `blocks` blocks over tn pixels: chunk if it is
// > 0, else split the pixels until there are `target` blocks, none under
// min_chunk pixels; at most 65535 splits.
int pixel_chunk(long long blocks, int tn, int chunk, long long target,
                int min_chunk) {
  if (chunk == 0) {
    long long splits = (target + blocks - 1) / blocks;
    const long long most = (tn + min_chunk - 1) / min_chunk;
    splits = splits > most ? most : splits < 1 ? 1 : splits;
    chunk = (int)((tn + splits - 1) / splits + 7) & ~7;
  }
  if ((tn + (long long)chunk - 1) / chunk > 65535)
    chunk = (tn + 65534) / 65535;
  return chunk;
}

}  // namespace

// coords [b, tn, 2] f32, dirs [b, tn, vn, 2] f32, valid [b, tn] bool,
// hyps [b, hn, vn, 2] f32, all contiguous -> counts [b, hn, vn] i32.
// t2 = thresh^2. chunk = pixels per block: 0 chooses it (split the pixels
// until there are about two waves of blocks, which measured fastest at
// hn = 512 and 1024 on the H100); chunk >= tn never splits. b, vn, hn,
// tn >= 1.
extern "C" int pvnet_count_inliers(const float* coords, const float* dirs,
                                   const uint8_t* valid, const float* hyps,
                                   int* counts, int b, int vn, int tn,
                                   int hn, float t2, int chunk,
                                   cudaStream_t stream) {
  if (b < 1 || vn < 1 || tn < 1 || hn < 1 || chunk < 0)
    return (int)cudaErrorInvalidValue;
  const int htiles = (hn + HYPS - 1) / HYPS;
  const long long blocks = (long long)b * vn * htiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  if (chunk == 0) device_slots(&sms, &per_sm);
  // about two waves of blocks
  chunk = pixel_chunk(blocks, tn, chunk, 2LL * sms * per_sm, MIN_CHUNK);
  const int splits = (tn + chunk - 1) / chunk;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(
        counts, 0, (size_t)b * hn * vn * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)blocks, splits);
  count_inliers_kernel<<<grid, THREADS, 0, stream>>>(
      reinterpret_cast<const float2*>(coords),
      reinterpret_cast<const float2*>(dirs), valid,
      reinterpret_cast<const float2*>(hyps), counts, vn, tn, hn, htiles,
      chunk, t2, splits > 1);
  return (int)cudaGetLastError();
}

// The bfloat16 mode. coords, dirs, valid, hyps as pvnet_count_inliers;
// ctr [b, 2] f32 each image's centroid; t2 = bf16(thresh^2) and
// eps2 = bf16(1e-12), as floats; chunk = pixels per block, 0 chooses it
// (split only a grid of fewer than BF_WARPS_PER_SM warps per SM, which
// measured fastest at hn = 512 and 1024 on the H100). b, vn, hn, tn >= 1.
extern "C" int pvnet_count_inliers_bf16(const float* coords,
                                        const float* dirs,
                                        const uint8_t* valid,
                                        const float* hyps, const float* ctr,
                                        int* counts, int b, int vn, int tn,
                                        int hn, float t2, float eps2,
                                        int chunk, cudaStream_t stream) {
  if (b < 1 || vn < 1 || tn < 1 || hn < 1 || chunk < 0)
    return (int)cudaErrorInvalidValue;
  const int htiles = (hn + BF_HYPS - 1) / BF_HYPS;
  const long long blocks = (long long)b * vn * htiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int sms = 0, per_sm = 0;
  if (chunk == 0) device_slots(&sms, &per_sm);
  // BF_WARPS_PER_SM warps on each SM; a split under one staged tile
  // would leave warps idle
  chunk = pixel_chunk(blocks, tn, chunk,
                      (long long)sms * BF_WARPS_PER_SM / BF_WARPS, BF_TILE);
  const int splits = (tn + chunk - 1) / chunk;
  if (splits > 1) {
    cudaError_t err = cudaMemsetAsync(
        counts, 0, (size_t)b * hn * vn * sizeof(int), stream);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)blocks, splits);
  count_inliers_bf16_kernel<<<grid, BF_THREADS, 0, stream>>>(
      reinterpret_cast<const float2*>(coords),
      reinterpret_cast<const float2*>(dirs), valid,
      reinterpret_cast<const float2*>(hyps),
      reinterpret_cast<const float2*>(ctr), counts, vn, tn, hn, htiles,
      chunk, t2, eps2, splits > 1);
  return (int)cudaGetLastError();
}
