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
  if (chunk == 0) {
    int sms = 0, per_sm = 0;
    device_slots(&sms, &per_sm);
    const long long waves = 2LL * sms * per_sm;
    long long splits = (waves + blocks - 1) / blocks;
    const long long most = (tn + MIN_CHUNK - 1) / MIN_CHUNK;
    splits = splits > most ? most : splits;
    chunk = (int)((tn + splits - 1) / splits + 7) & ~7;
  }
  if ((tn + (long long)chunk - 1) / chunk > 65535)
    chunk = (tn + 65534) / 65535;
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
