// Stratified foreground selection (kernels K1 and K2).
//
// Replaces: pvnet_tpu/ops/select_kernel.py: _kernel_cmajor (K1, called
// through stratified_select_cmajor, a channel-major [b, C, h, w] field)
// and _kernel (K2, called through stratified_select, a flat NHWC
// [b, h, w, C] field). For each image and phase bucket (y mod a, x mod bb)
// it keeps the pixel with the largest score and returns that score, the
// winner's tile index ty*(w/bb)+tx and the winner's C field values.
//
// What bounds it on the H100: device-memory reads, and at small sizes the
// launch and two dependent trips to memory. The score map is read once
// (b*h*w floats: 19.7 MB for K1 at b=16, 480x640; 4.9 MB for K2 on the
// packed 240x320 lattice); the field is read only at the a*bb winners (C
// values each), never streamed whole. The TPU kernel K2 streams the whole
// field through VMEM and expands the mask with a 0/1 matmul; on Hopper
// that would read 393 MB per request for 0.66 MB of winners. There is no
// arithmetic to speak of. K1's winners' values lie in C planes h*w apart,
// so each costs a 32-byte sector of its own. K2's 4.9 MB take ~1.5 us at
// 3.35 TB/s, less than one block's chain of launch, score loads, merge
// and winner copy, which sets its time.
//
// What the design does about it:
// - A block owns one (image, row phase py): the ty_n rows y = ty*a + py,
//   all w columns. Its threads own column groups: 4 adjacent columns read
//   as one 16-byte load where w % 4 == 0 and the score is 16-byte aligned
//   (the vector path), one column otherwise (the scalar path, a template
//   branch of its own). The block's threads form row slices, each a copy
//   of the column groups over every slices-th chunk of kRows rows; the
//   launch adds slices while the grid holds fewer than kSlicesPerSM for
//   each SM (K2 at b=16: 128 blocks of 4 slices; K1 at b=16: 256 blocks of
//   2). A thread issues the loads of its kRows rows before any compare,
//   as streaming loads (the score is read once).
// - Per column a thread keeps (best, ty) under a strict '>' in ascending
//   ty: a NaN score never wins, and all -inf leaves (-inf, ty 0).
// - Row slices and the columns of one x phase px = x mod bb are merged
//   under an order-free rule: the larger score wins, on an equal score
//   the smaller tile index wins. Packed as key = (score in an order-
//   preserving unsigned form) << 32 | (0xFFFFFFFF - tile), the rule is a
//   plain max, so the merge is exact and deterministic in any order: a
//   butterfly of warp shuffles where bb divides one warp's span of
//   columns (32 * columns per thread), then atomicMax into one shared key
//   per phase. The rule is that of jnp.argmax and of the plain version's
//   torch.argmax (the first maximum in tile order ty*(w/bb)+tx wins) on
//   every score that is not NaN; -0 and +0 tie, as '>' sees them. On NaN
//   the kernel, like the Pallas kernels, never picks it, while
//   torch.argmax would; the path's scores (2*fg + uniform, -1 padding)
//   are never NaN.
// - The block then writes its bb results: the winner's score is read back
//   from the score map (so -0 stays -0), and the winners' values are
//   copied by the whole block, kCopy loads of a thread in flight at once:
//   one thread per (winner, channel) in the channel-major layout (strided
//   by h*w), and 16-byte vectors of the contiguous NHWC row where C *
//   element size is a multiple of 16 and the rows are aligned (element by
//   element otherwise). bf16 values are moved as 16-bit patterns, never
//   converted, so every output equals the plain version bit for bit.
// - A block keeps the keys of at most kPhaseChunk phases in shared memory;
//   a wider bb (w > 4096) is split over blockIdx.y, each block reading all
//   of its rows and merging only its phases.
// - The ty range is not split across blocks: one block's chain, not the
//   number of blocks, sets K2's time (b=1 takes about as long as b=16),
//   and a split would add a round of partial winners to that chain.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRows = 8;           // rows whose loads a thread issues at once
constexpr int kMaxThreads = 512;
constexpr int kSlicesPerSM = 4;
constexpr int kCopy = 8;           // copies whose loads a thread issues at once
constexpr int kPhaseChunk = 4096;  // phases whose keys one block keeps

template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<4> { using T = float4; };

// A candidate's key: its score in an order-preserving unsigned form (-0
// and +0 tie), then 0xFFFFFFFF - tile. The larger key wins: the larger
// score, on an equal score the smaller tile.
__device__ __forceinline__ unsigned long long make_key(float v, int tile) {
  unsigned u = v == 0.0f ? 0u : __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned)tile);
}

__device__ __forceinline__ int key_tile(unsigned long long k) {
  return (int)(0xFFFFFFFFu - (unsigned)k);
}

// d[i] = load(i) for i < n, by the whole block, kCopy loads of a thread in
// flight before its stores.
template <typename E, typename Load>
__device__ __forceinline__ void block_copy(E* __restrict__ d, int n,
                                           Load load) {
  for (int i0 = threadIdx.x; i0 < n; i0 += kCopy * blockDim.x) {
    E v[kCopy];
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < kCopy; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) d[i] = v[u];
    }
  }
}

// V columns per thread (4: the vector path, 1: the scalar path). The
// block's threads form `slices` slices of blockDim.x / slices threads (a
// multiple of 32); slice k reads the row chunks k, k + slices, ... T is
// the field's element, moved as is: float, or unsigned short for the bits
// of a bf16 value. The field value of channel ci at pixel (y, x) of image
// bi sits at bi*c*h*w + (y*w + x)*pix_stride + ci*ch_stride.
template <int V, typename T>
__global__ void __launch_bounds__(kMaxThreads)
select_kernel(const float* __restrict__ score, const T* __restrict__ field,
              float* __restrict__ best_out, int* __restrict__ idx_out,
              T* __restrict__ dirs_out, int c, int h, int w, int a, int bb,
              long long pix_stride, long long ch_stride, int slices,
              int vec_copy) {
  using VT = typename Vec<V>::T;
  extern __shared__ unsigned long long keys[];
  const int bi = blockIdx.x / a;
  const int py = blockIdx.x - bi * a;
  const int p0 = blockIdx.y * kPhaseChunk;
  const int np = min(bb - p0, kPhaseChunk);
  const int ty_n = h / a;
  const int tx_n = w / bb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int width = blockDim.x / slices;
  const int slice = tid / width;
  const float* s = score + ((size_t)bi * h + py) * w;   // row y = py
  const size_t row_step = (size_t)a * w;                // ty -> ty + 1

  for (int i = tid; i < np; i += blockDim.x) keys[i] = 0ull;
  __syncthreads();

  const int groups = w / V;
  // lanes l and l ^ off hold the same phases for off = span..16
  const bool shuffle = (32 * V) % bb == 0;
  const int span = bb > V ? bb / V : 1;
  // a uniform loop: every lane of a warp takes each iteration (shuffles)
  for (int g0 = 0; g0 < groups; g0 += width) {
    const int g = g0 + tid - slice * width;
    float best[V];
    int bty[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      best[j] = -CUDART_INF_F;
      bty[j] = 0;
    }
    if (g < groups) {
      const VT* col = reinterpret_cast<const VT*>(s) + g;
      const size_t vstep = row_step / V;
      for (int ty0 = slice * kRows; ty0 < ty_n; ty0 += slices * kRows) {
        VT v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (ty0 + r < ty_n) v[r] = __ldcs(col + (size_t)(ty0 + r) * vstep);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (ty0 + r < ty_n) {
            const float* e = reinterpret_cast<const float*>(&v[r]);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              if (e[j] > best[j]) {
                best[j] = e[j];
                bty[j] = ty0 + r;
              }
            }
          }
        }
      }
    }
    unsigned long long key[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int x = g * V + j;
      key[j] = g < groups ? make_key(best[j], bty[j] * tx_n + x / bb) : 0ull;
    }
    if (shuffle) {
      for (int off = span; off < 32; off <<= 1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const unsigned long long k =
              __shfl_xor_sync(0xffffffffu, key[j], off);
          if (k > key[j]) key[j] = k;
        }
      }
      if (lane >= span) continue;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int p = (g * V + j) % bb - p0;
      if (key[j] != 0ull && p >= 0 && p < np) atomicMax(&keys[p], key[j]);
    }
  }
  __syncthreads();

  const size_t o = ((size_t)bi * a + py) * bb + p0;     // first output
  for (int i = tid; i < np; i += blockDim.x) {
    const int tile = key_tile(keys[i]);
    const int x = (tile % tx_n) * bb + p0 + i;
    best_out[o + i] = s[(size_t)(tile / tx_n) * row_step + x];
    idx_out[o + i] = tile;
  }
  const T* f = field + (size_t)bi * c * h * w;
  // element offset in f of the winner of phase p0 + p
  auto pixel = [&](int p) {
    const int tile = key_tile(keys[p]);
    const int y = (tile / tx_n) * a + py;
    const int x = (tile % tx_n) * bb + p0 + p;
    return ((size_t)y * w + x) * pix_stride;
  };
  if (vec_copy) {
    // NHWC rows of c * sizeof(T) bytes, a multiple of 16, aligned
    const int nv = c * (int)sizeof(T) / 16;
    block_copy(reinterpret_cast<uint4*>(dirs_out + o * c), np * nv,
               [&](int i) {
                 const int p = i / nv;
                 return reinterpret_cast<const uint4*>(f + pixel(p))
                     [i - p * nv];
               });
  } else {
    block_copy(dirs_out + o * c, np * c, [&](int i) {
      const int p = i / c;
      return f[pixel(p) + (size_t)(i - p * c) * ch_stride];
    });
  }
}

template <typename T>
int launch(const float* score, const T* field, float* best, int* idx,
           T* dirs, int b, int c, int h, int w, int a, int bb,
           long long pix_stride, long long ch_stride, int vec_copy,
           cudaStream_t stream) {
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(score) % 16 == 0;
  const auto kernel = vec ? select_kernel<4, T> : select_kernel<1, T>;
  const int groups = vec ? w / 4 : w;
  const int width = std::min(kMaxThreads, (groups + 31) / 32 * 32);
  const dim3 grid(b * a, (bb + kPhaseChunk - 1) / kPhaseChunk);
  const size_t smem = (size_t)std::min(bb, kPhaseChunk)
                      * sizeof(unsigned long long);
  // Row slices (each thread then reads fewer row chunks) until the grid
  // holds about kSlicesPerSM slices for each SM.
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long slices = std::min((h / a + kRows - 1) / kRows,
                              kMaxThreads / width);
  slices = std::min(slices, (long long)kSlicesPerSM * sms / grid.x / grid.y);
  slices = std::max(slices, 1LL);
  kernel<<<grid, width * slices, smem, stream>>>(
      score, field, best, idx, dirs, c, h, w, a, bb, pix_stride, ch_stride,
      (int)slices, vec_copy);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. score [b, h, w] f32, field [b, c, h, w] f32 -> best [b, a, bb] f32,
// idx [b, a, bb] i32, dirs [b, a, bb, c] f32. h % a == 0 == w % bb.
extern "C" int pvnet_select_cmajor(const float* score, const float* field,
                                   float* best, int* idx, float* dirs,
                                   int b, int c, int h, int w, int a, int bb,
                                   cudaStream_t stream) {
  return launch<float>(score, field, best, idx, dirs, b, c, h, w, a, bb, 1,
                       (long long)h * w, 0, stream);
}

// K2. score [b, h, w] f32, field [b, h, w, c] of elem_bytes-wide values
// (4: f32, 2: bf16) -> best [b, a, bb] f32, idx [b, a, bb] i32,
// dirs [b, a, bb, c] in the field's type. h % a == 0 == w % bb.
extern "C" int pvnet_select_nhwc(const float* score, const void* field,
                                 float* best, int* idx, void* dirs,
                                 int b, int c, int h, int w, int a, int bb,
                                 int elem_bytes, cudaStream_t stream) {
  const int vec_copy = (long long)c * elem_bytes % 16 == 0
                       && reinterpret_cast<uintptr_t>(field) % 16 == 0
                       && reinterpret_cast<uintptr_t>(dirs) % 16 == 0;
  if (elem_bytes == 4)
    return launch<float>(score, static_cast<const float*>(field), best, idx,
                         static_cast<float*>(dirs), b, c, h, w, a, bb, c, 1,
                         vec_copy, stream);
  if (elem_bytes == 2)
    return launch<unsigned short>(
        score, static_cast<const unsigned short*>(field), best, idx,
        static_cast<unsigned short*>(dirs), b, c, h, w, a, bb, c, 1,
        vec_copy, stream);
  return (int)cudaErrorInvalidValue;
}
