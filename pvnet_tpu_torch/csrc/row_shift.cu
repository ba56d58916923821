// Per-row and per-column circular integer shifts (kernels K4 and K5).
//
// Replaces: pvnet_tpu/ops/row_shift.py: _lanes_kernel (K4, called through
// shift_lanes) and _sublanes_kernel (K5, called through shift_sublanes).
//   K4: y[p, r, c] = x[p, r, (starts[p, r] + c) mod C]
//   K5: y[p, i, c] = x[p, (starts[p, c] + i) mod H, c]
// Shifts are reduced with ((s % n) + n) % n, so negative and over-range
// starts wrap as jnp.mod does (C's % keeps the sign of a negative shift).
//
// What bounds it on the H100: device-memory bytes. Each element is read
// once and written once and nothing is computed on it; at the training
// shape (64 planes of 480x640 float32) either kernel moves 2 x 78.6 MB,
// ~47 us at 3.35 TB/s. So both loads and stores have to be whole 128-byte
// lines.
//
// What the design does about it: the Pallas kernel decomposes the shift
// into log2(n) static rolls and selects because Mosaic has no cheap
// per-lane index; Hopper has one.
// - K4: one block per row, each thread computes its source index. A
//   warp's loads are one contiguous run except at the row's single wrap
//   point, and its stores are always contiguous.
// - K5: every column has its own start row, so a warp that read its 32
//   columns straight from device memory would touch 32 rows (32 sectors
//   for 128 useful bytes). Instead a block owns one plane and a strip of
//   columns 128 bytes wide (32 four-byte or 128 one-byte columns) and
//   stages all H rows of the strip into shared memory with whole-line
//   vector loads (60 KB at H = 480, ~3 blocks per SM). It then writes the
//   output rows whole: lane l reads tile[(s_c + i) mod H][c] from bank
//   l whatever the row, so the reads are free of bank conflicts and each
//   warp stores one 128-byte line. For one-byte elements a lane takes 4
//   adjacent columns, reads 4 bytes from 4 rows (bank l again) and stores
//   one 32-bit word. A ragged last strip is masked.
// - K5, direct branch: a strip of H rows that does not fit a block's
//   shared memory (H > 1816 on the H100) takes the kernel without
//   staging: threads along c, each walking its column from its own start
//   row (stores contiguous, loads scattered). Named, and tested at
//   H = 2000.
// Elements are moved as bits: a 4-byte template serves f32, i32 and u32,
// a 1-byte template uint8 and int8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int SUBLANE_CHUNK = 32;
constexpr int STRIP_BYTES = 128;
constexpr int STRIP_THREADS = 512;
constexpr int STRIP_WARPS = STRIP_THREADS / 32;

__device__ __forceinline__ int wrap(int s, int n) {
  s %= n;
  return s < 0 ? s + n : s;
}

template <typename T>
__global__ void shift_lanes_kernel(const T* __restrict__ x,
                                   const int* __restrict__ starts,
                                   T* __restrict__ y, int C) {
  const size_t row = blockIdx.x;
  const int s = wrap(starts[row], C);
  const T* xr = x + row * C;
  T* yr = y + row * C;
#pragma unroll 4
  for (int c = threadIdx.x; c < C; c += THREADS) {
    int src = s + c;
    if (src >= C) src -= C;
    yr[c] = xr[src];
  }
}

// Copy rows [0, H) of a strip of strip_bytes (<= 128) bytes, rows
// row_bytes apart, into tile (rows 128 bytes apart), in vectors of V.
template <typename V>
__device__ __forceinline__ void stage_strip(const uint8_t* __restrict__ src,
                                            uint8_t* __restrict__ tile,
                                            int H, size_t row_bytes,
                                            int strip_bytes) {
  constexpr int PER_ROW = STRIP_BYTES / sizeof(V);
  const int n = H * PER_ROW;
#pragma unroll 8
  for (int k = threadIdx.x; k < n; k += STRIP_THREADS) {
    const int r = k / PER_ROW;
    const int off = (k - r * PER_ROW) * (int)sizeof(V);
    if (off < strip_bytes)
      *reinterpret_cast<V*>(tile + r * STRIP_BYTES + off) =
          *reinterpret_cast<const V*>(src + r * row_bytes + off);
  }
}

// K5 for 4-byte elements: block = (plane, strip of 32 columns).
template <typename V>
__global__ void __launch_bounds__(STRIP_THREADS)
shift_sublanes_strip4(const uint8_t* __restrict__ x,
                      const int* __restrict__ starts,
                      uint8_t* __restrict__ y, int H, int C, int strips) {
  extern __shared__ __align__(16) uint8_t tile[];
  const int p = blockIdx.x / strips;
  const int c0 = (blockIdx.x - p * strips) * (STRIP_BYTES / 4);
  const size_t row_bytes = (size_t)C * 4;
  const size_t plane = (size_t)p * H * row_bytes;
  stage_strip<V>(x + plane + (size_t)c0 * 4, tile, H, row_bytes,
                 min(STRIP_BYTES, (C - c0) * 4));
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = c0 + lane;
  if (c >= C) return;
  const int step = STRIP_WARPS % H;                 // rows between passes
  int r = wrap(starts[(size_t)p * C + c], H) + warp % H;
  if (r >= H) r -= H;
  const uint32_t* t32 = reinterpret_cast<const uint32_t*>(tile) + lane;
  uint32_t* yc = reinterpret_cast<uint32_t*>(y + plane) + c;
#pragma unroll 4
  for (int i = warp; i < H; i += STRIP_WARPS) {
    yc[(size_t)i * C] = t32[r * (STRIP_BYTES / 4)];
    r += step;
    if (r >= H) r -= H;
  }
}

// K5 for 1-byte elements: block = (plane, strip of 128 columns); a lane
// writes 4 adjacent columns, as one word where C % 4 == 0 and y is
// 4-byte aligned (word_store), else byte by byte.
template <typename V>
__global__ void __launch_bounds__(STRIP_THREADS)
shift_sublanes_strip1(const uint8_t* __restrict__ x,
                      const int* __restrict__ starts,
                      uint8_t* __restrict__ y, int H, int C, int strips,
                      int word_store) {
  extern __shared__ __align__(16) uint8_t tile[];
  const int p = blockIdx.x / strips;
  const int c0 = (blockIdx.x - p * strips) * STRIP_BYTES;
  const size_t plane = (size_t)p * H * C;
  stage_strip<V>(x + plane + c0, tile, H, (size_t)C,
                 min(STRIP_BYTES, C - c0));
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cb = c0 + 4 * lane;
  if (cb >= C) return;
  const int step = STRIP_WARPS % H;
  int r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r[k] = 0;
    if (cb + k < C) {
      r[k] = wrap(starts[(size_t)p * C + cb + k], H) + warp % H;
      if (r[k] >= H) r[k] -= H;
    }
  }
  const uint8_t* tl = tile + 4 * lane;
  uint8_t* yc = y + plane + cb;
#pragma unroll 2
  for (int i = warp; i < H; i += STRIP_WARPS) {
    uint32_t w = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      w |= (uint32_t)tl[r[k] * STRIP_BYTES + k] << (8 * k);
      r[k] += step;
      if (r[k] >= H) r[k] -= H;
    }
    uint8_t* yr = yc + (size_t)i * C;
    if (word_store) {
      *reinterpret_cast<uint32_t*>(yr) = w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (cb + k < C) yr[k] = (uint8_t)(w >> (8 * k));
    }
  }
}

// K5's direct branch, for strips too tall for shared memory: threads run
// along c and loop over a chunk of i.
template <typename T>
__global__ void shift_sublanes_direct(const T* __restrict__ x,
                                      const int* __restrict__ starts,
                                      T* __restrict__ y, int H, int C,
                                      int c_tiles) {
  const int p = blockIdx.x / c_tiles;
  const int c = (blockIdx.x - p * c_tiles) * THREADS + threadIdx.x;
  if (c >= C) return;
  const int i0 = blockIdx.y * SUBLANE_CHUNK;
  const int i1 = min(i0 + SUBLANE_CHUNK, H);
  const size_t plane = (size_t)p * H * C;
  int r = wrap(starts[(size_t)p * C + c], H) + i0 % H;
  if (r >= H) r -= H;
  for (int i = i0; i < i1; ++i) {
    y[plane + (size_t)i * C + c] = x[plane + (size_t)r * C + c];
    if (++r == H) r = 0;
  }
}

template <typename T>
int launch_lanes(const void* x, const int* starts, void* y, int n_rows,
                 int C, cudaStream_t stream) {
  shift_lanes_kernel<T><<<n_rows, THREADS, 0, stream>>>(
      static_cast<const T*>(x), starts, static_cast<T*>(y), C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_direct(const void* x, const int* starts, void* y, int P, int H,
                  int C, cudaStream_t stream) {
  const int c_tiles = (C + THREADS - 1) / THREADS;
  dim3 grid(P * c_tiles, (H + SUBLANE_CHUNK - 1) / SUBLANE_CHUNK);
  shift_sublanes_direct<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), starts, static_cast<T*>(y), H, C, c_tiles);
  return (int)cudaGetLastError();
}

// The strip kernels stage H rows of 128 bytes in dynamic shared memory,
// which needs an opt-in above 48 KB.
template <typename V>
int launch_strip4(const uint8_t* x, const int* starts, uint8_t* y, int P,
                  int H, int C, cudaStream_t stream) {
  const int strips = (C + 31) / 32, smem = H * STRIP_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      shift_sublanes_strip4<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  shift_sublanes_strip4<V><<<P * strips, STRIP_THREADS, smem, stream>>>(
      x, starts, y, H, C, strips);
  return (int)cudaGetLastError();
}

template <typename V>
int launch_strip1(const uint8_t* x, const int* starts, uint8_t* y, int P,
                  int H, int C, int word_store, cudaStream_t stream) {
  const int strips = (C + STRIP_BYTES - 1) / STRIP_BYTES;
  const int smem = H * STRIP_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      shift_sublanes_strip1<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  shift_sublanes_strip1<V><<<P * strips, STRIP_THREADS, smem, stream>>>(
      x, starts, y, H, C, strips, word_store);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// Largest shared memory a block may opt in to, on the current device.
int max_block_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

}  // namespace

// x, y [n_rows, C] contiguous, elements of elem_bytes (4 or 1) bytes;
// starts [n_rows] int32, any value (reduced mod C here).
extern "C" int pvnet_shift_lanes(const void* x, const int* starts, void* y,
                                 int n_rows, int C, int elem_bytes,
                                 cudaStream_t stream) {
  if (elem_bytes == 4)
    return launch_lanes<uint32_t>(x, starts, y, n_rows, C, stream);
  if (elem_bytes == 1)
    return launch_lanes<uint8_t>(x, starts, y, n_rows, C, stream);
  return (int)cudaErrorInvalidValue;
}

// x, y [P, H, C] contiguous, elements of elem_bytes (4 or 1) bytes;
// starts [P, C] int32, any value (reduced mod H here). Takes the strip
// kernels while H rows of 128 bytes fit a block's shared memory, else the
// direct branch.
extern "C" int pvnet_shift_sublanes(const void* x, const int* starts,
                                    void* y, int P, int H, int C,
                                    int elem_bytes, cudaStream_t stream) {
  if (elem_bytes != 4 && elem_bytes != 1) return (int)cudaErrorInvalidValue;
  if ((size_t)H * STRIP_BYTES > (size_t)max_block_smem())
    return elem_bytes == 4
               ? launch_direct<uint32_t>(x, starts, y, P, H, C, stream)
               : launch_direct<uint8_t>(x, starts, y, P, H, C, stream);
  // stage in 16-byte vectors where every row starts on 16 bytes, else
  // element by element
  const bool vec16 = aligned(x, 16) && (size_t)C * elem_bytes % 16 == 0;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  uint8_t* yb = static_cast<uint8_t*>(y);
  if (elem_bytes == 4)
    return vec16 ? launch_strip4<uint4>(xb, starts, yb, P, H, C, stream)
                 : launch_strip4<uint32_t>(xb, starts, yb, P, H, C, stream);
  const int word_store = aligned(y, 4) && C % 4 == 0;
  return vec16 ? launch_strip1<uint4>(xb, starts, yb, P, H, C, word_store,
                                      stream)
               : launch_strip1<uint8_t>(xb, starts, yb, P, H, C, word_store,
                                        stream);
}
