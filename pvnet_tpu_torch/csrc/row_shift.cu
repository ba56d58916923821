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
// once and written once and nothing is computed on it; K4 on the training
// path moves 2 x 78.6 MB of float32 per launch (b=16, 4 planes, 480x640),
// ~47 us at 3.35 TB/s.
//
// What the design does about it: the Pallas kernel decomposes the shift
// into log2(C) static rolls and selects because Mosaic has no cheap
// per-lane index; Hopper has one, so each thread computes its source index
// directly and moves one element per iteration.
// - K4: one block per row. Neighbouring threads take neighbouring c, so a
//   warp's loads are one contiguous run except at the row's single wrap
//   point, and its stores are always contiguous.
// - K5: threads run along c and loop over a chunk of i, so a warp's stores
//   are contiguous; each thread's loads walk down one column from its own
//   start row (L2 serves the neighbouring columns' reads of a sector).
// Elements are moved as bits: a 4-byte template serves f32, i32 and u32,
// a 1-byte template uint8 and int8.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int SUBLANE_CHUNK = 32;

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

template <typename T>
__global__ void shift_sublanes_kernel(const T* __restrict__ x,
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
int launch_sublanes(const void* x, const int* starts, void* y, int P, int H,
                    int C, cudaStream_t stream) {
  const int c_tiles = (C + THREADS - 1) / THREADS;
  dim3 grid(P * c_tiles, (H + SUBLANE_CHUNK - 1) / SUBLANE_CHUNK);
  shift_sublanes_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), starts, static_cast<T*>(y), H, C, c_tiles);
  return (int)cudaGetLastError();
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
// starts [P, C] int32, any value (reduced mod H here).
extern "C" int pvnet_shift_sublanes(const void* x, const int* starts,
                                    void* y, int P, int H, int C,
                                    int elem_bytes, cudaStream_t stream) {
  if (elem_bytes == 4)
    return launch_sublanes<uint32_t>(x, starts, y, P, H, C, stream);
  if (elem_bytes == 1)
    return launch_sublanes<uint8_t>(x, starts, y, P, H, C, stream);
  return (int)cudaErrorInvalidValue;
}
