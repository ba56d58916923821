// Host emulation of the CUDA built-ins that csrc/jpeg_decode.cu's pixel
// kernel uses, for running the kernel's own source on a CPU with g++
// (tests/test_torch_jpeg_emulated.py): every CUDA thread a std::thread,
// std::barrier for __syncthreads, __syncwarp and a warp's shuffles, each
// block's dynamic shared memory a buffer of its own filled with noise. The
// launch itself is the test harness's (emu_launch_hook).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) int2 { int x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
// refuses more dynamic shared memory than an H100 block may have
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int v) {
  return v > 232448 ? 1 : 0;
}
struct EmuBlock {
  std::barrier<>* bar;
  std::vector<std::barrier<>*> warps;
  int* shfl;
  uint8_t* smem;
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline thread_local EmuBlock* emu_blk;
// slots of a launch, all blocks together (the harness counts them)
inline std::atomic<long> emu_ns{0};
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp() {
  emu_blk->warps[threadIdx.x / 32]->arrive_and_wait();
}
inline int __shfl_sync(unsigned, int v, int src) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  int* buf = emu_blk->shfl + 32 * w;
  buf[l] = v;
  emu_blk->warps[w]->arrive_and_wait();
  const int r = buf[src & 31];
  emu_blk->warps[w]->arrive_and_wait();
  return r;
}
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
  const int l = threadIdx.x % 32;
  const int r = __shfl_sync(~0u, v, l >= (int)d ? l - (int)d : l);
  return l >= (int)d ? r : v;
}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; i++)
    r |= ((v >> (8 * ((s >> (4 * i)) & 7))) & 255) << (8 * i);
  return r;
}
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return (unsigned)((((uint64_t)hi << 32) | lo) >> (sh & 31));
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
extern int (*emu_launch_hook)(const void*, dim3, dim3, void**, size_t);
inline cudaError_t cudaLaunchKernel(const void* f, dim3 grid, dim3 block,
                                    void** args, size_t smem, cudaStream_t) {
  return emu_launch_hook(f, grid, block, args, smem);
}
inline cudaError_t cudaGetLastError() { return 0; }
