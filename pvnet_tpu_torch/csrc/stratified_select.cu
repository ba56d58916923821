// Stratified foreground selection (kernels K1 and K2).
//
// Replaces: pvnet_tpu/ops/select_kernel.py: _kernel_cmajor (K1, called
// through stratified_select_cmajor, a channel-major [b, C, h, w] field)
// and _kernel (K2, called through stratified_select, a flat NHWC
// [b, h, w, C] field). For each image and phase bucket (y mod a, x mod bb)
// it keeps the pixel with the largest score and returns that score, the
// winner's tile index ty*(w/bb)+tx and the winner's C field values.
//
// What bounds it on the H100: device-memory reads. The score map is read
// once (b*h*w floats: 19.7 MB for K1 at b=16, 480x640; 4.9 MB for K2 on
// the packed 240x320 lattice); the field is read only at the a*bb
// winners (C values each), never streamed whole. The TPU kernel K2 streams
// the whole field through VMEM and expands the mask with a 0/1 matmul; on
// Hopper that would read 393 MB per request for 0.66 MB of winners. There
// is no arithmetic to speak of.
//
// What the design does about it: one thread per (image, phase bucket).
// Neighbouring threads take neighbouring x phases, so each score load of a
// warp is one contiguous row segment. A thread walks its (h/a)*(w/bb)
// candidates in ascending tile index with a strict '>', the tie rule of
// jnp.argmax and of the Pallas kernels (the first maximum wins), and then
// gathers only its winner's C values: strided by h*w in the channel-major
// layout, contiguous in NHWC. Results are written directly in the merged
// [b, a, bb] form: Hopper has no 128-lane tiles, so K1's lane replicas and
// their merging epilogue do not exist here. Values are moved, never
// blended (bf16 fields are copied as 16-bit patterns), so the results
// equal the plain version bit for bit. Each thread's loads are independent
// of its compares, so the unrolled loop keeps several loads in flight;
// with only b*a*bb threads the kernel is latency-bound at small batches.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// T is the field's element, moved as is: float, or unsigned short for the
// bits of a bf16 value. The field value of channel ci at pixel (y, x) of
// image bi sits at bi*c*h*w + (y*w + x)*pix_stride + ci*ch_stride.
template <typename T>
__global__ void select_kernel(const float* __restrict__ score,
                              const T* __restrict__ field,
                              float* __restrict__ best_out,
                              int* __restrict__ idx_out,
                              T* __restrict__ dirs_out,
                              int c, int h, int w, int a, int bb,
                              long long pix_stride, long long ch_stride) {
  const int phase = blockIdx.x * blockDim.x + threadIdx.x;   // py*bb + px
  const int bi = blockIdx.y;
  if (phase >= a * bb) return;
  const int py = phase / bb;
  const int px = phase - py * bb;
  const int ty_n = h / a;
  const int tx_n = w / bb;
  const size_t plane = (size_t)h * w;

  const float* s = score + (size_t)bi * plane;
  float best = -CUDART_INF_F;
  int bidx = 0;
  for (int ty = 0; ty < ty_n; ++ty) {
    const float* row = s + (size_t)(ty * a + py) * w + px;
#pragma unroll 4
    for (int tx = 0; tx < tx_n; ++tx) {
      const float v = row[tx * bb];
      if (v > best) {
        best = v;
        bidx = ty * tx_n + tx;
      }
    }
  }

  const size_t o = (size_t)bi * a * bb + phase;
  best_out[o] = best;
  idx_out[o] = bidx;
  const int y = (bidx / tx_n) * a + py;
  const int x = (bidx % tx_n) * bb + px;
  const T* f = field + (size_t)bi * c * plane
               + ((size_t)y * w + x) * pix_stride;
  T* d = dirs_out + o * c;
  for (int ci = 0; ci < c; ++ci) d[ci] = f[(size_t)ci * ch_stride];
}

template <typename T>
int launch(const float* score, const T* field, float* best, int* idx,
           T* dirs, int b, int c, int h, int w, int a, int bb,
           long long pix_stride, long long ch_stride, cudaStream_t stream) {
  const int threads = 128;
  dim3 grid((a * bb + threads - 1) / threads, b);
  select_kernel<T><<<grid, threads, 0, stream>>>(
      score, field, best, idx, dirs, c, h, w, a, bb, pix_stride, ch_stride);
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
                       (long long)h * w, stream);
}

// K2. score [b, h, w] f32, field [b, h, w, c] of elem_bytes-wide values
// (4: f32, 2: bf16) -> best [b, a, bb] f32, idx [b, a, bb] i32,
// dirs [b, a, bb, c] in the field's type. h % a == 0 == w % bb.
extern "C" int pvnet_select_nhwc(const float* score, const void* field,
                                 float* best, int* idx, void* dirs,
                                 int b, int c, int h, int w, int a, int bb,
                                 int elem_bytes, cudaStream_t stream) {
  if (elem_bytes == 4)
    return launch<float>(score, static_cast<const float*>(field), best, idx,
                         static_cast<float*>(dirs), b, c, h, w, a, bb, c, 1,
                         stream);
  if (elem_bytes == 2)
    return launch<unsigned short>(
        score, static_cast<const unsigned short*>(field), best, idx,
        static_cast<unsigned short*>(dirs), b, c, h, w, a, bb, c, 1, stream);
  return (int)cudaErrorInvalidValue;
}
