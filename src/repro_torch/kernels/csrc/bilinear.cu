// Bilinear image upscale by an integer scale for Hopper (sm_90a): src [H, W]
// -> out [H*scale, W*scale], float32 or bfloat16 in and out, float32 math.
//
// Replaces: src/repro/kernels/bilinear/bilinear.py, function
// `bilinear_upscale` (`_bilinear_kernel`, `_tent_weights`), the Pallas TPU
// kernel that computes the upscale as `Wy @ src @ Wx^T` on the MXU with
// banded tent-weight matrices built from iota, because a TPU has no
// efficient per-element gather.
//
// What bounds it on the H100: it reads the source once (through L1/L2) and
// writes scale^2 times as many output pixels, at about 10 FLOP each, so it
// is bound by device-memory bytes — the output's, above all.
//
// Design: a GPU gathers well, so this is the paper's own CUDA kernel: one
// thread per output pixel, block (bw, bh) = the tile, which is a runtime
// launch argument (bh * bw <= 1024 threads, no shared memory), so one build
// serves every tile of a sweep. Each thread maps its pixel to the source
// position min(out / scale, len - 1) on both axes — the same clamped map as
// the TPU kernel's tent weights — and blends the four neighbours
// src[y1|y2][x1|x2] with x2 = min(x1 + 1, W - 1) (replicate edge). Threads
// of one warp write neighbouring output pixels of one row, so the stores
// coalesce; the ragged last blocks are masked, so no tile has to divide the
// output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void bilinear_kernel(const T* __restrict__ src, T* __restrict__ out,
                                int h, int w, int scale) {
  const int oh = h * scale, ow = w * scale;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= ow || oy >= oh) return;
  const float fs = (float)scale;
  const float yp = fminf((float)oy / fs, (float)(h - 1));
  const float xp = fminf((float)ox / fs, (float)(w - 1));
  const int y1 = (int)floorf(yp), x1 = (int)floorf(xp);
  const int y2 = min(y1 + 1, h - 1), x2 = min(x1 + 1, w - 1);
  const float dy = yp - (float)y1, dx = xp - (float)x1;
  const T* r1 = src + (size_t)y1 * w;
  const T* r2 = src + (size_t)y2 * w;
  const float top = (1.f - dx) * to_f32(r1[x1]) + dx * to_f32(r1[x2]);
  const float bot = (1.f - dx) * to_f32(r2[x1]) + dx * to_f32(r2[x2]);
  store(&out[(size_t)oy * ow + ox], (1.f - dy) * top + dy * bot);
}

template <typename T>
int launch(const void* src, void* out, int h, int w, int scale, int bh,
           int bw, cudaStream_t stream) {
  const int oh = h * scale, ow = w * scale;
  dim3 block(bw, bh);
  dim3 grid((ow + bw - 1) / bw, (oh + bh - 1) / bh);
  if (grid.y > (unsigned)MAX_GRID_Y) return (int)cudaErrorInvalidValue;
  bilinear_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(out), h, w, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (bh, bw) is the thread block, at most
// 1024 threads. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an argument this file does not take.
extern "C" int repro_bilinear(const void* src, void* out, int h, int w,
                              int scale, int dtype, int bh, int bw,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || w <= 0 || scale <= 0 || bh <= 0 || bw <= 0 ||
      bh * bw > MAX_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch<float>(src, out, h, w, scale, bh, bw, s);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(src, out, h, w, scale, bh, bw, s);
  }
  return (int)cudaErrorInvalidValue;
}
