// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t
// over a, x [B, S, F] from h0 [B, F] -> y [B, S, F] (every h_t) and h_last
// [B, F]; float32 or bfloat16 in and out, float32 state.
//
// Replaces: src/repro/kernels/rglru/rglru.py, function `rglru_scan`
// (`_rglru_kernel`), the Pallas TPU kernel with grid (B, F/bf, S/bt) whose
// time axis runs in order and carries the state of one feature block in
// VMEM scratch, scanning the bt rows of each (bt, bf) tile with a fori_loop.
//
// What bounds it on the H100: 2 FLOP per element on 3 elements moved (read
// a and x, write y), so on paper it is bound by device-memory bytes. In
// practice the scan is sequential in time: each step waits for the last,
// and at recurrentgemma-9b's F = 4096 and B = 1 there are only 4096
// independent chains, two SMs' worth of resident threads, so it is bound by
// the latency of that chain, not by bandwidth.
//
// Design: one thread per feature scans the time axis, so no state crosses
// threads or blocks; a block of bf threads owns bf neighbouring features of
// one batch row (grid (F/bf, B)). Each step of the outer loop stages a
// (bt, bf) tile of a and x in shared memory as float32: thread f loads
// column f of all bt rows, and since neighbouring threads read neighbouring
// features every row's load coalesces, with the bt loads of a thread in
// flight together ahead of its scan. The tile (bt, bf) is a runtime launch
// argument (bf threads, 8 * bt * bf bytes of dynamic shared memory); ragged
// time and feature edges are masked. Each thread reads back only what it
// staged, so no barrier is needed. A chunked parallel scan, which would put
// more than F chains in flight, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the H100's per-block maximum

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int bt, int bf) { return 2 * sizeof(float) * (size_t)bt * bf; }

template <typename T>
__global__ void rglru_kernel(const T* __restrict__ a, const T* __restrict__ x,
                             const T* __restrict__ h0, T* __restrict__ y,
                             T* __restrict__ h_out, int s, int f, int bt) {
  extern __shared__ float smem[];
  const int bf = blockDim.x;
  float* as = smem;            // [bt][bf]
  float* xs = as + bt * bf;    // [bt][bf]
  const int tid = threadIdx.x;
  const int feat = blockIdx.x * bf + tid;
  const int bb = blockIdx.y;
  if (feat >= f) return;
  const size_t row0 = (size_t)bb * s;
  float h = to_f32(h0[(size_t)bb * f + feat]);
  for (int t0 = 0; t0 < s; t0 += bt) {
    const int tn = min(bt, s - t0);
    for (int t = 0; t < tn; ++t) {
      const size_t i = (row0 + t0 + t) * f + feat;
      as[t * bf + tid] = to_f32(a[i]);
      xs[t * bf + tid] = to_f32(x[i]);
    }
    for (int t = 0; t < tn; ++t) {
      // a * h, then + x, each rounded, as the plain version computes it.
      h = __fadd_rn(__fmul_rn(as[t * bf + tid], h), xs[t * bf + tid]);
      store(&y[(row0 + t0 + t) * f + feat], h);
    }
  }
  store(&h_out[(size_t)bb * f + feat], h);
}

template <typename T>
int launch(const void* a, const void* x, const void* h0, void* y, void* h_out,
           int b, int s, int f, int bt, int bf, cudaStream_t stream) {
  const size_t smem = smem_bytes(bt, bf);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = rglru_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((f + bf - 1) / bf, b);
  kernel<<<grid, bf, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const T*>(h0), static_cast<T*>(y), static_cast<T*>(h_out), s,
      f, bt);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (bt, bf): time rows staged per step and
// features (threads) per block, bf <= 1024. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for an argument this file does not
// take (too many threads, or a tile over 227 KB of shared memory).
extern "C" int repro_rglru(const void* a, const void* x, const void* h0,
                           void* y, void* h_out, int b, int s, int f, int bt,
                           int bf, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || f <= 0 || bt <= 0 || bf <= 0 || bf > MAX_THREADS) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch<float>(a, x, h0, y, h_out, b, s, f, bt, bf, st);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(a, x, h0, y, h_out, b, s, f, bt, bf, st);
  }
  return (int)cudaErrorInvalidValue;
}
