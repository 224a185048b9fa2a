// Tiled GEMM for Hopper (sm_90a): c[M,N] = a[M,K] @ b[K,N], float32 or
// bfloat16 in and out, float32 accumulation.
//
// Replaces: src/repro/kernels/matmul/matmul.py, function `matmul`
// (`_matmul_kernel`), the Pallas TPU kernel with a (bm, bk, bn) grid and an
// f32 VMEM accumulator cast on the last K step.
//
// What bounds it on the H100: on the serving path it runs the SwiGLU GEMMs
// of one layer. At decode (M = 1) it is a matrix-vector product: the weight
// (1536 x 8960 x 4 B = 55 MB in float32) is read once for 2 FLOP per
// element, so it is bound by device-memory bytes (~16 us at 3.35 TB/s). At
// prefill (M = prompt length) it is bound by operations: this kernel
// computes in float32 on the SIMT units (67 TFLOP/s), not on the tensor
// cores.
//
// Design: one thread block owns a (BM x BN) output tile and walks K in BK
// steps through shared memory (A transposed and padded against bank
// conflicts, B row-major); each of 256 threads keeps a TM x TN register
// accumulator on an interleaved row/column pattern, so shared-memory reads
// are broadcasts or conflict-free and global stores coalesce. Ragged edges
// are masked: qwen2's d_ff = 8960 is no multiple of the TPU's 512 tile, and
// no tile has to divide the problem here. Two tiles are compiled: (8, 32,
// 128) for the decode GEMV, whose waste on the M side costs nothing while
// bytes bound it, and (64, 16, 64) for prefill. When the output tiles are
// too few to fill the 132 SMs (decode, or the narrow N = 1536 down
// projection), K is split over blockIdx.z into a float32 workspace that a
// second kernel sums in a fixed order (deterministic, no atomics).
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int BM, int BK, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, float* __restrict__ ws, int m, int n, int k,
              int k_split) {
  constexpr int TX = BN / TN;  // threads across N
  constexpr int TY = BM / TM;  // threads across M
  constexpr int NT = TX * TY;
  __shared__ float as[BK][BM + 1];  // A tile, transposed: as[kk][mm]
  __shared__ float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(k, k_begin + k_split);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
#pragma unroll
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] =
          (gm < m && gk < k_end) ? to_f32(a[(size_t)gm * k + gk]) : 0.f;
    }
#pragma unroll
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      bs[kk][nn] =
          (gk < k_end && gn < n) ? to_f32(b[(size_t)gk * n + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gm < m && gn < n) {
        if (ws != nullptr)
          ws[((size_t)blockIdx.z * m + gm) * n + gn] = acc[i][j];
        else
          store(&c[(size_t)gm * n + gn], acc[i][j]);
      }
    }
  }
}

// Sum the K-split partials in split order and cast to the output type.
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws, T* __restrict__ c,
                              size_t mn, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * mn + i];
  store(&c[i], s);
}

template <typename T, int BM, int BK, int BN, int TM, int TN>
void launch(const void* a, const void* b, void* c, void* ws, int m, int n,
            int k, int splits, cudaStream_t stream) {
  // Each split covers a whole number of BK steps; a split past K would do
  // no work, so the grid keeps only the splits that cover K.
  int k_split = (k + splits - 1) / splits;
  k_split = (k_split + BK - 1) / BK * BK;
  const int z = (k + k_split - 1) / k_split;
  float* part = z > 1 ? static_cast<float*>(ws) : nullptr;
  dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, z);
  matmul_kernel<T, BM, BK, BN, TM, TN><<<grid, (BM / TM) * (BN / TN), 0,
                                         stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      part, m, n, k, k_split);
  if (part != nullptr) {
    const size_t mn = (size_t)m * n;
    splitk_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
        part, static_cast<T*>(c), mn, z);
  }
}

template <typename T>
int dispatch(const void* a, const void* b, void* c, void* ws, int m, int n,
             int k, int bm, int bk, int bn, int splits, cudaStream_t stream) {
  if (bm == 8 && bk == 32 && bn == 128) {
    launch<T, 8, 32, 128, 1, 4>(a, b, c, ws, m, n, k, splits, stream);
  } else if (bm == 64 && bk == 16 && bn == 64) {
    launch<T, 64, 16, 64, 4, 4>(a, b, c, ws, m, n, k, splits, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ws: float32 workspace of splits*m*n
// elements (unused when splits == 1). Returns cudaGetLastError() after the
// launches; cudaErrorInvalidValue for a tile or dtype this file does not
// compile.
extern "C" int repro_matmul(const void* a, const void* b, void* c, void* ws,
                            int m, int n, int k, int dtype, int bm, int bk,
                            int bn, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return dispatch<float>(a, b, c, ws, m, n, k, bm, bk, bn, splits, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(a, b, c, ws, m, n, k, bm, bk, bn, splits,
                                   s);
  }
  return (int)cudaErrorInvalidValue;
}
