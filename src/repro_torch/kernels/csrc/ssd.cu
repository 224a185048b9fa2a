// Mamba-2 SSD chunk scan for Hopper (sm_90a): log_a [B, H, S], dtx
// [B, S, H, P], Bm and C [B, S, N], h0 [B, H, N, P] -> y [B, S, H, P] and
// h_last [B, H, N, P]; float32 or bfloat16 in and out, float32 math and
// state.
//
// Replaces: src/repro/kernels/ssd/ssd.py, function `ssd_scan`
// (`_ssd_kernel`), the Pallas TPU kernel with grid (B, H, S/Q) whose chunk
// axis runs in order ("arbitrary") and carries the [N, P] state in VMEM
// scratch, doing three MXU contractions per chunk.
//
// What bounds it on the H100: per chunk of Q steps it does 2*Q*Q*N (C B^T)
// + 2*Q*Q*P (intra) + 2*Q*N*P (inter) + 2*Q*N*P (state) FLOP on Q*(1 + P +
// 2N) inputs, some 110 FLOP per byte at Q = 64, P = 64, N = 128 in float32 —
// above the card's float32 SIMT balance point (67 TFLOP/s over 3.35 TB/s =
// 20), so it is bound by operations; in practice by shared-memory traffic,
// since every multiply-add reads its operands from shared memory.
//
// Design: blocks run in parallel and in no order on Hopper, so the chunk
// axis cannot be a grid axis that carries state: one block per (b, h) loops
// over the chunks itself and keeps the [N, P] float32 state in shared
// memory for the whole sequence. Per chunk it stages log_a, x, B and C in
// shared memory as float32, takes the inclusive cumsum of log_a, forms the
// masked decay scores (C_i . B_j) exp(cum_i - cum_j) for i >= j, writes
// y = scores @ x + exp(cum) * (C @ h), and updates h = exp(total) h +
// (B * exp(total - cum))^T @ x — the reference's order of operations, so
// float32 agrees to its 3e-4 tolerance. The chunk Q is a runtime argument
// (dynamic shared memory, opted into above 48 KB); shared memory bounds it:
// at mamba2-2.7b's P = 64, N = 128, Q = 64 needs 129 KB and Q = 128 would
// need 259 KB, over the 227 KB a block may use. The last chunk may be
// ragged: its missing steps are zero (log_a 0, x 0, B 0), which adds
// nothing to the state, and are not stored. B rows are padded by one float
// so the score loop, whose threads walk B rows, does not hit one bank.
// Known limit: one block per (b, h) gives 80 blocks on 132 SMs at B = 1 for
// mamba2-2.7b (H = 80); splitting the sequence with a second pass over the
// chunk states is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 256;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the H100's per-block maximum

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_bytes(int q, int p, int n) {
  return sizeof(float) * (2 * (size_t)q + (size_t)q * p +
                          (size_t)q * (n + 1) + (size_t)q * n +
                          (size_t)q * q + (size_t)n * p);
}

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ log_a, const T* __restrict__ dtx,
           const T* __restrict__ bm, const T* __restrict__ cm,
           const T* __restrict__ h0, T* __restrict__ y, T* __restrict__ h_out,
           int nh, int s, int p, int n, int q) {
  extern __shared__ float smem[];
  float* cum = smem;                  // [q] inclusive cumsum of log_a
  float* wv = cum + q;                // [q] exp(total - cum)
  float* xs = wv + q;                 // [q][p]
  float* bs = xs + q * p;             // [q][n + 1], padded rows
  float* cs = bs + q * (n + 1);       // [q][n]
  float* sc = cs + q * n;             // [q][q] masked decay scores
  float* hs = sc + q * q;             // [n][p] state

  const int tid = threadIdx.x;
  const int h = blockIdx.x, bb = blockIdx.y;
  const T* la_b = log_a + ((size_t)bb * nh + h) * s;
  const T* bm_b = bm + (size_t)bb * s * n;
  const T* cm_b = cm + (size_t)bb * s * n;
  const size_t st_off = ((size_t)bb * nh + h) * n * p;

  for (int i = tid; i < n * p; i += NT) hs[i] = to_f32(h0[st_off + i]);

  for (int t0 = 0; t0 < s; t0 += q) {
    const int qn = min(q, s - t0);
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < q; i += NT) cum[i] = i < qn ? to_f32(la_b[t0 + i]) : 0.f;
    for (int i = tid; i < q * p; i += NT) {
      const int r = i / p, c = i % p;
      xs[i] = r < qn ? to_f32(dtx[(((size_t)bb * s + t0 + r) * nh + h) * p + c])
                     : 0.f;
    }
    for (int i = tid; i < q * n; i += NT) {
      const int r = i / n, c = i % n;
      const bool ok = r < qn;
      const size_t src = (size_t)(t0 + r) * n + c;
      bs[r * (n + 1) + c] = ok ? to_f32(bm_b[src]) : 0.f;
      cs[i] = ok ? to_f32(cm_b[src]) : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.f;
      for (int i = 0; i < q; ++i) {
        acc += cum[i];
        cum[i] = acc;
      }
    }
    __syncthreads();
    const float total = cum[q - 1];
    for (int i = tid; i < q; i += NT) wv[i] = expf(total - cum[i]);

    // Scores: (C_i . B_j) * exp(cum_i - cum_j) below the diagonal.
    for (int e = tid; e < q * q; e += NT) {
      const int i = e / q, j = e % q;
      float v = 0.f;
      if (i >= j) {
        const float* ci = cs + i * n;
        const float* bj = bs + j * (n + 1);
        float dot = 0.f;
        for (int k = 0; k < n; ++k) dot = fmaf(ci[k], bj[k], dot);
        v = dot * expf(cum[i] - cum[j]);
      }
      sc[e] = v;
    }
    __syncthreads();

    // y = scores @ x + exp(cum) * (C @ h_prev).
    for (int e = tid; e < qn * p; e += NT) {
      const int i = e / p, c = e % p;
      const float* si = sc + i * q;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(si[j], xs[j * p + c], intra);
      const float* ci = cs + i * n;
      float inter = 0.f;
      for (int k = 0; k < n; ++k) inter = fmaf(ci[k], hs[k * p + c], inter);
      store(&y[(((size_t)bb * s + t0 + i) * nh + h) * p + c],
            intra + inter * expf(cum[i]));
    }
    __syncthreads();  // every read of h_prev is done

    // h = exp(total) h_prev + (B * exp(total - cum))^T @ x.
    const float decay = expf(total);
    for (int e = tid; e < n * p; e += NT) {
      const int k = e / p, c = e % p;
      float acc = 0.f;
      for (int j = 0; j < q; ++j) {
        acc = fmaf(bs[j * (n + 1) + k] * wv[j], xs[j * p + c], acc);
      }
      hs[e] = decay * hs[e] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < n * p; i += NT) store(&h_out[st_off + i], hs[i]);
}

template <typename T>
int launch(const void* log_a, const void* dtx, const void* bm, const void* cm,
           const void* h0, void* y, void* h_out, int b, int nh, int s, int p,
           int n, int q, cudaStream_t stream) {
  const size_t smem = smem_bytes(q, p, n);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = ssd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nh, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(dtx),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(h0), static_cast<T*>(y), static_cast<T*>(h_out),
      nh, s, p, n, q);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is the chunk length (1 <= q; the last
// chunk may be shorter). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an argument this file does not take (a chunk
// whose shared memory exceeds 227 KB).
extern "C" int repro_ssd(const void* log_a, const void* dtx, const void* bm,
                         const void* cm, const void* h0, void* y, void* h_out,
                         int b, int nh, int s, int p, int n, int q, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || nh <= 0 || s <= 0 || p <= 0 || n <= 0 || q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch<float>(log_a, dtx, bm, cm, h0, y, h_out, b, nh, s, p, n, q,
                         st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(log_a, dtx, bm, cm, h0, y, h_out, b, nh, s, p,
                                 n, q, st);
  }
  return (int)cudaErrorInvalidValue;
}
