// Flash attention forward for Hopper (sm_90a): online-softmax attention of
// q [B, Hq, Sq, D] over k, v [B, Hkv, Skv, D], float32 or bfloat16 in and
// out, float32 statistics and accumulator.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py, function
// `flash_attention` (`_flash_kernel`), the Pallas TPU kernel with grid
// (B, Hq, Sq/bq, Skv/bkv) whose KV axis runs in order ("arbitrary") and
// carries the running max, denominator and accumulator in VMEM scratch.
//
// What bounds it on the H100: whole-prompt prefill does 4*D FLOP per visible
// (query, key) pair and reads q, k, v once, so it is bound by operations —
// here the float32 SIMT rate (67 TFLOP/s), since this version does not use
// the tensor cores. Shared-memory traffic is the practical limit: every
// multiply-add reads its operands from shared memory.
//
// Design: Hopper runs blocks in parallel and in no order, so nothing can be
// carried between blocks the way Pallas carries scratch across its
// sequential grid axis. One thread block owns one (b, h, q-block) and loops
// over the KV blocks itself, holding the running max, denominator and
// rescale factor per row in shared memory and the output accumulator in
// registers (each thread owns one head-dim column of up to 32 row quads).
// KV blocks entirely above the causal diagonal or left of the window are
// never loaded — the same block skip as `pl.when(relevant)`. GQA reads KV
// head h / n_rep. Prompts of any length work: the last q and KV blocks are
// masked instead of requiring bq | Sq and bkv | Skv. The numerics follow the
// reference: NEG_INF = -2e30 (not -inf), the mask applied after the softcap,
// and the 1e-30 clamp of the denominator. The tile (bq, bkv) is a runtime
// argument (multiples of 4, bq at most REPRO_FA_BQ_LIMITS gives: 128, and
// 64 at D = 256 so the per-thread accumulator stays at 64 floats, since at
// D = 256 each thread owns one column of every row quad); its
// shared-memory working set is checked
// against the 227 KB a block may use. wgmma, TMA and warp specialisation are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float NEG_INF = -2.0e30f;
constexpr int NT = 256;         // threads per block
constexpr int NWARPS = NT / 32;
// The largest bq each head dim takes, as X(head dim, bq): the accumulator
// holds bq / 4 / (NT / D) row quads of 4 floats per thread, 64 floats at
// D = 128, bq = 128 and at D = 256, bq = 64. flash_attention.py reads this
// table, so the launch rule is stated here alone.
#define REPRO_FA_BQ_LIMITS \
  X(16, 128) X(32, 128) X(64, 128) X(128, 128) X(256, 64)
__host__ __device__ constexpr int bq_max_for(int D) {
#define X(d, bq) D == d ? bq :
  return REPRO_FA_BQ_LIMITS 0;
#undef X
}
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the H100's per-block maximum

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int D>
size_t smem_bytes(int bq, int bkv) {
  return sizeof(float) * ((size_t)bq * D + (size_t)bkv * (D + 1) +
                          (size_t)bkv * D + (size_t)bq * bkv + 3 * (size_t)bq);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq,
                       int hkv, int sq, int skv, int bq, int bkv, float scale,
                       int causal, int window, float softcap, int q_offset) {
  static_assert(NT % D == 0, "head_dim must divide the thread count");
  constexpr int RQ_STEP = NT / D;  // row quads between one thread's groups
  constexpr int MAXG = (bq_max_for(D) / 4 + RQ_STEP - 1) / RQ_STEP;

  extern __shared__ float smem[];
  float* qs = smem;                  // [bq][D], pre-scaled queries
  float* ks = qs + bq * D;           // [bkv][D + 1], padded rows
  float* vs = ks + bkv * (D + 1);    // [bkv][D]
  float* ps = vs + bkv * D;          // [bq][bkv] logits, then probabilities
  float* m_s = ps + bq * bkv;        // [bq] running max
  float* l_s = m_s + bq;             // [bq] running denominator
  float* a_s = l_s + bq;             // [bq] this block's rescale factor

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int iq = blockIdx.x, h = blockIdx.y, bb = blockIdx.z;
  const int g = h / (hq / hkv);
  const int q0 = iq * bq;
  const int rows = min(bq, sq - q0);
  const T* qb = q + (((size_t)bb * hq + h) * sq + q0) * D;
  const T* kb = k + ((size_t)bb * hkv + g) * (size_t)skv * D;
  const T* vb = v + ((size_t)bb * hkv + g) * (size_t)skv * D;
  T* ob = out + (((size_t)bb * hq + h) * sq + q0) * D;

  for (int i = tid; i < bq * D; i += NT) {
    qs[i] = (i / D) < rows ? to_f32(qb[i]) * scale : 0.f;
  }
  for (int r = tid; r < bq; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // KV blocks any row of this q-block can see.
  const int q_first = q_offset + q0;
  const int q_last = q_offset + q0 + rows - 1;
  const int kv_hi = causal ? min(skv, q_last + 1) : skv;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int ib_lo = kv_lo / bkv;
  const int ib_hi = (kv_hi + bkv - 1) / bkv;

  const int d = tid % D;
  const int rq0 = tid / D;
  float acc[MAXG][4];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[gi][j] = 0.f;

  for (int ib = ib_lo; ib < ib_hi; ++ib) {
    const int k0 = ib * bkv;
    const int kn = min(bkv, skv - k0);
    __syncthreads();  // the previous block is done with ks, vs, ps
    for (int i = tid; i < bkv * D; i += NT) {
      const int c = i / D, dd = i % D;
      const bool ok = c < kn;
      const size_t src = (size_t)(k0 + c) * D + dd;
      ks[c * (D + 1) + dd] = ok ? to_f32(kb[src]) : 0.f;
      vs[i] = ok ? to_f32(vb[src]) : 0.f;
    }
    __syncthreads();

    // Logits: each thread takes four rows against one key.
    for (int i = tid; i < (bq / 4) * bkv; i += NT) {
      const int c = i % bkv, r0 = (i / bkv) * 4;
      const float* kr = ks + c * (D + 1);
      const float* qr = qs + r0 * D;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        const float kv = kr[dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = fmaf(qr[j * D + dd], kv, s[j]);
      }
      const int kpos = k0 + c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[j];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const int qpos = q_first + r0 + j;
        bool vis = c < kn;
        if (causal) vis = vis && kpos <= qpos;
        if (window > 0) vis = vis && kpos > qpos - window;
        ps[(r0 + j) * bkv + c] = vis ? x : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax, one warp per row.
    for (int r = warp; r < bq; r += NWARPS) {
      float* pr = ps + r * bkv;
      float mx = NEG_INF;
      for (int c = lane; c < bkv; c += 32) mx = fmaxf(mx, pr[c]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < bkv; c += 32) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for this thread's column d.
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      const int r0 = (rq0 + gi * RQ_STEP) * 4;
      if (r0 < bq) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[gi][j] *= a_s[r0 + j];
      }
    }
    for (int c = 0; c < bkv; ++c) {
      const float vv = vs[c * D + d];
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        const int r0 = (rq0 + gi * RQ_STEP) * 4;
        if (r0 < bq) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[gi][j] = fmaf(ps[(r0 + j) * bkv + c], vv, acc[gi][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    const int r0 = (rq0 + gi * RQ_STEP) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + j;
      if (r < rows) store(&ob[(size_t)r * D + d], acc[gi][j] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int sq, int skv, int bq, int bkv, float scale,
           int causal, int window, float softcap, int q_offset,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(bq, bkv);
  if (smem > (size_t)SMEM_LIMIT || bq > bq_max_for(D)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + bq - 1) / bq, hq, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, bq,
      bkv, scale, causal, window, softcap, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int dh, const void* q, const void* k, const void* v, void* out,
               int b, int hq, int hkv, int sq, int skv, int bq, int bkv,
               float scale, int causal, int window, float softcap,
               int q_offset, cudaStream_t s) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv, scale,
                           causal, window, softcap, q_offset, s);
    case 32:
      return launch<T, 32>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv, scale,
                           causal, window, softcap, q_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv, scale,
                           causal, window, softcap, q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv, scale,
                            causal, window, softcap, q_offset, s);
    case 256:
      return launch<T, 256>(q, k, v, out, b, hq, hkv, sq, skv, bq, bkv, scale,
                            causal, window, softcap, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means none, softcap <= 0
// means none. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an argument this file does not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int hq,
                                     int hkv, int sq, int skv, int dh,
                                     int dtype, int bq, int bkv, float scale,
                                     int causal, int window, float softcap,
                                     int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || bq <= 0 || bq % 4 != 0 || bkv <= 0 ||
      bkv % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return dispatch_d<float>(dh, q, k, v, out, b, hq, hkv, sq, skv, bq, bkv,
                             scale, causal, window, softcap, q_offset, s);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(dh, q, k, v, out, b, hq, hkv, sq, skv,
                                     bq, bkv, scale, causal, window, softcap,
                                     q_offset, s);
  }
  return (int)cudaErrorInvalidValue;
}
