// Flash decode for Hopper (sm_90a): one query per sequence over a KV cache,
// q [B, Hq, D] x k, v [B, Hkv, S, D] -> [B, Hq, D], float32 or bfloat16 in
// and out, float32 statistics and accumulator.
//
// Replaces: src/repro/kernels/flash_attention/decode.py, function
// `flash_decode` (`_decode_kernel`), the Pallas TPU kernel with grid
// (B, Hkv, S/bkv) whose KV axis runs in order and whose grouped queries of
// one KV head stay resident in VMEM while K/V blocks stream.
//
// What bounds it on the H100: it reads every visible cache row once
// (2 * Hkv * (pos + 1) * D elements) for 4 * D FLOP per (query head, key),
// about n_rep FLOP per byte — far below the card's balance point, so it is
// bound by device-memory bytes.
//
// Design: one thread block per (b, kv-head) keeps the n_rep grouped queries
// in shared memory, so each K/V row is read from device memory once per
// group rather than once per query head, and loops over bkv-row blocks in
// place of the sequential Pallas grid axis, carrying the online-softmax
// statistics in shared memory and the accumulator in registers. Without a
// kv_pos map (a linear cache, slot i = position i) blocks past `pos`, or
// wholly left of the window, are never read — the reference's `monotonic`
// block skip; with a kv_pos map (ring caches, -1 = unwritten) every block is
// visited and masking is per key. The cache length need not be a multiple
// of bkv: the last block is masked. Numerics follow the reference: NEG_INF =
// -2e30, softcap before the mask, the 1e-30 clamp of the denominator.
//
// Known limit: with B = 1 and Hkv = 2 (qwen2 serving, one request per slot)
// the grid is two blocks, so two of the 132 SMs stream the cache and the
// rest idle. Splitting the KV range across blocks with a log-sum-exp combine
// of the partials (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float NEG_INF = -2.0e30f;
constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int REP_MAX = 32;
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
size_t smem_bytes(int n_rep, int bkv) {
  return sizeof(float) * ((size_t)n_rep * D + (size_t)bkv * (D + 1) +
                          (size_t)bkv * D + (size_t)n_rep * bkv +
                          3 * (size_t)n_rep);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_pos,
                    T* __restrict__ out, int hq, int hkv, int s, int bkv,
                    int pos, float scale, int window, float softcap) {
  static_assert(NT % D == 0, "head_dim must divide the thread count");
  constexpr int R_STEP = NT / D;  // rows between one thread's groups
  constexpr int MAXG = (REP_MAX + R_STEP - 1) / R_STEP;

  const int n_rep = hq / hkv;
  extern __shared__ float smem[];
  float* qs = smem;                  // [n_rep][D], pre-scaled
  float* ks = qs + n_rep * D;        // [bkv][D + 1], padded rows
  float* vs = ks + bkv * (D + 1);    // [bkv][D]
  float* ps = vs + bkv * D;          // [n_rep][bkv]
  float* m_s = ps + n_rep * bkv;     // [n_rep]
  float* l_s = m_s + n_rep;
  float* a_s = l_s + n_rep;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = blockIdx.x, bb = blockIdx.y;
  const T* qb = q + ((size_t)bb * hq + (size_t)g * n_rep) * D;
  const T* kb = k + ((size_t)bb * hkv + g) * (size_t)s * D;
  const T* vb = v + ((size_t)bb * hkv + g) * (size_t)s * D;
  T* ob = out + ((size_t)bb * hq + (size_t)g * n_rep) * D;

  for (int i = tid; i < n_rep * D; i += NT) qs[i] = to_f32(qb[i]) * scale;
  for (int r = tid; r < n_rep; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  int ib_lo = 0, ib_hi = (s + bkv - 1) / bkv;
  if (kv_pos == nullptr) {
    ib_hi = min(ib_hi, pos / bkv + 1);
    if (window > 0) ib_lo = max(0, pos - window + 1) / bkv;
  }

  const int d = tid % D;
  const int r0t = tid / D;
  float acc[MAXG];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) acc[gi] = 0.f;

  for (int ib = ib_lo; ib < ib_hi; ++ib) {
    const int k0 = ib * bkv;
    const int kn = min(bkv, s - k0);
    __syncthreads();
    for (int i = tid; i < bkv * D; i += NT) {
      const int c = i / D, dd = i % D;
      const bool ok = c < kn;
      const size_t src = (size_t)(k0 + c) * D + dd;
      ks[c * (D + 1) + dd] = ok ? to_f32(kb[src]) : 0.f;
      vs[i] = ok ? to_f32(vb[src]) : 0.f;
    }
    __syncthreads();

    // Logits: each thread takes up to four query rows against one key.
    const int n_quads = (n_rep + 3) / 4;
    for (int i = tid; i < n_quads * bkv; i += NT) {
      const int c = i % bkv, r0 = (i / bkv) * 4;
      const float* kr = ks + c * (D + 1);
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int dd = 0; dd < D; ++dd) {
        const float kv = kr[dd];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (r0 + j < n_rep) sc[j] = fmaf(qs[(r0 + j) * D + dd], kv, sc[j]);
        }
      }
      const int kp = kv_pos != nullptr ? (c < kn ? kv_pos[k0 + c] : -1)
                                       : k0 + c;
      bool vis = c < kn && kp >= 0 && kp <= pos;
      if (window > 0) vis = vis && kp > pos - window;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (r0 + j < n_rep) {
          float x = sc[j];
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          ps[(r0 + j) * bkv + c] = vis ? x : NEG_INF;
        }
      }
    }
    __syncthreads();

    for (int r = warp; r < n_rep; r += NWARPS) {
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

#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      const int r = r0t + gi * R_STEP;
      if (r < n_rep) acc[gi] *= a_s[r];
    }
    for (int c = 0; c < bkv; ++c) {
      const float vv = vs[c * D + d];
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        const int r = r0t + gi * R_STEP;
        if (r < n_rep) acc[gi] = fmaf(ps[r * bkv + c], vv, acc[gi]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    const int r = r0t + gi * R_STEP;
    if (r < n_rep) store(&ob[(size_t)r * D + d], acc[gi] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_pos,
           void* out, int b, int hq, int hkv, int s, int bkv, int pos,
           float scale, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(hq / hkv, bkv);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = flash_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hkv, b);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_pos, static_cast<T*>(out), hq, hkv, s, bkv,
      pos, scale, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int dh, const void* q, const void* k, const void* v,
               const int* kv_pos, void* out, int b, int hq, int hkv, int s,
               int bkv, int pos, float scale, int window, float softcap,
               cudaStream_t st) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, kv_pos, out, b, hq, hkv, s, bkv, pos,
                           scale, window, softcap, st);
    case 32:
      return launch<T, 32>(q, k, v, kv_pos, out, b, hq, hkv, s, bkv, pos,
                           scale, window, softcap, st);
    case 64:
      return launch<T, 64>(q, k, v, kv_pos, out, b, hq, hkv, s, bkv, pos,
                           scale, window, softcap, st);
    case 128:
      return launch<T, 128>(q, k, v, kv_pos, out, b, hq, hkv, s, bkv, pos,
                            scale, window, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_pos: int32 [S] slot -> position map,
// or null for a linear cache. window <= 0 / softcap <= 0 mean none. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for an
// argument this file does not take.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* kv_pos, void* out, int b,
                                  int hq, int hkv, int s, int dh, int dtype,
                                  int bkv, int pos, float scale, int window,
                                  float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > REP_MAX || bkv <= 0 ||
      pos < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int* kp = static_cast<const int*>(kv_pos);
  if (dtype == 0) {
    return dispatch_d<float>(dh, q, k, v, kp, out, b, hq, hkv, s, bkv, pos,
                             scale, window, softcap, st);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(dh, q, k, v, kp, out, b, hq, hkv, s, bkv,
                                     pos, scale, window, softcap, st);
  }
  return (int)cudaErrorInvalidValue;
}
