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
// (2 * Hkv * keys * D elements) for 4 * D FLOP per (query head, key), about
// n_rep FLOP per byte — far below the card's balance point, so device-memory
// bytes bound it. At B = 1 the cache is small (1 MB for qwen2 at position
// 511) and the time is latency: what matters is how many SMs pull at once.
//
// Design (flash-decoding): the grid is (splits, Hkv, B). Each block keeps the
// n_rep grouped queries of its KV head in shared memory, so each K/V row is
// read once per group, and streams a contiguous run of bkv-row blocks with
// the online softmax of the reference (statistics in shared memory, the
// accumulator in registers: each thread one head-dim column of every
// NT / D-th query row, so a block has 256 threads, or 320 at D = 80).
//
// The query position is an int32 scalar in device memory, read once by each
// block, so that one launch serves every decode step of a captured CUDA
// graph. The grid therefore depends on the cache length alone: the wrapper
// sizes the split count from B * Hkv and the cache's ceil(S / bkv) blocks
// (about one wave of 132 blocks; 1 once B * Hkv fills the card). Each block
// derives the key blocks that hold visible keys from the position — with a
// linear cache (slot i = position i) [max(0, pos - window + 1), pos], the
// reference's block skip; with a kv_pos map (ring caches, -1 = unwritten)
// all S slots, masked per key. The first min(splits, blocks) splits share
// that run in equal parts, so at every position the work is what a grid
// sized from the host's position would do; a surplus split gets no block
// and writes the empty partial (m = NEG_INF, l = 0, acc = 0)
// (decode.py:decode_splits is this rule in Python). Thread 0 reads the
// position into shared memory while the block loads its queries, so the
// read adds no round trip of its own.
//
// A block writes its unnormalised accumulator and its (m, l) to a float32
// workspace, and a second kernel rescales each split by exp(m_i - M) and
// sums them in split order (deterministic). A split with no visible key has
// m = NEG_INF and drops out of that sum, and an empty partial adds nothing
// to it even where every m is NEG_INF; if no split sees a key, every
// visited split weighs 1 and the result is the reference's average of the
// masked rows it visited. With one split the block normalises and stores
// directly. Slots past the cache end (S need not be a multiple of
// bkv) get a logit of -inf, so they never count. Numerics otherwise follow
// the reference: NEG_INF = -2e30, softcap before the mask, the 1e-30 clamp
// of the denominator.
//
// On request (a non-null `lse`), each (b, query head) also gets its
// log-sum-exp, m + log l over the keys it saw, in float32 [B, Hq]: the one
// split block writes it beside its output, the combine as M + log(sum_i
// exp(m_i - M) l_i). Ranks that each hold a slice of a sequence-sharded
// cache combine their outputs with it (models/attention.py). The write is
// the template argument LSE of both kernels, so a call without it runs code
// compiled as it was before the output existed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr float NEG_INF = -2.0e30f;
constexpr int COMBINE_NT = 256;  // the most threads a combine block has
constexpr int COMBINE_WARPS = COMBINE_NT / 32;
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

// Threads of a decode block: 256, or where the head dim does not divide 256
// (80) four rows of it, a multiple of 32 too (320), so that every thread
// owns one head-dim column of its rows.
__host__ __device__ constexpr int threads_for(int d) {
  return 256 % d == 0 ? 256 : 4 * d;
}

// The key blocks that hold visible keys at position pos, [lo, lo + n), and
// the splits that share them, used = min(splits, n) (at least 1).
struct Run {
  int lo, n, used;
};
__device__ __forceinline__ Run visible_run(int pos, int s, int bkv,
                                           int window, bool linear,
                                           int splits) {
  const int n_all = (s + bkv - 1) / bkv;
  int lo = 0, hi = n_all;
  if (linear) {
    hi = min(n_all, pos / bkv + 1);
    if (window > 0) lo = max(0, pos - window + 1) / bkv;
  }
  lo = min(lo, hi);
  return Run{lo, hi - lo, max(1, min(splits, hi - lo))};
}

template <int D>
size_t smem_bytes(int n_rep, int bkv) {
  return sizeof(float) * ((size_t)n_rep * D + (size_t)bkv * (D + 1) +
                          (size_t)bkv * D + (size_t)n_rep * bkv +
                          3 * (size_t)n_rep);
}

// Each row's m + log l, from a call and not inline: inline, its logf took
// the D = 80 kernel from 96 registers to 108, and so from two blocks an SM
// to one, which made a one-split launch at B = 32 46% slower on the H100
// (PERF.md).
__device__ __noinline__ void write_lse(float* __restrict__ dst,
                                       const float* m_s, const float* l_s,
                                       int n_rep) {
  for (int r = threadIdx.x; r < n_rep; r += blockDim.x)
    dst[r] = m_s[r] + logf(l_s[r]);
}

// One block an SM as the floor lets ptxas keep what the loops need in
// registers: without it, once the position came from device memory, ptxas
// held D = 128 to 64 registers (80 before) and D = 256 to 128 (244), and the
// kernel ran up to 45% slower on the H100 (PERF.md).
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(threads_for(D), 1)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_pos,
                    const int* __restrict__ pos_ptr, T* __restrict__ out,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    float* __restrict__ lse, int hq, int hkv, int s, int bkv,
                    float scale, int window, float softcap) {
  constexpr int NT = threads_for(D);
  constexpr int NWARPS = NT / 32;
  static_assert(NT % D == 0 && NT % 32 == 0,
                "the thread count must be whole warps and whole rows");
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
  const int split = blockIdx.x, splits = gridDim.x;
  const int g = blockIdx.y, bb = blockIdx.z;
  const T* qb = q + ((size_t)bb * hq + (size_t)g * n_rep) * D;
  const T* kb = k + ((size_t)bb * hkv + g) * (size_t)s * D;
  const T* vb = v + ((size_t)bb * hkv + g) * (size_t)s * D;
  T* ob = out + ((size_t)bb * hq + (size_t)g * n_rep) * D;

  // The position, read once, its load in flight with the queries'.
  __shared__ int pos_s;
  if (tid == 0) pos_s = __ldg(pos_ptr);
  for (int i = tid; i < n_rep * D; i += NT) qs[i] = to_f32(qb[i]) * scale;
  for (int r = tid; r < n_rep; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();
  const int pos = pos_s;

  // This split's equal share of the visible key blocks; a surplus split has
  // none, and its loop below does not run: it writes the empty partial.
  const Run run = visible_run(pos, s, bkv, window, kv_pos == nullptr, splits);
  const int ib_begin =
      split < run.used ? run.lo + (int)((long long)split * run.n / run.used)
                       : 0;
  const int ib_end =
      split < run.used
          ? run.lo + (int)((long long)(split + 1) * run.n / run.used)
          : 0;

  const int d = tid % D;
  const int r0t = tid / D;
  float acc[MAXG];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) acc[gi] = 0.f;

  for (int ib = ib_begin; ib < ib_end; ++ib) {
    const int k0 = ib * bkv;
    const int kn = min(bkv, s - k0);
    __syncthreads();
    // Scalar loads, so that the stores into the padded K rows stay free of
    // bank conflicts: 16-byte loads stored element by element measured
    // slower at B = 128 on the H100.
#pragma unroll 4
    for (int i = tid; i < bkv * D; i += NT) {
      const int c = i / D, dd = i % D;
      const bool ok = c < kn;
      const size_t src = (size_t)(k0 + c) * D + dd;
      ks[c * (D + 1) + dd] = ok ? to_f32(kb[src]) : 0.f;
      vs[i] = ok ? to_f32(vb[src]) : 0.f;
    }
    __syncthreads();

    // Logits: each thread takes up to four query rows against one key
    // (splitting the head dim over lanes measured slower on the H100).
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
          // A slot past the cache end is no key at all: -inf, so exp gives
          // 0 even when every real key is masked.
          ps[(r0 + j) * bkv + c] = c >= kn ? -CUDART_INF_F : vis ? x : NEG_INF;
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

  if (ws_acc == nullptr) {
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      const int r = r0t + gi * R_STEP;
      if (r < n_rep)
        store(&ob[(size_t)r * D + d], acc[gi] / fmaxf(l_s[r], 1e-30f));
    }
    if constexpr (LSE)
      write_lse(lse + (size_t)bb * hq + (size_t)g * n_rep, m_s, l_s, n_rep);
    return;
  }
  // Partials of this split: ws_acc [B, Hkv, splits, n_rep, D] unnormalised,
  // ws_ml [B, Hkv, splits, n_rep, 2] = (m, l).
  const size_t part = ((size_t)bb * hkv + g) * splits + split;
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    const int r = r0t + gi * R_STEP;
    if (r < n_rep) ws_acc[(part * n_rep + r) * D + d] = acc[gi];
  }
  for (int r = tid; r < n_rep; r += NT) {
    ws_ml[(part * n_rep + r) * 2] = m_s[r];
    ws_ml[(part * n_rep + r) * 2 + 1] = l_s[r];
  }
}

// Combine the splits of one (query row, b, kv-head), one thread per head
// dim element (whole warps: threads past d only join the reductions):
// rescale each partial by exp(m_i - M), sum in split order, divide by
// max(l, 1e-30), cast. Dynamic shared memory: 2 * splits floats.
template <typename T, bool LSE>
__global__ void __launch_bounds__(COMBINE_NT)
flash_decode_combine(const float* __restrict__ ws_acc,
                     const float* __restrict__ ws_ml, T* __restrict__ out,
                     float* __restrict__ lse, int n_rep, int d, int splits) {
  extern __shared__ float cs[];
  float* w = cs;             // [splits] exp(m_i - M)
  float* wl = cs + splits;   // [splits] exp(m_i - M) * l_i
  __shared__ float red[COMBINE_WARPS];
  __shared__ float den_s;
  __shared__ float lse_s;
  const int r = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t bg = blockIdx.y;  // b * hkv + g
  const float* ml = ws_ml + bg * splits * n_rep * 2;
  float mx = NEG_INF;
  for (int z = tid; z < splits; z += nt)
    mx = fmaxf(mx, ml[((size_t)z * n_rep + r) * 2]);
  mx = warp_max(mx);
  if (tid % 32 == 0) red[tid / 32] = mx;
  __syncthreads();
  mx = red[0];
  for (int i = 1; i < (nt + 31) / 32; ++i) mx = fmaxf(mx, red[i]);
  for (int z = tid; z < splits; z += nt) {
    const float wz = expf(ml[((size_t)z * n_rep + r) * 2] - mx);
    w[z] = wz;
    wl[z] = wz * ml[((size_t)z * n_rep + r) * 2 + 1];
  }
  __syncthreads();
  if (tid == 0) {
    float den = 0.f;
    for (int z = 0; z < splits; ++z) den += wl[z];
    den_s = fmaxf(den, 1e-30f);
    if constexpr (LSE) lse_s = mx + logf(den);
  }
  const float* acc = ws_acc + (bg * splits * n_rep + r) * d;
  float num = 0.f;
  if (tid < d) {
#pragma unroll 16
    for (int z = 0; z < splits; ++z)
      num = fmaf(w[z], acc[(size_t)z * n_rep * d + tid], num);
  }
  __syncthreads();
  if (tid < d) store(&out[(bg * n_rep + r) * d + tid], num / den_s);
  // Stored last: stored where it is computed, before the loads above, it
  // made the combine ~2 us slower on the H100 (4.1 -> 6.1 us, PERF.md).
  if constexpr (LSE) {
    if (tid == 0) lse[bg * n_rep + r] = lse_s;
  }
}

struct Split {
  float* ws_acc;
  float* ws_ml;
  int splits;
};

template <typename T, int D, bool LSE>
int launch(const void* q, const void* k, const void* v, const int* kv_pos,
           const int* pos, void* out, float* lse, int b, int hq, int hkv,
           int s, int bkv, float scale, int window, float softcap, Split sp,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(hq / hkv, bkv);
  // The block's static shared int (the position) counts against the limit.
  if (smem + sizeof(int) > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_decode_kernel<T, D, LSE>;
  static size_t sized = 0;  // the dynamic shared memory already allowed
  if (smem > sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  const bool split = sp.splits > 1;
  dim3 grid(sp.splits, hkv, b);
  kernel<<<grid, threads_for(D), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_pos, pos, static_cast<T*>(out),
      split ? sp.ws_acc : nullptr, split ? sp.ws_ml : nullptr, lse, hq, hkv,
      s, bkv, scale, window, softcap);
  if (split) {
    dim3 cgrid(hq / hkv, b * hkv);
    constexpr int combine_nt = (D + 31) / 32 * 32;
    static_assert(combine_nt <= COMBINE_NT, "a combine block is too large");
    flash_decode_combine<T, LSE>
        <<<cgrid, combine_nt, 2 * sp.splits * sizeof(float), stream>>>(
            sp.ws_acc, sp.ws_ml, static_cast<T*>(out), lse, hq / hkv, D,
            sp.splits);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int dh, const void* q, const void* k, const void* v,
               const int* kv_pos, const int* pos, void* out, float* lse,
               int b, int hq, int hkv, int s, int bkv, float scale,
               int window, float softcap, Split sp, cudaStream_t st) {
#define REPRO_DECODE_D(DH)                                                   \
  case DH:                                                                  \
    return lse != nullptr                                                   \
               ? launch<T, DH, true>(q, k, v, kv_pos, pos, out, lse, b, hq, \
                                     hkv, s, bkv, scale, window, softcap, sp,\
                                     st)                                     \
               : launch<T, DH, false>(q, k, v, kv_pos, pos, out, nullptr, b,\
                                      hq, hkv, s, bkv, scale, window,        \
                                      softcap, sp, st);
  switch (dh) {
    REPRO_DECODE_D(16)
    REPRO_DECODE_D(32)
    REPRO_DECODE_D(64)
    REPRO_DECODE_D(80)
    REPRO_DECODE_D(128)
    REPRO_DECODE_D(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_D
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. kv_pos: int32 [S] slot -> position map,
// or null for a linear cache. pos: the query's absolute position, an int32
// scalar in device memory (>= 0). window <= 0 / softcap <= 0 mean none. The
// grid has `splits` blocks for each (b, kv-head); with splits > 1, ws_acc
// (float32 [B, Hkv, splits, n_rep, D]) and ws_ml ([B, Hkv, splits, n_rep,
// 2]) hold the partials and a second kernel combines them. lse: null, or
// float32 [B, Hq] for each row's log-sum-exp. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for an
// argument this file does not take.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* kv_pos, const void* pos,
                                  void* out, void* ws_acc, void* ws_ml,
                                  void* lse, int b,
                                  int hq, int hkv, int s, int dh, int dtype,
                                  int bkv, float scale, int window,
                                  float softcap, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > REP_MAX || bkv <= 0 ||
      pos == nullptr || splits < 1 || splits > 65535 ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const Split sp{static_cast<float*>(ws_acc), static_cast<float*>(ws_ml),
                 splits};
  const int* kp = static_cast<const int*>(kv_pos);
  const int* p = static_cast<const int*>(pos);
  float* ls = static_cast<float*>(lse);
  if (dtype == 0) {
    return dispatch_d<float>(dh, q, k, v, kp, p, out, ls, b, hq, hkv, s, bkv,
                             scale, window, softcap, sp, st);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(dh, q, k, v, kp, p, out, ls, b, hq, hkv,
                                     s, bkv, scale, window, softcap, sp, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The threads of one decode block at head dim dh (its combine block rounds
// max(dh, 32) up to whole warps).
extern "C" int repro_flash_decode_threads(int dh) { return threads_for(dh); }
