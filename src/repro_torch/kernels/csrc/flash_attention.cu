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
// (query, key) pair and reads q, k, v once, so operations bound it: the bf16
// tensor cores (989 TFLOP/s) in bfloat16, and in float32 the TF32 tensor
// cores at a third of their 495 TFLOP/s, since each float32 product takes
// three TF32 ones (below).
//
// Hopper runs blocks in parallel and in no order, so one thread block owns
// one (b, h, q-block) and loops over the KV blocks itself; KV blocks wholly
// above the causal diagonal or left of the window are never loaded (the
// reference's `pl.when(relevant)`), and the q-blocks with the most KV blocks
// launch first (reverse order under causal), so the diagonal's long blocks
// do not form the tail. GQA reads KV head h / (Hq / Hkv). Any Sq and Skv:
// the last q and KV blocks are masked. The numerics follow the reference:
// q.k in float32, scaled, then the softcap, then the mask (NEG_INF = -2e30,
// not -inf), the online max, sum and rescale, and the output divided by
// max(l, 1e-30). Only blocks that cross the diagonal, the window edge or
// Skv are masked. The dtype picks one of two regimes:
//
// * wgmma (bfloat16), shaped as FlashAttention-3. A producer warpgroup (one
//   thread issuing) brings Q once and each KV block's K and V by TMA, through
//   3-D tensor maps over [B*H, S, D] (rows past S come back zero, never the
//   next head's), with 128-byte swizzle, into a two-stage mbarrier ring;
//   setmaxnreg moves its registers to one or two consumer warpgroups of 64
//   query rows each (bq = 64 or 128). A consumer computes S = Q K^T with
//   wgmma m64n{bkv}k16 (both operands in shared memory, K as it lies:
//   K-major), applies scale, softcap, mask and the online softmax to the
//   accumulator fragment in registers (row max and sum by quad shuffles),
//   rounds P to bf16 in registers and adds P V with wgmma m64n64k16 per 64
//   head-dim columns, P the register A operand, V read MN-major (the
//   transpose bit) as it lies. Rounding P to bf16 is the one departure from
//   the reference, of the order of the output's own bf16 rounding. A head
//   dim that is no multiple of 64 (16, 32, 80) is zero-filled by TMA to
//   whole 64-column panels.
// * mma (float32) on the tensor cores at float32 accuracy: mma.sync m16n8k8
//   TF32 in the 3xTF32 split (x = hi + lo, hopper::split; hi*hi + hi*lo + lo*hi
//   keeps about 21 bits of each product; plain TF32 keeps 11 and misses the
//   float32 check). One warp owns 16 query rows (bq = 64 or 128: 4 or 8
//   warps); K and V come by 16-byte cp.async into a two-stage ring,
//   zero-filled past Skv; the softmax runs on the fragments. The P V product
//   takes the keys of each 8-key step in the order the S fragment holds them
//   (2t, 2t+1 as k = t, t+4), so P never moves between threads.
//
// The tiles each regime launches are REPRO_FA_TILES below, which
// flash_attention.py parses; a block's shared memory is smem_bytes.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -2.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the H100's per-block maximum
constexpr int STAGES = 2;           // K/V ring depth of both regimes
enum Regime { MMA = 0, WGMMA = 1 };

// Every (regime, head dim, bkv) this file compiles, as X(regime, D, bkv);
// bq is 64 or 128 wherever smem_bytes fits SMEM_LIMIT. flash_attention.py
// reads this table, so the launch rule is stated here alone. The wgmma
// regime takes bkv = 128 up to D = 128 (a consumer then holds 64 S, 32 P
// and 64 O registers), 64 at D = 256 (128 O registers). D = 80
// (h2o-danube-1.8b) runs the mma regime as it is (10 k-steps and 10
// n-tiles of 8) and the wgmma regime zero-padded to two 64-column panels,
// the D = 128 kernel: TMA fills columns 80 .. 127 with zeros, so Q K^T is
// exact, the padded columns of P V are dropped at the store, and the scale
// is the wrapper's 1 / sqrt(80). It does 128 / 80 = 1.6x the products.
#define REPRO_FA_TILES                                                    \
  X(MMA, 16, 32) X(MMA, 16, 64) X(MMA, 32, 32) X(MMA, 32, 64)              \
  X(MMA, 64, 32) X(MMA, 64, 64) X(MMA, 80, 32) X(MMA, 80, 64)              \
  X(MMA, 128, 32) X(MMA, 128, 64) X(MMA, 256, 32)                          \
  X(WGMMA, 16, 64) X(WGMMA, 16, 128) X(WGMMA, 32, 64) X(WGMMA, 32, 128)    \
  X(WGMMA, 64, 64) X(WGMMA, 64, 128) X(WGMMA, 80, 64) X(WGMMA, 80, 128)    \
  X(WGMMA, 128, 64) X(WGMMA, 128, 128) X(WGMMA, 256, 64)

// The head dim the wgmma regime computes at: whole 64-column panels.
__host__ __device__ constexpr int panel_dim(int d) {
  return (d + 63) / 64 * 64;
}

// Shared memory of one block: the float32 q block and two K and V stages,
// rows padded by 4 floats (mma); the bf16 q block and two K and V stages in
// 64-column panels, plus 1024 bytes of alignment and the mbarriers (wgmma).
__host__ __device__ constexpr size_t smem_bytes(int regime, int d, int bq,
                                                int bkv) {
  return regime == MMA
             ? 4 * (size_t)(d + 4) * (bq + 2 * STAGES * bkv)
             : 2 * (size_t)panel_dim(d) * (bq + 2 * STAGES * bkv) + 1024 +
                   8 * (1 + 3 * STAGES);
}

// ---------------------------------------------------------------------------
// Masks and the KV range, shared by both regimes
// ---------------------------------------------------------------------------

// KV blocks [ib_lo, ib_hi) that any query of [q_first, q_last] can see.
__device__ __forceinline__ void kv_blocks(int q_first, int q_last, int skv,
                                          int bkv, int causal, int window,
                                          int& ib_lo, int& ib_hi) {
  const int kv_hi = causal ? min(skv, q_last + 1) : skv;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  ib_lo = kv_lo / bkv;
  ib_hi = max(ib_lo, (kv_hi + bkv - 1) / bkv);
}

// Every key of [k0, k0 + bkv) is hidden from every query of [qa, qb].
__device__ __forceinline__ bool hidden(int k0, int bkv, int qa, int qb,
                                       int causal, int window) {
  return (causal && k0 > qb) || (window > 0 && k0 + bkv - 1 <= qa - window);
}

// Some key of [k0, k0 + bkv) is hidden from some query of [qa, qb].
__device__ __forceinline__ bool needs_mask(int k0, int bkv, int qa, int qb,
                                           int skv, int causal, int window) {
  return k0 + bkv > skv || (causal && k0 + bkv - 1 > qa) ||
         (window > 0 && k0 <= qb - window);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int skv,
                                        int causal, int window) {
  return kpos < skv && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// The reference's order: the softcap, then the mask.
__device__ __forceinline__ float logit(float x, float softcap, bool mask,
                                       int qpos, int kpos, int skv,
                                       int causal, int window) {
  if (softcap > 0.f) x = softcap * tanhf(x / softcap);
  return mask && !visible(qpos, kpos, skv, causal, window) ? NEG_INF : x;
}

// The four threads of a quad share the rows of an mma or wgmma fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(~0u, x, 1));
  return fmaxf(x, __shfl_xor_sync(~0u, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(~0u, x, 1);
  return x + __shfl_xor_sync(~0u, x, 2);
}

// ---------------------------------------------------------------------------
// mma: float32 as 3xTF32 on mma.sync m16n8k8 (split and mma_3xtf32 in
// hopper.cuh)
// ---------------------------------------------------------------------------

// blockDim.x = 2 * bq: warp w owns query rows 16w .. 16w + 15. Fragment
// layouts (g = lane / 4, t = lane % 4): A a0..a3 = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B b0, b1 = (k t, n g), (k t + 4, n g);
// C c0..c3 = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
template <int D, int BKV>
__global__ void __launch_bounds__(256)
flash_attention_kernel_mma(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           int hq, int hkv, int sq, int skv, float scale,
                           int causal, int window, float softcap,
                           int q_offset) {
  constexpr int RS = D + 4;    // row stride: fragment loads hit 32 banks
  constexpr int NK = BKV / 8;  // 8-key tiles of a KV block
  constexpr int ND = D / 8;    // 8-column tiles of the head dim
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x, bq = nthreads / 2;
  float* qs = smem;                    // [bq][RS], pre-scaled
  float* ks = qs + bq * RS;            // [STAGES][BKV][RS]
  float* vs = ks + STAGES * BKV * RS;  // [STAGES][BKV][RS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int iq = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int q0 = iq * bq;
  const int rows = min(bq, sq - q0);
  const float* qb = q + (((size_t)bb * hq + h) * sq + q0) * D;
  const size_t kv_off = ((size_t)bb * hkv + h / (hq / hkv)) * (size_t)skv * D;
  const float* kb = k + kv_off;
  const float* vb = v + kv_off;

  int ib_lo, ib_hi;
  kv_blocks(q_offset + q0, q_offset + q0 + rows - 1, skv, BKV, causal, window,
            ib_lo, ib_hi);
  auto load_kv = [&](int ib, int st) {
    const int k0 = ib * BKV;
    for (int i = tid; i < BKV * D / 4; i += nthreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool ok = k0 + r < skv;
      const size_t src = ok ? (size_t)(k0 + r) * D + c : 0;
      cp_async16(ks + (st * BKV + r) * RS + c, kb + src, ok ? 16 : 0);
      cp_async16(vs + (st * BKV + r) * RS + c, vb + src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  if (ib_lo < ib_hi) load_kv(ib_lo, 0);
  for (int i = tid; i < bq * D / 4; i += nthreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      x = __ldg(reinterpret_cast<const float4*>(qb + (size_t)r * D + c));
    *reinterpret_cast<float4*>(qs + r * RS + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qpos0 = q_offset + q0 + r0;
  const int wa = q_offset + q0 + warp * 16, wb = wa + 15;  // the warp's rows
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int ib = ib_lo; ib < ib_hi; ++ib) {
    const int st = (ib - ib_lo) & 1;
    if (ib + 1 < ib_hi) {
      load_kv(ib + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage (and on the first pass q) is in place
    const int k0 = ib * BKV;
    if (!hidden(k0, BKV, wa, wb, causal, window)) {  // warp-uniform
      const float* kt = ks + st * BKV * RS;
      const float* vt = vs + st * BKV * RS;
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < ND; ++kk) {
        const float* qr = qs + r0 * RS + kk * 8 + t;
        uint32_t ahi[4], alo[4];
        split(qr[0], ahi[0], alo[0]);
        split(qr[8 * RS], ahi[1], alo[1]);
        split(qr[4], ahi[2], alo[2]);
        split(qr[8 * RS + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          const float* kr = kt + (j * 8 + g) * RS + kk * 8 + t;
          uint32_t bh0, bl0, bh1, bl1;
          split(kr[0], bh0, bl0);
          split(kr[4], bh1, bl1);
          mma_3xtf32(s[j], ahi, alo, bh0, bh1, bl0, bl1);
        }
      }

      const bool mask = needs_mask(k0, BKV, wa, wb, skv, causal, window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = logit(s[j][c], softcap, mask, qpos0 + 8 * (c >> 1),
                          k0 + j * 8 + 2 * t + (c & 1), skv, causal, window);
          mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
        }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float mn = fmaxf(m[hh], quad_max(mx[hh]));
        alpha[hh] = expf(m[hh] - mn);
        m[hh] = mn;
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[j][c] = expf(s[j][c] - m[c >> 1]);
          l[c >> 1] += s[j][c];
        }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[n][c] *= alpha[c >> 1];

      // O += P V, key 8j + 2t as k = t and 8j + 2t + 1 as k = t + 4: the A
      // fragment is the S fragment as it lies.
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        uint32_t ahi[4], alo[4];
        split(s[j][0], ahi[0], alo[0]);
        split(s[j][2], ahi[1], alo[1]);
        split(s[j][1], ahi[2], alo[2]);
        split(s[j][3], ahi[3], alo[3]);
        const float* vr = vt + (j * 8 + 2 * t) * RS + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vr[n * 8], bh0, bl0);
          split(vr[RS + n * 8], bh1, bl1);
          mma_3xtf32(o[n], ahi, alo, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float den = fmaxf(quad_sum(l[hh]), 1e-30f);
    const int r = r0 + 8 * hh;
    if (r >= rows) continue;
    float* dst = out + (((size_t)bb * hq + h) * sq + q0 + r) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(dst + n * 8) =
          make_float2(o[n][2 * hh] / den, o[n][2 * hh + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// wgmma: bfloat16, a TMA producer warpgroup, wgmma consumer warpgroups
// ---------------------------------------------------------------------------

// d[32] (+)= A (64x16, K-major) @ B (16x64, K-major), bf16 in, f32 sum.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] (+)= A (64x16, K-major) @ B (16x128, K-major), bf16 in, f32 sum.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A (64x16 bf16, registers) @ B (16x64, MN-major), f32 sum.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// NWG consumer warpgroups (threads 0 .. 128 NWG - 1), each owning 64 query
// rows, then one producer warpgroup. A block of 8 or 12 warps enters with
// 128 or 168 registers a thread (two blocks an SM, or one); setmaxnreg
// takes the producer down to 24 and the consumers up to 232 or 240, the
// whole register file (a consumer holds up to 128 O, 64 S and 32 P
// registers). The role is warp-uniform (__shfl_sync) and each role's code
// runs to the end, as ptxas needs to allocate by role. A tile is PANELS
// panels of [rows][64] bf16 (128-byte rows, swizzled), one TMA box each.
// The accumulator of m64nN holds in register 4j + 2h + e row
// 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e; the A operand of
// the RS form holds, for keys 16kk .. 16kk + 15, those of S's registers
// 8kk .. 8kk + 7 in pairs.
template <int DP, int BKV, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), NWG == 1 ? 2 : 1)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             bf16* __restrict__ out, int hq, int hkv, int sq,
                             int skv, int d, float scale, int causal,
                             int window, float softcap, int q_offset) {
  constexpr int BQ = 64 * NWG;
  constexpr int PANELS = DP / 64;
  constexpr uint32_t Q_BYTES = BQ * DP * 2;
  constexpr uint32_t KV_BYTES = BKV * DP * 2;  // one K or V block
  static_assert(BKV == 64 || BKV == 128, "S is m64n64 or m64n128");
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* sq_t = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sk_t = sq_t + Q_BYTES;             // [STAGES][PANELS][BKV][64]
  uint8_t* sv_t = sk_t + STAGES * KV_BYTES;   // [STAGES][PANELS][BKV][64]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv_t + STAGES * KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* kv_empty = v_full + STAGES;

  const int tid = threadIdx.x, t = tid % 128;
  const int wg = __shfl_sync(~0u, tid / 128, 0);  // warp-uniform role
  const int iq = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int q0 = iq * BQ;
  const int rows = min(BQ, sq - q0);
  int ib_lo, ib_hi;
  kv_blocks(q_offset + q0, q_offset + q0 + rows - 1, skv, BKV, causal, window,
            ib_lo, ib_hi);
  const int nblk = ib_hi - ib_lo;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], NWG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // Producer: its registers go to the consumers; one thread issues.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (t == 0) {
      const int kvh = bb * hkv + h / (hq / hkv);
      mbar_expect_tx(q_full, Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load_3d(sq_t + p * BQ * 128, &tm_q, 64 * p, q0, bb * hq + h,
                    q_full);
      for (int i = 0; i < nblk; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&kv_empty[s], (i / STAGES - 1) & 1);
        const int k0 = (ib_lo + i) * BKV;
        mbar_expect_tx(&k_full[s], KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(sk_t + s * KV_BYTES + p * BKV * 128, &tm_k, 64 * p, k0,
                      kvh, &k_full[s]);
        mbar_expect_tx(&v_full[s], KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(sv_t + s * KV_BYTES + p * BKV * 128, &tm_v, 64 * p, k0,
                      kvh, &v_full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     NWG == 1 ? 232 : 240)
                 : "memory");
    const int lane = t % 32, quad = lane % 4;
    const int r0 = wg * 64 + (t / 32) * 16 + lane / 4;  // rows r0, r0 + 8
    const int qpos0 = q_offset + q0 + r0;
    const int wa = q_offset + q0 + wg * 64, wb = wa + 63;  // the group's rows
    const uint8_t* q_tile = sq_t + wg * 64 * 128;
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < nblk; ++i) {
      const int s = i % STAGES;
      const uint32_t phase = (i / STAGES) & 1;
      const int k0 = (ib_lo + i) * BKV;
      // A block no row of this group sees is waited for and released but
      // not computed (uniform over the warpgroup).
      const bool skip = hidden(k0, BKV, wa, wb, causal, window);
      uint32_t pa[BKV / 4];  // P in bf16, the A operand of P V
      mbar_wait(&k_full[s], phase);
      __syncwarp();
      if (!skip) {
        float sc[BKV / 2];
        const uint8_t* k_tile = sk_t + s * KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          // 16 head-dim columns: 32 bytes along a swizzled row, a new panel
          // every four steps; 8-row groups 1024 bytes apart.
          const uint64_t da = sw128_desc(q_tile + (kk / 4) * BQ * 128 +
                                             (kk % 4) * 32, 16, 1024);
          const uint64_t db = sw128_desc(k_tile + (kk / 4) * BKV * 128 +
                                             (kk % 4) * 32, 16, 1024);
          if constexpr (BKV == 64)
            wgmma_ss_n64(sc, da, db, kk > 0);
          else
            wgmma_ss_n128(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence<BKV / 2>(sc);

        const bool mask = needs_mask(k0, BKV, wa, wb, skv, causal, window);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int idx = 4 * j + c;
            sc[idx] = logit(sc[idx] * scale, softcap, mask,
                            qpos0 + 8 * (c >> 1), k0 + 8 * j + 2 * quad + (c & 1),
                            skv, causal, window);
            mx[c >> 1] = fmaxf(mx[c >> 1], sc[idx]);
          }
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float mn = fmaxf(m[hh], quad_max(mx[hh]));
          alpha[hh] = exp2f((m[hh] - mn) * LOG2E);
          m[hh] = mn;
          l[hh] *= alpha[hh];
        }
#pragma unroll
        for (int idx = 0; idx < BKV / 2; ++idx) {
          const int hh = (idx >> 1) & 1;
          sc[idx] = exp2f((sc[idx] - m[hh]) * LOG2E);
          l[hh] += sc[idx];
        }
#pragma unroll
        for (int idx = 0; idx < DP / 2; ++idx) o[idx] *= alpha[(idx >> 1) & 1];
#pragma unroll
        for (int r = 0; r < BKV / 4; ++r)
          pa[r] = pack_bf16(sc[2 * r], sc[2 * r + 1]);
      }
      mbar_wait(&v_full[s], phase);
      __syncwarp();
      if (!skip) {
        const uint8_t* v_tile = sv_t + s * KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
          for (int p = 0; p < PANELS; ++p)
            // 16 keys = 16 rows of 128 bytes; one 64-column panel.
            wgmma_rs_n64(o + 32 * p, pa + 4 * kk,
                         sw128_desc(v_tile + p * BKV * 128 + kk * 16 * 128,
                                    BKV * 128, 1024));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence<DP / 2>(o);
      }
      if (t == 0) mbar_arrive(&kv_empty[s]);  // the group is done with it
      __syncwarp();
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / fmaxf(quad_sum(l[hh]), 1e-30f);
      const int r = r0 + 8 * hh;
      if (r >= rows) continue;
      bf16* dst = out + (((size_t)bb * hq + h) * sq + q0 + r) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * hh] * inv,
                                    o[4 * j + 2 * hh + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  int b, hq, hkv, sq, skv, bq;
  float scale;
  int causal, window;
  float softcap;
  int q_offset;
  cudaStream_t stream;
};

template <typename Kernel>
int size_smem(Kernel kernel, size_t bytes, size_t& sized) {
  if (bytes <= sized) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  sized = bytes;
  return 0;
}

template <int D, int BKV>
int launch_MMA(const Args& a) {
  const size_t smem = smem_bytes(MMA, D, a.bq, BKV);
  if ((a.bq != 64 && a.bq != 128) || smem > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_kernel_mma<D, BKV>;
  static size_t sized = 0;
  const int rc = size_smem(kernel, smem, sized);
  if (rc != 0) return rc;
  dim3 grid((a.sq + a.bq - 1) / a.bq, a.hq, a.b);
  kernel<<<grid, 2 * a.bq, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.hq, a.hkv,
      a.sq, a.skv, a.scale, a.causal, a.window, a.softcap, a.q_offset);
  return 0;
}

template <int DP, int BKV, int NWG>
int launch_wgmma_groups(const Args& a, int d, const CUtensorMap& mq,
                        const CUtensorMap& mk, const CUtensorMap& mv) {
  constexpr size_t smem = smem_bytes(WGMMA, DP, 64 * NWG, BKV);
  static_assert(smem <= (size_t)SMEM_LIMIT, "tile does not fit a block");
  auto kernel = flash_attention_kernel_wgmma<DP, BKV, NWG>;
  static size_t sized = 0;
  const int rc = size_smem(kernel, smem, sized);
  if (rc != 0) return rc;
  dim3 grid((a.sq + 64 * NWG - 1) / (64 * NWG), a.hq, a.b);
  kernel<<<grid, 128 * (NWG + 1), smem, a.stream>>>(
      mq, mk, mv, static_cast<bf16*>(a.out), a.hq, a.hkv, a.sq, a.skv, d,
      a.scale, a.causal, a.window, a.softcap, a.q_offset);
  return 0;
}

// A [B*H, S, D] bf16 tensor in boxes of [rows, 64] (one head at a time).
int head_map(CUtensorMap* map, const void* ptr, int bh, int s, int d,
             int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)s * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return bf16_tensor_map(map, ptr, 3, dims, strides, box);
}

template <int D, int BKV>
int launch_WGMMA(const Args& a) {
  constexpr int DP = panel_dim(D);
  if (a.bq != 64 && a.bq != 128) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  int rc = head_map(&mq, a.q, a.b * a.hq, a.sq, D, a.bq);
  if (rc == 0) rc = head_map(&mk, a.k, a.b * a.hkv, a.skv, D, BKV);
  if (rc == 0) rc = head_map(&mv, a.v, a.b * a.hkv, a.skv, D, BKV);
  if (rc != 0) return rc;
  return a.bq == 64 ? launch_wgmma_groups<DP, BKV, 1>(a, D, mq, mk, mv)
                    : launch_wgmma_groups<DP, BKV, 2>(a, D, mq, mk, mv);
}

}  // namespace

// dtype: 0 = float32 (the mma regime), 1 = bfloat16 (wgmma). (bq, bkv)
// must be a tile of REPRO_FA_TILES for the regime and head dim. window <= 0
// means none, softcap <= 0 means none. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for an argument this file does not take.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int b, int hq,
                                     int hkv, int sq, int skv, int dh,
                                     int dtype, int bq, int bkv, float scale,
                                     int causal, int window, float softcap,
                                     int q_offset, void* stream) {
  if (b <= 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || sq <= 0 || skv <= 0)
    return (int)cudaErrorInvalidValue;
  const int regime = dtype == 0 ? MMA : dtype == 1 ? WGMMA : -1;
  const Args a{q,     k,      v,      out,     b,        hq,
               hkv,   sq,     skv,    bq,      scale,    causal,
               window, softcap, q_offset, static_cast<cudaStream_t>(stream)};
  int rc = (int)cudaErrorInvalidValue;
#define X(r, d, n) else if (regime == r && dh == d && bkv == n) rc = launch_##r<d, n>(a);
  if (false) {
  }
  REPRO_FA_TILES
#undef X
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
