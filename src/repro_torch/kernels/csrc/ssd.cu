// Mamba-2 SSD chunk scan for Hopper (sm_90a): log_a [B, H, S], dtx
// [B, S, H, P], Bm and C [B, S, N], h0 [B, H, N, P] -> y [B, S, H, P] and
// h_last [B, H, N, P]; float32 or bfloat16 in and out, float32 cumsum,
// decays and state.
//
// Replaces: src/repro/kernels/ssd/ssd.py, function `ssd_scan`
// (`_ssd_kernel`), the Pallas TPU kernel with grid (B, H, S/Q) whose chunk
// axis runs in order ("arbitrary") and carries the [N, P] state in VMEM
// scratch, doing its four contractions per chunk on the MXU.
//
// What bounds it on the H100: per chunk of Q steps and head it does
// Q (Q + 1) N (C B^T, causal pairs) + Q (Q + 1) P (scores x) + 2 Q N P
// (C h) + 2 Q N P (state) FLOP on Q (1 + P + 2N) inputs. At mamba2-2.7b's
// width (H 80, P 64, N 128) and Q = 64 that is 14.8 GFLOP for S = 4096,
// which in float32 takes 0.090 ms at the 3xTF32 rate (495/3 TFLOP/s) and in
// bf16 0.015 ms, below the 0.027 ms its 89 MB of inputs and outputs take at
// 3.35 TB/s: so operations bound float32 and bytes bound bf16.
//
// Design: Mamba-2's own GPU decomposition (arXiv:2405.21060 §6), three
// launches in order on one stream, so that every chunk of every head runs in
// parallel instead of one block per (b, h) walking the sequence:
//
// (a) ssd_state_kernel, grid (chunks x N-tiles x P-tiles, H, B): the chunk's
//     inclusive cumsum of log_a (a warp scan), w = exp(total - cum), and
//     the chunk's own state S_c = (B * w)^T x, a [128, 64] tile a block, on
//     the tensor cores; S_c and exp(total) go to a float32 workspace. With
//     one chunk (S <= Q) it writes h_last = exp(total) h0 + S_c instead and
//     (b) is skipped.
// (b) ssd_pass_kernel, grid (N*P / 1024, H, B): four state elements a
//     thread walk the chunks in order from h0: each chunk's slot is
//     overwritten by the state entering it, then h = exp(total_c) h + S_c
//     (the order of operations of the one-block scan this replaces); the
//     end is h_last.
// (c) ssd_out_kernel, grid (chunks x 64-row tiles x P-tiles, H, B), eight
//     warps: for 64 rows of a chunk, y = exp(cum_i) (C_i . h_in) + sum over
//     j <= i of (C_i . B_j) exp(cum_i - cum_j) x_j, j-tile by j-tile up to
//     the diagonal, on the tensor cores; the two warps of a row slab each
//     form half of its scores and pass them on through shared memory as
//     the A fragments of scores . x.
// (d) ssd_step_kernel, for S = 1 (the decode step) alone: one block a head
//     gives y and h_last of the one step in one launch, with no workspace;
//     at one step the products are dot products, not tensor-core work.
// (e) ssd_bwd_kernel (repro_ssd_bwd), the backward's dB and dC in one
//     launch: (c)'s products with the operands' roles swapped, summed over
//     heads. The Pallas kernel has no backward (the reference
//     differentiates its jnp scan); this one serves
//     kernels/ssd/ops.py:ssd_scan_backward, which first runs (a)-(c) (or
//     (d)) in their reversed mode for d(dtx), dh0 and d log_a's dot
//     products (the adjoint scan, whose states are the adjoint states), then
//     this kernel once: a grid dimension picks dC (the forward problem
//     against dy) or dB (the reversed one against dtx).
//
// The reversed mode (repro_ssd's reverse = 1): every kernel reads step t of
// the adjoint scan at forward step S - 1 - t, rows staged by cp.async with a
// negative row stride, so the tiles in shared memory are those the forward
// mode would stage from time-flipped copies (the same bits out); its log_a
// is 0 at t = 0 and log_a[S - t] after. Its chunk grid starts at forward
// step S - 1, so a ragged S puts its short chunk at forward step 0. y is
// written at forward steps, the chunk states in the adjoint scan's order.
// (c)'s epilogue, holding d dtx for its rows, also forms <dy_t, y_t> -
// <dtx_t, d dtx_t> over its P columns (dy is its own last j-tile) and
// writes them as float32 [P-tiles, B, H, S]: d log_a needs no full-size
// temporary and no copy.
//
// What bounds the backward: at mamba2-2.7b's width (H 80, P 64, N 128),
// S = 4096 and Q = 64 it does 3.37e10 FLOP (ops.bwd_flops: the reversed
// scan's and L (L + 1) (N + P) + 2 L N P a chunk and head for each of dB and
// dC), 0.20 ms at the 3xTF32 rate, so operations bound it in float32 and
// its 179 MB bytes bound it in bf16. (e) itself reads 2 x 168 MB of float32
// chunk states besides. Its design: a block takes 64 rows of a chunk and
// 128 N columns of one problem and walks a group of heads (all 80 at
// mamba2's width, one block an SM) through a two-stage cp.async ring, so a
// head's dy, x and h_in tiles load while the head before computes; the B
// tile is staged once a j-tile; the heads' cumsums are taken once, a head a
// warp; each head's products sum in a tile of their own, then into the
// block's float32 sum in a fixed order (summed in the tensor cores' own
// accumulator, 80 heads missed the float32 check). Both dtypes run on
// mma.sync with sixteen warps (four a 16-row slab, 32 N columns each; each
// SM sub-partition holds one warp of every slab, since the causal rows give
// the last slab four times the first's scores). The products, with their
// operand loads and 3xTF32 splits, take about two thirds of the float32
// launch and half of the bf16 one (tools/time_ssd.py's variant without
// them); a wgmma form of the bf16 kernel was no faster, and 3xTF32 on wgmma
// (tf32 operands K-major in shared memory, split into hi and lo there) is
// not tried yet.

// Every product of (a) and (c) runs on mma.sync with float32 sums. float32
// takes m16n8k8 as 3xTF32 (x = hi + lo, hopper::split; one TF32 product
// misses the 2e-5 float32 check). bf16 takes m16n8k16; its float32
// operands, B * w in (a) and h_in in (c), go in as hi + lo, both bf16 (two
// products, about 16 bits kept), so that the state and the decays stay
// float32; only the scores are rounded to bf16, as the operand of
// scores . x. A thread's k pair of a k8 step is (2t, 2t + 1) in both (in
// TF32 the k order within a step is free), so one fragment layout serves
// both dtypes and C B^T's accumulator is, as it lies, the A fragment of
// scores . x. Tiles are staged by cp.async in the input's type (h_in in
// float32), rows padded so that every fragment load of a warp hits 32
// banks. No block holds [Q, N] + [Q, Q] + [N, P] at once: the chunk is
// tiled by 64 rows, the state by 128 x 64, so any chunk up to QMAX = 256
// launches; shared memory bounds only N (out_smem). The last chunk may be
// ragged: its missing steps are zero (log_a 0, x 0, B 0, C 0), which adds
// nothing, and are not stored; bf16 zero-fills N to a multiple of 16 for
// the k16 steps over N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int NT = 128;      // threads of (a): four warps
constexpr int NT_OUT = 256;  // threads of (c): eight warps
constexpr int NT_BWD = 512;  // threads of (e): sixteen warps
constexpr int TQ = 64;     // time rows of a tile
constexpr int TP = 64;     // state columns (P) of a tile
constexpr int TN = 128;    // state rows (N) of a chunk-state tile, and N
                           // columns of a backward block
constexpr int QMAX = 256;  // the longest chunk (its cumsum sits in smem)
constexpr int PASS_THREADS = 256;
constexpr int STEP_THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the H100's per-block maximum

// Tiles sit in shared memory in the input's type, row strides in elements
// chosen so that every fragment load of a warp hits 32 banks. A tile read
// along its rows (k = 2t, 2t + 1 of row g: C and B in (c)) takes n + 8: 8
// mod 32 floats for float2 loads, 4 mod 32 words for bf16 pairs. A tile
// read down its rows (rows 2t and 2t + 1 of column g: x and h_in, and B in
// (a)) takes cols + 4 floats (4 mod 16) or cols + 8 bf16 (8 mod 32).
__host__ __device__ constexpr int ld_row(int n) { return n + 8; }
__host__ __device__ constexpr int ld_col(int cols, int es) {
  return es == 4 ? cols + 4 : cols + 8;
}
__host__ __device__ constexpr size_t state_smem(int es) {
  return (size_t)es * TQ * (ld_col(TN, es) + ld_col(TP, es)) + 4 * QMAX;
}
// The K extent of the products over N: a whole number of mma k-steps (8 in
// float32, 16 in bf16), zero-filled past n.
__host__ __device__ constexpr int n_steps(int n, int es) {
  return es == 4 ? n : (n + 15) & ~15;
}
// (c)'s score buffer: 16 rows x 64 j of each of the four row slabs; h_in's
// rows, float32 in both dtypes.
constexpr int LD_SC = TQ + 8;
constexpr int LH = TP + 4;
__host__ __device__ constexpr size_t out_smem(int n, int es) {
  return 4 * QMAX + (size_t)es * 4 * 16 * LD_SC + (size_t)es * TQ * ld_row(n) +
         ((size_t)4 * n_steps(n, es) * LH >
                  (size_t)es * TQ * (ld_row(n) + ld_col(TP, es))
              ? (size_t)4 * n_steps(n, es) * LH
              : (size_t)es * TQ * (ld_row(n) + ld_col(TP, es)));
}

// (e)'s blocks. A stage of the head pipeline: dy rows and x rows
// [TQ][ld_row(p)] in the input's type, then float32 h_in rows [TN][Pk + 8]
// (Pk: P in whole k-steps). After the stages: B columns [TQ][ld_col(TN)] of
// the block's j-tile, the score buffer, and the cumsums of the block's heads
// [hpb][q rounded up to 32], float32.
__host__ __device__ constexpr size_t bwd_stage_bytes(int p, int es) {
  return (size_t)2 * es * TQ * ld_row(p) + (size_t)4 * TN * (n_steps(p, es) + 8);
}
__host__ __device__ constexpr size_t bwd_smem(int p, int q, int hpb, int stages,
                                              int es) {
  return (size_t)stages * bwd_stage_bytes(p, es) +
         (size_t)es * TQ * ld_col(TN, es) + (size_t)es * 4 * 16 * LD_SC +
         (size_t)4 * hpb * ((q + 31) & ~31);
}
// Two stages where they fit, else one; 0 if not even one does. (A third,
// where it fits, made the bf16 kernel slower on the H100.)
__host__ __device__ constexpr int bwd_stages(int p, int q, int hpb, int es) {
  return bwd_smem(p, q, hpb, 2, es) <= (size_t)SMEM_LIMIT   ? 2
         : bwd_smem(p, q, hpb, 1, es) <= (size_t)SMEM_LIMIT ? 1
                                                            : 0;
}

// The units' ring of (e): unit u sits in stage u % stages.
// `nx` units are loading or loaded; at the top of unit u (all units before
// it consumed) the ring waits for unit u, then starts loads ahead while a
// stage is free. A unit that starts a j-tile round also stages that round's
// B tile, which the round before reads to its end: its loads start only
// once every unit before it is consumed.
__device__ __forceinline__ void bwd_ring_wait(int pending) {
  if (pending >= 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// The reversed mode (the backward's adjoint scan, read in place): step t of
// the scan is forward step s - 1 - t, and its log_a is 0 at t = 0 and
// log_a[s - t] after. `la` is the (b, h) row of log_a.
__device__ __forceinline__ int time_row(int t, int s, int rev) {
  return rev ? s - 1 - t : t;
}
template <typename T>
__device__ __forceinline__ float log_a_at(const T* la, int t, int s, int rev) {
  if (!rev) return to_f32(la[t]);
  return t == 0 ? 0.f : to_f32(la[s - t]);
}

// Two neighbouring outputs (p, p + 1), and their float values.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A [rows, cols] tile of a row-major source (row stride `stride` elements,
// negative to read rows backward in time) into shared memory of the same
// type (row stride ld) by 16-byte cp.async: rows >= vrows and columns >=
// vcols are zero-filled. cols and vcols are multiples of 8, rows start on 16
// bytes; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      ptrdiff_t stride, int rows, int vrows,
                                      int cols, int vcols) {
  constexpr int E = 16 / sizeof(T);
  const int per_row = cols / E;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * E;
    const bool ok = r < vrows && c < vcols;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok ? 16 : 0);
  }
}
// A bf16 tile into float32 shared memory (h0 as h_in, with one chunk):
// eight values a thread at a time, through registers.
__device__ __forceinline__ void stage(float* dst, int ld, const bf16* src,
                                      ptrdiff_t stride, int rows, int vrows,
                                      int cols, int vcols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row, c = (i % per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < vrows && c < vcols) {
      v = *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
    float f[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      f[2 * u] = __uint_as_float(w[u] << 16);
      f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
    }
    d[0] = make_float4(f[0], f[1], f[2], f[3]);
    d[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// Inclusive cumsum of cum[0 .. len) in place, len a multiple of 32, by one
// warp: a shuffle scan of each 32 values plus the carry of those before.
__device__ __forceinline__ void warp_cumsum(float* cum, int len) {
  const int lane = threadIdx.x & 31;
  float carry = 0.f;
  for (int base = 0; base < len; base += 32) {
    float v = cum[base + lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(~0u, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    cum[base + lane] = v;
    carry = __shfl_sync(~0u, v, 31);
  }
}

// The two warps of a row slab meet (named barrier 1 + slab; 0 is
// __syncthreads).
__device__ __forceinline__ void pair_sync(int slab) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slab) : "memory");
}
// The four warps of a row slab of (e) meet.
__device__ __forceinline__ void quad_sync(int slab) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + slab) : "memory");
}

// The operand arithmetic of each dtype, one mma k-step (K) at a time. An A
// fragment holds rows g and g + 8 at k = 2t and 2t + 1 (and, in bf16,
// 2t + 8 and 2t + 9), a B fragment column g at the same k: from two rows of
// a tile read along k (a_rows, b_row: p at k = 2t), or from a tile read
// down k (b_col, and b_wide from float32 h_in: p at row 2t, column g).
// a_scaled forms (B * w)^T of (a) from B read down k (p at k = 2t, row g)
// and w at k = 2t. AW and BW are the float32 operands: 3xTF32 already in
// float32, hi + lo in bf16.
template <typename T>
struct Mma;
template <>
struct Mma<float> {  // 3xTF32 on m16n8k8
  static constexpr int K = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  typedef A AW;
  typedef B BW;
  // (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) in the TF32 slots
  // (g, t), (g, t + 4), (g + 8, t), (g + 8, t + 4).
  __device__ static A a(float v00, float v01, float v10, float v11) {
    A r;
    split(v00, r.hi[0], r.lo[0]);
    split(v10, r.hi[1], r.lo[1]);
    split(v01, r.hi[2], r.lo[2]);
    split(v11, r.hi[3], r.lo[3]);
    return r;
  }
  __device__ static B b(float k0, float k1) {
    B r;
    split(k0, r.hi[0], r.lo[0]);
    split(k1, r.hi[1], r.lo[1]);
    return r;
  }
  __device__ static A a_rows(const float* r0, const float* r1) {
    const float2 u = load2(r0), v = load2(r1);
    return a(u.x, u.y, v.x, v.y);
  }
  __device__ static B b_row(const float* p) {
    const float2 u = load2(p);
    return b(u.x, u.y);
  }
  __device__ static B b_col(const float* p, int ld) { return b(p[0], p[ld]); }
  __device__ static BW b_wide(const float* p, int ld) { return b_col(p, ld); }
  __device__ static BW b_wide_row(const float* p) { return b_row(p); }
  __device__ static AW a_scaled(const float* p, int ld, const float* w) {
    return a(p[0] * w[0], p[ld] * w[1], p[8] * w[0], p[ld + 8] * w[1]);
  }
  __device__ static void mma(float* d, const A& a, const B& b) {
    mma_3xtf32(d, a.hi, a.lo, b.hi[0], b.hi[1], b.lo[0], b.lo[1]);
  }
};
// x = hi + lo for two floats, each half a bf16 pair.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair(const bf16* p, int ld) {
  return (uint32_t)*reinterpret_cast<const unsigned short*>(p) |
         ((uint32_t)*reinterpret_cast<const unsigned short*>(p + ld) << 16);
}
template <>
struct Mma<bf16> {  // bf16 on m16n8k16, float32 sums
  static constexpr int K = 16;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  struct AW {
    A hi, lo;
  };
  struct BW {
    B hi, lo;
  };
  __device__ static A a_rows(const bf16* r0, const bf16* r1) {
    return A{{ld32(r0), ld32(r1), ld32(r0 + 8), ld32(r1 + 8)}};
  }
  __device__ static B b_row(const bf16* p) { return B{{ld32(p), ld32(p + 8)}}; }
  __device__ static B b_col(const bf16* p, int ld) {
    return B{{pair(p, ld), pair(p + 8 * ld, ld)}};
  }
  __device__ static BW b_wide(const float* p, int ld) {
    BW r;
    split_bf16(p[0], p[ld], r.hi.r[0], r.lo.r[0]);
    split_bf16(p[8 * ld], p[9 * ld], r.hi.r[1], r.lo.r[1]);
    return r;
  }
  // The same from a float32 tile read along k (h_in rows in the backward).
  __device__ static BW b_wide_row(const float* p) {
    BW r;
    const float2 u = load2(p), v = load2(p + 8);
    split_bf16(u.x, u.y, r.hi.r[0], r.lo.r[0]);
    split_bf16(v.x, v.y, r.hi.r[1], r.lo.r[1]);
    return r;
  }
  __device__ static AW a_scaled(const bf16* p, int ld, const float* w) {
    AW r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // k = 2t (+ 8h) and the next
      const bf16* q = p + 8 * h * ld;
      const float w0 = w[8 * h], w1 = w[8 * h + 1];
      split_bf16(to_f32(q[0]) * w0, to_f32(q[ld]) * w1, r.hi.r[2 * h],
                 r.lo.r[2 * h]);
      split_bf16(to_f32(q[8]) * w0, to_f32(q[ld + 8]) * w1,
                 r.hi.r[2 * h + 1], r.lo.r[2 * h + 1]);
    }
    return r;
  }
  __device__ static void mma(float* d, const A& a, const B& b) {
    mma_bf16(d, a.r, b.r[0], b.r[1]);
  }
  // The small term first, as in 3xTF32.
  __device__ static void mma(float* d, const AW& a, const B& b) {
    mma(d, a.lo, b);
    mma(d, a.hi, b);
  }
  __device__ static void mma(float* d, const A& a, const BW& b) {
    mma(d, a, b.lo);
    mma(d, a, b.hi);
  }
};

// (a) The chunk's state S_c[n, p] = sum_j B[j, n] w_j x[j, p] for one
// [TN, TP] tile: warp w owns state rows 32w .. 32w + 31 (two m16 tiles) and
// all 64 columns (eight n8 tiles), K = the chunk's steps, 64 at a time
// (rows past the chunk and w past qv are zero). REV is the reversed mode,
// a template argument so that the forward compiles without it.
template <typename T, bool REV>
__global__ void __launch_bounds__(NT, 4)
ssd_state_kernel(const T* __restrict__ log_a, const T* __restrict__ dtx,
                 const T* __restrict__ bm, const T* __restrict__ h0,
                 float* __restrict__ ws, float* __restrict__ decay,
                 T* __restrict__ h_out, int nh, int s, int p, int n, int q,
                 int nc, int nnb, int npb) {
  typedef Mma<T> M;
  constexpr int LB = ld_col(TN, sizeof(T)), LX = ld_col(TP, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* w = reinterpret_cast<float*>(smem_raw);  // [QMAX] cumsum, then
                                                  // exp(total - cum)
  T* bs = reinterpret_cast<T*>(w + QMAX);         // [TQ][LB] B, N-tile
  T* xs = bs + TQ * LB;                           // [TQ][LX] x, P-tile
  int bx = blockIdx.x;
  const int pb = bx % npb;
  bx /= npb;
  const int nb = bx % nnb, c = bx / nnb;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * q, qv = min(q, s - t0), qpad = (qv + 31) & ~31;
  const int n0 = nb * TN, p0 = pb * TP;
  constexpr int rev = REV;
  const ptrdiff_t sgn = REV ? -1 : 1;
  auto stage_tile = [&](int j0) {
    const int jv = min(TQ, qv - j0);
    const size_t row = (size_t)bb * s + time_row(t0 + j0, s, rev);
    stage(bs, LB, bm + row * n + n0, sgn * n, TQ, jv, TN, min(TN, n - n0));
    stage(xs, LX, dtx + (row * nh + h) * p + p0, sgn * nh * p, TQ, jv, TP,
          min(TP, p - p0));
    cp_async_commit();
  };
  stage_tile(0);  // in flight while the cumsum is taken

  const T* la = log_a + ((size_t)bb * nh + h) * s;
  for (int i = tid; i < qpad; i += NT) {
    w[i] = i < qv ? log_a_at(la, t0 + i, s, rev) : 0.f;
  }
  __syncthreads();
  if (warp == 0) warp_cumsum(w, qpad);
  __syncthreads();
  const float total = w[qpad - 1];
  __syncthreads();  // every thread has read the total
  for (int i = tid; i < qpad; i += NT) w[i] = i < qv ? expf(total - w[i]) : 0.f;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int m0 = warp * 32;
  for (int j0 = 0; j0 < qv; j0 += TQ) {
    if (j0 > 0) {
      __syncthreads();  // the last tile is consumed
      stage_tile(j0);
    }
    cp_async_wait<0>();
    __syncthreads();  // the tile, and w, are in place
    const int ksteps = (min(TQ, qv - j0) + M::K - 1) / M::K;
    for (int kk = 0; kk < ksteps; ++kk) {
      const int k = kk * M::K + 2 * t;
      typename M::AW a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt] = M::a_scaled(bs + k * LB + m0 + mt * 16 + g, LB, w + j0 + k);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const typename M::B b = M::b_col(xs + k * LX + nt * 8 + g, LX);
        M::mma(acc[0][nt], a[0], b);
        M::mma(acc[1][nt], a[1], b);
      }
    }
  }

  const size_t bh = (size_t)bb * nh + h;
  const float dA = expf(total);
  if (nc > 1 && nb == 0 && pb == 0 && tid == 0) decay[bh * nc + c] = dA;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = n0 + m0 + mt * 16 + g + 8 * hh;
      if (r >= n) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = p0 + nt * 8 + 2 * t;
        if (col >= p) continue;
        const float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
        if (nc > 1) {
          store2(ws + ((bh * nc + c) * n + r) * p + col, v0, v1);
        } else {
          const size_t o = (bh * n + r) * p + col;
          const float2 h2 = load2(h0 + o);
          store2(h_out + o, dA * h2.x + v0, dA * h2.y + v1);
        }
      }
    }
}

// (b) The state entering each chunk: four state elements a thread, the
// chunks in order, loads kept 8 chunks ahead.
template <typename T>
__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(const T* __restrict__ h0, float* __restrict__ ws,
                const float* __restrict__ decay, T* __restrict__ h_out,
                int nh, int np, int nc) {
  const int e = 4 * (blockIdx.x * PASS_THREADS + threadIdx.x);
  if (e >= np) return;
  const size_t bh = (size_t)blockIdx.z * nh + blockIdx.y;
  float hv[4];
  {
    const float2 a = load2(h0 + bh * np + e), b = load2(h0 + bh * np + e + 2);
    hv[0] = a.x, hv[1] = a.y, hv[2] = b.x, hv[3] = b.y;
  }
  float4* st = reinterpret_cast<float4*>(ws + bh * nc * np + e);
  const size_t step = np / 4;
  const float* dA = decay + bh * nc;
  constexpr int AHEAD = 8;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float4 sc[AHEAD];
    float d[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u < nc) {
        sc[u] = st[(c0 + u) * step];
        d[u] = dA[c0 + u];
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u < nc) {
        st[(c0 + u) * step] = make_float4(hv[0], hv[1], hv[2], hv[3]);
        hv[0] = d[u] * hv[0] + sc[u].x;
        hv[1] = d[u] * hv[1] + sc[u].y;
        hv[2] = d[u] * hv[2] + sc[u].z;
        hv[3] = d[u] * hv[3] + sc[u].w;
      }
    }
  }
  store2(h_out + bh * np + e, hv[0], hv[1]);
  store2(h_out + bh * np + e + 2, hv[2], hv[3]);
}

// (c) y for 64 rows of a chunk and 64 columns of P. Warp w owns rows
// 16 (w % 4) .. + 15 of the tile (its slab) and columns 32 (w / 4) .. + 31;
// the two warps of a slab form alternate j8-tiles of its scores and share
// them through shared memory (rounded to T, the operand type). h_in, h0
// with one chunk, sits in float32. REV as in (a); only the reversed mode
// takes y_fwd, x_fwd and dots.
template <typename T, bool REV>
__global__ void __launch_bounds__(NT_OUT, sizeof(T) == 4 ? 2 : 3)
ssd_out_kernel(const T* __restrict__ log_a, const T* __restrict__ dtx,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const T* __restrict__ h0, const float* __restrict__ ws,
               T* __restrict__ y, const T* __restrict__ y_fwd,
               const T* __restrict__ x_fwd, float* __restrict__ dots, int nh,
               int s, int p, int n, int q, int nc, int nib, int npb) {
  typedef Mma<T> M;
  constexpr int NTP = TP / 16;        // n8 tiles of a warp's 32 columns
  constexpr int LX = ld_col(TP, sizeof(T));
  constexpr int KU = 32 / M::K;       // k-steps unrolled: C h_in, C B^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldn = ld_row(n), nk = n_steps(n, sizeof(T));
  float* cum = reinterpret_cast<float*>(smem_raw);  // [QMAX]
  T* sbuf = reinterpret_cast<T*>(cum + QMAX);       // [4][16][LD_SC] scores
  T* cs = sbuf + 4 * 16 * LD_SC;                    // [TQ][ldn] C, i-tile
  float* hs = reinterpret_cast<float*>(cs + TQ * ldn);  // [nk][LH] h_in,
  T* bs = reinterpret_cast<T*>(hs);                 // then [TQ][ldn] B,
  T* xs = bs + TQ * ldn;                            // [TQ][LX] x, j-tile
  int bx = blockIdx.x;
  const int pb = bx % npb;
  bx /= npb;
  const int ib = nib - 1 - bx % nib;  // the longest row tiles first
  const int c = bx / nib;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int t0 = c * q, qv = min(q, s - t0), i0 = ib * TQ;
  if (i0 >= qv) return;               // past a ragged chunk's end
  const int iv = min(TQ, qv - i0), p0 = pb * TP, pv = min(TP, p - p0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(qv, i0 + TQ), lpad = (len + 31) & ~31;
  const size_t bh = (size_t)bb * nh + h;

  constexpr int rev = REV;
  const ptrdiff_t sgn = REV ? -1 : 1;
  // C and h_in by cp.async (bf16 h0 through registers).
  stage(cs, ldn, cm + ((size_t)bb * s + time_row(t0 + i0, s, rev)) * n,
        sgn * n, TQ, iv, nk, n);
  if (nc > 1) {
    stage(hs, LH, ws + (bh * nc + c) * n * p + p0, p, nk, n, TP, pv);
  } else {
    stage(hs, LH, h0 + bh * n * p + p0, p, nk, n, TP, pv);
  }
  cp_async_commit();
  const T* la = log_a + bh * s;
  for (int i = tid; i < lpad; i += NT_OUT) {
    cum[i] = i < len ? log_a_at(la, t0 + i, s, rev) : 0.f;
  }
  auto stage_j = [&](int j0) {
    const size_t row = (size_t)bb * s + time_row(t0 + j0, s, rev);
    const int jv = min(TQ, qv - j0);
    stage(bs, ldn, bm + row * n, sgn * n, TQ, jv, nk, n);
    stage(xs, LX, dtx + (row * nh + h) * p + p0, sgn * nh * p, TQ, jv, TP,
          pv);
    cp_async_commit();
  };
  cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) warp_cumsum(cum, lpad);
  __syncthreads();

  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * (TP / 2);
  const bool active = r0 < iv;        // warp-uniform: rows past iv are zero
  float acc[NTP][4];
#pragma unroll
  for (int nt = 0; nt < NTP; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const T* crow = cs + (r0 + g) * ldn + 2 * t;
  if (active) {
#pragma unroll KU
    for (int k = 0; k < nk; k += M::K) {
      const typename M::A a = M::a_rows(crow + k, crow + 8 * ldn + k);
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        M::mma(acc[nt], a, M::b_wide(hs + (k + 2 * t) * LH + c0 + nt * 8 + g, LH));
      }
    }
  }
  const int ia = i0 + r0 + g;         // this thread's rows: ia and ia + 8
  const float cia = cum[min(ia, len - 1)], cib = cum[min(ia + 8, len - 1)];
  {
    const float ea = expf(cia), eb = expf(cib);
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      acc[nt][0] *= ea, acc[nt][1] *= ea;
      acc[nt][2] *= eb, acc[nt][3] *= eb;
    }
  }

  for (int jb = 0; jb <= ib; ++jb) {
    const int j0 = jb * TQ;
    __syncthreads();  // h_in, or the last j-tile, is consumed
    stage_j(j0);
    cp_async_wait<0>();
    __syncthreads();
    if (!active) continue;
    // The j8-tiles this slab sees: all below the diagonal tile, on it those
    // up to its last row; four at a time, two of them this warp's.
    const int ntj = jb < ib ? 8 : min(8, (r0 + 16) / 8);
    const int slab = warp & 3, half = warp >> 2;
    T* sb = sbuf + slab * 16 * LD_SC;
    for (int jt0 = 0; jt0 < ntj; jt0 += 4) {
      float sc[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[u][e] = 0.f;
#pragma unroll KU
      for (int k = 0; k < nk; k += M::K) {
        const typename M::A a = M::a_rows(crow + k, crow + 8 * ldn + k);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int jt = jt0 + half + 2 * u;
          if (jt < ntj) {
            M::mma(sc[u], a, M::b_row(bs + (jt * 8 + g) * ldn + k + 2 * t));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int jt = jt0 + half + 2 * u;
        if (jt < ntj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = min(ia + 8 * (e >> 1), len - 1);
            const int j = j0 + jt * 8 + 2 * t + (e & 1);
            const float ci = e < 2 ? cia : cib;
            sc[u][e] = j <= i ? sc[u][e] * expf(ci - cum[j]) : 0.f;
          }
          store2(sb + g * LD_SC + jt * 8 + 2 * t, sc[u][0], sc[u][1]);
          store2(sb + (g + 8) * LD_SC + jt * 8 + 2 * t, sc[u][2], sc[u][3]);
        }
      }
      pair_sync(slab);  // the slab's scores of this group are in place
#pragma unroll
      for (int jt = jt0; jt < jt0 + 4; jt += M::K / 8) {
        if (jt < ntj) {  // ntj is even, so a k16 step's second tile is too
          // Scores as the A fragment of scores . x, k = j.
          const typename M::A a = M::a_rows(sb + g * LD_SC + jt * 8 + 2 * t,
                                            sb + (g + 8) * LD_SC + jt * 8 + 2 * t);
          const T* xr = xs + (jt * 8 + 2 * t) * LX + c0 + g;
#pragma unroll
          for (int nt = 0; nt < NTP; ++nt) {
            M::mma(acc[nt], a, M::b_col(xr + nt * 8, LX));
          }
        }
      }
      pair_sync(slab);  // both have read them before the next group
    }
  }

  if (!active) return;
  if (REV && dots != nullptr) {
    // d log_a's terms of these rows, <dy_t, y_t> - <dtx_t, d dtx_t> over
    // this tile's columns: here dtx is dy (its last j-tile, still in xs, is
    // these rows), y is d dtx (in acc), and y_fwd, x_fwd the forward's y
    // and dtx. Summed over the four lanes of a row, then over the slab's
    // two warps through its score rows (both have read them).
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      if (r >= iv) continue;
      const size_t o = (((size_t)bb * s + time_row(t0 + i0 + r, s, rev)) * nh +
                        h) * p + p0;
#pragma unroll
      for (int nt = 0; nt < NTP; ++nt) {
        const int col = c0 + nt * 8 + 2 * t;
        if (col < pv) {
          const float2 dv = load2(xs + r * LX + col);
          const float2 yv = load2(y_fwd + o + col), xv = load2(x_fwd + o + col);
          part[hh] += dv.x * yv.x + dv.y * yv.y - xv.x * acc[nt][2 * hh] -
                      xv.y * acc[nt][2 * hh + 1];
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      part[hh] += __shfl_xor_sync(~0u, part[hh], 1);
      part[hh] += __shfl_xor_sync(~0u, part[hh], 2);
    }
    float* pr = reinterpret_cast<float*>(sbuf + (warp & 3) * 16 * LD_SC);
    if (t == 0) {
      pr[(warp >> 2) * 16 + g] = part[0];
      pr[(warp >> 2) * 16 + g + 8] = part[1];
    }
    pair_sync(warp & 3);
    if (warp < 4 && t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + g + 8 * hh;
        if (r < iv) {
          dots[(((size_t)pb * gridDim.z + bb) * nh + h) * s +
               time_row(t0 + i0 + r, s, rev)] = pr[g + 8 * hh] + pr[16 + g + 8 * hh];
        }
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= iv) continue;
    T* dst = y + (((size_t)bb * s + time_row(t0 + i0 + r, s, rev)) * nh + h) * p +
             p0 + c0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NTP; ++nt) {
      if (c0 + nt * 8 + 2 * t < pv) {
        store2(dst + nt * 8, acc[nt][2 * hh], acc[nt][2 * hh + 1]);
      }
    }
  }
}

// (d) One step (S = 1, the decode step), one block a (b, h): y = (C . B) x
// + exp(la) (C . h0) and h_last = exp(la) h0 + B x^T, which (a) and (c)
// give for a one-step chunk. Thread (g8, cp) takes state rows g8, g8 + 8,
// ... and columns 2cp, 2cp + 1 (+ 64, ...); y's sum over the rows goes
// through shared memory in a fixed order. REV is the reversed mode (log_a
// read as 0, d log_a's terms into dots), a template argument so that the
// forward's decode step compiles without it.
template <typename T, bool REV>
__global__ void __launch_bounds__(STEP_THREADS)
ssd_step_kernel(const T* __restrict__ log_a, const T* __restrict__ dtx,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const T* __restrict__ h0, T* __restrict__ y,
                T* __restrict__ h_out, const T* __restrict__ y_fwd,
                const T* __restrict__ x_fwd, float* __restrict__ dots, int nh,
                int p, int n) {
  __shared__ float part[STEP_THREADS / 32][2 * 32];
  __shared__ float cbs;
  const int h = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, g8 = tid >> 5, cp = tid & 31;
  const size_t bh = (size_t)bb * nh + h;
  const T* bv = bm + (size_t)bb * n;
  const T* cv = cm + (size_t)bb * n;
  // Reversed, log_a is 0, held opaque: a constant dA = 1 would let the
  // compiler fuse the products below otherwise than the forward mode does,
  // whose bits on flipped copies the reversed mode must give.
  float la = 0.f;
  if (REV) {
    asm volatile("" : "+f"(la));
  } else {
    la = to_f32(log_a[bh]);
  }
  const float dA = expf(la);
  float dsum = 0.f;  // d log_a's terms (the reversed mode with dots)
  // C . B, by the first warp.
  if (g8 == 0) {
    float v = 0.f;
    for (int k = cp; k < n; k += 32) v = fmaf(to_f32(cv[k]), to_f32(bv[k]), v);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
    if (cp == 0) cbs = v;
  }
  const T* xr = dtx + bh * p;
  const T* hr = h0 + bh * n * p;
  T* ho = h_out + bh * n * p;
  for (int col0 = 0; col0 < p; col0 += 64) {  // block-uniform trips
    const int col = col0 + 2 * cp;
    const bool in = col < p;
    const float2 xv = in ? load2(xr + col) : make_float2(0.f, 0.f);
    float ya = 0.f, yb = 0.f;
    for (int k = g8; in && k < n; k += STEP_THREADS / 32) {
      const float bk = to_f32(bv[k]), ck = to_f32(cv[k]);
      const float2 hv = load2(hr + (size_t)k * p + col);
      store2(ho + (size_t)k * p + col, dA * hv.x + bk * xv.x,
             dA * hv.y + bk * xv.y);
      ya = fmaf(ck, hv.x, ya);
      yb = fmaf(ck, hv.y, yb);
    }
    __syncthreads();  // part is free; cbs is written
    part[g8][2 * cp] = ya;
    part[g8][2 * cp + 1] = yb;
    __syncthreads();
    if (g8 == 0 && in) {
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int w = 0; w < STEP_THREADS / 32; ++w) {
        sa += part[w][2 * cp];
        sb += part[w][2 * cp + 1];
      }
      const float ya = cbs * xv.x + sa * dA, yb = cbs * xv.y + sb * dA;
      store2(y + bh * p + col, ya, yb);
      if (REV && dots != nullptr) {
        const float2 yf = load2(y_fwd + bh * p + col),
                     xf = load2(x_fwd + bh * p + col);
        dsum += xv.x * yf.x + xv.y * yf.y - xf.x * ya - xf.y * yb;
      }
    }
  }
  if (REV && dots != nullptr && g8 == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(~0u, dsum, o);
    if (cp == 0) dots[bh] = dsum;
  }
}

// (e) The backward's products (repro_ssd_bwd), dC and dB in one launch:
// for 64 rows t of a chunk and 128 columns of N, d_t[n] = sum over the
// block's heads of exp(cum_t) (dy_t . h_in[n, :]) + sum over s <= t of
// (dy_t . x_s) exp(cum_t - cum_s) B_s[n]: ssd_out_kernel's products with dy
// in C's place, x in B's, B in x's and h_in read across (N and P swap
// roles). blockIdx.z picks the problem: dC is the forward scan against dy;
// dB is the reversed scan (log_a', x' = dy, B' = C, its chunk states, h0' =
// dh_last) against dtx, read in place like repro_ssd's reversed mode and
// written in forward order.
//
// A block walks units (j-tile, head), the heads inner, through a ring of
// `stages` shared-memory stages: a unit's dy and x tiles (and, at the first
// j-tile, h_in) are in flight while the unit before it computes. The B tile
// is the same for every head: it is staged once per j-tile, at the first
// head (the pipeline waits at that one boundary, since the tile is read
// until the last head). Every head's cumsum is taken once, before the walk,
// by all eight warps, a head a warp. All heads add to one float32 sum in
// registers in a fixed order, and the block writes its group's partial: no
// atomics, so a rerun gives the same bits. Sixteen warps: each owns the 16
// rows of one slab and 32 of the N columns; the four warps of a slab each
// form a quarter of its scores (dy . x over P, all eight j8-tiles at once)
// and pass them on through shared memory as the A fragments of scores . B.
// The slabs are dealt so that each SM sub-partition holds all four causal
// row ranges. One block an SM: its stages take most of its shared memory,
// and sixteen warps keep the sub-partitions' tensor cores fed where eight
// waited on their own chains of products.
template <typename T>
__global__ void __launch_bounds__(NT_BWD, 1)
ssd_bwd_kernel(const T* __restrict__ log_a, const T* __restrict__ dtx,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const T* __restrict__ dy, const T* __restrict__ h0,
               const T* __restrict__ dh_last, const float* __restrict__ ws,
               const float* __restrict__ ws_rev, float* __restrict__ part,
               int nbatch, int nh, int s, int p, int n, int q, int nc, int nib,
               int nnb, int hpb, int stages) {
  typedef Mma<T> M;
  constexpr int NTN = TN / 32;        // n8 tiles of a warp's 32 columns
  constexpr int LB = ld_col(TN, sizeof(T));
  constexpr int KU = 32 / M::K;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldp = ld_row(p), pk = n_steps(p, sizeof(T)), lhr = pk + 8;
  const size_t stage_bytes = bwd_stage_bytes(p, sizeof(T));
  T* bc = reinterpret_cast<T*>(smem_raw + stages * stage_bytes);  // [TQ][LB]
  T* sbuf = bc + TQ * LB;                                         // scores
  float* cums = reinterpret_cast<float*>(sbuf + 4 * 16 * LD_SC);  // [hpb][lq]
  const int lq = (q + 31) & ~31;
  int bx = blockIdx.x;
  const int nbk = bx % nnb;
  bx /= nnb;
  const int ib = nib - 1 - bx % nib;  // the longest row tiles first
  const int c = bx / nib;
  const int hg = blockIdx.y, bb = blockIdx.z >> 1, rev = blockIdx.z & 1;
  const int t0 = c * q, qv = min(q, s - t0), i0 = ib * TQ;
  if (i0 >= qv) return;               // past a ragged chunk's end
  const int iv = min(TQ, qv - i0), n0 = nbk * TN, nv = min(TN, n - n0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(qv, i0 + TQ), lpad = (len + 31) & ~31;
  // Warps w, w + 4, w + 8 and w + 12 share an SM sub-partition: give them
  // four different slabs, so that each holds short and long causal rows.
  const int quarter = warp >> 2, slab = (warp + quarter) & 3;
  const int r0 = slab * 16, c0 = quarter * (TN / 4);
  const bool active = r0 < iv;        // warp-uniform: rows past iv are zero
  T* sb = sbuf + slab * 16 * LD_SC;
  const int ia = i0 + r0 + g;         // this thread's rows: ia and ia + 8

  // The problem's operands: rows t ("dy"), rows s ("x"), B, the states.
  const T* ga = rev ? dtx : dy;
  const T* gx = rev ? dy : dtx;
  const T* gb = rev ? cm : bm;
  const float* st = rev ? ws_rev : ws;
  const T* gh0 = rev ? dh_last : h0;
  const ptrdiff_t sgn = rev ? -1 : 1;
  const int h_first = hg * hpb, nhb = min(nh, h_first + hpb) - h_first;
  const int units = (ib + 1) * nhb;

  auto load_unit = [&](int u) {  // unit u = (j-tile u / nhb, head u % nhb)
    const int jb = u / nhb, h = h_first + u % nhb, j0 = jb * TQ;
    T* ds = reinterpret_cast<T*>(smem_raw + (u % stages) * stage_bytes);
    T* xs = ds + TQ * ldp;
    float* hs = reinterpret_cast<float*>(xs + TQ * ldp);
    const size_t bh = (size_t)bb * nh + h;
    stage(ds, ldp,
          ga + (((size_t)bb * s + time_row(t0 + i0, s, rev)) * nh + h) * p,
          sgn * nh * p, TQ, iv, pk, p);
    stage(xs, ldp,
          gx + (((size_t)bb * s + time_row(t0 + j0, s, rev)) * nh + h) * p,
          sgn * nh * p, TQ, min(TQ, qv - j0), pk, p);
    if (jb == 0) {
      if (nc > 1) {
        stage(hs, lhr, st + ((bh * nc + c) * n + n0) * p, p, TN, nv, pk, p);
      } else {
        stage(hs, lhr, gh0 + (bh * n + n0) * p, p, TN, nv, pk, p);
      }
    }
    if (u % nhb == 0) {
      stage(bc, LB, gb + ((size_t)bb * s + time_row(t0 + j0, s, rev)) * n + n0,
            sgn * n, TQ, min(TQ, qv - j0), TN, nv);
    }
    cp_async_commit();
  };
  int nx = 0;  // units loading or loaded
  do {
    load_unit(nx++);
  } while (nx < units && nx < stages && nx % nhb != 0);

  // Every head's cumsum over the chunk's first len steps.
  for (int hl = warp; hl < nhb; hl += NT_BWD / 32) {
    const T* la = log_a + ((size_t)bb * nh + h_first + hl) * s;
    float* cum = cums + hl * lq;
    float carry = 0.f;
    for (int base = 0; base < lpad; base += 32) {
      const int i = base + lane;
      float v = i < len ? log_a_at(la, t0 + i, s, rev) : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float w = __shfl_up_sync(~0u, v, o);
        if (lane >= o) v += w;
      }
      v += carry;
      cum[i] = v;
      carry = __shfl_sync(~0u, v, 31);
    }
  }

  float acc[NTN][4];
#pragma unroll
  for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int u = 0; u < units; ++u) {
    if (nx == u) {  // a round's first unit: the units before it are consumed
      __syncthreads();
      load_unit(nx++);
    }
    bwd_ring_wait(nx - 1 - u);
    __syncthreads();  // unit u is in place, unit u - 1 consumed
    while (nx < units && nx - u < stages && nx % nhb != 0) load_unit(nx++);
    const int jb = u / nhb, hl = u % nhb, j0 = jb * TQ;
    const T* ds = reinterpret_cast<const T*>(smem_raw + (u % stages) * stage_bytes);
    const T* xs = ds + TQ * ldp;
    const float* hs = reinterpret_cast<const float*>(xs + TQ * ldp);
    const float* cum = cums + hl * lq;
    const T* drow = ds + (r0 + g) * ldp + 2 * t;
    const float cia = cum[min(ia, len - 1)], cib = cum[min(ia + 8, len - 1)];
    // The unit's terms sum in a tile of their own, added to acc after: the
    // tensor cores' adds into a large running sum lose low bits, in
    // proportion to the heads summed (80 heads missed the float32 check).
    float tmp[NTN][4];
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmp[nt][e] = 0.f;
    if (active && jb == 0) {  // exp(cum_t) (dy_t . h_in[n, :])
#pragma unroll KU
      for (int k = 0; k < pk; k += M::K) {
        const typename M::A a = M::a_rows(drow + k, drow + 8 * ldp + k);
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt) {
          M::mma(tmp[nt], a,
                 M::b_wide_row(hs + (c0 + nt * 8 + g) * lhr + k + 2 * t));
        }
      }
      const float ea = expf(cia), eb = expf(cib);
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt) {
        tmp[nt][0] *= ea, tmp[nt][1] *= ea;
        tmp[nt][2] *= eb, tmp[nt][3] *= eb;
      }
    }
    if (active) {
      // The j8-tiles this slab sees (all below the diagonal tile, on it
      // those up to its last row), every fourth one this warp's.
      const int ntj = jb < ib ? 8 : min(8, (r0 + 16) / 8);
      {
        float sc[2][4];
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[v][e] = 0.f;
#pragma unroll KU
        for (int k = 0; k < pk; k += M::K) {
          const typename M::A a = M::a_rows(drow + k, drow + 8 * ldp + k);
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int jt = quarter + 4 * v;
            if (jt < ntj) {
              M::mma(sc[v], a, M::b_row(xs + (jt * 8 + g) * ldp + k + 2 * t));
            }
          }
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int jt = quarter + 4 * v;
          if (jt < ntj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = min(ia + 8 * (e >> 1), len - 1);
              const int j = j0 + jt * 8 + 2 * t + (e & 1);
              const float ci = e < 2 ? cia : cib;
              sc[v][e] = j <= i ? sc[v][e] * expf(ci - cum[min(j, len - 1)]) : 0.f;
            }
            store2(sb + g * LD_SC + jt * 8 + 2 * t, sc[v][0], sc[v][1]);
            store2(sb + (g + 8) * LD_SC + jt * 8 + 2 * t, sc[v][2], sc[v][3]);
          }
        }
        quad_sync(slab);  // the slab's scores are in place
#pragma unroll
        for (int jt = 0; jt < 8; jt += M::K / 8) {
          if (jt < ntj) {
            const typename M::A a = M::a_rows(sb + g * LD_SC + jt * 8 + 2 * t,
                                              sb + (g + 8) * LD_SC + jt * 8 + 2 * t);
            const T* br = bc + (jt * 8 + 2 * t) * LB + c0 + g;
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt) {
              M::mma(tmp[nt], a, M::b_col(br + nt * 8, LB));
            }
          }
        }
      }  // (the next unit's scores are written after its __syncthreads)
#pragma unroll
      for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += tmp[nt][e];
    }
  }

  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= iv) continue;
    float* dst = part + ((((size_t)hg * 2 + rev) * nbatch + bb) * s +
                         time_row(t0 + i0 + r, s, rev)) * n + n0 + c0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt) {
      if (c0 + nt * 8 + 2 * t < nv) {
        store2(dst + nt * 8, acc[nt][2 * hh], acc[nt][2 * hh + 1]);
      }
    }
  }
}

template <typename T>
int launch_bwd(const void* log_a, const void* dtx, const void* bm,
               const void* cm, const void* dy, const void* h0,
               const void* dh_last, const float* ws, const float* ws_rev,
               float* part, int b, int nh, int s, int p, int n, int q, int hpb,
               cudaStream_t stream) {
  const int stages = bwd_stages(p, q, hpb, sizeof(T));
  if (q > QMAX || p % 8 || n % 8 || hpb <= 0 || stages == 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = (s + q - 1) / q;
  if (nc > 1 && (ws == nullptr || ws_rev == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nnb = (n + TN - 1) / TN, nib = (q + TQ - 1) / TQ;
  const int groups = (nh + hpb - 1) / hpb;
  auto kern = ssd_bwd_kernel<T>;
  const size_t smem = bwd_smem(p, q, hpb, stages, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(nc * nib * nnb, groups, 2 * b), NT_BWD, smem, stream>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(dtx),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const T*>(dy), static_cast<const T*>(h0),
      static_cast<const T*>(dh_last), ws, ws_rev, part, b, nh, s, p, n, q, nc,
      nib, nnb, hpb, stages);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* log_a, const void* dtx, const void* bm, const void* cm,
           const void* h0, void* y, void* h_out, float* ws, float* decay,
           const void* y_fwd, const void* x_fwd, float* dots, int b, int nh,
           int s, int p, int n, int q, int rev, cudaStream_t stream) {
  if (q > QMAX || p % 8 || n % 8 ||
      out_smem(n, sizeof(T)) > (size_t)SMEM_LIMIT) {
    return (int)cudaErrorInvalidValue;
  }
  const int nc = (s + q - 1) / q;
  if (nc > 1 && (ws == nullptr || decay == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nnb = (n + TN - 1) / TN, npb = (p + TP - 1) / TP;
  const int nib = (q + TQ - 1) / TQ;
  const T* la = static_cast<const T*>(log_a);
  const T* x = static_cast<const T*>(dtx);
  const T* bmt = static_cast<const T*>(bm);
  const T* h0t = static_cast<const T*>(h0);
  T* hout = static_cast<T*>(h_out);
  const T* yf = static_cast<const T*>(y_fwd);
  const T* xf = static_cast<const T*>(x_fwd);

  if (s == 1) {  // the decode step: one kernel
    auto step = rev ? ssd_step_kernel<T, true> : ssd_step_kernel<T, false>;
    step<<<dim3(nh, b), STEP_THREADS, 0, stream>>>(
        la, x, bmt, static_cast<const T*>(cm), h0t, static_cast<T*>(y), hout,
        yf, xf, dots, nh, p, n);
    return (int)cudaGetLastError();
  }
  auto state = rev ? ssd_state_kernel<T, true> : ssd_state_kernel<T, false>;
  auto out = rev ? ssd_out_kernel<T, true> : ssd_out_kernel<T, false>;
  // All of the SM's 228 KB as shared memory, so that as many blocks as it
  // fits share an SM (at N = 128: four of (a); two of (c) in float32, three
  // in bf16, where registers bound it).
  cudaError_t err = cudaFuncSetAttribute(
      state, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)state_smem(sizeof(T)));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(state,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        out, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)out_smem(n, sizeof(T)));
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(out,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;

  state<<<dim3(nc * nnb * npb, nh, b), NT, state_smem(sizeof(T)), stream>>>(
      la, x, bmt, h0t, ws, decay, hout, nh, s, p, n, q, nc, nnb, npb);
  if (nc > 1) {
    const int per = PASS_THREADS * 4;
    ssd_pass_kernel<T><<<dim3((n * p + per - 1) / per, nh, b), PASS_THREADS,
                         0, stream>>>(h0t, ws, decay, hout, nh, n * p, nc);
  }
  out<<<dim3(nc * nib * npb, nh, b), NT_OUT, out_smem(n, sizeof(T)), stream>>>(
      la, x, bmt, static_cast<const T*>(cm), h0t, ws, static_cast<T*>(y), yf,
      xf, dots, nh, s, p, n, q, nc, nib, npb);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q is the chunk length (1 <= q <= 256;
// the last chunk may be shorter); P and N are multiples of 8, and dtx, Bm,
// C and h0 start on 16 bytes. With more than one chunk, ws holds
// ceil(S / q) * B * H * N * P floats and decay ceil(S / q) * B * H (both
// may be null otherwise). Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for an argument this file does not take.
//
// reverse = 1 runs the scan backward in time, read in place: step t is
// forward step S - 1 - t of dtx, Bm and C, its log_a 0 at t = 0 and
// log_a[S - t] after, and y is written at the forward step (the states in
// ws, the scan's own, in its order). The backward calls it with dtx = dy,
// Bm = C, C = Bm and h0 = dh_last for d dtx (y) and the adjoint states.
// dots, if not null (reverse only), takes d log_a's terms <dy_t, y_fwd_t> -
// <x_fwd_t, y_t> over P, float32 [parts, B, H, S] at forward steps, one part
// a 64-column tile of P (one part at S = 1); y_fwd and x_fwd are the
// forward's y and dtx.
extern "C" int repro_ssd(const void* log_a, const void* dtx, const void* bm,
                         const void* cm, const void* h0, void* y, void* h_out,
                         void* ws, void* decay, const void* y_fwd,
                         const void* x_fwd, void* dots, int b, int nh, int s,
                         int p, int n, int q, int reverse, int dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || nh <= 0 || s <= 0 || p <= 0 || n <= 0 || q <= 0 ||
      (reverse != 0 && reverse != 1) ||
      (dots != nullptr && (!reverse || y_fwd == nullptr || x_fwd == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  float* wsf = static_cast<float*>(ws);
  float* dec = static_cast<float*>(decay);
  float* dts = static_cast<float*>(dots);
  if (dtype == 0) {
    return launch<float>(log_a, dtx, bm, cm, h0, y, h_out, wsf, dec, y_fwd,
                         x_fwd, dts, b, nh, s, p, n, q, reverse, st);
  }
  if (dtype == 1) {
    return launch<bf16>(log_a, dtx, bm, cm, h0, y, h_out, wsf, dec, y_fwd,
                        x_fwd, dts, b, nh, s, p, n, q, reverse, st);
  }
  return (int)cudaErrorInvalidValue;
}


// Shared memory of one block of (c), the larger kernel, at state width n
// (dtype as above): the bound on N that `repro_ssd` checks. The wrapper's
// KernelSpec (kernels/ssd/ops.py: smem_bytes) reads QMAX, TQ and TP from
// this file and states the same sum, which a card test holds to this one.
extern "C" long long repro_ssd_smem(int n, int dtype) {
  return (long long)out_smem(n, dtype == 0 ? 4 : 2);
}


// The backward's dB and dC (ssd_bwd_kernel), one launch: part[g, 0, b, t, n]
// = dC's and part[g, 1, b, t, n] = dB's sum over heads g * hpb .. (g + 1) *
// hpb - 1, where the function of a scan (log_a, x, B, states) against rows
// r is exp(cum_t) (r_t . h_in) + sum over s <= t in t's chunk of (r_t . x_s)
// exp(cum_t - cum_s) B_s: dC's scan is the forward one (log_a, dtx, bm, ws:
// the forward's states entering each chunk, [B, H, nc, N, P] float32) against
// dy; dB's the reversed one (reverse = 1 of repro_ssd: x = dy, B = cm,
// ws_rev its states) against dtx, written at forward steps. With one chunk
// ws and ws_rev may be null (the states are h0 and dh_last). part holds
// ceil(H / hpb) * 2 * B * S * N floats. Shapes and alignment as repro_ssd's.
extern "C" int repro_ssd_bwd(const void* log_a, const void* dtx,
                             const void* bm, const void* cm, const void* dy,
                             const void* h0, const void* dh_last,
                             const void* ws, const void* ws_rev, void* part,
                             int b, int nh, int s, int p, int n, int q,
                             int hpb, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || nh <= 0 || s <= 0 || p <= 0 || n <= 0 || q <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* wsf = static_cast<const float*>(ws);
  const float* wsr = static_cast<const float*>(ws_rev);
  float* pf = static_cast<float*>(part);
  if (dtype == 0) {
    return launch_bwd<float>(log_a, dtx, bm, cm, dy, h0, dh_last, wsf, wsr, pf,
                             b, nh, s, p, n, q, hpb, st);
  }
  if (dtype == 1) {
    return launch_bwd<bf16>(log_a, dtx, bm, cm, dy, h0, dh_last, wsf, wsr, pf,
                            b, nh, s, p, n, q, hpb, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one ssd_bwd_kernel block at head width p, chunk q and hpb
// heads a block (dtype as above), at the stages it launches with (two where
// they fit, else one; one if neither fits, which repro_ssd_bwd refuses);
// kernels/ssd/ops.py: smem_bwd_bytes states the same sum.
extern "C" long long repro_ssd_bwd_smem(int p, int q, int hpb, int dtype) {
  const int es = dtype == 0 ? 4 : 2;
  const int stages = bwd_stages(p, q, hpb, es);
  return (long long)bwd_smem(p, q, hpb, stages == 0 ? 1 : stages, es);
}
