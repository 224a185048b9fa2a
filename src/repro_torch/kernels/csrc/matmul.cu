// Matrix product for Hopper (sm_90a): c[M,N] = a[M,K] @ b[K,N], float32 or
// bfloat16 in and out, float32 accumulation. b is the port's weight layout,
// [K, N] row-major (N contiguous).
//
// Replaces: src/repro/kernels/matmul/matmul.py, function `matmul`
// (`_matmul_kernel`), the Pallas TPU kernel with a (bm, bk, bn) grid and an
// f32 VMEM accumulator cast on the last K step.
//
// Four regimes; the wrapper (kernels/matmul/ops.py:mm) picks one from M, N,
// K and the dtype before the launch, and this file refuses a call that does
// not meet its regime's conditions:
//
// * skinny (M <= 16: decode, one row per serving slot). A matrix-vector
//   product: the weight is read once for 2*M FLOP per element, so device
//   memory bounds it (qwen2's 1536 x 8960 float32 weight, 55 MB, takes
//   16 us at 3.35 TB/s). A block owns 256 columns; each thread streams
//   16-byte vectors of B (4 floats or 8 bf16 of contiguous columns) down a
//   run of K rows, unrolled so that several loads are in flight a thread;
//   the M rows of A wait in shared memory; K is split over blockIdx.y until
//   at least two blocks sit on each of the 132 SMs; the k-lanes of a block
//   meet in shared memory in a fixed order.
// * simt (M > 16, float32). Operations bound it. It stays in full float32
//   on the SIMT units (67 TFLOP/s), never TF32: the float32 path must agree
//   with the plain version to 2e-5. 256 threads own a 128x128 or 64x128
//   tile with 8x8 or 4x8 register micro-tiles and walk K in steps of 16; A
//   comes in with 16-byte loads and is stored transposed in shared memory,
//   so the inner loop reads float4s of A and B; B arrives by cp.async into
//   a two-stage ring, so tile k+1 loads while tile k computes, with one
//   barrier a step.
// * wgmma (M > 16, bfloat16). Operations bound it, at 989 TFLOP/s on the
//   tensor cores. TMA brings the A tile (K-major) and the B tile (MN-major:
//   the weight as it lies, no transposed copy) with 128-byte swizzle into a
//   4-stage ring guarded by mbarriers; one or two consumer warpgroups issue
//   wgmma m64n128k16 with the float32 sum in registers, and thread 0 keeps
//   the next tiles' loads in flight. Rows past M and K past its end come
//   from TMA's zero fill; the epilogue casts and masks.
// * plain (a row of A or B that is no multiple of 16 bytes, which neither
//   TMA nor a 16-byte load can take). The simt tiles with scalar loads, for
//   any M and either dtype.
//
// Every regime masks its ragged edges. When the output tiles are too few
// for the card, K is split over the grid into a float32 workspace that a
// second kernel sums in split order: the result is deterministic, with no
// float atomics.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;  // threads of a skinny or simt block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of T, unpacked to floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i sits in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Sum the K-split partials in split order and cast to the output type.
template <typename T>
__global__ void matmul_splitk_reduce(const float* __restrict__ ws,
                                     T* __restrict__ c, size_t mn,
                                     int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[(size_t)z * mn + i];
  store(&c[i], s);
}

// ---------------------------------------------------------------------------
// skinny: M <= MT rows against a streamed weight
// ---------------------------------------------------------------------------

constexpr int SK_KC = 512;  // K rows of A staged in shared memory at a time

template <typename T, int MT, int BK, int BN>
__global__ void __launch_bounds__(NT)
matmul_skinny(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ c, float* __restrict__ ws, int m, int n, int k,
              int k_split) {
  constexpr int VEC = Vec<T>::N;
  constexpr int CT = BN / VEC;   // threads across N, each owning VEC columns
  constexpr int KL = NT / CT;    // k-lanes
  constexpr int U = BK / KL;     // B rows a k-lane loads per step
  static_assert(CT * VEC == BN && KL * CT == NT && U * KL == BK,
                "tile does not map onto the block");
  static_assert(SK_KC % BK == 0, "a step must not straddle an A chunk");
  __shared__ float as[MT][SK_KC];
  __shared__ float red[KL][BN];

  const int tid = threadIdx.x;
  const int ct = tid % CT, kl = tid / CT;
  const int n0 = blockIdx.x * BN;
  const int col = n0 + ct * VEC;
  const bool col_ok = col < n;  // n % VEC == 0: a vector is all in or out
  const int k_begin = blockIdx.y * k_split;
  const int k_end = min(k, k_begin + k_split);

  float acc[MT][VEC];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[r][v] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += SK_KC) {
    const int kn = min(SK_KC, k_end - kc);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = tid; i < MT * SK_KC; i += NT) {
      const int r = i / SK_KC, kk = i % SK_KC;
      as[r][kk] = (r < m && kk < kn) ? to_f32(a[(size_t)r * k + kc + kk]) : 0.f;
    }
    __syncthreads();
    for (int k0 = 0; k0 < kn; k0 += BK) {
      const int kr = k0 + kl * U;  // this lane's first row of the step
      uint4 raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        raw[u] = (col_ok && kr + u < kn)
                     ? __ldg(reinterpret_cast<const uint4*>(
                           b + (size_t)(kc + kr + u) * n + col))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float bv[VEC];
        Vec<T>::unpack(raw[u], bv);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const float av = as[r][kr + u];
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[r][v] = fmaf(av, bv[v], acc[r][v]);
        }
      }
    }
  }

  // The k-lanes meet in shared memory, summed in lane order.
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    if (r >= m) break;  // uniform over the block
    __syncthreads();
#pragma unroll
    for (int v = 0; v < VEC; ++v) red[kl][ct * VEC + v] = acc[r][v];
    __syncthreads();
    for (int j = tid; j < BN; j += NT) {
      const int gn = n0 + j;
      if (gn >= n) continue;
      float s = 0.f;
#pragma unroll
      for (int l = 0; l < KL; ++l) s += red[l][j];
      if (ws != nullptr)
        ws[((size_t)blockIdx.y * m + r) * n + gn] = s;
      else
        store(&c[(size_t)r * n + gn], s);
    }
  }
}

// ---------------------------------------------------------------------------
// simt: float32 tiles on the SIMT units (VEC), or scalar loads (plain)
// ---------------------------------------------------------------------------

template <typename T, int BM, int BK, int BN, bool VEC>
__global__ void __launch_bounds__(NT)
matmul_simt(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, float* __restrict__ ws, int m, int n, int k,
            int k_split) {
  constexpr int TX = 16;           // threads across N, 8 columns each
  constexpr int TY = NT / TX;      // threads across M
  constexpr int TM = BM / TY;      // rows a thread owns: 8 or 4
  constexpr int AP = BM + 4;       // padded row of the transposed A tile
  constexpr int A_LD = BM * BK / (4 * NT);  // 4-element pieces a thread loads
  constexpr int B_LD = BK * BN / (4 * NT);
  static_assert(BN == 128 && BK == 16 && (TM == 8 || TM == 4),
                "compiled simt tiles: (128|64, 16, 128)");
  static_assert(!VEC || sizeof(T) == 4, "the vector path is float32");
  __shared__ __align__(16) float as[2][BK][AP];  // as[k][m]
  __shared__ __align__(16) float bs[2][BK][BN];

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(k, k_begin + k_split);
  const int nk = (k_end - k_begin + BK - 1) / BK;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ra[A_LD][4];  // the next A tile, on its way through registers
  float rb[B_LD][4];  // the next B tile (scalar path only)

  auto load_a = [&](int kt) {
    const int k0 = k_begin + kt * BK;
#pragma unroll
    for (int p = 0; p < A_LD; ++p) {
      const int idx = tid + p * NT;
      const int gm = m0 + idx / (BK / 4), gk = k0 + (idx % (BK / 4)) * 4;
      if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gm < m && gk < k_end)
          v = __ldg(reinterpret_cast<const float4*>(a + (size_t)gm * k + gk));
        ra[p][0] = v.x; ra[p][1] = v.y; ra[p][2] = v.z; ra[p][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ra[p][j] = (gm < m && gk + j < k_end)
                         ? to_f32(a[(size_t)gm * k + gk + j]) : 0.f;
      }
    }
  };
  auto store_a = [&](int st) {
#pragma unroll
    for (int p = 0; p < A_LD; ++p) {
      const int idx = tid + p * NT;
      const int r = idx / (BK / 4), kq = (idx % (BK / 4)) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j) as[st][kq + j][r] = ra[p][j];
    }
  };
  auto load_b = [&](int kt, int st) {
    const int k0 = k_begin + kt * BK;
#pragma unroll
    for (int p = 0; p < B_LD; ++p) {
      const int idx = tid + p * NT;
      const int kk = idx / (BN / 4), cn = (idx % (BN / 4)) * 4;
      const int gk = k0 + kk, gn = n0 + cn;
      if constexpr (VEC) {
        const bool ok = gk < k_end && gn < n;
        cp_async16(&bs[st][kk][cn], ok ? (const void*)(b + (size_t)gk * n + gn)
                                       : (const void*)b,
                   ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          rb[p][j] = (gk < k_end && gn + j < n)
                         ? to_f32(b[(size_t)gk * n + gn + j]) : 0.f;
      }
    }
  };
  auto store_b = [&](int st) {
    if constexpr (!VEC) {
#pragma unroll
      for (int p = 0; p < B_LD; ++p) {
        const int idx = tid + p * NT;
        const int kk = idx / (BN / 4), cn = (idx % (BN / 4)) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) bs[st][kk][cn + j] = rb[p][j];
      }
    }
  };

  if (nk > 0) {
    load_a(0);
    load_b(0, 0);
    store_a(0);
    store_b(0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {
      load_a(kt + 1);
      load_b(kt + 1, cur ^ 1);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      if constexpr (TM == 8) {
        const float4 a1 =
            *reinterpret_cast<const float4*>(&as[cur][kk][64 + ty * 4]);
        av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) {
      store_a(cur ^ 1);
      store_b(cur ^ 1);
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // Rows ty*4 + i (and 64 + ty*4 + i), columns tx*4 + j and 64 + tx*4 + j.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      const float* v = &acc[i][h * 4];
      if (ws != nullptr) {
        float* dst = ws + ((size_t)blockIdx.z * m + row) * n + col;
        if (VEC) {
          if (col < n) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < n) dst[j] = v[j];
        }
      } else {
        T* dst = c + (size_t)row * n + col;
        if constexpr (VEC) {
          if (col < n) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < n) store(dst + j, v[j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: bfloat16 on the tensor cores, TMA into an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int WG_BK = 64;       // one 128-byte swizzle row of bf16
constexpr int WG_BN = 128;
constexpr int WG_STAGES = 4;

// d[64] += A (64x16, K-major) @ B (16x128, MN-major), bf16 in, f32 sum.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

template <int WG>
constexpr size_t wgmma_smem() {
  return (size_t)WG_STAGES * (64 * WG * WG_BK * 2 + WG_BK * WG_BN * 2) +
         1024 /* alignment */ + 2 * WG_STAGES * sizeof(uint64_t);
}

// WG consumer warpgroups, each owning 64 rows of the (64*WG) x 128 tile.
template <int WG>
__global__ void __launch_bounds__(128 * WG)
matmul_wgmma(const __grid_constant__ CUtensorMap tma_a,
             const __grid_constant__ CUtensorMap tma_b, bf16* __restrict__ c,
             float* __restrict__ ws, int m, int n, int k, int k_split) {
  constexpr int BM = 64 * WG;
  constexpr uint32_t A_BYTES = BM * WG_BK * 2;     // [BM][64] bf16
  constexpr uint32_t B_BYTES = WG_BK * WG_BN * 2;  // two [64 k][64 n] halves
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: align the ring to it.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sa = smem;
  uint8_t* sb = smem + WG_STAGES * A_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + WG_STAGES * B_BYTES);
  uint64_t* empty = full + WG_STAGES;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * WG_BN;
  const int k_begin = blockIdx.z * k_split;
  const int nk = (min(k, k_begin + k_split) - k_begin + WG_BK - 1) / WG_BK;

  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const CUtensorMap* map_a = &tma_a;
  const CUtensorMap* map_b = &tma_b;
  auto issue = [=](int kt) {
    const int s = kt % WG_STAGES;
    const int kc = k_begin + kt * WG_BK;
    mbar_expect_tx(&full[s], A_BYTES + B_BYTES);
    tma_load_2d(sa + s * A_BYTES, map_a, kc, m0, &full[s]);
    tma_load_2d(sb + s * B_BYTES, map_b, n0, kc, &full[s]);
    tma_load_2d(sb + s * B_BYTES + B_BYTES / 2, map_b, n0 + 64, kc, &full[s]);
  };
  if (tid == 0) {
    for (int kt = 0; kt < min(nk, WG_STAGES); ++kt) issue(kt);
  }
  __syncwarp();  // wgmma is warp-aligned: reconverge after thread 0's work

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(&full[s], (kt / WG_STAGES) & 1);
    wgmma_fence();
    const uint8_t* a_tile = sa + s * A_BYTES + wg * 64 * 128;
    const uint8_t* b_tile = sb + s * B_BYTES;
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // A: 16 columns = 32 bytes along the swizzled row; 8-row groups 1024 B
      // apart. B: 16 rows of 128 B; the second 64 columns 8 KB on.
      wgmma_m64n128k16(acc, sw128_desc(a_tile + kk * 32, 16, 1024),
                       sw128_desc(b_tile + kk * 16 * 128, B_BYTES / 2, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with its stage
    if (kt > 0) {
      const int sp = (kt - 1) % WG_STAGES;
      if (t == 0) mbar_arrive(&empty[sp]);
      if (tid == 0 && kt - 1 + WG_STAGES < nk) {
        mbar_wait(&empty[sp], ((kt - 1) / WG_STAGES) & 1);
        issue(kt - 1 + WG_STAGES);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");

  // Accumulator layout of m64nNk16: register 4j + 2h + e holds row
  // 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + e.
  const int warp = t / 32, lane = t % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;  // n % 8 == 0: col+1 < n too
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + h * 8;
      if (row >= m) continue;
      const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
      if (ws != nullptr)
        *reinterpret_cast<float2*>(ws + ((size_t)blockIdx.z * m + row) * n +
                                   col) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(c + (size_t)row * n + col) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

// A 2-D bf16 row-major [outer, inner] tensor, boxes of [box_outer, 64].
int tensor_map(CUtensorMap* map, const void* ptr, int inner, int outer,
               int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  return bf16_tensor_map(map, ptr, 2, dims, strides, box);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
void reduce(float* ws, void* c, int m, int n, int splits, cudaStream_t st) {
  const size_t mn = (size_t)m * n;
  matmul_splitk_reduce<T><<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      ws, static_cast<T*>(c), mn, splits);
}

template <typename T, int MT, int BK, int BN>
void launch_skinny(const void* a, const void* b, void* c, float* ws, int m,
                   int n, int k, int k_split, int splits, cudaStream_t st) {
  dim3 grid((n + BN - 1) / BN, splits);
  matmul_skinny<T, MT, BK, BN><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      splits > 1 ? ws : nullptr, m, n, k, k_split);
}

template <typename T, int BK, int BN>
void skinny_rows(const void* a, const void* b, void* c, float* ws, int m,
                 int n, int k, int k_split, int splits, cudaStream_t st) {
  if (m <= 1)
    launch_skinny<T, 1, BK, BN>(a, b, c, ws, m, n, k, k_split, splits, st);
  else if (m <= 4)
    launch_skinny<T, 4, BK, BN>(a, b, c, ws, m, n, k, k_split, splits, st);
  else
    launch_skinny<T, 16, BK, BN>(a, b, c, ws, m, n, k, k_split, splits, st);
}

template <typename T, int BM, bool VEC>
void launch_simt(const void* a, const void* b, void* c, float* ws, int m,
                 int n, int k, int k_split, int splits, cudaStream_t st) {
  dim3 grid((n + 127) / 128, (m + BM - 1) / BM, splits);
  matmul_simt<T, BM, 16, 128, VEC><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      splits > 1 ? ws : nullptr, m, n, k, k_split);
}

template <int WG>
int launch_wgmma(const void* a, const void* b, void* c, float* ws, int m,
                 int n, int k, int k_split, int splits, cudaStream_t st) {
  CUtensorMap ma, mb;
  int rc = tensor_map(&ma, a, k, m, 64 * WG);
  if (rc != 0) return rc;
  rc = tensor_map(&mb, b, n, k, 64);
  if (rc != 0) return rc;
  constexpr size_t smem = wgmma_smem<WG>();
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        matmul_wgmma<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  dim3 grid((n + WG_BN - 1) / WG_BN, (m + 64 * WG - 1) / (64 * WG), splits);
  matmul_wgmma<WG><<<grid, 128 * WG, smem, st>>>(
      ma, mb, static_cast<bf16*>(c), splits > 1 ? ws : nullptr, m, n, k,
      k_split);
  return 0;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

enum Regime { SKINNY = 0, SIMT = 1, WGMMA = 2, PLAIN = 3 };

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. regime: 0 skinny, 1 simt, 2 wgmma,
// 3 plain, with the (bm, bk, bn) tiles each compiles. K is split into
// `splits` runs of `k_split` rows (a multiple of bk); ws is a float32
// workspace of splits*m*n elements, unused when splits == 1. Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// call its regime does not take.
extern "C" int repro_matmul(const void* a, const void* b, void* c, void* ws,
                            int m, int n, int k, int dtype, int regime, int bm,
                            int bk, int bn, int k_split, int splits,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const int esize = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (esize == 0 || m <= 0 || n <= 0 || k <= 0 || splits < 1 ||
      k_split < 1 || k_split % bk != 0 || (long long)splits * k_split < k ||
      (long long)(splits - 1) * k_split >= k ||
      (splits > 1 && ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool vec_ok = (k * esize) % 16 == 0 && (n * esize) % 16 == 0 &&
                      aligned16(a) && aligned16(b) && aligned16(c) &&
                      (ws == nullptr || aligned16(ws));
  int rc = 0;
  if (regime == SKINNY) {
    if (m > 16 || !vec_ok || bm != 16 || bk != 64 || bn != 256)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      skinny_rows<float, 64, 256>(a, b, c, w, m, n, k, k_split, splits, st);
    else
      skinny_rows<bf16, 64, 256>(a, b, c, w, m, n, k, k_split, splits, st);
  } else if (regime == SIMT || regime == PLAIN) {
    if (bk != 16 || bn != 128 || (bm != 128 && bm != 64))
      return (int)cudaErrorInvalidValue;
    if (regime == SIMT) {
      if (dtype != 0 || !vec_ok) return (int)cudaErrorInvalidValue;
      if (bm == 128)
        launch_simt<float, 128, true>(a, b, c, w, m, n, k, k_split, splits, st);
      else
        launch_simt<float, 64, true>(a, b, c, w, m, n, k, k_split, splits, st);
    } else if (dtype == 0) {
      if (bm == 128)
        launch_simt<float, 128, false>(a, b, c, w, m, n, k, k_split, splits, st);
      else
        launch_simt<float, 64, false>(a, b, c, w, m, n, k, k_split, splits, st);
    } else {
      if (bm == 128)
        launch_simt<bf16, 128, false>(a, b, c, w, m, n, k, k_split, splits, st);
      else
        launch_simt<bf16, 64, false>(a, b, c, w, m, n, k, k_split, splits, st);
    }
  } else if (regime == WGMMA) {
    if (dtype != 1 || !vec_ok || bk != WG_BK || bn != WG_BN)
      return (int)cudaErrorInvalidValue;
    if (bm == 128)
      rc = launch_wgmma<2>(a, b, c, w, m, n, k, k_split, splits, st);
    else if (bm == 64)
      rc = launch_wgmma<1>(a, b, c, w, m, n, k, k_split, splits, st);
    else
      return (int)cudaErrorInvalidValue;
    if (rc != 0) return rc;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (splits > 1) {
    if (dtype == 0)
      reduce<float>(w, c, m, n, splits, st);
    else
      reduce<bf16>(w, c, m, n, splits, st);
  }
  return (int)cudaGetLastError();
}
