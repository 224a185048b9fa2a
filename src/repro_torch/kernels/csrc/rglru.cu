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
// a and x, write y), so device-memory bytes: 0.060 ms in float32 and 0.030
// in bf16 at recurrentgemma-9b's F = 4096 and S = 4096. A scan that walks
// time in one chain per feature has only F = 4096 chains at B = 1, two SMs'
// worth of threads, and is bound by the latency of its S dependent steps.
//
// Design: a chunked scan over time, three launches in order on one stream.
// The tile (bt, bf) is the chunk length L = bt in time and the features a
// block takes, bf.
// (a) rglru_summary, grid (F/bf x S/L, B): for each (chunk, feature) the
//     chunk's decay A_c = prod a_t and its scan from zero, e_c; a and x are
//     read once, with 16-byte loads (4 float32 or 8 bf16 features a thread)
//     where F and bf allow.
// (b) rglru_carry, grid (F/256, B): each feature walks its chunks in order,
//     h_in_c = h and h = A_c h + e_c from h0, loads kept 16 chunks ahead;
//     it touches F x S/L values.
// (c) rglru_rescan, grid as (a): each (chunk, feature) rescans from h_in_c
//     with h = a_t h + x_t, each product and sum rounded as the plain
//     version rounds them (__fmul_rn, __fadd_rn), writes every h_t, and the
//     last chunk writes h_last.
// At L = 64 and S = F = 4096 that is 262,144 independent chains (the card
// holds 270,336 resident threads) and 5/3 of the bound's bytes (a and x are
// read twice). Only h_in is rounded otherwise than in the plain scan: it
// comes through the product of up to L decays. With one chunk (S <= L:
// the decode step) only (c) runs, from h0.
//
// The backward (repro_rglru_bwd, below (c)): the same three launches over
// time reversed, reading the reversed rows in place (no flipped copies),
// with da = g h_{t-1} folded into the rescan. It moves a, dy and y in and
// dx and da out, five arrays of S x F: 0.100 ms in float32 at S = F = 4096
// is its bound. The Pallas kernel has no backward (the reference
// differentiates its jnp scan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_FEATURES = 1024;  // features a block (threads, unvectorised)
constexpr int CARRY_THREADS = 256;
constexpr int AHEAD = 16;           // chunks the carry loads ahead

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// V neighbouring elements of T as floats: 16 bytes for V > 1.
template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 1> {
  __device__ static void load(const float* p, float* f) { f[0] = *p; }
  __device__ static void store(float* p, const float* f) { *p = f[0]; }
};
template <>
struct Vec<bf16, 1> {
  __device__ static void load(const bf16* p, float* f) {
    f[0] = __bfloat162float(*p);
  }
  __device__ static void store(bf16* p, const float* f) {
    *p = __float2bfloat16(f[0]);
  }
};
template <>
struct Vec<float, 4> {
  __device__ static void load(const float* p, float* f) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = r.x, f[1] = r.y, f[2] = r.z, f[3] = r.w;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<bf16, 8> {
  __device__ static void load(const bf16* p, float* f) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 x = __bfloat1622float2(v[u]);
      f[2 * u] = x.x, f[2 * u + 1] = x.y;
    }
  }
  __device__ static void store(bf16* p, const float* f) {
    uint4 r;
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __floats2bfloat162_rn(f[2 * u], f[2 * u + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

// Block (fb, c) of a (chunk, feature-block) grid flattened on x; thread i
// takes features f0 .. f0 + V - 1. False for a thread past the block or F.
template <int V>
__device__ __forceinline__ bool place(int f, int bf, int nfb, int& c, int& f0) {
  c = blockIdx.x / nfb;
  const int off = threadIdx.x * V;
  f0 = (blockIdx.x % nfb) * bf + off;
  return off < bf && f0 < f;
}

// (a) Per (chunk, feature): A = prod a_t, e = the chunk's scan from 0.
template <typename T, int V>
__global__ void rglru_summary(const T* __restrict__ a, const T* __restrict__ x,
                              float* __restrict__ acum, float* __restrict__ ecum,
                              int s, int f, int bt, int bf, int nfb, int nc) {
  int c, f0;
  if (!place<V>(f, bf, nfb, c, f0)) return;
  const int bb = blockIdx.y, t0 = c * bt, tn = min(bt, s - t0);
  const size_t base = ((size_t)bb * s + t0) * f + f0;
  float A[V], e[V];
#pragma unroll
  for (int v = 0; v < V; ++v) A[v] = 1.f, e[v] = 0.f;
#pragma unroll 4
  for (int t = 0; t < tn; ++t) {
    float av[V], xv[V];
    Vec<T, V>::load(a + base + (size_t)t * f, av);
    Vec<T, V>::load(x + base + (size_t)t * f, xv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      e[v] = __fadd_rn(__fmul_rn(av[v], e[v]), xv[v]);
      A[v] = __fmul_rn(A[v], av[v]);
    }
  }
  const size_t o = ((size_t)bb * nc + c) * f + f0;
#pragma unroll
  for (int v = 0; v < V; ++v) acum[o + v] = A[v], ecum[o + v] = e[v];
}

// (b) Per feature, the state entering each chunk: h_in_c, then h = A_c h +
// e_c.
template <typename T>
__global__ void __launch_bounds__(CARRY_THREADS)
rglru_carry(const T* __restrict__ h0, const float* __restrict__ acum,
            const float* __restrict__ ecum, float* __restrict__ hin, int f,
            int nc) {
  const int fi = blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (fi >= f) return;
  const int bb = blockIdx.y;
  float h = to_f32(h0[(size_t)bb * f + fi]);
  const size_t base = (size_t)bb * nc * f + fi;
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float A[AHEAD], e[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u < nc) {
        A[u] = acum[base + (size_t)(c0 + u) * f];
        e[u] = ecum[base + (size_t)(c0 + u) * f];
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (c0 + u < nc) {
        hin[base + (size_t)(c0 + u) * f] = h;
        h = A[u] * h + e[u];
      }
    }
  }
}

// (c) Per (chunk, feature): rescan from h_in (h0 for the first chunk).
template <typename T, int V>
__global__ void rglru_rescan(const T* __restrict__ a, const T* __restrict__ x,
                             const T* __restrict__ h0,
                             const float* __restrict__ hin, T* __restrict__ y,
                             T* __restrict__ h_out, int s, int f, int bt,
                             int bf, int nfb, int nc) {
  int c, f0;
  if (!place<V>(f, bf, nfb, c, f0)) return;
  const int bb = blockIdx.y, t0 = c * bt, tn = min(bt, s - t0);
  const size_t base = ((size_t)bb * s + t0) * f + f0;
  float h[V];
  if (c == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = to_f32(h0[(size_t)bb * f + f0 + v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = hin[((size_t)bb * nc + c) * f + f0 + v];
  }
#pragma unroll 4
  for (int t = 0; t < tn; ++t) {
    float av[V], xv[V];
    Vec<T, V>::load(a + base + (size_t)t * f, av);
    Vec<T, V>::load(x + base + (size_t)t * f, xv);
#pragma unroll
    for (int v = 0; v < V; ++v) h[v] = __fadd_rn(__fmul_rn(av[v], h[v]), xv[v]);
    Vec<T, V>::store(y + base + (size_t)t * f, h);
  }
  if (c == nc - 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      Vec<T, 1>::store(h_out + (size_t)bb * f + f0 + v, &h[v]);
    }
  }
}

// The backward (repro_rglru_bwd) is the same chunked scan run backward in
// time: the adjoint g_t = a_{t+1} g_{t+1} + dy_t from g_{S-1} = dy_{S-1} +
// dh_last. Step u = 0 .. S-1 of the reversed scan is time t = S - 1 - u,
// its input dy_t and its decay a_{t+1} (1 at u = 0): (a) and (c) read those
// rows in place of flipped copies, and (b) runs unchanged from dh_last.
// The rescan writes dx_t = g_t and da_t = g_t h_{t-1} (h_{-1} = h0, else
// the forward's y_{t-1}) and, at t = 0, dh0 = a_0 g_0: a, dy and y are read
// (a and dy twice, with more than one chunk), dx and da written.
template <typename T, int V>
__device__ __forceinline__ void rev_step(const T* a, const T* dy, size_t row0,
                                         int s, int u, int f, float* av,
                                         float* xv) {
  const int t = s - 1 - u;
  if (u == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) av[v] = 1.f;
  } else {
    Vec<T, V>::load(a + row0 + (size_t)(t + 1) * f, av);
  }
  Vec<T, V>::load(dy + row0 + (size_t)t * f, xv);
}

// (a) backward: per (chunk of u, feature), A = prod a' and e, the chunk's
// reversed scan from 0.
template <typename T, int V>
__global__ void rglru_bwd_summary(const T* __restrict__ a,
                                  const T* __restrict__ dy,
                                  float* __restrict__ acum,
                                  float* __restrict__ ecum, int s, int f,
                                  int bt, int bf, int nfb, int nc) {
  int c, f0;
  if (!place<V>(f, bf, nfb, c, f0)) return;
  const int bb = blockIdx.y, u0 = c * bt, un = min(bt, s - u0);
  const size_t row0 = (size_t)bb * s * f + f0;
  float A[V], e[V];
#pragma unroll
  for (int v = 0; v < V; ++v) A[v] = 1.f, e[v] = 0.f;
#pragma unroll 4
  for (int u = u0; u < u0 + un; ++u) {
    float av[V], xv[V];
    rev_step<T, V>(a, dy, row0, s, u, f, av, xv);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      e[v] = __fadd_rn(__fmul_rn(av[v], e[v]), xv[v]);
      A[v] = __fmul_rn(A[v], av[v]);
    }
  }
  const size_t o = ((size_t)bb * nc + c) * f + f0;
#pragma unroll
  for (int v = 0; v < V; ++v) acum[o + v] = A[v], ecum[o + v] = e[v];
}

// (c) backward: per (chunk of u, feature), the reversed rescan from the
// adjoint entering the chunk (dh_last for the first), with dx, da and dh0.
template <typename T, int V>
__global__ void rglru_bwd_rescan(const T* __restrict__ a,
                                 const T* __restrict__ dy,
                                 const T* __restrict__ y,
                                 const T* __restrict__ h0,
                                 const T* __restrict__ dh_last,
                                 const float* __restrict__ hin,
                                 T* __restrict__ dx, T* __restrict__ da,
                                 T* __restrict__ dh0, int s, int f, int bt,
                                 int bf, int nfb, int nc) {
  int c, f0;
  if (!place<V>(f, bf, nfb, c, f0)) return;
  const int bb = blockIdx.y, u0 = c * bt, un = min(bt, s - u0);
  const size_t row0 = (size_t)bb * s * f + f0;
  float g[V];
  if (c == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) g[v] = to_f32(dh_last[(size_t)bb * f + f0 + v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) g[v] = hin[((size_t)bb * nc + c) * f + f0 + v];
  }
#pragma unroll 2
  for (int u = u0; u < u0 + un; ++u) {
    float av[V], xv[V], hp[V], dav[V];
    rev_step<T, V>(a, dy, row0, s, u, f, av, xv);
    const int t = s - 1 - u;
    if (t > 0) {
      Vec<T, V>::load(y + row0 + (size_t)(t - 1) * f, hp);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) hp[v] = to_f32(h0[(size_t)bb * f + f0 + v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      g[v] = __fadd_rn(__fmul_rn(av[v], g[v]), xv[v]);
      dav[v] = g[v] * hp[v];
    }
    Vec<T, V>::store(dx + row0 + (size_t)t * f, g);
    Vec<T, V>::store(da + row0 + (size_t)t * f, dav);
  }
  if (c == nc - 1) {  // u = S - 1 is t = 0: dh0 = a_0 g_0
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float d = to_f32(a[row0 + v]) * g[v];
      Vec<T, 1>::store(dh0 + (size_t)bb * f + f0 + v, &d);
    }
  }
}

template <typename T, int V>
void launch_scans(const T* a, const T* x, const T* h0, T* y, T* h_out,
                  float* acum, float* ecum, float* hin, int b, int s, int f,
                  int bt, int bf, cudaStream_t stream) {
  const int nc = (s + bt - 1) / bt, nfb = (f + bf - 1) / bf;
  const int threads = (bf + V - 1) / V;
  const dim3 grid(nfb * nc, b);
  if (nc > 1) {
    rglru_summary<T, V><<<grid, threads, 0, stream>>>(a, x, acum, ecum, s, f,
                                                      bt, bf, nfb, nc);
    rglru_carry<T><<<dim3((f + CARRY_THREADS - 1) / CARRY_THREADS, b),
                     CARRY_THREADS, 0, stream>>>(h0, acum, ecum, hin, f, nc);
  }
  rglru_rescan<T, V><<<grid, threads, 0, stream>>>(a, x, h0, hin, y, h_out, s,
                                                   f, bt, bf, nfb, nc);
}

template <typename T>
int launch(const void* a, const void* x, const void* h0, void* y, void* h_out,
           float* ws, int b, int s, int f, int bt, int bf,
           cudaStream_t stream) {
  const long long nc = (s + bt - 1) / bt, nfb = (f + bf - 1) / bf;
  if (nc * nfb > 0x7fffffffLL || b > 65535) return (int)cudaErrorInvalidValue;
  if (nc > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  // ws: A, e and h_in, B * nc * F floats each.
  const size_t plane = (size_t)b * nc * f;
  float* acum = ws;
  float* ecum = ws ? ws + plane : nullptr;
  float* hin = ws ? ws + 2 * plane : nullptr;
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const T* at = static_cast<const T*>(a);
  const T* xt = static_cast<const T*>(x);
  const T* h0t = static_cast<const T*>(h0);
  T* yt = static_cast<T*>(y);
  T* ht = static_cast<T*>(h_out);
  if (aligned && f % VEC == 0 && bf % VEC == 0) {
    launch_scans<T, VEC>(at, xt, h0t, yt, ht, acum, ecum, hin, b, s, f, bt,
                         bf, stream);
  } else {
    launch_scans<T, 1>(at, xt, h0t, yt, ht, acum, ecum, hin, b, s, f, bt, bf,
                       stream);
  }
  return (int)cudaGetLastError();
}

template <typename T, int V>
void launch_bwd_scans(const T* a, const T* y, const T* h0, const T* dy,
                      const T* dh_last, T* dx, T* da, T* dh0, float* acum,
                      float* ecum, float* hin, int b, int s, int f, int bt,
                      int bf, cudaStream_t stream) {
  const int nc = (s + bt - 1) / bt, nfb = (f + bf - 1) / bf;
  const int threads = (bf + V - 1) / V;
  const dim3 grid(nfb * nc, b);
  if (nc > 1) {
    rglru_bwd_summary<T, V><<<grid, threads, 0, stream>>>(
        a, dy, acum, ecum, s, f, bt, bf, nfb, nc);
    rglru_carry<T><<<dim3((f + CARRY_THREADS - 1) / CARRY_THREADS, b),
                     CARRY_THREADS, 0, stream>>>(dh_last, acum, ecum, hin, f,
                                                 nc);
  }
  rglru_bwd_rescan<T, V><<<grid, threads, 0, stream>>>(
      a, dy, y, h0, dh_last, hin, dx, da, dh0, s, f, bt, bf, nfb, nc);
}

template <typename T>
int launch_bwd(const void* a, const void* y, const void* h0, const void* dy,
               const void* dh_last, void* dx, void* da, void* dh0, float* ws,
               int b, int s, int f, int bt, int bf, cudaStream_t stream) {
  const long long nc = (s + bt - 1) / bt, nfb = (f + bf - 1) / bf;
  if (nc * nfb > 0x7fffffffLL || b > 65535) return (int)cudaErrorInvalidValue;
  if (nc > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)b * nc * f;
  float* acum = ws;
  float* ecum = ws ? ws + plane : nullptr;
  float* hin = ws ? ws + 2 * plane : nullptr;
  constexpr int VEC = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
        reinterpret_cast<uintptr_t>(da)) & 15) == 0;
  const T* at = static_cast<const T*>(a);
  const T* yt = static_cast<const T*>(y);
  const T* h0t = static_cast<const T*>(h0);
  const T* dyt = static_cast<const T*>(dy);
  const T* dht = static_cast<const T*>(dh_last);
  T* dxt = static_cast<T*>(dx);
  T* dat = static_cast<T*>(da);
  T* d0t = static_cast<T*>(dh0);
  if (aligned && f % VEC == 0 && bf % VEC == 0) {
    launch_bwd_scans<T, VEC>(at, yt, h0t, dyt, dht, dxt, dat, d0t, acum, ecum,
                             hin, b, s, f, bt, bf, stream);
  } else {
    launch_bwd_scans<T, 1>(at, yt, h0t, dyt, dht, dxt, dat, d0t, acum, ecum,
                           hin, b, s, f, bt, bf, stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (bt, bf): the chunk length in time and
// the features a block takes (bf <= 1024). With more than one chunk, ws
// holds 3 * B * ceil(S / bt) * F floats (null otherwise). Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for an
// argument this file does not take.
extern "C" int repro_rglru(const void* a, const void* x, const void* h0,
                           void* y, void* h_out, void* ws, int b, int s, int f,
                           int bt, int bf, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || f <= 0 || bt <= 0 || bf <= 0 || bf > MAX_FEATURES) {
    return (int)cudaErrorInvalidValue;
  }
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0) return launch<float>(a, x, h0, y, h_out, wsf, b, s, f, bt, bf, st);
  if (dtype == 1) return launch<bf16>(a, x, h0, y, h_out, wsf, b, s, f, bt, bf, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of repro_rglru's scan: from its a, y (every h_t) and h0 and
// the output gradients dy [B, S, F] and dh_last [B, F], dx = g, da_t = g_t
// h_{t-1} and dh0 = a_0 g_0, with g the adjoint scanned backward in time
// (above). Tile and workspace as repro_rglru's.
extern "C" int repro_rglru_bwd(const void* a, const void* y, const void* h0,
                               const void* dy, const void* dh_last, void* dx,
                               void* da, void* dh0, void* ws, int b, int s,
                               int f, int bt, int bf, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0 || s <= 0 || f <= 0 || bt <= 0 || bf <= 0 || bf > MAX_FEATURES) {
    return (int)cudaErrorInvalidValue;
  }
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0) {
    return launch_bwd<float>(a, y, h0, dy, dh_last, dx, da, dh0, wsf, b, s, f,
                             bt, bf, st);
  }
  if (dtype == 1) {
    return launch_bwd<bf16>(a, y, h0, dy, dh_last, dx, da, dh0, wsf, b, s, f,
                            bt, bf, st);
  }
  return (int)cudaErrorInvalidValue;
}
