// Bilinear image upscale by an integer scale for Hopper (sm_90a): src [H, W]
// -> out [H*scale, W*scale], float32 or bfloat16 in and out, float32 math.
//
// Replaces: src/repro/kernels/bilinear/bilinear.py, function
// `bilinear_upscale` (`_bilinear_kernel`, `_tent_weights`), the Pallas TPU
// kernel that computes the upscale as `Wy @ src @ Wx^T` on the MXU with
// banded tent-weight matrices built from iota, because a TPU has no
// efficient per-element gather.
//
// What bounds it on the H100: it reads the source once and writes scale^2
// times as many output pixels, at a few FLOP each, so device-memory bytes
// bound it: the output's, above all (256 MB at scale 10 from an 800x800
// float32 image, five times the 50 MB L2).
//
// Design. The tile (bh, bw) stays the thread block, the variable of the
// paper's Fig. 3, so one build serves every tile of a sweep. A thread writes
// V = 16 / sizeof(T) neighbouring pixels of a row (4 float32, 8 bf16) as one
// 16-byte streaming store, on ROWS = 4 consecutive rows (of 1, 2, 4 and 8
// timed on the H100, PERF.md): a block covers (ROWS * bh) x (V * bw) output
// pixels, and the ragged last blocks are masked. What each part does
// about the cost of the paper's one-thread-per-pixel form:
//
// * The divisions are hoisted. A block first writes the source position of
//   each of its V * bw columns and R * bh rows to shared memory, with the
//   paper's clamped map min(o / scale, len - 1) as an IEEE division (no
//   reciprocal: it misses the quotient by an ulp); a thread takes x1 =
//   floor, the weight = the fraction, x2 = min(x1 + 1, W - 1) (replicate
//   edge), as the one-pixel kernel did.
// * The horizontal pass is separable and held in registers. For its R rows
//   a thread keeps the V-pixel lerps of source rows y1 ("top") and y2
//   ("bot") and recomputes them only when y1 changes: a new row is then
//   one blend (1 - dy) * top + dy * bot per pixel. When y1 moves on by one
//   the old bot becomes the new top. At scale >= V a run's V pixels fall
//   between at most three source columns, so a source row costs three
//   loads, each pixel selecting its pair; below it, two loads a pixel.
//   top and bot are the same sums the one-pixel kernel formed, so every
//   pixel is what it computed, apart from FMA contraction.
// * Stores are 16 bytes a thread and evict first (st.global.cs: the output
//   passes the L2 once, the source stays in it). A row whose byte width is
//   no multiple of 16 has unaligned vectors, so such an image takes the
//   scalar-store instantiation, masked per pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int ROWS = 4;  // a thread's rows (the wrapper reads this line)
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_SIDE = 1 << 24;  // positions are exact float integers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of V pixels, streamed (evict first).
__device__ __forceinline__ void store16(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  __stcs(reinterpret_cast<uint4*>(p), u);
}

// The clamped source position of output index o (the reference's map).
__device__ __forceinline__ float position(int o, float fs, int len) {
  return fminf((float)o / fs, (float)(len - 1));
}

// The V-pixel horizontal lerps of one source row: pixel j blends row[x1_j]
// and row[min(x1_j + 1, W - 1)] with weight dx_j. With `three`, x1_j is x1_0
// or x1_0 + 1 for every j (scale >= V), and the row is read at three columns.
template <typename T, int V>
__device__ __forceinline__ void hlerp(const T* __restrict__ row, int w,
                                      const int* x1, const float* dx,
                                      bool three, float* out) {
  if (three) {
    const float a = to_f32(row[x1[0]]);
    const float b = to_f32(row[min(x1[0] + 1, w - 1)]);
    const float c = to_f32(row[min(x1[0] + 2, w - 1)]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool next = x1[j] != x1[0];
      out[j] = (1.f - dx[j]) * (next ? b : a) + dx[j] * (next ? c : b);
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      out[j] = (1.f - dx[j]) * to_f32(row[x1[j]]) +
               dx[j] * to_f32(row[min(x1[j] + 1, w - 1)]);
  }
}

// A row of 16-byte multiples keeps every vector aligned (the wrapper
// allocates the output, 256-byte aligned); another row takes scalar stores.
__host__ __device__ constexpr bool vector_stores(long long ow, int bytes) {
  return ow * bytes % 16 == 0;
}

// Block (bw, bh) threads; thread (tx, ty) writes columns V tx .. V tx + V - 1
// and rows R ty .. R ty + R - 1 of the block's (R bh) x (V bw) footprint,
// R = ROWS. Dynamic shared memory: 4 (V bw + R bh) bytes of source positions.
template <typename T, bool VEC>
__global__ void __launch_bounds__(MAX_THREADS)
bilinear_kernel(const T* __restrict__ src, T* __restrict__ out, int h, int w,
                int scale) {
  constexpr int V = 16 / sizeof(T), R = ROWS;
  extern __shared__ float pos[];
  const int bw = blockDim.x, bh = blockDim.y;
  const int cols = V * bw, rows = R * bh;
  float* xpos = pos;          // [cols]
  float* ypos = pos + cols;   // [rows]
  const int oh = h * scale, ow = w * scale;
  const int c_base = blockIdx.x * cols, r_base = blockIdx.y * rows;
  const int tid = threadIdx.y * bw + threadIdx.x, nt = bw * bh;
  const float fs = (float)scale;
  for (int i = tid; i < cols; i += nt) xpos[i] = position(c_base + i, fs, w);
  for (int i = tid; i < rows; i += nt) ypos[i] = position(r_base + i, fs, h);
  __syncthreads();

  const int c0 = c_base + V * threadIdx.x;
  if (c0 >= ow) return;
  int x1[V];
  float dx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float xp = xpos[V * threadIdx.x + j];
    x1[j] = (int)floorf(xp);
    dx[j] = xp - (float)x1[j];
  }
  const bool three = scale >= V;
  float top[V], bot[V];
  int cy = -2;  // the source row `top` holds
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int lr = R * threadIdx.y + i, oy = r_base + lr;
    if (oy >= oh) break;
    const float yp = ypos[lr];
    const int y1 = (int)floorf(yp);
    const float dy = yp - (float)y1;
    if (y1 != cy) {
      const int y2 = min(y1 + 1, h - 1);
      if (y1 == cy + 1) {
#pragma unroll
        for (int j = 0; j < V; ++j) top[j] = bot[j];
      } else {
        hlerp<T, V>(src + (size_t)y1 * w, w, x1, dx, three, top);
      }
      hlerp<T, V>(src + (size_t)y2 * w, w, x1, dx, three, bot);
      cy = y1;
    }
    T* dst = out + (size_t)oy * ow + c0;
    if (VEC) {
      float px[V];
#pragma unroll
      for (int j = 0; j < V; ++j) px[j] = (1.f - dy) * top[j] + dy * bot[j];
      store16(dst, px);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c0 + j < ow) store(dst + j, (1.f - dy) * top[j] + dy * bot[j]);
    }
  }
}

template <typename T>
int launch(const void* src, void* out, int h, int w, int scale, int bh,
           int bw, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T), R = ROWS;
  const int oh = h * scale, ow = w * scale;
  dim3 block(bw, bh);
  dim3 grid((ow + V * bw - 1) / (V * bw), (oh + R * bh - 1) / (R * bh));
  if (grid.y > (unsigned)MAX_GRID_Y) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)V * bw + (size_t)R * bh);
  if (vector_stores(ow, sizeof(T))) {
    bilinear_kernel<T, true><<<grid, block, smem, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(out), h, w, scale);
  } else {
    bilinear_kernel<T, false><<<grid, block, smem, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(out), h, w, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (bh, bw) is the thread block, at most
// 1024 threads. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an argument this file does not take.
extern "C" int repro_bilinear(const void* src, void* out, int h, int w,
                              int scale, int dtype, int bh, int bw,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h <= 0 || w <= 0 || scale <= 0 || bh <= 0 || bw <= 0 ||
      bh * bw > MAX_THREADS || (long long)h * scale > MAX_SIDE ||
      (long long)w * scale > MAX_SIDE) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) return launch<float>(src, out, h, w, scale, bh, bw, s);
  if (dtype == 1) return launch<__nv_bfloat16>(src, out, h, w, scale, bh, bw, s);
  return (int)cudaErrorInvalidValue;
}

// 1 where a [*, w] image upscaled by `scale` takes the 16-byte vector
// stores, 0 where it takes scalar stores (dtype as above).
extern "C" int repro_bilinear_vector_stores(int w, int scale, int dtype) {
  return vector_stores((long long)w * scale, dtype == 0 ? 4 : 2) ? 1 : 0;
}
