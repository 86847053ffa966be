// One-pass row statistics (K5) for Hopper (sm_90a): float32 sum and sum of
// squares over the last axis, from one read of x.
//
// Replaces the Pallas TPU kernel _stats_kernel (vit_search_tpu/ops/pallas/
// stats.py:39), called through row_sum_sumsq (stats.py:71-89):
//   s1[r] = sum_c x[r, c];  s2[r] = sum_c x[r, c]^2      (float32 accumulation)
//
// What bounds it on this card: bytes. Each element costs two flops, and the
// outputs are two floats per row, so the kernel is a stream over x.
// Design: one warp owns one row at a time and walks the rows grid-stride.
// Lanes read 16-byte vectors (8 bf16 or 4 f32), neighbouring lanes on
// neighbouring addresses; where the row length or its alignment does not
// allow whole vectors, every element is loaded on its own, and the ragged
// end of a row is masked either way. Each lane sums its elements in a fixed
// order and a butterfly of warp shuffles folds the lanes, so the summation
// order is fixed per row and repeated runs give identical bits. Lane 0
// writes the row's two floats. C may be any length: a lane loops over the row.
//
// The TPU kernel tiles (g, n, C) blocks into VMEM and so needs C % 128 == 0
// (stats.py:92-93); nothing here does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps (rows in flight) per block
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of x -> VEC floats (VEC = 4 for f32, 8 for bf16)
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// VECTOR: rows are whole 16-byte vectors on 16-byte boundaries
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
row_stats_kernel(const T* __restrict__ x, float* __restrict__ s1, float* __restrict__ s2,
                 long long rows, int c) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < rows;
       row += warps) {
    const T* xr = x + row * c;
    float a = 0.f, aa = 0.f;
    if constexpr (VECTOR) {
      for (int i = lane * VEC; i < c; i += 32 * VEC) {
        float v[VEC];
        load_vec(xr + i, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          a += v[e];
          aa += v[e] * v[e];
        }
      }
    } else {
      for (int i = lane; i < c; i += 32) {
        const float v = to_float(xr[i]);
        a += v;
        aa += v * v;
      }
    }
    a = warp_sum(a);
    aa = warp_sum(aa);
    if (lane == 0) {
      s1[row] = a;
      s2[row] = aa;
    }
  }
}

template <typename T>
int launch(const void* x, void* s1, void* s2, long long rows, int c, int blocks,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vector = c % VEC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  float* a = static_cast<float*>(s1);
  float* aa = static_cast<float*>(s2);
  if (vector)
    row_stats_kernel<T, true><<<blocks, kThreads, 0, stream>>>(xp, a, aa, rows, c);
  else
    row_stats_kernel<T, false><<<blocks, kThreads, 0, stream>>>(xp, a, aa, rows, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (rows, c) contiguous, dtype 0 = float32, 1 = bfloat16; s1, s2: float32
// (rows,). blocks: grid size (the rows are walked grid-stride). Returns
// cudaGetLastError() after the launch.
int vst_row_stats(const void* x, void* s1, void* s2, long long rows, int c, int blocks,
                  int dtype, void* stream) {
  if (rows < 1 || c < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(x, s1, s2, rows, c, blocks, s);
  if (dtype == 0) return launch<float>(x, s1, s2, rows, c, blocks, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
