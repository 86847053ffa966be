// Masked layer norm, forward (K3) and backward (K4), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vit_search_tpu/ops/pallas/masked_ln.py:
//   K3  _fwd_kernel (masked_ln.py:40), called through _forward (:106-131)
//   K4  _bwd_kernel (masked_ln.py:58), called through _backward (:134-161)
//
// Math (per row of C channels, mask row m of the row's example, f32):
//   inv_p = 1 / mean(m);  mu = mean(x) * inv_p;  var = mean(x^2) * inv_p - mu^2
//   inv_std = rsqrt(var + eps);  z = (x - mu) * inv_std
//   y = (w * z + b) * m                                 saved: (mu, inv_std)
//   gf = g * m;  dz = gf * w
//   gx = (dz - (mean(dz) + z * mean(z * dz)) * inv_p) * inv_std
//   gw = sum_rows gf * z;  gb = sum_rows gf
//
// What bounds it on this card: bytes. Each element is touched by a handful of
// flops, so both kernels are memory-bound (about 0.5 flop per byte moved).
// Design: one warp owns one row of C channels (C <= 2048, C % 4 == 0); each
// lane loads 4-element vectors, keeps them in registers, and the row's three
// sums come from warp shuffles, so x is read once and y written once; nothing
// but the two per-row statistics goes back to memory. The mask row of an
// example is read by each of its rows, from L2 (it is B*C elements in all),
// and carries its own sum, so no separate pass computes mean(mask).
//
// The TPU accumulates gw/gb across its sequential grid (masked_ln.py:76-82).
// Blocks on the GPU run in no order, so each block keeps per-lane sums for the
// rows it walks (grid-stride), folds its warps together in a fixed order in
// shared memory and writes one (2, C) partial; a second kernel sums the
// partials in block order. The result is deterministic, which atomics are not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // rows per block (one warp per row)
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<uint32_t*>(&a);
  t.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = t;
}

// CPL: 4-element chunks per lane; lane l owns chunks l, l + 32, ...
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
masked_ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                     long long mask_bstride, const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y,
                     float2* __restrict__ stats, int rows, int n, int c, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nchunks = c >> 2;
  const T* xr = x + (long long)row * c;
  const T* mr = mask + (long long)(row / n) * mask_bstride;

  float xv[CPL][4], mv[CPL][4];
  float sx = 0.f, sxx = 0.f, sm = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int ch = lane + 32 * k;
    if (ch < nchunks) {
      load4(xr + 4 * ch, xv[k]);
      load4(mr + 4 * ch, mv[k]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sx += xv[k][e];
        sxx += xv[k][e] * xv[k][e];
        sm += mv[k][e];
      }
    }
  }
  sx = warp_sum(sx);
  sxx = warp_sum(sxx);
  sm = warp_sum(sm);
  const float inv_p = 1.f / (sm / c);
  const float mu = (sx / c) * inv_p;
  const float var = (sxx / c) * inv_p - mu * mu;
  const float inv_std = rsqrtf(var + eps);

  T* yr = y + (long long)row * c;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int ch = lane + 32 * k;
    if (ch < nchunks) {
      float wv[4], bv[4], out[4];
      load4(w + 4 * ch, wv);
      load4(b + 4 * ch, bv);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[e] = (wv[e] * ((xv[k][e] - mu) * inv_std) + bv[e]) * mv[k][e];
      store4(yr + 4 * ch, out);
    }
  }
  if (lane == 0) stats[row] = make_float2(mu, inv_std);
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
masked_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                     long long mask_bstride, const float* __restrict__ w,
                     const float2* __restrict__ stats, const T* __restrict__ g,
                     T* __restrict__ gx, float* __restrict__ partial,
                     int rows, int n, int c) {
  extern __shared__ float red[];  // (2, c): this block's gw then gb
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunks = c >> 2;

  float accw[CPL][4], accb[CPL][4];
#pragma unroll
  for (int k = 0; k < CPL; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) accw[k][e] = accb[k][e] = 0.f;

  for (int row = blockIdx.x * kWarps + warp; row < rows; row += gridDim.x * kWarps) {
    const long long off = (long long)row * c;
    const T* mr = mask + (long long)(row / n) * mask_bstride;
    const float2 st = stats[row];
    const float mu = st.x, inv_std = st.y;
    float zv[CPL][4], dzv[CPL][4];
    float s_dz = 0.f, s_zdz = 0.f, sm = 0.f;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int ch = lane + 32 * k;
      if (ch < nchunks) {
        float xv[4], mv[4], gv[4], wv[4];
        load4(x + off + 4 * ch, xv);
        load4(mr + 4 * ch, mv);
        load4(g + off + 4 * ch, gv);
        load4(w + 4 * ch, wv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float z = (xv[e] - mu) * inv_std;
          const float gf = gv[e] * mv[e];
          const float dz = gf * wv[e];
          zv[k][e] = z;
          dzv[k][e] = dz;
          s_dz += dz;
          s_zdz += z * dz;
          sm += mv[e];
          accw[k][e] += gf * z;
          accb[k][e] += gf;
        }
      }
    }
    s_dz = warp_sum(s_dz);
    s_zdz = warp_sum(s_zdz);
    sm = warp_sum(sm);
    const float inv_p = 1.f / (sm / c);
    const float mean_dz = s_dz / c;
    const float mean_zdz = s_zdz / c;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int ch = lane + 32 * k;
      if (ch < nchunks) {
        float out[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[e] = (dzv[k][e] - (mean_dz + zv[k][e] * mean_zdz) * inv_p) * inv_std;
        store4(gx + off + 4 * ch, out);
      }
    }
  }

  // fold the warps' column sums in warp order (deterministic)
  for (int i = threadIdx.x; i < 2 * c; i += kThreads) red[i] = 0.f;
  __syncthreads();
  for (int wi = 0; wi < kWarps; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int ch = lane + 32 * k;
        if (ch < nchunks) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            red[4 * ch + e] += accw[k][e];
            red[c + 4 * ch + e] += accb[k][e];
          }
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + (long long)blockIdx.x * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += kThreads) out[i] = red[i];
}

// Sum the per-block partials in block order: column i < c is gw, else gb.
__global__ void masked_ln_bwd_reduce_kernel(const float* __restrict__ partial, int nparts,
                                            int c, float* __restrict__ gw,
                                            float* __restrict__ gb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * c) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[(long long)p * 2 * c + i];
  if (i < c) gw[i] = s; else gb[i - c] = s;
}

template <typename T, int CPL>
int fwd_launch(const void* x, const void* mask, long long mask_bstride, const void* w,
               const void* b, void* y, void* stats, int rows, int n, int c, float eps,
               cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  masked_ln_fwd_kernel<T, CPL><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), mask_bstride,
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float2*>(stats), rows, n, c, eps);
  return (int)cudaGetLastError();
}

template <typename T, int CPL>
int bwd_launch(const void* x, const void* mask, long long mask_bstride, const void* w,
               const void* stats, const void* g, void* gx, void* partial, int nparts,
               void* gw, void* gb, int rows, int n, int c, cudaStream_t stream) {
  masked_ln_bwd_kernel<T, CPL><<<nparts, kThreads, 2 * c * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), mask_bstride,
      static_cast<const float*>(w), static_cast<const float2*>(stats),
      static_cast<const T*>(g), static_cast<T*>(gx), static_cast<float*>(partial),
      rows, n, c);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  masked_ln_bwd_reduce_kernel<<<(2 * c + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), nparts, c, static_cast<float*>(gw),
      static_cast<float*>(gb));
  return (int)cudaGetLastError();
}

// chunks per lane rounded up to the next instantiated size; 0 if too wide
int pick_cpl(int c) {
  const int need = ((c >> 2) + 31) / 32;
  for (int cpl = 1; cpl <= 16; cpl *= 2)
    if (need <= cpl) return cpl;
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, mask, y share it; w, b are float32).
// rows = B * n; mask_bstride = elements between examples' mask rows (0 to
// broadcast one mask row over the batch). Returns cudaGetLastError().
int vst_masked_ln_fwd(const void* x, const void* mask, long long mask_bstride,
                      const void* w, const void* b, void* y, void* stats, int rows, int n,
                      int c, float eps, int dtype, void* stream) {
  if (c % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VST_FWD(T, CPL) \
  return fwd_launch<T, CPL>(x, mask, mask_bstride, w, b, y, stats, rows, n, c, eps, s)
#define VST_FWD_CPL(T)                          \
  switch (pick_cpl(c)) {                        \
    case 1: VST_FWD(T, 1);                      \
    case 2: VST_FWD(T, 2);                      \
    case 4: VST_FWD(T, 4);                      \
    case 8: VST_FWD(T, 8);                      \
    case 16: VST_FWD(T, 16);                    \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 1) { VST_FWD_CPL(__nv_bfloat16) }
  if (dtype == 0) { VST_FWD_CPL(float) }
  return (int)cudaErrorInvalidValue;
#undef VST_FWD_CPL
#undef VST_FWD
}

// partial: float32 scratch of (nparts, 2, c); gw, gb: float32 (c,).
int vst_masked_ln_bwd(const void* x, const void* mask, long long mask_bstride,
                      const void* w, const void* stats, const void* g, void* gx,
                      void* partial, int nparts, void* gw, void* gb, int rows, int n, int c,
                      int dtype, void* stream) {
  if (c % 4 != 0 || nparts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VST_BWD(T, CPL)                                                                 \
  return bwd_launch<T, CPL>(x, mask, mask_bstride, w, stats, g, gx, partial, nparts, gw, \
                            gb, rows, n, c, s)
#define VST_BWD_CPL(T)                          \
  switch (pick_cpl(c)) {                        \
    case 1: VST_BWD(T, 1);                      \
    case 2: VST_BWD(T, 2);                      \
    case 4: VST_BWD(T, 4);                      \
    case 8: VST_BWD(T, 8);                      \
    case 16: VST_BWD(T, 16);                    \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 1) { VST_BWD_CPL(__nv_bfloat16) }
  if (dtype == 0) { VST_BWD_CPL(float) }
  return (int)cudaErrorInvalidValue;
#undef VST_BWD_CPL
#undef VST_BWD
}

}  // extern "C"
