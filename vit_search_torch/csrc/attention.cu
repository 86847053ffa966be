// Fused multi-head attention over the packed qkv projection, forward (K1) and
// backward (K2), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of vit_search_tpu/ops/pallas/attention.py:
//   K1  _fwd_kernel_qkv (attention.py:88), called through _fwd_call_qkv (:217-229)
//   K2  _bwd_kernel_qkv (attention.py:108), called through _bwd_call_qkv (:232-244)
//
// Layout: qkv is (B, N, 3W) with column blocks [q | k | v], each ordered by
// head (W = H * D); the output is (B, N, W); the backward's cotangent is the
// packed (B, N, 3W) dqkv, so the qkv projection's backward takes it as is.
//
// Math, per (example, head), as the TPU kernels do it:
//   forward   s = q k^T * scale (f32); p = softmax_rows(s) (f32);
//             o = cast(p, dtype(v)) v, summed in f32, stored in dtype(qkv)
//   backward  p recomputed in f32 from qkv (the only residual), all in f32:
//             dv = p^T do;  dp = do v^T;  delta = rowsum(dp * p)
//             ds = p * (dp - delta);  dq = ds k * scale;  dk = ds^T q * scale
//
// What bounds it on this card: at the main path's shapes (N = 257/65/17,
// D = 32/48/64) the function is bound by bytes at the tensor cores' rate
// (about 4*N*D flops per (example, head) and row against 6*D bytes), but this
// first version computes on the CUDA cores in f32, which makes the dot
// products its limit. wgmma, TMA and tuning come later.
//
// Design. The TPU keeps whole (N, N) f32 score tiles in VMEM; one such tile
// at N = 257 is 264 KB, more than the 227 KB of shared memory a block can
// have, so no kernel here holds one. A block owns one (example, head); it
// stages the head's K and V (or Q and dO) in shared memory as f32, rows
// padded to D + 1 floats so that lanes walking rows hit distinct banks.
// A warp owns one row at a time and keeps only that row of scores (N floats)
// in shared memory:
//   K1   warp per query row: scores over all keys, exact two-pass softmax,
//        p rounded to v's dtype, then o with lanes over the head's columns.
//   K2   the sum over queries that forms dk and dv cannot be carried from
//        block to block as the TPU's sequential grid does, so the backward
//        is split (the layout of tools/attn_lab.py:123-185):
//        (a) warp per query row: recompute p, dp, delta = rowsum(dp * p) from
//            the f32 p, write dq and the row's (max, sum, delta);
//        (b) warp per key row: recompute p from the saved (max, sum), ds from
//            delta, and sum dk, dv over all queries.
//        Both recompute s with the same f32 operation order, so they agree
//        on p bit for bit.
// N is any length (every loop masks its ragged end); D is a template
// constant (8, 16, 32, 48, 64, 128) so the per-row vectors live in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may opt into

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v after a round trip through T: the cast of p to v's dtype before p.v
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage columns [col, col + D) of every row of one example into f32 shared
// memory with row stride `stride`.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ rows, long long row_stride,
                                      int col, int n, float* __restrict__ dst, int stride) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int j = idx / D, c = idx - j * D;
    dst[j * stride + c] = to_f(rows[j * row_stride + col + c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                float scale) {
  constexpr int KS = D + 1;
  constexpr int CD = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Ks = smem;             // n x KS
  float* Vs = Ks + n * KS;      // n x D
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int W = heads * D;
  const long long W3 = 3LL * W;
  const T* base = qkv + (long long)b * n * W3;
  stage<T, D>(base, W3, W + h * D, n, Ks, KS);
  stage<T, D>(base, W3, 2 * W + h * D, n, Vs, D);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = Vs + n * D + warp * n;  // this warp's row of scores / probabilities
  for (int i = warp; i < n; i += kWarps) {
    const T* qr = base + i * W3 + h * D;
    float q[D];
#pragma unroll
    for (int c = 0; c < D; ++c) q[c] = to_f(qr[c]);
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = Ks + j * KS;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) s = fmaf(q[c], kr[c], s);
      s *= scale;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) p[j] = round_to<T>(p[j] / sum);
    __syncwarp();

    float acc[CD];
#pragma unroll
    for (int t = 0; t < CD; ++t) acc[t] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float pj = p[j];
#pragma unroll
      for (int t = 0; t < CD; ++t) {
        const int c = lane + 32 * t;
        if (c < D) acc[t] = fmaf(pj, Vs[j * D + c], acc[t]);
      }
    }
    T* orow = out + ((long long)b * n + i) * W + h * D;
#pragma unroll
    for (int t = 0; t < CD; ++t) {
      const int c = lane + 32 * t;
      if (c < D) orow[c] = from_f<T>(acc[t]);
    }
    __syncwarp();
  }
}

// K2 (a): dq and the per-row (max, sum, delta), warp per query row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                   T* __restrict__ dqkv, float4* __restrict__ rowstats, int n, int heads,
                   float scale) {
  constexpr int KS = D + 1;
  constexpr int CD = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Ks = smem;             // n x KS
  float* Vs = Ks + n * KS;      // n x KS
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int W = heads * D;
  const long long W3 = 3LL * W;
  const T* base = qkv + (long long)b * n * W3;
  stage<T, D>(base, W3, W + h * D, n, Ks, KS);
  stage<T, D>(base, W3, 2 * W + h * D, n, Vs, KS);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = Vs + n * KS + warp * 2 * n;
  float* dp = p + n;
  for (int i = warp; i < n; i += kWarps) {
    const T* qr = base + i * W3 + h * D;
    const T* gr = dout + ((long long)b * n + i) * W + h * D;
    float q[D], g[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      q[c] = to_f(qr[c]);
      g[c] = to_f(gr[c]);
    }
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = Ks + j * KS;
      const float* vr = Vs + j * KS;
      float s = 0.f, d = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(q[c], kr[c], s);
        d = fmaf(g[c], vr[c], d);
      }
      s *= scale;
      p[j] = s;
      dp[j] = d;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float pj = p[j] / sum;
      p[j] = pj;
      delta += pj * dp[j];
    }
    delta = warp_sum(delta);
    for (int j = lane; j < n; j += 32) p[j] = p[j] * (dp[j] - delta);  // ds
    __syncwarp();

    float acc[CD];
#pragma unroll
    for (int t = 0; t < CD; ++t) acc[t] = 0.f;
    for (int j = 0; j < n; ++j) {
      const float ds = p[j];
#pragma unroll
      for (int t = 0; t < CD; ++t) {
        const int c = lane + 32 * t;
        if (c < D) acc[t] = fmaf(ds, Ks[j * KS + c], acc[t]);
      }
    }
    T* drow = dqkv + ((long long)b * n + i) * W3 + h * D;
#pragma unroll
    for (int t = 0; t < CD; ++t) {
      const int c = lane + 32 * t;
      if (c < D) drow[c] = from_f<T>(acc[t] * scale);
    }
    if (lane == 0)
      rowstats[(long long)blockIdx.x * n + i] = make_float4(mx, sum, delta, 0.f);
    __syncwarp();
  }
}

// K2 (b): dk and dv, warp per key row, summing over every query.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                    const float4* __restrict__ rowstats, T* __restrict__ dqkv, int n,
                    int heads, float scale) {
  constexpr int KS = D + 1;
  constexpr int CD = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;             // n x KS
  float* Gs = Qs + n * KS;      // n x KS
  float* Mx = Gs + n * KS;      // n
  float* Sum = Mx + n;          // n
  float* Delta = Sum + n;       // n
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int W = heads * D;
  const long long W3 = 3LL * W;
  const T* base = qkv + (long long)b * n * W3;
  stage<T, D>(base, W3, h * D, n, Qs, KS);
  stage<T, D>(dout + (long long)b * n * W, W, h * D, n, Gs, KS);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float4 st = rowstats[(long long)blockIdx.x * n + i];
    Mx[i] = st.x;
    Sum[i] = st.y;
    Delta[i] = st.z;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = Delta + n + warp * 2 * n;
  float* ds = p + n;
  for (int j = warp; j < n; j += kWarps) {
    const T* kr = base + j * W3 + W + h * D;
    float k[D], v[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      k[c] = to_f(kr[c]);
      v[c] = to_f(kr[W + c]);
    }
    for (int i = lane; i < n; i += 32) {
      const float* qr = Qs + i * KS;
      const float* gr = Gs + i * KS;
      float s = 0.f, d = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(qr[c], k[c], s);
        d = fmaf(gr[c], v[c], d);
      }
      s *= scale;
      const float pij = expf(s - Mx[i]) / Sum[i];
      p[i] = pij;
      ds[i] = pij * (d - Delta[i]);
    }
    __syncwarp();

    float acck[CD], accv[CD];
#pragma unroll
    for (int t = 0; t < CD; ++t) acck[t] = accv[t] = 0.f;
    for (int i = 0; i < n; ++i) {
      const float pi = p[i], dsi = ds[i];
#pragma unroll
      for (int t = 0; t < CD; ++t) {
        const int c = lane + 32 * t;
        if (c < D) {
          accv[t] = fmaf(pi, Gs[i * KS + c], accv[t]);
          acck[t] = fmaf(dsi, Qs[i * KS + c], acck[t]);
        }
      }
    }
    T* drow = dqkv + ((long long)b * n + j) * W3 + h * D;
#pragma unroll
    for (int t = 0; t < CD; ++t) {
      const int c = lane + 32 * t;
      if (c < D) {
        drow[W + c] = from_f<T>(acck[t] * scale);
        drow[2 * W + c] = from_f<T>(accv[t]);
      }
    }
    __syncwarp();
  }
}

size_t fwd_smem(int n, int d) { return sizeof(float) * ((size_t)n * (2 * d + 1) + kWarps * n); }
size_t dq_smem(int n, int d) { return sizeof(float) * ((size_t)n * 2 * (d + 1) + 2 * kWarps * n); }
size_t dkv_smem(int n, int d) {
  return sizeof(float) * ((size_t)n * 2 * (d + 1) + 3 * n + 2 * kWarps * n);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T, int D>
int fwd_launch(const void* qkv, void* out, int batch, int n, int heads, float scale,
               cudaStream_t stream) {
  const size_t smem = fwd_smem(n, D);
  int rc = prepare(attn_fwd_kernel<T, D>, smem);
  if (rc) return rc;
  attn_fwd_kernel<T, D><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), n, heads, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int bwd_launch(const void* qkv, const void* dout, void* dqkv, void* rowstats, int batch,
               int n, int heads, float scale, cudaStream_t stream) {
  size_t smem = dq_smem(n, D);
  int rc = prepare(attn_bwd_dq_kernel<T, D>, smem);
  if (rc) return rc;
  attn_bwd_dq_kernel<T, D><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<float4*>(rowstats), n, heads, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  smem = dkv_smem(n, D);
  rc = prepare(attn_bwd_dkv_kernel<T, D>, smem);
  if (rc) return rc;
  attn_bwd_dkv_kernel<T, D><<<batch * heads, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const float4*>(rowstats), static_cast<T*>(dqkv), n, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

#define VST_SWITCH_D(d, CALL)                        \
  switch (d) {                                       \
    case 8: CALL(8);                                 \
    case 16: CALL(16);                               \
    case 32: CALL(32);                               \
    case 48: CALL(48);                               \
    case 64: CALL(64);                               \
    case 128: CALL(128);                             \
    default: return (int)cudaErrorInvalidValue;      \
  }

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. qkv (batch, n, 3 * heads * d), out
// (batch, n, heads * d). Returns cudaGetLastError() (or cudaErrorInvalidValue
// for a head size or length the kernel does not take).
int vst_attn_fwd(const void* qkv, void* out, int batch, int n, int heads, int d,
                 float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VST_FWD_BF16(D) return fwd_launch<__nv_bfloat16, D>(qkv, out, batch, n, heads, scale, s)
#define VST_FWD_F32(D) return fwd_launch<float, D>(qkv, out, batch, n, heads, scale, s)
  if (dtype == 1) { VST_SWITCH_D(d, VST_FWD_BF16) }
  if (dtype == 0) { VST_SWITCH_D(d, VST_FWD_F32) }
  return (int)cudaErrorInvalidValue;
#undef VST_FWD_BF16
#undef VST_FWD_F32
}

// dout (batch, n, heads * d) -> dqkv (batch, n, 3 * heads * d); rowstats is
// float32 scratch of (batch * heads * n, 4).
int vst_attn_bwd(const void* qkv, const void* dout, void* dqkv, void* rowstats, int batch,
                 int n, int heads, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VST_BWD_BF16(D) \
  return bwd_launch<__nv_bfloat16, D>(qkv, dout, dqkv, rowstats, batch, n, heads, scale, s)
#define VST_BWD_F32(D) \
  return bwd_launch<float, D>(qkv, dout, dqkv, rowstats, batch, n, heads, scale, s)
  if (dtype == 1) { VST_SWITCH_D(d, VST_BWD_BF16) }
  if (dtype == 0) { VST_SWITCH_D(d, VST_BWD_F32) }
  return (int)cudaErrorInvalidValue;
#undef VST_BWD_BF16
#undef VST_BWD_F32
}

// Largest dynamic shared memory each kernel needs at (n, d), so the caller
// can refuse a shape before launching.
long long vst_attn_smem_bytes(int n, int d) {
  size_t a = fwd_smem(n, d), b = dq_smem(n, d), c = dkv_smem(n, d);
  size_t m = a > b ? a : b;
  return (long long)(m > c ? m : c);
}

}  // extern "C"
