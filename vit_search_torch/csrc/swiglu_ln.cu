// SwiGLU with its sub-LN (EVA-02's MLP between the packed W1 | W2 GEMM and
// W3): G1 (forward) and G2 (backward, then a fold of its partials).
//
//   u = [a | b]  (rows of 2P, bf16: a = x W1 + b1, b = x W2 + b2 in the
//                 first H of each half's P columns, P >= H the pitch)
//   h = silu(a) * b                     (float32)
//   y = (h - mean) * rstd * w + beta    (bf16, rows of P; mean and the biased
//                                        variance over the row's H values,
//                                        rstd = 1 / sqrt(var + eps))
//
// Columns H..P-1 of y and of the cotangent du are written as zeros: a model
// pads H to a pitch whose rows the GEMMs before and after read at 16 bytes
// (EVA-02-L's 2730 to 2736), and the padded weights' zero rows and columns
// then see zeros, never stale memory.
//
// G1: one row a block. Each thread holds up to 8 pairs of h (or single values
// where H is odd) in registers; the mean is a block sum, the variance
// a second block sum of (h - mean)^2 over the held values (K3d's two-pass
// form). Only the row's (mean, rstd) are saved.
//
// G2: blocks stride over the rows. For a row it recomputes h and xhat =
// (h - mean) rstd, takes gx = gy w and the block sums of gx and gx xhat (one
// reduction of both), then reads the row again (from L1/L2: a few registers
// a value instead of holding the row, so more blocks share an SM) for
//   dh = rstd (gx - mean(gx) - xhat mean(gx xhat))
//   da = dh b sig(a) (1 + a (1 - sig(a))),  db = dh silu(a)
// written as the packed (M, 2P) cotangent. Each thread keeps its columns'
// partial sums of gy xhat (dw) and gy (dbeta) over its block's rows in
// registers; they go to a (blocks, 2, H) scratch, which a second launch folds
// in a fixed order (deterministic, no atomics).
//
// Any H up to 2048 * V (4096 even, 2048 odd): V = 2 (bf16x2 loads,
// 4-byte aligned) where H and P are even, so that the b half of a row starts
// on a 4-byte boundary; V = 1 otherwise. 2730 is even but not a multiple of
// 4 or 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
// loads a thread holds of a row, G1 and G2: a row of 2730 takes 192 threads
// in G1 (small blocks, many an SM) and 704 in G2 (whose partial sums of the
// norm's gradients take registers a slot)
constexpr int kSlotsFwd = 8, kMaxThreadsFwd = 256;
constexpr int kSlotsBwd = 2, kMaxThreadsBwd = 1024;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
  static __device__ __forceinline__ void loadf(const float* p, float (&v)[1]) { v[0] = *p; }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[2]) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
  static __device__ __forceinline__ void loadf(const float* p, float (&v)[2]) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  }
};

__device__ __forceinline__ float sigmoid(float a) { return 1.f / (1.f + __expf(-a)); }

// The sum of v over the block, to every thread; `red` holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nw ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red is reused by the next sum
  return total;
}

// The sums of both parts of v over the block, to every thread; `red` holds
// 66 floats.
__device__ __forceinline__ float2 block_sum2(float2 v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  if (lane == 0) {
    red[warp] = v.x;
    red[33 + warp] = v.y;
  }
  __syncthreads();
  if (warp == 0) {
    float x = lane < nw ? red[lane] : 0.f, y = lane < nw ? red[33 + lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, o);
      y += __shfl_xor_sync(0xffffffffu, y, o);
    }
    if (lane == 0) {
      red[32] = x;
      red[65] = y;
    }
  }
  __syncthreads();
  const float2 total = make_float2(red[32], red[65]);
  __syncthreads();  // red is reused by the next row
  return total;
}

template <int V>
__global__ void __launch_bounds__(kMaxThreadsFwd)
swiglu_ln_fwd_kernel(const bf16* __restrict__ u, const float* __restrict__ w,
                     const float* __restrict__ beta, bf16* __restrict__ y,
                     float2* __restrict__ stats, int hidden, int pitch, float eps) {
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const bf16* a = u + row * 2 * pitch;
  const bf16* bb = a + pitch;
  const int groups = hidden / V;
  float hv[kSlotsFwd][V];
  float sum = 0.f;
#pragma unroll
  for (int s = 0; s < kSlotsFwd; ++s) {
    const int idx = threadIdx.x + s * blockDim.x;
    if (idx < groups) {
      float av[V], bv[V];
      Vec<V>::load(a + idx * V, av);
      Vec<V>::load(bb + idx * V, bv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        hv[s][e] = av[e] * sigmoid(av[e]) * bv[e];
        sum += hv[s][e];
      }
    }
  }
  const float inv_h = 1.f / (float)hidden;
  const float mean = block_sum(sum, red) * inv_h;
  float sq = 0.f;
#pragma unroll
  for (int s = 0; s < kSlotsFwd; ++s) {
    const int idx = threadIdx.x + s * blockDim.x;
    if (idx < groups) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float c = hv[s][e] - mean;
        sq = fmaf(c, c, sq);
      }
    }
  }
  const float rstd = rsqrtf(block_sum(sq, red) * inv_h + eps);
  bf16* yr = y + row * pitch;
  for (int c = hidden + threadIdx.x; c < pitch; c += blockDim.x) yr[c] = __float2bfloat16_rn(0.f);
#pragma unroll
  for (int s = 0; s < kSlotsFwd; ++s) {
    const int idx = threadIdx.x + s * blockDim.x;
    if (idx < groups) {
      float wv[V], bt[V], out[V];
      Vec<V>::loadf(w + idx * V, wv);
      Vec<V>::loadf(beta + idx * V, bt);
#pragma unroll
      for (int e = 0; e < V; ++e) out[e] = (hv[s][e] - mean) * rstd * wv[e] + bt[e];
      Vec<V>::store(yr + idx * V, out);
    }
  }
  if (threadIdx.x == 0) stats[row] = make_float2(mean, rstd);
}

template <int V>
__global__ void __launch_bounds__(kMaxThreadsBwd)
swiglu_ln_bwd_kernel(const bf16* __restrict__ u, const bf16* __restrict__ gy,
                     const float* __restrict__ w, const float2* __restrict__ stats,
                     bf16* __restrict__ du, float* __restrict__ part, int rows, int hidden,
                     int pitch) {
  __shared__ float red[66];
  const int groups = hidden / V;
  const float inv_h = 1.f / (float)hidden;
  float accw[kSlotsBwd][V], accb[kSlotsBwd][V];
#pragma unroll
  for (int s = 0; s < kSlotsBwd; ++s)
#pragma unroll
    for (int e = 0; e < V; ++e) accw[s][e] = accb[s][e] = 0.f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const bf16* a = u + row * 2 * pitch;
    const bf16* bb = a + pitch;
    const bf16* g = gy + row * pitch;
    const float2 st = stats[row];
    // pass 1: the sums of gx and gx * xhat, and the norm's partials
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int s = 0; s < kSlotsBwd; ++s) {
      const int idx = threadIdx.x + s * blockDim.x;
      if (idx < groups) {
        float av[V], bv[V], gv[V], wv[V];
        Vec<V>::load(a + idx * V, av);
        Vec<V>::load(bb + idx * V, bv);
        Vec<V>::load(g + idx * V, gv);
        Vec<V>::loadf(w + idx * V, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = (av[e] * sigmoid(av[e]) * bv[e] - st.x) * st.y;
          const float gx = gv[e] * wv[e];
          s1 += gx;
          s2 = fmaf(gx, xh, s2);
          accw[s][e] = fmaf(gv[e], xh, accw[s][e]);
          accb[s][e] += gv[e];
        }
      }
    }
    const float2 m = block_sum2(make_float2(s1, s2), red);
    const float m1 = m.x * inv_h, m2 = m.y * inv_h;
    bf16* da = du + row * 2 * pitch;
    bf16* db = da + pitch;
    for (int c = hidden + threadIdx.x; c < pitch; c += blockDim.x)
      da[c] = db[c] = __float2bfloat16_rn(0.f);
    // pass 2: the row again (from the caches), the cotangent
#pragma unroll
    for (int s = 0; s < kSlotsBwd; ++s) {
      const int idx = threadIdx.x + s * blockDim.x;
      if (idx < groups) {
        float av[V], bv[V], gv[V], wv[V], oa[V], ob[V];
        Vec<V>::load(a + idx * V, av);
        Vec<V>::load(bb + idx * V, bv);
        Vec<V>::load(g + idx * V, gv);
        Vec<V>::loadf(w + idx * V, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float sg = sigmoid(av[e]), sa = av[e] * sg;
          const float xh = (sa * bv[e] - st.x) * st.y;
          const float dh = st.y * (gv[e] * wv[e] - m1 - xh * m2);
          oa[e] = dh * bv[e] * sg * (1.f + av[e] * (1.f - sg));
          ob[e] = dh * sa;
        }
        Vec<V>::store(da + idx * V, oa);
        Vec<V>::store(db + idx * V, ob);
      }
    }
  }
  float* pw = part + (long long)blockIdx.x * 2 * hidden;
#pragma unroll
  for (int s = 0; s < kSlotsBwd; ++s) {
    const int idx = threadIdx.x + s * blockDim.x;
    if (idx < groups) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        pw[idx * V + e] = accw[s][e];
        pw[hidden + idx * V + e] = accb[s][e];
      }
    }
  }
}

// dw[c] and dbeta[c]: the blocks' partials summed in block order.
__global__ void swiglu_ln_fold_kernel(const float* __restrict__ part, int blocks, int hidden,
                                      float* __restrict__ dw, float* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * hidden) return;
  float acc = 0.f;
  for (int k = 0; k < blocks; ++k) acc += part[(long long)k * 2 * hidden + c];
  if (c < hidden)
    dw[c] = acc;
  else
    db[c - hidden] = acc;
}

// the loads' width: bf16 pairs where H and the pitch are even
int width_of(int hidden, int pitch) { return hidden % 2 == 0 && pitch % 2 == 0 ? 2 : 1; }

// threads of a block for `groups` loads a row: a multiple of 32, enough that
// `slots` each cover the row, at least 64
int threads_for(int groups, int slots) {
  int t = (groups + slots - 1) / slots;
  t = (t + 31) / 32 * 32;
  return t < 64 ? 64 : t;
}

}  // namespace

extern "C" {

// the widest row the kernels take
int vst_swiglu_ln_max_hidden(int even) { return kSlotsFwd * kMaxThreadsFwd * (even ? 2 : 1); }

// the blocks of G2's row pass, whose partials the fold sums: as many as fit
// on the card at once
int vst_swiglu_ln_bwd_blocks(int rows, int hidden, int pitch, int sms) {
  const int threads = threads_for(hidden / width_of(hidden, pitch), kSlotsBwd);
  const int per_sm = 2048 / threads > 1 ? 2048 / threads : 1;
  return rows < per_sm * sms ? rows : per_sm * sms;
}

// G1: u (rows, 2 * pitch) bf16 -> y (rows, pitch) bf16, stats (rows, 2) f32.
int vst_swiglu_ln_fwd(const void* u, const void* w, const void* beta, void* y, void* stats,
                      int rows, int hidden, int pitch, float eps, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int v = width_of(hidden, pitch), groups = hidden / v;
  const int threads = threads_for(groups, kSlotsFwd);
  if (threads > kMaxThreadsFwd || rows <= 0 || pitch < hidden) return (int)cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(u);
  const float *wp = static_cast<const float*>(w), *bp = static_cast<const float*>(beta);
  if (v == 2)
    swiglu_ln_fwd_kernel<2><<<rows, threads, 0, stream>>>(
        x, wp, bp, static_cast<bf16*>(y), static_cast<float2*>(stats), hidden, pitch, eps);
  else
    swiglu_ln_fwd_kernel<1><<<rows, threads, 0, stream>>>(
        x, wp, bp, static_cast<bf16*>(y), static_cast<float2*>(stats), hidden, pitch, eps);
  return (int)cudaGetLastError();
}

// G2: gy (rows, pitch) -> du (rows, 2 * pitch) bf16, dw and dbeta (hidden)
// f32; part is a (blocks, 2, hidden) f32 scratch, blocks from
// vst_swiglu_ln_bwd_blocks.
int vst_swiglu_ln_bwd(const void* u, const void* gy, const void* w, const void* stats,
                      void* du, void* dw, void* dbeta, void* part, int blocks, int rows,
                      int hidden, int pitch, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int v = width_of(hidden, pitch), groups = hidden / v;
  const int threads = threads_for(groups, kSlotsBwd);
  if (threads > kMaxThreadsBwd || rows <= 0 || blocks <= 0 || pitch < hidden)
    return (int)cudaErrorInvalidValue;
  const bf16 *x = static_cast<const bf16*>(u), *g = static_cast<const bf16*>(gy);
  const float* wp = static_cast<const float*>(w);
  const float2* st = static_cast<const float2*>(stats);
  float* pp = static_cast<float*>(part);
  if (v == 2)
    swiglu_ln_bwd_kernel<2><<<blocks, threads, 0, stream>>>(x, g, wp, st,
                                                            static_cast<bf16*>(du), pp, rows,
                                                            hidden, pitch);
  else
    swiglu_ln_bwd_kernel<1><<<blocks, threads, 0, stream>>>(x, g, wp, st,
                                                            static_cast<bf16*>(du), pp, rows,
                                                            hidden, pitch);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  swiglu_ln_fold_kernel<<<(2 * hidden + 255) / 256, 256, 0, stream>>>(
      pp, blocks, hidden, static_cast<float*>(dw), static_cast<float*>(dbeta));
  return (int)cudaGetLastError();
}

}  // extern "C"
