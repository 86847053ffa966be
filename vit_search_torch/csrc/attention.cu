// Fused multi-head attention, forward and backward, for Hopper (sm_90a), over
// three layouts of q, k and v.
//
// Replaces the Pallas TPU kernels of vit_search_tpu/ops/pallas/attention.py:
//   K1  _fwd_kernel_qkv   (attention.py:88),  called through _fwd_call_qkv   (:217-229)
//   K2  _bwd_kernel_qkv   (attention.py:108), called through _bwd_call_qkv   (:232-244)
//   K6  _fwd_kernel       (attention.py:46),  called through _fwd_call       (:170-181)
//   K7  _bwd_kernel       (attention.py:62),  called through _bwd_call       (:184-195)
//   K8  _fwd_kernel_qkv_t (attention.py:306), called through _fwd_call_qkv_t (:402-415)
//   K9  _bwd_kernel_qkv_t (attention.py:331), called through _bwd_call_qkv_t (:418-432)
//
// Layouts (W = H * D; q, k and v each ordered by head):
//   packed      K1/K2  qkv (B, N, 3W) with column blocks [q | k | v]; out and
//                      dout (B, N, W); the cotangent is the packed dqkv
//                      (B, N, 3W), so the qkv projection's backward takes it
//   separate    K6/K7  q, k, v, out, dout each (B, N, W); dq, dk, dv the same
//   seq-major   K8/K9  the packed layout with the first two axes swapped:
//                      qkv (N, B, 3W), out and dout (N, B, W), dqkv (N, B, 3W)
// One kernel body serves all three: each operand is a base pointer with a
// stride per token and a stride per example, offsets in 64 bits (a
// sequence-major token offset at B = 2048, stage 1, already reaches 3.0e8
// elements). The layout is a template parameter, so each instantiation's
// strides fold to expressions of n, heads and batch as in a kernel written for
// that layout alone. The layouts run the same arithmetic in the same order and
// agree bit for bit.
//
// Math, per (example, head), as the TPU kernels do it:
//   forward   s = q k^T * scale (f32); p = softmax_rows(s) (f32);
//             o = cast(p, dtype(v)) v, summed in f32, stored in dtype(q)
//   backward  p recomputed in f32 from q, k (the inputs are the only
//             residuals), all in f32:
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
//   forward   warp per query row: scores over all keys, exact two-pass
//             softmax, p rounded to v's dtype, then o with lanes over the
//             head's columns.
//   backward  the sum over queries that forms dk and dv cannot be carried
//             from block to block as the TPU's sequential grid does, so the
//             backward is two passes that share each query row's statistics
//             (K12 in attn_lab.cu is the lab's split, whose dk/dv kernel
//             recomputes them):
//             (a) warp per query row: recompute p, dp, delta = rowsum(dp * p)
//                 from the f32 p, write dq and the row's (max, sum, delta);
//             (b) warp per key row: recompute p from the saved (max, sum), ds
//                 from delta, and sum dk, dv over all queries.
//             Both recompute s with the same f32 operation order, so they
//             agree on p bit for bit.
// N is any length (every loop masks its ragged end); D is a template
// constant (8, 16, 32, 48, 64, 128) so the per-row vectors live in registers.
// The TPU's group sizes and VMEM limits (_pick_group, _pick_group_t,
// _params_t and VST_ATTN_T_VMEM_MB) budget VMEM blocks and have no
// counterpart here: the block per (example, head) is the same for every layout.

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

enum Layout { kPacked = 0, kSeparate = 1, kSeqMajor = 2 };

// The strides, in elements, of one layout's operands: element (example b,
// token i, column c) of an operand is at base[b * ex + i * tok + c]. `qkv`
// strides serve q, k, v and their cotangents (rows of 3W in packed and
// sequence-major, of W in separate); `wide` strides serve out and dout.
template <int L>
struct Strides {
  long long tok, ex;
  __device__ __forceinline__ static Strides qkv(int batch, int n, int w) {
    const long long w3 = 3LL * w;
    if (L == kSeparate) return {w, (long long)n * w};
    if (L == kSeqMajor) return {batch * w3, w3};
    return {w3, n * w3};
  }
  __device__ __forceinline__ static Strides wide(int batch, int n, int w) {
    if (L == kSeqMajor) return {(long long)batch * w, w};
    return {w, (long long)n * w};
  }
  template <typename P>
  __device__ __forceinline__ P* row(P* base, int b, int i) const {
    return base + (long long)b * ex + (long long)i * tok;
  }
};

// Stage columns [0, D) of rows 0..n-1 from `rows` (token stride `row_stride`)
// into f32 shared memory with row stride `stride`.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ rows, long long row_stride, int n,
                                      float* __restrict__ dst, int stride) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int j = idx / D, c = idx - j * D;
    dst[j * stride + c] = to_f(rows[j * row_stride + c]);
  }
}

// q, k and v (or dq, dk and dv) are the column blocks of one tensor in the
// packed and sequence-major layouts, W columns apart; separate ones otherwise.
template <typename T, int D, int L>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int batch, int n, int heads, float scale) {
  constexpr int KS = D + 1;
  constexpr int CD = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Ks = smem;             // n x KS
  float* Vs = Ks + n * KS;      // n x D
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides<L> in = Strides<L>::qkv(batch, n, heads * D);
  const Strides<L> wide = Strides<L>::wide(batch, n, heads * D);
  stage<T, D>(in.row(k, b, 0) + h * D, in.tok, n, Ks, KS);
  stage<T, D>(in.row(v, b, 0) + h * D, in.tok, n, Vs, D);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = Vs + n * D + warp * n;  // this warp's row of scores / probabilities
  for (int i = warp; i < n; i += kWarps) {
    const T* qr = in.row(q, b, i) + h * D;
    float qv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) qv[c] = to_f(qr[c]);
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = Ks + j * KS;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) s = fmaf(qv[c], kr[c], s);
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
    T* orow = wide.row(out, b, i) + h * D;
#pragma unroll
    for (int t = 0; t < CD; ++t) {
      const int c = lane + 32 * t;
      if (c < D) orow[c] = from_f<T>(acc[t]);
    }
    __syncwarp();
  }
}

// backward (a): dq and the per-row (max, sum, delta), warp per query row.
template <typename T, int D, int L>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, T* __restrict__ dq,
                   float4* __restrict__ rowstats, int batch, int n, int heads, float scale) {
  constexpr int KS = D + 1;
  constexpr int CD = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Ks = smem;             // n x KS
  float* Vs = Ks + n * KS;      // n x KS
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides<L> in = Strides<L>::qkv(batch, n, heads * D);
  const Strides<L> wide = Strides<L>::wide(batch, n, heads * D);
  stage<T, D>(in.row(k, b, 0) + h * D, in.tok, n, Ks, KS);
  stage<T, D>(in.row(v, b, 0) + h * D, in.tok, n, Vs, KS);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = Vs + n * KS + warp * 2 * n;
  float* dp = p + n;
  for (int i = warp; i < n; i += kWarps) {
    const T* qr = in.row(q, b, i) + h * D;
    const T* gr = wide.row(dout, b, i) + h * D;
    float qv[D], g[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      qv[c] = to_f(qr[c]);
      g[c] = to_f(gr[c]);
    }
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const float* kr = Ks + j * KS;
      const float* vr = Vs + j * KS;
      float s = 0.f, d = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(qv[c], kr[c], s);
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
    T* drow = in.row(dq, b, i) + h * D;
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

// backward (b): dk and dv, warp per key row, summing over every query.
template <typename T, int D, int L>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float4* __restrict__ rowstats,
                    T* __restrict__ dk, T* __restrict__ dv, int batch, int n, int heads,
                    float scale) {
  constexpr int KS = D + 1;
  constexpr int CD = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;             // n x KS
  float* Gs = Qs + n * KS;      // n x KS
  float* Mx = Gs + n * KS;      // n
  float* Sum = Mx + n;          // n
  float* Delta = Sum + n;       // n
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides<L> in = Strides<L>::qkv(batch, n, heads * D);
  const Strides<L> wide = Strides<L>::wide(batch, n, heads * D);
  stage<T, D>(in.row(q, b, 0) + h * D, in.tok, n, Qs, KS);
  stage<T, D>(wide.row(dout, b, 0) + h * D, wide.tok, n, Gs, KS);
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
    const T* kr = in.row(k, b, j) + h * D;
    const T* vr = in.row(v, b, j) + h * D;
    float kv[D], vv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      kv[c] = to_f(kr[c]);
      vv[c] = to_f(vr[c]);
    }
    for (int i = lane; i < n; i += 32) {
      const float* qr = Qs + i * KS;
      const float* gr = Gs + i * KS;
      float s = 0.f, d = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        s = fmaf(qr[c], kv[c], s);
        d = fmaf(gr[c], vv[c], d);
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
    T* dkrow = in.row(dk, b, j) + h * D;
    T* dvrow = in.row(dv, b, j) + h * D;
#pragma unroll
    for (int t = 0; t < CD; ++t) {
      const int c = lane + 32 * t;
      if (c < D) {
        dkrow[c] = from_f<T>(acck[t] * scale);
        dvrow[c] = from_f<T>(accv[t]);
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

// q, k and v (or their cotangents): the one qkv tensor `a` with the blocks W
// columns apart, or (separate) the tensors a, b and c.
template <typename P>
struct QKV {
  P *q, *k, *v;
};

template <int L, typename P>
QKV<P> split(P* a, P* b, P* c, int w) {
  if (L == kSeparate) return {a, b, c};
  return {a, a + w, a + 2 * w};
}

template <typename T, int D, int L>
int fwd_launch(const void* a, const void* b, const void* c, void* out, int batch, int n,
               int heads, float scale, cudaStream_t stream) {
  const QKV<const T> in = split<L>(static_cast<const T*>(a), static_cast<const T*>(b),
                                   static_cast<const T*>(c), heads * D);
  const size_t smem = fwd_smem(n, D);
  int rc = prepare(attn_fwd_kernel<T, D, L>, smem);
  if (rc) return rc;
  attn_fwd_kernel<T, D, L><<<batch * heads, kThreads, smem, stream>>>(
      in.q, in.k, in.v, static_cast<T*>(out), batch, n, heads, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int L>
int bwd_launch(const void* a, const void* b, const void* c, const void* dout, void* da,
               void* db, void* dc, void* rowstats, int batch, int n, int heads, float scale,
               cudaStream_t stream) {
  const QKV<const T> in = split<L>(static_cast<const T*>(a), static_cast<const T*>(b),
                                   static_cast<const T*>(c), heads * D);
  const QKV<T> grad = split<L>(static_cast<T*>(da), static_cast<T*>(db), static_cast<T*>(dc),
                               heads * D);
  const T* g = static_cast<const T*>(dout);
  size_t smem = dq_smem(n, D);
  int rc = prepare(attn_bwd_dq_kernel<T, D, L>, smem);
  if (rc) return rc;
  attn_bwd_dq_kernel<T, D, L><<<batch * heads, kThreads, smem, stream>>>(
      in.q, in.k, in.v, g, grad.q, static_cast<float4*>(rowstats), batch, n, heads, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  smem = dkv_smem(n, D);
  rc = prepare(attn_bwd_dkv_kernel<T, D, L>, smem);
  if (rc) return rc;
  attn_bwd_dkv_kernel<T, D, L><<<batch * heads, kThreads, smem, stream>>>(
      in.q, in.k, in.v, g, static_cast<const float4*>(rowstats), grad.k, grad.v, batch, n,
      heads, scale);
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

namespace {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() (or
// cudaErrorInvalidValue for a head size, length or dtype the kernels do not take).
template <int L>
int attn_fwd(const void* a, const void* b, const void* c, void* out, int batch, int n,
             int heads, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VST_FWD_BF16(D) \
  return fwd_launch<__nv_bfloat16, D, L>(a, b, c, out, batch, n, heads, scale, s)
#define VST_FWD_F32(D) return fwd_launch<float, D, L>(a, b, c, out, batch, n, heads, scale, s)
  if (dtype == 1) { VST_SWITCH_D(d, VST_FWD_BF16) }
  if (dtype == 0) { VST_SWITCH_D(d, VST_FWD_F32) }
  return (int)cudaErrorInvalidValue;
#undef VST_FWD_BF16
#undef VST_FWD_F32
}

// rowstats is float32 scratch of (batch * heads * n, 4).
template <int L>
int attn_bwd(const void* a, const void* b, const void* c, const void* dout, void* da,
             void* db, void* dc, void* rowstats, int batch, int n, int heads, int d,
             float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VST_BWD_BF16(D)                                                                    \
  return bwd_launch<__nv_bfloat16, D, L>(a, b, c, dout, da, db, dc, rowstats, batch, n,    \
                                         heads, scale, s)
#define VST_BWD_F32(D)                                                                    \
  return bwd_launch<float, D, L>(a, b, c, dout, da, db, dc, rowstats, batch, n, heads,    \
                                 scale, s)
  if (dtype == 1) { VST_SWITCH_D(d, VST_BWD_BF16) }
  if (dtype == 0) { VST_SWITCH_D(d, VST_BWD_F32) }
  return (int)cudaErrorInvalidValue;
#undef VST_BWD_BF16
#undef VST_BWD_F32
}

}  // namespace

extern "C" {

// K1: qkv (batch, n, 3 * heads * d) -> out (batch, n, heads * d).
int vst_attn_fwd(const void* qkv, void* out, int batch, int n, int heads, int d, float scale,
                 int dtype, void* stream) {
  return attn_fwd<kPacked>(qkv, nullptr, nullptr, out, batch, n, heads, d, scale, dtype, stream);
}

// K2: dout (batch, n, heads * d) -> dqkv (batch, n, 3 * heads * d).
int vst_attn_bwd(const void* qkv, const void* dout, void* dqkv, void* rowstats, int batch,
                 int n, int heads, int d, float scale, int dtype, void* stream) {
  return attn_bwd<kPacked>(qkv, nullptr, nullptr, dout, dqkv, nullptr, nullptr, rowstats,
                           batch, n, heads, d, scale, dtype, stream);
}

// K6: q, k, v (batch, n, heads * d) -> out (batch, n, heads * d).
int vst_attn_fwd_sep(const void* q, const void* k, const void* v, void* out, int batch, int n,
                     int heads, int d, float scale, int dtype, void* stream) {
  return attn_fwd<kSeparate>(q, k, v, out, batch, n, heads, d, scale, dtype, stream);
}

// K7: dout -> dq, dk, dv, every tensor (batch, n, heads * d).
int vst_attn_bwd_sep(const void* q, const void* k, const void* v, const void* dout, void* dq,
                     void* dk, void* dv, void* rowstats, int batch, int n, int heads, int d,
                     float scale, int dtype, void* stream) {
  return attn_bwd<kSeparate>(q, k, v, dout, dq, dk, dv, rowstats, batch, n, heads, d, scale,
                             dtype, stream);
}

// K8: qkv_t (n, batch, 3 * heads * d) -> out_t (n, batch, heads * d).
int vst_attn_fwd_t(const void* qkv_t, void* out_t, int batch, int n, int heads, int d,
                   float scale, int dtype, void* stream) {
  return attn_fwd<kSeqMajor>(qkv_t, nullptr, nullptr, out_t, batch, n, heads, d, scale, dtype,
                             stream);
}

// K9: dout_t (n, batch, heads * d) -> dqkv_t (n, batch, 3 * heads * d).
int vst_attn_bwd_t(const void* qkv_t, const void* dout_t, void* dqkv_t, void* rowstats,
                   int batch, int n, int heads, int d, float scale, int dtype, void* stream) {
  return attn_bwd<kSeqMajor>(qkv_t, nullptr, nullptr, dout_t, dqkv_t, nullptr, nullptr,
                             rowstats, batch, n, heads, d, scale, dtype, stream);
}

// Largest dynamic shared memory each kernel needs at (n, d), so the caller
// can refuse a shape before launching.
long long vst_attn_smem_bytes(int n, int d) {
  size_t a = fwd_smem(n, d), b = dq_smem(n, d), c = dkv_smem(n, d);
  size_t m = a > b ? a : b;
  return (long long)(m > c ? m : c);
}

}  // extern "C"
