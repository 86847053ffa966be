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
// One kernel body per pass and dtype serves all three: each operand is a base
// pointer with a stride per token and a stride per example, offsets in 64
// bits (a sequence-major token offset at B = 2048, stage 1, already reaches
// 3.0e8 elements). The layout is a template parameter, so each instantiation's
// strides fold to expressions of n, heads and batch as in a kernel written for
// that layout alone. The layouts run the same arithmetic in the same order, so
// they agree bit for bit; no sum uses atomics, so every run gives the same bits.
//
// Math, per (example, head), as the TPU kernels do it:
//   forward   s = q k^T * scale (f32); p = softmax_rows(s) (f32), normalised,
//             then rounded to dtype(v); o = p v, summed in f32, stored in dtype(q)
//   backward  p recomputed from q, k (the inputs are the only residuals):
//             dv = p^T do;  dp = do v^T;  delta = rowsum(dp * p)
//             ds = p * (dp - delta);  dq = ds k * scale;  dk = ds^T q * scale
//
// Two bodies, chosen by dtype:
//   bfloat16  (the model's) on the tensor cores: mma.sync m16n8k16, bf16
//             operands, f32 accumulators. The forward rounds p where the TPU
//             kernel does (normalised, then to bf16). The backward's products
//             take p and ds as bf16 operands where the TPU kernel keeps them in
//             f32: a deliberate change of rounding. delta = rowsum(dp * p) is
//             still formed from the f32 p and dp (the accumulators), and ds
//             in f32 before it is rounded as an operand; delta is not taken as
//             rowsum(do * o), whose o was rounded twice.
//   float32   the first port's bodies on the CUDA cores, all in f32, which hold
//             the f32 function to 1e-4 where bf16 operands could not (below).
//
// What bounds it on this card: at the main path's shapes (N = 257/65/17, D =
// 32/48/64) each (example, head) does about 4*N^2*D flops in the forward
// (10*N^2*D in the backward) against about 8*N*D bytes (14*N*D), so about N/2
// flops per byte, far below the 295 at which the H100's bf16 tensor cores and
// not its memory are the limit: the function is bound by bytes. So the design
// reads each input once per (example, head), keeps every score on chip, and
// picks the MMA shape by padding, not by peak rate: 16-row tiles waste 6% /
// 23% / 47% of the rows at N = 257 / 65 / 17, wgmma's 64-row tiles 20% / 49%
// / 73%, so the warp-level mma.sync.
//
// Design of the bf16 bodies. A block owns one (example, head) and 1-8 warps,
// as many as spread the 16-row tiles of the sequence evenly. Rows live in
// shared memory as bf16 with the head dim padded with zeros to a multiple of
// 16 (so D = 8 works) and a row stride of that plus 8 elements, which makes
// every ldmatrix free of bank conflicts; rows past N are zero. Operands come
// in by 16-byte cp.async and reach the MMAs through ldmatrix (.trans for the
// operands read along the sequence); C fragments turn into A fragments in
// registers, and movmatrix transposes ds^T into ds for dq. Exponentials run
// in base 2 on the SFU (ex2.approx) from s * scale * log2(e).
//   forward   K and V resident. A warp owns 16 query rows (its Q fragments in
//             registers) and makes two passes over the keys, 16 at a time:
//             (1) S = Q K^T, the row max and sum (rescaled as the max moves);
//             (2) S again, p = exp(s - m) / l rounded to bf16, O += P V.
//             Keys past N are -inf before the softmax. O goes out through the
//             warp's tile in shared memory, stored along rows, coalesced.
//   backward  one launch (the lab's K11 form, FlashAttention-2's backward):
//             nothing crosses blocks and no row statistics go to device memory.
//             (1) warp per 16 query rows: S = Q K^T and dP = dO V^T over all
//                 keys give each row's max, sum and delta = sum p * dp (the
//                 sum and delta rescaled as the max moves), 12 bytes a row
//                 into shared memory;
//             (2) warps over key blocks of 16 rows, dK and dV of the block in
//                 registers, each warp walking every query tile:
//                   S^T = K_blk Q^T,  P^T = exp(S^T - m) / l,  dP^T = V_blk dO^T,
//                   dS^T = P^T (dP^T - delta),  dV += P^T dO,  dK += dS^T Q,
//                   dQ_tile += dS K_blk into an f32 dQ in shared memory.
//                 The warps walk the query tiles in a rotation, warp w at step
//                 t on tile (t + w) mod T, one barrier a step, so no two warps
//                 add to one dQ tile at once and each dQ element sums its key
//                 blocks in a fixed order, without atomics. Q and dO stream
//                 through a ring of W + 1 tiles (W warps): the tiles of the
//                 step's window and the one loaded for the next step.
//             Finally dQ * scale, dK * scale and dV, stored along rows.
//             Shared memory, with R = D padded to 16, plus 8: K, V and the
//             f32 dQ 8*N*R bytes, the ring 64*(W + 1)*R, the statistics
//             12*N: 108 KB at stage 1 (two blocks per SM), up to N = 624 at
//             D = 32 (the 336 px finetune's N = 577 fits).
// Design of the f32 bodies (the first port's): a block owns one (example,
// head) and stages K and V (or Q and dO) as f32, rows padded to D + 1 floats;
// a warp owns one row at a time and keeps that row of scores in shared memory.
// The forward is an exact two-pass softmax per row. The backward is two
// launches that share each query row's (max, sum, delta) through the caller's
// `rowstats` scratch: (a) warp per query row writes dq and the statistics;
// (b) warp per key row sums dk and dv over every query.
// N is any length (every loop masks its ragged end); D is a template constant
// (8, 16, 32, 48, 64, 128). The TPU's group sizes and VMEM limits
// (_pick_group, _pick_group_t, _params_t and VST_ATTN_T_VMEM_MB) budget VMEM
// blocks and have no counterpart here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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

// --- float32 bodies (CUDA cores) -------------------------------------------

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

// --- bfloat16 bodies (tensor cores) ----------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// Rows of the head in shared memory: DP columns (D padded with zeros to the
// MMA's k of 16), row stride RS = DP + 8 elements (bf16) or floats (the f32
// dQ). 8 rows at that stride start in 8 distinct 16-byte bank groups, so the
// 8 row addresses of an ldmatrix, and the float2 accesses of a dQ fragment,
// are free of conflicts.
template <int D>
struct Geom {
  static constexpr int DP = (D + 15) / 16 * 16;
  static constexpr int RS = DP + 8;
  static constexpr int KT = DP / 16;    // k steps over the head dim
  static constexpr int NT = DP / 8;     // n tiles of 8 over the head dim
  static constexpr int CH = D / 8;      // 16-byte chunks of a row in device memory
  static constexpr int CHP = DP / 8;    // ... in shared memory
};

// warps of a block over `tiles` 16-row tiles: up to 8, spread evenly
inline int warps_for(int tiles) {
  const int rounds = (tiles + kWarps - 1) / kWarps;
  return (tiles + rounds - 1) / rounds;
}

inline size_t rs_of(int d) { return (size_t)((d + 15) / 16 * 16 + 8); }

size_t fwd_bytes(int n, int d) {
  const size_t tiles = (n + 15) / 16, rs = rs_of(d);
  return sizeof(bf16) * rs * 16 * (2 * tiles + warps_for((int)tiles));
}

size_t bwd_bytes(int n, int d) {
  const size_t tiles = (n + 15) / 16, rs = rs_of(d), np = 16 * tiles;
  return sizeof(bf16) * rs * (2 * np + 2 * 16 * (warps_for((int)tiles) + 1)) +
         sizeof(float) * (np * rs + 3 * np);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from device to shared memory, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a b: a 16x16 (row), b 16x8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the transpose of an 8x8 bf16 matrix held as one fragment by the warp
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A 16x16 C pair (two n tiles of 8) as the A fragment of the next product.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack(c[0][0], c[0][1]);
  a[1] = pack(c[0][2], c[0][3]);
  a[2] = pack(c[1][0], c[1][1]);
  a[3] = pack(c[1][2], c[1][3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Lane addresses for ldmatrix.x4 of a 16x16 block at (r0, c0) of a row-major
// tile: as an A operand (ldsm4), or as the B operand of two n tiles of 8 when
// the tile is stored [k][n] (ldsm4_t) ...
template <int D>
__device__ __forceinline__ const bf16* at_rows(const bf16* x, int r0, int c0, int lane) {
  return x + (r0 + (lane & 15)) * Geom<D>::RS + c0 + ((lane >> 4) << 3);
}
// ... and as the B operand of two n tiles of 8 when stored [n][k] (ldsm4).
template <int D>
__device__ __forceinline__ const bf16* at_cols(const bf16* x, int n0, int k0, int lane) {
  return x + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Geom<D>::RS + k0 + (lane & 8);
}

// The A fragments of 16 rows of a tile, over the padded head dim.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[Geom<D>::KT][4], const bf16* x, int r0,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < Geom<D>::KT; ++ks) ldsm4(a[ks], at_rows<D>(x, r0, ks * 16, lane));
}

// s (16 x 16) = A (16 x DP) times rows n0..n0+15 of x (DP wide), transposed.
template <int D>
__device__ __forceinline__ void dot_rows(float (&s)[2][4], const uint32_t (&a)[Geom<D>::KT][4],
                                         const bf16* x, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Geom<D>::KT; ++ks) {
    uint32_t b[4];
    ldsm4(b, at_cols<D>(x, n0, ks * 16, lane));
    mma(s[0], a[ks], b[0], b[1]);
    mma(s[1], a[ks], b[2], b[3]);
  }
}

// acc (16 x DP) += a (16 x 16) times rows k0..k0+15 of x (DP wide).
template <int D>
__device__ __forceinline__ void acc_rows(float (&acc)[Geom<D>::NT][4], const uint32_t (&a)[4],
                                         const bf16* x, int k0, int lane) {
#pragma unroll
  for (int dp = 0; dp < Geom<D>::KT; ++dp) {
    uint32_t b[4];
    ldsm4_t(b, at_rows<D>(x, k0, dp * 16, lane));
    mma(acc[2 * dp], a, b[0], b[1]);
    mma(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// cp.async rows row0..row0+rows-1 of one operand (head h of example b) into
// a shared tile, zero past n and past D; threads `tid` of `count` share it.
template <int D, int L>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, const Strides<L>& st,
                                          int b, int h, int row0, int rows, int n, int tid,
                                          int count) {
  using G = Geom<D>;
  for (int idx = tid; idx < rows * G::CHP; idx += count) {
    const int r = idx / G::CHP, c = idx - r * G::CHP, i = row0 + r;
    const bool valid = i < n && c < G::CH;
    cp_async16(dst + r * G::RS + c * 8, valid ? st.row(base, b, i) + h * D + c * 8 : base,
               valid);
  }
}

// Rows row0.. (< n) of a bf16 shared tile to one operand, 16 bytes a lane.
template <int D, int L>
__device__ __forceinline__ void store_rows(bf16* base, const Strides<L>& st, int b, int h,
                                           const bf16* src, int row0, int rows, int n,
                                           int tid, int count) {
  using G = Geom<D>;
  for (int idx = tid; idx < rows * G::CH; idx += count) {
    const int r = idx / G::CH, c = idx - r * G::CH, i = row0 + r;
    if (i < n)
      *reinterpret_cast<uint4*>(st.row(base, b, i) + h * D + c * 8) =
          *reinterpret_cast<const uint4*>(src + r * G::RS + c * 8);
  }
}

// A C fragment set (16 x DP, f32) times `mul`, to rows of a bf16 shared tile.
template <int D>
__device__ __forceinline__ void put_rows(bf16* x, const float (&acc)[Geom<D>::NT][4], float mul,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < Geom<D>::NT; ++j) {
    bf16* r = x + g * Geom<D>::RS + 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(r) = pack(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(r + 8 * Geom<D>::RS) = pack(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// S (16 x 16) for 16 rows of A against keys n0..n0+15, in log2 units
// (s * scale * log2 e), keys at or past n at -inf.
template <int D>
__device__ __forceinline__ void scores(float (&s)[2][4], const uint32_t (&a)[Geom<D>::KT][4],
                                       const bf16* ks, int n0, int n, float sl2, int lane) {
  dot_rows<D>(s, a, ks, n0, lane);
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + 8 * j + 2 * (lane & 3) + (e & 1);
      s[j][e] = key < n ? s[j][e] * sl2 : -INFINITY;
    }
}

// 2^x on the SFU: ex2.approx.ftz, without exp2f's handling of results below
// 2^-126 (they flush to zero, far under a bf16 step of any p that counts)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the base a running max subtracts: 0 while the max is still -inf
__device__ __forceinline__ float base_of(float m) { return m == -INFINITY ? 0.f : m; }

template <int D, int L>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int batch, int n,
                int heads, float scale) {
  using G = Geom<D>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tiles = (n + 15) >> 4, np = tiles * 16;
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);   // np x RS
  bf16* Vs = Ks + np * G::RS;                     // np x RS
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qs = Vs + np * G::RS + warp * 16 * G::RS;  // this warp's 16 x RS tile
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides<L> in = Strides<L>::qkv(batch, n, heads * D);
  const Strides<L> wide = Strides<L>::wide(batch, n, heads * D);
  load_rows<D, L>(Ks, k, in, b, h, 0, np, n, threadIdx.x, blockDim.x);
  load_rows<D, L>(Vs, v, in, b, h, 0, np, n, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float sl2 = scale * kLog2e;
  for (int qt = warp; qt < tiles; qt += nw) {
    load_rows<D, L>(Qs, q, in, b, h, qt * 16, 16, n, lane, 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    uint32_t qa[G::KT][4];
    load_a<D>(qa, Qs, 0, lane);

    // pass 1: each thread's running max and sum for rows g and g + 8
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
    for (int kt = 0; kt < tiles; ++kt) {
      float s[2][4];
      scores<D>(s, qa, Ks, kt * 16, n, sl2, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(fmaxf(mx[r], fmaxf(s[0][2 * r], s[0][2 * r + 1])),
                              fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        const float base = base_of(m);
        sm[r] = sm[r] * exp2_fast(mx[r] - base) + exp2_fast(s[0][2 * r] - base) +
                exp2_fast(s[0][2 * r + 1] - base) + exp2_fast(s[1][2 * r] - base) +
                exp2_fast(s[1][2 * r + 1] - base);
        mx[r] = m;
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = quad_max(mx[r]);
      inv[r] = 1.f / quad_sum(sm[r] * exp2_fast(mx[r] - m));
      mx[r] = m;
    }

    // pass 2: p normalised, rounded to bf16, O += P V
    float o[G::NT][4];
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    for (int kt = 0; kt < tiles; ++kt) {
      float s[2][4];
      scores<D>(s, qa, Ks, kt * 16, n, sl2, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = exp2_fast(s[j][e] - mx[e >> 1]) * inv[e >> 1];
      uint32_t pa[4];
      to_a(pa, s);
      acc_rows<D>(o, pa, Vs, kt * 16, lane);
    }
    __syncwarp();
    put_rows<D>(Qs, o, 1.f, lane);
    __syncwarp();
    store_rows<D, L>(out, wide, b, h, Qs, qt * 16, 16, n, lane, 32);
    __syncwarp();
  }
}

template <int D, int L>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int batch, int n, int heads, float scale) {
  using G = Geom<D>;
  constexpr int SLOT = 2 * 16 * G::RS;   // a ring slot: 16 rows of q, then of dout
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tiles = (n + 15) >> 4, np = tiles * 16;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);     // np x RS
  bf16* Vs = Ks + np * G::RS;                       // np x RS
  bf16* ring = Vs + np * G::RS;                     // (nw + 1) slots
  float* dQs = reinterpret_cast<float*>(ring + (nw + 1) * SLOT);  // np x RS, f32
  float* M = dQs + np * G::RS;                      // row max of s * scale * log2 e
  float* IL = M + np;                               // 1 / row sum
  float* DL = IL + np;                              // delta
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides<L> in = Strides<L>::qkv(batch, n, heads * D);
  const Strides<L> wide = Strides<L>::wide(batch, n, heads * D);
  load_rows<D, L>(Ks, k, in, b, h, 0, np, n, threadIdx.x, blockDim.x);
  load_rows<D, L>(Vs, v, in, b, h, 0, np, n, threadIdx.x, blockDim.x);
  cp_async_commit();
  for (int i = threadIdx.x; i < np * G::RS / 4; i += blockDim.x)
    reinterpret_cast<float4*>(dQs)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  cp_async_wait_all();
  __syncthreads();

  const float sl2 = scale * kLog2e;
  const int g = lane >> 2, t = lane & 3;

  // phase 1: each query row's max, sum and delta, a warp per 16 rows
  {
    bf16* Qs = ring + warp * SLOT;
    bf16* Gs = Qs + 16 * G::RS;
    for (int qt = warp; qt < tiles; qt += nw) {
      load_rows<D, L>(Qs, q, in, b, h, qt * 16, 16, n, lane, 32);
      load_rows<D, L>(Gs, dout, wide, b, h, qt * 16, 16, n, lane, 32);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      uint32_t qa[G::KT][4], ga[G::KT][4];
      load_a<D>(qa, Qs, 0, lane);
      load_a<D>(ga, Gs, 0, lane);
      __syncwarp();
      float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
      for (int kt = 0; kt < tiles; ++kt) {
        float s[2][4], dp[2][4];
        scores<D>(s, qa, Ks, kt * 16, n, sl2, lane);
        dot_rows<D>(dp, ga, Vs, kt * 16, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m = fmaxf(fmaxf(mx[r], fmaxf(s[0][2 * r], s[0][2 * r + 1])),
                                fmaxf(s[1][2 * r], s[1][2 * r + 1]));
          const float base = base_of(m), corr = exp2_fast(mx[r] - base);
          float es = 0.f, ed = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              const float x = exp2_fast(s[j][e] - base);
              es += x;
              ed = fmaf(x, dp[j][e], ed);
            }
          sm[r] = sm[r] * corr + es;
          dl[r] = dl[r] * corr + ed;
          mx[r] = m;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = quad_max(mx[r]), f = exp2_fast(mx[r] - m);
        const float l = quad_sum(sm[r] * f), d = quad_sum(dl[r] * f);
        if (t == 0) {
          const int i = qt * 16 + g + 8 * r;
          M[i] = m;
          IL[i] = 1.f / l;
          DL[i] = d / l;
        }
      }
    }
  }
  __syncthreads();

  // phase 2: warps over key blocks, rotating over the query tiles; stream
  // position p holds query tile p % tiles in ring slot p % (nw + 1)
  const int rounds = (tiles + nw - 1) / nw;
  auto load_slot = [&](int p) {
    bf16* dst = ring + (p % (nw + 1)) * SLOT;
    const int row0 = (p % tiles) * 16;
    load_rows<D, L>(dst, q, in, b, h, row0, 16, n, threadIdx.x, blockDim.x);
    load_rows<D, L>(dst + 16 * G::RS, dout, wide, b, h, row0, 16, n, threadIdx.x, blockDim.x);
  };
  for (int p = 0; p < nw; ++p) load_slot(p);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    const int kb = r * nw + warp;
    const bool active = kb < tiles;
    float dka[G::NT][4], dva[G::NT][4];
    uint32_t ka[G::KT][4], va[G::KT][4];
#pragma unroll
    for (int j = 0; j < G::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
    if (active) {
      load_a<D>(ka, Ks, kb * 16, lane);
      load_a<D>(va, Vs, kb * 16, lane);
    }
    for (int step = 0; step < tiles; ++step) {
      const int sigma = r * tiles + step;
      load_slot(sigma + nw);  // the next step's new tile, into the slot this step frees
      cp_async_commit();
      if (active) {
        const int p = sigma + warp, qt = p % tiles;
        const bf16* Qs = ring + (p % (nw + 1)) * SLOT;
        const bf16* Gs = Qs + 16 * G::RS;
        float s[2][4], dp[2][4];
        dot_rows<D>(s, ka, Qs, 0, lane);   // S^T: rows keys, columns queries
        dot_rows<D>(dp, va, Gs, 0, lane);  // dP^T
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = qt * 16 + 8 * j + 2 * t + c;
            const float m = M[i], il = IL[i], dl = DL[i];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
              const int e = 2 * rr + c, key = kb * 16 + g + 8 * rr;
              const float pv = key < n ? exp2_fast(s[j][e] * sl2 - m) * il : 0.f;
              s[j][e] = pv;
              dp[j][e] = pv * (dp[j][e] - dl);
            }
          }
        uint32_t pa[4], dsa[4];
        to_a(pa, s);    // P^T
        to_a(dsa, dp);  // dS^T
        acc_rows<D>(dva, pa, Gs, 0, lane);
        acc_rows<D>(dka, dsa, Qs, 0, lane);
        // dS = (dS^T)^T, 8x8 block by block, then dQ_tile += dS K_blk
        const uint32_t dsq[4] = {transpose8(dsa[0]), transpose8(dsa[2]), transpose8(dsa[1]),
                                 transpose8(dsa[3])};
#pragma unroll
        for (int dpi = 0; dpi < G::KT; ++dpi) {
          uint32_t kb4[4];
          ldsm4_t(kb4, at_rows<D>(Ks, kb * 16, dpi * 16, lane));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* r0 = dQs + (qt * 16 + g) * G::RS + 8 * (2 * dpi + half) + 2 * t;
            float* r1 = r0 + 8 * G::RS;
            const float2 x0 = *reinterpret_cast<float2*>(r0), x1 = *reinterpret_cast<float2*>(r1);
            float c4[4] = {x0.x, x0.y, x1.x, x1.y};
            mma(c4, dsq, kb4[2 * half], kb4[2 * half + 1]);
            *reinterpret_cast<float2*>(r0) = make_float2(c4[0], c4[1]);
            *reinterpret_cast<float2*>(r1) = make_float2(c4[2], c4[3]);
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }
    if (active) {
      // this warp alone reads rows kb of K and V in phase 2: reuse them
      bf16* dkr = Ks + kb * 16 * G::RS;
      bf16* dvr = Vs + kb * 16 * G::RS;
      put_rows<D>(dkr, dka, scale, lane);
      put_rows<D>(dvr, dva, 1.f, lane);
      __syncwarp();
      store_rows<D, L>(dk, in, b, h, dkr, kb * 16, 16, n, lane, 32);
      store_rows<D, L>(dv, in, b, h, dvr, kb * 16, 16, n, lane, 32);
    }
  }

  // dQ * scale, 8 columns a thread
  for (int idx = threadIdx.x; idx < n * G::CH; idx += blockDim.x) {
    const int i = idx / G::CH, c = idx - i * G::CH;
    const float* x = dQs + i * G::RS + c * 8;
    uint4 w;
    w.x = pack(x[0] * scale, x[1] * scale);
    w.y = pack(x[2] * scale, x[3] * scale);
    w.z = pack(x[4] * scale, x[5] * scale);
    w.w = pack(x[6] * scale, x[7] * scale);
    *reinterpret_cast<uint4*>(in.row(dq, b, i) + h * D + c * 8) = w;
  }
}

}  // namespace tc

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

template <int D, int L>
int fwd_launch_tc(const void* a, const void* b, const void* c, void* out, int batch, int n,
                  int heads, float scale, cudaStream_t stream) {
  using tc::bf16;
  const QKV<const bf16> in = split<L>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                      static_cast<const bf16*>(c), heads * D);
  const size_t smem = tc::fwd_bytes(n, D);
  int rc = prepare(tc::attn_fwd_kernel<D, L>, smem);
  if (rc) return rc;
  const int warps = tc::warps_for((n + 15) / 16);
  tc::attn_fwd_kernel<D, L><<<batch * heads, 32 * warps, smem, stream>>>(
      in.q, in.k, in.v, static_cast<bf16*>(out), batch, n, heads, scale);
  return (int)cudaGetLastError();
}

template <int D, int L>
int bwd_launch_tc(const void* a, const void* b, const void* c, const void* dout, void* da,
                  void* db, void* dc, int batch, int n, int heads, float scale,
                  cudaStream_t stream) {
  using tc::bf16;
  const QKV<const bf16> in = split<L>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                      static_cast<const bf16*>(c), heads * D);
  const QKV<bf16> grad = split<L>(static_cast<bf16*>(da), static_cast<bf16*>(db),
                                  static_cast<bf16*>(dc), heads * D);
  const size_t smem = tc::bwd_bytes(n, D);
  int rc = prepare(tc::attn_bwd_kernel<D, L>, smem);
  if (rc) return rc;
  const int warps = tc::warps_for((n + 15) / 16);
  tc::attn_bwd_kernel<D, L><<<batch * heads, 32 * warps, smem, stream>>>(
      in.q, in.k, in.v, static_cast<const bf16*>(dout), grad.q, grad.k, grad.v, batch, n,
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

// dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core body).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a head size,
// length or dtype the kernels do not take).
template <int L>
int attn_fwd(const void* a, const void* b, const void* c, void* out, int batch, int n,
             int heads, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VST_FWD_BF16(D) return fwd_launch_tc<D, L>(a, b, c, out, batch, n, heads, scale, s)
#define VST_FWD_F32(D) return fwd_launch<float, D, L>(a, b, c, out, batch, n, heads, scale, s)
  if (dtype == 1) { VST_SWITCH_D(d, VST_FWD_BF16) }
  if (dtype == 0) { VST_SWITCH_D(d, VST_FWD_F32) }
  return (int)cudaErrorInvalidValue;
#undef VST_FWD_BF16
#undef VST_FWD_F32
}

// rowstats: float32 scratch of (batch * heads * n, 4) for the f32 body's two
// launches; the bf16 body keeps its statistics on chip and does not read it.
template <int L>
int attn_bwd(const void* a, const void* b, const void* c, const void* dout, void* da,
             void* db, void* dc, void* rowstats, int batch, int n, int heads, int d,
             float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VST_BWD_BF16(D) \
  return bwd_launch_tc<D, L>(a, b, c, dout, da, db, dc, batch, n, heads, scale, s)
#define VST_BWD_F32(D)                                                                    \
  return bwd_launch<float, D, L>(a, b, c, dout, da, db, dc, rowstats, batch, n, heads,    \
                                 scale, s)
  if (dtype == 1) { VST_SWITCH_D(d, VST_BWD_BF16) }
  if (dtype == 0) {
    if (!rowstats) return (int)cudaErrorInvalidValue;
    VST_SWITCH_D(d, VST_BWD_F32)
  }
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

// Largest dynamic shared memory the kernels of `dtype` need at (n, d), so the
// caller can refuse a shape before launching.
long long vst_attn_smem_bytes(int n, int d, int dtype) {
  size_t a, b;
  if (dtype == 1) {
    a = tc::fwd_bytes(n, d);
    b = tc::bwd_bytes(n, d);
  } else {
    a = fwd_smem(n, d);
    b = dq_smem(n, d) > dkv_smem(n, d) ? dq_smem(n, d) : dkv_smem(n, d);
  }
  return (long long)(a > b ? a : b);
}

}  // extern "C"
