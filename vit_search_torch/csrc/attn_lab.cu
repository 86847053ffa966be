// The attention lab's kernels for Hopper (sm_90a): a forward whose context dot
// is formed transposed, a backward in one launch, and a backward split into a
// dq kernel and a dk/dv kernel that share nothing.
//
// Replaces the Pallas TPU kernels of vit_search_tpu/tools/attn_lab.py:
//   K10   _fwd_kernel_T (attn_lab.py:55),  called through call_fwd   (:82-91)
//   K11   _bwd_kernel_T (attn_lab.py:27),  called through call_bwd   (:70-79)
//   K12a  _dq_kernel    (attn_lab.py:123), called through call_split (:168-185)
//   K12b  _dkv_kernel   (attn_lab.py:146), called through call_split (:168-185)
//
// Layout (W = H * D): the packed projection qkv (B, N, 3W) with column blocks
// [q | k | v], each ordered by head, and dout (B, N, W). K10 writes out
// (B, N, W); K11 the packed dqkv (B, N, 3W); K12a dq (B, N, W); K12b dkv
// (B, N, 2W) with column blocks [dk | dv], as _dkv_kernel writes them
// (attn_lab.py:164-165).
//
// Math, per (example, head):
//   K10       s = q k^T * scale; p = softmax_rows(s); o = p v with p NOT
//             rounded: the lab lifts v to p's f32 (attn_lab.py:65), where K1
//             rounds p to v's dtype (attention.cu), so in bf16 K10 is not K1's
//             function. o is stored in the dtype of qkv.
//   K11, K12  K2's function: dv = p^T do; dp = do v^T; delta = rowsum(dp * p);
//             ds = p * (dp - delta); dq = ds k * scale; dk = ds^T q * scale.
//   K10 and K11 keep p and ds at f32 precision in both dtypes; the bf16 K12
//   rounds as K2's tensor-core body (p and ds bf16 only as MMA operands).
//
// What bounds them on this card: as for K1/K2, the function is bound by bytes
// at the tensor cores' rate (about 4*N*D flops per (example, head) and row in
// the forward, 10*N*D in the backward, against 8*D and 14*D bytes).
//
// Two bodies per kernel, chosen by dtype:
//   bfloat16  the tensor-core bodies of attention_tc.cuh, on the packed
//             layout. K10 and K11 are K1's two-pass forward and K2's
//             one-launch backward instantiated with kF32P: p and ds go into
//             their products as bf16 hi/lo pairs (x_hi = bf16(x), x_lo =
//             bf16(x - x_hi)), both products summed in the f32 accumulators,
//             so they keep the lab's f32 function to about 2^-16 of each p
//             and ds where one bf16 operand would round them to 2^-8. That
//             is four N^2*D products in the forward for K1's three, ten in
//             the backward for K2's seven; the MMAs stay far under the bytes
//             bound. Their shared memory is K1's and K2's, so K10 takes N up
//             to 1376 and K11 up to 624 at D = 32 (one launch by definition:
//             past that it refuses, it takes no split route). The "T" of the
//             TPU kernels, the sequence on lanes with one swapaxes per
//             result, is a TPU layout trick; these bodies keep the function
//             and store along rows. K12a and K12b are the split bodies, the
//             ones that also carry K2 past its one-launch body's N limit:
//             the same instantiation, with the lab's output strides.
//   float32   the CUDA-core bodies below, all in f32, whose dot products on
//             the CUDA cores are their limit.
//
// Design of the float32 (CUDA-core) bodies. The TPU keeps whole (N, N) f32
// score tiles in VMEM; at N = 258 one is 266 KB, more than the 227 KB of
// shared memory a block can have. A block owns one (example, head) and stages what it reads
// for every row as f32, rows padded to D + 1 floats so that lanes walking rows
// hit distinct banks. Arrays read with lanes over their rows but indexed along
// the sequence have a row stride of n | 1, odd for the same reason.
//   K10   The TPU puts the sequence on lanes so that (d, n) results fill its
//         128-wide tiles. Here the block walks the queries in tiles of 32:
//         (1) warp per query row: scores over all keys, exact two-pass
//             softmax, the f32 row of p into the tile's P;
//         (2) o^T for the tile: lanes over the tile's queries, each warp over
//             every 8th column of the head, o[i][c] = sum_j P[i][j] V[j][c]
//             (V read as a broadcast);
//         (3) the tile of o through shared memory to a store with lanes along
//             each row, coalesced; a store with lanes over rows would be
//             strided by W. This stands in for the TPU's one swapaxes.
//   K11   One launch, as the TPU's one pallas_call. The sum over queries that
//         forms dk and dv cannot be carried from block to block as the TPU's
//         sequential grid carries it; the block carries it over its own walk
//         of the query tiles in shared memory, dK^T and dV^T as (D, n | 1) f32
//         accumulators with the sequence on lanes, each element owned by one
//         thread. Per tile of 32 queries:
//         (1) stage the tile's q and do;
//         (2) warp per query row: s, p, dp, delta and ds into the tile's P and
//             dS, in K2's f32 operation order;
//         (3) dq^T: lanes over the tile's queries as K10's o^T, through shared
//             memory to a coalesced store;
//         (4) dK^T += dS^T q and dV^T += P^T do: lanes over keys, warps over
//             columns, summed over the queries in ascending order as K2's
//             dk/dv pass sums them.
//         dk and dv are stored from dK^T and dV^T at the end, lanes along
//         rows. At N = 258, D = 32 the block holds K and V (66.5 KB), dK^T
//         and dV^T (64.8 KB), P and dS (64.8 KB), and the tile's q, do and
//         dq (12.4 KB): 208.4 KB of 227 KB, one block per SM. It fits, so it
//         is not split.
//   K12a  (f32) Warp per query row as K2's f32 dq pass; dq goes to its own
//         (B, N, W) tensor, and no row statistics are written.
//   K12b  (f32) Shares nothing with K12a: the lab's _dkv_kernel recomputes s
//         and p itself (attn_lab.py:158-162). The block stages q, k, v and do,
//         then
//         (1) warp per query row over all keys: each row's max, sum and delta
//             into shared memory (K2's dq pass without the dq product);
//         (2) warp per key row over all queries, as K2's dk/dv pass: p and ds
//             from those statistics, dk and dv summed over every query.
//         At N = 258, D = 32: q, k, v, do 136.2 KB, statistics 3.1 KB, the
//         warps' rows 16.5 KB.
// N is any length up to what shared memory holds (every loop masks its ragged
// end); D is a template constant (8, 16, 32, 48, 64, 128) so the per-row
// vectors live in registers. The JAX lab's group size g (_pick_group) budgets
// VMEM per grid cell and has no counterpart here: the block per (example,
// head) is the same at every shape.

#include "attention_tc.cuh"

#include <type_traits>

namespace {

constexpr int kTile = 32;             // query rows per tile in K10 and K11: one per lane

// kernel codes of vst_lab_launch and vst_lab_smem_bytes
enum Which { kFwdT = 0, kBwdT = 1, kDq = 2, kDkv = 3 };

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Store f32 shared rows 0..rows-1 (row stride `stride`) to columns [0, D) of
// global rows (token stride `row_stride`), lanes along each row.
template <typename T, int D>
__device__ __forceinline__ void store_rows(const float* __restrict__ src, int stride, int rows,
                                           T* __restrict__ dst, long long row_stride) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[(long long)r * row_stride + c] = from_f<T>(src[r * stride + c]);
  }
}

// A transposed-output product for one tile of queries: with lanes over the
// tile's `rows` query rows and each warp over every kWarps-th column,
// dst[i][c] = mul * sum_j A[i][j] B[j][c] (A row stride as, B row stride bs,
// dst row stride ds), summed over j in ascending order.
template <int D>
__device__ __forceinline__ void tile_product(const float* __restrict__ a, int as, int n,
                                             const float* __restrict__ bm, int bs, float mul,
                                             float* __restrict__ dst, int ds, int rows) {
  constexpr int CW = (D + kWarps - 1) / kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane >= rows) return;
  const float* ar = a + lane * as;
  float acc[CW];
#pragma unroll
  for (int t = 0; t < CW; ++t) acc[t] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float aj = ar[j];
#pragma unroll
    for (int t = 0; t < CW; ++t) {
      const int c = warp + kWarps * t;
      if (c < D) acc[t] = fmaf(aj, bm[j * bs + c], acc[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < CW; ++t) {
    const int c = warp + kWarps * t;
    if (c < D) dst[lane * ds + c] = acc[t] * mul;
  }
}

// K10: o = softmax(q k^T * scale) v with p kept in f32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lab_fwd_t_kernel(const T* __restrict__ qkv, T* __restrict__ out, int n, int heads,
                 float scale) {
  constexpr int KS = D + 1;
  extern __shared__ float smem[];
  const int ps = n | 1;
  float* Ks = smem;              // n x KS
  float* Vs = Ks + n * KS;       // n x D
  float* P = Vs + n * D;         // kTile x ps: the tile's probabilities
  float* Os = P + kTile * ps;    // kTile x KS: the tile's output
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int w = heads * D;
  const long long row3 = 3LL * w;
  const T* base = qkv + (long long)b * n * row3 + h * D;
  T* obase = out + (long long)b * n * w + h * D;
  stage(base + w, row3, n, D, Ks, KS);
  stage(base + 2 * w, row3, n, D, Vs, D);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = 0; i0 < n; i0 += kTile) {
    const int rows = min(kTile, n - i0);
    __syncthreads();  // staging done; the last tile's Os stored
    for (int r = warp; r < rows; r += kWarps) {
      const T* qr = base + (long long)(i0 + r) * row3;
      float qv[D];
#pragma unroll
      for (int c = 0; c < D; ++c) qv[c] = to_f(qr[c]);
      float* pr = P + r * ps;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) {
        const float* kr = Ks + j * KS;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < D; ++c) s = fmaf(qv[c], kr[c], s);
        s *= scale;
        pr[j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(pr[j] - mx);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < n; j += 32) pr[j] = pr[j] / sum;
    }
    __syncthreads();
    tile_product<D>(P, ps, n, Vs, D, 1.f, Os, KS, rows);
    __syncthreads();
    store_rows<T, D>(Os, KS, rows, obase + (long long)i0 * w, w);
  }
}

// K11: the packed dqkv in one launch.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lab_bwd_t_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
                 int n, int heads, float scale) {
  constexpr int KS = D + 1;
  constexpr int CW = (D + kWarps - 1) / kWarps;
  extern __shared__ float smem[];
  const int ns = n | 1;
  float* Ks = smem;              // n x KS
  float* Vs = Ks + n * KS;       // n x KS
  float* dKt = Vs + n * KS;      // D x ns: sum over queries of ds^T q, the sequence on lanes
  float* dVt = dKt + D * ns;     // D x ns: sum over queries of p^T do
  float* P = dVt + D * ns;       // kTile x ns: the tile's probabilities
  float* dS = P + kTile * ns;    // kTile x ns: the tile's dp, then ds
  float* Qs = dS + kTile * ns;   // kTile x KS: the tile's q
  float* Gs = Qs + kTile * KS;   // kTile x KS: the tile's do
  float* dQs = Gs + kTile * KS;  // kTile x KS: the tile's dq
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int w = heads * D;
  const long long row3 = 3LL * w;
  const T* base = qkv + (long long)b * n * row3 + h * D;
  const T* gbase = dout + (long long)b * n * w + h * D;
  T* dbase = dqkv + (long long)b * n * row3 + h * D;
  stage(base + w, row3, n, D, Ks, KS);
  stage(base + 2 * w, row3, n, D, Vs, KS);
  for (int idx = threadIdx.x; idx < D * ns; idx += kThreads) dKt[idx] = dVt[idx] = 0.f;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = 0; i0 < n; i0 += kTile) {
    const int rows = min(kTile, n - i0);
    __syncthreads();  // the last tile's P, dS, Qs and Gs read and its dQs stored
    stage(base + (long long)i0 * row3, row3, rows, D, Qs, KS);
    stage(gbase + (long long)i0 * w, w, rows, D, Gs, KS);
    __syncthreads();
    for (int r = warp; r < rows; r += kWarps) {
      float qv[D], g[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        qv[c] = Qs[r * KS + c];
        g[c] = Gs[r * KS + c];
      }
      float* pr = P + r * ns;
      float* dr = dS + r * ns;
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
        pr[j] = s;
        dr[j] = d;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float e = expf(pr[j] - mx);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      float delta = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float pj = pr[j] / sum;
        pr[j] = pj;
        delta += pj * dr[j];
      }
      delta = warp_sum(delta);
      for (int j = lane; j < n; j += 32) dr[j] = pr[j] * (dr[j] - delta);
    }
    __syncthreads();
    // dq^T for the tile, and the tile's share of dK^T and dV^T: both read
    // P, dS, Qs, Gs and K, and write disjoint arrays
    tile_product<D>(dS, ns, n, Ks, KS, scale, dQs, KS, rows);
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      if (j >= n) break;
      float ak[CW], av[CW];
#pragma unroll
      for (int t = 0; t < CW; ++t) {
        const int c = warp + kWarps * t;
        if (c < D) {
          ak[t] = dKt[c * ns + j];
          av[t] = dVt[c * ns + j];
        }
      }
      for (int r = 0; r < rows; ++r) {
        const float pr = P[r * ns + j], dsr = dS[r * ns + j];
#pragma unroll
        for (int t = 0; t < CW; ++t) {
          const int c = warp + kWarps * t;
          if (c < D) {
            av[t] = fmaf(pr, Gs[r * KS + c], av[t]);
            ak[t] = fmaf(dsr, Qs[r * KS + c], ak[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < CW; ++t) {
        const int c = warp + kWarps * t;
        if (c < D) {
          dKt[c * ns + j] = ak[t];
          dVt[c * ns + j] = av[t];
        }
      }
    }
    __syncthreads();
    store_rows<T, D>(dQs, KS, rows, dbase + (long long)i0 * row3, row3);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int j = idx / D, c = idx - j * D;
    T* row = dbase + (long long)j * row3;
    row[w + c] = from_f<T>(dKt[c * ns + j] * scale);
    row[2 * w + c] = from_f<T>(dVt[c * ns + j]);
  }
}

// K12a: dq alone, warp per query row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lab_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dq, int n,
              int heads, float scale) {
  constexpr int KS = D + 1;
  constexpr int CD = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Ks = smem;             // n x KS
  float* Vs = Ks + n * KS;      // n x KS
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int w = heads * D;
  const long long row3 = 3LL * w;
  const T* base = qkv + (long long)b * n * row3 + h * D;
  const T* gbase = dout + (long long)b * n * w + h * D;
  T* dbase = dq + (long long)b * n * w + h * D;
  stage(base + w, row3, n, D, Ks, KS);
  stage(base + 2 * w, row3, n, D, Vs, KS);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = Vs + n * KS + warp * 2 * n;
  float* dp = p + n;
  for (int i = warp; i < n; i += kWarps) {
    const T* qr = base + (long long)i * row3;
    const T* gr = gbase + (long long)i * w;
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
    T* drow = dbase + (long long)i * w;
#pragma unroll
    for (int t = 0; t < CD; ++t) {
      const int c = lane + 32 * t;
      if (c < D) drow[c] = from_f<T>(acc[t] * scale);
    }
    __syncwarp();
  }
}

// K12b: dk and dv, with every query row's statistics recomputed in the block.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
lab_dkv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dkv,
               int n, int heads, float scale) {
  constexpr int KS = D + 1;
  constexpr int CD = (D + 31) / 32;
  extern __shared__ float smem[];
  float* Qs = smem;             // n x KS
  float* Ks = Qs + n * KS;      // n x KS
  float* Vs = Ks + n * KS;      // n x KS
  float* Gs = Vs + n * KS;      // n x KS
  float* Mx = Gs + n * KS;      // n
  float* Sum = Mx + n;          // n
  float* Delta = Sum + n;       // n
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int w = heads * D;
  const long long row3 = 3LL * w;
  const T* base = qkv + (long long)b * n * row3 + h * D;
  T* dbase = dkv + (long long)b * n * 2 * w + h * D;
  stage(base, row3, n, D, Qs, KS);
  stage(base + w, row3, n, D, Ks, KS);
  stage(base + 2 * w, row3, n, D, Vs, KS);
  stage(dout + (long long)b * n * w + h * D, w, n, D, Gs, KS);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* p = Delta + n + warp * 2 * n;  // this warp's two rows
  float* dp = p + n;
  // (1) each query row's max, sum and delta
  for (int i = warp; i < n; i += kWarps) {
    float qv[D], g[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      qv[c] = Qs[i * KS + c];
      g[c] = Gs[i * KS + c];
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
      delta += pj * dp[j];
    }
    delta = warp_sum(delta);
    if (lane == 0) {
      Mx[i] = mx;
      Sum[i] = sum;
      Delta[i] = delta;
    }
    __syncwarp();
  }
  __syncthreads();

  // (2) dk and dv, warp per key row, summed over every query
  float* ds = dp;
  for (int j = warp; j < n; j += kWarps) {
    float kv[D], vv[D];
#pragma unroll
    for (int c = 0; c < D; ++c) {
      kv[c] = Ks[j * KS + c];
      vv[c] = Vs[j * KS + c];
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
    T* row = dbase + (long long)j * 2 * w;
#pragma unroll
    for (int t = 0; t < CD; ++t) {
      const int c = lane + 32 * t;
      if (c < D) {
        row[c] = from_f<T>(acck[t] * scale);
        row[w + c] = from_f<T>(accv[t]);
      }
    }
    __syncwarp();
  }
}

// Dynamic shared memory of kernel `which` at (n, d) and dtype (0 = float32:
// the CUDA-core bodies; 1 = bfloat16: the tensor-core bodies of
// attention_tc.cuh, K10 and K11 the one-launch ones, K12a and K12b the split).
size_t smem_bytes(int which, int n, int d, int dtype) {
  const size_t ks = (size_t)d + 1, odd = (size_t)(n | 1), rows = (size_t)n;
  const bool tensor_cores = dtype == 1;
  switch (which) {
    case kFwdT:
      if (tensor_cores) return tc::fwd_bytes(n, d);
      return sizeof(float) * (rows * (ks + d) + kTile * odd + kTile * ks);
    case kBwdT:
      if (tensor_cores) return tc::bwd_bytes(n, d);
      return sizeof(float) * (2 * rows * ks + 2 * (size_t)d * odd + 2 * kTile * odd +
                              3 * kTile * ks);
    case kDq:
      if (tensor_cores) return tc::split_dq_bytes(n, d);
      return sizeof(float) * (2 * rows * ks + 2 * kWarps * rows);
    case kDkv:
      if (tensor_cores) return tc::split_dkv_bytes(n, d);
      return sizeof(float) * (4 * rows * ks + 3 * rows + 2 * kWarps * rows);
    default: return 0;
  }
}

// The bf16 kernels: the tensor-core bodies of attention_tc.cuh on the packed
// qkv. K10 and K11 are the one-launch forward and backward with p and ds as
// hi/lo pairs (kF32P), storing out (batch, n, W) and the packed dqkv (batch,
// n, 3W); K12a and K12b the split bodies, storing dq into (batch, n, W) and
// [dk | dv] into (batch, n, 2W).
template <int DP>
int launch_tc(int which, const tc::bf16* x, const tc::bf16* g, tc::bf16* y, int batch, int n,
              int heads, int d, float scale, size_t smem, cudaStream_t stream) {
  const int w = heads * d, blocks = batch * heads;
  const int threads = 32 * tc::warps_for((n + 15) / 16);
  int rc;
  if (which == kFwdT) {
    if ((rc = prepare(tc::attn_fwd_kernel<DP, kPacked, true>, smem))) return rc;
    tc::attn_fwd_kernel<DP, kPacked, true><<<blocks, threads, smem, stream>>>(
        x, x + w, x + 2 * w, y, batch, n, heads, d, scale);
  } else if (which == kBwdT) {
    if ((rc = prepare(tc::attn_bwd_kernel<DP, kPacked, true>, smem))) return rc;
    tc::attn_bwd_kernel<DP, kPacked, true><<<blocks, threads, smem, stream>>>(
        x, x + w, x + 2 * w, g, y, y + w, y + 2 * w, batch, n, heads, d, scale);
  } else if (which == kDq) {
    if ((rc = prepare(tc::attn_split_dq_kernel<DP, kPacked>, smem))) return rc;
    tc::attn_split_dq_kernel<DP, kPacked><<<blocks, threads, smem, stream>>>(
        x, x + w, x + 2 * w, g, y, Strides{w, (long long)n * w}, batch, n, heads, d, scale);
  } else {
    if ((rc = prepare(tc::attn_split_dkv_kernel<DP, kPacked>, smem))) return rc;
    tc::attn_split_dkv_kernel<DP, kPacked><<<blocks, threads, smem, stream>>>(
        x, x + w, x + 2 * w, g, y, y + w, Strides{2LL * w, 2LL * n * w}, batch, n, heads, d,
        scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(int which, const void* qkv, const void* dout, void* out, int batch, int n,
           int heads, float scale, cudaStream_t stream) {
  constexpr bool is_bf16 = std::is_same<T, tc::bf16>::value;
  const T* x = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* y = static_cast<T*>(out);
  const int blocks = batch * heads;
  const size_t smem = smem_bytes(which, n, D, is_bf16 ? 1 : 0);
  if (which < kFwdT || which > kDkv) return (int)cudaErrorInvalidValue;
  if constexpr (is_bf16) {
    return launch_tc<(D + 15) / 16 * 16>(which, x, g, y, batch, n, heads, D, scale, smem, stream);
  } else {
    int rc;
    if (which == kFwdT) {
      if ((rc = prepare(lab_fwd_t_kernel<T, D>, smem))) return rc;
      lab_fwd_t_kernel<T, D><<<blocks, kThreads, smem, stream>>>(x, y, n, heads, scale);
    } else if (which == kBwdT) {
      if ((rc = prepare(lab_bwd_t_kernel<T, D>, smem))) return rc;
      lab_bwd_t_kernel<T, D><<<blocks, kThreads, smem, stream>>>(x, g, y, n, heads, scale);
    } else if (which == kDq) {
      if ((rc = prepare(lab_dq_kernel<T, D>, smem))) return rc;
      lab_dq_kernel<T, D><<<blocks, kThreads, smem, stream>>>(x, g, y, n, heads, scale);
    } else {
      if ((rc = prepare(lab_dkv_kernel<T, D>, smem))) return rc;
      lab_dkv_kernel<T, D><<<blocks, kThreads, smem, stream>>>(x, g, y, n, heads, scale);
    }
    return (int)cudaGetLastError();
  }
}

}  // namespace

#define VST_LAB_SWITCH_D(T)                                                       \
  switch (d) {                                                                    \
    case 8: return launch<T, 8>(which, qkv, dout, out, batch, n, heads, scale, s);     \
    case 16: return launch<T, 16>(which, qkv, dout, out, batch, n, heads, scale, s);   \
    case 32: return launch<T, 32>(which, qkv, dout, out, batch, n, heads, scale, s);   \
    case 48: return launch<T, 48>(which, qkv, dout, out, batch, n, heads, scale, s);   \
    case 64: return launch<T, 64>(which, qkv, dout, out, batch, n, heads, scale, s);   \
    case 128: return launch<T, 128>(which, qkv, dout, out, batch, n, heads, scale, s); \
    default: return (int)cudaErrorInvalidValue;                                   \
  }

extern "C" {

// Launch one lab kernel on the packed projection qkv (batch, n, 3 * heads * d):
//   which 0 (K10): out (batch, n, heads * d); dout unused
//   which 1 (K11): out = dqkv (batch, n, 3 * heads * d)
//   which 2 (K12a): out = dq (batch, n, heads * d)
//   which 3 (K12b): out = dkv (batch, n, 2 * heads * d), columns [dk | dv]
// dout is (batch, n, heads * d). dtype: 0 = float32, 1 = bfloat16. Returns
// cudaGetLastError() (or cudaErrorInvalidValue for a kernel code, head size,
// length or dtype the kernels do not take).
int vst_lab_launch(int which, const void* qkv, const void* dout, void* out, int batch, int n,
                   int heads, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) { VST_LAB_SWITCH_D(__nv_bfloat16) }
  if (dtype == 0) { VST_LAB_SWITCH_D(float) }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory the kernel `which` needs at (n, d) in `dtype`, so the
// caller can refuse a shape before launching.
long long vst_lab_smem_bytes(int which, int n, int d, int dtype) {
  return (long long)smem_bytes(which, n, d, dtype);
}

}  // extern "C"

#undef VST_LAB_SWITCH_D
