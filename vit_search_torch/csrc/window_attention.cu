// Windowed scaled-cosine attention with a learned position bias (SwinV2's
// WindowAttention), forward and backward, for Hopper (sm_90a).
//
// No TPU kernel precedes it: the JAX package has no windowed attention. The
// function, per window w (B * nW of them, each of N = ws * ws tokens) and
// head h, on the packed projection qkv (B * nW, N, 3C), C = H * d:
//   q' = scale_h * q / |q|,  k' = k / |k|          (|.| over the head dim)
//   s  = q' k'^T + bias[h] + mask_w                 (f32)
//   p  = softmax_rows(s), rounded to bf16;  out = p v  (summed in f32)
// scale_h = exp(min(logit_scale_h, ln 100)) comes in as a vector, bias as the
// (H, N, N) table 16 * sigmoid(cpb_mlp(...)) gathered by the relative index,
// and mask_w as each token's region id in window w % nW of a shifted block
// (-100 between tokens of different regions, the function of Swin's
// (nW, N, N) attn_mask, which is never read). The backward returns dqkv, the
// bias's gradient summed over every window of every image, and the scale's.
//
// Launches (d = 32, N = 16, 64 or 256, bf16):
//   prep fwd   a thread per (token, head): |q|, |k| in f32; q', k' and a copy
//              of v into a packed qkvn (B * nW, N, 3C); 1/|q| and 1/|k| kept.
//   fwd        out from qkvn (below).
//   dq         dq' = dS k', and each query row's max, 1 / sum and delta
//              into a (B * nW * H * N, 4) f32 scratch for the next launch.
//   dkv        dk' = dS^T q', dv = P^T dO; the bias's gradient partials.
//   prep bwd   in place over dqkvn: dq = (scale * dq' - q' (q'.dq') / scale)
//              / |q|, dk = (dk' - k' (k'.dk')) / |k|; the scale's partials
//              sum (q'.dq') / scale over each block's tokens.
//   fold (x2)  each partial array summed over its first axis in a fixed
//              order: the bias's and the scale's gradients.
// No launch uses atomics, so every run gives the same bits.
//
// Design of fwd, dq and dkv. The tensor-core helpers of attention_tc.cuh
// (mma.sync m16n8k16, bf16 operands, f32 accumulators; rows in shared memory
// at the padded stride RS = 40, 16-byte cp.async, ldmatrix) and its split
// backward's plan: dq and dk/dv in separate launches, neither keeping an f32
// dQ nor using atomics. What is new is the bias. Per (window, head) it is
// an N x N table, 4 * N^2 bytes (256 KB at N = 256) against 8 * N * d bytes
// of q, k and v (64 KB): streamed from L2 for every window it would be most
// of the traffic. So a block is persistent: it owns one head and one part of
// the N rows (8 tiles of 16 rows, a warp each; N = 256 has two parts), keeps
// the bias of those rows in shared memory in f32 for the whole launch (132
// KB at N = 256), and walks a group of windows, w = group, group + groups,
// ... The launch has groups * H * parts blocks, one per SM.
//   fwd   K and V of the window resident; a warp's 16 query rows make two
//         passes over the keys (max and sum, then O += P V), as attention_tc's
//         forward does, the scores in log2 units from (s + bias + mask).
//   dq    K and V resident; a warp's rows: max, sum and delta = sum p dp in
//         one pass over the keys (written to the scratch), then dS and dq'.
//   dkv   Q and dO of the window resident, the statistics read back; a
//         warp owns 16 keys, walks every query tile (S^T, P^T, dP^T, dS^T,
//         dV += P^T dO, dK += dS^T Q) and adds dS^T in f32 to its registers'
//         share of the bias gradient: N / 16 tiles of 16 x 16 (128 floats a
//         lane at N = 256). The block's bias rows are kept transposed (its
//         keys by every query). After its last window each lane writes its
//         share once into the group's (H, N, N) partial; the fold sums the
//         groups.
// The rounding is attention_tc's: p and ds are bf16 only as MMA operands,
// delta comes from the f32 accumulators, ds is formed in f32; the bias's
// gradient sums the f32 ds. q' and k' are rounded to bf16 once, in the prep.

#include "attention_tc.cuh"

namespace {
namespace wa {

using tc::bf16;
constexpr int DP = 32;                  // the head dim this file takes
using G = tc::Geom<DP>;
constexpr int RS = G::RS;
constexpr float kMaskFill = -100.f;     // Swin's fill between regions
constexpr float kNormEps = 1e-12f;      // F.normalize's

// A window of TILES 16-row tiles, cut into parts of up to 8 tiles (a warp
// each); the bias rows of a part are held at stride BS floats, which keeps
// a warp's float2 reads of a C fragment free of bank conflicts.
template <int TILES>
struct Win {
  static constexpr int N = TILES * 16;
  static constexpr int RB = TILES < 8 ? TILES : 8;
  static constexpr int PARTS = TILES / RB;
  static constexpr int BS = N + 8;
  static constexpr size_t bias_bytes = sizeof(float) * RB * 16 * BS;
  static constexpr size_t tile_bytes = sizeof(bf16) * 16 * RS;
  static constexpr size_t rows_bytes = sizeof(bf16) * N * RS;
  // K and V resident, a Q tile per warp (fwd) or a Q and a dO tile (dq)
  static constexpr size_t fwd_smem = bias_bytes + 2 * rows_bytes + RB * tile_bytes + 4 * N;
  static constexpr size_t dq_smem = bias_bytes + 2 * rows_bytes + 2 * RB * tile_bytes + 4 * N;
  // Q and dO resident, a K and a V tile per warp, the statistics
  static constexpr size_t dkv_smem =
      bias_bytes + 2 * rows_bytes + 2 * RB * tile_bytes + 3 * 4 * N + 4 * N;
};

// The block's (group, head, part).
struct Slot {
  int group, h, part;
};

__device__ __forceinline__ Slot slot_of(int heads, int parts) {
  const int per = heads * parts, r = blockIdx.x % per;
  return {(int)(blockIdx.x / per), r / parts, r % parts};
}

// Region ids of window w's tokens into shared memory (none unmasked).
template <int N>
__device__ __forceinline__ void load_regions(int* rg, const int* regions, int w, int nwin) {
  if (!regions) return;
  const int* src = regions + (long long)(w % nwin) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) rg[i] = src[i];
}

// S (16 x 16) in log2 units for a warp's 16 query rows against keys
// n0..n0+15: (q'.k' + bias + mask) * log2 e. `bq` is the bias row of the
// warp's first query, `rq` the region of rows g and g + 8.
template <int BS>
__device__ __forceinline__ void scores(float (&s)[2][4], const uint32_t (&qa)[G::KT][4],
                                       const bf16* ks, const float* bq, const int* rg,
                                       bool masked, const int (&rq)[2], int n0, int lane) {
  tc::dot_rows<DP>(s, qa, ks, n0, lane);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int key = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 b = *reinterpret_cast<const float2*>(bq + (g + 8 * r) * BS + key);
      float m0 = 0.f, m1 = 0.f;
      if (masked) {
        m0 = rg[key] != rq[r] ? kMaskFill : 0.f;
        m1 = rg[key + 1] != rq[r] ? kMaskFill : 0.f;
      }
      s[j][2 * r] = (s[j][2 * r] + b.x + m0) * tc::kLog2e;
      s[j][2 * r + 1] = (s[j][2 * r + 1] + b.y + m1) * tc::kLog2e;
    }
  }
}

// The part's bias rows [row0, row0 + 16 * RB) of head h, at stride BS ...
template <int TILES>
__device__ __forceinline__ void load_bias_rows(float* bs, const float* bias, int h, int row0) {
  using W = Win<TILES>;
  const float* src = bias + ((long long)h * W::N + row0) * W::N;
  for (int idx = threadIdx.x; idx < W::RB * 16 * W::N; idx += blockDim.x) {
    const int r = idx / W::N, j = idx - r * W::N;
    bs[r * W::BS + j] = src[(long long)r * W::N + j];
  }
}

// ... and its columns [col0, col0 + 16 * RB), transposed: bt[key][query].
template <int TILES>
__device__ __forceinline__ void load_bias_cols(float* bt, const float* bias, int h, int col0) {
  using W = Win<TILES>;
  const float* src = bias + (long long)h * W::N * W::N + col0;
  for (int idx = threadIdx.x; idx < W::RB * 16 * W::N; idx += blockDim.x) {
    const int i = idx / (W::RB * 16), kl = idx - i * (W::RB * 16);
    bt[kl * W::BS + i] = src[(long long)i * W::N + kl];
  }
}

template <int TILES>
__global__ void __launch_bounds__(kThreads, 1)
wattn_fwd_kernel(const bf16* __restrict__ qkvn, const float* __restrict__ bias,
                 const int* __restrict__ regions, bf16* __restrict__ out, int bw, int heads,
                 int nwin, int groups) {
  using W = Win<TILES>;
  constexpr int N = W::N;
  extern __shared__ __align__(16) unsigned char wa_smem[];
  float* Bs = reinterpret_cast<float*>(wa_smem);
  bf16* Ks = reinterpret_cast<bf16*>(wa_smem + W::bias_bytes);
  bf16* Vs = Ks + N * RS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  bf16* Qs = Vs + N * RS + warp * 16 * RS;
  int* Rg = reinterpret_cast<int*>(Vs + N * RS + W::RB * 16 * RS);
  const Slot sl = slot_of(heads, W::PARTS);
  const int c = heads * DP, qt = sl.part * W::RB + warp;
  const Strides in = qkv_strides<kPacked>(bw, N, c);
  const Strides wide = wide_strides<kPacked>(bw, N, c);
  load_bias_rows<TILES>(Bs, bias, sl.h, sl.part * W::RB * 16);
  const float* bq = Bs + warp * 16 * W::BS;
  const bool masked = regions != nullptr;

  for (int w = sl.group; w < bw; w += groups) {
    __syncthreads();
    tc::load_rows<DP>(Ks, qkvn + c, in, w, sl.h, DP, 0, N, N, threadIdx.x, blockDim.x);
    tc::load_rows<DP>(Vs, qkvn + 2 * c, in, w, sl.h, DP, 0, N, N, threadIdx.x, blockDim.x);
    tc::load_rows<DP>(Qs, qkvn, in, w, sl.h, DP, qt * 16, 16, N, lane, 32);
    tc::cp_async_commit();
    load_regions<N>(Rg, regions, w, nwin);
    tc::cp_async_wait_all();
    __syncthreads();
    uint32_t qa[G::KT][4];
    tc::load_a<DP>(qa, Qs, 0, lane);
    const int rq[2] = {masked ? Rg[qt * 16 + g] : 0, masked ? Rg[qt * 16 + g + 8] : 0};

    // pass 1: each thread's running max and sum for rows g and g + 8
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
#pragma unroll 4
    for (int kt = 0; kt < TILES; ++kt) {
      float s[2][4];
      scores<W::BS>(s, qa, Ks, bq, Rg, masked, rq, kt * 16, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = fmaxf(fmaxf(mx[r], fmaxf(s[0][2 * r], s[0][2 * r + 1])),
                              fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        sm[r] = sm[r] * tc::exp2_fast(mx[r] - m) + tc::exp2_fast(s[0][2 * r] - m) +
                tc::exp2_fast(s[0][2 * r + 1] - m) + tc::exp2_fast(s[1][2 * r] - m) +
                tc::exp2_fast(s[1][2 * r + 1] - m);
        mx[r] = m;
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m = tc::quad_max(mx[r]);
      inv[r] = 1.f / tc::quad_sum(sm[r] * tc::exp2_fast(mx[r] - m));
      mx[r] = m;
    }

    // pass 2: p normalised and rounded to bf16, O += P V
    float o[G::NT][4];
    tc::zero<DP>(o);
#pragma unroll 4
    for (int kt = 0; kt < TILES; ++kt) {
      float s[2][4];
      scores<W::BS>(s, qa, Ks, bq, Rg, masked, rq, kt * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = tc::exp2_fast(s[j][e] - mx[e >> 1]) * inv[e >> 1];
      uint32_t pa[1][4];
      tc::to_a(pa, s);
      tc::acc_rows<DP, 1>(o, pa, Vs, kt * 16, lane);
    }
    __syncwarp();
    tc::put_rows<DP>(Qs, o, 1.f, lane);
    __syncwarp();
    tc::store_rows<DP>(out, wide, w, sl.h, DP, Qs, qt * 16, 16, N, lane, 32);
  }
}

template <int TILES>
__global__ void __launch_bounds__(kThreads, 1)
wattn_dq_kernel(const bf16* __restrict__ qkvn, const float* __restrict__ bias,
                const int* __restrict__ regions, const bf16* __restrict__ dout,
                bf16* __restrict__ dqkvn, float4* __restrict__ stats, int bw, int heads,
                int nwin, int groups) {
  using W = Win<TILES>;
  constexpr int N = W::N;
  extern __shared__ __align__(16) unsigned char wa_smem[];
  float* Bs = reinterpret_cast<float*>(wa_smem);
  bf16* Ks = reinterpret_cast<bf16*>(wa_smem + W::bias_bytes);
  bf16* Vs = Ks + N * RS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* Qs = Vs + N * RS + warp * 32 * RS;
  bf16* Gs = Qs + 16 * RS;
  int* Rg = reinterpret_cast<int*>(Vs + N * RS + W::RB * 32 * RS);
  const Slot sl = slot_of(heads, W::PARTS);
  const int c = heads * DP, qt = sl.part * W::RB + warp;
  const Strides in = qkv_strides<kPacked>(bw, N, c);
  const Strides wide = wide_strides<kPacked>(bw, N, c);
  load_bias_rows<TILES>(Bs, bias, sl.h, sl.part * W::RB * 16);
  const float* bq = Bs + warp * 16 * W::BS;
  const bool masked = regions != nullptr;

  for (int w = sl.group; w < bw; w += groups) {
    __syncthreads();
    tc::load_rows<DP>(Ks, qkvn + c, in, w, sl.h, DP, 0, N, N, threadIdx.x, blockDim.x);
    tc::load_rows<DP>(Vs, qkvn + 2 * c, in, w, sl.h, DP, 0, N, N, threadIdx.x, blockDim.x);
    tc::load_rows<DP>(Qs, qkvn, in, w, sl.h, DP, qt * 16, 16, N, lane, 32);
    tc::load_rows<DP>(Gs, dout, wide, w, sl.h, DP, qt * 16, 16, N, lane, 32);
    tc::cp_async_commit();
    load_regions<N>(Rg, regions, w, nwin);
    tc::cp_async_wait_all();
    __syncthreads();
    uint32_t qa[G::KT][4], ga[G::KT][4];
    tc::load_a<DP>(qa, Qs, 0, lane);
    tc::load_a<DP>(ga, Gs, 0, lane);
    const int rq[2] = {masked ? Rg[qt * 16 + g] : 0, masked ? Rg[qt * 16 + g + 8] : 0};

    // each row's max, sum and delta = sum p dp (sum and delta rescaled as
    // the max moves), as attention_tc's row_stats
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
#pragma unroll 4
    for (int kt = 0; kt < TILES; ++kt) {
      float s[2][4], dp[2][4];
      scores<W::BS>(s, qa, Ks, bq, Rg, masked, rq, kt * 16, lane);
      tc::dot_rows<DP>(dp, ga, Vs, kt * 16, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mr = fmaxf(fmaxf(mx[r], fmaxf(s[0][2 * r], s[0][2 * r + 1])),
                               fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        const float corr = tc::exp2_fast(mx[r] - mr);
        float es = 0.f, ed = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float x = tc::exp2_fast(s[j][e] - mr);
            es += x;
            ed = fmaf(x, dp[j][e], ed);
          }
        sm[r] = sm[r] * corr + es;
        dd[r] = dd[r] * corr + ed;
        mx[r] = mr;
      }
    }
    float m[2], il[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mr = tc::quad_max(mx[r]), f = tc::exp2_fast(mx[r] - mr);
      const float l = tc::quad_sum(sm[r] * f), dsum = tc::quad_sum(dd[r] * f);
      m[r] = mr;
      il[r] = 1.f / l;
      dl[r] = dsum / l;
      if (t == 0)
        stats[((long long)w * heads + sl.h) * N + qt * 16 + g + 8 * r] =
            make_float4(m[r], il[r], dl[r], 0.f);
    }

    // dq' = dS k'
    float dqa[G::NT][4];
    tc::zero<DP>(dqa);
#pragma unroll 4
    for (int kt = 0; kt < TILES; ++kt) {
      float s[2][4], dp[2][4];
      scores<W::BS>(s, qa, Ks, bq, Rg, masked, rq, kt * 16, lane);
      tc::dot_rows<DP>(dp, ga, Vs, kt * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = tc::exp2_fast(s[j][e] - m[e >> 1]) * il[e >> 1];
          dp[j][e] = pv * (dp[j][e] - dl[e >> 1]);
        }
      uint32_t dsa[1][4];
      tc::to_a(dsa, dp);
      tc::acc_rows<DP, 1>(dqa, dsa, Ks, kt * 16, lane);
    }
    __syncwarp();
    tc::put_rows<DP>(Qs, dqa, 1.f, lane);
    __syncwarp();
    tc::store_rows<DP>(dqkvn, in, w, sl.h, DP, Qs, qt * 16, 16, N, lane, 32);
  }
}

template <int TILES>
__global__ void __launch_bounds__(kThreads, 1)
wattn_dkv_kernel(const bf16* __restrict__ qkvn, const float* __restrict__ bias,
                 const int* __restrict__ regions, const bf16* __restrict__ dout,
                 const float4* __restrict__ stats, bf16* __restrict__ dqkvn,
                 float* __restrict__ dbias_part, int bw, int heads, int nwin, int groups) {
  using W = Win<TILES>;
  constexpr int N = W::N;
  extern __shared__ __align__(16) unsigned char wa_smem[];
  float* Bt = reinterpret_cast<float*>(wa_smem);
  bf16* Qs = reinterpret_cast<bf16*>(wa_smem + W::bias_bytes);
  bf16* Gs = Qs + N * RS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16* Ka = Gs + N * RS + warp * 32 * RS;
  bf16* Va = Ka + 16 * RS;
  float* M = reinterpret_cast<float*>(Gs + N * RS + W::RB * 32 * RS);
  float* IL = M + N;
  float* DL = IL + N;
  int* Rg = reinterpret_cast<int*>(DL + N);
  const Slot sl = slot_of(heads, W::PARTS);
  const int c = heads * DP, kb = sl.part * W::RB + warp;
  const Strides in = qkv_strides<kPacked>(bw, N, c);
  const Strides wide = wide_strides<kPacked>(bw, N, c);
  load_bias_cols<TILES>(Bt, bias, sl.h, sl.part * W::RB * 16);
  const bool masked = regions != nullptr;
  float db[TILES][2][4];
#pragma unroll
  for (int qt = 0; qt < TILES; ++qt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) db[qt][j][e] = 0.f;

  for (int w = sl.group; w < bw; w += groups) {
    __syncthreads();
    tc::load_rows<DP>(Qs, qkvn, in, w, sl.h, DP, 0, N, N, threadIdx.x, blockDim.x);
    tc::load_rows<DP>(Gs, dout, wide, w, sl.h, DP, 0, N, N, threadIdx.x, blockDim.x);
    tc::load_rows<DP>(Ka, qkvn + c, in, w, sl.h, DP, kb * 16, 16, N, lane, 32);
    tc::load_rows<DP>(Va, qkvn + 2 * c, in, w, sl.h, DP, kb * 16, 16, N, lane, 32);
    tc::cp_async_commit();
    load_regions<N>(Rg, regions, w, nwin);
    const float4* st = stats + ((long long)w * heads + sl.h) * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const float4 v = st[i];
      M[i] = v.x;
      IL[i] = v.y;
      DL[i] = v.z;
    }
    tc::cp_async_wait_all();
    __syncthreads();
    int rk[2] = {0, 0};
    if (masked) {
      rk[0] = Rg[kb * 16 + g];
      rk[1] = Rg[kb * 16 + g + 8];
    }
    float dka[G::NT][4], dva[G::NT][4];
    tc::zero<DP>(dka);
    tc::zero<DP>(dva);
#pragma unroll
    for (int qt = 0; qt < TILES; ++qt) {
      const bf16* Qt = Qs + qt * 16 * RS;
      const bf16* Gt = Gs + qt * 16 * RS;
      uint32_t ka[G::KT][4], va[G::KT][4];
      tc::load_a<DP>(ka, Ka, 0, lane);
      tc::load_a<DP>(va, Va, 0, lane);
      float s[2][4], dp[2][4];
      tc::dot_rows<DP>(s, ka, Qt, 0, lane);   // S^T: rows keys, columns queries
      tc::dot_rows<DP>(dp, va, Gt, 0, lane);  // dP^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = qt * 16 + 8 * j + 2 * t;   // queries i, i + 1
          const float2 b = *reinterpret_cast<const float2*>(Bt + (warp * 16 + g + 8 * r) * W::BS + i);
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int e = 2 * r + cc;
            float x = s[j][e] + (cc ? b.y : b.x);
            if (masked && Rg[i + cc] != rk[r]) x += kMaskFill;
            const float pv = tc::exp2_fast(x * tc::kLog2e - M[i + cc]) * IL[i + cc];
            const float ds = pv * (dp[j][e] - DL[i + cc]);
            s[j][e] = pv;
            dp[j][e] = ds;
            db[qt][j][e] += ds;
          }
        }
      uint32_t pa[1][4], dsa[1][4];
      tc::to_a(pa, s);    // P^T
      tc::to_a(dsa, dp);  // dS^T
      tc::acc_rows<DP, 1>(dva, pa, Gt, 0, lane);
      tc::acc_rows<DP, 1>(dka, dsa, Qt, 0, lane);
    }
    __syncwarp();
    tc::put_rows<DP>(Ka, dka, 1.f, lane);
    tc::put_rows<DP>(Va, dva, 1.f, lane);
    __syncwarp();
    tc::store_rows<DP>(dqkvn + c, in, w, sl.h, DP, Ka, kb * 16, 16, N, lane, 32);
    tc::store_rows<DP>(dqkvn + 2 * c, in, w, sl.h, DP, Va, kb * 16, 16, N, lane, 32);
  }

  // this lane's share of the group's bias gradient: [h][query i][key]
  float* dst = dbias_part + ((long long)sl.group * heads + sl.h) * N * N;
#pragma unroll
  for (int qt = 0; qt < TILES; ++qt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = qt * 16 + 8 * j + 2 * t + (e & 1), key = kb * 16 + g + 8 * (e >> 1);
        dst[(long long)i * N + key] = db[qt][j][e];
      }
}

// Eight bf16 of a 16-byte chunk as floats, and back.
__device__ __forceinline__ void unpack8(float (&f)[8], uint4 u) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8], float mul) {
  uint4 u;
  uint32_t* p = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = tc::pack(f[2 * i] * mul, f[2 * i + 1] * mul);
  return u;
}

// A head's 32 columns of one token (four 16-byte chunks) as floats.
__device__ __forceinline__ void load32(float (&f)[4][8], const bf16* src) {
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) unpack8(f[ch], reinterpret_cast<const uint4*>(src)[ch]);
}

__device__ __forceinline__ float dot32(const float (&a)[4][8], const float (&b)[4][8]) {
  float s = 0.f;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(a[ch][i], b[ch][i], s);
  return s;
}

// A thread per (token, head): q' = scale * q / |q|, k' = k / |k|, v copied.
__global__ void __launch_bounds__(kThreads)
wattn_prep_fwd_kernel(const bf16* __restrict__ qkv, const float* __restrict__ scale,
                      bf16* __restrict__ qkvn, float2* __restrict__ rn, long long items,
                      int heads) {
  const int c = heads * DP;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < items;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / heads;
    const int h = (int)(idx - row * heads);
    const long long at = row * 3 * c + h * DP;
    float q[4][8], k[4][8];
    load32(q, qkv + at);
    load32(k, qkv + at + c);
    const float rq = 1.f / fmaxf(sqrtf(dot32(q, q)), kNormEps);
    const float rk = 1.f / fmaxf(sqrtf(dot32(k, k)), kNormEps);
    const float fq = scale[h] * rq;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      reinterpret_cast<uint4*>(qkvn + at)[ch] = pack8(q[ch], fq);
      reinterpret_cast<uint4*>(qkvn + at + c)[ch] = pack8(k[ch], rk);
      reinterpret_cast<uint4*>(qkvn + at + 2 * c)[ch] =
          reinterpret_cast<const uint4*>(qkv + at + 2 * c)[ch];
    }
    rn[idx] = make_float2(rq, rk);
  }
}

// In place over dqkvn, a thread per (token, head): dq' and dk' to dq and dk
// (dv is already in place); each block's sum of (q'.dq') / scale per head.
// The grid's stride is a multiple of `heads` (256 % heads == 0), so each
// thread keeps one head.
__global__ void __launch_bounds__(kThreads)
wattn_prep_bwd_kernel(const bf16* __restrict__ qkvn, const float* __restrict__ scale,
                      const float2* __restrict__ rn, bf16* __restrict__ dqkvn,
                      float* __restrict__ dscale_part, long long items, int heads) {
  __shared__ float red[kThreads];
  const int c = heads * DP;
  float acc = 0.f;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < items;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long row = idx / heads;
    const int h = (int)(idx - row * heads);
    const long long at = row * 3 * c + h * DP;
    const float s = scale[h];
    const float2 r = rn[idx];
    float x[4][8], dx[4][8];
    load32(x, qkvn + at);
    load32(dx, dqkvn + at);
    float dot = dot32(x, dx) / s;
    acc += dot;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (s * dx[ch][i] - x[ch][i] * dot) * r.x;
      reinterpret_cast<uint4*>(dqkvn + at)[ch] = pack8(o, 1.f);
    }
    load32(x, qkvn + at + c);
    load32(dx, dqkvn + at + c);
    dot = dot32(x, dx);
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (dx[ch][i] - x[ch][i] * dot) * r.y;
      reinterpret_cast<uint4*>(dqkvn + at + c)[ch] = pack8(o, 1.f);
    }
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < heads) {
    float sum = 0.f;
    for (int i = threadIdx.x; i < kThreads; i += heads) sum += red[i];
    dscale_part[(long long)blockIdx.x * heads + threadIdx.x] = sum;
  }
}

// out[i] = sum over g < groups of part[g * m + i], in order of g.
__global__ void __launch_bounds__(kThreads)
wattn_fold_kernel(const float* __restrict__ part, float* __restrict__ out, int groups,
                  long long m) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int gi = 0; gi < groups; ++gi) s += part[gi * m + i];
    out[i] = s;
  }
}

int fold(const float* part, float* out, int groups, long long m, cudaStream_t stream) {
  const long long blocks = (m + kThreads - 1) / kThreads;
  wattn_fold_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
      part, out, groups, m);
  return (int)cudaGetLastError();
}

template <int TILES>
int fwd(const bf16* qkvn, const float* bias, const int* regions, bf16* out, int bw, int heads,
        int nwin, int groups, cudaStream_t stream) {
  using W = Win<TILES>;
  int rc = prepare(wattn_fwd_kernel<TILES>, W::fwd_smem);
  if (rc) return rc;
  wattn_fwd_kernel<TILES><<<groups * heads * W::PARTS, 32 * W::RB, W::fwd_smem, stream>>>(
      qkvn, bias, regions, out, bw, heads, nwin, groups);
  return (int)cudaGetLastError();
}

template <int TILES>
int bwd(const bf16* qkvn, const float* bias, const int* regions, const bf16* dout, bf16* dqkvn,
        float4* stats, float* dbias_part, float* dbias, int bw, int heads, int nwin,
        int groups, cudaStream_t stream) {
  using W = Win<TILES>;
  const int blocks = groups * heads * W::PARTS;
  int rc = prepare(wattn_dq_kernel<TILES>, W::dq_smem);
  if (rc) return rc;
  wattn_dq_kernel<TILES><<<blocks, 32 * W::RB, W::dq_smem, stream>>>(
      qkvn, bias, regions, dout, dqkvn, stats, bw, heads, nwin, groups);
  if ((rc = (int)cudaGetLastError())) return rc;
  if ((rc = prepare(wattn_dkv_kernel<TILES>, W::dkv_smem))) return rc;
  wattn_dkv_kernel<TILES><<<blocks, 32 * W::RB, W::dkv_smem, stream>>>(
      qkvn, bias, regions, dout, stats, dqkvn, dbias_part, bw, heads, nwin, groups);
  if ((rc = (int)cudaGetLastError())) return rc;
  return fold(dbias_part, dbias, groups, (long long)heads * W::N * W::N, stream);
}

}  // namespace wa
}  // namespace

#define VST_WA_SWITCH_N(n, CALL)                \
  switch (n) {                                  \
    case 16: CALL(1);                           \
    case 64: CALL(4);                           \
    case 256: CALL(16);                         \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// The forward. qkv (bw, n, 3 * heads * d) bf16; scale (heads,) f32; bias
// (heads, n, n) f32; regions (nwin, n) int32 or null (no mask). Writes qkvn
// (bw, n, 3 * heads * d) bf16, rn (bw * n * heads, 2) f32 and out (bw, n,
// heads * d) bf16. `groups` windows share a block's bias rows; `prep_blocks`
// is the prep launch's grid.
int vst_wattn_fwd(const void* qkv, const void* scale, const void* bias, const void* regions,
                  void* qkvn, void* rn, void* out, int bw, int n, int heads, int d, int nwin,
                  int groups, int prep_blocks, void* stream) {
  using namespace wa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != DP || kThreads % heads || groups < 1 || prep_blocks < 1 || nwin < 1 || bw % nwin)
    return (int)cudaErrorInvalidValue;
  wattn_prep_fwd_kernel<<<prep_blocks, kThreads, 0, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(scale), static_cast<bf16*>(qkvn),
      static_cast<float2*>(rn), (long long)bw * n * heads, heads);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
#define VST_WA_FWD(T)                                                                      \
  return fwd<T>(static_cast<const bf16*>(qkvn), static_cast<const float*>(bias),           \
                static_cast<const int*>(regions), static_cast<bf16*>(out), bw, heads, nwin, \
                groups, s)
  VST_WA_SWITCH_N(n, VST_WA_FWD)
#undef VST_WA_FWD
}

// The backward, from the forward's qkvn and rn and the output's cotangent
// dout (bw, n, heads * d): dqkv (bw, n, 3 * heads * d) bf16, dbias (heads, n,
// n) f32, dscale (heads,) f32. Scratch: stats (bw * heads * n, 4) f32,
// dbias_part (groups, heads, n, n) f32, dscale_part (prep_blocks, heads) f32.
int vst_wattn_bwd(const void* qkvn, const void* scale, const void* bias, const void* regions,
                  const void* rn, const void* dout, void* dqkv, void* stats, void* dbias_part,
                  void* dbias, void* dscale_part, void* dscale, int bw, int n, int heads, int d,
                  int nwin, int groups, int prep_blocks, void* stream) {
  using namespace wa;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d != DP || kThreads % heads || groups < 1 || prep_blocks < 1 || nwin < 1 || bw % nwin)
    return (int)cudaErrorInvalidValue;
  int rc;
#define VST_WA_BWD(T)                                                                         \
  rc = bwd<T>(static_cast<const bf16*>(qkvn), static_cast<const float*>(bias),                \
              static_cast<const int*>(regions), static_cast<const bf16*>(dout),               \
              static_cast<bf16*>(dqkv), static_cast<float4*>(stats),                          \
              static_cast<float*>(dbias_part), static_cast<float*>(dbias), bw, heads, nwin,   \
              groups, s);                                                                     \
  break
  VST_WA_SWITCH_N(n, VST_WA_BWD)
#undef VST_WA_BWD
  if (rc) return rc;
  wattn_prep_bwd_kernel<<<prep_blocks, kThreads, 0, s>>>(
      static_cast<const bf16*>(qkvn), static_cast<const float*>(scale),
      static_cast<const float2*>(rn), static_cast<bf16*>(dqkv),
      static_cast<float*>(dscale_part), (long long)bw * n * heads, heads);
  if ((rc = (int)cudaGetLastError())) return rc;
  return fold(static_cast<const float*>(dscale_part), static_cast<float*>(dscale),
              prep_blocks, heads, s);
}

}  // extern "C"

#undef VST_WA_SWITCH_N
