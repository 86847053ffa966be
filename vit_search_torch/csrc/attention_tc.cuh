// What the attention kernels of attention.cu and attn_lab.cu share: the
// layouts and their strides, the f32 staging helpers, the bf16 tensor-core
// helpers, the one-launch forward and backward bodies, and the two bodies of
// the split backward.
//
// The one-launch bodies (their design is described in attention.cu) carry
// K1/K2, K6/K7 and K8/K9 there, and the lab's K10 and K11 in attn_lab.cu,
// by a compile-time flag kF32P:
//   false  p (forward), and p and ds (backward), go into their products as
//          one bf16 operand each: K1/K2's rounding. attention.cu
//          instantiates only this.
//   true   each goes in as a pair x_hi = bf16(x), x_lo = bf16(x - x_hi)
//          (to_a over P = 2 parts), both products summed in the f32
//          accumulators against the same B fragments: x keeps about 16
//          bits, within 2^-16 |x| of its f32 value, so the lab's f32
//          function holds where one bf16 operand would move it. The
//          forward runs four N^2*D products for three, the backward ten
//          for seven; dS is split before movmatrix transposes it, so dQ
//          sees the parts dK saw. attn_lab.cu instantiates only this, on
//          the packed layout. The inputs q, k, v and do are bf16 already,
//          so they need no lo half.
//
// The split backward replaces the JAX lab's pair (vit_search_tpu/tools/
// attn_lab.py):
//   K12a  _dq_kernel  (attn_lab.py:123): dq alone          -> attn_split_dq_kernel
//   K12b  _dkv_kernel (attn_lab.py:146): dk and dv, each   -> attn_split_dkv_kernel
//         query row's statistics recomputed
// and carries K2, K7 and K9 (attention.cu) where their one-launch backward does
// not fit in shared memory. Both bodies read q, k, v and dout in one of the
// three layouts (template parameter L) and write through strides given at run
// time, so the same instantiation stores into a packed, separate or
// sequence-major cotangent, or into the lab's own dq (B, N, W) and [dk | dv]
// (B, N, 2W).
//
// Design of the split (bf16 operands, f32 accumulators, mma.sync m16n8k16; a
// block per (example, head), 1-8 warps, rows padded as for the one-launch
// bodies). Neither body keeps an f32 dQ in shared memory, neither uses atomics
// or a barrier per step, so both are deterministic:
//   dq pass   K and V resident (4*N*R bytes, R = the padded row stride). A warp
//             owns 16 query rows, their Q and dO fragments in registers:
//             (1) S = Q K^T and dP = dO V^T over all keys: each row's max, sum
//                 and delta (the one-launch body's phase 1);
//             (2) S and dP again, then P and dS, and dQ += dS K in registers.
//             dQ * scale goes out through the warp's tile, along rows.
//   dk/dv     (1) as the dq pass's step (1), each row's max, 1 / sum and
//   pass          delta / sum into shared memory (12 bytes a row), K and V
//                 resident;
//             (2) Q and dO take K's and V's place, resident; a warp owns a key
//                 block of 16 rows (its K and V fragments reloaded from device
//                 memory, dK and dV in registers) and walks every query tile:
//                 S^T = K_blk Q^T, P^T, dP^T = V_blk dO^T, dS^T, dV += P^T dO,
//                 dK += dS^T Q. It walks them in the one-launch body's order
//                 (warp w from tile w on), so dk and dv have the one-launch
//                 body's bits.
//   Rounding, as the one-launch body's: p and ds are bf16 only as MMA
//   operands; delta = rowsum(dp * p) comes from the f32 accumulators and ds is
//   formed in f32 before the cast.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may opt into

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// Stage columns [0, d) of rows 0..n-1 from `rows` (token stride `row_stride`)
// into f32 shared memory with row stride `stride`, all kThreads threads of the
// block (a constant stride lets the compiler keep several loads in flight).
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ rows, long long row_stride, int n,
                                      int d, float* __restrict__ dst, int stride) {
  for (int idx = threadIdx.x; idx < n * d; idx += kThreads) {
    const int j = idx / d, c = idx - j * d;
    dst[j * stride + c] = to_f(rows[(long long)j * row_stride + c]);
  }
}

enum Layout { kPacked = 0, kSeparate = 1, kSeqMajor = 2 };

// The strides, in elements, of one operand: element (example b, token i,
// column c) is at base[b * ex + i * tok + c].
struct Strides {
  long long tok, ex;
  template <typename P>
  __device__ __forceinline__ P* row(P* base, int b, int i) const {
    return base + (long long)b * ex + (long long)i * tok;
  }
};

// q, k, v and their cotangents in layout L (rows of 3W in packed and
// sequence-major, of W in separate) ...
template <int L>
__host__ __device__ __forceinline__ Strides qkv_strides(int batch, int n, int w) {
  const long long w3 = 3LL * w;
  if (L == kSeparate) return {w, (long long)n * w};
  if (L == kSeqMajor) return {batch * w3, w3};
  return {w3, n * w3};
}

// ... and out and dout (rows of W).
template <int L>
__host__ __device__ __forceinline__ Strides wide_strides(int batch, int n, int w) {
  if (L == kSeqMajor) return {(long long)batch * w, w};
  return {w, (long long)n * w};
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// --- bfloat16 tensor-core helpers --------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// Rows of a head in shared memory: DP columns (the head dim d padded with
// zeros to a multiple of the MMA's k of 16), row stride RS = DP + 8 elements
// (bf16) or floats (f32). 8 rows at that stride start in 8 distinct 16-byte
// bank groups, so the 8 row addresses of an ldmatrix, and float2 accesses of
// a C fragment, are free of conflicts. The real d (a multiple of 8, at most
// DP) is a run-time argument: columns past it are zero on load and never
// stored.
template <int DP_>
struct Geom {
  static_assert(DP_ % 16 == 0 && DP_ >= 16 && DP_ <= 128, "padded head dim");
  static constexpr int DP = DP_;
  static constexpr int RS = DP + 8;
  static constexpr int KT = DP / 16;    // k steps over the head dim
  static constexpr int NT = DP / 8;     // n tiles of 8 over the head dim
  static constexpr int CHP = DP / 8;    // 16-byte chunks of a row in shared memory
};

// warps of a block over `tiles` 16-row tiles: up to 8, spread evenly
inline int warps_for(int tiles) {
  const int rounds = (tiles + kWarps - 1) / kWarps;
  return (tiles + rounds - 1) / rounds;
}

inline size_t rs_of(int d) { return (size_t)((d + 15) / 16 * 16 + 8); }

// Shared memory of the one-launch forward: K and V, a Q tile per warp ...
inline size_t fwd_bytes(int n, int d) {
  const size_t tiles = (n + 15) / 16, rs = rs_of(d);
  return sizeof(bf16) * rs * 16 * (2 * tiles + warps_for((int)tiles));
}

// ... and of the one-launch backward: K and V, the ring of Q and dO tiles,
// the f32 dQ and each query row's three statistics.
inline size_t bwd_bytes(int n, int d) {
  const size_t tiles = (n + 15) / 16, rs = rs_of(d), np = 16 * tiles;
  return sizeof(bf16) * rs * (2 * np + 2 * 16 * (warps_for((int)tiles) + 1)) +
         sizeof(float) * (np * rs + 3 * np);
}

// Shared memory of the split's dq pass: K and V, a Q and a dO tile per warp.
inline size_t split_dq_bytes(int n, int d) {
  const size_t tiles = (n + 15) / 16, rs = rs_of(d);
  return sizeof(bf16) * rs * (2 * 16 * tiles + 2 * 16 * warps_for((int)tiles));
}

// ... of its dk/dv pass: the same, and each query row's three statistics.
inline size_t split_dkv_bytes(int n, int d) {
  return split_dq_bytes(n, d) + sizeof(float) * 3 * 16 * ((n + 15) / 16);
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

// The A fragments of a C pair in P bf16 parts. P = 1: x rounded to bf16, as
// above. P = 2: the pair x_hi = bf16(x), x_lo = bf16(x - x_hi) (x - x_hi is
// exact in f32), whose two products summed in the f32 accumulators come
// within about 2^-16 |x| of x's own, where bf16(x) alone is 2^-8 off.
template <int P>
__device__ __forceinline__ void to_a(uint32_t (&a)[P][4], const float (&c)[2][4]) {
  static_assert(P == 1 || P == 2, "a bf16 operand, or a hi/lo pair");
  to_a(a[0], c);
  if constexpr (P == 2) {
    float r[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float2 h =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[0][2 * j + e / 2]));
        r[j][e] = c[j][e] - h.x;
        r[j][e + 1] = c[j][e + 1] - h.y;
      }
    to_a(a[1], r);
  }
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
template <int DP>
__device__ __forceinline__ const bf16* at_rows(const bf16* x, int r0, int c0, int lane) {
  return x + (r0 + (lane & 15)) * Geom<DP>::RS + c0 + ((lane >> 4) << 3);
}
// ... and as the B operand of two n tiles of 8 when stored [n][k] (ldsm4).
template <int DP>
__device__ __forceinline__ const bf16* at_cols(const bf16* x, int n0, int k0, int lane) {
  return x + (n0 + (lane & 7) + ((lane >> 4) << 3)) * Geom<DP>::RS + k0 + (lane & 8);
}

// The A fragments of 16 rows of a tile, over the padded head dim.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[Geom<DP>::KT][4], const bf16* x, int r0,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < Geom<DP>::KT; ++ks) ldsm4(a[ks], at_rows<DP>(x, r0, ks * 16, lane));
}

// s (16 x 16) = A (16 x DP) times rows n0..n0+15 of x (DP wide), transposed.
template <int DP>
__device__ __forceinline__ void dot_rows(float (&s)[2][4], const uint32_t (&a)[Geom<DP>::KT][4],
                                         const bf16* x, int n0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Geom<DP>::KT; ++ks) {
    uint32_t b[4];
    ldsm4(b, at_cols<DP>(x, n0, ks * 16, lane));
    mma(s[0], a[ks], b[0], b[1]);
    mma(s[1], a[ks], b[2], b[3]);
  }
}

// acc (16 x DP) += a (16 x 16, the sum of its P bf16 parts) times rows
// k0..k0+15 of x (DP wide), the B fragments loaded once for all parts.
template <int DP, int P>
__device__ __forceinline__ void acc_rows(float (&acc)[Geom<DP>::NT][4], const uint32_t (&a)[P][4],
                                         const bf16* x, int k0, int lane) {
#pragma unroll
  for (int dp = 0; dp < Geom<DP>::KT; ++dp) {
    uint32_t b[4];
    ldsm4_t(b, at_rows<DP>(x, k0, dp * 16, lane));
#pragma unroll
    for (int part = 0; part < P; ++part) {
      mma(acc[2 * dp], a[part], b[0], b[1]);
      mma(acc[2 * dp + 1], a[part], b[2], b[3]);
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero(float (&acc)[Geom<DP>::NT][4]) {
#pragma unroll
  for (int j = 0; j < Geom<DP>::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// cp.async rows row0..row0+rows-1 of one operand (head h of example b, head
// dim d) into a shared tile, zero past n and past d; threads `tid` of `count`
// share it.
template <int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, const Strides& st, int b,
                                          int h, int d, int row0, int rows, int n, int tid,
                                          int count) {
  using G = Geom<DP>;
  const int ch = d >> 3;
  for (int idx = tid; idx < rows * G::CHP; idx += count) {
    const int r = idx / G::CHP, c = idx - r * G::CHP, i = row0 + r;
    const bool valid = i < n && c < ch;
    cp_async16(dst + r * G::RS + c * 8, valid ? st.row(base, b, i) + h * d + c * 8 : base,
               valid);
  }
}

// Rows row0.. (< n), columns [0, d), of a bf16 shared tile to one operand, 16
// bytes a lane (the loop runs over the padded width, so it divides by a
// constant).
template <int DP>
__device__ __forceinline__ void store_rows(bf16* base, const Strides& st, int b, int h, int d,
                                           const bf16* src, int row0, int rows, int n, int tid,
                                           int count) {
  using G = Geom<DP>;
  const int ch = d >> 3;
  for (int idx = tid; idx < rows * G::CHP; idx += count) {
    const int r = idx / G::CHP, c = idx - r * G::CHP, i = row0 + r;
    if (i < n && c < ch)
      *reinterpret_cast<uint4*>(st.row(base, b, i) + h * d + c * 8) =
          *reinterpret_cast<const uint4*>(src + r * G::RS + c * 8);
  }
}

// A C fragment set (16 x DP, f32) times `mul`, to rows of a bf16 shared tile.
template <int DP>
__device__ __forceinline__ void put_rows(bf16* x, const float (&acc)[Geom<DP>::NT][4], float mul,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < Geom<DP>::NT; ++j) {
    bf16* r = x + g * Geom<DP>::RS + 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(r) = pack(acc[j][0] * mul, acc[j][1] * mul);
    *reinterpret_cast<uint32_t*>(r + 8 * Geom<DP>::RS) = pack(acc[j][2] * mul, acc[j][3] * mul);
  }
}

// S (16 x 16) for 16 rows of A against keys n0..n0+15, in log2 units
// (s * scale * log2 e), keys at or past n at -inf.
template <int DP>
__device__ __forceinline__ void scores(float (&s)[2][4], const uint32_t (&a)[Geom<DP>::KT][4],
                                       const bf16* ks, int n0, int n, float sl2, int lane) {
  dot_rows<DP>(s, a, ks, n0, lane);
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

// Each of a warp's 16 query rows' statistics over all keys, from their Q and
// dO fragments: the max of s * scale * log2 e, 1 / sum and delta / sum (the
// sum and delta rescaled as the max moves). Thread (g, t) gets rows g (r = 0)
// and g + 8 (r = 1); the four threads of a quad get the same values.
template <int DP>
__device__ __forceinline__ void row_stats(float (&m)[2], float (&il)[2], float (&dl)[2],
                                          const uint32_t (&qa)[Geom<DP>::KT][4],
                                          const uint32_t (&ga)[Geom<DP>::KT][4], const bf16* Ks,
                                          const bf16* Vs, int tiles, int n, float sl2,
                                          int lane) {
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  for (int kt = 0; kt < tiles; ++kt) {
    float s[2][4], dp[2][4];
    scores<DP>(s, qa, Ks, kt * 16, n, sl2, lane);
    dot_rows<DP>(dp, ga, Vs, kt * 16, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mr = fmaxf(fmaxf(mx[r], fmaxf(s[0][2 * r], s[0][2 * r + 1])),
                             fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      const float base = base_of(mr), corr = exp2_fast(mx[r] - base);
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
      dd[r] = dd[r] * corr + ed;
      mx[r] = mr;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mr = quad_max(mx[r]), f = exp2_fast(mx[r] - mr);
    const float l = quad_sum(sm[r] * f), dsum = quad_sum(dd[r] * f);
    m[r] = mr;
    il[r] = 1.f / l;
    dl[r] = dsum / l;
  }
}

// One step of a key block's walk over the query tiles: with the block's K and
// V fragments (ka, va; keys kb*16..) and a query tile's 16 rows of q and dout
// at Qt and Gt (query rows qt*16..), and each query row's statistics M, IL and
// DL, S^T = K_blk Q^T, P^T, dP^T = V_blk dO^T, dS^T = P^T (dP^T - delta);
// dV += P^T dO, dK += dS^T Q. P^T and dS^T go into the products as P bf16
// parts (to_a); dS^T is left in dsa, the A fragments of the product.
template <int DP, int P>
__device__ __forceinline__ void kv_step(float (&dka)[Geom<DP>::NT][4],
                                        float (&dva)[Geom<DP>::NT][4], uint32_t (&dsa)[P][4],
                                        const uint32_t (&ka)[Geom<DP>::KT][4],
                                        const uint32_t (&va)[Geom<DP>::KT][4], const bf16* Qt,
                                        const bf16* Gt, const float* M, const float* IL,
                                        const float* DL, int qt, int kb, int n, float sl2,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  float s[2][4], dp[2][4];
  dot_rows<DP>(s, ka, Qt, 0, lane);   // S^T: rows keys, columns queries
  dot_rows<DP>(dp, va, Gt, 0, lane);  // dP^T
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
  uint32_t pa[P][4];
  to_a(pa, s);    // P^T
  to_a(dsa, dp);  // dS^T
  acc_rows<DP>(dva, pa, Gt, 0, lane);
  acc_rows<DP>(dka, dsa, Qt, 0, lane);
}

// --- the one-launch bodies ---------------------------------------------------

// The forward: out = softmax(q k^T * scale) v, p normalised in f32 and then
// rounded to bf16 (kF32P false: K1, K6, K8) or split into a hi/lo pair
// (kF32P true: the lab's K10, whose p stays f32).
template <int DP, int L, bool kF32P = false>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int batch, int n,
                int heads, int d, float scale) {
  using G = Geom<DP>;
  constexpr int P = kF32P ? 2 : 1;  // bf16 parts of each p operand
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tiles = (n + 15) >> 4, np = tiles * 16;
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);   // np x RS
  bf16* Vs = Ks + np * G::RS;                     // np x RS
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qs = Vs + np * G::RS + warp * 16 * G::RS;  // this warp's 16 x RS tile
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides in = qkv_strides<L>(batch, n, heads * d);
  const Strides wide = wide_strides<L>(batch, n, heads * d);
  load_rows<DP>(Ks, k, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  load_rows<DP>(Vs, v, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float sl2 = scale * kLog2e;
  for (int qt = warp; qt < tiles; qt += nw) {
    load_rows<DP>(Qs, q, in, b, h, d, qt * 16, 16, n, lane, 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    uint32_t qa[G::KT][4];
    load_a<DP>(qa, Qs, 0, lane);

    // pass 1: each thread's running max and sum for rows g and g + 8
    float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.f, 0.f};
    for (int kt = 0; kt < tiles; ++kt) {
      float s[2][4];
      scores<DP>(s, qa, Ks, kt * 16, n, sl2, lane);
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

    // pass 2: p normalised, as bf16 (or a hi/lo pair), O += P V
    float o[G::NT][4];
    zero<DP>(o);
    for (int kt = 0; kt < tiles; ++kt) {
      float s[2][4];
      scores<DP>(s, qa, Ks, kt * 16, n, sl2, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = exp2_fast(s[j][e] - mx[e >> 1]) * inv[e >> 1];
      uint32_t pa[P][4];
      to_a(pa, s);
      acc_rows<DP>(o, pa, Vs, kt * 16, lane);
    }
    __syncwarp();
    put_rows<DP>(Qs, o, 1.f, lane);
    __syncwarp();
    store_rows<DP>(out, wide, b, h, d, Qs, qt * 16, 16, n, lane, 32);
    __syncwarp();
  }
}

// The backward in one launch (q, k, v and their cotangents in layout L): p
// and ds go into the products as bf16 operands (kF32P false: K2, K7, K9) or
// as hi/lo pairs (kF32P true: the lab's K11, f32 throughout).
template <int DP, int L, bool kF32P = false>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                int batch, int n, int heads, int d, float scale) {
  using G = Geom<DP>;
  constexpr int P = kF32P ? 2 : 1;       // bf16 parts of each p and ds operand
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
  const Strides in = qkv_strides<L>(batch, n, heads * d);
  const Strides wide = wide_strides<L>(batch, n, heads * d);
  load_rows<DP>(Ks, k, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  load_rows<DP>(Vs, v, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
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
      load_rows<DP>(Qs, q, in, b, h, d, qt * 16, 16, n, lane, 32);
      load_rows<DP>(Gs, dout, wide, b, h, d, qt * 16, 16, n, lane, 32);
      cp_async_commit();
      cp_async_wait_all();
      __syncwarp();
      uint32_t qa[G::KT][4], ga[G::KT][4];
      load_a<DP>(qa, Qs, 0, lane);
      load_a<DP>(ga, Gs, 0, lane);
      __syncwarp();
      float m[2], il[2], dl[2];
      row_stats<DP>(m, il, dl, qa, ga, Ks, Vs, tiles, n, sl2, lane);
      if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = qt * 16 + g + 8 * r;
          M[i] = m[r];
          IL[i] = il[r];
          DL[i] = dl[r];
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
    load_rows<DP>(dst, q, in, b, h, d, row0, 16, n, threadIdx.x, blockDim.x);
    load_rows<DP>(dst + 16 * G::RS, dout, wide, b, h, d, row0, 16, n, threadIdx.x,
                  blockDim.x);
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
    zero<DP>(dka);
    zero<DP>(dva);
    if (active) {
      load_a<DP>(ka, Ks, kb * 16, lane);
      load_a<DP>(va, Vs, kb * 16, lane);
    }
    for (int step = 0; step < tiles; ++step) {
      const int sigma = r * tiles + step;
      load_slot(sigma + nw);  // the next step's new tile, into the slot this step frees
      cp_async_commit();
      if (active) {
        const int p = sigma + warp, qt = p % tiles;
        const bf16* Qs = ring + (p % (nw + 1)) * SLOT;
        uint32_t dsa[P][4];
        kv_step<DP>(dka, dva, dsa, ka, va, Qs, Qs + 16 * G::RS, M, IL, DL, qt, kb, n, sl2,
                    lane);
        // dS = (dS^T)^T, 8x8 block by block (each part: split before the
        // transpose, so dQ sees the parts dK saw), then dQ_tile += dS K_blk
        uint32_t dsq[P][4];
#pragma unroll
        for (int part = 0; part < P; ++part) {
          dsq[part][0] = transpose8(dsa[part][0]);
          dsq[part][1] = transpose8(dsa[part][2]);
          dsq[part][2] = transpose8(dsa[part][1]);
          dsq[part][3] = transpose8(dsa[part][3]);
        }
#pragma unroll
        for (int dpi = 0; dpi < G::KT; ++dpi) {
          uint32_t kb4[4];
          ldsm4_t(kb4, at_rows<DP>(Ks, kb * 16, dpi * 16, lane));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float* r0 = dQs + (qt * 16 + g) * G::RS + 8 * (2 * dpi + half) + 2 * t;
            float* r1 = r0 + 8 * G::RS;
            const float2 x0 = *reinterpret_cast<float2*>(r0), x1 = *reinterpret_cast<float2*>(r1);
            float c4[4] = {x0.x, x0.y, x1.x, x1.y};
#pragma unroll
            for (int part = 0; part < P; ++part)
              mma(c4, dsq[part], kb4[2 * half], kb4[2 * half + 1]);
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
      put_rows<DP>(dkr, dka, scale, lane);
      put_rows<DP>(dvr, dva, 1.f, lane);
      __syncwarp();
      store_rows<DP>(dk, in, b, h, d, dkr, kb * 16, 16, n, lane, 32);
      store_rows<DP>(dv, in, b, h, d, dvr, kb * 16, 16, n, lane, 32);
    }
  }

  // dQ * scale, 8 columns a thread
  const int ch = d >> 3;
  for (int idx = threadIdx.x; idx < n * G::CHP; idx += blockDim.x) {
    const int i = idx / G::CHP, c = idx - i * G::CHP;
    if (c >= ch) continue;
    const float* x = dQs + i * G::RS + c * 8;
    uint4 w;
    w.x = pack(x[0] * scale, x[1] * scale);
    w.y = pack(x[2] * scale, x[3] * scale);
    w.z = pack(x[4] * scale, x[5] * scale);
    w.w = pack(x[6] * scale, x[7] * scale);
    *reinterpret_cast<uint4*>(in.row(dq, b, i) + h * d + c * 8) = w;
  }
}

// --- the split backward ------------------------------------------------------

// dq = dS K * scale, stored through `dq_st` (rows of the cotangent dq points
// into, column h * d of each).
template <int DP, int L>
__global__ void __launch_bounds__(kThreads)
attn_split_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     bf16* __restrict__ dq, Strides dq_st, int batch, int n, int heads, int d,
                     float scale) {
  using G = Geom<DP>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tiles = (n + 15) >> 4, np = tiles * 16;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);       // np x RS
  bf16* Vs = Ks + np * G::RS;                         // np x RS
  bf16* Qs = Vs + np * G::RS + warp * 32 * G::RS;     // this warp's 16 rows of q ...
  bf16* Gs = Qs + 16 * G::RS;                         // ... and of dout
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides in = qkv_strides<L>(batch, n, heads * d);
  const Strides wide = wide_strides<L>(batch, n, heads * d);
  load_rows<DP>(Ks, k, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  load_rows<DP>(Vs, v, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float sl2 = scale * kLog2e;
  for (int qt = warp; qt < tiles; qt += nw) {
    load_rows<DP>(Qs, q, in, b, h, d, qt * 16, 16, n, lane, 32);
    load_rows<DP>(Gs, dout, wide, b, h, d, qt * 16, 16, n, lane, 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    uint32_t qa[G::KT][4], ga[G::KT][4];
    load_a<DP>(qa, Qs, 0, lane);
    load_a<DP>(ga, Gs, 0, lane);
    float m[2], il[2], dl[2];
    row_stats<DP>(m, il, dl, qa, ga, Ks, Vs, tiles, n, sl2, lane);

    float dqa[G::NT][4];
    zero<DP>(dqa);
    for (int kt = 0; kt < tiles; ++kt) {
      float s[2][4], dp[2][4];
      scores<DP>(s, qa, Ks, kt * 16, n, sl2, lane);
      dot_rows<DP>(dp, ga, Vs, kt * 16, lane);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = exp2_fast(s[j][e] - m[e >> 1]) * il[e >> 1];
          dp[j][e] = pv * (dp[j][e] - dl[e >> 1]);   // ds; 0 at keys past n
        }
      uint32_t dsa[1][4];
      to_a(dsa, dp);
      acc_rows<DP>(dqa, dsa, Ks, kt * 16, lane);
    }
    __syncwarp();
    put_rows<DP>(Qs, dqa, scale, lane);
    __syncwarp();
    store_rows<DP>(dq, dq_st, b, h, d, Qs, qt * 16, 16, n, lane, 32);
    __syncwarp();
  }
}

// dk = dS^T Q * scale and dv = P^T dO, stored through `out_st` (dk and dv may
// be column blocks of one tensor, or two tensors with the same strides).
template <int DP, int L>
__global__ void __launch_bounds__(kThreads)
attn_split_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, Strides out_st, int batch,
                      int n, int heads, int d, float scale) {
  using G = Geom<DP>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int tiles = (n + 15) >> 4, np = tiles * 16;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* X0 = reinterpret_cast<bf16*>(tc_smem);       // np x RS: K, then Q
  bf16* X1 = X0 + np * G::RS;                         // np x RS: V, then dout
  bf16* A0 = X1 + np * G::RS + warp * 32 * G::RS;     // this warp's two 16-row tiles
  bf16* A1 = A0 + 16 * G::RS;
  float* M = reinterpret_cast<float*>(X1 + np * G::RS + nw * 32 * G::RS);
  float* IL = M + np;
  float* DL = IL + np;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides in = qkv_strides<L>(batch, n, heads * d);
  const Strides wide = wide_strides<L>(batch, n, heads * d);
  load_rows<DP>(X0, k, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  load_rows<DP>(X1, v, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float sl2 = scale * kLog2e;
  const int g = lane >> 2, t = lane & 3;
  // phase 1: each query row's statistics, a warp per 16 rows
  for (int qt = warp; qt < tiles; qt += nw) {
    load_rows<DP>(A0, q, in, b, h, d, qt * 16, 16, n, lane, 32);
    load_rows<DP>(A1, dout, wide, b, h, d, qt * 16, 16, n, lane, 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    uint32_t qa[G::KT][4], ga[G::KT][4];
    load_a<DP>(qa, A0, 0, lane);
    load_a<DP>(ga, A1, 0, lane);
    __syncwarp();
    float m[2], il[2], dl[2];
    row_stats<DP>(m, il, dl, qa, ga, X0, X1, tiles, n, sl2, lane);
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = qt * 16 + g + 8 * r;
        M[i] = m[r];
        IL[i] = il[r];
        DL[i] = dl[r];
      }
    }
  }
  __syncthreads();

  // phase 2: q and dout resident in K's and V's place; warps over key blocks
  load_rows<DP>(X0, q, in, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  load_rows<DP>(X1, dout, wide, b, h, d, 0, np, n, threadIdx.x, blockDim.x);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  for (int kb = warp; kb < tiles; kb += nw) {
    load_rows<DP>(A0, k, in, b, h, d, kb * 16, 16, n, lane, 32);
    load_rows<DP>(A1, v, in, b, h, d, kb * 16, 16, n, lane, 32);
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    uint32_t ka[G::KT][4], va[G::KT][4];
    load_a<DP>(ka, A0, 0, lane);
    load_a<DP>(va, A1, 0, lane);
    float dka[G::NT][4], dva[G::NT][4];
    zero<DP>(dka);
    zero<DP>(dva);
    for (int step = 0; step < tiles; ++step) {
      const int qt = (step + warp) % tiles;   // the one-launch body's order
      uint32_t dsa[1][4];
      kv_step<DP>(dka, dva, dsa, ka, va, X0 + qt * 16 * G::RS, X1 + qt * 16 * G::RS, M, IL, DL,
                  qt, kb, n, sl2, lane);
    }
    __syncwarp();
    put_rows<DP>(A0, dka, scale, lane);
    put_rows<DP>(A1, dva, 1.f, lane);
    __syncwarp();
    store_rows<DP>(dk, out_st, b, h, d, A0, kb * 16, 16, n, lane, 32);
    store_rows<DP>(dv, out_st, b, h, d, A1, kb * 16, 16, n, lane, 32);
    __syncwarp();
  }
}

}  // namespace tc

}  // namespace
