// Streaming attention over the packed (B, N, 3W) projection, with an
// optional 2D rotary embedding of q and k: R1 (forward) and R2 (backward).
//
// K1/K2 (attention.cu) hold all of K and V of an (example, head) in shared
// memory, which ends at N = 736 for d = 64. These kernels stream K and V (the
// forward, R2's dq pass) or Q and dO (R2's dk/dv pass) in tiles of 64 rows
// through cp.async double buffering, so N is bounded only by the grid. They
// serve EVA-02's attention (N = 1025 at 448 px, d = 64, RoPE on the patch
// tokens), and any bf16 call whose K1/K2 shared memory exceeds the card's.
//
// Rotary embedding. With tables cos, sin (float32, (N, d), row i for token
// i), each adjacent pair of columns (x0, x1) of q and k becomes
//   (x0 c0 - x1 s0, x1 c1 + x0 s1),
// i.e. x cos + rotate_half(x) sin with rotate_half (x0, x1) -> (-x1, x0). A
// prep launch applies it in float32 to q and k once per call and writes them
// in bf16 to a (B, N, 2W) scratch, from which they become MMA operands; a row
// of cos 1 and sin 0 (EVA-02's cls token) passes unrotated. (Rotating each
// tile as it was staged cost every block of a head the same K or Q tiles
// again, 17 times at N = 1025, and stalled each tile on its table rows: R1
// took 1.93 ms against 1.30 without tables, R2 4.65 against 2.97, at B 48,
// N 1025, d 64 on the H100.) The backward applies the transpose,
//   (g0 c0 + g1 s1, g1 c1 - g0 s0),
// to dq and dk in registers before they are written: a thread of an mma C
// fragment holds both columns of each pair. Without tables (null pointers)
// there is no prep launch and the same kernels compute plain attention.
//
// R1: a block of 4 warps per (example, head, 64 query rows); a warp owns 16
// query rows, their (rotated) Q fragments in registers. Over the key tiles: S =
// Q K^T (scaled into log2 units), an online softmax in float32 (each row's
// running max shared by the quad of threads that hold the row, the
// accumulator rescaled as it moves), P rounded to bf16 as the operand of O +=
// P V. It writes O / l in bf16 and each row's log-sum-exp of the scaled
// scores (natural log, float32, (B, H, N)).
//
// R2, two launches, no atomics (deterministic), p recomputed from the saved
// log-sum-exp:
//   dq pass   a block per (example, head, 64 query rows): each row's delta =
//             dO . O (float32, to a (B, H, N) scratch for the next pass),
//             then over the key tiles S, dP = dO V^T, P, dS = P (dP - delta),
//             dQ += dS K; dQ * scale, rotated back, into the q columns of the
//             packed cotangent;
//   dk/dv     a block per (example, head, 64 key rows), a warp per 16 keys
//   pass      with its (rotated) K and its V fragments in registers; over the
//             query tiles ((rotated) Q, dO, and each query row's log-sum-exp
//             and delta staged): S^T = K Q^T, P^T, dP^T = V dO^T, dS^T, dV +=
//             P^T dO, dK += dS^T Q; dK * scale rotated back and dV into the k
//             and v columns.
// The products of R2 are those of attention_tc.cuh's split backward (its
// bf16 rounding: p and ds are bf16 only as MMA operands).
//
// Shared memory: R1 and the dq pass 5 tiles of 64 rows (Q, two of K, two of
// V), the dk/dv pass 6 (K, V, two of Q, two of dO); 64 x (DP + 8) bf16 each:
// 46 KB / 55 KB at d = 64. q and k are read from the scratch (rows of 2W)
// or, without tables, from the projection (rows of 3W); v always from the
// projection.

#include "attention_tc.cuh"

namespace {

using tc::bf16;
using tc::Geom;

constexpr int kRWarps = 4;
constexpr int kRThreads = kRWarps * 32;
constexpr int kTile = 64;              // rows of a staged tile: a block's queries or keys
constexpr int kSub = kTile / 16;       // 16-row chunks of a tile

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The prep launch: q and k of the (B, N, 3W) projection rotated in float32
// into the (B, N, 2W) scratch [q | k], 8 columns (16 bytes) a thread.
__global__ void __launch_bounds__(256)
rope_prep_kernel(const bf16* __restrict__ qkv, const float* __restrict__ cs,
                 const float* __restrict__ sn, bf16* __restrict__ qk, long long rows, int n,
                 int w, int d) {
  const int chunks = (2 * w) >> 3;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * chunks) return;
  const long long row = idx / chunks;
  const int col = (int)(idx - row * chunks) * 8, i = (int)(row % n), c = col % d;
  uint4 x = *reinterpret_cast<const uint4*>(qkv + row * 3 * w + col);
  const float4* cr = reinterpret_cast<const float4*>(cs + (long long)i * d + c);
  const float4* sr = reinterpret_cast<const float4*>(sn + (long long)i * d + c);
  uint32_t* v = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float4 co = __ldg(cr + half), si = __ldg(sr + half);
    const float cc[4] = {co.x, co.y, co.z, co.w}, ss[4] = {si.x, si.y, si.z, si.w};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float2 p = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v[2 * half + k]));
      v[2 * half + k] = tc::pack(p.x * cc[2 * k] - p.y * ss[2 * k],
                                 p.y * cc[2 * k + 1] + p.x * ss[2 * k + 1]);
    }
  }
  *reinterpret_cast<uint4*>(qk + row * 2 * w + col) = x;
}

// Where q and k come from: the scratch (rows of 2W) after a prep launch, or
// the projection itself (rows of 3W).
struct QK {
  const bf16* q;
  const bf16* k;
  Strides st;
};

// The transposed rotation of a C fragment set (16 x DP, rows row0 + g and
// row0 + g + 8 of this thread), times `mul`, in place.
template <int DP>
__device__ __forceinline__ void unrotate_acc(float (&acc)[Geom<DP>::NT][4], int row0, int n,
                                             int d, const float* __restrict__ cs,
                                             const float* __restrict__ sn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = row0 + g + 8 * rr;
    if (i >= n) continue;
#pragma unroll
    for (int j = 0; j < Geom<DP>::NT; ++j) {
      const int c = 8 * j + 2 * t;
      if (c >= d) continue;
      const float2 co = __ldg(reinterpret_cast<const float2*>(cs + (long long)i * d + c));
      const float2 si = __ldg(reinterpret_cast<const float2*>(sn + (long long)i * d + c));
      const float g0 = acc[j][2 * rr], g1 = acc[j][2 * rr + 1];
      acc[j][2 * rr] = g0 * co.x + g1 * si.y;
      acc[j][2 * rr + 1] = g1 * co.y - g0 * si.x;
    }
  }
}

template <int DP>
__device__ __forceinline__ void scale_acc(float (&acc)[Geom<DP>::NT][4], float mul) {
#pragma unroll
  for (int j = 0; j < Geom<DP>::NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= mul;
}

// A C fragment set to this warp's 16 rows of a bf16 tile, row g scaled by
// mul[0] and row g + 8 by mul[1].
template <int DP>
__device__ __forceinline__ void put_rows2(bf16* x, const float (&acc)[Geom<DP>::NT][4],
                                          const float (&mul)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < Geom<DP>::NT; ++j) {
    bf16* r = x + g * Geom<DP>::RS + 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(r) = tc::pack(acc[j][0] * mul[0], acc[j][1] * mul[0]);
    *reinterpret_cast<uint32_t*>(r + 8 * Geom<DP>::RS) =
        tc::pack(acc[j][2] * mul[1], acc[j][3] * mul[1]);
  }
}

// --- R1 ------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kRThreads)
rope_fwd_kernel(QK qk, const bf16* __restrict__ v, bf16* __restrict__ out,
                float* __restrict__ lse, int batch, int n, int heads, int d, float scale) {
  using G = Geom<DP>;
  extern __shared__ __align__(16) unsigned char rope_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(rope_smem);   // kTile x RS
  bf16* Ks = Qs + kTile * G::RS;                    // 2 x kTile x RS
  bf16* Vs = Ks + 2 * kTile * G::RS;                // 2 x kTile x RS
  const int qtiles = (n + kTile - 1) / kTile, ktiles = qtiles;
  const int bh = blockIdx.x / qtiles, q0 = (blockIdx.x - bh * qtiles) * kTile;
  const int b = bh / heads, h = bh - b * heads, w = heads * d;
  const Strides vst = qkv_strides<kPacked>(batch, n, w);
  const Strides wide = wide_strides<kPacked>(batch, n, w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16;
  const bool active = row0 < n;
  const float sl2 = scale * tc::kLog2e;

  tc::load_rows<DP>(Qs, qk.q, qk.st, b, h, d, q0, kTile, n, threadIdx.x, kRThreads);
  tc::load_rows<DP>(Ks, qk.k, qk.st, b, h, d, 0, kTile, n, threadIdx.x, kRThreads);
  tc::load_rows<DP>(Vs, v, vst, b, h, d, 0, kTile, n, threadIdx.x, kRThreads);
  tc::cp_async_commit();

  uint32_t qa[G::KT][4];
  float o[G::NT][4], mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  tc::zero<DP>(o);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1, k0 = kt * kTile;
    bf16* Kt = Ks + buf * kTile * G::RS;
    bf16* Vt = Vs + buf * kTile * G::RS;
    if (kt + 1 < ktiles) {
      tc::load_rows<DP>(Ks + (buf ^ 1) * kTile * G::RS, qk.k, qk.st, b, h, d, k0 + kTile,
                        kTile, n, threadIdx.x, kRThreads);
      tc::load_rows<DP>(Vs + (buf ^ 1) * kTile * G::RS, v, vst, b, h, d, k0 + kTile, kTile, n,
                        threadIdx.x, kRThreads);
      tc::cp_async_commit();
      cp_async_wait_one();
    } else {
      tc::cp_async_wait_all();
    }
    __syncthreads();
    if (kt == 0) tc::load_a<DP>(qa, Qs, warp * 16, lane);
    if (active) {
      const int subs = min(kSub, (n - k0 + 15) >> 4);
      float s[kSub][2][4];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (j < subs) {
          tc::scores<DP>(s[j], qa, Kt, j * 16, n - k0, sl2, lane);
        } else {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][jj][e] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = mx[r];
#pragma unroll
        for (int j = 0; j < kSub; ++j)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            m = fmaxf(m, fmaxf(s[j][jj][2 * r], s[j][jj][2 * r + 1]));
        m = tc::quad_max(m);
        const float base = tc::base_of(m), corr = tc::exp2_fast(mx[r] - base);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kSub; ++j)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              const float p = tc::exp2_fast(s[j][jj][e] - base);
              s[j][jj][e] = p;
              sum += p;
            }
        l[r] = l[r] * corr + sum;
#pragma unroll
        for (int nt = 0; nt < G::NT; ++nt) {
          o[nt][2 * r] *= corr;
          o[nt][2 * r + 1] *= corr;
        }
        mx[r] = m;
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (j < subs) {
          uint32_t pa[1][4];
          tc::to_a<1>(pa, s[j]);
          tc::acc_rows<DP, 1>(o, pa, Vt, j * 16, lane);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  if (active) {
    const int g = lane >> 2, t = lane & 3;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float total = tc::quad_sum(l[r]);
      inv[r] = 1.f / total;
      const int i = row0 + g + 8 * r;
      if (t == 0 && i < n)
        lse[(long long)bh * n + i] = (mx[r] + log2f(total)) * 0.6931471805599453f;
    }
    bf16* Os = Qs + warp * 16 * G::RS;  // the warp's own Q rows, read into qa already
    put_rows2<DP>(Os, o, inv, lane);
    __syncwarp();
    tc::store_rows<DP>(out, wide, b, h, d, Os, row0, 16, n, lane, 32);
  }
}

// --- R2: the dq pass -------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kRThreads)
rope_dq_kernel(QK qk, const bf16* __restrict__ v, const bf16* __restrict__ o,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ cs, const float* __restrict__ sn,
               bf16* __restrict__ dqkv, float* __restrict__ delta, int batch, int n, int heads,
               int d, float scale) {
  using G = Geom<DP>;
  extern __shared__ __align__(16) unsigned char rope_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(rope_smem);   // kTile x RS, then dO's tile
  bf16* Ks = Qs + kTile * G::RS;
  bf16* Vs = Ks + 2 * kTile * G::RS;
  __shared__ float Ls[kTile], Ds[kTile];
  const int qtiles = (n + kTile - 1) / kTile, ktiles = qtiles;
  const int bh = blockIdx.x / qtiles, q0 = (blockIdx.x - bh * qtiles) * kTile;
  const int b = bh / heads, h = bh - b * heads, w = heads * d;
  const Strides in = qkv_strides<kPacked>(batch, n, w);
  const Strides wide = wide_strides<kPacked>(batch, n, w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;
  const bool active = row0 < n;
  const float sl2 = scale * tc::kLog2e;

  tc::load_rows<DP>(Qs, qk.q, qk.st, b, h, d, q0, kTile, n, threadIdx.x, kRThreads);
  tc::load_rows<DP>(Ks, qk.k, qk.st, b, h, d, 0, kTile, n, threadIdx.x, kRThreads);
  tc::load_rows<DP>(Vs, v, in, b, h, d, 0, kTile, n, threadIdx.x, kRThreads);
  tc::cp_async_commit();

  // each query row's delta = dO . O and log-sum-exp (in log2 units): two
  // lanes a row, 8 columns a step
  for (int rr = threadIdx.x >> 1; rr < kTile; rr += kRThreads / 2) {
    const int i = q0 + rr;
    float acc = 0.f;
    if (i < n) {
      const bf16* orow = wide.row(o, b, i) + h * d;
      const bf16* grow = wide.row(dout, b, i) + h * d;
      for (int c = (threadIdx.x & 1) * 8; c < d; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(op[e]), z = __bfloat1622float2(gp[e]);
          acc = fmaf(a.x, z.x, fmaf(a.y, z.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) {
      Ds[rr] = acc;
      Ls[rr] = i < n ? lse[(long long)bh * n + i] * tc::kLog2e : INFINITY;
      if (i < n) delta[(long long)bh * n + i] = acc;
    }
  }

  uint32_t qa[G::KT][4], ga[G::KT][4];
  float dq[G::NT][4], lr[2], dr[2];
  tc::zero<DP>(dq);
  for (int kt = 0; kt < ktiles; ++kt) {
    const int buf = kt & 1, k0 = kt * kTile;
    bf16* Kt = Ks + buf * kTile * G::RS;
    bf16* Vt = Vs + buf * kTile * G::RS;
    if (kt + 1 < ktiles) {
      tc::load_rows<DP>(Ks + (buf ^ 1) * kTile * G::RS, qk.k, qk.st, b, h, d, k0 + kTile,
                        kTile, n, threadIdx.x, kRThreads);
      tc::load_rows<DP>(Vs + (buf ^ 1) * kTile * G::RS, v, in, b, h, d, k0 + kTile, kTile, n,
                        threadIdx.x, kRThreads);
      tc::cp_async_commit();
      cp_async_wait_one();
    } else {
      tc::cp_async_wait_all();
    }
    __syncthreads();
    if (kt == 0) {
      // Q's fragments, then dO's tile in Q's place (each warp its own rows)
      tc::load_a<DP>(qa, Qs, warp * 16, lane);
      __syncwarp();
      bf16* Gs = Qs + warp * 16 * G::RS;
      tc::load_rows<DP>(Gs, dout, wide, b, h, d, row0, 16, n, lane, 32);
      tc::cp_async_commit();
      tc::cp_async_wait_all();
      __syncwarp();
      tc::load_a<DP>(ga, Gs, 0, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lr[r] = Ls[warp * 16 + g + 8 * r];
        dr[r] = Ds[warp * 16 + g + 8 * r];
      }
    }
    if (active) {
      const int subs = min(kSub, (n - k0 + 15) >> 4);
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (j < subs) {
          float s[2][4], dp[2][4];
          tc::dot_rows<DP>(s, qa, Kt, j * 16, lane);
          tc::dot_rows<DP>(dp, ga, Vt, j * 16, lane);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + j * 16 + 8 * jj + 2 * t + (e & 1);
              const float p = key < n ? tc::exp2_fast(s[jj][e] * sl2 - lr[e >> 1]) : 0.f;
              dp[jj][e] = p * (dp[jj][e] - dr[e >> 1]);
            }
          uint32_t dsa[1][4];
          tc::to_a<1>(dsa, dp);
          tc::acc_rows<DP, 1>(dq, dsa, Kt, j * 16, lane);
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    scale_acc<DP>(dq, scale);
    if (cs != nullptr) unrotate_acc<DP>(dq, row0, n, d, cs, sn, lane);
    bf16* Ds_ = Qs + warp * 16 * G::RS;
    const float one[2] = {1.f, 1.f};
    put_rows2<DP>(Ds_, dq, one, lane);
    __syncwarp();
    tc::store_rows<DP>(dqkv, in, b, h, d, Ds_, row0, 16, n, lane, 32);
  }
}

// --- R2: the dk/dv pass ----------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kRThreads)
rope_dkv_kernel(QK qk, const bf16* __restrict__ v, const bf16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ cs, const float* __restrict__ sn,
                bf16* __restrict__ dqkv, int batch, int n, int heads, int d, float scale) {
  using G = Geom<DP>;
  extern __shared__ __align__(16) unsigned char rope_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(rope_smem);   // kTile x RS
  bf16* Vs = Ks + kTile * G::RS;                    // kTile x RS
  bf16* Qs = Vs + kTile * G::RS;                    // 2 x kTile x RS
  bf16* Gs = Qs + 2 * kTile * G::RS;                // 2 x kTile x RS
  __shared__ float Ls[2][kTile], Ds[2][kTile];
  const int tiles = (n + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles, k0 = (blockIdx.x - bh * tiles) * kTile;
  const int b = bh / heads, h = bh - b * heads, w = heads * d;
  const Strides in = qkv_strides<kPacked>(batch, n, w);
  const Strides wide = wide_strides<kPacked>(batch, n, w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16;
  const bool active = key0 < n;
  const float sl2 = scale * tc::kLog2e;

  auto stage = [&](int qt, int buf) {
    const int r0 = qt * kTile;
    tc::load_rows<DP>(Qs + buf * kTile * G::RS, qk.q, qk.st, b, h, d, r0, kTile, n,
                      threadIdx.x, kRThreads);
    tc::load_rows<DP>(Gs + buf * kTile * G::RS, dout, wide, b, h, d, r0, kTile, n,
                      threadIdx.x, kRThreads);
    for (int r = threadIdx.x; r < kTile; r += kRThreads) {
      const int i = r0 + r;
      Ls[buf][r] = i < n ? lse[(long long)bh * n + i] * tc::kLog2e : INFINITY;
      Ds[buf][r] = i < n ? delta[(long long)bh * n + i] : 0.f;
    }
  };
  tc::load_rows<DP>(Ks, qk.k, qk.st, b, h, d, k0, kTile, n, threadIdx.x, kRThreads);
  tc::load_rows<DP>(Vs, v, in, b, h, d, k0, kTile, n, threadIdx.x, kRThreads);
  stage(0, 0);
  tc::cp_async_commit();

  uint32_t ka[G::KT][4], va[G::KT][4];
  float dka[G::NT][4], dva[G::NT][4];
  tc::zero<DP>(dka);
  tc::zero<DP>(dva);
  for (int qt = 0; qt < tiles; ++qt) {
    const int buf = qt & 1, q0 = qt * kTile;
    if (qt + 1 < tiles) {
      stage(qt + 1, buf ^ 1);
      tc::cp_async_commit();
      cp_async_wait_one();
    } else {
      tc::cp_async_wait_all();
    }
    __syncthreads();
    bf16* Qt = Qs + buf * kTile * G::RS;
    bf16* Gt = Gs + buf * kTile * G::RS;
    if (qt == 0) {
      tc::load_a<DP>(ka, Ks, warp * 16, lane);
      tc::load_a<DP>(va, Vs, warp * 16, lane);
    }
    if (active) {
      const int subs = min(kSub, (n - q0 + 15) >> 4);
      const float* L = Ls[buf];
      const float* Dl = Ds[buf];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (j < subs) {
          const bf16* Qj = Qt + j * 16 * G::RS;
          const bf16* Gj = Gt + j * 16 * G::RS;
          float s[2][4], dp[2][4];
          tc::dot_rows<DP>(s, ka, Qj, 0, lane);   // S^T: rows keys, columns queries
          tc::dot_rows<DP>(dp, va, Gj, 0, lane);  // dP^T
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int qi = j * 16 + 8 * jj + 2 * t + c;
              const float lq = L[qi], dq = Dl[qi];
#pragma unroll
              for (int rr = 0; rr < 2; ++rr) {
                const int e = 2 * rr + c, key = key0 + g + 8 * rr;
                const float p = key < n ? tc::exp2_fast(s[jj][e] * sl2 - lq) : 0.f;
                s[jj][e] = p;
                dp[jj][e] = p * (dp[jj][e] - dq);
              }
            }
          uint32_t pa[1][4], dsa[1][4];
          tc::to_a<1>(pa, s);
          tc::to_a<1>(dsa, dp);
          tc::acc_rows<DP, 1>(dva, pa, Gj, 0, lane);
          tc::acc_rows<DP, 1>(dka, dsa, Qj, 0, lane);
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    scale_acc<DP>(dka, scale);
    if (cs != nullptr) unrotate_acc<DP>(dka, key0, n, d, cs, sn, lane);
    const float one[2] = {1.f, 1.f};
    bf16* Kw = Ks + warp * 16 * G::RS;  // the warp's own rows, in its fragments already
    bf16* Vw = Vs + warp * 16 * G::RS;
    put_rows2<DP>(Kw, dka, one, lane);
    put_rows2<DP>(Vw, dva, one, lane);
    __syncwarp();
    tc::store_rows<DP>(dqkv + w, in, b, h, d, Kw, key0, 16, n, lane, 32);
    tc::store_rows<DP>(dqkv + 2 * w, in, b, h, d, Vw, key0, 16, n, lane, 32);
  }
}

// --- launches --------------------------------------------------------------------

template <int DP>
size_t tile_bytes() { return sizeof(bf16) * kTile * Geom<DP>::RS; }

// q and k for the kernels: rotated into `scratch` by a prep launch where
// there are tables, else the projection's own columns.
int stage_qk(QK& qk, const bf16* qkv, const float* cs, const float* sn, bf16* scratch,
             int batch, int n, int w, int d, cudaStream_t stream) {
  if (cs == nullptr) {
    qk = {qkv, qkv + w, qkv_strides<kPacked>(batch, n, w)};
    return 0;
  }
  const long long rows = (long long)batch * n, threads = rows * (2 * w / 8);
  rope_prep_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(qkv, cs, sn, scratch,
                                                                          rows, n, w, d);
  qk = {scratch, scratch + w, {2LL * w, 2LL * n * w}};
  return (int)cudaGetLastError();
}

template <int DP>
int fwd_launch(const bf16* qkv, const float* cs, const float* sn, bf16* scratch, bf16* out,
               float* lse, int batch, int n, int heads, int d, float scale,
               cudaStream_t stream) {
  QK qk;
  int rc = stage_qk(qk, qkv, cs, sn, scratch, batch, n, heads * d, d, stream);
  if (rc) return rc;
  const size_t smem = 5 * tile_bytes<DP>();
  if ((rc = prepare(rope_fwd_kernel<DP>, smem))) return rc;
  const long long blocks = (long long)batch * heads * ((n + kTile - 1) / kTile);
  rope_fwd_kernel<DP><<<(unsigned)blocks, kRThreads, smem, stream>>>(
      qk, qkv + 2 * heads * d, out, lse, batch, n, heads, d, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int bwd_launch(const bf16* qkv, const bf16* o, const bf16* dout, const float* lse,
               const float* cs, const float* sn, bf16* scratch, bf16* dqkv, float* delta,
               int batch, int n, int heads, int d, float scale, cudaStream_t stream) {
  QK qk;
  int rc = stage_qk(qk, qkv, cs, sn, scratch, batch, n, heads * d, d, stream);
  if (rc) return rc;
  const bf16* v = qkv + 2 * heads * d;
  const long long blocks = (long long)batch * heads * ((n + kTile - 1) / kTile);
  size_t smem = 5 * tile_bytes<DP>();
  if ((rc = prepare(rope_dq_kernel<DP>, smem))) return rc;
  rope_dq_kernel<DP><<<(unsigned)blocks, kRThreads, smem, stream>>>(
      qk, v, o, dout, lse, cs, sn, dqkv, delta, batch, n, heads, d, scale);
  if ((rc = (int)cudaGetLastError())) return rc;
  smem = 6 * tile_bytes<DP>();
  if ((rc = prepare(rope_dkv_kernel<DP>, smem))) return rc;
  rope_dkv_kernel<DP><<<(unsigned)blocks, kRThreads, smem, stream>>>(
      qk, v, dout, lse, delta, cs, sn, dqkv, batch, n, heads, d, scale);
  return (int)cudaGetLastError();
}

// the padded head width of d: 32, 64 or 128 (0 where none fits)
int padded(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0; }

}  // namespace

extern "C" {

// R1: qkv (batch, n, 3 * heads * d) bf16 -> out (batch, n, heads * d) bf16 and
// lse (batch, heads, n) f32; cs, sn (n, d) f32, or both null for no rotation;
// scratch (batch, n, 2 * heads * d) bf16 where there are tables.
int vst_rope_attn_fwd(const void* qkv, const void* cs, const void* sn, void* scratch, void* out,
                      void* lse, int batch, int n, int heads, int d, float scale,
                      void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bf16* x = static_cast<const bf16*>(qkv);
  const float *c = static_cast<const float*>(cs), *s = static_cast<const float*>(sn);
  bf16* qk = static_cast<bf16*>(scratch);
  bf16* y = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  switch (padded(d)) {
    case 32: return fwd_launch<32>(x, c, s, qk, y, l, batch, n, heads, d, scale, stream);
    case 64: return fwd_launch<64>(x, c, s, qk, y, l, batch, n, heads, d, scale, stream);
    case 128: return fwd_launch<128>(x, c, s, qk, y, l, batch, n, heads, d, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// R2: dout (batch, n, heads * d) -> dqkv (batch, n, 3 * heads * d), from qkv,
// R1's out and lse; delta is a (batch, heads, n) f32 scratch, scratch as R1's.
int vst_rope_attn_bwd(const void* qkv, const void* out, const void* dout, const void* lse,
                      const void* cs, const void* sn, void* scratch, void* dqkv, void* delta,
                      int batch, int n, int heads, int d, float scale, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* o = static_cast<const bf16*>(out);
  const bf16* g = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  const float *c = static_cast<const float*>(cs), *s = static_cast<const float*>(sn);
  bf16* qk = static_cast<bf16*>(scratch);
  bf16* dx = static_cast<bf16*>(dqkv);
  float* dl = static_cast<float*>(delta);
  switch (padded(d)) {
    case 32: return bwd_launch<32>(x, o, g, l, c, s, qk, dx, dl, batch, n, heads, d, scale, stream);
    case 64: return bwd_launch<64>(x, o, g, l, c, s, qk, dx, dl, batch, n, heads, d, scale, stream);
    case 128:
      return bwd_launch<128>(x, o, g, l, c, s, qk, dx, dl, batch, n, heads, d, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
