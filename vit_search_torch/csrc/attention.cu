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
// Head dims: every multiple of 8 from 8 to 128, passed at run time. Rows are
// copied in 16-byte pieces (8 bf16), so a head dim off that grid would split a
// copy; the wrappers send no such shape. The bf16 bodies are instantiated per
// padded width DP (d rounded up to 16: 16, 32, ..., 128), the f32 bodies per
// columns a lane holds (d rounded up to 32: 32, ..., 128); columns past d are
// zero on load and never stored.
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
// Design of the bf16 bodies (in attention_tc.cuh, shared with the lab's K10
// and K11, which instantiate them with p and ds kept as bf16 hi/lo pairs;
// this file instantiates them with one bf16 operand each). A block owns one
// (example, head) and 1-8 warps, as many as spread the 16-row tiles of the
// sequence evenly. Rows live in shared memory as bf16 with the head dim
// padded with zeros to DP and a row stride of DP + 8 elements, which makes
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
//   backward  one launch where it fits (the lab's K11 form, FlashAttention-2's
//             backward): nothing crosses blocks and no row statistics go to
//             device memory.
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
//             Shared memory, with R = DP + 8: K, V and the f32 dQ 8*N*R
//             bytes, the ring 64*(W + 1)*R, the statistics 12*N: 108 KB at
//             stage 1 (two blocks per SM), up to N = 624 at D = 32.
//             Past that (the 392 px finetune's N = 785 at D = 32), two
//             launches of the split backward in attention_tc.cuh, which keeps
//             no f32 dQ: a dq pass, then a dk/dv pass that recomputes each
//             row's statistics, both writing into this layout's cotangent.
//             The choice is fixed by (N, D); dk and dv keep the one-launch
//             body's bits, dq sums its key blocks in another order.
// Design of the f32 bodies (the first port's arithmetic): a block owns one
// (example, head) and stages K and V (or Q and dO) as f32, rows padded to
// d + 1 floats; a warp owns one row at a time, lanes over the keys (or
// queries), and recomputes its scores pass by pass instead of keeping a row
// of them: an exact two-pass softmax, then the products 32 keys at a time,
// each lane's p (or ds) handed to the warp by shuffle. The backward is two
// launches that share each query row's (max, sum, delta) through the caller's
// `rowstats` scratch: (a) warp per query row writes dq and the statistics;
// (b) warp per key row sums dk and dv over every query.
// N is any length up to what shared memory holds (every loop masks its ragged
// end; vst_attn_smem_bytes gives the need). The TPU's group sizes and VMEM
// limits (_pick_group, _pick_group_t, _params_t and VST_ATTN_T_VMEM_MB) budget
// VMEM blocks and have no counterpart here.

#include "attention_tc.cuh"

namespace {

// --- float32 bodies (CUDA cores) -------------------------------------------

// x[c] = row[c] for c < d, 0 past it.
template <int DM>
__device__ __forceinline__ void load_vec(float (&x)[DM], const float* __restrict__ row, int d) {
#pragma unroll
  for (int c = 0; c < DM; ++c) x[c] = c < d ? row[c] : 0.f;
}

// sum over c < d of x[c] * r[c], in ascending c
template <int DM>
__device__ __forceinline__ float dot(const float (&x)[DM], const float* __restrict__ r, int d) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < DM; ++c)
    if (c < d) s = fmaf(x[c], r[c], s);
  return s;
}

// acc[t] += a * x[lane + 32 t] over the columns c < d a lane holds
template <int CD>
__device__ __forceinline__ void axpy(float (&acc)[CD], float a, const float* __restrict__ x,
                                     int d, int lane) {
#pragma unroll
  for (int t = 0; t < CD; ++t) {
    const int c = lane + 32 * t;
    if (c < d) acc[t] = fmaf(a, x[c], acc[t]);
  }
}

template <int CD>
__device__ __forceinline__ void store_vec(float* __restrict__ row, const float (&acc)[CD],
                                          float mul, int d, int lane) {
#pragma unroll
  for (int t = 0; t < CD; ++t) {
    const int c = lane + 32 * t;
    if (c < d) row[c] = acc[t] * mul;
  }
}

// q, k and v (or dq, dk and dv) are the column blocks of one tensor in the
// packed and sequence-major layouts, W columns apart; separate ones otherwise.
template <int DM, int L>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out, int batch, int n,
                int heads, int d, float scale) {
  constexpr int CD = DM / 32;
  extern __shared__ float smem[];
  const int ks = d + 1;
  float* Ks = smem;             // n x (d + 1)
  float* Vs = Ks + n * ks;      // n x d
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides in = qkv_strides<L>(batch, n, heads * d);
  const Strides wide = wide_strides<L>(batch, n, heads * d);
  stage(in.row(k, b, 0) + h * d, in.tok, n, d, Ks, ks);
  stage(in.row(v, b, 0) + h * d, in.tok, n, d, Vs, d);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += kWarps) {
    float qv[DM];
    load_vec<DM>(qv, in.row(q, b, i) + h * d, d);
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, dot<DM>(qv, Ks + j * ks, d) * scale);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) sum += expf(dot<DM>(qv, Ks + j * ks, d) * scale - mx);
    sum = warp_sum(sum);

    float acc[CD];
#pragma unroll
    for (int t = 0; t < CD; ++t) acc[t] = 0.f;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane, m = min(32, n - j0);
      const float pj = j < n ? expf(dot<DM>(qv, Ks + j * ks, d) * scale - mx) / sum : 0.f;
      for (int jj = 0; jj < m; ++jj)
        axpy<CD>(acc, __shfl_sync(0xffffffffu, pj, jj), Vs + (j0 + jj) * d, d, lane);
    }
    store_vec<CD>(wide.row(out, b, i) + h * d, acc, 1.f, d, lane);
  }
}

// backward (a): dq and the per-row (max, sum, delta), warp per query row.
template <int DM, int L>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   float* __restrict__ dq, float4* __restrict__ rowstats, int batch, int n,
                   int heads, int d, float scale) {
  constexpr int CD = DM / 32;
  extern __shared__ float smem[];
  const int ks = d + 1;
  float* Ks = smem;             // n x (d + 1)
  float* Vs = Ks + n * ks;      // n x (d + 1)
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides in = qkv_strides<L>(batch, n, heads * d);
  const Strides wide = wide_strides<L>(batch, n, heads * d);
  stage(in.row(k, b, 0) + h * d, in.tok, n, d, Ks, ks);
  stage(in.row(v, b, 0) + h * d, in.tok, n, d, Vs, ks);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += kWarps) {
    float qv[DM], g[DM];
    load_vec<DM>(qv, in.row(q, b, i) + h * d, d);
    load_vec<DM>(g, wide.row(dout, b, i) + h * d, d);
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, dot<DM>(qv, Ks + j * ks, d) * scale);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) sum += expf(dot<DM>(qv, Ks + j * ks, d) * scale - mx);
    sum = warp_sum(sum);
    float delta = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float pj = expf(dot<DM>(qv, Ks + j * ks, d) * scale - mx) / sum;
      delta += pj * dot<DM>(g, Vs + j * ks, d);
    }
    delta = warp_sum(delta);

    float acc[CD];
#pragma unroll
    for (int t = 0; t < CD; ++t) acc[t] = 0.f;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane, m = min(32, n - j0);
      float ds = 0.f;
      if (j < n) {
        const float pj = expf(dot<DM>(qv, Ks + j * ks, d) * scale - mx) / sum;
        ds = pj * (dot<DM>(g, Vs + j * ks, d) - delta);
      }
      for (int jj = 0; jj < m; ++jj)
        axpy<CD>(acc, __shfl_sync(0xffffffffu, ds, jj), Ks + (j0 + jj) * ks, d, lane);
    }
    store_vec<CD>(in.row(dq, b, i) + h * d, acc, scale, d, lane);
    if (lane == 0)
      rowstats[(long long)blockIdx.x * n + i] = make_float4(mx, sum, delta, 0.f);
  }
}

// backward (b): dk and dv, warp per key row, summing over every query.
template <int DM, int L>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float4* __restrict__ rowstats, float* __restrict__ dk,
                    float* __restrict__ dv, int batch, int n, int heads, int d, float scale) {
  constexpr int CD = DM / 32;
  extern __shared__ float smem[];
  const int ks = d + 1;
  float* Qs = smem;             // n x (d + 1)
  float* Gs = Qs + n * ks;      // n x (d + 1)
  float* Mx = Gs + n * ks;      // n
  float* Sum = Mx + n;          // n
  float* Delta = Sum + n;       // n
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const Strides in = qkv_strides<L>(batch, n, heads * d);
  const Strides wide = wide_strides<L>(batch, n, heads * d);
  stage(in.row(q, b, 0) + h * d, in.tok, n, d, Qs, ks);
  stage(wide.row(dout, b, 0) + h * d, wide.tok, n, d, Gs, ks);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float4 st = rowstats[(long long)blockIdx.x * n + i];
    Mx[i] = st.x;
    Sum[i] = st.y;
    Delta[i] = st.z;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < n; j += kWarps) {
    float kv[DM], vv[DM];
    load_vec<DM>(kv, in.row(k, b, j) + h * d, d);
    load_vec<DM>(vv, in.row(v, b, j) + h * d, d);
    float acck[CD], accv[CD];
#pragma unroll
    for (int t = 0; t < CD; ++t) acck[t] = accv[t] = 0.f;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane, m = min(32, n - i0);
      float p = 0.f, ds = 0.f;
      if (i < n) {
        const float s = dot<DM>(kv, Qs + i * ks, d) * scale;
        p = expf(s - Mx[i]) / Sum[i];
        ds = p * (dot<DM>(vv, Gs + i * ks, d) - Delta[i]);
      }
      for (int ii = 0; ii < m; ++ii) {
        const int r = (i0 + ii) * ks;
        axpy<CD>(accv, __shfl_sync(0xffffffffu, p, ii), Gs + r, d, lane);
        axpy<CD>(acck, __shfl_sync(0xffffffffu, ds, ii), Qs + r, d, lane);
      }
    }
    store_vec<CD>(in.row(dk, b, j) + h * d, acck, scale, d, lane);
    store_vec<CD>(in.row(dv, b, j) + h * d, accv, 1.f, d, lane);
  }
}

size_t fwd_smem(int n, int d) { return sizeof(float) * (size_t)n * (2 * d + 1); }
size_t dq_smem(int n, int d) { return sizeof(float) * (size_t)n * 2 * (d + 1); }
size_t dkv_smem(int n, int d) { return sizeof(float) * (size_t)n * (2 * (d + 1) + 3); }

// --- bfloat16 bodies (tensor cores): attention_tc.cuh ------------------------

namespace tc {

// the backward takes the split route where the one-launch body does not fit
bool bwd_split(int n, int d) { return bwd_bytes(n, d) > kMaxSmem; }

size_t bwd_route_bytes(int n, int d) {
  if (!bwd_split(n, d)) return bwd_bytes(n, d);
  const size_t a = split_dq_bytes(n, d), b = split_dkv_bytes(n, d);
  return a > b ? a : b;
}

}  // namespace tc

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

template <int DM, int L>
int fwd_launch(const void* a, const void* b, const void* c, void* out, int batch, int n,
               int heads, int d, float scale, cudaStream_t stream) {
  const QKV<const float> in = split<L>(static_cast<const float*>(a),
                                       static_cast<const float*>(b),
                                       static_cast<const float*>(c), heads * d);
  const size_t smem = fwd_smem(n, d);
  int rc = prepare(attn_fwd_kernel<DM, L>, smem);
  if (rc) return rc;
  attn_fwd_kernel<DM, L><<<batch * heads, kThreads, smem, stream>>>(
      in.q, in.k, in.v, static_cast<float*>(out), batch, n, heads, d, scale);
  return (int)cudaGetLastError();
}

template <int DM, int L>
int bwd_launch(const void* a, const void* b, const void* c, const void* dout, void* da,
               void* db, void* dc, void* rowstats, int batch, int n, int heads, int d,
               float scale, cudaStream_t stream) {
  const QKV<const float> in = split<L>(static_cast<const float*>(a),
                                       static_cast<const float*>(b),
                                       static_cast<const float*>(c), heads * d);
  const QKV<float> grad = split<L>(static_cast<float*>(da), static_cast<float*>(db),
                                   static_cast<float*>(dc), heads * d);
  const float* g = static_cast<const float*>(dout);
  size_t smem = dq_smem(n, d);
  int rc = prepare(attn_bwd_dq_kernel<DM, L>, smem);
  if (rc) return rc;
  attn_bwd_dq_kernel<DM, L><<<batch * heads, kThreads, smem, stream>>>(
      in.q, in.k, in.v, g, grad.q, static_cast<float4*>(rowstats), batch, n, heads, d, scale);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  smem = dkv_smem(n, d);
  rc = prepare(attn_bwd_dkv_kernel<DM, L>, smem);
  if (rc) return rc;
  attn_bwd_dkv_kernel<DM, L><<<batch * heads, kThreads, smem, stream>>>(
      in.q, in.k, in.v, g, static_cast<const float4*>(rowstats), grad.k, grad.v, batch, n,
      heads, d, scale);
  return (int)cudaGetLastError();
}

template <int DP, int L>
int fwd_launch_tc(const void* a, const void* b, const void* c, void* out, int batch, int n,
                  int heads, int d, float scale, cudaStream_t stream) {
  using tc::bf16;
  const QKV<const bf16> in = split<L>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                      static_cast<const bf16*>(c), heads * d);
  const size_t smem = tc::fwd_bytes(n, d);
  int rc = prepare(tc::attn_fwd_kernel<DP, L>, smem);
  if (rc) return rc;
  const int warps = tc::warps_for((n + 15) / 16);
  tc::attn_fwd_kernel<DP, L><<<batch * heads, 32 * warps, smem, stream>>>(
      in.q, in.k, in.v, static_cast<bf16*>(out), batch, n, heads, d, scale);
  return (int)cudaGetLastError();
}

template <int DP, int L>
int bwd_launch_tc(const void* a, const void* b, const void* c, const void* dout, void* da,
                  void* db, void* dc, int batch, int n, int heads, int d, float scale,
                  cudaStream_t stream) {
  using tc::bf16;
  const QKV<const bf16> in = split<L>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                                      static_cast<const bf16*>(c), heads * d);
  const QKV<bf16> grad = split<L>(static_cast<bf16*>(da), static_cast<bf16*>(db),
                                  static_cast<bf16*>(dc), heads * d);
  const bf16* g = static_cast<const bf16*>(dout);
  const int blocks = batch * heads, threads = 32 * tc::warps_for((n + 15) / 16);
  int rc;
  if (!tc::bwd_split(n, d)) {
    const size_t smem = tc::bwd_bytes(n, d);
    if ((rc = prepare(tc::attn_bwd_kernel<DP, L>, smem))) return rc;
    tc::attn_bwd_kernel<DP, L><<<blocks, threads, smem, stream>>>(
        in.q, in.k, in.v, g, grad.q, grad.k, grad.v, batch, n, heads, d, scale);
    return (int)cudaGetLastError();
  }
  // the split route: the cotangent's strides are the inputs'
  const Strides st = qkv_strides<L>(batch, n, heads * d);
  size_t smem = tc::split_dq_bytes(n, d);
  if ((rc = prepare(tc::attn_split_dq_kernel<DP, L>, smem))) return rc;
  tc::attn_split_dq_kernel<DP, L><<<blocks, threads, smem, stream>>>(
      in.q, in.k, in.v, g, grad.q, st, batch, n, heads, d, scale);
  if ((rc = (int)cudaGetLastError())) return rc;
  smem = tc::split_dkv_bytes(n, d);
  if ((rc = prepare(tc::attn_split_dkv_kernel<DP, L>, smem))) return rc;
  tc::attn_split_dkv_kernel<DP, L><<<blocks, threads, smem, stream>>>(
      in.q, in.k, in.v, g, grad.k, grad.v, st, batch, n, heads, d, scale);
  return (int)cudaGetLastError();
}

bool head_dim_ok(int d) { return d >= 8 && d <= 128 && d % 8 == 0; }

}  // namespace

// bf16 bodies by padded width (d rounded up to 16), f32 bodies by columns a
// lane holds (d rounded up to 32); the caller has checked head_dim_ok(d)
#define VST_SWITCH_DP(d, CALL)                 \
  switch (((d) + 15) / 16) {                   \
    case 1: CALL(16);                          \
    case 2: CALL(32);                          \
    case 3: CALL(48);                          \
    case 4: CALL(64);                          \
    case 5: CALL(80);                          \
    case 6: CALL(96);                          \
    case 7: CALL(112);                         \
    case 8: CALL(128);                         \
    default: return (int)cudaErrorInvalidValue; \
  }
#define VST_SWITCH_DM(d, CALL)                 \
  switch (((d) + 31) / 32) {                   \
    case 1: CALL(32);                          \
    case 2: CALL(64);                          \
    case 3: CALL(96);                          \
    case 4: CALL(128);                         \
    default: return (int)cudaErrorInvalidValue; \
  }

namespace {

// dtype: 0 = float32 (CUDA-core body), 1 = bfloat16 (tensor-core body).
// Returns cudaGetLastError() (or cudaErrorInvalidValue for a head size,
// length or dtype the kernels do not take).
template <int L>
int attn_fwd(const void* a, const void* b, const void* c, void* out, int batch, int n,
             int heads, int d, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dim_ok(d)) return (int)cudaErrorInvalidValue;
#define VST_FWD_BF16(DP) return fwd_launch_tc<DP, L>(a, b, c, out, batch, n, heads, d, scale, s)
#define VST_FWD_F32(DM) return fwd_launch<DM, L>(a, b, c, out, batch, n, heads, d, scale, s)
  if (dtype == 1) { VST_SWITCH_DP(d, VST_FWD_BF16) }
  if (dtype == 0) { VST_SWITCH_DM(d, VST_FWD_F32) }
  return (int)cudaErrorInvalidValue;
#undef VST_FWD_BF16
#undef VST_FWD_F32
}

// rowstats: float32 scratch of (batch * heads * n, 4) for the f32 body's two
// launches; the bf16 bodies keep their statistics on chip and do not read it.
template <int L>
int attn_bwd(const void* a, const void* b, const void* c, const void* dout, void* da,
             void* db, void* dc, void* rowstats, int batch, int n, int heads, int d,
             float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dim_ok(d)) return (int)cudaErrorInvalidValue;
#define VST_BWD_BF16(DP) \
  return bwd_launch_tc<DP, L>(a, b, c, dout, da, db, dc, batch, n, heads, d, scale, s)
#define VST_BWD_F32(DM) \
  return bwd_launch<DM, L>(a, b, c, dout, da, db, dc, rowstats, batch, n, heads, d, scale, s)
  if (dtype == 1) { VST_SWITCH_DP(d, VST_BWD_BF16) }
  if (dtype == 0) {
    if (!rowstats) return (int)cudaErrorInvalidValue;
    VST_SWITCH_DM(d, VST_BWD_F32)
  }
  return (int)cudaErrorInvalidValue;
#undef VST_BWD_BF16
#undef VST_BWD_F32
}

}  // namespace

#undef VST_SWITCH_DP
#undef VST_SWITCH_DM

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

// Largest dynamic shared memory the kernels of `dtype` need at (n, d), the
// backward by the route it takes there, so the caller can refuse a shape
// before launching.
long long vst_attn_smem_bytes(int n, int d, int dtype) {
  size_t a, b;
  if (dtype == 1) {
    a = tc::fwd_bytes(n, d);
    b = tc::bwd_route_bytes(n, d);
  } else {
    a = fwd_smem(n, d);
    b = dq_smem(n, d) > dkv_smem(n, d) ? dq_smem(n, d) : dkv_smem(n, d);
  }
  return (long long)(a > b ? a : b);
}

// 1 where a bfloat16 backward at (n, d) takes the split route (two launches),
// 0 where it takes the one-launch body.
int vst_attn_bwd_split(int n, int d) { return tc::bwd_split(n, d) ? 1 : 0; }

}  // extern "C"
