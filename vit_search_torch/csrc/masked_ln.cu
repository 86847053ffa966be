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
// flops (about 0.5 flop per byte moved), so both kernels are streams over
// x (and g), and the only lever is keeping enough bytes in flight.
//
// Design (the tiled path, taken where every row is whole 16-byte vectors on
// 16-byte boundaries): one row engine for K3 and K4. A persistent grid of a
// few blocks per SM; each block takes an even share of the rows (to a row, so
// no block moves more bytes than another: at stage 3 a share is 17-33 rows)
// and walks it in near-equal tiles of at most R rows. Since x and g are
// (rows, C) row-major, a tile is one contiguous span, and
// the mask rows of the examples it touches are another (an example's rows are
// consecutive; a shared mask is one row). Thread 0 stages them into a ring of
// S shared-memory stages with the 1-D TMA bulk copy (cp.async.bulk, completion
// on one mbarrier per stage, an L2 evict-first hint since each byte is read
// once), so the ring, not the register count, sets the bytes in flight. Lanes read 16 bytes at a time from shared memory; a group
// of lanes owns a row (8 / 16 / 32 lanes at C = 256 / 512 / 1024 in bf16, so
// a warp works on several short rows at once), its sums come from shuffles
// within the group, and each mask row's sum is taken once per tile. w and b
// are loaded into shared memory once per block.
// y (gx) goes from registers straight to memory in 16-byte stores; a row's
// values are read again from shared memory rather than kept in registers, so
// no per-lane array grows with C.
//
// K4's column sums: the TPU accumulates gw/gb across its sequential grid
// (masked_ln.py:76-82); blocks here run in no order. In each tile every thread
// owns a 16-byte chunk of columns and a phase, and adds the tile's rows of
// that phase in row order (no array grows with C); at the end the block folds
// its phases in order and writes one (2, C) partial, one per block of the
// persistent grid. A second kernel folds the partials: each block takes 32
// columns, each of its warps a fixed group of partials in order, then the
// groups in order. No float atomics anywhere, so gw and gb are bit-identical
// from run to run, and nothing but launches (no allocation, no host sync), so
// both kernels can be captured in a CUDA graph.
//
// The general path takes what the tiled path cannot (a bf16 row with
// C % 8 != 0, an input not 16-byte aligned): one warp per row, 4-element
// loads (8 bytes in bf16), the row kept in registers; its K4 writes per-block
// partials for the same fold kernel.
//
// The launch plan (tile rows R, stages S, mask rows per stage, grid, shared
// bytes) is computed by the wrapper (ops/masked_layer_norm.py, launch_plan);
// tiled_smem_bytes below is its layout, and a launch whose shared bytes differ
// from it is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTileRows = kThreads;   // a thread holds one row's statistics
constexpr int kMaxStages = 4;
constexpr int kHeader = 256;              // shared bytes of the mbarriers and staged Tiles
constexpr int kTileSlots = 32;            // offset of the Tiles in the header
constexpr size_t kMaxSmem = 232448;       // dynamic shared memory a block may opt into
// blocks per SM the tiled kernels are compiled for (register caps 64 and 128)
constexpr int kFwdBlocksPerSM = 4;
constexpr int kBwdBlocksPerSM = 2;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --- 16-byte vectors (the tiled path) -----------------------------------------

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&v)[8]) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// V floats of w (or b) from shared memory
template <int V>
__device__ __forceinline__ void load_params(const float* p, float (&v)[V]) {
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 t = *reinterpret_cast<const float4*>(p + i);
    v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
  }
}

// --- the ring: mbarriers and the 1-D bulk copy ----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte aligned global to shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

__host__ __device__ __forceinline__ size_t round128(size_t v) { return (v + 127) / 128 * 128; }

// K4's column slots: a thread owns a chunk of V columns and a phase of rows
__host__ __device__ __forceinline__ int fold_phases(int nchunks) {
  return nchunks >= kThreads ? 1 : kThreads / nchunks;
}

// Shared memory of a tiled block, in this order, each part 128-byte aligned:
// the header (S mbarriers, then the S staged tiles' Tile); w (and b in K3) as float; one mask sum per mask row
// of a stage; in K4 one (mu, inv_std) per tile row; each tile row's mask row
// (an int); then the ring of S stages, each x's tile (R rows), g's tile in K4,
// and `mask_rows` mask rows. K4 folds its column sums in the ring's space at
// the end, so the ring is at least that fold's phases x 2C floats.
size_t tiled_smem_bytes(bool bwd, int c, int esize, int tile_rows, int stages,
                        int mask_rows) {
  const size_t row = (size_t)c * esize;
  size_t ring = (size_t)stages * ((bwd ? 2 : 1) * (size_t)tile_rows + mask_rows) * row;
  if (bwd) {
    const size_t fold = (size_t)fold_phases(c / (16 / esize)) * 2 * c * sizeof(float);
    if (fold > ring) ring = fold;
  }
  return kHeader + round128((bwd ? 1 : 2) * (size_t)c * sizeof(float)) +
         round128((size_t)mask_rows * sizeof(float)) +
         (bwd ? round128((size_t)tile_rows * sizeof(float2)) : 0) +
         round128((size_t)tile_rows * sizeof(int)) + ring;
}

// Lanes that share a row: a power of two, so that each lane holds about four
// 16-byte chunks of it (C = 256 / 512 / 1024 in bf16: 8 / 16 / 32 lanes), and
// a warp works on 32 / lanes rows at once, each summed over its lanes alone.
__device__ __forceinline__ int lanes_per_row(int nchunks) {
  int l = 1;
  while (l < 32 && 8 * l <= nchunks) l *= 2;
  return l;
}

// sum over the `lanes` lanes of a row (aligned groups; every lane calls it)
__device__ __forceinline__ float row_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A staged tile. Thread 0 writes it into the stage's slot of the header before
// its arrive on the stage's mbarrier, so a thread that saw the stage land
// reads it there; no other thread divides rows by n.
struct Tile {
  long long r0;  // first row
  long long e0;  // example of the first row
  int nr;        // rows
  int ne;        // mask rows staged (1 for a shared mask)
  int off;       // r0 - e0 * n: the first row's place in its example
};

// A block's rows: an even share of all rows (to a row, so every block moves
// the same bytes), cut into nt tiles of near-equal size (the first `rem` one
// row longer), each at most R rows.
struct Walk {
  long long b0;  // the block's first row
  int nt, q, rem;

  __device__ Walk(long long rows, int tile_rows) {
    b0 = rows * blockIdx.x / gridDim.x;
    const long long nb = rows * (blockIdx.x + 1) / gridDim.x - b0;
    nt = (int)((nb + tile_rows - 1) / tile_rows);
    q = nt ? (int)(nb / nt) : 0;
    rem = nt ? (int)(nb % nt) : 0;
  }

  __device__ Tile tile(int j, int n, long long mask_bstride) const {
    Tile tl;
    tl.r0 = b0 + (long long)j * q + min(j, rem);
    tl.nr = q + (j < rem ? 1 : 0);
    tl.e0 = tl.r0 / n;
    tl.off = (int)(tl.r0 - tl.e0 * n);
    tl.ne = mask_bstride ? (tl.off + tl.nr - 1) / n + 1 : 1;
    return tl;
  }
};

// L2 policy for the staged loads: each byte is read once, so it goes first
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// Thread 0: stage tile tl into `stage` (x, then g where given, then the masks)
// and note it in `slot`.
template <typename T>
__device__ __forceinline__ void issue_tile(const Tile& tl, int c, int tile_rows, const T* x,
                                           const T* g, const T* mask, long long mask_bstride,
                                           unsigned char* stage, uint64_t* bar, Tile* slot,
                                           uint64_t policy) {
  *slot = tl;
  const uint32_t xb = (uint32_t)tl.nr * c * sizeof(T);
  const uint32_t mb = (uint32_t)tl.ne * c * sizeof(T);
  T* xs = reinterpret_cast<T*>(stage);
  T* ms = xs + (size_t)(g ? 2 : 1) * tile_rows * c;
  bar_expect(bar, (g ? 2 : 1) * xb + mb);
  bulk_copy(xs, x + tl.r0 * c, xb, bar, policy);
  if (g) bulk_copy(xs + (size_t)tile_rows * c, g + tl.r0 * c, xb, bar, policy);
  bulk_copy(ms, mask + tl.e0 * mask_bstride, mb, bar, policy);
}

// Once a tile has landed: the warps sum each staged mask row once (msum[j],
// j < ne), and thread r notes row r's mask row (rslot[r]).
template <typename T>
__device__ __forceinline__ void tile_masks(const T* ms, const Tile& tl, int n, int c,
                                           long long mask_bstride, float* msum, int* rslot) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < tl.ne; j += kWarps) {
    const T* mr = ms + (size_t)j * c;
    float a = 0.f;
    for (int ch = lane; ch < c / V; ch += 32) {
      float m[V];
      load16(mr + ch * V, m);
#pragma unroll
      for (int e = 0; e < V; ++e) a += m[e];
    }
    a = warp_sum(a);
    if (lane == 0) msum[j] = a;
  }
  if ((int)threadIdx.x < tl.nr)
    rslot[threadIdx.x] = mask_bstride ? (tl.off + (int)threadIdx.x) / n : 0;
}

// --- K3, tiled ---------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSM)
masked_ln_fwd_tiled_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                           long long mask_bstride, const float* __restrict__ w,
                           const float* __restrict__ b, T* __restrict__ y,
                           float2* __restrict__ stats, long long rows, int n, int c,
                           float eps, int tile_rows, int stages, int mask_rows) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Tile* metas = reinterpret_cast<Tile*>(smem + kTileSlots);
  float* ws = reinterpret_cast<float*>(smem + kHeader);
  float* bs = ws + c;
  float* msum =
      reinterpret_cast<float*>(smem + kHeader + round128(2 * (size_t)c * sizeof(float)));
  int* rslot = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(msum) +
                                      round128((size_t)mask_rows * sizeof(float)));
  unsigned char* ring = reinterpret_cast<unsigned char*>(rslot) +
                        round128((size_t)tile_rows * sizeof(int));
  const size_t stage_bytes = (size_t)(tile_rows + mask_rows) * c * sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nchunks = c / V;
  const int lanes = lanes_per_row(nchunks), per_warp = 32 / lanes, sub = lane & (lanes - 1);
  const Walk walk(rows, tile_rows);
  const uint64_t policy = evict_first();

  // the first tiles are under way before w and b are read
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) bar_init(&bars[s]);
    bar_init_fence();
    for (int s = 0; s < stages && s < walk.nt; ++s)
      issue_tile<T>(walk.tile(s, n, mask_bstride), c, tile_rows, x, nullptr, mask,
                    mask_bstride, ring + s * stage_bytes, &bars[s], &metas[s], policy);
  }
  for (int i = threadIdx.x; i < c; i += kThreads) {
    ws[i] = w[i];
    bs[i] = b[i];
  }
  __syncthreads();

  for (int k = 0; k < walk.nt; ++k) {
    const int s = k % stages;
    const T* xs = reinterpret_cast<const T*>(ring + s * stage_bytes);
    const T* ms = xs + (size_t)tile_rows * c;
    bar_wait(&bars[s], (k / stages) & 1);
    const Tile tl = metas[s];
    tile_masks(ms, tl, n, c, mask_bstride, msum, rslot);
    __syncthreads();
    // each warp's lane groups take rows base, base + 1, ...; every lane of the
    // warp runs the loop and the sums, a group past the tile's end on its last
    // row, storing nothing
    for (int base = warp * per_warp; base < tl.nr; base += kWarps * per_warp) {
      const bool valid = base + lane / lanes < tl.nr;
      const int r = valid ? base + lane / lanes : tl.nr - 1;
      const int slot = rslot[r];
      const T* xr = xs + (size_t)r * c;
      const T* mr = ms + (size_t)slot * c;
      float sx = 0.f, sxx = 0.f;
      for (int ch = sub; ch < nchunks; ch += lanes) {
        float v[V];
        load16(xr + ch * V, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          sx += v[e];
          sxx += v[e] * v[e];
        }
      }
      sx = row_sum(sx, lanes);
      sxx = row_sum(sxx, lanes);
      const float inv_p = 1.f / (msum[slot] / c);
      const float mu = (sx / c) * inv_p;
      const float var = (sxx / c) * inv_p - mu * mu;
      const float inv_std = rsqrtf(var + eps);
      if (!valid) continue;
      T* yr = y + (tl.r0 + r) * c;
      for (int ch = sub; ch < nchunks; ch += lanes) {
        float v[V], m[V], wv[V], bv[V], out[V];
        load16(xr + ch * V, v);
        load16(mr + ch * V, m);
        load_params(ws + ch * V, wv);
        load_params(bs + ch * V, bv);
#pragma unroll
        for (int e = 0; e < V; ++e) out[e] = (wv[e] * ((v[e] - mu) * inv_std) + bv[e]) * m[e];
        store16(yr + ch * V, out);
      }
      if (sub == 0) stats[tl.r0 + r] = make_float2(mu, inv_std);
    }
    __syncthreads();  // the stage is free
    if (threadIdx.x == 0 && k + stages < walk.nt)
      issue_tile<T>(walk.tile(k + stages, n, mask_bstride), c, tile_rows, x, nullptr, mask,
                    mask_bstride, ring + s * stage_bytes, &bars[s], &metas[s], policy);
  }
}

// --- K4, tiled: gx, and one (2, C) partial of gw, gb per block ------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM)
masked_ln_bwd_tiled_kernel(const T* __restrict__ x, const T* __restrict__ mask,
                           long long mask_bstride, const float* __restrict__ w,
                           const float2* __restrict__ stats, const T* __restrict__ g,
                           T* __restrict__ gx, float* __restrict__ partial, long long rows,
                           int n, int c, int tile_rows, int stages, int mask_rows) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  Tile* metas = reinterpret_cast<Tile*>(smem + kTileSlots);
  float* ws = reinterpret_cast<float*>(smem + kHeader);
  float* msum = reinterpret_cast<float*>(smem + kHeader + round128((size_t)c * sizeof(float)));
  float2* rstat = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(msum) +
                                            round128((size_t)mask_rows * sizeof(float)));
  int* rslot = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(rstat) +
                                      round128((size_t)tile_rows * sizeof(float2)));
  unsigned char* ring = reinterpret_cast<unsigned char*>(rslot) +
                        round128((size_t)tile_rows * sizeof(int));
  const size_t stage_bytes = (size_t)(2 * tile_rows + mask_rows) * c * sizeof(T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nchunks = c / V;
  const int lanes = lanes_per_row(nchunks), per_warp = 32 / lanes, sub = lane & (lanes - 1);
  const int nphase = fold_phases(nchunks), nslots = nphase * nchunks;
  const Walk walk(rows, tile_rows);
  const uint64_t policy = evict_first();

  // thread r holds the statistics of row r of tile j, loaded one tile ahead
  // (tile j's Tile is read once a barrier has passed since it was staged)
  auto row_stats = [&](int j) {
    if (j >= walk.nt) return make_float2(0.f, 0.f);
    const Tile& tl = metas[j % stages];
    return (int)threadIdx.x < tl.nr ? stats[tl.r0 + threadIdx.x] : make_float2(0.f, 0.f);
  };

  // the first tiles are under way before w is read
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) bar_init(&bars[s]);
    bar_init_fence();
    for (int s = 0; s < stages && s < walk.nt; ++s)
      issue_tile<T>(walk.tile(s, n, mask_bstride), c, tile_rows, x, g, mask, mask_bstride,
                    ring + s * stage_bytes, &bars[s], &metas[s], policy);
  }
  for (int i = threadIdx.x; i < c; i += kThreads) ws[i] = w[i];
  __syncthreads();

  float accw[2][V], accb[2][V];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int e = 0; e < V; ++e) accw[q][e] = accb[q][e] = 0.f;

  float2 st_next = row_stats(0);
  for (int k = 0; k < walk.nt; ++k) {
    const int s = k % stages;
    const T* xs = reinterpret_cast<const T*>(ring + s * stage_bytes);
    const T* gs = xs + (size_t)tile_rows * c;
    const T* ms = gs + (size_t)tile_rows * c;
    bar_wait(&bars[s], (k / stages) & 1);
    const Tile tl = metas[s];
    if ((int)threadIdx.x < tl.nr) rstat[threadIdx.x] = st_next;
    tile_masks(ms, tl, n, c, mask_bstride, msum, rslot);
    __syncthreads();
    st_next = row_stats(k + 1);

    // rows: lane groups as in K3, gx straight to memory
    for (int base = warp * per_warp; base < tl.nr; base += kWarps * per_warp) {
      const bool valid = base + lane / lanes < tl.nr;
      const int r = valid ? base + lane / lanes : tl.nr - 1;
      const int slot = rslot[r];
      const float2 rs = rstat[r];
      const float mu = rs.x, inv_std = rs.y;
      const T* xr = xs + (size_t)r * c;
      const T* gr = gs + (size_t)r * c;
      const T* mr = ms + (size_t)slot * c;
      float s_dz = 0.f, s_zdz = 0.f;
      for (int ch = sub; ch < nchunks; ch += lanes) {
        float v[V], gv[V], m[V], wv[V];
        load16(xr + ch * V, v);
        load16(gr + ch * V, gv);
        load16(mr + ch * V, m);
        load_params(ws + ch * V, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float z = (v[e] - mu) * inv_std;
          const float dz = gv[e] * m[e] * wv[e];
          s_dz += dz;
          s_zdz += z * dz;
        }
      }
      s_dz = row_sum(s_dz, lanes);
      s_zdz = row_sum(s_zdz, lanes);
      if (!valid) continue;
      const float inv_p = 1.f / (msum[slot] / c);
      const float mean_dz = s_dz / c, mean_zdz = s_zdz / c;
      T* gxr = gx + (tl.r0 + r) * c;
      for (int ch = sub; ch < nchunks; ch += lanes) {
        float v[V], gv[V], m[V], wv[V], out[V];
        load16(xr + ch * V, v);
        load16(gr + ch * V, gv);
        load16(mr + ch * V, m);
        load_params(ws + ch * V, wv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float z = (v[e] - mu) * inv_std;
          const float dz = gv[e] * m[e] * wv[e];
          out[e] = (dz - (mean_dz + z * mean_zdz) * inv_p) * inv_std;
        }
        store16(gxr + ch * V, out);
      }
    }

    // columns: each slot adds its phase's rows of the tile in row order
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int sl = threadIdx.x + q * kThreads;
      if (sl < nslots) {
        const int ch = sl % nchunks;
        for (int r = sl / nchunks; r < tl.nr; r += nphase) {
          const float2 rs = rstat[r];
          float v[V], gv[V], m[V];
          load16(xs + (size_t)r * c + ch * V, v);
          load16(gs + (size_t)r * c + ch * V, gv);
          load16(ms + (size_t)rslot[r] * c + ch * V, m);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float gf = gv[e] * m[e];
            accw[q][e] += gf * ((v[e] - rs.x) * rs.y);
            accb[q][e] += gf;
          }
        }
      }
    }
    __syncthreads();  // the stage is free
    if (threadIdx.x == 0 && k + stages < walk.nt)
      issue_tile<T>(walk.tile(k + stages, n, mask_bstride), c, tile_rows, x, g, mask,
                    mask_bstride, ring + s * stage_bytes, &bars[s], &metas[s], policy);
  }

  // fold the phases in order, in the ring's space (every staged tile was waited
  // for, and the loop's last barrier passed): red[phase][2C], gw then gb
  float* red = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int sl = threadIdx.x + q * kThreads;
    if (sl < nslots) {
      float* out = red + (size_t)(sl / nchunks) * 2 * c + (sl % nchunks) * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        out[e] = accw[q][e];
        out[c + e] = accb[q][e];
      }
    }
  }
  __syncthreads();
  float* part = partial + (long long)blockIdx.x * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += kThreads) {
    float a = 0.f;
    for (int p = 0; p < nphase; ++p) a += red[(size_t)p * 2 * c + i];
    part[i] = a;
  }
}

// --- the general path: a warp per row, 4-element loads ---------------------------

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

// --- K4's second launch: the partials folded in a fixed order --------------------

// Block: 32 columns of the (nparts, 2C) partials (column i < C is gw, else gb);
// warp q sums partials q, q + 8, ... in order, then the warps' sums in order.
__global__ void __launch_bounds__(kThreads)
masked_ln_bwd_fold_kernel(const float* __restrict__ partial, int nparts, int c,
                          float* __restrict__ gw, float* __restrict__ gb) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, q = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (i < 2 * c) {
#pragma unroll 4
    for (int p = q; p < nparts; p += kWarps) a += partial[(long long)p * 2 * c + i];
  }
  red[q][lane] = a;
  __syncthreads();
  if (q == 0 && i < 2 * c) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k][lane];
    if (i < c) gw[i] = s; else gb[i - c] = s;
  }
}

// --- launches ---------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the tiled path's own conditions; the wrapper sends nothing else to it
bool tiled_ok(bool bwd, int c, int esize, int tile_rows, int grid, int stages, int mask_rows,
              long long smem, const void* x, const void* g, const void* mask, const void* y) {
  return (size_t)c * esize % 16 == 0 && tile_rows >= 1 && tile_rows <= kMaxTileRows &&
         grid >= 1 && stages >= 2 && stages <= kMaxStages && mask_rows >= 1 &&
         smem == (long long)tiled_smem_bytes(bwd, c, esize, tile_rows, stages, mask_rows) &&
         aligned16(x) && aligned16(mask) && aligned16(y) && (!g || aligned16(g));
}

template <typename T>
int fwd_tiled(const void* x, const void* mask, long long mask_bstride, const void* w,
              const void* b, void* y, void* stats, long long rows, int n, int c, float eps,
              int tile_rows, int grid, int stages, int mask_rows, long long smem,
              cudaStream_t stream) {
  if (!tiled_ok(false, c, sizeof(T), tile_rows, grid, stages, mask_rows, smem, x, nullptr,
                mask, y))
    return (int)cudaErrorInvalidValue;
  auto kernel = masked_ln_fwd_tiled_kernel<T>;
  int rc = prepare(kernel, (size_t)smem);
  if (rc) return rc;
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), mask_bstride,
      static_cast<const float*>(w), static_cast<const float*>(b), static_cast<T*>(y),
      static_cast<float2*>(stats), rows, n, c, eps, tile_rows, stages, mask_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd_tiled(const void* x, const void* mask, long long mask_bstride, const void* w,
              const void* stats, const void* g, void* gx, void* partial, int nparts,
              long long rows, int n, int c, int tile_rows, int stages, int mask_rows,
              long long smem, cudaStream_t stream) {
  if (!tiled_ok(true, c, sizeof(T), tile_rows, nparts, stages, mask_rows, smem, x, g, mask,
                gx))
    return (int)cudaErrorInvalidValue;
  auto kernel = masked_ln_bwd_tiled_kernel<T>;
  int rc = prepare(kernel, (size_t)smem);
  if (rc) return rc;
  kernel<<<nparts, kThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), mask_bstride,
      static_cast<const float*>(w), static_cast<const float2*>(stats),
      static_cast<const T*>(g), static_cast<T*>(gx), static_cast<float*>(partial), rows, n,
      c, tile_rows, stages, mask_rows);
  return (int)cudaGetLastError();
}

template <typename T, int CPL>
int fwd_general(const void* x, const void* mask, long long mask_bstride, const void* w,
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
int bwd_general(const void* x, const void* mask, long long mask_bstride, const void* w,
                const void* stats, const void* g, void* gx, void* partial, int nparts,
                int rows, int n, int c, cudaStream_t stream) {
  masked_ln_bwd_kernel<T, CPL><<<nparts, kThreads, 2 * c * sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(mask), mask_bstride,
      static_cast<const float*>(w), static_cast<const float2*>(stats),
      static_cast<const T*>(g), static_cast<T*>(gx), static_cast<float*>(partial),
      rows, n, c);
  return (int)cudaGetLastError();
}

int fold(const void* partial, int nparts, int c, void* gw, void* gb, cudaStream_t stream) {
  masked_ln_bwd_fold_kernel<<<(2 * c + 31) / 32, kThreads, 0, stream>>>(
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
// broadcast one mask row over the batch). tile_rows = 0 takes the general path
// (grid and the rest unused); otherwise the tiled path with that plan.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for what neither takes.
int vst_masked_ln_fwd(const void* x, const void* mask, long long mask_bstride,
                      const void* w, const void* b, void* y, void* stats, long long rows,
                      int n, int c, float eps, int dtype, int tile_rows, int grid, int stages,
                      int mask_rows, long long smem, void* stream) {
  if (c % 4 != 0 || rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows > 0) {
    if (dtype == 1)
      return fwd_tiled<__nv_bfloat16>(x, mask, mask_bstride, w, b, y, stats, rows, n, c, eps,
                                      tile_rows, grid, stages, mask_rows, smem, s);
    if (dtype == 0)
      return fwd_tiled<float>(x, mask, mask_bstride, w, b, y, stats, rows, n, c, eps,
                              tile_rows, grid, stages, mask_rows, smem, s);
    return (int)cudaErrorInvalidValue;
  }
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
#define VST_FWD(T, CPL) \
  return fwd_general<T, CPL>(x, mask, mask_bstride, w, b, y, stats, (int)rows, n, c, eps, s)
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

// partial: float32 scratch of (nparts, 2, c), one per block of the first
// launch; gw, gb: float32 (c,), written by the fold.
int vst_masked_ln_bwd(const void* x, const void* mask, long long mask_bstride,
                      const void* w, const void* stats, const void* g, void* gx,
                      void* partial, int nparts, void* gw, void* gb, long long rows, int n,
                      int c, int dtype, int tile_rows, int stages, int mask_rows,
                      long long smem, void* stream) {
  if (c % 4 != 0 || nparts < 1 || rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
  if (tile_rows > 0) {
    if (dtype == 1)
      rc = bwd_tiled<__nv_bfloat16>(x, mask, mask_bstride, w, stats, g, gx, partial, nparts,
                                    rows, n, c, tile_rows, stages, mask_rows, smem, s);
    else if (dtype == 0)
      rc = bwd_tiled<float>(x, mask, mask_bstride, w, stats, g, gx, partial, nparts, rows, n,
                            c, tile_rows, stages, mask_rows, smem, s);
  } else if (rows <= 0x7fffffffLL) {
#define VST_BWD(T, CPL)                                                                 \
  rc = bwd_general<T, CPL>(x, mask, mask_bstride, w, stats, g, gx, partial, nparts,     \
                           (int)rows, n, c, s);                                         \
  break
#define VST_BWD_CPL(T)                 \
  switch (pick_cpl(c)) {               \
    case 1: VST_BWD(T, 1);             \
    case 2: VST_BWD(T, 2);             \
    case 4: VST_BWD(T, 4);             \
    case 8: VST_BWD(T, 8);             \
    case 16: VST_BWD(T, 16);           \
    default: break;                    \
  }
    if (dtype == 1) { VST_BWD_CPL(__nv_bfloat16) }
    else if (dtype == 0) { VST_BWD_CPL(float) }
#undef VST_BWD_CPL
#undef VST_BWD
  }
  if (rc) return rc;
  return fold(partial, nparts, c, gw, gb, s);
}

}  // extern "C"
