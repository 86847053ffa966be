// Batch norm with the ReLU after it fused, for Hopper (sm_90a): B1 (forward:
// statistics, then normalize) and B2 (backward), the conv stem's norms
// (models/patch_embed.py) in train and in eval mode.
//
// Replaces no TPU kernel: the JAX package leaves flax's nn.BatchNorm to XLA
// (vit_search_tpu/models/patch_embed.py:62), which fuses it. Flax's rule, per
// channel c over the n elements of that channel (every process's):
//   mean = sum x / n;  var = max(sum x^2 / n - mean^2, 0)         (float32)
//   mul = rsqrt(var + eps) * w;  z = (x - mean) * mul + b;  y = relu ? max(z, 0) : z
// and, with g = dy * [z > 0] (dy without the ReLU), xh = (x - mean) * rsqrt(var + eps):
//   db = sum g;  dw = sum g * xh;  dx = mul * (g - DB / n - xh * DW / n)
// where DB, DW are db, dw summed over the processes. In eval mode mean and var
// are the running statistics, which x does not move: the wrapper passes
// inv_n = 0 and the sums' terms of dx vanish.
//
// x is (outer, C, inner), contiguous: an NCHW tensor gives (B, C, H*W) and a
// channels-last one (B*H*W, C, 1), each read in place. x, y, dy and dx are
// bfloat16 or float32 (one type per call); the statistics, w, b and the sums
// are float32. Every element is computed in float32 registers; no float32
// copy of an activation is made.
//
// What bounds it on this card: bytes. Each element costs a few flops, and the
// forward reads x twice (statistics, normalize) and writes y once; the
// backward reads x and dy twice (sums, dx) and writes dx once. Design:
// - one pass kernel per layout, templated on the pass (statistics, normalize,
//   backward sums, dx); each thread owns up to 8 channels and reads them as
//   one 16-byte vector (8 bf16 or 4 f32) where the channel count (channels
//   last) or the plane (NCHW) and the pointers allow it, else one element;
// - channels last: a block's threads split one row of C channels (at most
//   256 vectors of it: wider rows are cut into channel tiles, grid y) and
//   walk the block's rows, so a warp reads consecutive bytes; with C = 24 in
//   bf16 three threads cover a row and 85 rows are read at once;
// - NCHW: a block takes one channel (grid y) and a share of the batch, and
//   walks its planes;
// - the reductions (statistics, backward sums) leave one float32 pair per
//   channel per block, summed in a fixed order inside the block; a second
//   launch folds the blocks' pairs in a fixed order, a warp per channel. No
//   atomics: repeated runs give the same bits. The statistics' fold also
//   finishes the statistics (mean, var) and moves the running statistics;
//   with a process group it only sums, and vst_bn_finalize finishes after
//   the wrapper's all-reduce.
// Grids are the occupancy's blocks per SM times the SMs, fewer where the work
// is smaller, and at most max_parts blocks for a reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Pass { kStats = 0, kApply = 1, kBwdSums = 2, kBwdDx = 3 };

struct Args {
  const void* x;
  const void* dy;
  void* out;
  long long outer, inner;
  int c;
  int tile_c;                       // channels last: the channels of one block
  const float* mean;
  const float* var;
  const float* w;
  const float* b;
  const float* s0;                  // dx: the processes' sum g
  const float* s1;                  // dx: the processes' sum g * xh
  float eps, inv_n;
  float* parts;                     // reductions: (gridDim.x, 2, C)
};

// 16 bytes of x, or one element, as loaded
template <typename T, int V>
struct Raw {
  uint4 v;
};
template <typename T>
struct Raw<T, 1> {
  T v;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load(const T* p) {
  if constexpr (V == 1) {
    return {p[0]};
  } else {
    return {*reinterpret_cast<const uint4*>(p)};
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_float(r.v);
  } else if constexpr (sizeof(T) == 4) {
    f[0] = __uint_as_float(r.v.x);
    f[1] = __uint_as_float(r.v.y);
    f[2] = __uint_as_float(r.v.z);
    f[3] = __uint_as_float(r.v.w);
  } else {
    const uint32_t w[4] = {r.v.x, r.v.y, r.v.z, r.v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  if constexpr (V == 1) {
    from_float(f[0], p);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                                              __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 t = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&t);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One channel's constants. The normalize's arithmetic is the plain
// version's, rounding for rounding: rsqrt(var + eps) * w, then
// (x - mean) * mul + b, so the backward finds the forward's ReLU mask.
struct Chan {
  float mean, mul, b, rstd, ka, q;
};

template <int P>
__device__ __forceinline__ Chan channel(const Args& a, int c) {
  Chan k{};
  if constexpr (P != kStats) {
    k.mean = a.mean[c];
    k.rstd = rsqrtf(__fadd_rn(a.var[c], a.eps));
    k.mul = __fmul_rn(k.rstd, a.w[c]);
    k.b = a.b[c];
    if constexpr (P == kBwdDx) {
      k.ka = k.mul * (a.s0[c] * a.inv_n);
      k.q = k.mul * (a.s1[c] * a.inv_n) * k.rstd;
    }
  }
  return k;
}

// one element: accumulate (statistics, backward sums) or compute the output
template <int P, bool RELU>
__device__ __forceinline__ void element(const Chan& k, float x, float dy, float& a0, float& a1,
                                        float& out) {
  if constexpr (P == kStats) {
    a0 += x;
    a1 += x * x;
  } else {
    const float d = __fsub_rn(x, k.mean);
    const float z = __fadd_rn(__fmul_rn(d, k.mul), k.b);
    if constexpr (P == kApply) {
      out = (RELU && z <= 0.f) ? 0.f : z;
    } else {
      const float g = (RELU && z <= 0.f) ? 0.f : dy;
      if constexpr (P == kBwdSums) {
        a0 += g;
        a1 += g * (d * k.rstd);
      } else {
        out = k.mul * g - (k.ka + d * k.q);
      }
    }
  }
}

template <int P>
__host__ __device__ constexpr bool reduces() { return P == kStats || P == kBwdSums; }
template <int P>
__host__ __device__ constexpr bool reads_dy() { return P == kBwdSums || P == kBwdDx; }
template <int P>
__host__ __device__ constexpr bool writes() { return P == kApply || P == kBwdDx; }
// vectors in flight per thread: two of x and dy where the pass reads both
template <int P>
__host__ __device__ constexpr int unroll() { return reads_dy<P>() ? 2 : 4; }

// V elements at x[off], dy[off]: the pass's work on them, output to out[off];
// k holds each element's channel (channels last) or, ONE, their one channel
template <typename T, int V, int P, bool RELU, bool ONE>
__device__ __forceinline__ void vector_step(const Args& a, const Chan* k, const Raw<T, V>& xr,
                                            const Raw<T, V>& gr, long long off, float* a0,
                                            float* a1) {
  float xv[V], gv[V], ov[V];
  unpack<T, V>(xr, xv);
  if constexpr (reads_dy<P>()) unpack<T, V>(gr, gv);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const Chan& ke = k[ONE ? 0 : e];
    element<P, RELU>(ke, xv[e], reads_dy<P>() ? gv[e] : 0.f, a0[e], a1[e], ov[e]);
  }
  if constexpr (writes<P>()) store<T, V>(static_cast<T*>(a.out) + off, ov);
}

// Channels last, (outer, C, 1): thread t owns channels c0 .. c0 + V - 1 of
// the block's tile and rows rl, rl + rpar, ... of the block's share.
template <typename T, int V, int P, bool RELU>
__global__ void __launch_bounds__(kThreads) bn_rows_kernel(const Args a) {
  constexpr int U = unroll<P>();
  const int cv = a.tile_c / V;
  const int rpar = kThreads / cv;
  const int t = threadIdx.x;
  const int chunk = t % cv, rl = t / cv;
  const int c0 = blockIdx.y * a.tile_c + chunk * V;
  const long long r_begin = a.outer * blockIdx.x / gridDim.x;
  const long long r_end = a.outer * (blockIdx.x + 1) / gridDim.x;
  float a0[V], a1[V];
#pragma unroll
  for (int e = 0; e < V; ++e) a0[e] = a1[e] = 0.f;
  if (rl < rpar && c0 < a.c) {
    Chan k[V];
#pragma unroll
    for (int e = 0; e < V; ++e) k[e] = channel<P>(a, c0 + e);
    const T* x = static_cast<const T*>(a.x);
    const T* dy = static_cast<const T*>(a.dy);
    long long r = r_begin + rl;
    for (; r + (long long)(U - 1) * rpar < r_end; r += (long long)U * rpar) {
      Raw<T, V> xr[U], gr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long off = (r + (long long)u * rpar) * a.c + c0;
        xr[u] = load<T, V>(x + off);
        if constexpr (reads_dy<P>()) gr[u] = load<T, V>(dy + off);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        vector_step<T, V, P, RELU, false>(a, k, xr[u], gr[u],
                                          (r + (long long)u * rpar) * a.c + c0, a0, a1);
    }
    for (; r < r_end; r += rpar) {
      const long long off = r * a.c + c0;
      Raw<T, V> xr = load<T, V>(x + off), gr{};
      if constexpr (reads_dy<P>()) gr = load<T, V>(dy + off);
      vector_step<T, V, P, RELU, false>(a, k, xr, gr, off, a0, a1);
    }
  }
  if constexpr (reduces<P>()) {
    // thread t's channels sit at t * V = rl * tile_c + chunk * V
    __shared__ float red[2][kThreads * V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      red[0][t * V + e] = a0[e];
      red[1][t * V + e] = a1[e];
    }
    __syncthreads();
    const int width = min(a.tile_c, a.c - (int)blockIdx.y * a.tile_c);
    for (int j = t; j < width; j += kThreads) {
      float s0 = 0.f, s1 = 0.f;
      for (int q = 0; q < rpar; ++q) {
        s0 += red[0][q * a.tile_c + j];
        s1 += red[1][q * a.tile_c + j];
      }
      const long long ch = (long long)blockIdx.y * a.tile_c + j;
      a.parts[(2LL * blockIdx.x) * a.c + ch] = s0;
      a.parts[(2LL * blockIdx.x + 1) * a.c + ch] = s1;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// NCHW, (outer, C, inner): the block takes channel blockIdx.y and a share of
// the batch, and its threads walk each plane of inner elements.
template <typename T, int V, int P, bool RELU>
__global__ void __launch_bounds__(kThreads) bn_planes_kernel(const Args a) {
  constexpr int U = unroll<P>();
  const int c = blockIdx.y;
  const long long b_begin = a.outer * blockIdx.x / gridDim.x;
  const long long b_end = a.outer * (blockIdx.x + 1) / gridDim.x;
  const long long iv = a.inner / V;
  const Chan k = channel<P>(a, c);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  float a0[V], a1[V];
#pragma unroll
  for (int e = 0; e < V; ++e) a0[e] = a1[e] = 0.f;
  for (long long bi = b_begin; bi < b_end; ++bi) {
    const long long base = (bi * a.c + c) * a.inner;
    long long i = threadIdx.x;
    for (; i + (long long)(U - 1) * kThreads < iv; i += (long long)U * kThreads) {
      Raw<T, V> xr[U], gr[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long off = base + (i + (long long)u * kThreads) * V;
        xr[u] = load<T, V>(x + off);
        if constexpr (reads_dy<P>()) gr[u] = load<T, V>(dy + off);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        vector_step<T, V, P, RELU, true>(a, &k, xr[u], gr[u],
                                         base + (i + (long long)u * kThreads) * V, a0, a1);
    }
    for (; i < iv; i += kThreads) {
      const long long off = base + i * V;
      Raw<T, V> xr = load<T, V>(x + off), gr{};
      if constexpr (reads_dy<P>()) gr = load<T, V>(dy + off);
      vector_step<T, V, P, RELU, true>(a, &k, xr, gr, off, a0, a1);
    }
  }
  if constexpr (reduces<P>()) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s0 += a0[e];
      s1 += a1[e];
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    __shared__ float red[2][kWarps];
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[0][warp] = s0;
      red[1][warp] = s1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      s0 = s1 = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        s0 += red[0][w];
        s1 += red[1][w];
      }
      a.parts[(2LL * blockIdx.x) * a.c + c] = s0;
      a.parts[(2LL * blockIdx.x + 1) * a.c + c] = s1;
    }
  }
}

struct Fold {
  const float* parts;               // (nparts, 2, C)
  int nparts, c;
  float* out0;                      // the sums, or mean
  float* out1;                      // the sums, or the biased var
  int finalize;
  float n, momentum, one_minus_m;
  float* running_mean;              // moved where finalize
  float* running_var;
};

// a warp per channel: lane l sums parts l, l + 32, ..., then a butterfly
__global__ void __launch_bounds__(kThreads) bn_fold_kernel(const Fold f) {
  const int ch = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (ch >= f.c) return;
  float s0 = 0.f, s1 = 0.f;
  for (int p = lane; p < f.nparts; p += 32) {
    s0 += f.parts[(2LL * p) * f.c + ch];
    s1 += f.parts[(2LL * p + 1) * f.c + ch];
  }
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  if (lane != 0) return;
  if (!f.finalize) {
    f.out0[ch] = s0;
    f.out1[ch] = s1;
    return;
  }
  const float mean = __fdiv_rn(s0, f.n);
  float var = __fsub_rn(__fdiv_rn(s1, f.n), __fmul_rn(mean, mean));
  var = var < 0.f ? 0.f : var;
  f.out0[ch] = mean;
  f.out1[ch] = var;
  f.running_mean[ch] = __fadd_rn(__fmul_rn(f.running_mean[ch], f.momentum),
                                 __fmul_rn(f.one_minus_m, mean));
  f.running_var[ch] = __fadd_rn(__fmul_rn(f.running_var[ch], f.momentum),
                                __fmul_rn(f.one_minus_m, var));
}

int fold(const Fold& f, cudaStream_t s) {
  bn_fold_kernel<<<(f.c + kWarps - 1) / kWarps, kThreads, 0, s>>>(f);
  return (int)cudaGetLastError();
}

template <typename T, int V, int P, bool RELU>
int launch_vec(Args a, int sms, int max_parts, cudaStream_t s, int* blocks) {
  const bool planes = a.inner > 1;
  void (*kernel)(const Args) = bn_rows_kernel<T, V, P, RELU>;
  if (planes) kernel = bn_planes_kernel<T, V, P, RELU>;
  static int occupancy[2] = {0, 0};   // blocks per SM, by layout
  int& occ = occupancy[planes];
  if (occ == 0) {
    int got = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, kernel,
                                                                           kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    occ = got > 0 ? got : 1;
  }
  const long long target = (long long)occ * sms;
  long long gx;
  int gy;
  if (planes) {
    if (a.c > 65535) return (int)cudaErrorInvalidValue;
    gy = a.c;
    gx = (target + a.c - 1) / a.c;
    if (gx > a.outer) gx = a.outer;
  } else {
    a.tile_c = a.c < kThreads * V ? a.c : kThreads * V;
    gy = (a.c + a.tile_c - 1) / a.tile_c;
    const long long rows_at_once = (long long)(kThreads / (a.tile_c / V)) * unroll<P>();
    gx = (target + gy - 1) / gy;
    const long long work = (a.outer + rows_at_once - 1) / rows_at_once;
    if (gx > work) gx = work;
  }
  if (gx > max_parts) gx = max_parts;
  if (gx < 1) gx = 1;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, s>>>(a);
  *blocks = (int)gx;
  return (int)cudaGetLastError();
}

// 16-byte vectors where the pointers are aligned and the rows (channels
// last) or planes (NCHW) are whole vectors, else one element at a time
template <typename T, int P, bool RELU>
int launch_t(const Args& a, int sms, int max_parts, cudaStream_t s, int* blocks) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.dy) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const bool whole = a.inner > 1 ? a.inner % V == 0 : a.c % V == 0;
  if (aligned && whole) return launch_vec<T, V, P, RELU>(a, sms, max_parts, s, blocks);
  return launch_vec<T, 1, P, RELU>(a, sms, max_parts, s, blocks);
}

template <int P, bool RELU>
int launch_p(const Args& a, int dtype, int sms, int max_parts, cudaStream_t s, int* blocks) {
  if (dtype == 1) return launch_t<__nv_bfloat16, P, RELU>(a, sms, max_parts, s, blocks);
  if (dtype == 0) return launch_t<float, P, RELU>(a, sms, max_parts, s, blocks);
  return (int)cudaErrorInvalidValue;
}

template <int P>
int launch(const Args& a, int dtype, int relu, int sms, int max_parts, cudaStream_t s,
           int* blocks) {
  if (a.outer < 1 || a.inner < 1 || a.c < 1 || sms < 1 || max_parts < 1)
    return (int)cudaErrorInvalidValue;
  if (relu) return launch_p<P, true>(a, dtype, sms, max_parts, s, blocks);
  return launch_p<P, false>(a, dtype, sms, max_parts, s, blocks);
}

Args shape(const void* x, long long outer, int c, long long inner) {
  Args a{};
  a.x = x;
  a.outer = outer;
  a.c = c;
  a.inner = inner;
  return a;
}

void affine(Args& a, const float* mean, const float* var, const float* w, const float* b,
            float eps) {
  a.mean = mean;
  a.var = var;
  a.w = w;
  a.b = b;
  a.eps = eps;
}

}  // namespace

extern "C" {

// x: (outer, c, inner) contiguous, dtype 0 = float32, 1 = bfloat16. Every
// function returns cudaGetLastError() after its launches (0 on success).
//
// B1, statistics: parts holds (max_parts, 2, c) floats of scratch. With
// finalize, out0 / out1 get the mean and the biased variance over n elements
// and the running statistics move by momentum; without, out0 / out1 get the
// channel sums of x and x^2.
int vst_bn_stats(const void* x, long long outer, int c, long long inner, int dtype,
                 float* parts, int max_parts, float* out0, float* out1, int finalize, float n,
                 float momentum, float one_minus_m, float* running_mean, float* running_var,
                 int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a = shape(x, outer, c, inner);
  a.dy = a.out = nullptr;
  a.parts = parts;
  int blocks = 0;
  const int rc = launch<kStats>(a, dtype, 0, sms, max_parts, s, &blocks);
  if (rc != 0) return rc;
  return fold(Fold{parts, blocks, c, out0, out1, finalize, n, momentum, one_minus_m,
                   running_mean, running_var}, s);
}

// B1's finish after an all-reduce of the sums: sums (2, c) -> mean, var and
// the running statistics, as vst_bn_stats with finalize
int vst_bn_finalize(const float* sums, int c, float* mean, float* var, float n, float momentum,
                    float one_minus_m, float* running_mean, float* running_var, void* stream) {
  if (c < 1) return (int)cudaErrorInvalidValue;
  return fold(Fold{sums, 1, c, mean, var, 1, n, momentum, one_minus_m, running_mean,
                   running_var}, static_cast<cudaStream_t>(stream));
}

// B1, normalize: y (as x) = (x - mean) * rsqrt(var + eps) * w + b, then ReLU
// where relu
int vst_bn_apply(const void* x, void* y, long long outer, int c, long long inner, int dtype,
                 const float* mean, const float* var, const float* w, const float* b, float eps,
                 int relu, int sms, void* stream) {
  Args a = shape(x, outer, c, inner);
  a.dy = x;
  a.out = y;
  affine(a, mean, var, w, b, eps);
  int blocks = 0;
  return launch<kApply>(a, dtype, relu, sms, 1 << 30, static_cast<cudaStream_t>(stream),
                        &blocks);
}

// B2, sums: db = sum g, dw = sum g * xh over this process's elements
int vst_bn_bwd_sums(const void* x, const void* dy, long long outer, int c, long long inner,
                    int dtype, const float* mean, const float* var, const float* w,
                    const float* b, float eps, int relu, float* parts, int max_parts, float* db,
                    float* dw, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a = shape(x, outer, c, inner);
  a.dy = dy;
  a.out = nullptr;
  affine(a, mean, var, w, b, eps);
  a.parts = parts;
  int blocks = 0;
  const int rc = launch<kBwdSums>(a, dtype, relu, sms, max_parts, s, &blocks);
  if (rc != 0) return rc;
  return fold(Fold{parts, blocks, c, db, dw, 0, 1.f, 0.f, 0.f, nullptr, nullptr}, s);
}

// B2, dx (as x) = mul * (g - s0 * inv_n - xh * s1 * inv_n), s0 / s1 the
// processes' db / dw
int vst_bn_bwd_dx(const void* x, const void* dy, void* dx, long long outer, int c,
                  long long inner, int dtype, const float* mean, const float* var,
                  const float* w, const float* b, float eps, int relu, const float* s0,
                  const float* s1, float inv_n, int sms, void* stream) {
  Args a = shape(x, outer, c, inner);
  a.dy = dy;
  a.out = dx;
  affine(a, mean, var, w, b, eps);
  a.s0 = s0;
  a.s1 = s1;
  a.inv_n = inv_n;
  int blocks = 0;
  return launch<kBwdDx>(a, dtype, relu, sms, 1 << 30, static_cast<cudaStream_t>(stream),
                        &blocks);
}

}  // extern "C"
