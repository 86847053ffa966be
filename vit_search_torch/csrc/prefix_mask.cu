// Supernet prefix masks and stochastic depth applied inside the elementwise
// passes that already read and write the data, for Hopper (sm_90a):
//   M1 prefix_gelu_fwd   y  = gelu(h) * [c < n_b]
//      prefix_gelu_bwd   dh = gelu'(h) * g * [c < n_b]
//   M2 branch_add        out = x + f * s_b * [c < n_b]
//   M3 prefix_scale      y  = g * s_b * [c < n_b]
// over contiguous (B, N, C) tensors, with b = row / N. Every supernet mask
// keeps a prefix of channels (ops/masking.py), so example b's mask is
// c < n_b for a (B,) int32 count vector n; s_b is drop path's per-example
// scale keep_b / keep_prob (float32). A null n keeps every channel, a null s
// is 1.
//
// Replaces no TPU kernel: the JAX package multiplies by boolean masks and
// draws drop path with jnp ops (vit_search_tpu/models/layers.py) and XLA
// fuses them into their neighbours. In PyTorch each multiply, drop path's
// divide, fill and where, and the residual add are passes of their own.
//
// What bounds them on this card: bytes. Each element costs a few flops (an
// erf or tanh in M1). Design:
// - 16-byte vectors (8 bf16 or 4 f32) where C and the pointers allow, else
//   one element a lane; each thread takes kUnroll vectors a block-width
//   apart, finds their counts and scales, issues all their loads (kept
//   packed, few registers, so that four blocks fit an SM), then computes, so
//   that many loads are in flight;
// - the vector's row, column and example come from two divisions by
//   invariants (multiply-high with a magic number, as PyTorch's IntDivider);
// - a vector wholly past its example's count, or of an example whose scale is
//   0, reads nothing it does not need: M1 and M3 write zeros without a load,
//   M2 copies x without reading f;
// - float32 in registers, one rounding to the output type; M2 and M3 multiply
//   and add without contraction, as the plain version rounds;
// - M1's erf: CUDA's erff nearly sets M1's time (at Tiny's stage 1 on the
//   H100, 71% of the HBM bound forward, 78% backward, against 85% and 90%
//   with the cheaper form), so a bf16 output takes one_plus_erf's FAST form,
//   accurate far past bf16's rounding.
// The tanh form of GELU, and the erf form for float32 outputs, with their
// derivatives, are PyTorch's (ATen's GeluCUDAKernelImpl /
// GeluBackwardCUDAKernelImpl), in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMinBlocks = 4;   // blocks an SM: at most 64 registers a thread

enum Op { kGeluFwd = 0, kGeluBwd = 1, kBranchAdd = 2, kScale = 3 };

// math.h's M_SQRT2, M_2_SQRTPI and M_SQRT1_2, which strict C++17 hides
constexpr double kSqrt2 = 1.41421356237309504880;
constexpr double k2SqrtPi = 1.12837916709551257390;
constexpr double kSqrt1_2 = 0.70710678118654752440;

// n / d for n, d < 2^31: (umulhi(n, m) + n) >> s
struct FastDiv {
  unsigned d, m, s;
};

__device__ __forceinline__ unsigned divide(const FastDiv& f, unsigned n) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct Args {
  const void* a;         // h (M1), x (M2), g (M3)
  const void* b;         // g (M1 backward), f (M2)
  void* out;
  const int* counts;     // (B,) or null: every channel kept
  const float* scale;    // (B,) or null: 1
  FastDiv row;           // vectors per row
  FastDiv example;       // vectors per example (N rows)
  unsigned total;        // vectors
  int tanh_form;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes (V > 1) or one element, as loaded: kept packed until the compute
// so that the loads in flight cost few registers
template <typename T, int V>
struct Raw {
  uint4 v;
};
template <typename T>
struct Raw<T, 1> {
  T v;
};

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
    if constexpr (sizeof(T) == 4) {
      p[0] = f[0];
    } else {
      p[0] = __float2bfloat16_rn(f[0]);
    }
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

// 1 + erf(x / sqrt 2) and exp(-x^2 / 2) of the exact GELU. FAST (bf16
// outputs): Abramowitz and Stegun 7.1.26, erfc(|z|) = poly(t) exp(-z^2) with
// t = 1 / (1 + p |z|), absolute error under 1.5e-7, so that 1 + erf(z) of a
// negative z is erfc(|z|) with no cancellation and the backward's exp comes
// free; else erff and expf, as PyTorch's float32 GELU.
template <bool FAST>
__device__ __forceinline__ float one_plus_erf(float x, float& e) {
  const float kAlpha = static_cast<float>(kSqrt1_2);
  const float z = x * kAlpha;
  if constexpr (FAST) {
    const float t = __fdividef(1.f, fmaf(0.3275911f, fabsf(z), 1.f));
    float poly = fmaf(1.061405429f, t, -1.453152027f);
    poly = fmaf(poly, t, 1.421413741f);
    poly = fmaf(poly, t, -0.284496736f);
    poly = fmaf(poly, t, 0.254829592f);
    e = __expf(-z * z);
    const float q = poly * t * e;
    return z >= 0.f ? 2.f - q : q;
  } else {
    e = expf(-0.5f * x * x);
    return 1.f + erff(z);
  }
}

template <bool FAST>
__device__ __forceinline__ float gelu(float x, bool tanh_form) {
  if (tanh_form) {
    const float kBeta = static_cast<float>(kSqrt2 * k2SqrtPi * 0.5);
    const float kKappa = 0.044715f;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.f + tanhf(inner));
  }
  if constexpr (FAST) {
    float e;
    return x * 0.5f * one_plus_erf<true>(x, e);
  } else {
    const float kAlpha = static_cast<float>(kSqrt1_2);
    return x * 0.5f * (1.f + erff(x * kAlpha));
  }
}

template <bool FAST>
__device__ __forceinline__ float gelu_grad(float x, float dy, bool tanh_form) {
  if (tanh_form) {
    const float kBeta = static_cast<float>(kSqrt2 * k2SqrtPi * 0.5);
    const float kKappa = 0.044715f;
    const float x_sq = x * x;
    const float x_cube = x_sq * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    const float tanh_inner = tanhf(inner);
    const float left = 0.5f * x;
    const float right = 1.f + tanh_inner;
    const float left_derivative = 0.5f * right;
    const float right_derivative = 1.f - tanh_inner * tanh_inner;
    const float inner_derivative = kBeta * (1.f + 3.f * kKappa * x_sq);
    return dy * (left_derivative + left * right_derivative * inner_derivative);
  }
  const float kBeta = static_cast<float>(k2SqrtPi * kSqrt1_2 * 0.5);
  float e;
  const float cdf = 0.5f * one_plus_erf<FAST>(x, e);
  const float pdf = e * kBeta;
  return dy * (cdf + x * pdf);
}

template <int P>
__host__ __device__ constexpr bool two_inputs() { return P == kGeluBwd || P == kBranchAdd; }

template <typename T, int V, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks) prefix_kernel(const Args a) {
  const T* pa = static_cast<const T*>(a.a);
  const T* pb = static_cast<const T*>(a.b);
  T* po = static_cast<T*>(a.out);
  const unsigned c = a.row.d * V;
  const unsigned first = blockIdx.x * (kThreads * kUnroll) + threadIdx.x;
  constexpr bool kFast = sizeof(T) == 2;   // a bf16 output: one_plus_erf's FAST form

  // each vector's kept channels and scale first, so that the data loads that
  // depend on them issue together
  int kept[kUnroll];
  float s[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const unsigned v = first + u * kThreads;
    kept[u] = -1;   // past the end
    s[u] = 1.f;
    if (v >= a.total) continue;
    const unsigned row = divide(a.row, v);
    const unsigned col = (v - row * a.row.d) * V;
    const unsigned b = divide(a.example, v);
    const int n = a.counts ? a.counts[b] : static_cast<int>(c);
    if (a.scale) s[u] = a.scale[b];
    kept[u] = s[u] == 0.f ? 0 : min(max(n - static_cast<int>(col), 0), V);
  }
  // x is always read; h, g and f only where a channel of the vector is kept
  Raw<T, V> ra[kUnroll], rb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long off = static_cast<long long>(first + u * kThreads) * V;
    if ((P == kBranchAdd && kept[u] >= 0) || kept[u] > 0) ra[u] = load<T, V>(pa + off);
    if (two_inputs<P>() && kept[u] > 0) rb[u] = load<T, V>(pb + off);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (kept[u] < 0) continue;
    float fa[V], fb[V], o[V];
    if (P == kBranchAdd || kept[u] > 0) unpack<T, V>(ra[u], fa);
    if (two_inputs<P>() && kept[u] > 0) unpack<T, V>(rb[u], fb);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const bool keep = j < kept[u];
      if constexpr (P == kGeluFwd) {
        o[j] = keep ? gelu<kFast>(fa[j], a.tanh_form) : 0.f;
      } else if constexpr (P == kGeluBwd) {
        o[j] = keep ? gelu_grad<kFast>(fa[j], fb[j], a.tanh_form) : 0.f;
      } else if constexpr (P == kBranchAdd) {
        o[j] = keep ? __fadd_rn(fa[j], __fmul_rn(fb[j], s[u])) : fa[j];
      } else {
        o[j] = keep ? __fmul_rn(fa[j], s[u]) : 0.f;
      }
    }
    store<T, V>(po + static_cast<long long>(first + u * kThreads) * V, o);
  }
}

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1u << s) < d) ++s;
  const uint64_t one = 1;
  const uint64_t m = ((one << 32) * ((one << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int V, int P>
int launch_as(Args a, long long elements, long long per_example, int c, cudaStream_t stream) {
  const long long total = elements / V;
  if (total >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
  a.row = make_div(static_cast<unsigned>(c / V));
  a.example = make_div(static_cast<unsigned>(per_example / V));
  a.total = static_cast<unsigned>(total);
  const long long blocks = (total + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  prefix_kernel<T, V, P><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch(const Args& a, long long rows, int n, int c, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long elements = rows * c;
  const long long per_example = static_cast<long long>(n) * c;
  if (elements == 0) return 0;
  const bool vec = c % kVec == 0 && aligned16(a.a) && aligned16(a.b) && aligned16(a.out);
  if (vec) return launch_as<T, kVec, P>(a, elements, per_example, c, stream);
  return launch_as<T, 1, P>(a, elements, per_example, c, stream);
}

template <int P>
int dispatch(const Args& a, long long rows, int n, int c, int dtype, void* stream) {
  if (rows < 0 || n <= 0 || c <= 0 || rows % n != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, P>(a, rows, n, c, s);
  if (dtype == 1) return launch<__nv_bfloat16, P>(a, rows, n, c, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* a, const void* b, void* out, const int* counts, const float* scale,
               int tanh_form) {
  Args r{};
  r.a = a;
  r.b = b;
  r.out = out;
  r.counts = counts;
  r.scale = scale;
  r.tanh_form = tanh_form;
  return r;
}

}  // namespace

// rows = B * N; n = N (the rows of one example); c = C; dtype 0 float32, 1
// bfloat16. Each returns the launch's CUDA error code, 0 on success.
extern "C" int vst_prefix_gelu_fwd(const void* h, void* y, const int* counts, long long rows,
                                   int n, int c, int dtype, int tanh_form, void* stream) {
  return dispatch<kGeluFwd>(make_args(h, nullptr, y, counts, nullptr, tanh_form), rows, n, c,
                            dtype, stream);
}

extern "C" int vst_prefix_gelu_bwd(const void* h, const void* g, void* dh, const int* counts,
                                   long long rows, int n, int c, int dtype, int tanh_form,
                                   void* stream) {
  return dispatch<kGeluBwd>(make_args(h, g, dh, counts, nullptr, tanh_form), rows, n, c, dtype,
                            stream);
}

extern "C" int vst_branch_add(const void* x, const void* f, void* out, const int* counts,
                              const float* scale, long long rows, int n, int c, int dtype,
                              void* stream) {
  return dispatch<kBranchAdd>(make_args(x, f, out, counts, scale, 0), rows, n, c, dtype, stream);
}

extern "C" int vst_prefix_scale(const void* g, void* y, const int* counts, const float* scale,
                                long long rows, int n, int c, int dtype, void* stream) {
  return dispatch<kScale>(make_args(g, nullptr, y, counts, scale, 0), rows, n, c, dtype, stream);
}
