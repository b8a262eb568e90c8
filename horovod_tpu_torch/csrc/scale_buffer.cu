// The pre/postscale kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel horovod_tpu/ops/pallas_kernels.py::_scale_kernel
// (scale_buffer, K1):
//     out[i] = cast_out(float(x[i]) * s)
// with s an fp32 scalar passed by value and x and out each fp32, bf16 or
// fp16 (the cast case, such as fp32 in and bf16 out, is the JAX
// function's out_dtype).
//
// Bound on this card: memory. The kernel reads n input elements and writes
// n output elements and does one multiply per element; at GPT-2 medium's
// largest gradient, tok_emb (51,463,168 fp32 elements in and out), that is
// 411.7 MB, or 122.9 us at 3.35 TB/s. A 1,024-element LayerNorm bias moves
// 8 KB, a few ns: launch latency bounds it.
//
// Design:
// - Numerics first. The product is __fmul_rn (never contracted into
//   anything) and the conversion to a 16-bit output is one
//   round-to-nearest-even (__float2bfloat16_rn, __float2half_rn), so the
//   result is the plain version's (x.float() * s).to(out) to the bit. The
//   eager engine's _apply_scale hands the kernel a scale already rounded
//   to the tensor's dtype: for bf16 and fp16 tensors the fp32 product of
//   two such values is exact, so the one rounding gives the correctly
//   rounded product the JAX package computes as x * s in the tensor's
//   dtype. (A NaN input gives CUDA's canonical NaN, which can differ in
//   its payload bits from PyTorch's.)
// - A streaming pass over 16-byte input vectors (4 fp32 or 8 bf16/fp16
//   elements) where both pointers are 16-byte aligned. Each block takes
//   one chunk of kUnroll x kThreads vectors and exits: each thread issues
//   its kUnroll independent vector loads before its first multiply, then
//   its kUnroll stores, and vector u of a thread is u block-widths after
//   vector 0, so every warp access is 512 contiguous bytes. Each byte is
//   touched once: the loads bypass L1 (ld.global.nc.L1::no_allocate) and
//   the stores are streaming (st.global.cs). A grid-stride scalar loop
//   takes the tail, and everything when a pointer is not aligned. No
//   shared memory. (Measured on tok_emb against the bound: a first
//   version, 8 elements a thread in two 16-byte accesses 32 bytes apart,
//   at 1.72x; one vector a thread in flight over a grid-stride loop
//   capped at 132 x 16 blocks, at 1.18x; a persistent grid of SMs x
//   resident blocks with four loads in flight a thread, at 1.23x, while
//   torch.mul ran at 1.14-1.15x: on this card a grid that holds its
//   blocks to the end loses to one whose blocks retire and are
//   replaced.)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Each dtype as its storage type, with exact widening to fp32 and one
// round-to-nearest-even narrowing from it.
struct F32 {
  using S = float;
  static __device__ __forceinline__ float to_f32(S v) { return v; }
  static __device__ __forceinline__ S from_f32(float v) { return v; }
};
struct BF16 {
  using S = unsigned short;
  static __device__ __forceinline__ float to_f32(S v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ S from_f32(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct F16 {
  using S = unsigned short;
  static __device__ __forceinline__ float to_f32(S v) {
    return __half2float(__ushort_as_half(v));
  }
  static __device__ __forceinline__ S from_f32(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// Elements per 16-byte input vector: 4 fp32 or 8 bf16/fp16.
template <typename D>
constexpr int kLanes = 16 / static_cast<int>(sizeof(typename D::S));

constexpr int kUnroll = 2;      // vector loads in flight per thread

// One 16-byte vector, read once: no L1 allocation, non-coherent path.
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void store_stream(void* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};" ::"l"(p), "r"(v.x),
               "r"(v.y)
               : "memory");
}

// A 16-byte vector of D, widened to fp32.
template <typename D>
__device__ __forceinline__ void widen(uint4 w, float (&f)[kLanes<D>]) {
  if constexpr (sizeof(typename D::S) == 4) {
    f[0] = __uint_as_float(w.x); f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z); f[3] = __uint_as_float(w.w);
  } else {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = D::to_f32(static_cast<typename D::S>(u[k] & 0xffffu));
      f[2 * k + 1] = D::to_f32(static_cast<typename D::S>(u[k] >> 16));
    }
  }
}

// K fp32 values narrowed to E and written to aligned storage, streaming:
// one 16-byte store when the dtypes match, 8 bytes for fp32 -> 16-bit,
// two 16-byte stores for 16-bit -> fp32.
template <typename E, int K>
__device__ __forceinline__ void store(typename E::S* p, const float (&f)[K]) {
  if constexpr (sizeof(typename E::S) == 4) {
#pragma unroll
    for (int k = 0; k < K; k += 4)
      store_stream(p + k, make_uint4(__float_as_uint(f[k]),
                                     __float_as_uint(f[k + 1]),
                                     __float_as_uint(f[k + 2]),
                                     __float_as_uint(f[k + 3])));
  } else {
    unsigned u[K / 2];
#pragma unroll
    for (int k = 0; k < K / 2; ++k) {
      u[k] = static_cast<unsigned>(E::from_f32(f[2 * k])) |
             (static_cast<unsigned>(E::from_f32(f[2 * k + 1])) << 16);
    }
    if constexpr (K == 8) {
      store_stream(p, make_uint4(u[0], u[1], u[2], u[3]));
    } else {
      store_stream(p, make_uint2(u[0], u[1]));
    }
  }
}

// Vector g of x, scaled, into out.
template <typename D, typename E>
__device__ __forceinline__ void scale_vector(
    uint4 w, typename E::S* __restrict__ out, long long g, float s) {
  constexpr int K = kLanes<D>;
  float f[K];
  widen<D>(w, f);
#pragma unroll
  for (int k = 0; k < K; ++k) f[k] = __fmul_rn(f[k], s);
  store<E, K>(out + g * K, f);
}

template <typename D, typename E>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const typename D::S* __restrict__ x,
             typename E::S* __restrict__ out, long long n, long long groups,
             float s) {
  constexpr int K = kLanes<D>;
  const long long g0 =
      static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
  uint4 w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (g0 + u * kThreads < groups)
      w[u] = load_stream(x + (g0 + u * kThreads) * K);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (g0 + u * kThreads < groups)
      scale_vector<D, E>(w[u], out, g0 + u * kThreads, s);
  const long long threads = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = groups * K + static_cast<long long>(blockIdx.x) *
                                      kThreads + threadIdx.x;
       i < n; i += threads)
    out[i] = E::from_f32(__fmul_rn(D::to_f32(x[i]), s));
}

template <typename D, typename E>
int launch(const void* x, void* out, long long n, float s,
           cudaStream_t st) {
  const bool aligned = (reinterpret_cast<std::uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<std::uintptr_t>(out) % 16 == 0);
  const long long groups = aligned ? n / kLanes<D> : 0;
  const long long tail = n - groups * kLanes<D>;
  const long long chunks =
      (groups + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const long long tail_blocks = (tail + kThreads - 1) / kThreads;
  const long long blocks = chunks > tail_blocks ? chunks : tail_blocks;
  scale_kernel<D, E><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const typename D::S*>(x),
      static_cast<typename E::S*>(out), n, groups, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename D>
int launch_out(const void* x, void* out, int out_dtype, long long n, float s,
               cudaStream_t st) {
  switch (out_dtype) {
    case kF32: return launch<D, F32>(x, out, n, s, st);
    case kBF16: return launch<D, BF16>(x, out, n, s, st);
    case kF16: return launch<D, F16>(x, out, n, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface for ctypes. `x` and `out` are device pointers of n
// elements of their dtypes (0 = fp32, 1 = bf16, 2 = fp16); `stream` is a
// cudaStream_t; the launch goes to the current device. Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a dtype it does not take.
extern "C" int hvd_scale_buffer(const void* x, int in_dtype, void* out,
                                int out_dtype, long long n, float scale,
                                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32: return launch_out<F32>(x, out, out_dtype, n, scale, st);
    case kBF16: return launch_out<BF16>(x, out, out_dtype, n, scale, st);
    case kF16: return launch_out<F16>(x, out, out_dtype, n, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
