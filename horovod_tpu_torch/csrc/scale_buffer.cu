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
// - A grid-stride loop over 16-byte input vectors (4 fp32 or 8 bf16/fp16
//   elements), so that a warp's loads, and its stores when the dtypes
//   match, are 512 contiguous bytes, where both pointers are 16-byte
//   aligned; then a masked scalar loop over the tail (and over everything
//   when a pointer is not aligned). No shared memory: each element is
//   touched once. (A first version took 8 elements a thread, two 16-byte
//   accesses 32 bytes apart, and ran at 1.72x the bound on tok_emb against
//   torch.mul's 1.15x.)

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

// One 16-byte vector of D from aligned storage, widened to fp32.
template <typename D>
__device__ __forceinline__ void load16(const typename D::S* __restrict__ p,
                                       float (&f)[kLanes<D>]) {
  if constexpr (sizeof(typename D::S) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = D::to_f32(static_cast<typename D::S>(u[k] & 0xffffu));
      f[2 * k + 1] = D::to_f32(static_cast<typename D::S>(u[k] >> 16));
    }
  }
}

// K fp32 values narrowed to E and written to aligned storage: one
// 16-byte store when the dtypes match, 8 bytes for fp32 -> 16-bit, two
// 16-byte stores for 16-bit -> fp32.
template <typename E, int K>
__device__ __forceinline__ void store(typename E::S* __restrict__ p,
                                      const float (&f)[K]) {
  if constexpr (sizeof(typename E::S) == 4) {
#pragma unroll
    for (int k = 0; k < K; k += 4) {
      reinterpret_cast<float4*>(p)[k / 4] =
          make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
    }
  } else {
    unsigned u[K / 2];
#pragma unroll
    for (int k = 0; k < K / 2; ++k) {
      u[k] = static_cast<unsigned>(E::from_f32(f[2 * k])) |
             (static_cast<unsigned>(E::from_f32(f[2 * k + 1])) << 16);
    }
    if constexpr (K == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
    } else {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    }
  }
}

template <typename D, typename E>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const typename D::S* __restrict__ x,
             typename E::S* __restrict__ out, long long n, long long groups,
             float s) {
  constexpr int K = kLanes<D>;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long g = first; g < groups; g += stride) {
    float f[K];
    load16<D>(x + g * K, f);
#pragma unroll
    for (int k = 0; k < K; ++k) f[k] = __fmul_rn(f[k], s);
    store<E, K>(out + g * K, f);
  }
  for (long long i = groups * K + first; i < n; i += stride) {
    out[i] = E::from_f32(__fmul_rn(D::to_f32(x[i]), s));
  }
}

unsigned grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

template <typename D, typename E>
int launch(const void* x, void* out, long long n, float s,
           cudaStream_t st) {
  const bool aligned = (reinterpret_cast<std::uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<std::uintptr_t>(out) % 16 == 0);
  const long long groups = aligned ? n / kLanes<D> : 0;
  const long long tail = n - groups * kLanes<D>;
  scale_kernel<D, E><<<grid_for(groups > tail ? groups : tail), kThreads, 0,
                       st>>>(static_cast<const typename D::S*>(x),
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
// cudaStream_t. Returns cudaGetLastError() after the launch (0 =
// launched), or cudaErrorInvalidValue for a dtype it does not take.
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
