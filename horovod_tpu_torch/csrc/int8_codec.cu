// Block-scaled int8 codec for Hopper (sm_90a): the KV-wire quantize and
// dequantize kernels of the prefill -> decode handoff, and the stochastic
// quantize of the int8 gradient wire (compression="int8_ef").
//
// Replaces the TPU kernels horovod_tpu/ops/pallas_kernels.py::_quant_kernel
// (quantize_int8), ::_quant_sr_kernel (quantize_int8_stochastic, K3) and
// ::_dequant_kernel (dequantize_int8). K3 reads one more fp32 stream, the
// rounding thresholds u, so at a 64 MiB fp32 gradient bucket it moves
// 4 + 4 + 1 bytes per element: ~45 us of traffic at 3.35 TB/s, a
// bandwidth-bound pass like the other two. The format is
// the JAX package's: the input is read as a flat vector of n elements,
// cut into 4096-element blocks (32 rows x 128 lanes there), and each block
// carries one fp32 scale
//     s = max(absmax(block), 1e-30) / 127
//     q = clip(rint(x / s), -127, 127)        (round half to even)
// Codes of the zero-padded tail of the last block are 0, so q holds
// nblocks * 4096 int8 values.
//
// Bound on this card: memory. Quantize reads 2 or 4 bytes and writes 1 byte
// per element plus 4 bytes per block; dequantize reads 1 byte and writes
// 2 or 4. At 3.35 TB/s one 1M-element bf16 K/V leaf is ~0.9 us of traffic,
// which is below a kernel launch, so the handoff's 48 launches per side are
// latency-bound rather than bandwidth-bound.
//
// What the design does about it: one CTA of 256 threads owns one block, so
// a block's absmax reduction stays inside the CTA (warp shuffles, then one
// shared-memory word per warp) and the scale never makes a trip through
// device memory between passes. Each thread keeps its 16 values in
// registers between the reduction and the store, so the input is read once.
// Loads and stores are strided by the CTA width so neighbouring threads
// touch neighbouring addresses. The ragged tail is masked in the kernel
// (code 0, as the zero padding would give) instead of padding a copy of the
// input, and the dequantize kernel writes only the first n outputs straight
// into the caller's shape, fusing the JAX package's slice-and-reshape.
//
// Numerics match the JAX fallback bitwise: IEEE fp32 divide (__fdiv_rn; no
// fast-math), rintf for round-half-to-even, and round-to-nearest-even on the
// bf16 output cast. A NaN in a block is ignored by fmaxf in the absmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 4096;    // elements per scale (32 x 128 on the TPU)
constexpr int kThreads = 256;   // one CTA per block
constexpr int kPerThread = kBlock / kThreads;  // 16

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_from_f32(float* p, long long i,
                                               float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, long long i,
                                               float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, long long n, int8_t* __restrict__ q,
                float* __restrict__ scales) {
  __shared__ float warp_max[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const int t = threadIdx.x;

  float v[kPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + t;
    v[k] = i < n ? load_f32(x, i) : 0.0f;
    amax = fmaxf(amax, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((t & 31) == 0) warp_max[t >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float s = __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const float r = rintf(__fdiv_rn(v[k], s));
    q[base + k * kThreads + t] =
        static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
  if (t == 0) scales[blockIdx.x] = s;
}

// K3: the same block scale as quantize_kernel, then stochastic rounding
// against the caller's thresholds u (fp32, one per element of the padded
// (rows, 128) layout, drawn outside the kernel):
//     scaled = x / s,  q = clip(floor(scaled) + (u < scaled - floor), +-127)
// Every step is IEEE (divides with __fdiv_rn, floorf, an exact subtract),
// so the codes equal the plain version's bit for bit given the same u.
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_stochastic_kernel(const T* __restrict__ x, long long n,
                           const float* __restrict__ u,
                           int8_t* __restrict__ q,
                           float* __restrict__ scales) {
  __shared__ float warp_max[kThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const int t = threadIdx.x;

  float v[kPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + t;
    v[k] = i < n ? load_f32(x, i) : 0.0f;
    amax = fmaxf(amax, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((t & 31) == 0) warp_max[t >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float s = __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + t;
    const float scaled = __fdiv_rn(v[k], s);
    const float fl = floorf(scaled);
    const float r = u[i] < __fsub_rn(scaled, fl) ? __fadd_rn(fl, 1.0f) : fl;
    q[i] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
  }
  if (t == 0) scales[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, long long n,
                  T* __restrict__ out) {
  const long long base = static_cast<long long>(blockIdx.x) * kBlock;
  const float s = scales[blockIdx.x];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = base + k * kThreads + threadIdx.x;
    if (i < n) store_from_f32(out, i, static_cast<float>(q[i]) * s);
  }
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each function returns cudaGetLastError() after its launch
// (0 = launched), or cudaErrorInvalidValue for a dtype it does not take.

extern "C" int hvd_quantize_int8(const void* x, int x_dtype, long long n,
                                 void* q, void* scales, long long nblocks,
                                 void* stream) {
  if (nblocks <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  const dim3 grid(static_cast<unsigned>(nblocks));
  if (x_dtype == kF32) {
    quantize_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, qp, sp);
  } else if (x_dtype == kBF16) {
    quantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, qp, sp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_quantize_int8_stochastic(const void* x, int x_dtype,
                                            long long n, const void* u,
                                            void* q, void* scales,
                                            long long nblocks,
                                            void* stream) {
  if (nblocks <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* up = static_cast<const float*>(u);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scales);
  const dim3 grid(static_cast<unsigned>(nblocks));
  if (x_dtype == kF32) {
    quantize_stochastic_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), n, up, qp, sp);
  } else if (x_dtype == kBF16) {
    quantize_stochastic_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), n, up, qp, sp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_dequantize_int8(const void* q, const void* scales,
                                   long long n, long long nblocks, void* out,
                                   int out_dtype, void* stream) {
  if (nblocks <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scales);
  const dim3 grid(static_cast<unsigned>(nblocks));
  if (out_dtype == kF32) {
    dequantize_kernel<float><<<grid, kThreads, 0, st>>>(
        qp, sp, n, static_cast<float*>(out));
  } else if (out_dtype == kBF16) {
    dequantize_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        qp, sp, n, static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
