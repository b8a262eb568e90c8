// The two passes of the pairwise Adasum combine for Hopper (sm_90a).
//
// Replaces the TPU kernels horovod_tpu/ops/pallas_kernels.py
// ::_dot_norms_kernel (adasum_dot_norms, K8) and ::_combine_kernel
// (adasum_combine, K9):
//     K8: dn = [a.b, |a|^2, |b|^2], fp32 sums over any-shape a, b
//     K9: out = a * ca + b * cb,  ca = 1 - dot / max(2 |a|^2, eps)
//         (1 where |a|^2 = 0), cb the same with |b|^2; out in a's dtype.
// Both read fp32 or bf16 operands of one dtype.
//
// Bound on this card: memory. K8 reads a and b once (8 bytes per fp32
// element), K9 reads both and writes out (12 bytes); at GPT-2 medium's
// largest gradient, tok_emb (51,463,168 fp32 elements), that is 123 us
// and 184 us of traffic at 3.35 TB/s. Each does 2-3 operations per
// element, far below the card's arithmetic rate.
//
// What the design does about it, and about the one thing Adasum adds:
// both partners of a pair must compute bitwise-equal coefficients, or
// their replicas drift apart by an ulp a step.
// - The TPU kernel carries its three sums across a sequential grid. Here
//   K8 is two launches: pass 1 gives each of G CTAs a fixed grid-stride
//   share of the elements (G a function of n alone, at most 1024); each
//   thread accumulates its elements in increasing index order with fmaf,
//   the CTA reduces its 256 threads with a fixed shuffle tree and writes
//   three partials; pass 2 is one CTA that reduces the G partials in a
//   fixed order. No atomics, so the result is the same on every run, and
//   the a-stream and the b-stream go through the same operations in the
//   same order: the partner, which sees a and b swapped, gets |a|^2 and
//   |b|^2 swapped bit for bit, and the same dot (fmaf(x, y, .) equals
//   fmaf(y, x, .)).
// - The main loop of pass 1 loads four elements per thread before it
//   accumulates them (in index order), so each thread keeps four loads
//   of each stream in flight.
// - K9 derives ca and cb in every thread from the three scalars in device
//   memory with IEEE operations, and writes the combine as
//   __fadd_rn(__fmul_rn(a, ca), __fmul_rn(b, cb)): nvcc would otherwise
//   contract it into an FMA, whose result depends on which operand is
//   "self", and the two partners would differ by an ulp. Written so, it is
//   bitwise equal to the plain version's three separate ops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Sum of three values over the CTA, in a fixed order; valid in thread 0.
__device__ __forceinline__ void block_sum3(float& d, float& na, float& nb) {
  __shared__ float part[3][kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    d = __fadd_rn(d, __shfl_down_sync(0xffffffffu, d, off));
    na = __fadd_rn(na, __shfl_down_sync(0xffffffffu, na, off));
    nb = __fadd_rn(nb, __shfl_down_sync(0xffffffffu, nb, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = d;
    part[1][warp] = na;
    part[2][warp] = nb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    d = part[0][0];
    na = part[1][0];
    nb = part[2][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      d = __fadd_rn(d, part[0][w]);
      na = __fadd_rn(na, part[1][w]);
      nb = __fadd_rn(nb, part[2][w]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_norms_partial_kernel(const T* __restrict__ a, const T* __restrict__ b,
                         long long n, float* __restrict__ partials) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float d = 0.0f, na = 0.0f, nb = 0.0f;
  for (; i + 3 * stride < n; i += 4 * stride) {
    float x[4], y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = load_f32(a, i + k * stride);
      y[k] = load_f32(b, i + k * stride);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d = fmaf(x[k], y[k], d);
      na = fmaf(x[k], x[k], na);
      nb = fmaf(y[k], y[k], nb);
    }
  }
  for (; i < n; i += stride) {
    const float x = load_f32(a, i), y = load_f32(b, i);
    d = fmaf(x, y, d);
    na = fmaf(x, x, na);
    nb = fmaf(y, y, nb);
  }
  block_sum3(d, na, nb);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = d;
    partials[3 * blockIdx.x + 1] = na;
    partials[3 * blockIdx.x + 2] = nb;
  }
}

__global__ void __launch_bounds__(kThreads)
dot_norms_final_kernel(const float* __restrict__ partials, int nparts,
                       float* __restrict__ out) {
  float d = 0.0f, na = 0.0f, nb = 0.0f;
  for (int j = threadIdx.x; j < nparts; j += kThreads) {
    d = __fadd_rn(d, partials[3 * j + 0]);
    na = __fadd_rn(na, partials[3 * j + 1]);
    nb = __fadd_rn(nb, partials[3 * j + 2]);
  }
  block_sum3(d, na, nb);
  if (threadIdx.x == 0) {
    out[0] = d;
    out[1] = na;
    out[2] = nb;
  }
}

__device__ __forceinline__ float coefficient(float dot, float nrm2,
                                             float eps) {
  return nrm2 > 0.0f
             ? __fsub_rn(1.0f,
                         __fdiv_rn(dot, fmaxf(__fmul_rn(2.0f, nrm2), eps)))
             : 1.0f;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ a, const T* __restrict__ b, long long n,
               const float* __restrict__ dn, float eps, T* __restrict__ out) {
  const float dot = dn[0];
  const float ca = coefficient(dot, dn[1], eps);
  const float cb = coefficient(dot, dn[2], eps);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    store_from_f32(out, i,
                   __fadd_rn(__fmul_rn(load_f32(a, i), ca),
                             __fmul_rn(load_f32(b, i), cb)));
  }
}

unsigned combine_grid(long long n) {
  long long blocks = (n + kThreads * 4 - 1) / (kThreads * 4);
  if (blocks > 132 * 16) blocks = 132 * 16;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each function returns cudaGetLastError() after its launches
// (0 = launched), or cudaErrorInvalidValue for a dtype or size it does not
// take. `partials` is scratch of 3 * nparts floats, nparts in [1, 1024].

extern "C" int hvd_adasum_dot_norms(const void* a, const void* b, int dtype,
                                    long long n, void* partials, int nparts,
                                    void* out, void* stream) {
  if (n <= 0) return 0;
  if (nparts < 1 || nparts > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partials);
  if (dtype == kF32) {
    dot_norms_partial_kernel<float><<<nparts, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), n, pp);
  } else if (dtype == kBF16) {
    dot_norms_partial_kernel<__nv_bfloat16><<<nparts, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), n, pp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_norms_final_kernel<<<1, kThreads, 0, st>>>(pp, nparts,
                                                 static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hvd_adasum_combine(const void* a, const void* b, int dtype,
                                  long long n, const void* dn, float eps,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(dn);
  const unsigned grid = combine_grid(n);
  if (dtype == kF32) {
    combine_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), n, dp,
        eps, static_cast<float*>(out));
  } else if (dtype == kBF16) {
    combine_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), n, dp, eps,
        static_cast<__nv_bfloat16*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
