// Block-scaled int8 codec for Hopper (sm_90a): the KV-wire quantize and
// dequantize kernels of the prefill -> decode handoff (K2, K4), and the
// stochastic quantize of the int8 gradient wire (K3, compression="int8_ef").
//
// Replaces the TPU kernels horovod_tpu/ops/pallas_kernels.py::_quant_kernel
// (quantize_int8), ::_quant_sr_kernel (quantize_int8_stochastic, K3) and
// ::_dequant_kernel (dequantize_int8). The format is the JAX package's: the
// input is read as a flat vector of n elements, cut into 4096-element
// blocks (32 rows x 128 lanes there), and each block carries one fp32 scale
//     s = max(absmax(block), 1e-30) / 127
//     q = clip(rint(x / s), -127, 127)        (round half to even)
// Codes of the zero-padded tail of the last block are 0, so q holds
// nblocks * 4096 int8 values.
//
// Bound on this card: memory. Quantize reads 2 or 4 bytes and writes 1 byte
// per element plus 4 bytes per block; dequantize reads 1 byte and writes
// 2 or 4. K3 reads one more fp32 stream, the rounding thresholds u: at a
// 64 MiB fp32 gradient bucket it moves 4 + 4 + 1 bytes per element, ~45 us
// at 3.35 TB/s. One 1M-element bf16 K/V leaf of the handoff is only
// ~0.9 us of traffic, below a kernel launch; a handoff moves 48 of them.
//
// K2/K4 design (the handoff):
// - One launch codes a GROUP of leaves. The wrapper passes a table of at
//   most kMaxLeaves entries (pointers, n, dtype, the leaf's first block in
//   the launch's grid) by value as a __grid_constant__ kernel parameter,
//   and the grid is one CTA per 4096-element block over all the leaves.
//   Each CTA finds its leaf by a binary search over the entries' first
//   blocks, read from the constant bank. A handoff's 48 leaves are one
//   launch per side instead of 48.
// - One CTA of 256 threads owns one block, so a block's absmax reduction
//   stays inside the CTA (warp shuffles, then one shared-memory word per
//   warp) and the input is read once: each thread keeps its 16 values in
//   registers between the reduction and the store.
// - Thread t owns the 16 contiguous elements [16t, 16t + 16) of its block:
//   K2 reads them as two (bf16) or four (fp32) 16-byte vectors through the
//   read-only path, which allocates in L1, since each 32-byte sector is
//   taken by two of a thread's loads, and writes their codes as one
//   16-byte streaming store (st.global.cs); K4 reads the 16 codes as one
//   16-byte streaming load and writes two (bf16) or four (fp32) 16-byte
//   streaming stores. Every byte is touched once per handoff, and a
//   handoff's ~150 MB per side is three times the 50 MB L2.
// - A leaf whose pointers are not 16-byte aligned, and the ragged last
//   block of a leaf (n % 4096 != 0), take a masked scalar path in the same
//   kernel: codes past n are 0, and K4 writes only the first n outputs,
//   straight into the caller's tensor (a cache slot, for the handoff).
//
// Numerics match the plain versions and the JAX fallback bitwise: IEEE
// fp32 divide (__fdiv_rn; no fast-math, no reciprocal), rintf for
// round-half-to-even, an fp32 product (__fmul_rn) and one
// round-to-nearest-even on the bf16 output. A NaN in a block is ignored by
// fmaxf in the absmax, and its code is -127.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlock = 4096;    // elements per scale (32 x 128 on the TPU)
constexpr int kThreads = 256;   // one CTA per block
constexpr int kPerThread = kBlock / kThreads;  // 16
constexpr int kMaxLeaves = 64;  // table entries per launch

enum DType { kF32 = 0, kBF16 = 1 };

// One leaf of a grouped K2/K4 launch. The wrapper packs it with the
// struct format "=QQQqqii" (horovod_tpu_torch/ops/kernels.py _LEAF): 48
// bytes, no padding.
struct CodecLeaf {
  const void* src;    // K2: x (fp32/bf16); K4: the codes
  void* dst;          // K2: the codes; K4: the output (fp32/bf16)
  float* scales;      // one per block: K2 writes them, K4 reads them
  long long n;        // elements
  long long first;    // the leaf's first block in the launch's grid
  int dtype;          // K2: x's dtype; K4: the output's (DType)
  int vec;            // 1: src and dst are 16-byte aligned
};
static_assert(sizeof(CodecLeaf) == 48, "CodecLeaf must stay 48 bytes");
static_assert(offsetof(CodecLeaf, n) == 24 &&
                  offsetof(CodecLeaf, first) == 32 &&
                  offsetof(CodecLeaf, dtype) == 40 &&
                  offsetof(CodecLeaf, vec) == 44,
              "CodecLeaf layout is packed by kernels._LEAF");

struct CodecTable {
  CodecLeaf leaf[kMaxLeaves];
};
// Passed by value with one int: under the classic 4 KB parameter limit.
static_assert(sizeof(CodecTable) + 8 <= 4096, "CodecTable too large");

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

// The entry whose blocks hold grid block b: the last with first <= b (the
// wrapper leaves out leaves with no blocks, so the firsts increase).
__device__ __forceinline__ int find_leaf(const CodecTable& table,
                                         int nleaves, long long b) {
  int lo = 0, hi = nleaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.leaf[mid].first <= b) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// A thread's 16 contiguous elements [i, i + 16) of x as fp32: 16-byte
// vectors on the vector path, masked scalars (0 past n) otherwise.
__device__ __forceinline__ void load16(const float* x, long long i,
                                       long long n, bool vec,
                                       float (&v)[kPerThread]) {
  if (vec) {
    const float4* p = reinterpret_cast<const float4*>(x + i);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const float4 w = __ldg(p + h);
      v[4 * h] = w.x; v[4 * h + 1] = w.y;
      v[4 * h + 2] = w.z; v[4 * h + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      v[k] = i + k < n ? x[i + k] : 0.0f;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* x, long long i,
                                       long long n, bool vec,
                                       float (&v)[kPerThread]) {
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(x + i);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 w = __ldg(p + h);
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {     // bf16 -> fp32 is exact: a shift
        v[8 * h + 2 * j] = __uint_as_float(u[j] << 16);
        v[8 * h + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      v[k] = i + k < n ? __bfloat162float(x[i + k]) : 0.0f;
  }
}

// 16 fp32 values written to out[i, i + 16) (only below n on the scalar
// path): fp32 as four 16-byte stores, bf16 rounded to nearest even as two.
__device__ __forceinline__ void store16(float* out, long long i, long long n,
                                        bool vec,
                                        const float (&v)[kPerThread]) {
  if (vec) {
    float4* p = reinterpret_cast<float4*>(out + i);
#pragma unroll
    for (int h = 0; h < 4; ++h)
      __stcs(p + h, make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2],
                                v[4 * h + 3]));
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (i + k < n) out[i + k] = v[k];
  }
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
          << 16);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, long long i,
                                        long long n, bool vec,
                                        const float (&v)[kPerThread]) {
  if (vec) {
    uint4* p = reinterpret_cast<uint4*>(out + i);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      __stcs(p + h, make_uint4(bf16x2(v[8 * h], v[8 * h + 1]),
                               bf16x2(v[8 * h + 2], v[8 * h + 3]),
                               bf16x2(v[8 * h + 4], v[8 * h + 5]),
                               bf16x2(v[8 * h + 6], v[8 * h + 7])));
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if (i + k < n) out[i + k] = __float2bfloat16_rn(v[k]);
  }
}

// The code byte of a value already rounded and clamped to [-127, 127].
__device__ __forceinline__ uint32_t code_byte(float r) {
  return static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
}

// K2 over a table of leaves: grid block b quantizes block b - first of the
// leaf that holds it.
__global__ void __launch_bounds__(kThreads)
quantize_group_kernel(const __grid_constant__ CodecTable table,
                      int nleaves) {
  __shared__ float warp_max[kThreads / 32];
  const long long b = blockIdx.x;
  const CodecLeaf& leaf = table.leaf[find_leaf(table, nleaves, b)];
  const long long blk = b - leaf.first;
  const long long n = leaf.n;
  const long long i = blk * kBlock + threadIdx.x * kPerThread;
  const bool vec = leaf.vec && (blk + 1) * kBlock <= n;
  const int t = threadIdx.x;

  float v[kPerThread];
  if (leaf.dtype == kBF16)
    load16(static_cast<const __nv_bfloat16*>(leaf.src), i, n, vec, v);
  else
    load16(static_cast<const float*>(leaf.src), i, n, vec, v);
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) amax = fmaxf(amax, fabsf(v[k]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((t & 31) == 0) warp_max[t >> 5] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);

  const float s = __fdiv_rn(fmaxf(amax, 1e-30f), 127.0f);
  uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v[k], s)), -127.0f), 127.0f);
    packed[k >> 2] |= code_byte(r) << (8 * (k & 3));
  }
  int8_t* q = static_cast<int8_t*>(leaf.dst) + i;
  if (leaf.vec) {       // the codes are whole blocks, ragged or not
    __stcs(reinterpret_cast<uint4*>(q),
           make_uint4(packed[0], packed[1], packed[2], packed[3]));
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      q[k] = static_cast<int8_t>((packed[k >> 2] >> (8 * (k & 3))) & 0xffu);
  }
  if (t == 0) leaf.scales[blk] = s;
}

// K3: the same block scale as quantize_group_kernel, then stochastic rounding
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

// K4 over a table of leaves: grid block b writes block b - first of the
// leaf that holds it, float(q) * s rounded once to the output dtype.
__global__ void __launch_bounds__(kThreads)
dequantize_group_kernel(const __grid_constant__ CodecTable table,
                        int nleaves) {
  const long long b = blockIdx.x;
  const CodecLeaf& leaf = table.leaf[find_leaf(table, nleaves, b)];
  const long long blk = b - leaf.first;
  const long long n = leaf.n;
  const long long i = blk * kBlock + threadIdx.x * kPerThread;
  const bool vec = leaf.vec && (blk + 1) * kBlock <= n;
  const int8_t* q = static_cast<const int8_t*>(leaf.src);
  const float s = leaf.scales[blk];

  float v[kPerThread];
  if (vec) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(q + i));
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      v[k] = __fmul_rn(static_cast<float>(static_cast<int8_t>(
                           (u[k >> 2] >> (8 * (k & 3))) & 0xffu)), s);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      v[k] = i + k < n ? __fmul_rn(static_cast<float>(q[i + k]), s) : 0.0f;
  }
  if (leaf.dtype == kBF16)
    store16(static_cast<__nv_bfloat16*>(leaf.dst), i, n, vec, v);
  else
    store16(static_cast<float*>(leaf.dst), i, n, vec, v);
}

// Copies the caller's nleaves entries into a table passed by value and
// launches one CTA per block; refuses a dtype it does not take.
template <typename Kernel>
int launch_group(Kernel kernel, const void* entries, int nleaves,
                 long long total_blocks, void* stream) {
  if (nleaves <= 0 || total_blocks <= 0) return 0;
  if (nleaves > kMaxLeaves || total_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CodecTable table;
  memset(&table, 0, sizeof(table));
  memcpy(table.leaf, entries, sizeof(CodecLeaf) * nleaves);
  for (int l = 0; l < nleaves; ++l)
    if (table.leaf[l].dtype != kF32 && table.leaf[l].dtype != kBF16)
      return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(total_blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(table, nleaves);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers, except
// `entries`, a host array of nleaves CodecLeaf records (at most 64, the
// leaves with at least one block, firsts a prefix sum from 0 that ends at
// total_blocks); `stream` is a cudaStream_t. Each function returns
// cudaGetLastError() after its launch (0 = launched), or
// cudaErrorInvalidValue for a dtype or a size it does not take.

extern "C" int hvd_quantize_int8_group(const void* entries, int nleaves,
                                       long long total_blocks,
                                       void* stream) {
  return launch_group(quantize_group_kernel, entries, nleaves, total_blocks,
                      stream);
}

extern "C" int hvd_dequantize_int8_group(const void* entries, int nleaves,
                                         long long total_blocks,
                                         void* stream) {
  return launch_group(dequantize_group_kernel, entries, nleaves,
                      total_blocks, stream);
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
