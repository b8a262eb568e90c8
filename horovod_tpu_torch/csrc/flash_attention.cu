// Flash attention for Hopper (sm_90a): the forward (K5) and the two
// backward kernels (K6: dq, K7: dk/dv) of the GPT training path.
//
// Replaces the TPU kernels horovod_tpu/ops/flash_attention.py::_fwd_kernel
// (K5), ::_dq_kernel (K6) and ::_dkv_kernel (K7). What they compute is the
// JAX package's, on q, k, v laid out (B, S, H, D):
//
//     s   = (q * scale) . k^T,  scale = 1 / sqrt(D)
//     s   = -1e30 where the key mask is 0        (a logit, not -inf)
//     o   = softmax(s) . v,     lse = m + log(max(l, 1e-30))  (B, H, S) fp32
//     p   = exp(s - lse),       delta = rowsum(do * o)  (computed outside)
//     ds  = p * (do . v^T - delta + dlse)
//     dq  = ds . k * scale,  dk = ds^T . q * scale,  dv = p^T . do
//
// Two things the TPU kernels did not need are decided here. A key after its
// query (causal) and a key past the end of a ragged sequence never
// contribute (p = 0); a key hidden by the key mask is a -1e30 logit, so a
// row whose keys are all masked averages them uniformly, as the JAX kernel
// does, instead of producing NaN.
//
// Layout: q, k, v and do are read in place through their (b, s, h) strides
// (the last dimension must be contiguous); o, dq, dk and dv are written
// contiguous (B, S, H, D) and lse as (B, H, S). None of the TPU's
// transposes to (B, H, S, D), lane-broadcast lse/delta or sublane-broadcast
// mask is carried over.
//
// Work split. K5: one CTA per (q-block of 64 rows, head, batch), looping
// over 64-key tiles up to the causal bound hi = min(ceil((qb + 64) / 64),
// nk); K/V tiles stage through shared memory, the online softmax state
// (m, l) and the fp32 output accumulator stay in registers. K6: the same
// grid and loop, with ds staged in shared memory for the ds . k product.
// K7: one CTA per (k-block, head, batch), looping over q-blocks from the
// causal lower bound lo = kb / 64; p and ds are staged in shared memory for
// the p^T . do and ds^T . q products.
//
// Thread layout (256 threads): thread (ty, tx) = (tid / 16, tid % 16) owns
// rows ty + 16 i (i < 4) and columns tx + 16 j of every 64 x 64 tile and
// of the D-wide accumulators, so a row's reduction is a 16-lane shuffle.
// Shared-memory rows are padded by one float so that the 16 lanes of a
// half-warp reading 16 different rows hit 16 different banks.
//
// Bound on this card, at the training shape (B = 8, S = 512, H = 16,
// D = 64, causal, bf16): the bytes (q, k, v, o once each, ~34 MB for K5) at
// 3.35 TB/s take ~10 us, the causal FLOPs (~4.3 GFLOP for K5) at the bf16
// tensor-core peak ~4 us, so the kernels are bound by bytes. This first
// version does its inner products as fp32 FMAs on the CUDA cores (inputs
// converted to fp32 as they land in shared memory), which caps it far below
// either bound; tensor cores (wgmma), TMA and warp specialisation are the
// later work that closes the gap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per tile
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int kRows = 4;        // rows (and tile columns) per thread: 64 / 16
constexpr float kMaskValue = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

struct Strides {                // element strides of a (B, S, H, D) tensor
  long long b, s, h;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;             // do (backward only)
  const float* mask;            // (B, S) key mask, 1 = attend; null = all
  const float* lse;             // (B, H, S)
  const float* delta;           // (B, H, S), backward only
  const float* dlse;            // (B, H, S), backward only; null = 0
  void* o;                      // forward: o; K6: dq; K7: dk
  void* o2;                     // K7: dv
  float* lse_out;               // forward: lse
  Strides sq, sk, sv, sdo;
  int S, H;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy rows [row0, row0 + 64) of head h, batch b into a padded fp32 tile
// (row stride D + 1), times `mul`; rows past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const Strides& st, int b, int h,
                                          int row0, int S, float mul) {
  const T* base = src + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] =
        row < S ? to_f32(base[static_cast<long long>(row) * st.s + d]) * mul
                : 0.0f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Logit of query row `qrow` against key `key`, after the masks: -inf for
// a key that must not contribute (past S, or after the query when causal),
// -1e30 for a key the key mask hides.
__device__ __forceinline__ float masked_logit(float s, int qrow, int key,
                                              const Args& a, int b) {
  if (key >= a.S || (a.causal && key > qrow)) return -INFINITY;
  if (a.mask != nullptr && !(a.mask[static_cast<long long>(b) * a.S + key] >
                             0.0f))
    return kMaskValue;
  return s;
}

// ---------------------------------------------------------------- K5 ------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;    // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // 64 x DP, q * scale
  float* Ks = Qs + kBQ * DP;              // 64 x DP
  float* Vs = Ks + kBK * DP;              // 64 x DP
  float* Ps = Vs + kBK * DP;              // 64 x (64 + 1)

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = (a.S + kBK - 1) / kBK;
  const int hi = a.causal ? min((q0 + kBQ + kBK - 1) / kBK, nk) : nk;

  load_tile<T, D>(Qs, static_cast<const T*>(a.q), a.sq, b, h, q0, a.S,
                  a.scale);

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int jt = 0; jt < hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();                      // previous tile fully consumed
    load_tile<T, D>(Ks, static_cast<const T*>(a.k), a.sk, b, h, k0, a.S,
                    1.0f);
    load_tile<T, D>(Vs, static_cast<const T*>(a.v), a.sv, b, h, k0, a.S,
                    1.0f);
    __syncthreads();

    float s[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < kRows; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        s[i][j] = masked_logit(s[i][j], q0 + r, k0 + tx + 16 * j, a, b);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float p = expf(s[i][j] - m_new);   // 0 for a -inf logit
        Ps[r * (kBK + 1) + tx + 16 * j] = p;
        psum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = Ps[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      from_f32(o + base + tx + 16 * c, acc[i][c] / li);
    if (tx == 0)
      a.lse_out[(static_cast<long long>(b) * a.H + h) * a.S + row] =
          m[i] + logf(li);
  }
}

// ---------------------------------------------------------------- K6 ------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                       // 64 x DP, q * scale
  float* dOs = Qs + kBQ * DP;             // 64 x DP
  float* Ks = dOs + kBQ * DP;             // 64 x DP
  float* Vs = Ks + kBK * DP;              // 64 x DP
  float* dSs = Vs + kBK * DP;             // 64 x (64 + 1)

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = (a.S + kBK - 1) / kBK;
  const int hi = a.causal ? min((q0 + kBQ + kBK - 1) / kBK, nk) : nk;

  load_tile<T, D>(Qs, static_cast<const T*>(a.q), a.sq, b, h, q0, a.S,
                  a.scale);
  load_tile<T, D>(dOs, static_cast<const T*>(a.dout), a.sdo, b, h, q0, a.S,
                  1.0f);

  float lse[kRows], dterm[kRows], acc[kRows][DC];
  const long long bh = (static_cast<long long>(b) * a.H + h) * a.S;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < a.S;
    lse[i] = in ? a.lse[bh + row] : 0.0f;
    // dp - delta + dlse = dp + dterm
    dterm[i] = in ? (a.dlse != nullptr ? a.dlse[bh + row] : 0.0f) -
                        a.delta[bh + row]
                  : 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.0f;
  }

  for (int jt = 0; jt < hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();
    load_tile<T, D>(Ks, static_cast<const T*>(a.k), a.sk, b, h, k0, a.S,
                    1.0f);
    load_tile<T, D>(Vs, static_cast<const T*>(a.v), a.sv, b, h, k0, a.S,
                    1.0f);
    __syncthreads();

    float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], dov[kRows], kv[kRows], vv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        dov[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float sm = masked_logit(s[i][j], q0 + r, k0 + tx + 16 * j, a, b);
        const float p = q0 + r < a.S ? expf(sm - lse[i]) : 0.0f;
        dSs[r * (kBK + 1) + tx + 16 * j] = p * (dp[i][j] + dterm[i]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float ds = dSs[(ty + 16 * i) * (kBK + 1) + kk];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

  T* dq = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.S) continue;
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      from_f32(dq + base + tx + 16 * c, acc[i][c] * a.scale);
  }
}

// ---------------------------------------------------------------- K7 ------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Args a) {
  constexpr int DP = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                       // 64 x DP
  float* Vs = Ks + kBK * DP;              // 64 x DP
  float* Qs = Vs + kBK * DP;              // 64 x DP, q * scale
  float* dOs = Qs + kBQ * DP;             // 64 x DP
  float* Ps = dOs + kBQ * DP;             // 64 keys x (64 + 1) queries
  float* dSs = Ps + kBK * (kBQ + 1);      // 64 keys x (64 + 1) queries
  float* lse_s = dSs + kBK * (kBQ + 1);   // 64
  float* dterm_s = lse_s + kBQ;           // 64: dlse - delta

  const int b = blockIdx.z, h = blockIdx.y;
  const int k0 = blockIdx.x * kBK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (a.S + kBQ - 1) / kBQ;
  const int lo = a.causal ? k0 / kBQ : 0;
  const long long bh = (static_cast<long long>(b) * a.H + h) * a.S;

  load_tile<T, D>(Ks, static_cast<const T*>(a.k), a.sk, b, h, k0, a.S, 1.0f);
  load_tile<T, D>(Vs, static_cast<const T*>(a.v), a.sv, b, h, k0, a.S, 1.0f);

  float dk[kRows][DC], dv[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.0f;

  for (int it = lo; it < nq; ++it) {
    const int q0 = it * kBQ;
    __syncthreads();
    load_tile<T, D>(Qs, static_cast<const T*>(a.q), a.sq, b, h, q0, a.S,
                    a.scale);
    load_tile<T, D>(dOs, static_cast<const T*>(a.dout), a.sdo, b, h, q0, a.S,
                    1.0f);
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      const bool in = row < a.S;
      lse_s[threadIdx.x] = in ? a.lse[bh + row] : 0.0f;
      dterm_s[threadIdx.x] =
          in ? (a.dlse != nullptr ? a.dlse[bh + row] : 0.0f) -
                   a.delta[bh + row]
             : 0.0f;
    }
    __syncthreads();

    // Thread rows are keys (ty + 16 i), columns are queries (tx + 16 j).
    float s[kRows][kRows], dp[kRows][kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kRows; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kv[kRows], vv[kRows], qv[kRows], dov[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        kv[i] = Ks[(ty + 16 * i) * DP + d];
        vv[i] = Vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        qv[j] = Qs[(tx + 16 * j) * DP + d];
        dov[j] = dOs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int kr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int qc = tx + 16 * j;
        const float sm = masked_logit(s[i][j], q0 + qc, k0 + kr, a, b);
        const float p = q0 + qc < a.S ? expf(sm - lse_s[qc]) : 0.0f;
        Ps[kr * (kBQ + 1) + qc] = p;
        dSs[kr * (kBQ + 1) + qc] = p * (dp[i][j] + dterm_s[qc]);
      }
    }
    __syncthreads();

    for (int qq = 0; qq < kBQ; ++qq) {
      float dov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dov[c] = dOs[qq * DP + tx + 16 * c];
        qv[c] = Qs[qq * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kr = ty + 16 * i;
        const float p = Ps[kr * (kBQ + 1) + qq];
        const float ds = dSs[kr * (kBQ + 1) + qq];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[i][c] = fmaf(p, dov[c], dv[i][c]);
          dk[i][c] = fmaf(ds, qv[c], dk[i][c]);   // Qs already holds q*scale
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.o);
  T* dv_out = static_cast<T*>(a.o2);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.S) continue;
    const long long base =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      from_f32(dk_out + base + tx + 16 * c, dk[i][c]);
      from_f32(dv_out + base + tx + 16 * c, dv[i][c]);
    }
  }
}

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * 64 * (D + 1) + 64 * 65);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * 65);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * 65 + 2 * 64);
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
int launch(int which, const Args& a, int B, cudaStream_t st) {
  auto kernel = which == kFwd  ? flash_fwd_kernel<T, D>
                : which == kDq ? flash_bwd_dq_kernel<T, D>
                               : flash_bwd_dkv_kernel<T, D>;
  const size_t smem = which == kFwd  ? fwd_smem(D)
                      : which == kDq ? dq_smem(D)
                                     : dkv_smem(D);
  // Above 48 KB a kernel must opt in to dynamic shared memory. The
  // attribute is set once per kernel, at its first launch, so that later
  // launches (inside a CUDA graph capture too) are launches only.
  static bool configured[3] = {false, false, false};
  if (!configured[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[which] = true;
  }
  const dim3 grid((a.S + 63) / 64, a.H, B);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. `which`: 0 = K5 forward (o, lse_out),
// 1 = K6 (dq into o), 2 = K7 (dk into o, dv into o2). `strides` holds 12
// element strides: (b, s, h) of q, k, v and do. Pointers are device
// pointers; `stream` is a cudaStream_t. Returns cudaGetLastError() after
// the launch (0 = launched), or cudaErrorInvalidValue for a dtype or head
// dimension the kernels do not take.
extern "C" int hvd_flash_attention(
    int which, int dtype, int B, int S, int H, int D, int causal, float scale,
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* lse, const void* delta, const void* dlse,
    void* o, void* o2, void* lse_out, const long long* strides,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.mask = static_cast<const float*>(mask);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dlse = static_cast<const float*>(dlse);
  a.o = o;
  a.o2 = o2;
  a.lse_out = static_cast<float*>(lse_out);
  a.sq = {strides[0], strides[1], strides[2]};
  a.sk = {strides[3], strides[4], strides[5]};
  a.sv = {strides[6], strides[7], strides[8]};
  a.sdo = {strides[9], strides[10], strides[11]};
  a.S = S;
  a.H = H;
  a.causal = causal;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which < kFwd || which > kDkv) return cudaErrorInvalidValue;
  if (dtype == kF32 && D == 64) return launch<float, 64>(which, a, B, st);
  if (dtype == kF32 && D == 128) return launch<float, 128>(which, a, B, st);
  if (dtype == kBF16 && D == 64)
    return launch<__nv_bfloat16, 64>(which, a, B, st);
  if (dtype == kBF16 && D == 128)
    return launch<__nv_bfloat16, 128>(which, a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
