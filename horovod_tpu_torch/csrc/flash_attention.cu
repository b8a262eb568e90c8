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
// Two routes, chosen by dtype inside hvd_flash_attention:
//
// bf16, K5, K6 and K7: flash_fwd_sm90, flash_bwd_dq_sm90 and
// flash_bwd_dkv_sm90, Hopper kernels (sm_90a). At the training shape
// (B = 8, S = 512, H = 16, D = 64, causal) K5 must move ~34 MB (q, k, v,
// o once), K6 ~42 MB (q, k, v, do, dq) and K7 ~51 MB (q, k, v, do, dk,
// dv), 10.1, 12.7 and 15.2 us at 3.35 TB/s, against 4.3, 6.5 and 8.6
// GFLOP of causal products, 4.3, 6.5 and 8.7 us at the 989 TFLOP/s bf16
// tensor-core peak: bound by bytes, and only a tensor-core kernel comes
// near either bound. So every product is a wgmma m64n64k16 (bf16 in,
// fp32 accumulate): S = Q K^T and, in K6, dP = dO V^T, in K7 S^T = K Q^T
// and dP^T = V dO^T, read both operands from shared memory; P V, dS K,
// P^T dO and dS^T Q take P or dS from registers, converted to bf16 in
// place (the fp32 accumulator's fragment layout is the A operand's), as
// every Hopper flash kernel does. Tiles are 64 x 64 bf16, moved by TMA
// (4-D maps over the (b, s, h) strides, encoded per call on the host,
// passed as __grid_constant__; one backward call encodes q, k, v and do
// once for K6 and K7) into 128-byte-swizzled shared memory, with one
// mbarrier per stage of a 2-stage ring: K5 and K6 stream K and V past a
// resident Q (and dO), K7 streams Q and dO past resident K and V, so the
// next tile's load overlaps this tile's products. K5 runs the online
// softmax in the accumulator's layout (a row's max over the 4 lanes that
// hold it, exp2 with log2(e) folded into the scale); K5 and K6 launch
// their q blocks heaviest first, up to the causal bound hi = qb + 1; K7
// computes everything transposed, keys as the 64 M rows, from the causal
// lower bound lo = kb, with D / 64 warpgroups each owning 64 columns of
// dk and dv. Masks (causal, key mask, ragged S) are evaluated only on the
// tiles that need them. TMA fills rows past S with zeros; they still get
// p = 0. The wrapper hands these kernels tensors whose base and strides
// are multiples of 16 bytes (the fused QKV views are), copying any other
// once. ptxas (nvcc 12.9, -O3, sm_90a; python3 -m
// horovod_tpu_torch.ops.kernel_report): flash_fwd_sm90<64> 107
// registers, flash_bwd_dq_sm90<64> 122, flash_bwd_dkv_sm90<64> 204
// (D = 128: 140, 154 and 204), no spills; dynamic shared memory
// 42,048 bytes for K5 and 50,240 for K6 and K7 (D = 128: 83,008 and
// 99,392), above the 48 KB default, so the opt-in attribute is set per
// kernel and device. Rounding P and dS to
// bf16 before the products is the one numeric difference from the fp32
// JAX kernels; it stays inside the bf16 tolerance
// (tests/test_torch_port_flash_sm90.py).
//
// fp32 (K5, K6, K7): the CUDA-core kernels. One CTA of 256 threads per
// (q-block of 64 rows, head, batch) for K5/K6, looping over 64-key tiles
// up to the causal bound hi = min(ceil((qb + 64) / 64), nk); K7 one per
// (k-block, head, batch) from lo = kb / 64. Tiles are loaded element by
// element into padded fp32 shared memory; thread (ty, tx) = (tid / 16,
// tid % 16) owns rows ty + 16 i and columns tx + 16 j, so a row's
// reduction is a 16-lane shuffle; every product is an fp32 FMA. TF32
// tensor cores could not meet the fp32 tolerances (2e-4 forward, 5e-3
// gradients), so fp32 stays here.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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
  void* o2;                     // K7: dv; K6 then K7: dk
  void* o3;                     // K6 then K7: dv
  float* lse_out;               // forward: lse
  Strides sq, sk, sv, sdo;
  int S, H;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }

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

// ------------------------------------------ CUDA-core K5 (fp32) ------

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

// ------------------------------------------ CUDA-core K6 (fp32) ------

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

// ------------------------------------------ CUDA-core K7 (fp32) ------

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

// --------------------------------------- bf16 K5, K6 and K7 for sm_90a ------
//
// Tiles are 64 rows x 64 bf16 columns (one 128-byte row per tile row),
// landed by TMA with the 128-byte swizzle, 8 KB and 1024-byte aligned; a
// D = 128 operand is two such tiles side by side in D. `wgmma` reads them
// through matrix descriptors: K-major (the product runs over D, D
// contiguous) advances 32 bytes per 16-deep step inside the swizzle
// atom; MN-major (the product runs over the rows, tnspB) advances 16 rows
// = 2048 bytes per step. Both byte offsets of a descriptor are 1024: the
// stride between 8-row groups, the only one a 64-wide operand uses.

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kTile = 64 * 64;            // bf16 elements of one tile
constexpr int kTileBytes = kTile * 2;

struct TmaParams {
  CUtensorMap q, k, v, dout;              // (D, H, S, B) maps, 64 x 64 box
  Args a;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One 64 x 64 tile of head h, batch b, rows [row, row + 64), columns
// [col, col + 64) into `dst`; rows past S arrive as zeros.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int h,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(h), "r"(row), "r"(b)
      : "memory");
}

// A 64-row, 64-wide swizzled tile as a wgmma operand (see above).
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Ties an accumulator's registers to the point after wgmma_wait0, so the
// compiler reads them only once the asynchronous product has landed.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HVD_ACC32                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])
#define HVD_REG32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A . B, 64 x 64 x 16: A and B K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_REG32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HVD_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B, 64 x 64 x 16: A in registers (bf16 pairs in the
// accumulator's fragment layout), B an MN-major tile (tnspB).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HVD_REG32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HVD_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 64 fp32 accumulator as the bf16 A operand of four 16-deep
// steps: step kk takes columns [16 kk, 16 kk + 16), which the
// accumulator holds in d[8 kk .. 8 kk + 8) in exactly the A layout.
__device__ __forceinline__ void acc_to_a(const float (&d)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// Accumulator element i of a thread: row (within the 64) and column.
// Fragment layout of wgmma m64nNk16: warp w holds rows 16 w .. 16 w + 15;
// lane l holds rows l / 4 and l / 4 + 8 of them, columns 8 n + 2 (l % 4)
// and the next of every 8-column block n.
__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x & 127;
  return 16 * (t >> 5) + ((t & 31) >> 2) + ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t off = smem_u32(p) & 1023u;
  return off ? p + (1024u - off) : p;
}

// K5, bf16. One CTA (one warpgroup) per (head, batch, 64-row q block),
// q blocks launched heaviest first. Q lands once; K and V stream through
// a 2-stage ring up to the causal bound; S = Q K^T and O += P V run on
// the tensor cores, the online softmax in the accumulator's layout.
template <int D>
__global__ void __launch_bounds__(128, 1)
flash_fwd_sm90(const __grid_constant__ TmaParams p) {
  constexpr int NT = D / 64;              // 64-wide tiles across D
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* Qs = base;                     // NT tiles
  uint8_t* Ks = Qs + NT * kTileBytes;     // [2 stages][NT]
  uint8_t* Vs = Ks + 2 * NT * kTileBytes; // [2 stages][NT]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + 2 * NT * kTileBytes);

  const Args& a = p.a;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int q0 = qb * kBQ;
  const int nk = (a.S + kBK - 1) / kBK;
  const int hi = a.causal ? min(qb + 1, nk) : nk;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int stage, int j) {
    mbar_expect(&bars[1 + stage], 2 * NT * kTileBytes);
    for (int t = 0; t < NT; ++t) {
      tma_tile(Ks + (stage * NT + t) * kTileBytes, &p.k, &bars[1 + stage],
               64 * t, h, j * kBK, b);
      tma_tile(Vs + (stage * NT + t) * kTileBytes, &p.v, &bars[1 + stage],
               64 * t, h, j * kBK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect(&bars[0], NT * kTileBytes);
    for (int t = 0; t < NT; ++t)
      tma_tile(Qs + t * kTileBytes, &p.q, &bars[0], 64 * t, h, q0, b);
    for (int j = 0; j < min(2, hi); ++j) load_kv(j, j);
  }

  const float sl2 = a.scale * kLog2e;     // logits straight to log2 units
  const float mask2 = kMaskValue * kLog2e;
  float o[NT][32];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[t][i] = 0.0f;
  float m[2] = {mask2, mask2};            // rows acc_row(0), acc_row(2)
  float l[2] = {0.0f, 0.0f};              // this thread's partial sums
  const float* kmask =
      a.mask != nullptr ? a.mask + static_cast<long long>(b) * a.S : nullptr;

  mbar_wait(&bars[0], 0);
  for (int j = 0; j < hi; ++j) {
    const int stage = j & 1;
    const int k0 = j * kBK;
    mbar_wait(&bars[1 + stage], (j >> 1) & 1);
    const uint8_t* Kt = Ks + stage * NT * kTileBytes;
    const uint8_t* Vt = Vs + stage * NT * kTileBytes;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, tile_desc(Qs + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               tile_desc(Kt + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(s);

    const bool edge = (a.causal && k0 + kBK - 1 > q0) || kmask != nullptr ||
                      k0 + kBK > a.S;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * sl2;
      if (edge) {
        const int key = k0 + acc_col(i), row = q0 + acc_row(i);
        if (key >= a.S || (a.causal && key > row))
          x = -INFINITY;
        else if (kmask != nullptr && !(kmask[key] > 0.0f))
          x = mask2;
      }
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(s[i] - m[r]);          // 0 for a -inf logit
      l[r] += s[i];
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[t][i] *= alpha[(i >> 1) & 1];

    uint32_t pa[4][4];
    acc_to_a(s, pa);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(o[t], pa[kk], tile_desc(Vt + t * kTileBytes) + 128 * kk);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int t = 0; t < NT; ++t) fence_acc(o[t]);

    __syncthreads();                      // every warp is done with stage
    if (threadIdx.x == 0 && j + 2 < hi) load_kv(stage, j + 2);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    const int row = q0 + acc_row(2 * r);
    if (row >= a.S) continue;
    const float inv = 1.0f / lr;
    const long long rb =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = 4 * n + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(out + rb + 64 * t + acc_col(i)) =
            __floats2bfloat162_rn(o[t][i] * inv, o[t][i + 1] * inv);
      }
    if ((threadIdx.x & 3) == 0)
      a.lse_out[(static_cast<long long>(b) * a.H + h) * a.S + row] =
          m[r] * kLn2 + logf(lr);
  }
}

// K6, bf16. K5's structure with one more product and no online
// softmax: one CTA (one warpgroup) per (head, batch, 64-row q block), q
// blocks launched heaviest first. Q and dO land once; K and V stream
// through a 2-stage ring up to the causal bound. S = Q K^T and dP =
// dO V^T (both operands K-major) are one commit group; P = exp(s - lse)
// and dS = P (dP - delta + dlse) are formed in the accumulator's layout,
// where each thread's two query rows (acc_row(0), acc_row(2)) are fixed
// for the CTA, so lse and dlse - delta are loaded once; then dQ += dS K
// with dS as bf16 register operands and K the MN-major B operand, as K5
// takes V. Rows past S are computed but never written: a dQ row depends
// on its own dS row alone.
template <int D>
__global__ void __launch_bounds__(128, 1)
flash_bwd_dq_sm90(const __grid_constant__ TmaParams p) {
  constexpr int NT = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* Qs = base;                      // NT tiles
  uint8_t* dOs = Qs + NT * kTileBytes;     // NT tiles
  uint8_t* Ks = dOs + NT * kTileBytes;     // [2 stages][NT]
  uint8_t* Vs = Ks + 2 * NT * kTileBytes;  // [2 stages][NT]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + 2 * NT * kTileBytes);

  const Args& a = p.a;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int q0 = qb * kBQ;
  const int nk = (a.S + kBK - 1) / kBK;
  const int hi = a.causal ? min(qb + 1, nk) : nk;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int stage, int j) {
    mbar_expect(&bars[1 + stage], 2 * NT * kTileBytes);
    for (int t = 0; t < NT; ++t) {
      tma_tile(Ks + (stage * NT + t) * kTileBytes, &p.k, &bars[1 + stage],
               64 * t, h, j * kBK, b);
      tma_tile(Vs + (stage * NT + t) * kTileBytes, &p.v, &bars[1 + stage],
               64 * t, h, j * kBK, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect(&bars[0], 2 * NT * kTileBytes);
    for (int t = 0; t < NT; ++t) {
      tma_tile(Qs + t * kTileBytes, &p.q, &bars[0], 64 * t, h, q0, b);
      tma_tile(dOs + t * kTileBytes, &p.dout, &bars[0], 64 * t, h, q0, b);
    }
    for (int j = 0; j < min(2, hi); ++j) load_kv(j, j);
  }

  const float sl2 = a.scale * kLog2e;
  const long long bh = (static_cast<long long>(b) * a.H + h) * a.S;
  // lse (natural and log2 units) and dlse - delta of this thread's two
  // query rows, loaded while Q and dO land.
  float lse[2], lse2[2], dterm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(2 * r);
    const bool in = row < a.S;
    lse[r] = in ? a.lse[bh + row] : 0.0f;
    lse2[r] = lse[r] * kLog2e;
    dterm[r] = in ? (a.dlse != nullptr ? a.dlse[bh + row] : 0.0f) -
                        a.delta[bh + row]
                  : 0.0f;
  }
  const float* kmask =
      a.mask != nullptr ? a.mask + static_cast<long long>(b) * a.S : nullptr;
  float dq[NT][32];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[t][i] = 0.0f;

  mbar_wait(&bars[0], 0);
  for (int j = 0; j < hi; ++j) {
    const int stage = j & 1;
    const int k0 = j * kBK;
    mbar_wait(&bars[1 + stage], (j >> 1) & 1);
    const uint8_t* Kt = Ks + stage * NT * kTileBytes;
    const uint8_t* Vt = Vs + stage * NT * kTileBytes;

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(s, tile_desc(Qs + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               tile_desc(Kt + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, tile_desc(dOs + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               tile_desc(Vt + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(s);
    fence_acc(dp);

    const bool edge = (a.causal && k0 + kBK - 1 > q0) || kmask != nullptr ||
                      k0 + kBK > a.S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float pr = exp2f(s[i] * sl2 - lse2[r]);
      if (edge) {
        const int key = k0 + acc_col(i), row = q0 + acc_row(i);
        if (key >= a.S || (a.causal && key > row))
          pr = 0.0f;
        else if (kmask != nullptr && !(kmask[key] > 0.0f))
          pr = expf(kMaskValue - lse[r]);     // the -1e30 logit's p
      }
      dp[i] = pr * (dp[i] + dterm[r]);
    }

    uint32_t dsa[4][4];
    acc_to_a(dp, dsa);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dq[t], dsa[kk], tile_desc(Kt + t * kTileBytes) + 128 * kk);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int t = 0; t < NT; ++t) fence_acc(dq[t]);

    __syncthreads();                      // every warp is done with stage
    if (threadIdx.x == 0 && j + 2 < hi) load_kv(stage, j + 2);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + acc_row(2 * r);
    if (row >= a.S) continue;
    const long long rb =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int i = 4 * n + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(out + rb + 64 * t + acc_col(i)) =
            __floats2bfloat162_rn(dq[t][i] * a.scale,
                                  dq[t][i + 1] * a.scale);
      }
  }
}

// K7, bf16. One CTA per (head, batch, 64-key block); D / 64 warpgroups.
// K and V stay resident; Q and dO stream through a 2-stage ring from the
// causal lower bound. Everything is transposed so keys are the M rows:
// S^T = K Q^T and dP^T = V dO^T (both operands K-major), then dV += P^T dO
// and dK += dS^T Q with P^T and dS^T as bf16 register operands and dO, Q
// MN-major. Each warpgroup forms the whole S^T and dP^T and accumulates
// its own 64 columns of dK and dV.
template <int D>
__global__ void __launch_bounds__(2 * D, 1)
flash_bwd_dkv_sm90(const __grid_constant__ TmaParams p) {
  constexpr int NT = D / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* Ks = base;                      // NT tiles
  uint8_t* Vs = Ks + NT * kTileBytes;      // NT tiles
  uint8_t* Qs = Vs + NT * kTileBytes;      // [2 stages][NT]
  uint8_t* dOs = Qs + 2 * NT * kTileBytes; // [2 stages][NT]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dOs + 2 * NT * kTileBytes);

  const Args& a = p.a;
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;         // low blocks (most work) first
  const int nq = (a.S + kBQ - 1) / kBQ;
  const int lo = a.causal ? k0 / kBQ : 0;
  const int wg = threadIdx.x >> 7;         // this warpgroup's dK/dV tile

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_q = [&](int stage, int it) {
    mbar_expect(&bars[1 + stage], 2 * NT * kTileBytes);
    for (int t = 0; t < NT; ++t) {
      tma_tile(Qs + (stage * NT + t) * kTileBytes, &p.q, &bars[1 + stage],
               64 * t, h, it * kBQ, b);
      tma_tile(dOs + (stage * NT + t) * kTileBytes, &p.dout,
               &bars[1 + stage], 64 * t, h, it * kBQ, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect(&bars[0], 2 * NT * kTileBytes);
    for (int t = 0; t < NT; ++t) {
      tma_tile(Ks + t * kTileBytes, &p.k, &bars[0], 64 * t, h, k0, b);
      tma_tile(Vs + t * kTileBytes, &p.v, &bars[0], 64 * t, h, k0, b);
    }
    for (int it = lo; it < min(lo + 2, nq); ++it) load_q(it - lo, it);
  }

  const float sl2 = a.scale * kLog2e;
  const long long bh = (static_cast<long long>(b) * a.H + h) * a.S;
  // The key mask of this thread's two key rows, fixed for the CTA.
  bool hidden[2] = {false, false};
  if (a.mask != nullptr)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = k0 + acc_row(2 * r);
      hidden[r] = key < a.S &&
                  !(a.mask[static_cast<long long>(b) * a.S + key] > 0.0f);
    }
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.0f;

  mbar_wait(&bars[0], 0);
  for (int it = lo; it < nq; ++it) {
    const int n = it - lo, stage = n & 1;
    const int q0 = it * kBQ;
    mbar_wait(&bars[1 + stage], (n >> 1) & 1);
    const uint8_t* Qt = Qs + stage * NT * kTileBytes;
    const uint8_t* dOt = dOs + stage * NT * kTileBytes;

    float st[32], dpt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(st, tile_desc(Ks + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               tile_desc(Qt + (kk / 4) * kTileBytes) + 2 * (kk % 4), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dpt, tile_desc(Vs + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               tile_desc(dOt + (kk / 4) * kTileBytes) + 2 * (kk % 4),
               kk > 0);
    wgmma_commit();

    // lse and dlse - delta of this thread's 16 query columns, loaded
    // while the products run.
    float lse[16], dterm[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int q = q0 + acc_col(4 * (c >> 1) + (c & 1));
      const bool in = q < a.S;
      lse[c] = in ? a.lse[bh + q] : 0.0f;
      dterm[c] = in ? (a.dlse != nullptr ? a.dlse[bh + q] : 0.0f) -
                          a.delta[bh + q]
                    : 0.0f;
    }
    wgmma_wait0();
    fence_acc(st);
    fence_acc(dpt);

    const bool edge = (a.causal && q0 < k0 + kBK - 1) || a.mask != nullptr ||
                      q0 + kBQ > a.S || k0 + kBK > a.S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 2 * (i >> 2) + (i & 1);   // column slot of element i
      float pr = exp2f(st[i] * sl2 - lse[c] * kLog2e);
      if (edge) {
        const int q = q0 + acc_col(i), key = k0 + acc_row(i);
        if (q >= a.S || key >= a.S || (a.causal && key > q))
          pr = 0.0f;
        else if (hidden[(i >> 1) & 1])
          pr = expf(kMaskValue - lse[c]);     // the -1e30 logit's p
      }
      st[i] = pr;
      dpt[i] = pr * (dpt[i] + dterm[c]);
    }

    uint32_t pa[4][4], dsa[4][4];
    acc_to_a(st, pa);
    acc_to_a(dpt, dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dv, pa[kk], tile_desc(dOt + wg * kTileBytes) + 128 * kk);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(dk, dsa[kk], tile_desc(Qt + wg * kTileBytes) + 128 * kk);
    wgmma_commit();
    wgmma_wait0();
    fence_acc(dk);
    fence_acc(dv);

    __syncthreads();
    if (threadIdx.x == 0 && it + 2 < nq) load_q(stage, it + 2);
  }

  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(a.o);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(a.o2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = k0 + acc_row(2 * r);
    if (row >= a.S) continue;
    const long long rb =
        ((static_cast<long long>(b) * a.S + row) * a.H + h) * D + 64 * wg;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int i = 4 * n + 2 * r;
      *reinterpret_cast<__nv_bfloat162*>(dk_out + rb + acc_col(i)) =
          __floats2bfloat162_rn(dk[i] * a.scale, dk[i + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv_out + rb + acc_col(i)) =
          __floats2bfloat162_rn(dv[i], dv[i + 1]);
    }
  }
}

// ------------------------------------------------------------ launches ----

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * 64 * (D + 1) + 64 * 65);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * 64 * (D + 1) + 64 * 65);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * 64 * 65 + 2 * 64);
}

// kBwd: K6 then K7 in one call (dq into o, dk into o2, dv into o3), with
// the bf16 tensor maps encoded once for both.
enum Which { kFwd = 0, kDq = 1, kDkv = 2, kBwd = 3 };

constexpr int kMaxDevices = 64;

// Above 48 KB a kernel must opt in to dynamic shared memory. The
// attribute belongs to the current device, so it is set once per kernel
// and device, at the kernel's first launch there; later launches (inside
// a CUDA graph capture too) are launches only. A device past
// kMaxDevices sets it at every launch.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && configured[dev]) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  return static_cast<int>(err);
}

// The CUDA-core kernels: every fp32 launch.
template <int D, int W>
int launch_cc(const Args& a, int B, cudaStream_t st) {
  constexpr size_t smem = W == kFwd  ? fwd_smem(D)
                          : W == kDq ? dq_smem(D)
                                     : dkv_smem(D);
  auto kernel = [] {                      // instantiates only kernel W
    if constexpr (W == kFwd) return flash_fwd_kernel<float, D>;
    else if constexpr (W == kDq) return flash_bwd_dq_kernel<float, D>;
    else return flash_bwd_dkv_kernel<float, D>;
  }();
  static bool configured[kMaxDevices] = {};
  if (const int err = allow_smem(kernel, smem, configured)) return err;
  const dim3 grid((a.S + 63) / 64, a.H, B);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so
// that no source links libcuda itself.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A bf16 (B, S, H, D) tensor as a 4-D TMA map (D, H, S, B innermost
// first) whose box is one 64 x 64 tile of one head, 128-byte swizzled.
// The encoder refuses a base or stride that is not a multiple of 16
// bytes; the wrapper makes such a tensor contiguous before the call.
bool tile_map(CUtensorMap* map, const void* ptr, const Strides& st, int B,
              int S, int H, int D) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One bf16 Hopper kernel W on maps already encoded in p.
template <int D, int W>
int run_sm90(const TmaParams& p, int B, cudaStream_t st) {
  constexpr int tiles = (W == kFwd ? 5 : 6) * (D / 64);
  constexpr size_t smem = 1024 + tiles * kTileBytes + 64;
  auto kernel = [] {                      // instantiates only kernel W
    if constexpr (W == kFwd) return flash_fwd_sm90<D>;
    else if constexpr (W == kDq) return flash_bwd_dq_sm90<D>;
    else return flash_bwd_dkv_sm90<D>;
  }();
  static bool configured[kMaxDevices] = {};
  if (const int err = allow_smem(kernel, smem, configured)) return err;
  const dim3 grid(p.a.H, B, (p.a.S + 63) / 64);
  kernel<<<grid, W == kDkv ? 2 * D : 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 route: K5, K6, K7, or K6 then K7 on one set of maps.
template <int D>
int launch_sm90(int which, const Args& a, int B, cudaStream_t st) {
  TmaParams p;
  memset(&p, 0, sizeof(p));
  p.a = a;
  if (!tile_map(&p.q, a.q, a.sq, B, a.S, a.H, D) ||
      !tile_map(&p.k, a.k, a.sk, B, a.S, a.H, D) ||
      !tile_map(&p.v, a.v, a.sv, B, a.S, a.H, D) ||
      (which != kFwd && !tile_map(&p.dout, a.dout, a.sdo, B, a.S, a.H, D)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (which == kFwd) return run_sm90<D, kFwd>(p, B, st);
  if (which == kDkv) return run_sm90<D, kDkv>(p, B, st);
  if (const int err = run_sm90<D, kDq>(p, B, st)) return err;
  if (which == kDq) return 0;
  p.a.o = a.o2;
  p.a.o2 = a.o3;
  return run_sm90<D, kDkv>(p, B, st);
}

template <int D>
int dispatch(int which, int dtype, const Args& a, int B, cudaStream_t st) {
  if (dtype == kBF16) return launch_sm90<D>(which, a, B, st);
  if (which == kFwd) return launch_cc<D, kFwd>(a, B, st);
  if (which == kDkv) return launch_cc<D, kDkv>(a, B, st);
  if (const int err = launch_cc<D, kDq>(a, B, st)) return err;
  if (which == kDq) return 0;
  Args a7 = a;
  a7.o = a.o2;
  a7.o2 = a.o3;
  return launch_cc<D, kDkv>(a7, B, st);
}

}  // namespace

// Plain C interface for ctypes. `which`: 0 = K5 forward (o, lse_out),
// 1 = K6 (dq into o), 2 = K7 (dk into o, dv into o2), 3 = K6 then K7 on
// the same stream (dq into o, dk into o2, dv into o3). `strides` holds 12
// element strides: (b, s, h) of q, k, v and do. Pointers are device
// pointers; `stream` is a cudaStream_t; the launch goes to the current
// device. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a dtype, head dimension or (bf16) a layout
// the kernels do not take.
extern "C" int hvd_flash_attention(
    int which, int dtype, int B, int S, int H, int D, int causal, float scale,
    const void* q, const void* k, const void* v, const void* dout,
    const void* mask, const void* lse, const void* delta, const void* dlse,
    void* o, void* o2, void* o3, void* lse_out, const long long* strides,
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
  a.o3 = o3;
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
  if (which < kFwd || which > kBwd || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64) return dispatch<64>(which, dtype, a, B, st);
  if (D == 128) return dispatch<128>(which, dtype, a, B, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
