// Flash attention forward for Hopper (sm_90a), with and without the LSE.
//
// Replaces two TPU kernels of ray_tpu/ops/pallas/flash.py:
//   * `_fwd_kernel` (the with_lse=False pallas_call of `_fwd`, the
//     primal path: `flash_attention` without grad, the use_flash
//     prefill), entry point flash_fwd_launch;
//   * `_fwd_kernel_with_lse` (the with_lse=True pallas_call, the
//     custom-VJP forward of training), entry point flash_fwd_lse_launch:
//     the same kernel, also writing the f32 row logsumexp
//     m + log(max(l, 1e-30)) to a [b, h, sq] buffer for the backward
//     (ops/csrc/flash_bwd.cu). Masked scores are the finite -1e9, so the
//     LSE is finite on every row, as the TPU kernel's is (flash.py:99-107).
//
// What it computes: blockwise online-softmax attention of one
// (batch, head) over keys 0..sk-1, causal with TOP-LEFT alignment
// (q_pos >= k_pos) or dense; keys past sk are masked; key tiles wholly
// above the diagonal are skipped (the TPU kernel's `upper` bound).
// Scores and softmax statistics are f32, p is rounded to the value dtype
// before PV (flash.py's p.astype(v_blk.dtype)), the output is in the
// input dtype. GQA: query head hi reads kv head hi / group.
//
// What bounds it on the H100: operations. At s = 1024, d = 64 a causal
// head does ~2 * 2 * s^2 / 2 * d flops on 4 * s * d values, far above
// the card's ~295 flop/byte ridge, so the tensor cores (wgmma) are the
// limit a fast version would reach. This first version is the simple,
// right one: f32 FMAs on the CUDA cores, which caps it well below the
// bound (PERF.md has the measured gap). The design:
//   * one CTA (256 threads) per (b, h, 64-row q tile), the q tile kept
//     in shared memory as f32;
//   * a loop over 64-key K/V tiles staged through shared memory with
//     16-byte loads: the whole (b, h) K/V that the TPU kernel keeps
//     resident in VMEM does not fit Hopper's 227 KB of shared memory;
//   * each thread owns a 4 x 4 patch of the score tile and a 4 x (d/16)
//     patch of the output accumulator in registers; rows are padded to
//     d + 1 floats so the inner products are free of bank conflicts;
//   * causal tiles are issued longest first (q tile index reversed).
// It reads arbitrary batch/head/sequence strides with a unit-stride head
// dim, so "bshd" and "bhsd" both run without a transpose.
// wgmma, TMA and a producer/consumer pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 score patch each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + 64) of a [seq, D] slice with row stride `rs` into
// shared memory as f32 (row stride `ld`), zero past `nrows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int64_t rs, int row0, int nrows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = D / kVec;
  for (int e = threadIdx.x; e < kBQ * kVecsPerRow; e += kThreads) {
    const int r = e / kVecsPerRow;
    const int c0 = (e % kVecsPerRow) * kVec;
    float f[kVec];
    if (row0 + r < nrows) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (row0 + r) * rs + c0);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = to_f(t[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[r * ld + c0 + i] = f[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int group, int sq, int sk,
    int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int causal, float scale) {
  constexpr int kDP = D + 1;        // padded row stride of q and k tiles
  constexpr int kSP = kBK + 1;      // padded row stride of the score tile
  constexpr int kDJ = D / 16;       // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // kBQ * kDP
  float* ks = qs + kBQ * kDP;       // kBK * kDP
  float* vs = ks + kBK * kDP;       // kBK * D
  float* ss = vs + kBK * D;         // kBQ * kSP
  float* m_row = ss + kBQ * kSP;    // kBQ
  float* l_row = m_row + kBQ;       // kBQ
  float* c_row = l_row + kBQ;       // kBQ

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kvh = hi / group;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = qt * kBQ;

  const T* qb = q + bi * q_sb + hi * q_sh;
  const T* kb = k + bi * k_sb + kvh * k_sh;
  const T* vb = v + bi * v_sb + kvh * v_sh;
  T* ob = o + bi * o_sb + hi * o_sh;

  load_tile<T, D>(qs, kDP, qb, q_ss, q0, sq);
  for (int r = tid; r < kBQ; r += kThreads) {
    m_row[r] = -INFINITY;
    l_row[r] = 0.f;
  }
  float acc[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) acc[i][j] = 0.f;

  const int nk = (sk + kBK - 1) / kBK;
  const int upper = causal ? min(nk, (q0 + kBQ + kBK - 1) / kBK) : nk;
  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();   // the previous tile is fully consumed
    load_tile<T, D>(ks, kDP, kb, k_ss, k0, sk);
    load_tile<T, D>(vs, D, vb, v_ss, k0, sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * kDP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kDP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int kpos = k0 + col;
        const bool ok = kpos < sk && (!causal || q0 + r >= kpos);
        ss[r * kSP + col] = ok ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax: 8 warps x 8 rows, two columns per lane.
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* sr = ss + r * kSP;
      const float a = sr[lane], b = sr[lane + 32];
      const float m_old = m_row[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(a, b)));
      const float pa = expf(a - m_new), pb = expf(b - m_new);
      const float sum = warp_sum(pa + pb);
      sr[lane] = to_f(from_f<T>(pa));        // p in the value dtype
      sr[lane + 32] = to_f(from_f<T>(pb));
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_row[r] = corr;
        l_row[r] = l_row[r] * corr + sum;
        m_row[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_row[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const float vv = vs[kk * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    const float l = fmaxf(l_row[r], 1e-30f);
    T* orow = ob + (q0 + r) * o_ss;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
  if (lse != nullptr) {
    // Row logsumexp, [b, h, sq] f32 (the primal path passes nullptr).
    float* lrow = lse + ((int64_t)bi * gridDim.y + hi) * sq + q0;
    for (int r = tid; r < kBQ; r += kThreads)
      if (q0 + r < sq) lrow[r] = m_row[r] + logf(fmaxf(l_row[r], 1e-30f));
  }
}

constexpr int smem_bytes(int d) {
  return (int)sizeof(float) *
         (kBQ * (d + 1) + kBK * (d + 1) + kBK * d + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int h,
           int group, int sq, int sk, const int64_t* st, int causal,
           float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, D>;
  constexpr int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, group, sq, sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int h, int group, int sq, int sk,
             const int64_t* st,
             int causal, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, b, h, group, sq, sk, st, causal, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, h, group, sq, sk, st, causal, scale, s);
    case 48: return launch<T, 48>(q, k, v, o, lse, b, h, group, sq, sk, st, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, h, group, sq, sk, st, causal, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, lse, b, h, group, sq, sk, st, causal, scale, s);
    case 96: return launch<T, 96>(q, k, v, o, lse, b, h, group, sq, sk, st, causal, scale, s);
    case 112: return launch<T, 112>(q, k, v, o, lse, b, h, group, sq, sk, st, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, h, group, sq, sk, st, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d in {16, 32, ..., 128}; lse, when
// not null, is a [b, h, sq] float32 buffer.
// strides (elements): q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
// v_ss, o_sb, o_sh, o_ss; the head dim is unit-stride.
// Returns a cudaError_t (0 = launched).
int flash_fwd_lse_launch(int dtype, int d, const void* q, const void* k,
                         const void* v, void* o, float* lse, int b, int h,
                         int group, int sq, int sk, const int64_t* strides,
                         int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, lse, b, h, group, sq, sk, strides,
                           causal, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, lse, b, h, group, sq, sk,
                                   strides, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The primal path: no LSE.
int flash_fwd_launch(int dtype, int d, const void* q, const void* k,
                     const void* v, void* o, int b, int h, int group, int sq,
                     int sk, const int64_t* strides, int causal, float scale,
                     void* stream) {
  return flash_fwd_lse_launch(dtype, d, q, k, v, o, nullptr, b, h, group, sq,
                              sk, strides, causal, scale, stream);
}

int flash_fwd_smem_bytes(int d) { return smem_bytes(d); }

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
