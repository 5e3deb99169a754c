// Flash attention backward for Hopper (sm_90a): the fused kernel and the
// split dq / dk-dv kernels.
//
// Replaces three TPU kernels of ray_tpu/ops/pallas/flash.py, all behind
// the custom VJP's `_bwd`:
//   * `_bwd_fused_kernel` (pallas_call at flash.py:393), taken while
//     `_fused_bwd_fits`: entry point flash_bwd_fused_launch;
//   * `_bwd_dq_kernel` (flash.py:418) and `_bwd_dkv_kernel` (flash.py:433),
//     the long-sequence split path: flash_bwd_dq_launch and
//     flash_bwd_dkv_launch.
//
// What they compute, per (batch, head), with the forward's LSE and
// delta = sum_d dO * O (both f32, [b, h, sq]) as inputs:
//   p  = exp(q.k^T * scale - lse) where the key is visible, else 0
//   dv = p^T dO,  dp = dO v^T,  ds = p (dp - delta) scale,
//   dk = ds^T q,  dq = ds k.
// Causal masking is aligned top-left (q_pos >= k_pos) and keys past sk
// are masked, as in the TPU kernels; scores, p, ds and every
// accumulation are f32, and p and ds are rounded to the input dtype
// before the products they feed (flash.py's astype before each dot).
// GQA: query head hi reads kv head hi / group; dk and dv of a kv head
// are summed over its group inside the kernel (the TPU path expands K/V
// with jnp.repeat, whose transpose is the same group sum).
//
// What bounds them on the H100: operations. Per causal head the backward
// does ~2.5x the forward's 2 * 2 * s^2 / 2 * d flops on ~8 s d values,
// far above the ~295 flop/byte ridge, so the tensor cores are the bound
// a fast version would reach. These first versions are the simple, right
// ones: f32 FMAs on the CUDA cores with 64 x 64 tiles, as the forward
// (flash_fwd.cu); wgmma and TMA are later work (PERF.md has the gap).
//
// The design, and what it does about Hopper:
//   * The TPU's fused kernel walks every k block of one (b, h) in order
//     and keeps dq for the whole sequence in an f32 VMEM scratch. At
//     s 1024, d 64 that scratch plus the resident q/dO/K/V is ~1 MB,
//     far over 227 KB of shared memory, and CUDA blocks run in no order.
//     So the fused kernel runs one CTA per (b, kv head, 64-key tile):
//     dk and dv of the tile stay in registers while the CTA loops over
//     the q tiles from the causal diagonal down, and each q tile's dq
//     contribution ds.k is added with f32 atomicAdd into a [b, h, s, d]
//     f32 buffer that the wrapper zeroes on the same stream. The order
//     of those additions depends on how the CTAs are scheduled, so dq is
//     not bit-identical run to run: it differs in the last bits of an
//     f32 sum of at most s/64 terms, well inside the tolerance the
//     gradient is held to (and far below bf16's rounding, the dtype dq
//     is cast to on the training path). s and p are computed once per
//     (q tile, k tile) pair, as in the TPU's fused kernel.
//   * The split path needs no atomics: flash_bwd_dq_kernel runs one CTA
//     per (b, head, 64-row q tile) looping over the k tiles up to the
//     diagonal; flash_bwd_dkv_kernel one CTA per (b, kv head, k tile)
//     looping over the q tiles from the diagonal down. Each recomputes
//     s and p, as the TPU's split kernels do.
//   * Tiles are staged through shared memory as f32 with 16-byte loads,
//     rows padded to d + 1 floats so the inner products are free of bank
//     conflicts. Each of the 256 threads owns a 4 x 4 patch of the score
//     tile and a 4 x (d/16) patch of each accumulator. Arbitrary
//     batch/head/sequence strides with a unit-stride head dim: "bshd"
//     and "bhsd" run without a transpose, and gradients are written in
//     the inputs' layout.
//   * Causal tiles are issued longest first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // q and k tile rows
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 score patch each
constexpr int kSP = kB + 1;     // padded row stride of the p / ds tiles

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
// x rounded to T and back: the TPU kernels' astype before a product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Element strides of one [b, h, s, d] operand (the head dim is unit
// stride).
struct Str {
  int64_t b, h, s;
};
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // [b, h, sq] f32
  const float* delta;   // [b, h, sq] f32
  void* dq;             // T, or f32 for the fused kernel's atomics
  void* dk;
  void* dv;
  Str sq_, sk_, sv_, sdo_, sdq_, sdk_, sdv_;
  int h, group, sq, sk, causal;
  float scale;
};

// Rows [row0, row0 + 64) of a [seq, D] slice with row stride `rs` into
// shared memory as f32 (row stride D + 1), zero past `nrows`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t rs, int row0, int nrows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = D / kVec;
  for (int e = threadIdx.x; e < kB * kVecsPerRow; e += kThreads) {
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
    for (int i = 0; i < kVec; ++i) dst[r * (D + 1) + c0 + i] = f[i];
  }
}

// lse and delta of rows [row0, row0 + 64) of one (b, h), 0 past sq.
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const float* lse, const float* dl,
                                          int row0, int sq) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const bool ok = row0 + r < sq;
    lse_s[r] = ok ? lse[row0 + r] : 0.f;
    dl_s[r] = ok ? dl[row0 + r] : 0.f;
  }
}

// The (q tile, k tile) pair's p and ds, each rounded to T, into shared
// memory (row stride kSP). qs/dos: the q tile's q and dO; ks/vs: the k
// tile's K and V (row stride D + 1). Thread (ty, tx) owns rows
// ty + 16 i and columns tx + 16 j.
template <typename T, int D>
__device__ __forceinline__ void p_and_ds(
    float* ps, float* dss, const float* qs, const float* dos,
    const float* ks, const float* vs, const float* lse_s, const float* dl_s,
    int q0, int k0, const Args& a) {
  constexpr int kDP = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * kDP + c];
      dov[i] = dos[(ty + 16 * i) * kDP + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * kDP + c];
      vv[j] = vs[(tx + 16 * j) * kDP + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += qv[i] * kv[j];
        dp[i][j] += dov[i] * vv[j];
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const int kpos = k0 + col;
      const bool ok =
          qpos < a.sq && kpos < a.sk && (!a.causal || qpos >= kpos);
      const float p = ok ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
      const float ds = p * (dp[i][j] - dl_s[r]) * a.scale;
      ps[r * kSP + col] = round_to<T>(p);
      dss[r * kSP + col] = round_to<T>(ds);
    }
  }
}

// dv += p^T dO and dk += ds^T q for the thread's 4 key rows (ty + 16 i)
// and d/16 columns (tx + 16 j).
template <int D>
__device__ __forceinline__ void acc_dkv(float (*dk)[D / 16],
                                        float (*dv)[D / 16], const float* ps,
                                        const float* dss, const float* qs,
                                        const float* dos) {
  constexpr int kDP = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int r = 0; r < kB; ++r) {
    float pv[4], dsv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pv[i] = ps[r * kSP + ty + 16 * i];
      dsv[i] = dss[r * kSP + ty + 16 * i];
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float dov = dos[r * kDP + tx + 16 * j];
      const float qv = qs[r * kDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dv[i][j] += pv[i] * dov;
        dk[i][j] += dsv[i] * qv;
      }
    }
  }
}

// dq += ds k for the thread's 4 query rows (ty + 16 i) and d/16 columns
// (tx + 16 j).
template <int D>
__device__ __forceinline__ void acc_dq(float (*dq)[D / 16], const float* dss,
                                       const float* ks) {
  constexpr int kDP = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int kk = 0; kk < kB; ++kk) {
    float dsv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * kSP + kk];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float kv = ks[kk * kDP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[i][j] += dsv[i] * kv;
    }
  }
}

template <int D>
constexpr int smem_floats_kv() {   // fused and dk/dv kernels
  return 4 * kB * (D + 1) + 2 * kB * kSP + 2 * kB;
}
template <int D>
constexpr int smem_floats_q() {    // dq kernel
  return 4 * kB * (D + 1) + kB * kSP + 2 * kB;
}

// One CTA per (k tile, kv head, batch): dk and dv of the tile, summed
// over the kv head's group of query heads; with kFused, also each q
// tile's dq contribution by f32 atomicAdd into a.dq.
template <typename T, int D, bool kFused>
__global__ void __launch_bounds__(kThreads) flash_bwd_kv_kernel(Args a) {
  constexpr int kDP = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kB * kDP;
  float* qs = vs + kB * kDP;
  float* dos = qs + kB * kDP;
  float* ps = dos + kB * kDP;
  float* dss = ps + kB * kSP;
  float* lse_s = dss + kB * kSP;
  float* dl_s = lse_s + kB;

  const int kt = blockIdx.x;       // low tiles have the most q tiles
  const int kvh = blockIdx.y, bi = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * kB;
  const int nq = (a.sq + kB - 1) / kB;

  const T* kb = static_cast<const T*>(a.k) + bi * a.sk_.b + kvh * a.sk_.h;
  const T* vb = static_cast<const T*>(a.v) + bi * a.sv_.b + kvh * a.sv_.h;
  load_tile<T, D>(ks, kb, a.sk_.s, k0, a.sk);
  load_tile<T, D>(vs, vb, a.sv_.s, k0, a.sk);

  float dk[4][kDJ], dv[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // Causal: q tiles below the diagonal only (tile qt sees key k0 only
  // if qt * 64 + 63 >= k0).
  const int q_lo = a.causal ? kt : 0;
  for (int g = 0; g < a.group; ++g) {
    const int hi = kvh * a.group + g;
    const T* qb = static_cast<const T*>(a.q) + bi * a.sq_.b + hi * a.sq_.h;
    const T* dob =
        static_cast<const T*>(a.dout) + bi * a.sdo_.b + hi * a.sdo_.h;
    const int64_t row_off = ((int64_t)bi * a.h + hi) * a.sq;
    for (int qt = q_lo; qt < nq; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();   // the previous q tile is fully consumed
      load_tile<T, D>(qs, qb, a.sq_.s, q0, a.sq);
      load_tile<T, D>(dos, dob, a.sdo_.s, q0, a.sq);
      load_rows(lse_s, dl_s, a.lse + row_off, a.delta + row_off, q0, a.sq);
      __syncthreads();
      p_and_ds<T, D>(ps, dss, qs, dos, ks, vs, lse_s, dl_s, q0, k0, a);
      __syncthreads();
      acc_dkv<D>(dk, dv, ps, dss, qs, dos);
      if (kFused) {
        float dq[4][kDJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kDJ; ++j) dq[i][j] = 0.f;
        acc_dq<D>(dq, dss, ks);
        float* dqb = static_cast<float*>(a.dq) + bi * a.sdq_.b +
                     hi * a.sdq_.h;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + ty + 16 * i;
          if (r >= a.sq) continue;
#pragma unroll
          for (int j = 0; j < kDJ; ++j)
            atomicAdd(dqb + r * a.sdq_.s + tx + 16 * j, dq[i][j]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(a.dk) + bi * a.sdk_.b + kvh * a.sdk_.h;
  T* dvb = static_cast<T*>(a.dv) + bi * a.sdv_.b + kvh * a.sdv_.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= a.sk) continue;
#pragma unroll
    for (int j = 0; j < kDJ; ++j) {
      dkb[r * a.sdk_.s + tx + 16 * j] = from_f<T>(dk[i][j]);
      dvb[r * a.sdv_.s + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

// One CTA per (q tile, head, batch): dq of the tile over the k tiles up
// to the diagonal.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int kDP = D + 1;
  constexpr int kDJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kB * kDP;
  float* ks = dos + kB * kDP;
  float* vs = ks + kB * kDP;
  float* dss = vs + kB * kDP;
  float* lse_s = dss + kB * kSP;
  float* dl_s = lse_s + kB;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kvh = hi / a.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * kB;
  const int nk = (a.sk + kB - 1) / kB;
  const int upper = a.causal ? min(nk, qt + 1) : nk;

  const T* qb = static_cast<const T*>(a.q) + bi * a.sq_.b + hi * a.sq_.h;
  const T* dob = static_cast<const T*>(a.dout) + bi * a.sdo_.b + hi * a.sdo_.h;
  const T* kb = static_cast<const T*>(a.k) + bi * a.sk_.b + kvh * a.sk_.h;
  const T* vb = static_cast<const T*>(a.v) + bi * a.sv_.b + kvh * a.sv_.h;
  const int64_t row_off = ((int64_t)bi * a.h + hi) * a.sq;
  load_tile<T, D>(qs, qb, a.sq_.s, q0, a.sq);
  load_tile<T, D>(dos, dob, a.sdo_.s, q0, a.sq);
  load_rows(lse_s, dl_s, a.lse + row_off, a.delta + row_off, q0, a.sq);

  float dq[4][kDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kDJ; ++j) dq[i][j] = 0.f;

  for (int kt = 0; kt < upper; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();   // the previous k tile is fully consumed
    load_tile<T, D>(ks, kb, a.sk_.s, k0, a.sk);
    load_tile<T, D>(vs, vb, a.sv_.s, k0, a.sk);
    __syncthreads();
    // The dq kernel needs no p tile: p_and_ds writes p, then ds, to the
    // same place of the thread's own patch, and ds is what stays.
    p_and_ds<T, D>(dss, dss, qs, dos, ks, vs, lse_s, dl_s, q0, k0, a);
    __syncthreads();
    acc_dq<D>(dq, dss, ks);
  }

  T* dqb = static_cast<T*>(a.dq) + bi * a.sdq_.b + hi * a.sdq_.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < kDJ; ++j)
      dqb[r * a.sdq_.s + tx + 16 * j] = from_f<T>(dq[i][j]);
  }
}

// kind: 0 = fused, 1 = dq, 2 = dk/dv.
template <typename T, int D>
int launch(int kind, const Args& a, int b, cudaStream_t stream) {
  const int hkv = a.h / a.group;
  const int nq = (a.sq + kB - 1) / kB, nk = (a.sk + kB - 1) / kB;
  if (kind == 1) {
    auto kern = flash_bwd_dq_kernel<T, D>;
    constexpr int smem = (int)sizeof(float) * smem_floats_q<D>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nq, a.h, b), kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  auto kern = kind == 0 ? flash_bwd_kv_kernel<T, D, true>
                        : flash_bwd_kv_kernel<T, D, false>;
  constexpr int smem = (int)sizeof(float) * smem_floats_kv<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(nk, hkv, b), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int kind, int d, const Args& a, int b, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(kind, a, b, s);
    case 32: return launch<T, 32>(kind, a, b, s);
    case 48: return launch<T, 48>(kind, a, b, s);
    case 64: return launch<T, 64>(kind, a, b, s);
    case 80: return launch<T, 80>(kind, a, b, s);
    case 96: return launch<T, 96>(kind, a, b, s);
    case 112: return launch<T, 112>(kind, a, b, s);
    case 128: return launch<T, 128>(kind, a, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_any(int kind, int dtype, int d, const void* q, const void* k,
               const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, void* dk, void* dv, int b,
               int h, int group, int sq, int sk, const int64_t* st,
               int causal, float scale, void* stream) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv;
  Str* strs[7] = {&a.sq_, &a.sk_, &a.sv_, &a.sdo_, &a.sdq_, &a.sdk_, &a.sdv_};
  for (int i = 0; i < 7; ++i) {
    strs[i]->b = st[3 * i];
    strs[i]->h = st[3 * i + 1];
    strs[i]->s = st[3 * i + 2];
  }
  a.h = h; a.group = group; a.sq = sq; a.sk = sk; a.causal = causal;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(kind, d, a, b, s);
  if (dtype == 1) return launch_d<__nv_bfloat16>(kind, d, a, b, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Common arguments: dtype 0 = float32, 1 = bfloat16; d in {16, 32, ...,
// 128}; q and dout [.., sq, h, ..], k and v [.., sk, h / group, ..] in
// any batch/head/sequence strides with a unit-stride head dim; lse and
// delta [b, h, sq] float32. strides (elements), 21 of them: (batch,
// head, seq) of q, k, v, dout, dq, dk, dv. Each returns a cudaError_t
// (0 = launched).

// Fused: dq is a ZEROED float32 buffer, accumulated with atomicAdd; dk
// and dv are in the input dtype.
int flash_bwd_fused_launch(int dtype, int d, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* delta, float* dq, void* dk, void* dv,
                           int b, int h, int group, int sq, int sk,
                           const int64_t* strides, int causal, float scale,
                           void* stream) {
  return launch_any(0, dtype, d, q, k, v, dout, lse, delta, dq, dk, dv, b, h,
                    group, sq, sk, strides, causal, scale, stream);
}

// Split, dq only (input dtype).
int flash_bwd_dq_launch(int dtype, int d, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, int b, int h,
                        int group, int sq, int sk, const int64_t* strides,
                        int causal, float scale, void* stream) {
  return launch_any(1, dtype, d, q, k, v, dout, lse, delta, dq, nullptr,
                    nullptr, b, h, group, sq, sk, strides, causal, scale,
                    stream);
}

// Split, dk and dv only (input dtype).
int flash_bwd_dkv_launch(int dtype, int d, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* delta, void* dk, void* dv, int b,
                         int h, int group, int sq, int sk,
                         const int64_t* strides, int causal, float scale,
                         void* stream) {
  return launch_any(2, dtype, d, q, k, v, dout, lse, delta, nullptr, dk, dv,
                    b, h, group, sq, sk, strides, causal, scale, stream);
}

const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
