// Flash attention backward for Hopper (sm_90a): the fused route and the
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
// What bounds them on the H100: operations. Per causal head the fused
// backward does 2.5x the forward's 2 * 2 * s^2 / 2 * d flops (five
// products) on ~8 s d values, far above the ~295 flop/byte ridge, so the
// bf16 tensor cores are the bound; the split dq kernel does three of those
// products (1.5x) and the dk/dv kernel four (2x), on the same bytes.
//
// The fused route, bfloat16: flash_bwd_wgmma_kernel<DP>, then
// flash_bwd_dq_sum_kernel. The TPU kernel walks every k block of one
// (b, h) in order and keeps dq for the whole sequence in an f32 VMEM
// scratch; Hopper has 227 KB of shared memory and runs CTAs in no order.
// The design:
//   * one CTA of three warpgroups per (kv head, batch, 128-key tile), the
//     key tile the grid's slowest axis, so the tiles with the longest
//     causal walks (the first) start first. K and V of the tile are
//     loaded once by TMA; the CTA walks the kv head's group of query
//     heads and, for each, the q tiles from the causal diagonal down
//     (the first is floor(k0 / BQ), as the reference's `lower`);
//   * warpgroup 0 is the producer: one thread keeps a two-stage ring of
//     Q and dO tiles (4-D tensor maps with the tensors' own byte strides,
//     64-column boxes, the 128-byte swizzle; TMA's zero fill pads the head
//     dim to DP = 64 or 128 and rows past sq) and of the tile's LSE and
//     delta rows (one bulk copy from a [b, h, q tiles, 2, BQ] buffer the
//     wrapper pads with zeros), under "full" and "empty" mbarriers, then
//     gives its registers to the consumers with setmaxnreg;
//   * warpgroups 1 and 2 each own 64 of the tile's keys and issue the
//     five products on wgmma. They compute the scores transposed, so that
//     p and ds land in registers in the layout of wgmma's A operand:
//       S^T = K Q^T and dP^T = V dO^T (both operands K-major);
//       P^T = exp2(S^T scale log2(e) - lse log2(e)), masked, and
//       dS^T = P^T (dP^T - delta) scale, each rounded to bf16 in registers;
//       dV += P^T dO and dK += dS^T Q, A from registers, dO and Q read
//       MN-major through the transpose bit; dK and dV stay in f32
//       registers for the whole walk;
//       dQ_tile = dS K: dS^T is stored to shared memory (the 128-byte
//       swizzle written by hand, two buffers, one named barrier a q tile
//       between the consumers) and read back as an MN-major A operand, K
//       as an MN-major B. Each consumer computes one 64 x 64 block of the
//       tile's dq: q rows 64w.. when BQ = 128, head-dim columns 64w.. when
//       DP = 128 (BQ DP = 8192);
//   * dq without atomics, in a fixed order: the CTA writes its tile's dq
//     contribution, f32, to slot kt of a [n_k_tiles, b, h, sq, d]
//     workspace, and flash_bwd_dq_sum_kernel sums, for every element, the
//     slots 0 .. last visible key tile in increasing kt and writes dq in
//     the input dtype. Two calls on the same inputs give the same bits.
//     The price is the workspace's traffic: ~113 MB written and read at
//     the training shape [8, 1023, 12, 64].
//   Tiles: BK 128; BQ 128 at DP 64 and 64 at DP 128, so that the
//   consumers' live registers (S^T and dP^T, BQ / 2 floats each; dK and
//   dV, DP / 2 each) stay at 192 floats. The launch geometry (tiles,
//   grid, tensor maps) comes from ops/flash.py `bwd_geometry`.
//
// The fused route, float32: flash_bwd_kv_kernel<float, D, true>, the
// CUDA-core kernel (wgmma has no f32 inputs, and TF32 would not hold the
// f32 gradient tolerance): one CTA per (b, kv head, 64-key tile), dk and
// dv of the tile in registers while it loops over the q tiles from the
// causal diagonal down; each q tile's dq contribution goes to the same
// workspace, one slot per 64-key tile, for the same sum kernel.
//
// The split route, bfloat16 (the long-sequence path): no workspace, no
// atomics; each gradient is written once, so dq, dk and dv repeat bit for
// bit. Both kernels are built from the blocks of the fused kernel and the
// forward (hopper.cuh):
//   * flash_bwd_dkv_wgmma_kernel<DP> is the fused kernel without dq: the
//     same device body (bwd_kv_body<DP, kDq = false>), so the same CTA per
//     (kv head, batch, 128-key tile), the same Q / dO / LSE / delta ring
//     and geometry, and the four products S^T, dP^T, dV += P^T dO and
//     dK += dS^T Q; no dS store, no named barrier, no dQ product and no
//     workspace, and the shared-memory layout drops the two dS buffers;
//   * flash_bwd_dq_wgmma_kernel<DP> has the forward's structure with a
//     known LSE: one CTA of three warpgroups per (128-row q tile, head,
//     batch), the longest causal walks first. The producer loads Q and dO
//     once by TMA and keeps a two-stage ring of K / V tiles of BK = 8192 /
//     DP keys; each consumer owns 64 q rows and, per K / V tile, runs
//     S = Q K^T and dP = dO V^T (both operands K-major, as the forward's
//     S), P = exp2(S scale log2(e) - lse log2(e)) masked as the reference
//     masks, dS = P (dP - delta) scale rounded to bf16 into the register
//     layout of wgmma's A operand (as the forward's P), and dQ += dS K with
//     K read MN-major through the transpose bit (as the forward's V). The
//     walk stops at the reference's `upper`; there is no online max and no
//     rescaling. Each thread's two rows of LSE and delta are read once from
//     the [b, h, sq] arrays. BK = 8192 / DP keeps a consumer's live
//     accumulators (S and dP, BK / 2 floats each; dQ, DP / 2) at 160
//     floats at DP 64 and 128 at DP 128.
//   The launch geometry of both comes from ops/flash.py `bwd_geometry`
//   (route "kv", the fused route's, and route "dq").
//
// The split route, float32 (the CUDA-core design): flash_bwd_dq_kernel
// runs one CTA per (b, head, 64-row q tile) looping over the k tiles up to
// the diagonal; flash_bwd_kv_kernel<float, D, false> one CTA per (b, kv
// head, 64-key tile) looping over the q tiles from the diagonal down. Each
// recomputes s and p, as the TPU's split kernels do. Tiles are staged
// through shared memory as f32 with 16-byte loads, rows padded to d + 1
// floats against bank conflicts; each of the 256 threads owns a 4 x 4
// patch of the score tile and a 4 x (d/16) patch of each accumulator; any
// batch/head/sequence strides with a unit-stride head dim, so "bshd" and
// "bhsd" run without a transpose.

#include <math.h>

#include "hopper.cuh"   // TMA, mbarrier, wgmma, tensor-map encoding

namespace {

// ======================================================= CUDA-core kernels

constexpr int kB = 64;          // q and k tile rows
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 score patch each
constexpr int kSP = kB + 1;     // padded row stride of the p / ds tiles

// The CUDA-core kernels run the float32 routes only (T = float); the
// conversions keep the TPU kernels' astype before each product explicit.
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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
  void* dq;             // T (split dq kernel)
  void* dk;
  void* dv;
  float* dq_ws;         // fused: [n_k_tiles, b, h, sq, d] f32 workspace
  int64_t ws_slot;      // elements of one workspace slot, b * h * sq * d
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
// over the kv head's group of query heads; with kFused (float32 only),
// also each q tile's dq contribution, f32, into workspace slot kt for
// flash_bwd_dq_sum_kernel.
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
        float* dqb = a.dq_ws + kt * a.ws_slot +
                     ((int64_t)bi * a.h + hi) * a.sq * D;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = q0 + ty + 16 * i;
          if (r >= a.sq) continue;
#pragma unroll
          for (int j = 0; j < kDJ; ++j) dqb[r * D + tx + 16 * j] = dq[i][j];
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

// ============================================ bfloat16, fused and dk/dv

constexpr int kBwdBK = 128;       // keys of a CTA, 64 a consumer
constexpr int kBwdStages = 2;     // Q / dO (and dq kernel: K / V) ring depth
constexpr int kBwdThreads = 384;  // producer + two consumer warpgroups

// Shared memory of bwd_kv_body; kDq (the fused kernel) adds two dS buffers.
template <int DP, bool kDq>
struct BwdLayout {
  static constexpr int kBQ = 8192 / DP;             // q rows of a tile
  static constexpr int kPanels = DP / kPanelCols;
  static constexpr int kPanelK = kBwdBK * 128;      // bytes of a K/V panel
  static constexpr int kPanelQ = kBQ * 128;         // bytes of a Q/dO panel
  static constexpr int kPanelDS = kBwdBK * 128;     // 128 keys x 64 q rows
  static constexpr int kKBytes = kPanels * kPanelK;         // K or V
  static constexpr int kQBytes = kPanels * kPanelQ;         // Q or dO, 1 stage
  static constexpr int kDSBytes = (kBQ / 64) * kPanelDS;    // one dS buffer
  static constexpr int kRowBytes = 2 * kBQ * 4;             // LSE, delta
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKBytes;
  static constexpr int kQ = kV + kKBytes;
  static constexpr int kDO = kQ + kBwdStages * kQBytes;
  static constexpr int kDS = kDO + kBwdStages * kQBytes;
  static constexpr int kRows = kDS + (kDq ? 2 * kDSBytes : 0);
  static constexpr int kBars = kRows + kBwdStages * kRowBytes;
  // full[s], empty[s], then the K/V barrier; 1024 bytes of slack to
  // align the tiles to the 128-byte swizzle's 1024-byte period.
  static constexpr int kSmem = kBars + 8 * (2 * kBwdStages + 1) + 1024;
};

// One CTA per (kv head, batch, 128-key tile); see the note at the top.
// rows: [b, h, nq, 2, BQ] f32, each q tile's LSE then delta, zero past
// sq. With kDq (the fused kernel), dq_ws: [n_k_tiles, b, h, sq, d] f32,
// slot kt written for every q tile this CTA visits; without (the split
// dk/dv kernel) dq_ws and ws_slot are not read.
template <int DP, bool kDq>
__device__ __forceinline__ void bwd_kv_body(
    const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_do, const float* __restrict__ rows,
    float* __restrict__ dq_ws, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int h, int group, int sq, int sk, int d,
    int nq, int64_t ws_slot, int64_t dk_sb, int64_t dk_sh, int64_t dk_ss,
    int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, int causal, float scale) {
  using L = BwdLayout<DP, kDq>;
  constexpr int BQ = L::kBQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // generic pointer
  const uint32_t sK = base + L::kK, sV = base + L::kV, sQ = base + L::kQ;
  const uint32_t sDO = base + L::kDO;
  [[maybe_unused]] const uint32_t sDS = base + L::kDS;
  const uint32_t sRows = base + L::kRows;
  const uint32_t bar_full = base + L::kBars;
  const uint32_t bar_empty = bar_full + 8 * kBwdStages;
  const uint32_t bar_kv = bar_empty + 8 * kBwdStages;

  const int kvh = blockIdx.x, bi = blockIdx.y, kt = blockIdx.z;
  const int k0 = kt * kBwdBK;
  const int q_first = causal ? k0 / BQ : 0;   // the reference's `lower`
  const int walk = max(nq - q_first, 0);      // q tiles per query head
  const int n_iter = group * walk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);   // one arrival per consumer
    }
    mbar_init(bar_kv, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread loads K and V once, then keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_kv, 2 * L::kKBytes);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load(sK + p * L::kPanelK, &tm_k, bar_kv, p * kPanelCols, kvh, k0,
                 bi);
        tma_load(sV + p * L::kPanelK, &tm_v, bar_kv, p * kPanelCols, kvh, k0,
                 bi);
      }
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kBwdStages;
        const int hi = kvh * group + it / walk;
        const int qt = q_first + it % walk;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((it / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kQBytes + L::kRowBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          const uint32_t off = s * L::kQBytes + p * L::kPanelQ;
          tma_load(sQ + off, &tm_q, full, p * kPanelCols, hi, qt * BQ, bi);
          tma_load(sDO + off, &tm_do, full, p * kPanelCols, hi, qt * BQ, bi);
        }
        bulk_load(sRows + s * L::kRowBytes,
                  rows + (((int64_t)bi * h + hi) * nq + qt) * 2 * BQ,
                  L::kRowBytes, full);
      }
    }
  } else {
    // Consumers: warpgroup 1 takes keys k0..k0+63, warpgroup 2 the next
    // 64. Accumulator element i of a thread sits at row r0 + 8 * ((i >> 1)
    // & 1) and column 8 * (i >> 2) + c2 + (i & 1).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int w = wg - 1;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4;
    const int c2 = 2 * (lane % 4);
    const int key0 = k0 + 64 * w + r0;   // this thread's keys: key0, +8
    const float scale_log2 = scale * kLog2e;
    // This consumer's 64 x 64 block of each tile's dq (fused kernel).
    [[maybe_unused]] const int qpan = BQ == 128 ? w : 0;
    [[maybe_unused]] const int dpan = DP == 128 ? w : 0;
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kBwdStages;
      const int hi = kvh * group + it / walk;
      const int q0 = (q_first + it % walk) * BQ;
      const uint32_t sQs = sQ + s * L::kQBytes, sDOs = sDO + s * L::kQBytes;
      mbar_wait(bar_full + 8 * s, (it / kBwdStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys (A)
      // against the tile's BQ rows (B), both K-major, 16 columns of the
      // head dim a step.
      float st[BQ / 2], dpt[BQ / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t ka = (kk / 4) * L::kPanelK + w * 64 * 128 +
                            (kk % 4) * 32;
        const uint32_t qb = (kk / 4) * L::kPanelQ + (kk % 4) * 32;
        wgmma_ss<0, 0>(st, smem_desc(sK + ka, 16, 1024),
                       smem_desc(sQs + qb, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t ka = (kk / 4) * L::kPanelK + w * 64 * 128 +
                            (kk % 4) * 32;
        const uint32_t qb = (kk / 4) * L::kPanelQ + (kk % 4) * 32;
        wgmma_ss<0, 0>(dpt, smem_desc(sV + ka, 16, 1024),
                       smem_desc(sDOs + qb, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(st);
      pin(dpt);

      // P^T and dS^T, f32, rounded to bf16 in pairs (i, i + 1): the A
      // operand's registers. Masked where the query row is past sq, the
      // key past sk, or (causal) the key after the query row.
      const float* lse_s =
          reinterpret_cast<const float*>(gbase + L::kRows + s * L::kRowBytes);
      const float* dl_s = lse_s + BQ;
      const bool edge = q0 + BQ > sq || k0 + 64 * w + 64 > sk ||
                        (causal && q0 < k0 + 64 * w + 63);
      uint32_t pp[BQ / 4], pds[BQ / 4];
#pragma unroll
      for (int m = 0; m < BQ / 4; ++m) {
        const int col = 8 * (m >> 1) + c2;   // q row of elements 2m, 2m+1
        const int key = key0 + 8 * (m & 1);
        const float2 ls = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 dl = *reinterpret_cast<const float2*>(dl_s + col);
        float pa = exp2f(st[2 * m] * scale_log2 - ls.x * kLog2e);
        float pb = exp2f(st[2 * m + 1] * scale_log2 - ls.y * kLog2e);
        if (edge) {
          const int qa = q0 + col;
          if (qa >= sq || key >= sk || (causal && qa < key)) pa = 0.f;
          if (qa + 1 >= sq || key >= sk || (causal && qa + 1 < key))
            pb = 0.f;
        }
        pp[m] = pack_bf16(pa, pb);
        pds[m] = pack_bf16(pa * (dpt[2 * m] - dl.x) * scale,
                           pb * (dpt[2 * m + 1] - dl.y) * scale);
      }

      if constexpr (kDq) {
        // dS^T to shared memory for dQ = dS K: key rows (this warpgroup's
        // 64 of the buffer's 128), q along the 128-byte rows in BQ / 64
        // panels, the 128-byte swizzle written by hand; two buffers, so
        // one barrier a q tile orders both consumers' writes and reads.
        uint8_t* ds_buf = gbase + L::kDS + (it & 1) * L::kDSBytes;
#pragma unroll
        for (int m = 0; m < BQ / 4; ++m) {
          const int col = 8 * (m >> 1) + c2;
          const int row = 64 * w + r0 + 8 * (m & 1);
          const int chunk = ((col >> 3) & 7) ^ (row & 7);
          *reinterpret_cast<uint32_t*>(ds_buf + (col >> 6) * L::kPanelDS +
                                       row * 128 + chunk * 16 +
                                       (col & 7) * 2) = pds[m];
        }
        fence_proxy_async();
        named_barrier(1, 256);
      }

      // dV += P^T dO and dK += dS^T Q (16 q rows a step, dO and Q MN-major),
      // then (fused) this consumer's dq block = dS K (16 keys a step, dS and
      // K MN-major).
      [[maybe_unused]] float dq_acc[kDq ? 32 : 1];
      pin(dk_acc);
      pin(dv_acc);
      pin(pp);
      pin(pds);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(dv_acc, pp + 4 * kk,
                 smem_desc(sDOs + kk * 16 * 128, L::kPanelQ, 1024));
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs(dk_acc, pds + 4 * kk,
                 smem_desc(sQs + kk * 16 * 128, L::kPanelQ, 1024));
      if constexpr (kDq) {
        const uint32_t sDSb =
            sDS + (it & 1) * L::kDSBytes + qpan * L::kPanelDS;
#pragma unroll
        for (int kk = 0; kk < kBwdBK / 16; ++kk)
          wgmma_ss<1, 1>(dq_acc,
                         smem_desc(sDSb + kk * 16 * 128, L::kPanelDS, 1024),
                         smem_desc(sK + dpan * L::kPanelK + kk * 16 * 128,
                                   L::kPanelK, 1024),
                         kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(dk_acc);
      pin(dv_acc);
      if (t == 0) mbar_arrive(bar_empty + 8 * s);   // this stage is read

      if constexpr (kDq) {
        pin(dq_acc);
        // The tile's dq block, f32, into workspace slot kt.
        const int qrow = q0 + qpan * 64 + r0;
        float* dst = dq_ws + kt * ws_slot + ((int64_t)bi * h + hi) * sq * d;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = dpan * 64 + 8 * j + c2;
          if (col >= d) continue;
          if (qrow < sq)
            *reinterpret_cast<float2*>(dst + (int64_t)qrow * d + col) =
                make_float2(dq_acc[4 * j], dq_acc[4 * j + 1]);
          if (qrow + 8 < sq)
            *reinterpret_cast<float2*>(dst + (int64_t)(qrow + 8) * d + col) =
                make_float2(dq_acc[4 * j + 2], dq_acc[4 * j + 3]);
        }
      }
    }

    __nv_bfloat16* dkb = dk + bi * dk_sb + kvh * dk_sh;
    __nv_bfloat16* dvb = dv + bi * dv_sb + kvh * dv_sh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col >= d) continue;
      if (key0 < sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + key0 * dk_ss + col) =
            __floats2bfloat162_rn(dk_acc[4 * j], dk_acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + key0 * dv_ss + col) =
            __floats2bfloat162_rn(dv_acc[4 * j], dv_acc[4 * j + 1]);
      }
      if (key0 + 8 < sk) {
        *reinterpret_cast<__nv_bfloat162*>(dkb + (key0 + 8) * dk_ss + col) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2], dk_acc[4 * j + 3]);
        *reinterpret_cast<__nv_bfloat162*>(dvb + (key0 + 8) * dv_ss + col) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
  }
}

// The two kernels of bwd_kv_body, each under its own name (the profiler
// and the ptxas report tell them apart by name): the fused route's, and
// the split route's dk/dv kernel.
#define RT_BWD_KV_PARAMS                                                    \
  __grid_constant__ const CUtensorMap tm_q,                                 \
      __grid_constant__ const CUtensorMap tm_k,                             \
      __grid_constant__ const CUtensorMap tm_v,                             \
      __grid_constant__ const CUtensorMap tm_do,                            \
      const float* __restrict__ rows, float* __restrict__ dq_ws,            \
      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int h, \
      int group, int sq, int sk, int d, int nq, int64_t ws_slot,            \
      int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb,           \
      int64_t dv_sh, int64_t dv_ss, int causal, float scale
#define RT_BWD_KV_ARGS                                                      \
  tm_q, tm_k, tm_v, tm_do, rows, dq_ws, dk, dv, h, group, sq, sk, d, nq,    \
      ws_slot, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, causal, scale

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_wgmma_kernel(RT_BWD_KV_PARAMS) {
  bwd_kv_body<DP, true>(RT_BWD_KV_ARGS);
}

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkv_wgmma_kernel(RT_BWD_KV_PARAMS) {
  bwd_kv_body<DP, false>(RT_BWD_KV_ARGS);
}

#undef RT_BWD_KV_PARAMS
#undef RT_BWD_KV_ARGS

// ======================================================= bfloat16, dq

constexpr int kDqBQ = 128;        // q rows of a CTA, 64 a consumer

template <int DP>
struct DqLayout {
  static constexpr int kBK = 8192 / DP;             // keys of a K/V tile
  static constexpr int kPanels = DP / kPanelCols;
  static constexpr int kPanelQ = kDqBQ * 128;       // bytes of a Q/dO panel
  static constexpr int kPanelK = kBK * 128;         // bytes of a K/V panel
  static constexpr int kQBytes = kPanels * kPanelQ;         // Q or dO
  static constexpr int kKBytes = kPanels * kPanelK;         // K or V, 1 stage
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;
  static constexpr int kV = kK + kBwdStages * kKBytes;
  static constexpr int kBars = kV + kBwdStages * kKBytes;
  // full[s], empty[s], then the Q/dO barrier; 1024 bytes of slack to
  // align the tiles to the 128-byte swizzle's 1024-byte period.
  static constexpr int kSmem = kBars + 8 * (2 * kBwdStages + 1) + 1024;
};

// One CTA per (head, batch, 128-row q tile), the q tile walked from the
// last so the longest causal walks start first; see the note at the top.
// lse, delta: [b, h, sq] f32. dq in bf16, written once.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1) flash_bwd_dq_wgmma_kernel(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v,
    __grid_constant__ const CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int group, int sq, int sk, int d, int64_t dq_sb, int64_t dq_sh,
    int64_t dq_ss, int causal, float scale) {
  using L = DqLayout<DP>;
  constexpr int BK = L::kBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sDO = base + L::kDO;
  const uint32_t sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_full = base + L::kBars;
  const uint32_t bar_empty = bar_full + 8 * kBwdStages;
  const uint32_t bar_q = bar_empty + 8 * kBwdStages;

  const int hi = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kDqBQ;   // longest first
  const int nk = (sk + BK - 1) / BK;
  // The reference's `upper`: the key tiles up to the tile's last row.
  const int upper = causal ? min(nk, (q0 + kDqBQ + BK - 1) / BK) : nk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);   // one arrival per consumer
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread loads Q and dO once, then keeps the K/V ring
    // full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      const int kvh = hi / group;
      mbar_expect_tx(bar_q, 2 * L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load(sQ + p * L::kPanelQ, &tm_q, bar_q, p * kPanelCols, hi, q0,
                 bi);
        tma_load(sDO + p * L::kPanelQ, &tm_do, bar_q, p * kPanelCols, hi, q0,
                 bi);
      }
      for (int kt = 0; kt < upper; ++kt) {
        const int s = kt % kBwdStages;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, ((kt / kBwdStages) & 1) ^ 1);
        mbar_expect_tx(full, 2 * L::kKBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          const uint32_t off = s * L::kKBytes + p * L::kPanelK;
          tma_load(sK + off, &tm_k, full, p * kPanelCols, kvh, kt * BK, bi);
          tma_load(sV + off, &tm_v, full, p * kPanelCols, kvh, kt * BK, bi);
        }
      }
    }
  } else {
    // Consumers: warpgroup 1 takes rows 0..63 of the tile, 2 rows 64..127.
    // Accumulator element i of a thread sits at row r0 + 8 * ((i >> 1) & 1)
    // and column 8 * (i >> 2) + c2 + (i & 1).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int row_off = (wg - 1) * 64;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + row_off + 16 * warp + lane / 4;   // and r0 + 8
    const int c2 = 2 * (lane % 4);
    const float scale_log2 = scale * kLog2e;
    // This thread's two rows of LSE (log2 domain) and delta; 0 past sq
    // (those rows are never written).
    const int64_t row_base = ((int64_t)bi * gridDim.x + hi) * sq;
    const float ls0 = r0 < sq ? lse[row_base + r0] * kLog2e : 0.f;
    const float ls1 = r0 + 8 < sq ? lse[row_base + r0 + 8] * kLog2e : 0.f;
    const float dl0 = r0 < sq ? delta[row_base + r0] : 0.f;
    const float dl1 = r0 + 8 < sq ? delta[row_base + r0 + 8] : 0.f;
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < upper; ++kt) {
      const int s = kt % kBwdStages;
      const int k0 = kt * BK;
      const uint32_t sKs = sK + s * L::kKBytes, sVs = sV + s * L::kKBytes;
      mbar_wait(bar_full + 8 * s, (kt / kBwdStages) & 1);

      // S = Q K^T and dP = dO V^T: this warpgroup's 64 rows (A) against
      // the tile's BK keys (B), both K-major, 16 columns of the head dim a
      // step.
      float sc[BK / 2], dpc[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t qa = (kk / 4) * L::kPanelQ + row_off * 128 +
                            (kk % 4) * 32;
        const uint32_t kb = (kk / 4) * L::kPanelK + (kk % 4) * 32;
        wgmma_ss<0, 0>(sc, smem_desc(sQ + qa, 16, 1024),
                       smem_desc(sKs + kb, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t qa = (kk / 4) * L::kPanelQ + row_off * 128 +
                            (kk % 4) * 32;
        const uint32_t kb = (kk / 4) * L::kPanelK + (kk % 4) * 32;
        wgmma_ss<0, 0>(dpc, smem_desc(sDO + qa, 16, 1024),
                       smem_desc(sVs + kb, 16, 1024), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);
      pin(dpc);

      // P and dS, f32; dS rounded to bf16 in pairs (i, i + 1): the A
      // operand's registers. Masked where the key is past sk or (causal)
      // after the query row.
      const bool edge =
          k0 + BK > sk || (causal && k0 + BK - 1 > q0 + row_off);
      uint32_t pds[BK / 4];
#pragma unroll
      for (int m = 0; m < BK / 4; ++m) {
        const int key = k0 + 8 * (m >> 1) + c2;   // of elements 2m, 2m+1
        const int row = r0 + 8 * (m & 1);
        const float ls = (m & 1) ? ls1 : ls0;
        const float dl = (m & 1) ? dl1 : dl0;
        float pa = exp2f(sc[2 * m] * scale_log2 - ls);
        float pb = exp2f(sc[2 * m + 1] * scale_log2 - ls);
        if (edge) {
          if (key >= sk || (causal && key > row)) pa = 0.f;
          if (key + 1 >= sk || (causal && key + 1 > row)) pb = 0.f;
        }
        pds[m] = pack_bf16(pa * (dpc[2 * m] - dl) * scale,
                           pb * (dpc[2 * m + 1] - dl) * scale);
      }

      // dQ += dS K: 16 keys a step; K [keys, DP] is MN-major for this
      // product (rows of 128 bytes, panels of 64 columns kPanelK apart).
      pin(acc);
      pin(pds);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, pds + 4 * kk,
                 smem_desc(sKs + kk * 16 * 128, L::kPanelK, 1024));
      wg_commit();
      wg_wait_all();
      pin(acc);
      if (t == 0) mbar_arrive(bar_empty + 8 * s);   // this stage is read
    }

    __nv_bfloat16* dqb = dq + bi * dq_sb + hi * dq_sh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col >= d) continue;
      if (r0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + r0 * dq_ss + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r0 + 8 < sq)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (r0 + 8) * dq_ss + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// ================================================== the ordered dq sum

constexpr int kSumThreads = 256;

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  u.x = pack_bf16(v.x, v.y);
  u.y = pack_bf16(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// dq = the sum over k tiles kt = 0 .. last visible of ws[kt], in
// increasing kt, in dq's dtype and strides. ws: [n_slots, b, h, sq, d];
// slot kt holds the fused kernel's contribution of key tile kt (block_k
// keys) for every q tile of block_q rows at or below the diagonal, which
// is exactly kt <= (qt * block_q + block_q - 1) / block_k under the causal
// mask. Grid (b * h, row blocks): four consecutive elements of one
// (b, h)'s [sq, d] a thread, indexed in 32 bits.
template <typename T>
__global__ void __launch_bounds__(kSumThreads) flash_bwd_dq_sum_kernel(
    const float* __restrict__ ws, T* __restrict__ dq, int64_t slot,
    int n_slots, int h, int sq, int d, int64_t dq_sb, int64_t dq_sh,
    int64_t dq_ss, int block_q, int block_k, int causal) {
  const int e = (blockIdx.y * kSumThreads + threadIdx.x) * 4;
  if (e >= sq * d) return;
  const int row = e / d, c = e - row * d;
  const int bi = blockIdx.x / h, hi = blockIdx.x - bi * h;
  int last = n_slots - 1;
  if (causal)
    last = min(last, ((row / block_q) * block_q + block_q - 1) / block_k);
  const float* src = ws + (int64_t)blockIdx.x * sq * d + e;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kt = 0; kt <= last; ++kt) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src + kt * slot));
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  store4(dq + bi * dq_sb + hi * dq_sh + row * dq_ss + c, acc);
}

// ------------------------------------------------------------- launch

// The float32 routes' CUDA-core kernels. kind: 0 = fused, 1 = dq, 2 =
// dk/dv.
template <int D>
int launch_simt(int kind, const Args& a, int b, cudaStream_t stream) {
  const int hkv = a.h / a.group;
  const int nq = (a.sq + kB - 1) / kB, nk = (a.sk + kB - 1) / kB;
  if (kind == 1) {
    auto kern = flash_bwd_dq_kernel<float, D>;
    constexpr int smem = (int)sizeof(float) * smem_floats_q<D>();
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3(nq, a.h, b), kThreads, smem, stream>>>(a);
    return (int)cudaGetLastError();
  }
  void (*kern)(Args) = flash_bwd_kv_kernel<float, D, false>;
  if (kind == 0) kern = flash_bwd_kv_kernel<float, D, true>;
  constexpr int smem = (int)sizeof(float) * smem_floats_kv<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(nk, hkv, b), kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_d(int kind, int d, const Args& a, int b, cudaStream_t s) {
  switch (d) {
    case 16: return launch_simt<16>(kind, a, b, s);
    case 32: return launch_simt<32>(kind, a, b, s);
    case 48: return launch_simt<48>(kind, a, b, s);
    case 64: return launch_simt<64>(kind, a, b, s);
    case 80: return launch_simt<80>(kind, a, b, s);
    case 96: return launch_simt<96>(kind, a, b, s);
    case 112: return launch_simt<112>(kind, a, b, s);
    case 128: return launch_simt<128>(kind, a, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, int h, int group, int sq, int sk, const int64_t* st,
               int causal, float scale) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.dk = dk; a.dv = dv; a.dq_ws = nullptr; a.ws_slot = 0;
  Str* strs[7] = {&a.sq_, &a.sk_, &a.sv_, &a.sdo_, &a.sdq_, &a.sdk_, &a.sdv_};
  for (int i = 0; i < 7; ++i) {
    strs[i]->b = st[3 * i];
    strs[i]->h = st[3 * i + 1];
    strs[i]->s = st[3 * i + 2];
  }
  a.h = h; a.group = group; a.sq = sq; a.sk = sk; a.causal = causal;
  a.scale = scale;
  return a;
}

// The geometry array of every route (ops/flash.py `bwd_geometry`), int64:
//   [0:9)   DP, block_q, block_k, grid x, y, z, batch, q tiles, key tiles
//   [9:30)  element strides (batch, head, seq) of q, k, v, do, dq, dk, dv
//   [30:74) for q, k, v, do: dims (d, heads, seq, batch), byte strides
//           (heads, seq, batch), box (d, heads, seq, batch); zeros for f32
constexpr int kBwdGeomLen = 74;
constexpr int kBwdStrideAt = 9;
constexpr int kBwdMapAt = 30;

// The float32 routes' geometry: the CUDA-core kernels' 64 x 64 tiles.
bool simt_geom(int d, const int64_t* g) {
  return g[0] == d && g[1] == kB && g[2] == kB;
}

// The bf16 kernels' geometry at padded head dim dp: tiles (block_q,
// block_k) and maps of one 64-column panel of block_q rows (Q, dO) or
// block_k rows (K, V).
bool wgmma_geom(int d, int dp, int bq, int bk, const int64_t* g) {
  if (d % 16 || d < 16 || d > 128 || g[0] != dp || g[1] != bq || g[2] != bk)
    return false;
  for (int i = 0; i < 4; ++i)
    if (!panel_box(g + kBwdMapAt + i * kMapLen, i == 1 || i == 2 ? bk : bq))
      return false;
  return true;
}

int encode_maps(CUtensorMap (&maps)[4], const void* q, const void* k,
                const void* v, const void* dout, const int64_t* g) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int err = encode_map(&maps[i], ptrs[i], g + kBwdMapAt + i * kMapLen);
    if (err) return err;
  }
  return 0;
}

// flash_bwd_wgmma_kernel (kDq, the fused route) or
// flash_bwd_dkv_wgmma_kernel (the split route; ws is not read).
template <int DP, bool kDq>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* rows, float* ws, void* dk,
                 void* dv, int h, int group, int sq, int sk, int d,
                 const int64_t* g, int causal, float scale,
                 cudaStream_t stream) {
  CUtensorMap maps[4];
  const int enc = encode_maps(maps, q, k, v, dout, g);
  if (enc) return enc;
  auto kern = flash_bwd_wgmma_kernel<DP>;
  if constexpr (!kDq) kern = flash_bwd_dkv_wgmma_kernel<DP>;
  constexpr int smem = BwdLayout<DP, kDq>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t* st = g + kBwdStrideAt;
  const int64_t slot = kDq ? g[6] * h * (int64_t)sq * d : 0;
  dim3 grid((unsigned)g[3], (unsigned)g[4], (unsigned)g[5]);
  kern<<<grid, kBwdThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], rows, ws,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), h,
      group, sq, sk, d, (int)g[7], slot, st[15], st[16], st[17], st[18],
      st[19], st[20], causal, scale);
  return (int)cudaGetLastError();
}

template <bool kDq>
int launch_kv_bf16(int d, const void* q, const void* k, const void* v,
                   const void* dout, const float* rows, float* ws, void* dk,
                   void* dv, int h, int group, int sq, int sk,
                   const int64_t* g, int causal, float scale,
                   cudaStream_t s) {
  const int dp = d <= 64 ? 64 : 128;
  if (!wgmma_geom(d, dp, 8192 / dp, kBwdBK, g) || rows == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dp == 64)
    return launch_wgmma<64, kDq>(q, k, v, dout, rows, ws, dk, dv, h, group,
                                 sq, sk, d, g, causal, scale, s);
  return launch_wgmma<128, kDq>(q, k, v, dout, rows, ws, dk, dv, h, group,
                                sq, sk, d, g, causal, scale, s);
}

template <int DP>
int launch_dq_wgmma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int group, int sq, int sk, int d,
                    const int64_t* g, int causal, float scale,
                    cudaStream_t stream) {
  CUtensorMap maps[4];
  const int enc = encode_maps(maps, q, k, v, dout, g);
  if (enc) return enc;
  auto kern = flash_bwd_dq_wgmma_kernel<DP>;
  constexpr int smem = DqLayout<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t* st = g + kBwdStrideAt;
  dim3 grid((unsigned)g[3], (unsigned)g[4], (unsigned)g[5]);
  kern<<<grid, kBwdThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta,
      static_cast<__nv_bfloat16*>(dq), group, sq, sk, d, st[12], st[13],
      st[14], causal, scale);
  return (int)cudaGetLastError();
}

int launch_dq_bf16(int d, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int group, int sq, int sk, const int64_t* g,
                   int causal, float scale, cudaStream_t s) {
  const int dp = d <= 64 ? 64 : 128;
  if (!wgmma_geom(d, dp, kDqBQ, 8192 / dp, g))
    return (int)cudaErrorInvalidValue;
  if (dp == 64)
    return launch_dq_wgmma<64>(q, k, v, dout, lse, delta, dq, group, sq, sk,
                               d, g, causal, scale, s);
  return launch_dq_wgmma<128>(q, k, v, dout, lse, delta, dq, group, sq, sk,
                              d, g, causal, scale, s);
}

int launch_dq_sum(int dtype, const float* ws, void* dq, int h, int sq, int d,
                  const int64_t* g, int causal, cudaStream_t s) {
  const int64_t* st = g + kBwdStrideAt;
  const int64_t slot = g[6] * h * (int64_t)sq * d;
  const dim3 blocks((unsigned)(g[6] * h),
                    (sq * d / 4 + kSumThreads - 1) / kSumThreads);
  const int n_slots = (int)g[8], bq = (int)g[1], bk = (int)g[2];
  if (dtype == 0)
    flash_bwd_dq_sum_kernel<float><<<blocks, kSumThreads, 0, s>>>(
        ws, static_cast<float*>(dq), slot, n_slots, h, sq, d, st[12], st[13],
        st[14], bq, bk, causal);
  else
    flash_bwd_dq_sum_kernel<__nv_bfloat16><<<blocks, kSumThreads, 0, s>>>(
        ws, static_cast<__nv_bfloat16*>(dq), slot, n_slots, h, sq, d, st[12],
        st[13], st[14], bq, bk, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Common arguments: dtype 0 = float32, 1 = bfloat16; d in {16, 32, ...,
// 128}; q and dout [.., sq, h, ..], k and v [.., sk, h / group, ..] in
// any batch/head/sequence strides with a unit-stride head dim; lse and
// delta [b, h, sq] float32; geom: the kBwdGeomLen values of ops/flash.py
// `bwd_geometry` for the entry point's route. Each returns 0 when
// launched, else a cudaError_t, or kEncodeError plus the CUresult of a
// tensor map that failed to encode (flash_bwd_error_string).

// Fused: dq, dk and dv in the input dtype. dq_ws: the [slots, b, h, sq,
// d] f32 workspace (every slot that is read is written first); rows (bf16
// only): [b, h, q tiles, 2, block_q] f32, each q tile's LSE then delta,
// zero past sq. Launches the route's kernel, then the ordered dq sum.
int flash_bwd_fused_launch(int dtype, int d, const void* q, const void* k,
                           const void* v, const void* dout, const float* lse,
                           const float* delta, const float* rows,
                           float* dq_ws, void* dq, void* dk, void* dv, int h,
                           int group, int sq, int sk, const int64_t* geom,
                           int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    if (!simt_geom(d, geom)) return (int)cudaErrorInvalidValue;
    Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, h, group,
                       sq, sk, geom + kBwdStrideAt, causal, scale);
    a.dq_ws = dq_ws;
    a.ws_slot = geom[6] * h * (int64_t)sq * d;
    err = launch_d(0, d, a, (int)geom[6], s);
  } else if (dtype == 1) {
    err = launch_kv_bf16<true>(d, q, k, v, dout, rows, dq_ws, dk, dv, h,
                               group, sq, sk, geom, causal, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return launch_dq_sum(dtype, dq_ws, dq, h, sq, d, geom, causal, s);
}

// Split, dq only (input dtype): geom of route "dq". bf16:
// flash_bwd_dq_wgmma_kernel; f32: the CUDA-core flash_bwd_dq_kernel.
int flash_bwd_dq_launch(int dtype, int d, const void* q, const void* k,
                        const void* v, const void* dout, const float* lse,
                        const float* delta, void* dq, int h, int group,
                        int sq, int sk, const int64_t* geom, int causal,
                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_dq_bf16(d, q, k, v, dout, lse, delta, dq, group, sq, sk,
                          geom, causal, scale, s);
  if (dtype != 0 || !simt_geom(d, geom)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                           h, group, sq, sk, geom + kBwdStrideAt, causal,
                           scale);
  return launch_d(1, d, a, (int)geom[6], s);
}

// Split, dk and dv only (input dtype): geom of route "kv" (the fused
// route's). bf16: flash_bwd_dkv_wgmma_kernel, reading rows as the fused
// route does; f32: the CUDA-core flash_bwd_kv_kernel (rows unused).
int flash_bwd_dkv_launch(int dtype, int d, const void* q, const void* k,
                         const void* v, const void* dout, const float* lse,
                         const float* delta, const float* rows, void* dk,
                         void* dv, int h, int group, int sq, int sk,
                         const int64_t* geom, int causal, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_kv_bf16<false>(d, q, k, v, dout, rows, nullptr, dk, dv, h,
                                 group, sq, sk, geom, causal, scale, s);
  if (dtype != 0 || !simt_geom(d, geom)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, h,
                           group, sq, sk, geom + kBwdStrideAt, causal, scale);
  return launch_d(2, d, a, (int)geom[6], s);
}

int flash_bwd_geom_len() { return kBwdGeomLen; }

// Dynamic shared memory of the bf16 fused kernel at padded head dim dp
// (64 or 128).
int flash_bwd_smem_bytes(int dp) {
  return dp <= 64 ? BwdLayout<64, true>::kSmem : BwdLayout<128, true>::kSmem;
}

// Dynamic shared memory of a bf16 split kernel at padded head dim dp:
// kind 1 the dq kernel, 2 the dk/dv kernel.
int flash_bwd_split_smem_bytes(int kind, int dp) {
  if (kind == 1)
    return dp <= 64 ? DqLayout<64>::kSmem : DqLayout<128>::kSmem;
  return dp <= 64 ? BwdLayout<64, false>::kSmem
                  : BwdLayout<128, false>::kSmem;
}

const char* flash_bwd_error_string(int err) { return error_text(err); }

}  // extern "C"
