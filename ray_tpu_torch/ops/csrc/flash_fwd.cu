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
// Two kernels, chosen by dtype:
//
// bfloat16: flash_fwd_wgmma_kernel<DP>, the Hopper design.
//   What bounds it on the H100: at the training shape (b 8, s 1023,
//   h 12, d 64, causal) the work is ~12.9 GFLOP on ~50 MB, ~13 us on
//   the bf16 tensor cores and ~15 us of HBM; at the serving shape (b 1,
//   s 1024) the grid is under one wave, so the longest causal q tile's
//   walk over its key tiles sets the time. Both need the tensor cores
//   and key tiles that arrive while the previous one is in the math.
//   The design:
//   * one CTA of three warpgroups per (128-row q tile, head, batch), the
//     q tiles with the longest causal walk issued first (the q tile is
//     the grid's slowest axis, reversed);
//   * warpgroup 0 is the producer: one thread issues TMA loads of the
//     Q tile (once) and of K/V tiles of 128 keys into a two-stage ring
//     in shared memory, each stage guarded by a "full" mbarrier (TMA
//     transaction bytes) and an "empty" one (one arrival per consumer);
//     setmaxnreg moves its registers to the consumers;
//   * warpgroups 1 and 2 each own 64 query rows: S = Q·Kᵀ by
//     wgmma m64n128k16 with both operands in shared memory, the online
//     softmax in registers (a row lives in a quad of threads: two
//     shuffles for its max), p rounded to bf16 in registers and fed as
//     the A operand of O += P·V (wgmma m64n{DP}k16, V MN-major through
//     the transpose bit, no shuffle through shared memory), O rescaled
//     in registers;
//   * the tensor maps are 4-D (d, heads, seq, batch) with the tensors'
//     own byte strides, so "bshd" and "bhsd" both load without a
//     transpose; the box is 64 columns (128 bytes, 128-byte swizzle, the
//     layout wgmma reads), so the head dim is padded in shared memory to
//     DP = 64 (d <= 64) or 128 (d <= 128) and TMA fills the padding and
//     rows past sq/sk with zeros; the masking still treats keys past sk
//     as absent;
//   * the exponentials are exp2 of scores pre-scaled by scale·log2(e);
//     the LSE is converted back to the natural log: m·ln 2 + log(l).
//   The launch geometry (DP, tiles, grid, each tensor map's dims, byte
//   strides and box) comes from ops/flash.py `fwd_geometry`; the maps
//   are encoded on the host by hopper.cuh's encode_map
//   (cuTensorMapEncodeTiled, obtained through cudaGetDriverEntryPoint so
//   the library does not link libcuda). The TMA, mbarrier and wgmma
//   helpers are hopper.cuh's, shared with the backward.
//
// float32: flash_fwd_kernel<float, D>, the CUDA-core kernel (wgmma has
//   no f32 inputs, and TF32 would not hold the f32 tolerances). One CTA
//   (256 threads) per (b, h, 64-row q tile), K/V staged through shared
//   memory in 64-key tiles as f32 with 16-byte loads, each thread a
//   4 x 4 patch of the score tile and a 4 x (d/16) patch of the output
//   accumulator in registers, rows padded to d + 1 floats against bank
//   conflicts, causal tiles issued longest first. Bound by the CUDA
//   cores' f32 FMA rate (67 TFLOP/s at best), far below the tensor
//   cores.

#include <math.h>

#include "hopper.cuh"   // TMA, mbarrier, wgmma, tensor-map encoding

namespace {

constexpr float kNegInf = -1e9f;

// ============================================================ float32

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 score patch each

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

constexpr int simt_smem_bytes(int d) {
  return (int)sizeof(float) *
         (kBQ * (d + 1) + kBK * (d + 1) + kBK * d + kBQ * (kBK + 1) + 3 * kBQ);
}


// ============================================================ bfloat16

constexpr int kWgBQ = 128;        // query rows of a CTA (2 x 64)
constexpr int kWgBK = 128;        // keys of a K/V tile
constexpr int kWgStages = 2;      // K/V ring depth
constexpr int kWgThreads = 384;   // producer + two consumer warpgroups

template <int DP>
struct WgLayout {
  static constexpr int kPanels = DP / kPanelCols;
  static constexpr int kPanelQ = kWgBQ * 128;     // bytes of a Q panel
  static constexpr int kPanelKV = kWgBK * 128;    // bytes of a K/V panel
  static constexpr int kQBytes = kPanels * kPanelQ;
  static constexpr int kKVBytes = kPanels * kPanelKV;   // K or V, 1 stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kWgStages * kKVBytes;
  static constexpr int kBars = kV + kWgStages * kKVBytes;
  // full[s], empty[s], then the Q barrier; 1024 bytes of slack to align
  // the tiles to the 128-byte swizzle's 1024-byte period.
  static constexpr int kSmem = kBars + 8 * (2 * kWgStages + 1) + 1024;
};

// Scores of one K/V tile in the log2 domain, masked where a key is past
// sk or (causal) after the query row; the running row maxima of the
// thread's two rows. Accumulator element i of a thread sits at row
// r0 + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + c2 + (i & 1).
template <bool kMask>
__device__ __forceinline__ void scale_mask(float (&s)[64], float scale_log2,
                                           int k0, int c2, int r0, int sk,
                                           int causal, float& mx0,
                                           float& mx1) {
  constexpr float kMaskLog2 = kNegInf * kLog2e;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = s[i] * scale_log2;
    if (kMask) {
      const int col = k0 + 8 * (i >> 2) + c2 + (i & 1);
      const int row = r0 + 8 * ((i >> 1) & 1);
      if (col >= sk || (causal && col > row)) x = kMaskLog2;
    }
    s[i] = x;
    if ((i >> 1) & 1)
      mx1 = fmaxf(mx1, x);
    else
      mx0 = fmaxf(mx0, x);
  }
}

template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma_kernel(
    __grid_constant__ const CUtensorMap tm_q,
    __grid_constant__ const CUtensorMap tm_k,
    __grid_constant__ const CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int group, int sq, int sk, int d, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, int causal, float scale_log2) {
  using L = WgLayout<DP>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar_full = base + L::kBars;
  const uint32_t bar_empty = bar_full + 8 * kWgStages;
  const uint32_t bar_q = bar_empty + 8 * kWgStages;

  const int hi = blockIdx.x, bi = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWgBQ;   // longest first
  const int nk = (sk + kWgBK - 1) / kWgBK;
  const int upper =
      causal ? min(nk, (q0 + kWgBQ + kWgBK - 1) / kWgBK) : nk;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2);   // one arrival per consumer
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      const int kvh = hi / group;
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(sQ + p * L::kPanelQ, &tm_q, bar_q, p * kPanelCols, hi, q0,
                 bi);
      for (int kt = 0; kt < upper; ++kt) {
        const int s = kt % kWgStages;
        mbar_wait(bar_empty + 8 * s, ((kt / kWgStages) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * L::kKVBytes);
        for (int p = 0; p < L::kPanels; ++p) {
          const uint32_t off = s * L::kKVBytes + p * L::kPanelKV;
          tma_load(sK + off, &tm_k, bar_full + 8 * s, p * kPanelCols, kvh,
                   kt * kWgBK, bi);
          tma_load(sV + off, &tm_v, bar_full + 8 * s, p * kPanelCols, kvh,
                   kt * kWgBK, bi);
        }
      }
    }
  } else {
    // Consumers: warpgroup 1 takes rows 0..63 of the tile, 2 rows 64..127.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int row_off = (wg - 1) * 64;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + row_off + 16 * warp + lane / 4;   // and r0 + 8
    const int c2 = 2 * (lane % 4);
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    mbar_wait(bar_q, 0);
    for (int kt = 0; kt < upper; ++kt) {
      const int s = kt % kWgStages;
      const int k0 = kt * kWgBK;
      mbar_wait(bar_full + 8 * s, (kt / kWgStages) & 1);

      // S = Q Kᵀ: K-major A (this warpgroup's 64 rows of Q) and B (the
      // 128 keys), 16 columns of the head dim a step.
      float sc[64];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da = smem_desc(
            sQ + (kk / 4) * L::kPanelQ + row_off * 128 + col, 16, 1024);
        const uint64_t db = smem_desc(
            sK + s * L::kKVBytes + (kk / 4) * L::kPanelKV + col, 16, 1024);
        wgmma_ss<0, 0>(sc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(sc);

      float mx0 = -INFINITY, mx1 = -INFINITY;
      const bool edge = k0 + kWgBK > sk ||
                        (causal && k0 + kWgBK - 1 > q0 + row_off);
      if (edge)
        scale_mask<true>(sc, scale_log2, k0, c2, r0, sk, causal, mx0, mx1);
      else
        scale_mask<false>(sc, scale_log2, k0, c2, r0, sk, causal, mx0, mx1);
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // p = exp(s - m) in f32 for the row sums, rounded to bf16 for PV;
      // the pairs (i, i + 1) pack into the A operand's registers.
      uint32_t pk[32];
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const bool hi_row = (i >> 1) & 1;
        const float m = hi_row ? mn1 : mn0;
        const float pa = exp2f(sc[i] - m), pb = exp2f(sc[i + 1] - m);
        if (hi_row)
          ls1 += pa + pb;
        else
          ls0 += pa + pb;
        pk[i / 2] = pack_bf16(pa, pb);
      }
      l0 = l0 * corr0 + ls0;   // per-thread partial sums, reduced at the end
      l1 = l1 * corr1 + ls1;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= ((i >> 1) & 1) ? corr1 : corr0;

      // O += P V: 16 keys a step; V [keys, DP] is MN-major for this
      // product (rows of 128 bytes, panels of 64 columns kPanelKV apart).
      pin(acc);
      pin(pk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgBK / 16; ++kk) {
        const uint64_t db = smem_desc(sV + s * L::kKVBytes + kk * 16 * 128,
                                      L::kPanelKV, 1024);
        wgmma_rs(acc, pk + 4 * kk, db);
      }
      wg_commit();
      wg_wait_all();
      pin(acc);
      if (t == 0) mbar_arrive(bar_empty + 8 * s);   // this stage is read
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* ob = o + bi * o_sb + hi * o_sh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + c2;
      if (col >= d) continue;
      if (r0 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + r0 * o_ss + col) =
            __floats2bfloat162_rn(acc[4 * j] / lc0, acc[4 * j + 1] / lc0);
      if (r0 + 8 < sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (r0 + 8) * o_ss + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / lc1, acc[4 * j + 3] / lc1);
    }
    if (lse != nullptr && lane % 4 == 0) {
      // Row logsumexp, [b, h, sq] f32, in the natural log.
      float* lrow = lse + ((int64_t)bi * gridDim.x + hi) * sq;
      if (r0 < sq) lrow[r0] = m0 * kLn2 + logf(lc0);
      if (r0 + 8 < sq) lrow[r0 + 8] = m1 * kLn2 + logf(lc1);
    }
  }
}

// ------------------------------------------------------------- launch

// The geometry array from ops/flash.py `fwd_geometry` (int64):
//   [0:6)   DP, block_q, block_k, grid x, y, z
//   [6:18)  element strides (batch, head, seq) of q, k, v, out
//   [18:51) for q, k, v: dims (d, heads, seq, batch), byte strides
//           (heads, seq, batch), box (d, heads, seq, batch)
constexpr int kGeomLen = 51;
constexpr int kMapAt = 18;

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int group, int sq, int sk, int d,
                 const int64_t* g, int causal, float scale,
                 cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = encode_map(&maps[i], ptrs[i], g + kMapAt + i * kMapLen);
    if (err) return err;
  }
  auto kern = flash_fwd_wgmma_kernel<DP>;
  constexpr int smem = WgLayout<DP>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)g[3], (unsigned)g[4], (unsigned)g[5]);
  kern<<<grid, kWgThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), lse, group,
      sq, sk, d, g[15], g[16], g[17], causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int group, int sq, int sk, const int64_t* g,
                int causal, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<float, D>;
  constexpr int smem = simt_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t* st = g + 6;
  dim3 grid((unsigned)g[3], (unsigned)g[4], (unsigned)g[5]);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, group, sq,
      sk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, scale);
  return (int)cudaGetLastError();
}

int launch_f32(int d, const void* q, const void* k, const void* v, void* o,
               float* lse, int group, int sq, int sk, const int64_t* g,
               int causal, float scale, cudaStream_t s) {
  if (g[0] != d || g[1] != kBQ || g[2] != kBK)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch_simt<16>(q, k, v, o, lse, group, sq, sk, g, causal, scale, s);
    case 32: return launch_simt<32>(q, k, v, o, lse, group, sq, sk, g, causal, scale, s);
    case 48: return launch_simt<48>(q, k, v, o, lse, group, sq, sk, g, causal, scale, s);
    case 64: return launch_simt<64>(q, k, v, o, lse, group, sq, sk, g, causal, scale, s);
    case 80: return launch_simt<80>(q, k, v, o, lse, group, sq, sk, g, causal, scale, s);
    case 96: return launch_simt<96>(q, k, v, o, lse, group, sq, sk, g, causal, scale, s);
    case 112: return launch_simt<112>(q, k, v, o, lse, group, sq, sk, g, causal, scale, s);
    case 128: return launch_simt<128>(q, k, v, o, lse, group, sq, sk, g, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_bf16(int d, const void* q, const void* k, const void* v, void* o,
                float* lse, int group, int sq, int sk, const int64_t* g,
                int causal, float scale, cudaStream_t s) {
  if (d % 16 || d < 16 || d > 128 || g[0] != (d <= 64 ? 64 : 128) ||
      g[1] != kWgBQ || g[2] != kWgBK)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (!panel_box(g + kMapAt + i * kMapLen, i == 0 ? kWgBQ : kWgBK))
      return (int)cudaErrorInvalidValue;
  if (g[0] == 64)
    return launch_wgmma<64>(q, k, v, o, lse, group, sq, sk, d, g, causal,
                            scale, s);
  return launch_wgmma<128>(q, k, v, o, lse, group, sq, sk, d, g, causal,
                           scale, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; d in {16, 32, ..., 128}; lse, when
// not null, is a [b, h, sq] float32 buffer; geom is the int64 array of
// ops/flash.py `fwd_geometry` (kGeomLen values; the grid covers b and h).
// Returns 0 when launched, else a cudaError_t, or kEncodeError plus the
// CUresult of a tensor map that failed to encode.
int flash_fwd_lse_launch(int dtype, int d, const void* q, const void* k,
                         const void* v, void* o, float* lse, int group,
                         int sq, int sk, const int64_t* geom, int causal,
                         float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(d, q, k, v, o, lse, group, sq, sk, geom, causal, scale,
                      s);
  if (dtype == 1)
    return launch_bf16(d, q, k, v, o, lse, group, sq, sk, geom, causal,
                       scale, s);
  return (int)cudaErrorInvalidValue;
}

// The primal path: no LSE.
int flash_fwd_launch(int dtype, int d, const void* q, const void* k,
                     const void* v, void* o, int group, int sq, int sk,
                     const int64_t* geom, int causal, float scale,
                     void* stream) {
  return flash_fwd_lse_launch(dtype, d, q, k, v, o, nullptr, group, sq, sk,
                              geom, causal, scale, stream);
}

int flash_fwd_geom_len() { return kGeomLen; }

// Dynamic shared memory of a launch: the f32 kernel's at head dim d, or
// the bf16 kernel's at padded head dim d (64 or 128).
int flash_fwd_smem_bytes(int dtype, int d) {
  if (dtype == 1) return d <= 64 ? WgLayout<64>::kSmem : WgLayout<128>::kSmem;
  return simt_smem_bytes(d);
}

const char* flash_fwd_error_string(int err) { return error_text(err); }

}  // extern "C"
