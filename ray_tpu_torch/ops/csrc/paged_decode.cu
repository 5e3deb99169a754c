// Paged decode / verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel ray_tpu/ops/pallas/paged_decode.py
// `_decode_kernel` (built by `_make_decode_call`, one pallas_call for
// both q_len 1 decode and q_len > 1 speculative verify).
//
// What it computes: for each (sequence b, kv head h), online-softmax
// attention of rows = q_len * group query rows over the sequence's K/V,
// gathered block by block through block_tables[b, :]. Row r is query
// token r / group; its last visible key is
//     bound_r = min(ctx, ctx - q_lens[b] + 1 + r / group)
// (write-then-attend: the current tokens are already in their slots).
// Padded table slots name block 0, the pool's reserved scratch block;
// keys at or past the bound score NEG_INF and contribute exactly 0.
// Scores and the softmax statistics are f32; p is rounded to the value
// dtype before PV (the TPU kernel's p.astype(v.dtype)); the output is
// in q's dtype.
//
// What bounds it on the H100: bytes. Each (b, h) reads ctx * d K and V
// values once and does 4 * rows * d flops per key, far below the ~295
// flop/byte the card needs before compute limits (decode has rows = 1).
// The design therefore only tries to read each K/V byte once, with
// 16-byte loads:
//   * one CTA per (b, kv_head); the CTA reads its own table entries
//     (the TPU's scalar prefetch has no counterpart to need);
//   * an in-CTA loop over the sequence's blocks replaces the TPU's
//     sequential grid axis, and stops at ceil(ctx / block_size) instead
//     of walking all max_nb slots (masked keys would add exp(NEG_INF -
//     m) = 0 exactly, so the result is the same);
//   * K/V of a tile of blocks (~64 keys) is staged through shared
//     memory as f32, K rows padded to d + 1 floats so the score loop is
//     free of bank conflicts.
// Known limit, left for later: at GPT-2-small with max_batch 8 the grid
// is 8 * 12 = 96 CTAs on 132 SMs, and a long context is walked by one
// CTA. Splitting the context across CTAs (a second reduction pass) is
// the first thing to do to make it faster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kThreads = 128;

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

// q/out: [b, hkv, rows, d]; pools: [hkv, num_blocks, block_size, d];
// tables: [b, max_nb] int32; lens, qlens: [b] int32.
// Grid (hkv, b); kThreads threads; dynamic shared memory as laid out
// below (the wrapper computes the same size).
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lens, const int* __restrict__ qlens,
    T* __restrict__ out, int num_blocks, int block_size, int max_nb,
    int rows, int group, int d, int tile_blocks, float scale) {
  constexpr int kVec = 16 / sizeof(T);   // elements per 16-byte load
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hkv = gridDim.x;
  const int tid = threadIdx.x;
  const int tk = tile_blocks * block_size;   // keys per tile
  const int kstride = d + 1;

  extern __shared__ float smem[];
  float* qs = smem;                    // rows * d
  float* acc = qs + rows * d;          // rows * d
  float* ks = acc + rows * d;          // tk * (d + 1)
  float* vs = ks + tk * kstride;       // tk * d
  float* ss = vs + tk * d;             // rows * tk
  float* m_row = ss + rows * tk;       // rows
  float* l_row = m_row + rows;         // rows
  float* c_row = l_row + rows;         // rows

  const int ctx = lens[b];
  const int qn = qlens[b];
  int nblk = (ctx + block_size - 1) / block_size;
  if (nblk > max_nb) nblk = max_nb;

  const size_t qo = (size_t)(b * hkv + h) * rows * d;
  for (int i = tid; i < rows * d; i += kThreads) {
    qs[i] = to_f(q[qo + i]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_row[r] = -INFINITY;
    l_row[r] = 0.f;
  }

  const int* tab = tables + (size_t)b * max_nb;
  const size_t head_off = (size_t)h * num_blocks * block_size * d;
  const int vecs_per_row = d / kVec;
  const int warp = tid / 32, lane = tid % 32;

  for (int j0 = 0; j0 < nblk; j0 += tile_blocks) {
    const int nb_here = min(tile_blocks, nblk - j0);
    const int keys = nb_here * block_size;
    __syncthreads();   // the previous tile is fully consumed
    for (int e = tid; e < tk * vecs_per_row; e += kThreads) {
      const int kk = e / vecs_per_row;
      const int c0 = (e % vecs_per_row) * kVec;
      float kf[kVec], vf[kVec];
      if (kk < keys) {
        const int pb = tab[j0 + kk / block_size];
        const size_t off =
            head_off + ((size_t)pb * block_size + kk % block_size) * d + c0;
        const uint4 kr = *reinterpret_cast<const uint4*>(k_pool + off);
        const uint4 vr = *reinterpret_cast<const uint4*>(v_pool + off);
        const T* kt = reinterpret_cast<const T*>(&kr);
        const T* vt = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          kf[i] = to_f(kt[i]);
          vf[i] = to_f(vt[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        ks[kk * kstride + c0 + i] = kf[i];
        vs[kk * d + c0 + i] = vf[i];
      }
    }
    __syncthreads();

    // Scores, masked by the per-row causal bound.
    for (int idx = tid; idx < rows * tk; idx += kThreads) {
      const int r = idx / tk, kk = idx % tk;
      const int pos = j0 * block_size + kk;
      const int bound = min(ctx, ctx - qn + 1 + r / group);
      float s = kNegInf;
      if (kk < keys && pos < bound) {
        const float* qr = qs + r * d;
        const float* kr = ks + kk * kstride;
        float dot = 0.f;
        for (int c = 0; c < d; ++c) dot += qr[c] * kr[c];
        s = dot * scale;
      }
      ss[idx] = s;
    }
    __syncthreads();

    // Online softmax: one warp per row.
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* sr = ss + r * tk;
      float mx = -INFINITY;
      for (int kk = lane; kk < tk; kk += 32) mx = fmaxf(mx, sr[kk]);
      mx = warp_max(mx);
      const float m_old = m_row[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int kk = lane; kk < tk; kk += 32) {
        const float p = expf(sr[kk] - m_new);
        sum += p;
        sr[kk] = to_f(from_f<T>(p));   // p in the value dtype for PV
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_row[r] = corr;
        l_row[r] = l_row[r] * corr + sum;
        m_row[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
    for (int idx = tid; idx < rows * d; idx += kThreads) {
      const int r = idx / d, c = idx % d;
      const float* pr = ss + r * tk;
      float a = acc[idx] * c_row[r];
      for (int kk = 0; kk < keys; ++kk) a += pr[kk] * vs[kk * d + c];
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rows * d; idx += kThreads) {
    const int r = idx / d;
    out[qo + idx] = from_f<T>(acc[idx] / fmaxf(l_row[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lens, const void* qlens,
           void* out, int b, int hkv, int num_blocks, int block_size,
           int max_nb, int rows, int group, int d, int tile_blocks,
           float scale, int smem_bytes, cudaStream_t stream) {
  auto kern = paged_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(hkv, b), kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<const int*>(qlens),
      static_cast<T*>(out), num_blocks, block_size, max_nb, rows, group, d,
      tile_blocks, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int paged_attention_launch(int dtype, const void* q, const void* k_pool,
                           const void* v_pool, const void* tables,
                           const void* lens, const void* qlens, void* out,
                           int b, int hkv, int num_blocks, int block_size,
                           int max_nb, int rows, int group, int d,
                           int tile_blocks, float scale, int smem_bytes,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, tables, lens, qlens, out, b, hkv,
                         num_blocks, block_size, max_nb, rows, group, d,
                         tile_blocks, scale, smem_bytes, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lens, qlens, out,
                                 b, hkv, num_blocks, block_size, max_nb, rows,
                                 group, d, tile_blocks, scale, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
