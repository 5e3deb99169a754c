// Paged decode / verify attention for Hopper (sm_90a): each sequence's
// keys split across CTAs, the pool's blocks brought into shared memory by
// bulk asynchronous copies, the partial softmaxes combined in a fixed
// order.
//
// Replaces the TPU kernel ray_tpu/ops/pallas/paged_decode.py
// `_decode_kernel` (built by `_make_decode_call`, one pallas_call for
// both q_len 1 decode and q_len > 1 speculative verify).
//
// What it computes: for each (sequence b, kv head h), online-softmax
// attention of rows = q_len * group query rows over the sequence's K/V,
// gathered block by block through block_tables[b, :]. Row r is query
// token r / group; it sees the keys below
//     bound_r = min(ctx, ctx - q_lens[b] + 1 + r / group)
// (write-then-attend: the current tokens are already in their slots).
// Padded table slots name block 0, the pool's reserved scratch block.
// Scores and the softmax statistics are f32; p is rounded to the value
// dtype before P.V (the TPU kernel's p.astype(v.dtype)); the output is
// in q's dtype.
//
// What bounds it on the H100: bytes. Each (b, h) reads ctx * d K and V
// values once and does 4 * rows * d flops per key: 2 flops a byte at
// rows = 1, far below the ~295 a byte at which the tensor cores would
// limit. So the design keeps enough bytes in flight on every SM:
//   * Split the keys across CTAs. `paged_decode_split_kernel` runs on the
//     grid (max_splits, kv heads, batch x row tiles) that
//     ops/paged_decode.py `decode_geometry` computes from shapes alone;
//     split s of a sequence is its pool blocks [s, s + 1) * chunk_blocks
//     (~128 keys). A CTA whose split lies past ceil(ctx / block_size)
//     exits at once, so the host never reads context_lens. At b 8, 12 kv
//     heads, max_nb 64 and block size 16 that is 768 CTAs, ~480 of them
//     live at contexts of 512, several for each of the 132 SMs.
//   * Issue the copies before the arithmetic. The CTA reads its table
//     entries into shared memory; then one thread issues a
//     `cp.async.bulk` per pool block (block [h, pb] is block_size x d
//     contiguous elements, 16-byte aligned since d * itemsize is a
//     multiple of 16) for K and for V into a ring of stages of up to 64
//     keys, each completing on its full mbarrier. At the serving shape the
//     chunk is two stages, so all of its copies are in flight before the
//     first score; a longer chunk refills a stage once every warp has
//     arrived on its empty mbarrier. A block longer than a stage is
//     copied in equal pieces. bf16 stays bf16 in shared memory.
//   * Arithmetic on the CUDA cores (tensor cores would idle at 2 flops a
//     byte). `lanes` = d * itemsize / 16 threads (rounded up to a power
//     of two, at most 32) hold one key row, 16 bytes each: 8 lanes at d 64
//     bf16, so a warp reads 4 key rows at a time. A lane group takes 4
//     keys a step (2 with 4 rows a CTA): their dot products (in-group
//     shuffles) are independent, and the step costs one max and one
//     rescale of its running (m, l, acc[its columns]) for each of the
//     CTA's rows. The groups merge by shuffles inside a warp and through
//     shared memory across warps, in a fixed order; the CTA writes
//     (acc[d], m, l) of each row to its own slot of the f32 workspace
//     [b, hkv, max_splits, rows, d + 2]. Scores are in log2 units (the
//     scale carries log2(e)), so every exponential is exp2.
//   * `paged_decode_combine_kernel`, one warp per (b, h, row), reads
//     slots 0 .. n_splits(b) - 1 in increasing order: m = max m_i,
//     l = sum l_i 2^(m_i - m), o = sum acc_i 2^(m_i - m) / max(l, 1e-30),
//     written in q's dtype. No atomics and no zeroing (every slot read is
//     written first): the result is bitwise repeatable. It is launched as
//     a programmatic dependent of the split kernel (griddepcontrol), so
//     its launch overlaps the split grid and it waits for that grid's
//     writes before its first read.
// A key at or past its row's bound is skipped, so it contributes exactly
// 0, as exp(NEG_INF - m) does in the TPU kernel; a split with no visible
// key for a row writes m = -inf, l = 0, acc = 0 and gets weight 0 in the
// combine. Every row sees key 0, so split 0 always has a real key.
//
// The earlier design's limit, now removed: one CTA per (b, kv head)
// walked the whole context alone (96 CTAs on 132 SMs at max_batch 8, the
// longest context setting the time), staging 64-key tiles as f32 through
// four __syncthreads-separated phases with no copy in flight during the
// arithmetic: 0.0881 ms at the serving shape, ~20x its bytes bound, on
// an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2, L2 flushed). The
// pair reads 0.0182 ms there; what is left is mostly fixed cost: two
// launches, each CTA's table -> copy -> arithmetic -> merge chain, and
// the write-backs of the dirty lines that the timing's flush leaves.

#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxCols = 8;   // combine: d <= 256 columns over 32 lanes

// ops/paged_decode.py DecodeGeometry, in its field order.
struct Geom {
  int b, hkv, rows, d, bs, max_nb, num_blocks, itemsize;
  int lanes, vecs, row_tile, row_tiles;
  int tile_blocks, pieces, tile_keys, chunk_blocks, max_splits, stages;
  int merge_off, table_off, bar_off, smem;
};
constexpr int kGeomLen = 22;

Geom read_geom(const int64_t* a) {
  Geom g;
  g.b = (int)a[0];
  g.hkv = (int)a[1];
  g.rows = (int)a[2];
  g.d = (int)a[3];
  g.bs = (int)a[4];
  g.max_nb = (int)a[5];
  g.num_blocks = (int)a[6];
  g.itemsize = (int)a[7];
  g.lanes = (int)a[8];
  g.vecs = (int)a[9];
  g.row_tile = (int)a[10];
  g.row_tiles = (int)a[11];
  g.tile_blocks = (int)a[12];
  g.pieces = (int)a[13];
  g.tile_keys = (int)a[14];
  g.chunk_blocks = (int)a[15];
  g.max_splits = (int)a[16];
  g.stages = (int)a[17];
  g.merge_off = (int)a[18];
  g.table_off = (int)a[19];
  g.bar_off = (int)a[20];
  g.smem = (int)a[21];
  return g;
}

// 16 bytes of T: `n` values, kept raw (`uint4`) and unpacked to floats.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  __device__ static __forceinline__ void unpack(const uint4& x, float* f) {
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static __forceinline__ void unpack(const uint4& x, float* f) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <typename T>
__device__ __forceinline__ uint4 raw16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// p as the value dtype holds it (the TPU kernel's p.astype(v.dtype)).
template <typename T> __device__ __forceinline__ float in_dtype(float x);
template <> __device__ __forceinline__ float in_dtype<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float in_dtype<__nv_bfloat16>(
    float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// The stages of a split, as decode_geometry's `tiles` lays them out:
// tile_blocks whole blocks a stage, or a block cut in `pieces` pieces of
// tile_keys keys (the last one shorter). x is a key offset in the split.
__device__ __forceinline__ int tile_start(const Geom& g, int t) {
  if (g.pieces == 1) return t * g.tile_keys;
  return (t / g.pieces) * g.bs + (t % g.pieces) * g.tile_keys;
}
__device__ __forceinline__ int tile_span(const Geom& g, int t) {
  if (g.pieces == 1) return g.tile_keys;
  return min(g.tile_keys, g.bs - (t % g.pieces) * g.tile_keys);
}
__device__ __forceinline__ int tile_of(const Geom& g, int x) {
  if (g.pieces == 1) return x / g.tile_keys;
  return (x / g.bs) * g.pieces + (x % g.bs) / g.tile_keys;
}

__device__ __forceinline__ int num_blocks_of(const Geom& g, int ctx) {
  return min((ctx + g.bs - 1) / g.bs, g.max_nb);
}

// q: [b, hkv, rows, d]; pools: [hkv, num_blocks, bs, d]; tables:
// [b, max_nb] int32; lens, qlens: [b] int32 (qlens null: 1 each, decode);
// ws: the f32 workspace; scale: d^-0.5 * log2(e), so scores, m and the
// workspace's m are in log2 units and every exponential is exp2.
// RT query rows a CTA; NV 16-byte vectors a lane (2 only for f32 with
// d > 128).
template <typename T, int RT, int NV>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ lens, const int* __restrict__ qlens,
    float* __restrict__ ws, const Geom g, int group, float scale) {
  constexpr int kVec = Vec16<T>::n;
  constexpr int kCols = NV * kVec;
  // Keys a lane group takes in one step of its walk (ops/paged_decode.py
  // _KEYS_PER_STEP): independent dot products, and one max and one
  // rescale a step, where registers allow.
  constexpr int kKeys = RT == 1 ? 4 : 2;
  extern __shared__ __align__(128) uint8_t smem_raw[];

  const int split = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / g.row_tiles;
  const int row0 = (blockIdx.z % g.row_tiles) * RT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // The combine may launch now; it waits for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  T* sKV = reinterpret_cast<T*>(smem_raw);
  float* sMerge = reinterpret_cast<float*>(smem_raw + g.merge_off);
  int* sTab = reinterpret_cast<int*>(smem_raw + g.table_off);
  const uint32_t bar_full = smem_addr(smem_raw + g.bar_off);
  const uint32_t bar_empty = bar_full + 8 * g.stages;

  // The context length and the split's table entries, loaded together
  // (the entries do not depend on it).
  const int blk0 = split * g.chunk_blocks;
  const int ctx = lens[b];
  const int qn = qlens != nullptr ? qlens[b] : 1;
  for (int i = tid; i < g.chunk_blocks && blk0 + i < g.max_nb; i += kThreads)
    sTab[i] = tables[(size_t)b * g.max_nb + blk0 + i];
  const int nblk = num_blocks_of(g, ctx);
  if (blk0 >= nblk) return;   // past this sequence's keys
  const int nb_here = min(g.chunk_blocks, nblk - blk0);
  const int kbeg = blk0 * g.bs;
  const int kend = min(ctx, (blk0 + nb_here) * g.bs);
  const int row_bytes = g.d * (int)sizeof(T);
  const int stage_elems = g.tile_keys * g.d;   // K (or V) of one stage

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kWarps);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = tile_of(g, kend - 1 - kbeg) + 1;
  // One thread: the bulk copies of stage t, K and V, one per pool block.
  auto issue = [&](int t) {
    const int slot = t % g.stages;
    const uint32_t full = bar_full + 8 * slot;
    const int x0 = kbeg + tile_start(g, t);
    const int x1 = min(kend, x0 + tile_span(g, t));
    mbar_expect_tx(full, 2u * (uint32_t)((x1 - x0) * row_bytes));
    const uint32_t dk = smem_addr(sKV + (size_t)2 * slot * stage_elems);
    const uint32_t dv = dk + stage_elems * (int)sizeof(T);
    for (int x = x0; x < x1;) {
      const int j = x / g.bs, off = x - j * g.bs;
      const int n = min(x1, (j + 1) * g.bs) - x;
      const size_t src =
          (((size_t)h * g.num_blocks + sTab[j - blk0]) * g.bs + off) * g.d;
      const uint32_t dst = (uint32_t)((x - x0) * row_bytes);
      bulk_load(dk + dst, k_pool + src, n * row_bytes, full);
      bulk_load(dv + dst, v_pool + src, n * row_bytes, full);
      x += n;
    }
  };
  if (tid == 0)
    for (int t = 0; t < min(g.stages, n_tiles); ++t) issue(t);

  // While the copies fly: this lane's columns of the CTA's query rows.
  const int L = g.lanes;
  const int kpw = 32 / L;               // keys a warp takes at a time
  const int gi = lane % L, kk = lane / L;
  const int nvec = g.d / kVec;
  float qr[RT][kCols], acc[RT][kCols], m[RT], l[RT];
  int bound[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + r;
    const T* qrow = q + (((size_t)b * g.hkv + h) * g.rows + row) * g.d;
    bound[r] = row < g.rows ? min(ctx, ctx - qn + 1 + row / group) : 0;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int vi = gi + v * L;
      float* dst = &qr[r][v * kVec];
      if (row < g.rows && vi < nvec) {
        Vec16<T>::unpack(raw16(qrow + vi * kVec), dst);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % g.stages;
    const int x0 = kbeg + tile_start(g, t);
    const int n = min(kend, x0 + tile_span(g, t)) - x0;
    mbar_wait(bar_full + 8 * slot, (t / g.stages) & 1);
    const T* sK = sKV + (size_t)2 * slot * stage_elems;
    const T* sV = sK + stage_elems;
    // Warp-uniform loop: every lane takes part in the shuffles. In one
    // step, lane group kk of the warp takes keys j0 + u * kpw + kk,
    // u < kKeys: a warp reads kpw consecutive key rows at a time.
    for (int j0 = warp * kpw * kKeys; j0 < n; j0 += kWarps * kpw * kKeys) {
      uint4 kr[kKeys][NV], vr[kKeys][NV];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int j = j0 + u * kpw + kk;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const int vi = gi + v * L;
          if (j < n && vi < nvec) {
            kr[u][v] = raw16(sK + (size_t)j * g.d + vi * kVec);
            vr[u][v] = raw16(sV + (size_t)j * g.d + vi * kVec);
          } else {
            kr[u][v] = vr[u][v] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      float dot[kKeys][RT];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        float kf[kCols];
#pragma unroll
        for (int v = 0; v < NV; ++v)
          Vec16<T>::unpack(kr[u][v], &kf[v * kVec]);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float a = 0.f;
#pragma unroll
          for (int c = 0; c < kCols; ++c) a += qr[r][c] * kf[c];
          dot[u][r] = a;
        }
      }
      for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
#pragma unroll
          for (int r = 0; r < RT; ++r)
            dot[u][r] += __shfl_xor_sync(0xffffffffu, dot[u][r], o);
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        // The step's visible keys for this row, one max and one rescale.
        float mx = m[r];
        bool vis[kKeys];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
          const int j = j0 + u * kpw + kk;
          vis[u] = j < n && x0 + j < bound[r];
          dot[u][r] *= scale;   // log2 units
          if (vis[u]) mx = fmaxf(mx, dot[u][r]);
        }
        if (mx == -INFINITY) continue;   // nothing visible to this row yet
        const float corr = exp2f(m[r] - mx);
        float psum = 0.f, pv[kKeys];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
          const float p = vis[u] ? exp2f(dot[u][r] - mx) : 0.f;
          psum += p;
          pv[u] = in_dtype<T>(p);
        }
        l[r] = l[r] * corr + psum;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float vf[kKeys][kVec];
#pragma unroll
          for (int u = 0; u < kKeys; ++u) Vec16<T>::unpack(vr[u][v], vf[u]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            float a = acc[r][v * kVec + e] * corr;
#pragma unroll
            for (int u = 0; u < kKeys; ++u) a += pv[u] * vf[u][e];
            acc[r][v * kVec + e] = a;
          }
        }
        m[r] = mx;
      }
    }
    // Release the stage; refill it once every warp is done with it.
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * slot);
    if (tid == 0 && t + g.stages < n_tiles) {
      mbar_wait(bar_empty + 8 * slot, (t / g.stages) & 1);
      issue(t + g.stages);
    }
  }

  // Merge the lane groups of a warp (xor partners, so every group ends
  // with the warp's state).
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      const float sa = m[r] == -INFINITY ? 0.f : exp2f(m[r] - mn);
      const float sb = mo == -INFINITY ? 0.f : exp2f(mo - mn);
      l[r] = l[r] * sa + lo * sb;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][c], o);
        acc[r][c] = acc[r][c] * sa + ao * sb;
      }
      m[r] = mn;
    }
  }
  // Across warps through shared memory: [warp][row][acc d, m, l].
  const int w = g.d + 2;
  if (lane < L) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float* dst = sMerge + (size_t)(warp * RT + r) * w;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int vi = lane + v * L;
        if (vi < nvec) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            dst[vi * kVec + e] = acc[r][v * kVec + e];
        }
      }
      if (lane == 0) {
        dst[g.d] = m[r];
        dst[g.d + 1] = l[r];
      }
    }
  }
  __syncthreads();
  const int nrows = min(RT, g.rows - row0);
  float* out = ws + ((((size_t)b * g.hkv + h) * g.max_splits + split) *
                         g.rows + row0) * w;
  for (int idx = tid; idx < nrows * w; idx += kThreads) {
    const int r = idx / w, c = idx - r * w;
    float mw = -INFINITY;
#pragma unroll
    for (int i = 0; i < kWarps; ++i)
      mw = fmaxf(mw, sMerge[(size_t)(i * RT + r) * w + g.d]);
    float val = mw;
    if (c != g.d) {   // acc columns and l: warps 0..3 in order
      val = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        const float* src = sMerge + (size_t)(i * RT + r) * w;
        const float mi = src[g.d];
        const float si = mi == -INFINITY ? 0.f : exp2f(mi - mw);
        val += src[c] * si;
      }
    }
    out[(size_t)r * w + c] = val;
  }
}

// One warp per (b, h, row): the splits' partials in increasing order.
// Lane i holds split i's m and l, loaded together with the acc columns
// of the first kBatch splits (one round trip at the serving shape, up
// to 8 splits); the weights and l go round the warp by shuffles, and each
// lane sums its columns of acc over the splits in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_combine_kernel(
    const float* __restrict__ ws, const int* __restrict__ lens,
    T* __restrict__ out, const Geom g) {
  constexpr int kBatch = 8;
  const int item = blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= g.b * g.hkv * g.rows) return;
  const int lane = threadIdx.x % 32;
  const int row = item % g.rows, bh = item / g.rows, b = bh / g.hkv;
  const int nblk = num_blocks_of(g, lens[b]);
  const int ns = nblk > 0 ? (nblk + g.chunk_blocks - 1) / g.chunk_blocks : 0;
  const int w = g.d + 2;
  const size_t stride = (size_t)g.rows * w;
  const float* slot = ws + ((size_t)bh * g.max_splits * g.rows + row) * w;
  float a[kBatch][kMaxCols];
  auto load_batch = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        const int c = lane + 32 * j;
        a[u][j] = i0 + u < ns && c < g.d ? slot[(i0 + u) * stride + c] : 0.f;
      }
  };
  // Launched as a programmatic dependent of the split kernel: wait for
  // its grid (and its workspace writes) before the first read.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float mi = -INFINITY, li = 0.f;
  if (lane < ns) {
    mi = slot[lane * stride + g.d];
    li = slot[lane * stride + g.d + 1];
  }
  load_batch(0);
  float m = mi;
  for (int i = lane + 32; i < ns; i += 32) m = fmaxf(m, slot[i * stride + g.d]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, x));
  float o[kMaxCols], l = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) o[j] = 0.f;
  for (int i0 = 0; i0 < ns; i0 += 32) {
    if (i0 > 0) {
      mi = i0 + lane < ns ? slot[(i0 + lane) * stride + g.d] : -INFINITY;
      li = i0 + lane < ns ? slot[(i0 + lane) * stride + g.d + 1] : 0.f;
    }
    const float wi = mi == -INFINITY ? 0.f : exp2f(mi - m);   // log2 units
    const int n = min(32, ns - i0);
    for (int k = 0; k < n; k += kBatch) {
      if (i0 + k > 0) load_batch(i0 + k);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const float wu = __shfl_sync(0xffffffffu, wi, (k + u) & 31);
        const float lu = __shfl_sync(0xffffffffu, li, (k + u) & 31);
        if (k + u < n) {
          l += lu * wu;
#pragma unroll
          for (int j = 0; j < kMaxCols; ++j) o[j] += a[u][j] * wu;
        }
      }
    }
  }
  const float den = fmaxf(l, 1e-30f);
  T* dst = out + (size_t)item * g.d;
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int c = lane + 32 * j;
    if (c < g.d) dst[c] = from_f<T>(o[j] / den);
  }
}

template <typename T, int RT, int NV>
int launch_pair(const Geom& g, const void* q, const void* k_pool,
                const void* v_pool, const void* tables, const void* lens,
                const void* qlens, float* ws, void* out, int group,
                float scale, cudaStream_t stream) {
  auto split = paged_decode_split_kernel<T, RT, NV>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(g.max_splits, g.hkv, g.b * g.row_tiles), kThreads, g.smem,
          stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<const int*>(qlens), ws, g,
      group, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // The combine as a programmatic dependent launch: it is scheduled while
  // the split grid runs and waits for it in griddepcontrol.wait, so the
  // gap between two dependent launches is hidden.
  const int items = g.b * g.hkv * g.rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((items + kWarps - 1) / kWarps);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, paged_decode_combine_kernel<T>,
                           static_cast<const float*>(ws),
                           static_cast<const int*>(lens),
                           static_cast<T*>(out), g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The geometry the kernels assume, checked before any launch.
template <typename T>
bool geom_ok(const Geom& g) {
  constexpr int vec = Vec16<T>::n;
  const int nvec = g.d / vec;
  const int rows_ok = g.row_tile == 1 || g.row_tile == 4;
  return g.itemsize == (int)sizeof(T) && g.d % vec == 0 && g.d > 0 &&
         g.d <= 32 * kMaxCols && g.lanes > 0 && g.lanes <= 32 &&
         (g.lanes & (g.lanes - 1)) == 0 && g.vecs * g.lanes >= nvec &&
         (g.vecs - 1) * g.lanes < nvec && rows_ok &&
         g.row_tiles * g.row_tile >= g.rows && g.stages >= 1 &&
         g.stages <= kMaxStages && g.tile_keys >= 1 && g.pieces >= 1 &&
         g.chunk_blocks >= 1 && g.max_splits >= 1 && g.bs >= 1 &&
         (g.pieces == 1 ? g.tile_keys == g.tile_blocks * g.bs &&
                              g.chunk_blocks % g.tile_blocks == 0
                        : g.tile_blocks == 1 && g.tile_keys < g.bs) &&
         g.smem <= kMaxSmem && g.merge_off % 16 == 0 &&
         g.bar_off % 8 == 0 &&
         g.merge_off >= 2 * g.stages * g.tile_keys * g.d * g.itemsize &&
         g.table_off >= g.merge_off + kWarps * g.row_tile * (g.d + 2) * 4 &&
         g.bar_off >= g.table_off + 4 * g.chunk_blocks &&
         g.smem >= g.bar_off + 16 * g.stages;
}

template <typename T, int NV>
int launch_rows(const Geom& g, const void* q, const void* k_pool,
                const void* v_pool, const void* tables, const void* lens,
                const void* qlens, float* ws, void* out, int group,
                float scale, cudaStream_t s) {
  switch (g.row_tile) {
    case 1:
      return launch_pair<T, 1, NV>(g, q, k_pool, v_pool, tables, lens, qlens,
                                   ws, out, group, scale, s);
    case 4:
      return launch_pair<T, 4, NV>(g, q, k_pool, v_pool, tables, lens, qlens,
                                   ws, out, group, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const Geom& g, const void* q, const void* k_pool,
           const void* v_pool, const void* tables, const void* lens,
           const void* qlens, float* ws, void* out, int group, float scale,
           cudaStream_t s) {
  if (!geom_ok<T>(g) || group < 1) return (int)cudaErrorInvalidValue;
  if (g.vecs == 1)
    return launch_rows<T, 1>(g, q, k_pool, v_pool, tables, lens, qlens, ws,
                             out, group, scale, s);
  if constexpr (sizeof(T) == 4) {   // f32 at d > 128: two vectors a lane
    if (g.vecs == 2)
      return launch_rows<T, 2>(g, q, k_pool, v_pool, tables, lens, qlens, ws,
                               out, group, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; geom: the int64 array of
// ops/paged_decode.py `decode_geometry` (kGeomLen values); ws: the f32
// workspace of its `workspace_shape`; qlens may be null (decode: one row
// a sequence). Launches the split kernel, then the combine kernel, on
// `stream`. Returns a cudaError_t (0 = launched).
int paged_attention_launch(int dtype, const void* q, const void* k_pool,
                           const void* v_pool, const void* tables,
                           const void* lens, const void* qlens, float* ws,
                           void* out, const int64_t* geom, int group,
                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = read_geom(geom);
  if (dtype == 0)
    return launch<float>(g, q, k_pool, v_pool, tables, lens, qlens, ws, out,
                         group, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(g, q, k_pool, v_pool, tables, lens, qlens,
                                 ws, out, group, scale, s);
  return (int)cudaErrorInvalidValue;
}

int paged_decode_geom_len() { return kGeomLen; }

const char* paged_attention_error_string(int err) { return error_text(err); }

}  // extern "C"
