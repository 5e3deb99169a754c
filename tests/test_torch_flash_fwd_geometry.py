"""The launch geometry of the flash forward kernel
(ray_tpu_torch/ops/flash.py ``fwd_geometry``), on the CPU.

The bf16 forward kernel (ops/csrc/flash_fwd.cu) loads Q, K and V with
TMA through one tensor map each, over the 4-D view (d, heads, seq,
batch) with the tensors' own byte strides, and tiles the work in
128-row q tiles and 128-key K/V tiles with the head dim padded to 64 or
128. All of that is computed in Python and handed to the C entry point
as one int64 array, so it is tested here without a card: the maps
address every element where torch has it, meet TMA's rules (16-byte
strides, boxes of at most 256 rows and, under the 128-byte swizzle, 128
bytes), and the tiles cover the output. An emulation of the kernel's
loop on the CPU, driven by the same geometry (its tiles, its causal
bound, its zero padding, exp2 with the log2(e) scale), is held against
the plain version and against the JAX package's Pallas kernel in
interpret mode at the same tiles: bf16 output at 3e-2 max abs (the
flash bf16 tolerance), the f32 LSE at 2e-5. The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas import flash as jax_flash
from ray_tpu_torch.ops import flash as F

torch.set_num_threads(1)

ATOL_OUT_BF16 = 3e-2
ATOL_LSE = 2e-5
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


@pytest.fixture(scope="module", autouse=True)
def _two_cores():
    """Run this module's threads (torch's, and the JAX compiler's and
    runtime's, which torch.set_num_threads does not reach) on two cores,
    so that under the suite's parallel workers the timing-sensitive
    tests elsewhere keep the rest of the machine. Every thread's mask is
    restored afterwards."""
    if not hasattr(os, "sched_setaffinity"):
        yield
        return
    full = os.sched_getaffinity(0)
    cpus = sorted(full)
    w = int(os.environ.get("PYTEST_XDIST_WORKER", "gw0").lstrip("gw") or 0)
    cores = {cpus[(2 * w) % len(cpus)], cpus[(2 * w + 1) % len(cpus)]}

    def pin(mask):
        for tid in os.listdir("/proc/self/task"):
            try:
                os.sched_setaffinity(int(tid), mask)
            except OSError:   # the thread ended meanwhile
                pass

    pin(cores)
    try:
        yield
    finally:
        pin(full)


def _tensors(b, sq, sk, h, hk, d, layout, dtype=torch.bfloat16):
    def shape(s, n):
        return (b, s, n, d) if layout == "bshd" else (b, n, s, d)

    return (torch.empty(shape(sq, h), dtype=dtype),
            torch.empty(shape(sk, hk), dtype=dtype),
            torch.empty(shape(sk, hk), dtype=dtype))


def _geometry(q, k, v, layout):
    s_ax, h_ax = F._split(layout)
    q, k, v = F._kernel_operands((("q", q), ("k", k), ("v", v)), q.dtype,
                                 q.device, q.shape[-1])
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    return F.fwd_geometry(q, k, v, out, s_ax, h_ax), (q, k, v, out)


def _check_map(m, t, layout, rows):
    """The map's view of ``t`` is ``t``: dims, strides and box obey
    TMA's rules, and the byte offset of an element through the map is
    its offset in torch's storage."""
    s_ax, h_ax = F._split(layout)
    isz = t.element_size()
    assert m.dims == (t.shape[-1], t.shape[h_ax], t.shape[s_ax],
                      t.shape[0])
    assert all(0 < n < 2 ** 32 for n in m.dims)
    assert all(st % 16 == 0 and 0 < st < 2 ** 40 for st in m.strides)
    assert m.box == (64, 1, rows, 1)
    assert all(0 < n <= 256 for n in m.box)
    assert m.box[0] * isz <= 128           # the 128-byte swizzle's span
    rng = np.random.default_rng(sum(m.dims))
    for _ in range(16):
        di, hi, si, bi = (int(rng.integers(n)) for n in m.dims)
        idx = [0, 0, 0, 0]
        idx[0], idx[h_ax], idx[s_ax], idx[3] = bi, hi, si, di
        want = (t[tuple(idx)].data_ptr() - t.data_ptr())
        got = di * isz + hi * m.strides[0] + si * m.strides[1] \
            + bi * m.strides[2]
        assert got == want


@pytest.mark.parametrize("s", [1, 1000, 1023])
@pytest.mark.parametrize("d", F._HEAD_DIMS)
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_bf16_geometry_maps_and_tiles(layout, d, s):
    b, h = 2, 3
    q, k, v = _tensors(b, s, s, h, h, d, layout)
    g, (q, k, v, out) = _geometry(q, k, v, layout)
    assert g.head_dim_padded == (64 if d <= 64 else 128)
    assert g.head_dim_padded % 64 == 0 and g.head_dim_padded >= d
    assert (g.block_q, g.block_k) == (128, 128)
    assert g.grid == (h, b, math.ceil(s / 128))
    assert g.grid[2] * g.block_q >= s
    for m, t, rows in zip(g.maps, (q, k, v), (128, 128, 128)):
        _check_map(m, t, layout, rows)
    s_ax, h_ax = F._split(layout)
    assert g.strides == tuple(x for t in (q, k, v, out) for x in (
        t.stride(0), t.stride(h_ax), t.stride(s_ax)))
    arr = g.to_array()
    assert len(arr) == F.GEOM_LEN and all(isinstance(x, int) for x in arr)
    assert arr[:6] == [g.head_dim_padded, 128, 128, *g.grid]
    assert arr[18:29] == [*g.maps[0].dims, *g.maps[0].strides,
                          *g.maps[0].box]


@pytest.mark.parametrize("h,hk", [(8, 2), (4, 1)])
@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_bf16_geometry_gqa_kv_maps(layout, h, hk):
    q, k, v = _tensors(2, 200, 300, h, hk, 64, layout)
    g, (q, k, v, _) = _geometry(q, k, v, layout)
    assert g.grid == (h, 2, 2)
    assert g.maps[0].dims == (64, h, 200, 2)
    assert g.maps[1].dims == g.maps[2].dims == (64, hk, 300, 2)
    for m, t in zip(g.maps, (q, k, v)):
        _check_map(m, t, layout, 128)


@pytest.mark.parametrize("s", [1, 1000, 1023])
def test_f32_geometry_is_the_cuda_core_kernel(s):
    q, k, v = _tensors(2, s, s, 4, 2, 48, "bshd", torch.float32)
    g, (q, k, v, out) = _geometry(q, k, v, "bshd")
    assert (g.head_dim_padded, g.block_q, g.block_k) == (48, 64, 64)
    assert g.grid == (math.ceil(s / 64), 4, 2)
    assert g.maps == ()
    arr = g.to_array()
    assert len(arr) == F.GEOM_LEN and arr[18:] == [0] * (F.GEOM_LEN - 18)


def test_strided_views_copied_only_when_tma_cannot_read_them():
    # A fused-QKV slice: unit head stride, 16-byte strides; read in place.
    qkv = torch.empty(2, 100, 3, 4, 32, dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    g, (q2, k2, v2, _) = _geometry(q, k, v, "bshd")
    assert q2.data_ptr() == q.data_ptr()
    assert g.maps[0].strides == (64, 3 * 4 * 32 * 2, 100 * 3 * 4 * 32 * 2)
    _check_map(g.maps[0], q, "bshd", 128)
    # A non-unit head-dim stride and a 104-byte head stride: copied, and
    # the copy's map is the contiguous one.
    wide = torch.empty(2, 100, 4, 64, dtype=torch.bfloat16)
    q = wide[..., ::2]
    k = torch.empty(2, 100, 4, 52, dtype=torch.bfloat16)[..., :32]
    g, (q2, k2, _, _) = _geometry(q, k, k, "bshd")
    assert q2.data_ptr() != q.data_ptr() and q2.is_contiguous()
    assert k2.data_ptr() != k.data_ptr() and k2.is_contiguous()
    assert g.maps[0].strides == g.maps[1].strides == (64, 256, 25600)
    for m, t in zip(g.maps, (q2, k2)):
        _check_map(m, t, "bshd", 128)


def test_causal_walks_longest_first():
    q, k, v = _tensors(1, 1000, 1000, 2, 2, 64, "bhsd")
    g, _ = _geometry(q, k, v, "bhsd")
    walks = [_upper(_q0(g, z), g, 1000, True) for z in range(g.grid[2])]
    assert walks == sorted(walks, reverse=True) and walks[0] == 8


def _q0(g, z):
    """The first query row of the CTA at grid index z (reversed)."""
    return (g.grid[2] - 1 - z) * g.block_q


def _upper(q0, g, sk, causal):
    nk = -(-sk // g.block_k)
    if not causal:
        return nk
    return min(nk, (q0 + g.block_q + g.block_k - 1) // g.block_k)


def _emulate(q, k, v, causal, layout):
    """The bf16 kernel's loop on the CPU, from ``fwd_geometry``: per
    CTA (grid z reversed) two 64-row halves walk key tiles up to the
    causal bound; Q, K and V are zero-padded as TMA fills them (head dim
    to DP, rows to whole tiles); scores are f32 products scaled by
    scale·log2(e), masked with -1e9·log2(e) past sk and above the
    diagonal; exp2 online softmax; p rounded to bf16 for PV; out =
    acc / max(l, 1e-30); lse = m·ln2 + log(max(l, 1e-30))."""
    g, _ = _geometry(q, k, v, layout)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dp, bq, bk = g.head_dim_padded, g.block_q, g.block_k
    assert g.grid[:2] == (h, b)
    nk = -(-sk // bk)

    def pad(t, rows):
        t = t.float().repeat_interleave(h // t.shape[1], dim=1)
        return torch.nn.functional.pad(t, (0, dp - d, 0, rows - t.shape[2]))

    qp, kp, vp = pad(q, g.grid[2] * bq), pad(k, nk * bk), pad(v, nk * bk)
    scale_log2 = d ** -0.5 * LOG2E
    out = torch.zeros(b, h, g.grid[2] * bq, dp)
    lse = torch.zeros(b, h, g.grid[2] * bq)
    for z in range(g.grid[2]):
        q0 = _q0(g, z)
        for r0 in (q0, q0 + 64):
            qpos = torch.arange(r0, r0 + 64)[:, None]
            m = torch.full((b, h, 64), -math.inf)
            l = torch.zeros(b, h, 64)
            acc = torch.zeros(b, h, 64, dp)
            for kt in range(_upper(q0, g, sk, causal)):
                k0 = kt * bk
                s = qp[:, :, r0:r0 + 64] @ kp[:, :, k0:k0 + bk].transpose(
                    -1, -2) * scale_log2
                kpos = torch.arange(k0, k0 + bk)[None, :]
                mask = kpos < sk
                if causal:
                    mask = mask & (qpos >= kpos)
                s = torch.where(mask, s, torch.tensor(-1e9 * LOG2E))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[..., None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + \
                    p.bfloat16().float() @ vp[:, :, k0:k0 + bk]
                m = m_new
            lc = l.clamp_min(1e-30)
            out[:, :, r0:r0 + 64] = acc / lc[..., None]
            lse[:, :, r0:r0 + 64] = m * LN2 + torch.log(lc)
    out = out[:, :, :sq, :d].bfloat16()
    if layout == "bshd":
        out = out.transpose(1, 2)
    return out, lse[:, :, :sq]


def _inputs(seed, b, sq, sk, h, hk, d, layout):
    rng = np.random.default_rng(seed)

    def shape(s, n):
        return (b, s, n, d) if layout == "bshd" else (b, n, s, d)

    return [rng.standard_normal(shape(s, n), np.float32)
            for s, n in ((sq, h), (sk, hk), (sk, hk))]


EMULATED = {
    # name: (seed, b, sq, sk, h, hk, d, causal, layout)
    "serving_bhsd": (1, 1, 300, 300, 2, 2, 64, True, "bhsd"),
    "ragged_bshd_d48": (2, 2, 200, 200, 4, 2, 48, True, "bshd"),
    "dense_d80_gqa": (3, 1, 129, 129, 4, 1, 80, False, "bhsd"),
    "sq_lt_sk_d128": (4, 1, 100, 300, 2, 2, 128, True, "bshd"),
    "sq_lt_sk_dense_d16": (5, 1, 100, 300, 2, 2, 16, False, "bshd"),
    "long_d32": (6, 1, 1000, 1000, 2, 2, 32, True, "bhsd"),
    "one_row": (7, 2, 1, 1, 2, 2, 112, True, "bshd"),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_kernel_matches_plain_version(case):
    seed, b, sq, sk, h, hk, d, causal, layout = EMULATED[case]
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _inputs(seed, b, sq, sk, h, hk, d, layout))
    out, lse = _emulate(q, k, v, causal, layout)
    ref, ref_lse = F.flash_attention_fwd_lse_reference(
        q, k, v, causal=causal, layout=layout)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert float((out.float() - ref.float()).abs().max()) <= ATOL_OUT_BF16
    assert float((lse - ref_lse).abs().max()) <= ATOL_LSE


@pytest.mark.parametrize("case", ["serving_bhsd", "ragged_bshd_d48",
                                  "sq_lt_sk_d128"])
def test_emulated_kernel_matches_pallas_at_its_tiles(case):
    seed, b, sq, sk, h, hk, d, causal, layout = EMULATED[case]
    x = _inputs(seed, b, sq, sk, h, hk, d, layout)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in x)
    out, lse = _emulate(q, k, v, causal, layout)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in x)
    h_ax = 2 if layout == "bshd" else 1
    jk, jv = (jnp.repeat(a, h // hk, axis=h_ax) for a in (jk, jv))
    jout, res = jax_flash._fwd(jq, jk, jv, causal=causal, blk_q=128,
                               blk_k=128, interpret=True,
                               heads_major=layout == "bhsd")
    jlse = np.asarray(res[4])[:, :, :sq, 0]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32),
                               atol=ATOL_OUT_BF16, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL_LSE, rtol=0)
