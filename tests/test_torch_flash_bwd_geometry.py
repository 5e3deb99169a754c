"""The fused flash backward's launch geometry and its fixed-order dq
(ray_tpu_torch/ops/flash.py ``bwd_geometry``, ``row_stats``), and the
backward at unequal lengths, on the CPU.

The bf16 fused backward (ops/csrc/flash_bwd.cu) runs one CTA per (kv
head, batch, 128-key tile). It loads Q and dO tiles of 8192 / DP rows and
K and V with TMA through one tensor map each, over the 4-D view (d,
heads, seq, batch) with the tensors' own byte strides, the head dim
padded to DP = 64 or 128; each q tile's LSE and Δ come from a zero-padded
[b, h, q tiles, 2, BQ] buffer. It writes each q tile's dq contribution to
slot kt of an f32 workspace [key tiles, b, h, sq, d], and a second kernel
sums the slots 0 .. last visible key tile in increasing kt. All of that
is computed in Python and handed to the C entry point as one int64
array, so it is tested here without a card: the maps address every
element where torch has it and meet TMA's rules, the tiles cover dK, dV
and every dq slot the sum reads (and nothing unwritten is read), the
causal first q tile is right when BQ != BK, and the workspace is the size
reckoned for it. An emulation of the kernel's loop on the CPU, driven by
the same geometry (its tiles, the transposed scores, exp2 with the
log2(e) scale, P and dS rounded to bf16, the group sum of dK and dV, the
NaN-filled workspace and its ordered sum), is held against the plain
version and against the JAX package's Pallas backward in interpret mode
at the kernel's tiles: bf16 gradients by relative norm error 3e-2, as
chip_smoke.py holds the kernel on the card.

The fused route's f32 dq workspace grows with b·h·s², which the
reference's rule (``_fused_bwd_fits``) does not read: ``bwd_route``
sends a call whose workspace passes ``_FUSED_BWD_WORKSPACE_BYTES`` (256
MiB) to the split kernels, which need none. Its byte count is the
geometry's, the route at the shapes that matter is the one reckoned for
it, and ``FlashAttention``'s backward takes the route it names.

At unequal lengths (causal sq 300 > sk 100, causal sq 100 < sk 300, and
dense), the plain backward and the fused and split routes (their plain
versions on CPU tensors) are held against the Pallas backward in
interpret mode in f32 at the reference's gradient tolerance, 1e-3. The
Pallas backward is fed the residuals of its custom VJP built from the
port's plain forward (rows padded with zeros to its blocks), so only the
backward kernel is compiled.
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

RTOL_BF16 = 3e-2
ATOL_GRAD = 1e-3
LOG2E = 1.4426950408889634


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


def _shape(b, s, n, d, layout):
    return (b, s, n, d) if layout == "bshd" else (b, n, s, d)


def _geometry(q, k, v, do, layout):
    """The wrapper's operands and the fused route's geometry for them."""
    s_ax, h_ax = F._split(layout)
    q, k, v, do = F._kernel_operands(
        (("q", q), ("k", k), ("v", v), ("do", do)), q.dtype, q.device,
        q.shape[-1])
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    return (F.bwd_geometry(q, k, v, do, dq, dk, dv, s_ax, h_ax),
            (q, k, v, do, dq, dk, dv))


def _empty(b, sq, sk, h, hk, d, layout, dtype=torch.bfloat16):
    q, do = (torch.empty(_shape(b, sq, h, d, layout), dtype=dtype)
             for _ in range(2))
    k, v = (torch.empty(_shape(b, sk, hk, d, layout), dtype=dtype)
            for _ in range(2))
    return q, k, v, do


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
    assert m.box[0] * isz <= 128           # the 128-byte swizzle's span
    rng = np.random.default_rng(sum(m.dims))
    for _ in range(16):
        di, hi, si, bi = (int(rng.integers(n)) for n in m.dims)
        idx = [0, 0, 0, 0]
        idx[0], idx[h_ax], idx[s_ax], idx[3] = bi, hi, si, di
        want = t[tuple(idx)].data_ptr() - t.data_ptr()
        got = di * isz + hi * m.strides[0] + si * m.strides[1] \
            + bi * m.strides[2]
        assert got == want


@pytest.mark.parametrize("layout,d", [("bshd", 64), ("bhsd", 64),
                                      ("bshd", 48), ("bhsd", 80),
                                      ("bshd", 128)])
def test_bf16_bwd_geometry_maps_and_tiles(layout, d):
    b, s, h = 2, 1023, 3
    g, (q, k, v, do, dq, dk, dv) = _geometry(*_empty(b, s, s, h, h, d,
                                                     layout), layout)
    dp = 64 if d <= 64 else 128
    assert (g.head_dim_padded, g.block_q, g.block_k) == (dp, 8192 // dp,
                                                        128)
    assert g.grid == (h, b, math.ceil(s / 128)) and g.batch == b
    assert g.q_tiles == math.ceil(s / g.block_q) and g.slots == g.grid[2]
    for m, t, rows in zip(g.maps, (q, k, v, do),
                          (g.block_q, 128, 128, g.block_q)):
        _check_map(m, t, layout, rows)
    s_ax, h_ax = F._split(layout)
    assert g.strides == tuple(x for t in (q, k, v, do, dq, dk, dv) for x in (
        t.stride(0), t.stride(h_ax), t.stride(s_ax)))
    arr = g.to_array()
    assert len(arr) == F.BWD_GEOM_LEN and all(isinstance(x, int)
                                              for x in arr)
    assert arr[:9] == [dp, g.block_q, 128, *g.grid, b, g.q_tiles, g.slots]
    assert arr[30:41] == [*g.maps[0].dims, *g.maps[0].strides,
                          *g.maps[0].box]
    assert arr[63:74] == [*g.maps[3].dims, *g.maps[3].strides,
                          *g.maps[3].box]


def test_bf16_bwd_geometry_gqa_unequal_lengths():
    g, (q, k, v, do, *_) = _geometry(*_empty(2, 300, 100, 8, 2, 64,
                                             "bhsd"), "bhsd")
    assert g.grid == (2, 2, 1) and g.q_tiles == 3 and g.slots == 1
    assert g.maps[0].dims == g.maps[3].dims == (64, 8, 300, 2)
    assert g.maps[1].dims == g.maps[2].dims == (64, 2, 100, 2)
    for m, t, rows in zip(g.maps, (q, k, v, do), (128, 128, 128, 128)):
        _check_map(m, t, "bhsd", rows)


def test_f32_bwd_geometry_is_the_cuda_core_kernel():
    g, _ = _geometry(*_empty(2, 1000, 1000, 4, 2, 48, "bshd",
                             torch.float32), "bshd")
    assert (g.head_dim_padded, g.block_q, g.block_k) == (48, 64, 64)
    assert g.grid == (16, 2, 2) and g.slots == 16 and g.q_tiles == 16
    assert g.maps == ()
    arr = g.to_array()
    assert len(arr) == F.BWD_GEOM_LEN and arr[30:] == [0] * 44


def _written(g, sq, sk, causal):
    """The (q tile, key tile) pairs whose dq slot the kernel writes: each
    key tile's CTA walks its q tiles from ``first_q_tile`` down."""
    return {(qt, kt) for kt in range(g.slots)
            for qt in range(g.first_q_tile(kt, causal), g.q_tiles)}


@pytest.mark.parametrize("sq,sk,d,causal", [(1023, 1023, 64, True),
                                            (300, 100, 128, True),
                                            (100, 300, 80, True),
                                            (300, 100, 48, False)])
def test_tiles_cover_and_the_sum_reads_only_written_slots(sq, sk, d,
                                                          causal):
    g, _ = _geometry(*_empty(1, sq, sk, 2, 2, d, "bshd"), "bshd")
    assert g.slots * g.block_k >= sk          # dK and dV of every key
    assert g.q_tiles * g.block_q >= sq        # every dq row
    written = _written(g, sq, sk, causal)
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(sk)[None, :]
    visible = (qpos >= kpos) if causal else torch.ones(sq, sk, dtype=bool)
    for qt in range(g.q_tiles):
        last = g.last_slot(qt, causal)
        read = {(qt, kt) for kt in range(last + 1)}
        assert read <= written
        rows = slice(qt * g.block_q, (qt + 1) * g.block_q)
        for kt in range(g.slots):
            keys = slice(kt * g.block_k, (kt + 1) * g.block_k)
            seen = bool(visible[rows, keys].any())
            # A tile the sum leaves out has no visible key for the rows;
            # one it reads was written.
            assert seen <= (kt <= last)
            assert ((qt, kt) in written) == (kt <= last)
    # The causal walk starts at the first q tile that sees the key tile
    # (BQ = 64 != BK = 128 at DP 128: key tile kt starts at q tile 2 kt).
    if causal:
        for kt in range(g.slots):
            first = g.first_q_tile(kt, causal)
            k0 = kt * g.block_k
            assert first * g.block_q <= k0 < (first + 1) * g.block_q
        if g.head_dim_padded == 128:
            assert [g.first_q_tile(kt, True) for kt in range(g.slots)] == \
                [2 * kt for kt in range(g.slots)]


def test_workspace_matches_the_reckoning():
    """The workspace's size at BK 128, as flash_bwd.cu's note reckons
    it: the training shape's slots of 25.1 MB x 8, ~113 MB of them
    written (and read by the sum); 16384 tokens, 50.3 MB x 128 = 6.4 GB
    allocated."""
    g, _ = _geometry(*_empty(8, 1023, 1023, 12, 12, 64, "bshd"), "bshd")
    shape = g.workspace_shape(12, 1023, 64)
    assert shape == (8, 8, 12, 1023, 64)
    slot_mb = math.prod(shape[1:]) * 4 / 1e6
    assert round(slot_mb, 1) == 25.1
    written_mb = len(_written(g, 1023, 1023, True)) * 8 * 12 * 128 * 64 \
        * 4 / 1e6
    assert round(written_mb) == 113
    g, _ = _geometry(*_empty(1, 16384, 16384, 12, 12, 64, "bshd"), "bshd")
    shape = g.workspace_shape(12, 16384, 64)
    assert shape[0] == 128 and round(math.prod(shape[1:]) * 4 / 1e6, 1) \
        == 50.3
    assert round(math.prod(shape) * 4 / 1e9, 1) == 6.4


def test_row_stats_pads_each_tile_with_zeros():
    lse = torch.arange(2 * 3 * 130, dtype=torch.float32).view(2, 3, 130)
    delta = -lse
    rows = F.row_stats(lse, delta, 64)
    assert rows.shape == (2, 3, 3, 2, 64) and rows.is_contiguous()
    assert torch.equal(rows[:, :, :, 0].flatten(2)[..., :130], lse)
    assert torch.equal(rows[:, :, :, 1].flatten(2)[..., :130], delta)
    assert not rows[:, :, 2, :, 2:].any()


def _emulate(q, k, v, o, lse, do, causal, layout):
    """The bf16 fused route on the CPU, from ``bwd_geometry``: per key
    tile (its CTA), per query head of the group and q tile from the
    causal start down, S^T = K Q^T and dP^T = V dO^T in f32 over the
    zero-padded tiles (head dim to DP, rows to whole tiles); P^T =
    exp2(S^T scale log2e - lse log2e) masked past sq and sk and above
    the diagonal; dS^T = P^T (dP^T - Δ) scale; P and dS rounded to bf16;
    dV += P^T dO and dK += dS^T Q summed over the group; the tile's dq =
    dS K into workspace slot kt (NaN where never written); then dq =
    the slots 0 .. last_slot summed in increasing kt."""
    g, _ = _geometry(q, k, v, do, layout)
    s_ax, h_ax = F._split(layout)
    delta = F._delta(o, do, h_ax)
    if layout == "bshd":
        q, k, v, do = (t.transpose(1, 2) for t in (q, k, v, do))
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    grp = h // hk
    dp, bq, bk = g.head_dim_padded, g.block_q, g.block_k
    nq, nk = g.q_tiles, g.slots

    def pad(t, rows):
        return torch.nn.functional.pad(t.float(),
                                       (0, dp - d, 0, rows - t.shape[2]))

    Q, dO = (pad(t, nq * bq).view(b, hk, grp, nq * bq, dp) for t in (q, do))
    K, V = pad(k, nk * bk), pad(v, nk * bk)
    stats = F.row_stats(lse, delta, bq).view(b, hk, grp, nq, 2, bq)
    scale = d ** -0.5
    ws = torch.full(g.workspace_shape(h, sq, d), math.nan)
    dk = torch.zeros(b, hk, nk * bk, dp)
    dv = torch.zeros(b, hk, nk * bk, dp)
    for kt in range(nk):
        k0 = kt * bk
        Kt, Vt = K[:, :, None, k0:k0 + bk], V[:, :, None, k0:k0 + bk]
        keys = torch.arange(k0, k0 + bk)[:, None]
        for qt in range(g.first_q_tile(kt, causal), nq):
            q0 = qt * bq
            Qt, dOt = Q[..., q0:q0 + bq, :], dO[..., q0:q0 + bq, :]
            ls = stats[:, :, :, qt, 0, None, :]
            dl = stats[:, :, :, qt, 1, None, :]
            st = Kt @ Qt.transpose(-1, -2)             # [.., keys, rows]
            dpt = Vt @ dOt.transpose(-1, -2)
            qpos = torch.arange(q0, q0 + bq)[None, :]
            mask = (qpos < sq) & (keys < sk)
            if causal:
                mask = mask & (qpos >= keys)
            p = torch.where(mask, torch.exp2(st * scale * LOG2E
                                             - ls * LOG2E), 0.0)
            ds = p * (dpt - dl) * scale
            pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
            dv[:, :, k0:k0 + bk] += (pb @ dOt).sum(2)
            dk[:, :, k0:k0 + bk] += (dsb @ Qt).sum(2)
            dq_tile = (dsb.transpose(-1, -2) @ Kt).reshape(b, h, bq, dp)
            n = min(bq, sq - q0)
            ws[kt, :, :, q0:q0 + n] = dq_tile[:, :, :n, :d]
    dq = torch.zeros(b, h, sq, d)
    for qt in range(nq):
        rows = slice(qt * bq, min(sq, (qt + 1) * bq))
        for kt in range(g.last_slot(qt, causal) + 1):
            dq[:, :, rows] = dq[:, :, rows] + ws[kt, :, :, rows]
    grads = (dq.bfloat16(), dk[:, :, :sk, :d].bfloat16(),
             dv[:, :, :sk, :d].bfloat16())
    if layout == "bshd":
        grads = tuple(t.transpose(1, 2) for t in grads)
    return grads


def _inputs(seed, b, sq, sk, h, hk, d, layout):
    """q, k, v and the output gradient as numpy f32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(_shape(b, s, n, d, layout), np.float32)
            for s, n in ((sq, h), (sk, hk), (sk, hk), (sq, h))]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(t):
    return t.float().numpy()


EMULATED = {
    # name: (seed, b, sq, sk, h, hk, d, causal, layout)
    "training_tiles": (1, 1, 300, 300, 2, 2, 64, True, "bshd"),
    "gqa_8_2": (2, 1, 200, 200, 8, 2, 64, True, "bhsd"),
    "d48_padded": (3, 2, 150, 150, 2, 1, 48, True, "bshd"),
    "d80_padded_gqa": (4, 1, 200, 200, 4, 2, 80, True, "bhsd"),
    "sq_gt_sk": (5, 1, 300, 100, 2, 2, 64, True, "bshd"),
    "sq_lt_sk_dense_d128": (6, 1, 100, 300, 2, 2, 128, False, "bshd"),
}


def _emulated_and_plain(case):
    seed, b, sq, sk, h, hk, d, causal, layout = EMULATED[case]
    x = _inputs(seed, b, sq, sk, h, hk, d, layout)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in x)
    o, lse = F.flash_attention_fwd_lse_reference(q, k, v, causal=causal,
                                                 layout=layout)
    emu = _emulate(q, k, v, o, lse, do, causal, layout)
    return x, (o, lse), emu


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_kernel_matches_plain_version(case):
    seed, b, sq, sk, h, hk, d, causal, layout = EMULATED[case]
    x, (o, lse), emu = _emulated_and_plain(case)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in x)
    ref = F.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                          causal=causal, layout=layout)
    for name, a, r in zip(("dq", "dk", "dv"), emu, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel(_np(a), _np(r)) <= RTOL_BF16, name


def _pallas_bwd(x, o, lse, causal, blk_q, blk_k, dtype):
    """The JAX package's Pallas backward (interpret mode) as
    ``flash_attention_pallas`` runs it under grad, on bshd numpy inputs:
    K/V expanded by ``jnp.repeat`` (GQA), the custom VJP's residuals
    (heads-major, rows zero-padded to the blocks; o and the lse from the
    port's plain forward), ``_bwd``, and dk/dv summed back over each
    group. Returns numpy (dq, dk, dv)."""
    q, k, v, g = (jnp.asarray(a, dtype) for a in x)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    ek, ev = (jnp.repeat(a, h // hk, axis=2) for a in (k, v))
    bq, bk = min(blk_q, max(sq, 8)), min(blk_k, max(sk, 8))

    def heads(a, blk):
        return jax_flash._pad_seq(jnp.transpose(a, (0, 2, 1, 3)), blk)

    op = heads(jnp.asarray(_np(o), dtype), bq)
    lp = jax_flash._pad_seq(jnp.asarray(lse.numpy())[..., None], bq)
    res = (heads(q, bq), heads(ek, bk), heads(ev, bk), op, lp, sq, sk)
    dq, dk, dv = jax_flash._bwd(res, g, causal=causal, blk_q=blk_q,
                                blk_k=blk_k, interpret=True)
    dk, dv = (a.reshape(b, sk, hk, h // hk, d).sum(3) for a in (dk, dv))
    return tuple(np.asarray(a, np.float32) for a in (dq, dk, dv))


@pytest.mark.parametrize("case", ["training_tiles", "d80_padded_gqa"])
def test_emulated_kernel_matches_pallas_at_its_tiles(case):
    seed, b, sq, sk, h, hk, d, causal, layout = EMULATED[case]
    x, (o, lse), emu = _emulated_and_plain(case)
    if layout == "bhsd":   # the Pallas helper takes bshd
        x = [a.transpose(0, 2, 1, 3) for a in x]
        o = o.transpose(1, 2)
        emu = tuple(t.transpose(1, 2) for t in emu)
    bq = 8192 // (64 if d <= 64 else 128)
    jg = _pallas_bwd(x, o, lse, causal, bq, 128, jnp.bfloat16)
    for name, a, r in zip(("dq", "dk", "dv"), emu, jg):
        assert a.shape == r.shape, name
        assert _rel(_np(a), r) <= RTOL_BF16, name


UNEQUAL = {
    # name: (seed, sq, sk, causal); b 1, h 2, d 64, bshd, f32
    "causal_sq_gt_sk": (11, 300, 100, True),
    "causal_sq_lt_sk": (12, 100, 300, True),
    "dense_sq_gt_sk": (13, 300, 100, False),
}
_PALLAS_UNEQUAL = {}


def _unequal(case):
    """(inputs, o, lse, Pallas gradients) of one unequal-length case in
    f32, the Pallas backward run once per case."""
    if case not in _PALLAS_UNEQUAL:
        seed, sq, sk, causal = UNEQUAL[case]
        x = _inputs(seed, 1, sq, sk, 2, 2, 64, "bshd")
        q, k, v = (torch.from_numpy(a) for a in x[:3])
        o, lse = F.flash_attention_fwd_lse_reference(q, k, v, causal=causal)
        jg = _pallas_bwd(x, o, lse, causal, 512, 512, jnp.float32)
        _PALLAS_UNEQUAL[case] = (x, o, lse, jg)
    return _PALLAS_UNEQUAL[case]


@pytest.mark.parametrize("route", ["plain", "fused", "split"])
@pytest.mark.parametrize("case", sorted(UNEQUAL))
def test_unequal_lengths_match_pallas(case, route):
    x, o, lse, jg = _unequal(case)
    causal = UNEQUAL[case][3]
    fn = {"plain": F.flash_attention_bwd_reference,
          "fused": F.flash_attention_bwd_fused,
          "split": F.flash_attention_bwd_split}[route]
    q, k, v, do = (torch.from_numpy(a) for a in x)
    got = fn(q, k, v, o, lse, do, causal=causal)
    for name, a, r in zip(("dq", "dk", "dv"), got, jg):
        assert a.shape == r.shape and a.dtype == torch.float32, name
        np.testing.assert_allclose(_np(a), r, atol=ATOL_GRAD, rtol=0,
                                   err_msg=name)


# ------------------------------------------- the dq workspace's cap

CAP = 256 * 1024 * 1024


def _meta(b, sq, sk, h, hk, d, dtype):
    """Meta tensors of a bshd call and its dq/dk/dv: shapes and strides
    only, nothing allocated."""
    q, do, dq = (torch.empty((b, sq, h, d), dtype=dtype, device="meta")
                 for _ in range(3))
    k, v, dk, dv = (torch.empty((b, sk, hk, d), dtype=dtype, device="meta")
                    for _ in range(4))
    return q, k, v, do, dq, dk, dv


@pytest.mark.parametrize("b,sq,sk,h,hk,d,dtype", [
    (32, 10752, 10752, 12, 12, 64, torch.bfloat16),
    (8, 1023, 1023, 12, 12, 64, torch.bfloat16),
    (8, 1023, 1023, 12, 12, 64, torch.float32),
    (2, 300, 100, 8, 2, 48, torch.bfloat16),
    (3, 100, 300, 4, 1, 80, torch.float32)])
def test_workspace_bytes_are_the_geometrys(b, sq, sk, h, hk, d, dtype):
    geom = F.bwd_geometry(*_meta(b, sq, sk, h, hk, d, dtype), 1, 2)
    assert F.fused_bwd_workspace_bytes(b, h, sq, sk, d, dtype) == \
        4 * math.prod(geom.workspace_shape(h, sq, d))


@pytest.mark.parametrize("b,s,dtype,gb,route", [
    # 88.8 GB uncapped, more than the card holds.
    (32, 10752, torch.bfloat16, 88.8, "split"),
    # 3.2 GB: the reference's rule takes the fused kernel, the cap not.
    (2, 8192, torch.bfloat16, 3.2, "split"),
    # The training shape: 0.2 GB, the fused kernel as before the cap.
    (8, 1023, torch.bfloat16, 0.2, "fused"),
    # f32 takes 64-key tiles: twice the slots, 0.4 GB.
    (8, 1023, torch.float32, 0.4, "split"),
    (1, 2048, torch.bfloat16, 0.1, "fused"),
    # Past the reference's 12 MiB rule, whatever the workspace.
    (1, 16384, torch.bfloat16, 6.4, "split")])
def test_route_at_the_shapes_that_matter(b, s, dtype, gb, route):
    assert F._FUSED_BWD_WORKSPACE_BYTES == CAP
    h, d = 12, 64
    nbytes = F.fused_bwd_workspace_bytes(b, h, s, s, d, dtype)
    assert round(nbytes / 1e9, 1) == gb
    assert F.bwd_route(b, h, s, s, d, dtype, 512) == route
    fits = F._fused_bwd_fits(F._padded(s, 512), F._padded(s, 512), d,
                             torch.empty((), dtype=dtype).element_size())
    assert fits == (s < 16384)
    assert route == ("fused" if fits and nbytes <= CAP else "split")


@pytest.mark.parametrize("over", [False, True])
def test_flash_attention_takes_the_named_route(monkeypatch, over):
    """With the cap one byte under the call's workspace the backward
    takes the split kernels, at the workspace the fused one; either way
    the gradients are the plain version's."""
    b, s, h, hk, d = 2, 40, 4, 2, 16
    x = _inputs(22, b, s, s, h, hk, d, "bshd")
    q, k, v, g = (torch.from_numpy(a) for a in x)
    nbytes = F.fused_bwd_workspace_bytes(b, h, s, s, d, q.dtype)
    monkeypatch.setattr(F, "_FUSED_BWD_WORKSPACE_BYTES", nbytes - over)
    taken = []
    for name in ("flash_attention_bwd_fused", "flash_attention_bwd_split"):
        fn = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _n=name, _f=fn, **kw: (
            taken.append(_n), _f(*a, **kw))[1])
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    F.FlashAttention.apply(qs, ks, vs, True, "bshd", 512).backward(g)
    assert taken == ["flash_attention_bwd_" + ("split" if over else "fused")]
    o, lse = F.flash_attention_fwd_lse_reference(q, k, v)
    ref = F.flash_attention_bwd_reference(q, k, v, o, lse, g)
    for name, a, r in zip(("dq", "dk", "dv"), (qs.grad, ks.grad, vs.grad),
                          ref):
        np.testing.assert_allclose(_np(a), _np(r), atol=1e-6, rtol=0,
                                   err_msg=name)
