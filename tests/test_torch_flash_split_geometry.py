"""The split flash backward's launch geometry (ray_tpu_torch/ops/flash.py
``bwd_geometry`` routes "dq" and "kv") and the loops of its two bf16
kernels, on the CPU.

The bf16 split backward (ops/csrc/flash_bwd.cu) is two Hopper kernels.
The dk/dv kernel (``flash_bwd_dkv_wgmma_kernel``) is the fused kernel
without its dq: one CTA per (kv head, batch, 128-key tile) walking the q
tiles of 8192 / DP rows from the causal diagonal down, its LSE and Δ
from the zero-padded ``row_stats`` buffer. The dq kernel
(``flash_bwd_dq_wgmma_kernel``) has the forward's structure with a known
LSE: one CTA per (head, batch, 128-row q tile) walking the key tiles of
8192 / DP keys up to the reference's ``upper``, writing dq once. Both
load Q, K, V and dO with TMA through one tensor map each, over the 4-D
view (d, heads, seq, batch) with the tensors' own byte strides, the
head dim padded to DP = 64 or 128. All of that is computed in Python and
handed to the C entry points as one int64 array each, so it is tested
here without a card: the maps address every element where torch has it
and meet TMA's rules, the CTAs cover every dq row and every key, and
each CTA's first and last tile are the reference's ``lower`` and
``upper`` when the kernels' BQ and BK differ. An emulation of each
kernel's loop on the CPU, driven by the same geometry (its tiles, exp2
with the log2(e) scale, dS and P rounded to bf16, the group sum of dK
and dV), is held against the plain version and against the JAX
package's Pallas split backward in interpret mode at the kernels' tiles:
bf16 gradients by relative norm error 3e-2, as chip_smoke.py holds the
kernels on the card.
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


def _empty(b, sq, sk, h, hk, d, layout, dtype=torch.bfloat16):
    q, do = (torch.empty(_shape(b, sq, h, d, layout), dtype=dtype)
             for _ in range(2))
    k, v = (torch.empty(_shape(b, sk, hk, d, layout), dtype=dtype)
            for _ in range(2))
    return q, k, v, do


def _geometry(q, k, v, do, layout, route):
    """The wrapper's operands and one split kernel's geometry for them."""
    s_ax, h_ax = F._split(layout)
    q, k, v, do = F._kernel_operands(
        (("q", q), ("k", k), ("v", v), ("do", do)), q.dtype, q.device,
        q.shape[-1])
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    return (F.bwd_geometry(q, k, v, do, dq, dk, dv, s_ax, h_ax, route=route),
            (q, k, v, do, dq, dk, dv))


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
    assert m.box == (64, 1, rows, 1) and rows <= 256   # TMA's box limit
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


def _tiles(route, dp):
    """(BQ, BK) of a split kernel at padded head dim dp."""
    return (128, 8192 // dp) if route == "dq" else (8192 // dp, 128)


@pytest.mark.parametrize("route", ["dq", "kv"])
@pytest.mark.parametrize("layout,d", [("bshd", 64), ("bhsd", 64),
                                      ("bshd", 48), ("bhsd", 48),
                                      ("bshd", 80), ("bhsd", 80),
                                      ("bshd", 128), ("bhsd", 128)])
def test_split_geometry_maps_and_tiles(layout, d, route):
    b, s, h = 2, 1023, 3
    g, (q, k, v, do, dq, dk, dv) = _geometry(
        *_empty(b, s, s, h, h, d, layout), layout, route)
    dp = 64 if d <= 64 else 128
    bq, bk = _tiles(route, dp)
    assert (g.head_dim_padded, g.block_q, g.block_k) == (dp, bq, bk)
    assert g.q_tiles == math.ceil(s / bq) and g.slots == math.ceil(s / bk)
    assert g.grid == ((h, b, g.q_tiles) if route == "dq" else
                      (h, b, g.slots))
    for m, t, rows in zip(g.maps, (q, k, v, do), (bq, bk, bk, bq)):
        _check_map(m, t, layout, rows)
    s_ax, h_ax = F._split(layout)
    assert g.strides == tuple(x for t in (q, k, v, do, dq, dk, dv) for x in (
        t.stride(0), t.stride(h_ax), t.stride(s_ax)))
    arr = g.to_array()
    assert len(arr) == F.BWD_GEOM_LEN and all(isinstance(x, int)
                                              for x in arr)
    assert arr[:9] == [dp, bq, bk, *g.grid, b, g.q_tiles, g.slots]
    assert arr[9:30] == list(g.strides)
    for i, m in enumerate(g.maps):
        assert arr[30 + 11 * i:41 + 11 * i] == [*m.dims, *m.strides, *m.box]


@pytest.mark.parametrize("route", ["dq", "kv"])
@pytest.mark.parametrize("sq,sk,layout", [(300, 100, "bhsd"),
                                          (100, 300, "bshd")])
def test_split_geometry_gqa_unequal_lengths(sq, sk, layout, route):
    g, (q, k, v, do, *_) = _geometry(*_empty(2, sq, sk, 8, 2, 128, layout),
                                     layout, route)
    bq, bk = _tiles(route, 128)
    assert g.grid == ((8, 2, math.ceil(sq / bq)) if route == "dq" else
                      (2, 2, math.ceil(sk / bk)))
    assert g.maps[0].dims == g.maps[3].dims == (128, 8, sq, 2)
    assert g.maps[1].dims == g.maps[2].dims == (128, 2, sk, 2)
    for m, t, rows in zip(g.maps, (q, k, v, do), (bq, bk, bk, bq)):
        _check_map(m, t, layout, rows)


@pytest.mark.parametrize("route", ["dq", "kv"])
def test_f32_split_geometry_is_the_cuda_core_kernels(route):
    g, _ = _geometry(*_empty(2, 1000, 300, 4, 2, 48, "bshd",
                             torch.float32), "bshd", route)
    assert (g.head_dim_padded, g.block_q, g.block_k) == (48, 64, 64)
    assert (g.q_tiles, g.slots, g.batch) == (16, 5, 2)
    assert g.grid == ((16, 4, 2) if route == "dq" else (5, 2, 2))
    assert g.maps == () and g.to_array()[30:] == [0] * 44


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="route"):
        _geometry(*_empty(1, 64, 64, 2, 2, 64, "bshd"), "bshd", "split")


def _reference_upper(qi, blk_q, blk_k, nk, causal):
    """``_bwd_dq_kernel``'s walk (ray_tpu/ops/pallas/flash.py)."""
    if not causal:
        return nk
    return min(((qi + 1) * blk_q + blk_k - 1) // blk_k, nk)


def _reference_lower(ki, blk_q, blk_k, causal):
    """``_bwd_dkv_kernel``'s first q block."""
    return (ki * blk_k) // blk_q if causal else 0


@pytest.mark.parametrize("sq,sk,d,causal", [(1023, 1023, 64, True),
                                            (1023, 1023, 128, True),
                                            (300, 100, 128, True),
                                            (100, 300, 80, True),
                                            (300, 100, 48, False),
                                            (129, 129, 128, False)])
def test_ctas_cover_rows_and_keys_and_walk_the_references_tiles(
        sq, sk, d, causal):
    gq, _ = _geometry(*_empty(1, sq, sk, 2, 2, d, "bshd"), "bshd", "dq")
    gk, _ = _geometry(*_empty(1, sq, sk, 2, 2, d, "bshd"), "bshd", "kv")
    if d > 64:   # DP 128: the kernels' BQ and BK differ
        assert gq.block_q != gq.block_k and gk.block_q != gk.block_k
    # The dq CTAs (the grid's slowest axis) own every dq row once; the
    # dk/dv CTAs every key once.
    rows = [r for qt in range(gq.grid[2])
            for r in range(qt * gq.block_q, (qt + 1) * gq.block_q) if r < sq]
    assert rows == list(range(sq))
    keys = [c for kt in range(gk.grid[2])
            for c in range(kt * gk.block_k, (kt + 1) * gk.block_k) if c < sk]
    assert keys == list(range(sk))
    visible = (torch.arange(sq)[:, None] >= torch.arange(sk)[None, :]) \
        if causal else torch.ones(sq, sk, dtype=torch.bool)
    for qt in range(gq.q_tiles):
        upper = gq.last_slot(qt, causal) + 1
        assert upper == _reference_upper(qt, gq.block_q, gq.block_k,
                                         gq.slots, causal)
        # Every key tile past the walk is invisible to the tile's rows.
        r = slice(qt * gq.block_q, (qt + 1) * gq.block_q)
        assert not visible[r, upper * gq.block_k:].any()
    for kt in range(gk.slots):
        lower = gk.first_q_tile(kt, causal)
        assert lower == _reference_lower(kt, gk.block_q, gk.block_k, causal)
        c = slice(kt * gk.block_k, (kt + 1) * gk.block_k)
        assert not visible[:lower * gk.block_q, c].any()


def _pad(t, rows, dp):
    """[b, n, s, d] -> f32, head dim padded to dp, rows to ``rows``: the
    tiles as TMA's zero fill leaves them."""
    return torch.nn.functional.pad(t.float(), (0, dp - t.shape[-1], 0,
                                               rows - t.shape[2]))


def _heads_major(layout, *ts):
    return tuple(t.transpose(1, 2) if layout == "bshd" else t for t in ts)


def _emulate_dq(q, k, v, o, lse, do, causal, layout):
    """The bf16 dq kernel on the CPU, from route "dq": per q tile (its
    CTA; the two consumers' 64-row halves are independent), the key
    tiles 0 .. last_slot: S = Q K^T and dP = dO V^T in f32 over the
    zero-padded tiles; P = exp2(S scale log2e - lse log2e) with the LSE
    of rows past sq read as 0, masked where the key is past sk or
    (causal) after the row; dS = P (dP - Δ) scale rounded to bf16; dQ +=
    dS K; dq written once in bf16."""
    g, _ = _geometry(q, k, v, do, layout, "dq")
    s_ax, h_ax = F._split(layout)
    delta = F._delta(o, do, h_ax)
    q, k, v, do = _heads_major(layout, q, k, v, do)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dp, bq, bk = g.head_dim_padded, g.block_q, g.block_k
    Q, dO = (_pad(t, g.q_tiles * bq, dp) for t in (q, do))
    K, V = (_pad(t, g.slots * bk, dp).repeat_interleave(h // hk, dim=1)
            for t in (k, v))
    rows_pad = (0, g.q_tiles * bq - sq)
    ls = torch.nn.functional.pad(lse, rows_pad)[..., None] * LOG2E
    dl = torch.nn.functional.pad(delta, rows_pad)[..., None]
    scale = d ** -0.5
    dq = torch.full((b, h, g.q_tiles * bq, dp), math.nan)
    for qt in range(g.q_tiles):
        r = slice(qt * bq, (qt + 1) * bq)
        row = torch.arange(qt * bq, (qt + 1) * bq)[:, None]
        acc = torch.zeros(b, h, bq, dp)
        for kt in range(g.last_slot(qt, causal) + 1):
            c = slice(kt * bk, (kt + 1) * bk)
            key = torch.arange(kt * bk, (kt + 1) * bk)[None, :]
            s = Q[:, :, r] @ K[:, :, c].transpose(-1, -2)
            dpm = dO[:, :, r] @ V[:, :, c].transpose(-1, -2)
            p = torch.exp2(s * scale * LOG2E - ls[:, :, r])
            mask = key < sk
            if causal:
                mask = mask & (key <= row)
            p = torch.where(mask, p, 0.0)
            ds = (p * (dpm - dl[:, :, r]) * scale).bfloat16().float()
            acc = acc + ds @ K[:, :, c]
        dq[:, :, r] = acc
    out = dq[:, :, :sq, :d].bfloat16()
    return out.transpose(1, 2) if layout == "bshd" else out


def _emulate_dkv(q, k, v, o, lse, do, causal, layout):
    """The bf16 dk/dv kernel on the CPU, from route "kv": per key tile
    (its CTA), per query head of the group and q tile from ``first_q_tile``
    down, S^T = K Q^T and dP^T = V dO^T in f32 over the zero-padded tiles;
    P^T = exp2(S^T scale log2e - lse log2e) with the tile's LSE and Δ
    from ``row_stats``, masked past sq and sk and above the diagonal;
    dS^T = P^T (dP^T - Δ) scale; P and dS rounded to bf16; dV += P^T dO
    and dK += dS^T Q summed over the group; a key tile that walks no q
    tile writes zeros."""
    g, _ = _geometry(q, k, v, do, layout, "kv")
    s_ax, h_ax = F._split(layout)
    delta = F._delta(o, do, h_ax)
    q, k, v, do = _heads_major(layout, q, k, v, do)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    grp = h // hk
    dp, bq, bk = g.head_dim_padded, g.block_q, g.block_k
    Q, dO = (_pad(t, g.q_tiles * bq, dp).view(b, hk, grp, -1, dp)
             for t in (q, do))
    K, V = (_pad(t, g.slots * bk, dp) for t in (k, v))
    stats = F.row_stats(lse, delta, bq).view(b, hk, grp, g.q_tiles, 2, bq)
    scale = d ** -0.5
    dk = torch.full((b, hk, g.slots * bk, dp), math.nan)
    dv = torch.full((b, hk, g.slots * bk, dp), math.nan)
    for kt in range(g.slots):
        c = slice(kt * bk, (kt + 1) * bk)
        Kt, Vt = K[:, :, None, c], V[:, :, None, c]
        key = torch.arange(kt * bk, (kt + 1) * bk)[:, None]
        dk_t = torch.zeros(b, hk, bk, dp)
        dv_t = torch.zeros(b, hk, bk, dp)
        for qt in range(g.first_q_tile(kt, causal), g.q_tiles):
            r = slice(qt * bq, (qt + 1) * bq)
            Qt, dOt = Q[..., r, :], dO[..., r, :]
            ls = stats[:, :, :, qt, 0, None, :]
            dl = stats[:, :, :, qt, 1, None, :]
            st = Kt @ Qt.transpose(-1, -2)              # [.., keys, rows]
            dpt = Vt @ dOt.transpose(-1, -2)
            row = torch.arange(qt * bq, (qt + 1) * bq)[None, :]
            mask = (row < sq) & (key < sk)
            if causal:
                mask = mask & (row >= key)
            p = torch.where(mask, torch.exp2(st * scale * LOG2E
                                             - ls * LOG2E), 0.0)
            ds = p * (dpt - dl) * scale
            pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
            dv_t += (pb @ dOt).sum(2)
            dk_t += (dsb @ Qt).sum(2)
        dk[:, :, c], dv[:, :, c] = dk_t, dv_t
    grads = (dk[:, :, :sk, :d].bfloat16(), dv[:, :, :sk, :d].bfloat16())
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
    "training_tiles": (21, 1, 300, 300, 2, 2, 64, True, "bshd"),
    "causal_sq_gt_sk": (22, 1, 300, 100, 2, 2, 64, True, "bshd"),
    "dense_sq_lt_sk_d128": (23, 1, 100, 300, 2, 2, 128, False, "bshd"),
    "gqa_8_2": (24, 1, 200, 200, 8, 2, 64, True, "bhsd"),
    "d48_padded": (25, 2, 150, 150, 2, 1, 48, True, "bshd"),
    # Causal sq 100 < sk 300: key tiles 1 and 2 (keys 128..299) are seen
    # by no query row.
    "d80_padded_unseen_keys": (26, 1, 100, 300, 4, 2, 80, True, "bhsd"),
}
_RUNS = {}


def _emulated(case):
    """(inputs, (o, lse), (dq, dk, dv) of the emulations), once a case."""
    if case not in _RUNS:
        seed, b, sq, sk, h, hk, d, causal, layout = EMULATED[case]
        x = _inputs(seed, b, sq, sk, h, hk, d, layout)
        q, k, v, do = (torch.from_numpy(a).bfloat16() for a in x)
        o, lse = F.flash_attention_fwd_lse_reference(q, k, v, causal=causal,
                                                     layout=layout)
        args = (q, k, v, o, lse, do, causal, layout)
        _RUNS[case] = (x, (o, lse), (_emulate_dq(*args),
                                     *_emulate_dkv(*args)))
    return _RUNS[case]


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_split_kernels_match_plain_version(case):
    seed, b, sq, sk, h, hk, d, causal, layout = EMULATED[case]
    x, (o, lse), emu = _emulated(case)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in x)
    ref = F.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                          causal=causal, layout=layout)
    for name, a, r in zip(("dq", "dk", "dv"), emu, ref):
        assert a.shape == r.shape and a.dtype == r.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert _rel(_np(a), _np(r)) <= RTOL_BF16, name
    if case == "d80_padded_unseen_keys":
        s_ax = 1 if layout == "bshd" else 2
        for name, a, r in zip(("dk", "dv"), emu[1:], ref[1:]):
            unseen = a.narrow(s_ax, 128, sk - 128)
            assert not unseen.any() and not r.narrow(s_ax, 128,
                                                     sk - 128).any(), name


def _pallas_split(x, o, lse, causal, blk_q, blk_k, monkeypatch):
    """The JAX package's Pallas split backward (interpret mode, the
    fused branch's budget forced to 0) on bshd numpy inputs at blocks
    (blk_q, blk_k): K/V expanded by ``jnp.repeat`` (GQA), the custom
    VJP's residuals (heads-major, rows zero-padded to the blocks; o and
    the lse from the port's plain forward), ``_bwd``, and dk/dv summed
    back over each group. Returns numpy (dq, dk, dv)."""
    monkeypatch.setattr(jax_flash, "_FUSED_BWD_VMEM_BUDGET", 0)
    q, k, v, g = (jnp.asarray(a, jnp.bfloat16) for a in x)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    ek, ev = (jnp.repeat(a, h // hk, axis=2) for a in (k, v))
    bq, bk = min(blk_q, max(sq, 8)), min(blk_k, max(sk, 8))

    def heads(a, blk):
        return jax_flash._pad_seq(jnp.transpose(a, (0, 2, 1, 3)), blk)

    op = heads(jnp.asarray(_np(o), jnp.bfloat16), bq)
    lp = jax_flash._pad_seq(jnp.asarray(lse.numpy())[..., None], bq)
    res = (heads(q, bq), heads(ek, bk), heads(ev, bk), op, lp, sq, sk)
    dq, dk, dv = jax_flash._bwd(res, g, causal=causal, blk_q=blk_q,
                                blk_k=blk_k, interpret=True)
    dk, dv = (a.reshape(b, sk, hk, h // hk, d).sum(3) for a in (dk, dv))
    return tuple(np.asarray(a, np.float32) for a in (dq, dk, dv))


@pytest.mark.parametrize("case", ["training_tiles", "d80_padded_unseen_keys"])
def test_emulated_split_kernels_match_pallas_at_their_tiles(case,
                                                            monkeypatch):
    """Each kernel against the Pallas split kernel of its gradients at
    its own tiles: at DP 64 both are 128 x 128; at DP 128 the dq kernel's
    (BQ 128, BK 64) and the dk/dv kernel's (BQ 64, BK 128)."""
    seed, b, sq, sk, h, hk, d, causal, layout = EMULATED[case]
    x, (o, lse), emu = _emulated(case)
    if layout == "bhsd":   # the Pallas helper takes bshd
        x = [a.transpose(0, 2, 1, 3) for a in x]
        o = o.transpose(1, 2)
        emu = tuple(t.transpose(1, 2) for t in emu)
    dp = 64 if d <= 64 else 128
    tiles = {"dq": (128, 8192 // dp), "kv": (8192 // dp, 128)}
    jq = _pallas_split(x, o, lse, causal, *tiles["dq"], monkeypatch)
    jkv = jq if tiles["dq"] == tiles["kv"] else _pallas_split(
        x, o, lse, causal, *tiles["kv"], monkeypatch)
    for name, a, r in zip(("dq", "dk", "dv"), emu,
                          (jq[0], jkv[1], jkv[2])):
        assert a.shape == r.shape, name
        assert _rel(_np(a), r) <= RTOL_BF16, name
