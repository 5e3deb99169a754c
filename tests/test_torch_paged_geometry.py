"""The paged decode/verify kernels' launch geometry
(ray_tpu_torch/ops/paged_decode.py ``decode_geometry``) and the
arithmetic of the split and combine kernels, on the CPU.

ops/csrc/paged_decode.cu splits each sequence's keys across CTAs:
``paged_decode_split_kernel`` takes ``chunk_blocks`` pool blocks of one
sequence, copies their K and V rows into a ring of stages with bulk
asynchronous copies (one per pool block, or per piece of a block longer
than a stage), and walks them with ``lanes`` threads a key row, each lane
group keeping its own online softmax; the groups merge by xor shuffles
inside a warp and in warp order across warps, and the CTA writes (acc,
m, l) of each row to its slot of an f32 workspace.
``paged_decode_combine_kernel`` reads a row's slots in increasing split
order. All of the launch is computed in Python, so it is tested here
without a card: the splits and stages cover every key of every context
exactly once and stop at ceil(ctx / block_size), chunks are whole
blocks, shared memory fits, every bulk copy's source, destination and
size are 16-byte multiples, and the workspace has one slot per split
and row. An emulation of the two kernels, driven by the same geometry
(the stages as the copies lay them out, the lane groups' key order and
one max and rescale a step of several keys, p rounded to the value
dtype before P.V, exp2 of scores in log2 units,
the xor merge, the warp order and the split order), starts from a NaN
workspace and is held against the plain version and against the JAX
package's Pallas kernel in interpret mode, with the reference's
tolerances (f32 atol 2e-5, bf16 2e-2), at the edge cases: a context of
1 on the scratch block, contexts at and one past a chunk boundary, a
full table, verify with q_lens < q_len, and verify rows whose bound
ends a chunk early.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.pallas.paged_decode import (
    paged_decode_attention as jax_paged_decode,
    paged_verify_attention as jax_paged_verify,
)
from ray_tpu_torch.ops import paged_decode as P

torch.set_num_threads(1)

ATOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
WARPS = 4
MAX_SMEM = 227 * 1024
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


def _geom(b, hkv, rows, d, bs, max_nb, dtype="bf16", num_blocks=None):
    isz = torch.empty((), dtype=DTYPES[dtype]).element_size()
    return P.decode_geometry(b, hkv, rows, d, bs, max_nb,
                             num_blocks or b * max_nb + 1, isz)


# ---------------------------------------------------------------- geometry

def _check_cover(g, ctx):
    """Splits and stages cover keys [0, min(ctx, max_nb * bs)) once, in
    order, in whole-block chunks; every copy is 16-byte aligned and
    stays inside its block and its stage."""
    bs, rb = g.block_size, g.row_bytes
    nblk = min(-(-ctx // bs), g.max_nb)
    ns = g.n_splits(ctx)
    assert ns == -(-nblk // g.chunk_blocks) <= g.max_splits
    seen = []
    for s in range(ns):
        k0, k1 = g.split_keys(ctx, s)
        assert k0 == s * g.chunk_blocks * bs and k0 < k1
        assert k1 - k0 <= g.chunk_blocks * bs
        tiles = g.tiles(ctx, s)
        assert tiles[0][0] == k0 and tiles[-1][1] == k1
        for x0, x1 in tiles:
            assert 0 < x1 - x0 <= g.tile_keys
            seen.extend(range(x0, x1))
            at = 0
            for j, off, n, dst in g.copies(x0, x1):
                assert k0 // bs <= j < nblk and 0 <= off and off + n <= bs
                assert dst == at and dst % 16 == 0 and (n * rb) % 16 == 0
                # The source: pool block [h, pb] is bs x d contiguous.
                for pb in (0, g.num_blocks - 1):
                    for h in (0, g.kv_heads - 1):
                        src = ((h * g.num_blocks + pb) * bs + off) * rb
                        assert src % 16 == 0
                at += n * rb
            assert at == (x1 - x0) * rb <= g.tile_keys * rb
    assert seen == list(range(min(ctx, nblk * bs)))
    # A split past the context is empty: its CTA exits at once.
    assert g.n_splits(ctx) == len([s for s in range(g.max_splits)
                                   if s * g.chunk_blocks < nblk])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bs", [8, 16, 32, 128])
def test_splits_cover_every_key_once(bs, dtype):
    max_nb = max(3, 1100 // bs)
    for d in (16, 64, 128, 256):
        for group in (1, 2, 4, 8):
            for q_len in (1, 4):
                rows = group * q_len
                g = _geom(3, 2, rows, d, bs, max_nb, dtype)
                assert g.chunk_blocks % g.tile_blocks == 0
                assert (g.chunk_blocks * bs) % bs == 0 and g.chunk_blocks >= 1
                assert g.smem_bytes <= MAX_SMEM
                assert 1 <= g.stages <= min(4, g.chunk_blocks //
                                            g.tile_blocks * g.pieces)
                assert g.merge_off >= g.stages * g.stage_bytes
                assert g.table_off - g.merge_off == \
                    WARPS * g.row_tile * (d + 2) * 4
                assert g.bar_off >= g.table_off + 4 * g.chunk_blocks
                assert g.merge_off % 16 == 0 and g.bar_off % 8 == 0
                assert g.row_tile * g.row_tiles >= rows > \
                    g.row_tile * (g.row_tiles - 1)
                assert g.workspace_shape == (3, 2, g.max_splits, rows, d + 2)
                assert g.grid == (g.max_splits, 2, 3 * g.row_tiles)
                assert g.max_splits == -(-max_nb // g.chunk_blocks)
                vec = 16 // g.itemsize
                assert g.lanes & (g.lanes - 1) == 0 and g.lanes <= 32
                assert g.lanes * g.vecs >= d // vec > g.lanes * (g.vecs - 1)
                chunk = g.chunk_blocks * bs
                for ctx in sorted({1, bs, bs + 1, chunk - 1, chunk,
                                   chunk + 1, 2 * chunk + 3,
                                   max_nb * bs - 1, max_nb * bs,
                                   max_nb * bs + 5}):
                    if ctx >= 1:
                        _check_cover(g, ctx)


def test_serving_shape_geometry():
    """b 8, 12 kv heads, d 64 bf16, block 16, max_nb 64: 128-key chunks
    of two 64-key stages, all of a chunk's copies in flight at once; 768
    CTAs, 480 live at contexts of 513."""
    g = _geom(8, 12, 1, 64, 16, 64)
    assert (g.chunk_blocks, g.tile_keys, g.stages, g.lanes) == (8, 64, 2, 8)
    assert g.grid == (8, 12, 8) and math.prod(g.grid) == 768
    assert g.stages == g.chunk_blocks // g.tile_blocks * g.pieces
    assert sum(g.n_splits(513) for _ in range(8)) * 12 == 480
    assert g.workspace_shape == (8, 12, 8, 1, 66)
    assert g.smem_bytes <= 48 * 1024   # several CTAs an SM


def _old_smem(rows, d, bs):
    """The shared memory rule of the earlier one-CTA-per-head kernel."""
    tk = max(1, 64 // bs) * bs
    return 4 * (2 * rows * d + tk * (d + 1) + tk * d + rows * tk + 3 * rows)


def test_geometry_takes_every_shape_the_earlier_kernel_took():
    n = 0
    for dtype in ("f32", "bf16"):
        vec = 16 // (4 if dtype == "f32" else 2)
        for d in range(vec, 257, vec):
            for bs in (1, 3, 16, 48, 64, 100, 112, 128, 1024, 2048):
                for rows in (1, 2, 5, 12, 32, 64):
                    if _old_smem(rows, d, bs) > MAX_SMEM:
                        continue
                    g = _geom(2, 2, rows, d, bs, 3, dtype)
                    assert g.smem_bytes <= MAX_SMEM
                    _check_cover(g, 3 * bs)
                    n += 1
    assert n > 1000


def test_long_blocks_are_copied_in_pieces():
    g = _geom(2, 1, 8, 256, 128, 3, "f32")
    assert g.pieces > 1 and g.tile_blocks == 1 and g.chunk_blocks == 1
    assert g.tile_keys * (g.pieces - 1) < 128 <= g.tile_keys * g.pieces
    assert g.stages >= 2 and g.smem_bytes <= MAX_SMEM
    assert g.tiles(200, 1) == [(128, 128 + g.tile_keys),
                               (128 + g.tile_keys, 200)]


def test_geometry_rejects_head_dims_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        _geom(1, 1, 1, 20, 16, 4, "bf16")      # not a multiple of 8
    with pytest.raises(ValueError):
        _geom(1, 1, 1, 264, 16, 4, "bf16")     # > 256
    g = _geom(1, 1, 1, 20, 16, 4, "f32")       # a multiple of 4: taken
    assert g.lanes == 8 and g.vecs == 1


def test_geometry_array_is_the_field_list():
    g = _geom(8, 12, 1, 64, 16, 64)
    arr = g.to_array()
    assert len(arr) == P.DECODE_GEOM_LEN
    assert all(isinstance(v, int) for v in arr)
    assert arr[:8] == [8, 12, 1, 64, 16, 64, 513, 2]
    assert arr[-1] == g.smem_bytes


# --------------------------------------------------------------- emulation

def _merge(m, l, acc, mo, lo, ao):
    """Two online-softmax states merged as the kernels merge them: the
    caller's own first; a state with m = -inf weighs 0."""
    mn = torch.maximum(m, mo)
    fin = torch.isfinite(mn)
    sa = torch.where(torch.isfinite(m), torch.exp2(m - torch.where(
        fin, mn, 0)), torch.zeros_like(m))
    sb = torch.where(torch.isfinite(mo), torch.exp2(mo - torch.where(
        fin, mn, 0)), torch.zeros_like(m))
    return mn, l * sa + lo * sb, acc * sa[..., None] + ao * sb[..., None]


def emulate(q, k_pool, v_pool, tables, lens, qlens, group, ws_out=None):
    """The split and combine kernels on the CPU. q: [b, hkv, rows, d] as
    the kernel reads it; returns the output in q's dtype."""
    b, hkv, rows, d = q.shape
    _, nbk, bs, _ = k_pool.shape
    g = P.decode_geometry(b, hkv, rows, d, bs, tables.shape[1], nbk,
                          q.element_size())
    kpw = 32 // g.lanes
    G = WARPS * kpw
    ks = g.keys_per_step
    scale = d ** -0.5 * LOG2E     # scores and m in log2 units, as the kernel
    vdt = v_pool.dtype
    ninf = float("-inf")
    ws = torch.full(g.workspace_shape, float("nan"))
    for bi in range(b):
        ctx, qn = int(lens[bi]), int(qlens[bi])
        bound = torch.tensor([min(ctx, ctx - qn + 1 + r // group)
                              for r in range(rows)])
        qf = q[bi].float()                                   # [h, r, d]
        for s in range(g.n_splits(ctx)):
            m = torch.full((hkv, G, rows), ninf)
            l = torch.zeros((hkv, G, rows))
            acc = torch.zeros((hkv, G, rows, d))
            for x0, x1 in g.tiles(ctx, s):
                n = x1 - x0
                K = torch.empty((hkv, n, d), dtype=vdt)
                V = torch.empty((hkv, n, d), dtype=vdt)
                for j, off, cnt, dst in g.copies(x0, x1):
                    at = dst // g.row_bytes
                    pb = int(tables[bi, j])
                    K[:, at:at + cnt] = k_pool[:, pb, off:off + cnt]
                    V[:, at:at + cnt] = v_pool[:, pb, off:off + cnt]
                # Step i: lane group kk of warp w takes keys
                # w * kpw * ks + i * G * ks + u * kpw + kk, u < ks.
                gidx = torch.arange(G)
                first = (gidx // kpw) * kpw * ks + gidx % kpw
                for i in range(-(-n // (G * ks))):
                    js = [first + i * G * ks + u * kpw for u in range(ks)]
                    scs, viss, vvs = [], [], []
                    for j in js:
                        jj = torch.clamp(j, max=n - 1)
                        kk, vv = K[:, jj].float(), V[:, jj].float()
                        scs.append(torch.einsum("hrd,hgd->hgr", qf, kk)
                                   * scale)
                        viss.append((j < n)[None, :, None] & (
                            (x0 + j)[None, :, None] < bound[None, None, :]))
                        vvs.append(vv)
                    mx = m
                    for sc, vis in zip(scs, viss):
                        mx = torch.where(vis, torch.maximum(mx, sc), mx)
                    upd = torch.isfinite(mx)
                    safe = torch.where(upd, mx, torch.zeros_like(mx))
                    corr = torch.exp2(m - safe)
                    psum = torch.zeros_like(l)
                    pvs = []
                    for sc, vis in zip(scs, viss):
                        p = torch.where(vis, torch.exp2(
                            torch.where(vis, sc, safe) - safe), 0.0)
                        psum = psum + p
                        pvs.append(p.to(vdt).float())
                    a = acc * corr[..., None]
                    for pv, vv in zip(pvs, vvs):
                        a = a + pv[..., None] * vv[:, :, None, :]
                    l = torch.where(upd, l * corr + psum, l)
                    acc = torch.where(upd[..., None], a, acc)
                    m = mx
            # Inside a warp: xor partners over the groups' index bits.
            off = 1
            while off < kpw:
                gidx = torch.arange(G)
                part = (gidx // kpw) * kpw + ((gidx % kpw) ^ off)
                m, l, acc = _merge(m, l, acc, m[:, part], l[:, part],
                                   acc[:, part])
                off *= 2
            # Across warps, in warp order, from each warp's group 0.
            heads = [w * kpw for w in range(WARPS)]
            mw = torch.stack([m[:, i] for i in heads]).amax(0)   # [h, r]
            acc_s = torch.zeros((hkv, rows, d))
            l_s = torch.zeros((hkv, rows))
            for i in heads:
                si = torch.where(torch.isfinite(m[:, i]), torch.exp2(
                    m[:, i] - torch.where(torch.isfinite(mw), mw, 0)),
                    torch.zeros_like(mw))
                acc_s = acc_s + acc[:, i] * si[..., None]
                l_s = l_s + l[:, i] * si
            ws[bi, :, s, :, :d] = acc_s
            ws[bi, :, s, :, d] = mw
            ws[bi, :, s, :, d + 1] = l_s
    if ws_out is not None:
        ws_out.append(ws)
    # The combine: slots 0 .. n_splits - 1 in increasing order.
    out = torch.empty((b, hkv, rows, d))
    for bi in range(b):
        ns = g.n_splits(int(lens[bi]))
        slots = ws[bi, :, :ns]                       # [h, ns, r, d + 2]
        m = slots[..., d].amax(1) if ns else torch.full((hkv, rows), ninf)
        o = torch.zeros((hkv, rows, d))
        lsum = torch.zeros((hkv, rows))
        for i in range(ns):
            mi = slots[:, i, :, d]
            wi = torch.where(torch.isfinite(mi), torch.exp2(
                mi - torch.where(torch.isfinite(m), m, 0)),
                torch.zeros_like(mi))
            lsum = lsum + slots[:, i, :, d + 1] * wi
            o = o + slots[:, i, :, :d] * wi[..., None]
        out[bi] = o / torch.clamp(lsum, min=1e-30)[..., None]
    return out.to(q.dtype)


def _pool_case(seed, *, b, hkv, d, bs, max_nb, ctxs, q_len=None,
               group=1, scratch_lanes=()):
    """Pool, tables and lens; block 0 is the scratch block, tables are
    0-padded, and a lane in ``scratch_lanes`` keeps the all-zero table
    (a padded engine lane: context 1 on block 0)."""
    rng = np.random.default_rng(seed)
    nbk = b * max_nb + 1
    qshape = (b, hkv, group, d) if q_len is None else (b, q_len, hkv,
                                                        group, d)
    q = rng.standard_normal(qshape, np.float32)
    kp = rng.standard_normal((hkv, nbk, bs, d), np.float32)
    vp = rng.standard_normal((hkv, nbk, bs, d), np.float32)
    tables = np.zeros((b, max_nb), np.int32)
    free = list(rng.permutation(np.arange(1, nbk)))
    for i, ctx in enumerate(ctxs):
        if i in scratch_lanes:
            continue
        nb = -(-ctx // bs)
        tables[i, :nb] = [free.pop() for _ in range(nb)]
    return q, kp, vp, tables, np.asarray(ctxs, np.int32)


def _as(x, dtype):
    t = torch.from_numpy(x)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _jax(x, dtype):
    return jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


CASES = {
    # name: (dtype, d, bs, max_nb, group, q_len, ctxs, q_lens)
    # lane 0: context 1 on the scratch block; a context at and one past
    # the 128-key chunk; a full table; one in between.
    "decode_edges_f32": ("f32", 16, 16, 17, 1, None,
                         [1, 128, 129, 272, 57], None),
    "decode_edges_bf16_gqa": ("bf16", 64, 16, 17, 2, None,
                              [1, 128, 129, 272, 200], None),
    # Verify: q_lens < q_len on some lanes; lane 0's first rows end at
    # key 128 (ctx 131, q_len 4), lane 1's first at 128 (ctx 129, 2
    # rows), so split 1 holds no key they see.
    "verify_f32": ("f32", 16, 16, 17, 2, 4,
                   [131, 129, 4, 272, 1], [4, 2, 4, 3, 1]),
    "verify_bf16": ("bf16", 64, 8, 34, 1, 4,
                    [131, 129, 4, 272, 1], [4, 2, 4, 3, 1]),
    # Blocks longer than a stage (f32, d 256: copied in pieces).
    "pieces_f32": ("f32", 256, 128, 3, 1, None, [384, 130, 1], None),
    # 32 rows a lane: four row tiles of 8.
    "row_tiles_f32": ("f32", 16, 16, 10, 8, 4,
                      [160, 130, 4], [4, 3, 1]),
}


def _run_case(name, ws_out=None):
    """(emulation vs plain, emulation vs Pallas) max abs errors over the
    rows the caller reads; the emulation's output is finite."""
    dtype, d, bs, max_nb, group, q_len, ctxs, q_lens = CASES[name]
    b = len(ctxs)
    q, kp, vp, tables, lens = _pool_case(
        7, b=b, hkv=2, d=d, bs=bs, max_nb=max_nb, ctxs=ctxs, q_len=q_len,
        group=group, scratch_lanes=[i for i, c in enumerate(ctxs)
                                    if c == 1])
    tq, tk, tv = (_as(x, dtype) for x in (q, kp, vp))
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lens)
    jargs = [_jax(x, dtype) for x in (q, kp, vp)] + [jnp.asarray(tables),
                                                     jnp.asarray(lens)]
    if q_len is None:
        qlens = torch.ones(b, dtype=torch.int32)
        got = emulate(tq, tk, tv, tt, tl, qlens, group, ws_out)
        plain = P.paged_decode_attention_reference(tq, tk, tv, tt, tl)
        ker = jax_paged_decode(*jargs, interpret=True)
        keep = [slice(None)] * b
    else:
        qlens = torch.tensor(q_lens, dtype=torch.int32)
        hkv = 2
        qf = tq.permute(0, 2, 1, 3, 4).reshape(b, hkv, q_len * group, d)
        got = emulate(qf, tk, tv, tt, tl, qlens, group, ws_out)
        got = got.reshape(b, hkv, q_len, group, d).permute(0, 2, 1, 3, 4)
        plain = P.paged_verify_attention_reference(tq, tk, tv, tt, tl,
                                                   qlens)
        ker = jax_paged_verify(*jargs, jnp.asarray(np.asarray(q_lens,
                                                              np.int32)),
                               interpret=True)
        keep = [slice(0, n) for n in q_lens]   # padded rows: never read
    got_np = got.float().numpy()
    plain_np = plain.float().numpy()
    ker_np = np.asarray(ker, np.float32)
    assert got.dtype == tq.dtype and np.isfinite(got_np).all()
    e_plain = max(float(np.abs(got_np[i, s] - plain_np[i, s]).max())
                  for i, s in enumerate(keep))
    e_ker = max(float(np.abs(got_np[i, s] - ker_np[i, s]).max())
                for i, s in enumerate(keep))
    return e_plain, e_ker


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulation_matches_plain_and_pallas(name):
    e_plain, e_ker = _run_case(name)
    tol = ATOL[CASES[name][0]]
    assert e_plain <= tol, (name, e_plain, tol)
    assert e_ker <= tol, (name, e_ker, tol)


def test_a_split_with_no_visible_key_weighs_zero():
    """verify_f32's lane 0: rows 0-1 (query token 0) see keys below 128,
    so their slot of split 1 is m = -inf, l = 0, acc = 0; the combine
    gives it weight 0 and the rows still match the plain version."""
    ws = []
    _run_case("verify_f32", ws)
    slot = ws[0][0, :, 1, :2]                       # lane 0, split 1
    assert torch.isneginf(slot[..., 16]).all()
    assert (slot[..., 17] == 0).all() and (slot[..., :16] == 0).all()
    live = ws[0][0, :, 1, 2:]                        # token 1 sees key 128
    assert torch.isfinite(live[..., 16]).all() and (live[..., 17] > 0).all()
    # The splits past a context were never written (NaN) and never read.
    assert torch.isnan(ws[0][2, :, 1:]).all()


def test_masked_keys_never_reach_the_output():
    """NaN in every slot no row may see (the last block's tail and the
    scratch block) leaves the output finite and unchanged: the kernel
    skips masked keys."""
    dtype, d, bs, max_nb, group, _, ctxs, _ = CASES["decode_edges_f32"]
    q, kp, vp, tables, lens = _pool_case(
        7, b=len(ctxs), hkv=2, d=d, bs=bs, max_nb=max_nb, ctxs=ctxs,
        group=group, scratch_lanes=[0])
    args = [torch.from_numpy(x) for x in (q, kp, vp, tables, lens)]
    ones = torch.ones(len(ctxs), dtype=torch.int32)
    clean = emulate(*args, ones, group)
    for i, ctx in enumerate(ctxs):
        nb = -(-ctx // bs)
        pb = tables[i, nb - 1]
        kp[:, pb, ctx - (nb - 1) * bs:] = np.nan
        vp[:, pb, ctx - (nb - 1) * bs:] = np.nan
    kp[:, 0, 1:] = np.nan      # lane 0 reads key 0 of the scratch block
    vp[:, 0, 1:] = np.nan
    args = [torch.from_numpy(x) for x in (q, kp, vp, tables, lens)]
    dirty = emulate(*args, ones, group)
    assert torch.isfinite(dirty).all() and torch.equal(clean, dirty)
