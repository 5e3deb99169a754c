"""Paged decode attention (port of ray_tpu/ops/pallas/paged_decode.py).

Decode-time attention for continuous batching: each sequence's KV lives
in fixed-size blocks scattered across the pool (llm/kv_cache.py), named
by a per-sequence block table; the kernels gather K/V blocks through
the table, so the pool is never compacted.

``paged_decode_attention`` (one query token per sequence) and
``paged_verify_attention`` (q_len rows per sequence, causal within the
speculative span) share one CUDA entry point, ``paged_attention_launch``
in ops/csrc/paged_decode.cu, as they share one pallas_call in the JAX
package. It launches two kernels: ``paged_decode_split_kernel`` splits
each sequence's keys across CTAs (a whole number of pool blocks each)
and writes every split's partial softmax to an f32 workspace;
``paged_decode_combine_kernel`` combines the splits of each row in a
fixed order. ``decode_geometry`` chooses that launch from shapes alone
(no host sync on ``context_lens``). For a CUDA tensor the wrappers
launch the pair (or raise); for a CPU tensor they take the plain
versions below, ``paged_decode_attention_reference`` and
``paged_verify_attention_reference``. ``launches`` counts launches of
the pair, one a wrapper call, and nothing else.

GQA is native: query heads arrive grouped per KV head as
``[batch, kv_heads, group, head_dim]`` (query head i reads kv head
i // group), so the pool stores only ``kv_heads`` copies.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import _build
from .attention import NEG_INF

launches = 0   # launches of paged_attention_launch (the split/combine pair)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 128            # threads of a split CTA (4 warps)
_WARPS = _THREADS // 32
_CHUNK_KEYS = 128         # keys a split CTA walks, in whole pool blocks
_TILE_KEYS = 64           # key slots of one stage of the copy ring, at most
_MAX_STAGES = 4
_MAX_SMEM = 227 * 1024    # dynamic shared memory a CTA may use
_MAX_HEAD_DIM = 256
# Keys a lane group takes in one step of its walk, by row tile (the
# split kernel's kKeys).
_KEYS_PER_STEP = {1: 4, 4: 2}
# Values in the int64 geometry array paged_attention_launch reads.
DECODE_GEOM_LEN = 22


@dataclasses.dataclass(frozen=True)
class DecodeGeometry:
    """The launch of the split and combine kernels for one call.

    A split CTA takes ``chunk_blocks`` pool blocks of one sequence (its
    split), one kv head and ``row_tile`` query rows. It copies its keys'
    K and V rows into a ring of ``stages`` stages of ``tile_keys`` key
    slots: a stage holds ``tile_blocks`` whole blocks, or, when a block
    is longer than a stage, one of the block's ``pieces`` pieces.
    ``lanes`` threads hold one key row, ``vecs`` 16-byte vectors each.
    Shared memory: the stages (K then V each), the merge area
    (``_WARPS`` x ``row_tile`` x (d + 2) floats) at ``merge_off``, the
    split's table entries at ``table_off``, the full and empty
    mbarriers at ``bar_off``."""
    batch: int
    kv_heads: int
    rows: int
    head_dim: int
    block_size: int
    max_nb: int
    num_blocks: int
    itemsize: int
    lanes: int
    vecs: int
    row_tile: int
    row_tiles: int
    tile_blocks: int
    pieces: int
    tile_keys: int
    chunk_blocks: int
    max_splits: int
    stages: int
    merge_off: int
    table_off: int
    bar_off: int
    smem_bytes: int

    @property
    def keys_per_step(self) -> int:
        """Keys a lane group takes in one step of its walk."""
        return _KEYS_PER_STEP[self.row_tile]

    @property
    def row_bytes(self) -> int:
        return self.head_dim * self.itemsize

    @property
    def stage_bytes(self) -> int:
        return 2 * self.tile_keys * self.row_bytes

    @property
    def grid(self) -> tuple[int, int, int]:
        """The split kernel's grid: (split, kv head, batch x row tile)."""
        return (self.max_splits, self.kv_heads, self.batch * self.row_tiles)

    @property
    def workspace_shape(self) -> tuple[int, ...]:
        """The f32 workspace: per split, per row, acc[d] then m and l."""
        return (self.batch, self.kv_heads, self.max_splits, self.rows,
                self.head_dim + 2)

    def n_splits(self, ctx: int) -> int:
        """Splits that hold keys of a context of ``ctx`` tokens (the
        kernels compute the same on the device)."""
        nblk = min(-(-ctx // self.block_size), self.max_nb)
        return max(0, -(-nblk // self.chunk_blocks))

    def split_keys(self, ctx: int, split: int) -> tuple[int, int]:
        """Key positions [start, end) of one split."""
        blk0 = split * self.chunk_blocks
        nblk = min(-(-ctx // self.block_size), self.max_nb)
        end = min(ctx, min(nblk, blk0 + self.chunk_blocks) * self.block_size)
        return blk0 * self.block_size, end

    def _tile_start(self, t: int) -> int:
        if self.pieces == 1:
            return t * self.tile_keys
        return (t // self.pieces) * self.block_size + \
            (t % self.pieces) * self.tile_keys

    def _tile_span(self, t: int) -> int:
        if self.pieces == 1:
            return self.tile_keys
        return min(self.tile_keys,
                   self.block_size - (t % self.pieces) * self.tile_keys)

    def _tile_of(self, x: int) -> int:
        if self.pieces == 1:
            return x // self.tile_keys
        return (x // self.block_size) * self.pieces + \
            (x % self.block_size) // self.tile_keys

    def tiles(self, ctx: int, split: int) -> list:
        """The stages' key ranges [start, end) of one split, in the
        order the CTA walks them."""
        k0, k1 = self.split_keys(ctx, split)
        n = self._tile_of(k1 - 1 - k0) + 1
        return [(k0 + self._tile_start(t),
                 min(k1, k0 + self._tile_start(t) + self._tile_span(t)))
                for t in range(n)]

    def copies(self, x0: int, x1: int) -> list:
        """The bulk copies of the stage holding keys [x0, x1), each
        ``(table column, first key in the block, keys, byte offset in
        the stage)``; the kernel issues one for K and one for V."""
        out, x, bs = [], x0, self.block_size
        while x < x1:
            j = x // bs
            n = min(x1, (j + 1) * bs) - x
            out.append((j, x - j * bs, n, (x - x0) * self.row_bytes))
            x += n
        return out

    def to_array(self) -> list:
        """The int64 values paged_attention_launch reads."""
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


@functools.lru_cache(maxsize=256)
def decode_geometry(batch: int, kv_heads: int, rows: int, head_dim: int,
                    block_size: int, max_nb: int, num_blocks: int,
                    itemsize: int) -> DecodeGeometry:
    """The launch of the split/combine pair, from shapes alone.

    Chunks of ~128 keys (whole blocks; one block when blocks are
    longer): at b 8, kv heads 12, max_nb 64 and block size 16 the grid
    is 8 x 12 x 8 = 768 CTAs, ~480 of them live at contexts of 512.
    A stage holds at most 64 keys, fewer when two stages of K and V
    would not fit beside the merge area; a block longer than a stage is
    copied in equal pieces. Raises ValueError for a head dim the kernels
    do not take. Cached: a decode step asks for the same launch in every
    layer."""
    vec = 16 // itemsize
    if head_dim % vec or not 0 < head_dim <= _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {head_dim} must be a multiple of {vec} "
                         f"and <= {_MAX_HEAD_DIM} for the paged attention "
                         f"kernels")
    if block_size < 1 or rows < 1:
        raise ValueError(f"block_size {block_size} and rows {rows} must be "
                         f">= 1")
    nvec = head_dim // vec
    lanes = min(32, 1 << (nvec - 1).bit_length())
    vecs = -(-nvec // lanes)
    row_tile = 1 if rows == 1 else 4   # the kernel's RT
    row_bytes = head_dim * itemsize
    merge = _WARPS * row_tile * (head_dim + 2) * 4
    # The table entries: chunk_blocks < _CHUNK_KEYS + _TILE_KEYS.
    fixed = merge + 4 * (_CHUNK_KEYS + _TILE_KEYS) + 16 * _MAX_STAGES
    tk = min(_TILE_KEYS, (_MAX_SMEM - fixed) // (2 * 2 * row_bytes))
    if block_size <= tk:
        tile_blocks, pieces = tk // block_size, 1
        tile_keys = tile_blocks * block_size
    else:
        tile_blocks = 1
        pieces = -(-block_size // tk)
        tile_keys = -(-block_size // pieces)
        pieces = -(-block_size // tile_keys)   # no piece is empty
    chunk = max(1, _CHUNK_KEYS // block_size)
    chunk_blocks = -(-chunk // tile_blocks) * tile_blocks
    tiles_per_chunk = chunk_blocks // tile_blocks * pieces
    stage_bytes = 2 * tile_keys * row_bytes
    stages = min(_MAX_STAGES, tiles_per_chunk,
                 (_MAX_SMEM - fixed) // stage_bytes)
    merge_off = stages * stage_bytes
    table_off = merge_off + merge
    bar_off = -(-(table_off + 4 * chunk_blocks) // 8) * 8
    smem = bar_off + 16 * stages
    assert smem <= _MAX_SMEM, smem
    return DecodeGeometry(
        batch=batch, kv_heads=kv_heads, rows=rows, head_dim=head_dim,
        block_size=block_size, max_nb=max_nb, num_blocks=num_blocks,
        itemsize=itemsize, lanes=lanes, vecs=vecs, row_tile=row_tile,
        row_tiles=-(-rows // row_tile), tile_blocks=tile_blocks,
        pieces=pieces, tile_keys=tile_keys, chunk_blocks=chunk_blocks,
        max_splits=max(1, -(-max_nb // chunk_blocks)), stages=stages,
        merge_off=merge_off, table_off=table_off, bar_off=bar_off,
        smem_bytes=smem)


@functools.lru_cache(maxsize=256)
def _geometry_array(geom: DecodeGeometry):
    return (ctypes.c_int64 * DECODE_GEOM_LEN)(*geom.to_array())


def _lib():
    lib = _build.library("paged_decode")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, ctypes.c_float, p]
        fn.restype = i
        lib.paged_decode_geom_len.argtypes = []
        lib.paged_decode_geom_len.restype = i
        err = lib.paged_attention_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        if lib.paged_decode_geom_len() != DECODE_GEOM_LEN:
            raise RuntimeError("ray_tpu_torch: paged_decode.cu reads "
                               f"{lib.paged_decode_geom_len()} geometry "
                               f"values, ops/paged_decode.py writes "
                               f"{DECODE_GEOM_LEN}")
    return lib


def _launch(q, k_pool, v_pool, block_tables, context_lens, q_lens, group):
    """q: [b, hkv, rows, d]; returns the same shape in q's dtype. q_lens
    None: one query token a sequence (decode)."""
    global launches
    b, hkv, rows, d = q.shape
    hkv_p, num_blocks, block_size, d_p = k_pool.shape
    if (hkv_p, d_p) != (hkv, d):
        raise ValueError(f"pool heads/dim {(hkv_p, d_p)} != query {(hkv, d)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} must match q's dtype and device "
                            f"({t.dtype}, {t.device} vs {q.dtype}, "
                            f"{q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != k_pool.shape:
            raise ValueError("k_pool and v_pool must share one shape")
        if t.data_ptr() % 16:
            raise ValueError("pools must be 16-byte aligned")
    dev = q.device
    tables = block_tables.to(device=dev, dtype=torch.int32).contiguous()
    lens = context_lens.to(device=dev, dtype=torch.int32).contiguous()
    qlens = None if q_lens is None else \
        q_lens.to(device=dev, dtype=torch.int32).contiguous()
    if tables.dim() != 2 or tables.shape[0] != b or lens.shape != (b,) \
            or (qlens is not None and qlens.shape != (b,)):
        raise ValueError("block_tables/context_lens/q_lens must lead with "
                         f"batch {b}")
    geom = decode_geometry(b, hkv, rows, d, block_size, tables.shape[1],
                           num_blocks, q.element_size())
    q = q.contiguous()
    if q.data_ptr() % 16:   # the kernel reads q in 16-byte vectors
        q = q.clone()
    out = torch.empty_like(q)
    # Every slot the combine reads is written by its split first.
    ws = torch.empty(geom.workspace_shape, dtype=torch.float32, device=dev)
    arr = _geometry_array(geom)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attention_launch(
            _DTYPES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            None if qlens is None else qlens.data_ptr(), ws.data_ptr(),
            out.data_ptr(), arr, group,
            float(d ** -0.5), stream)
    _build.check(err, "paged_attention_launch",
                 lib.paged_attention_error_string)
    launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens):
    """Single-token attention over block-paged KV.

    Args:
      q: ``[batch, kv_heads, group, head_dim]`` — one query token per
        sequence, query heads grouped by the KV head they read.
      k_pool / v_pool: ``[kv_heads, num_blocks, block_size, head_dim]``
        — ONE layer's slice of the paged pool.
      block_tables: ``[batch, max_blocks_per_seq]`` int32 — pool block
        ids per sequence, padded with 0 (the reserved scratch block).
      context_lens: ``[batch]`` int32 — tokens in cache per sequence,
        INCLUDING the current token (already written to its slot).

    Returns ``[batch, kv_heads, group, head_dim]`` in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens)
    # q_lens None: one row a sequence (no q_lens tensor to make).
    return _launch(q, k_pool, v_pool, block_tables, context_lens, None,
                   q.shape[2])


def paged_verify_attention(q, k_pool, v_pool, block_tables, context_lens,
                           q_lens):
    """Multi-row (speculative verify) attention over block-paged KV.

    q: ``[batch, q_len, kv_heads, group, head_dim]`` — query row j of
    lane b sits at absolute position ``context_lens[b] - q_lens[b] + j``.
    context_lens include this step's q_lens[b] real rows; rows past
    q_lens[b] are padding (defined garbage the caller must not read).

    Returns ``[batch, q_len, kv_heads, group, head_dim]`` in q's dtype.
    """
    if q.device.type == "cpu":
        return paged_verify_attention_reference(
            q, k_pool, v_pool, block_tables, context_lens, q_lens)
    b, q_len, hkv, group, d = q.shape
    # Kernel row layout: [q_len, group] flattened, so row r is query
    # token r // group of the lane.
    qf = q.permute(0, 2, 1, 3, 4).reshape(b, hkv, q_len * group, d)
    out = _launch(qf, k_pool, v_pool, block_tables, context_lens, q_lens,
                  group)
    return out.reshape(b, hkv, q_len, group, d).permute(0, 2, 1, 3, 4)


def _gather(pool, block_tables):
    """[hkv, NB, BS, d] gathered by table -> [b, hkv, max_nb * BS, d]."""
    hkv, _, bs, d = pool.shape
    b, max_nb = block_tables.shape
    g = pool[:, block_tables.long()]          # [hkv, b, max_nb, bs, d]
    return g.permute(1, 0, 2, 3, 4).reshape(b, hkv, max_nb * bs, d)


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                     context_lens):
    """Plain version: materialize the gather, run dense masked softmax
    attention in f32. O(batch x max_ctx) memory."""
    b, hkv, group, d = q.shape
    k = _gather(k_pool, block_tables).float()
    v = _gather(v_pool, block_tables).float()
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k) * (d ** -0.5)
    k_pos = torch.arange(k.shape[2], device=q.device)[None, None, None, :]
    ctx = context_lens.to(q.device)[:, None, None, None]
    s = torch.where(k_pos < ctx, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bhkd->bhgd", p, v).to(q.dtype)


def paged_verify_attention_reference(q, k_pool, v_pool, block_tables,
                                     context_lens, q_lens):
    """Plain version of the q_len > 1 verify pass: same gather as the
    decode reference, per-row causal bound
    ``min(ctx, ctx - q_lens + 1 + row)``."""
    b, q_len, hkv, group, d = q.shape
    k = _gather(k_pool, block_tables).float()
    v = _gather(v_pool, block_tables).float()
    s = torch.einsum("bqhgd,bhkd->bhqgk", q.float(), k) * (d ** -0.5)
    dev = q.device
    k_pos = torch.arange(k.shape[2], device=dev)[None, None, None, None, :]
    ctx = context_lens.to(dev)[:, None, None, None, None]
    qi = torch.arange(q_len, device=dev)[None, None, :, None, None]
    bound = torch.minimum(ctx, ctx - q_lens.to(dev)[:, None, None, None, None]
                          + 1 + qi)
    s = torch.where(k_pos < bound, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqgk,bhkd->bqhgd", p, v).to(q.dtype)
