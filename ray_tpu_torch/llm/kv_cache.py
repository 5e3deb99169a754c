"""Block-allocated paged KV pool for the generation engine (port of
ray_tpu/llm/kv_cache.py).

KV for every in-flight sequence lives in ONE pool per layer —
``[kv_heads, num_blocks, block_size, head_dim]`` stacked over layers,
torch tensors on the engine's device — and a sequence owns an ordered
list of block ids (its *block table*) rather than a contiguous region:

  * admission/finish/preempt are allocator ops (list pushes), never
    device copies or compactions;
  * fragmentation is bounded at one partial block per sequence;
  * the pool NEVER overflows: ``alloc()`` returns None when empty and
    the engine preempts a victim and recomputes it on resume.

Block 0 is reserved as scratch: padded decode lanes and padded block-
table slots point at it, so gather indices are always in range and
masked writes need no bounds branch. The allocator never hands it out.

Writes are in place: where the JAX pool scattered functionally into
donated buffers under jit, ``write_prefill`` and ``cow`` index-assign
into the pool tensors. The allocator, the prefix-hash chain, refcounts,
LRU park/evict, ``needs_cow``, ``truncate`` and the event ring are
copies of the JAX pool's, op for op.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch

from .._device import resolve_device
from ..models.gpt import GPTConfig


class PagedKVCache:
    """The pool + its free-list allocator. Sequence bookkeeping (block
    tables, context lengths) belongs to the engine; this class owns the
    device tensors and which blocks are free."""

    def __init__(self, cfg: GPTConfig, num_blocks: int = 64,
                 block_size: int = 16, dtype=None, device=None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is reserved)")
        self.cfg = cfg
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype if dtype is not None else cfg.dtype
        self.device = resolve_device(device)
        shape = (cfg.n_layer, cfg.kv_heads, num_blocks, block_size,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=self.device)
        # LIFO free list (hot blocks rotate), block 0 reserved.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))

    # -- allocator ---------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the reserved scratch block)."""
        return self.num_blocks - 1

    def utilization(self) -> float:
        return 1.0 - self.num_free / max(1, self.capacity)

    def blocks_for_tokens(self, num_tokens: int) -> int:
        return max(1, math.ceil(num_tokens / self.block_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None if the pool can't cover them (all-or-
        nothing: a partial grant would strand blocks on a sequence that
        cannot run)."""
        if n > len(self._free):
            return None
        grant = self._free[-n:][::-1]
        del self._free[-n:]
        return grant

    def free(self, blocks: List[int]):
        seen = set(self._free)
        for b in blocks:
            if b == 0:
                raise ValueError("block 0 is reserved, never allocated")
            if b in seen:
                # A duplicate on the list-based free stack would let the
                # allocator hand the same block to two sequences.
                raise ValueError(f"double free of KV block {b}")
            seen.add(b)
        self._free.extend(blocks)

    def truncate(self, table: List[int], keep_tokens: int) -> List[int]:
        """Trim ``table`` IN PLACE to the blocks covering
        ``keep_tokens`` resident tokens, returning the surplus block
        ids to the free list (on the prefix pool through release(), so
        a shared or still-indexed block parks/unrefs). Returns the
        freed block ids."""
        nb = self.blocks_for_tokens(keep_tokens)
        if nb >= len(table):
            return []
        surplus = table[nb:]
        del table[nb:]
        self.free(surplus)
        return surplus

    # -- writes ------------------------------------------------------------

    def write_prefill(self, k, v, block_ids: List[int]):
        """Write a prefill's K/V into the pool, in place. k, v:
        ``[L, T, kv_heads, head_dim]`` (the stacked per-layer tensors
        forward_prefill emits); the tail of the last block is zero-
        padded (masked by context_lens at read time)."""
        L, T, hkv, d = k.shape
        nb = len(block_ids)
        pad = nb * self.block_size - T
        if pad < 0:
            raise ValueError(f"{nb} blocks cannot hold {T} tokens")
        if pad:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        # [L, T', Hkv, d] -> [L, Hkv, nb, BS, d]
        kb = k.reshape(L, nb, self.block_size, hkv, d).permute(
            0, 3, 1, 2, 4).to(self.dtype)
        vb = v.reshape(L, nb, self.block_size, hkv, d).permute(
            0, 3, 1, 2, 4).to(self.dtype)
        ids = torch.tensor(block_ids, dtype=torch.long, device=self.device)
        self.k[:, :, ids] = kb
        self.v[:, :, ids] = vb

    def gather_tokens(self, block_ids: List[int], length: int):
        """Read back ``length`` tokens' K/V as ``[L, length, Hkv, d]``
        (tests / debugging — the decode path never materializes this)."""
        ids = torch.tensor(block_ids, dtype=torch.long, device=self.device)
        k = self.k[:, :, ids]                 # [L, Hkv, nb, BS, d]
        v = self.v[:, :, ids]
        L, hkv, nb, bs, d = k.shape
        k = k.permute(0, 2, 3, 1, 4).reshape(L, nb * bs, hkv, d)
        v = v.permute(0, 2, 3, 1, 4).reshape(L, nb * bs, hkv, d)
        return k[:, :length], v[:, :length]


class PrefixPool(PagedKVCache):
    """Ref-counted, hash-indexed prefix cache over the paged pool
    (vLLM-style automatic prefix caching, Kwon et al. SOSP '23).

    A sequence's tokens are split into block-sized chunks; each chunk
    is keyed by ``hash((parent_key, chunk_tokens))`` so equal prefixes
    of different requests chain to the SAME keys. The index maps a key
    to the pool block already holding that chunk's K/V:

      * ``admit()`` walks the chain, bumps the refcount of every hit
        block (prefill for that span is skipped entirely) and allocates
        fresh blocks for the remainder — all-or-nothing like ``alloc``;
      * ``release()`` registers the sequence's now-computed chunks and
        decrements refs; refcount-0 blocks with index keys park on an
        LRU list (still matchable) instead of the free list;
      * allocation pressure evicts LRU parked blocks (dropping their
        keys) — referenced blocks are never evicted;
      * a shared block about to be written in a registered span is
        split copy-on-write via ``cow()``.

    Index entries store the full (parent_key, chunk_tokens) and are
    verified on lookup, so hash collisions degrade to misses, never to
    wrong-content hits. The partial prompt tail is registered with its
    exact remainder as the chunk, so a tail hit is always the WHOLE
    remaining prompt.

    Every state change (share, COW split, evict, register) emits into
    ``events``.
    """

    def __init__(self, cfg: GPTConfig, num_blocks: int = 64,
                 block_size: int = 16, dtype=None, device=None):
        super().__init__(cfg, num_blocks=num_blocks,
                         block_size=block_size, dtype=dtype, device=device)
        self._ref: Dict[int, int] = {}        # bid -> live references
        self._keys_of: Dict[int, List[int]] = {}  # bid -> index keys
        # key -> (parent_key, chunk_tokens, bid, span)
        self._index: Dict[int, Tuple] = {}
        # ref-0 registered blocks, eviction order (oldest first).
        self._lru: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        # Memoized chain walks (verified against the stored tuple, so
        # hash collisions cannot alias); invalidated whenever an
        # eviction drops index keys, the match cache also whenever
        # registration adds them.
        self._match_cache: Dict[int, Tuple] = {}
        self._reg_cache: Dict[int, Tuple] = {}
        self.events: Deque[tuple] = collections.deque(maxlen=4096)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.evictions = 0
        self.cow_splits = 0
        self.registrations = 0

    def _event(self, kind: str, **attrs) -> None:
        self.events.append((time.time(), kind, attrs))

    # -- allocator overrides ----------------------------------------------

    @property
    def num_free(self) -> int:
        """Allocatable blocks: truly free + parked (evictable) cached
        blocks."""
        return len(self._free) + len(self._lru)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks (refcount 1 each), evicting LRU parked blocks as
        needed; None if free + evictable cannot cover them."""
        free = self._free
        if n == 1 and free:             # decode/COW fast path
            b = free.pop()
            self._ref[b] = 1
            return [b]
        if n > len(free) + len(self._lru):
            return None
        while len(free) < n:
            self._evict_one()
        grant = super().alloc(n)
        for b in grant:
            self._ref[b] = 1
        return grant

    def _evict_one(self) -> None:
        bid, _ = self._lru.popitem(last=False)
        for key in self._keys_of.pop(bid, ()):
            e = self._index.get(key)
            if e is not None and e[2] == bid:
                del self._index[key]
        self._free.append(bid)
        self._match_cache.clear()       # cached chains may now be broken
        self._reg_cache.clear()
        self.evictions += 1
        self._event("evict", block=bid)

    def free(self, blocks: List[int]):
        """Alias of release(): engine teardown paths call free() on
        either pool flavor."""
        self.release(blocks)

    # -- prefix index ------------------------------------------------------

    def _match(self, seq: List[int]) -> Tuple[List[int], int]:
        """Longest cached chain for ``seq``: (block ids, tokens
        covered). Full block-sized chunks must match contiguously; the
        ragged tail only matches as the exact whole remainder."""
        bs = self.block_size
        index = self._index
        seqt = tuple(seq)
        sh = hash(seqt)
        hit = self._match_cache.get(sh)
        if hit is not None and hit[0] == seqt:
            return list(hit[1]), hit[2]
        parent = 0
        bids: List[int] = []
        covered = 0
        nfull = len(seqt) // bs
        for _ in range(nfull):
            chunk = seqt[covered:covered + bs]
            key = hash((parent, chunk))
            e = index.get(key)
            if e is None or e[0] != parent or e[1] != chunk \
                    or e[3] != bs:
                break
            bids.append(e[2])
            covered += bs
            parent = key
        else:
            rem = seqt[covered:]
            if rem:
                key = hash((parent, rem))
                e = index.get(key)
                if e is not None and e[0] == parent and e[1] == rem \
                        and e[3] == len(rem):
                    bids.append(e[2])
                    covered += len(rem)
        if len(self._match_cache) > 256:
            self._match_cache.clear()
        self._match_cache[sh] = (seqt, tuple(bids), covered)
        return bids, covered

    def admit(self, seq: List[int],
              need_tokens: int) -> Optional[Tuple[List[int], int]]:
        """Build a block table for a sequence: cached-chain blocks are
        acquired (ref++), the remainder freshly allocated. Returns
        (block_table, cached_tokens) or None if the pool cannot cover
        the fresh remainder (nothing acquired in that case)."""
        bids, cached = self._match(seq)
        self.lookup_tokens += len(seq)
        ref, lru = self._ref, self._lru
        for b in bids:
            r = ref.get(b, 0)
            if r == 0:
                lru.pop(b, None)
            ref[b] = r + 1
        fresh_n = self.blocks_for_tokens(need_tokens) - len(bids)
        grant = self.alloc(fresh_n) if fresh_n else []
        if grant is None:
            self._unref(bids)
            return None
        self.hit_tokens += cached
        if bids:
            self._event("share", blocks=len(bids), tokens=cached)
        return bids + grant, cached

    def register(self, seq: List[int], table: List[int]) -> None:
        """Index a sequence's computed chunks so later requests can
        reuse them. First writer wins per key; blocks already indexed
        for this chain are left as-is."""
        bs = self.block_size
        index = self._index
        seqt = tuple(seq)
        sh = hash(seqt)
        if self._reg_cache.get(sh) == seqt:
            return                    # full chain known indexed already
        parent = 0
        newly = 0
        nfull = len(seqt) // bs
        complete = True
        for i in range(nfull + 1):
            if i >= len(table):
                complete = False      # table shorter than the chain
                break
            if i < nfull:
                chunk = seqt[i * bs:(i + 1) * bs]
            else:
                chunk = seqt[nfull * bs:]
                if not chunk:
                    break
            key = hash((parent, chunk))
            if key not in index:
                index[key] = (parent, chunk, table[i], len(chunk))
                self._keys_of.setdefault(table[i], []).append(key)
                newly += 1
            parent = key
        if newly:
            self.registrations += newly
            self._match_cache.clear()  # longer chains may now match
            self._event("register", blocks=newly, tokens=len(seqt))
        if complete:
            if len(self._reg_cache) > 256:
                self._reg_cache.clear()
            self._reg_cache[sh] = seqt

    def release(self, blocks: List[int],
                seq: Optional[List[int]] = None) -> None:
        """Drop one reference per block. ``seq`` (the tokens actually
        resident) registers the now-computed chunks first, so
        continuations and re-admissions hit them."""
        if seq:
            self.register(seq, blocks)
        self._unref(blocks)

    def _unref(self, blocks: List[int]) -> None:
        ref, keys_of = self._ref, self._keys_of
        lru, free = self._lru, self._free
        for b in blocks:
            r = ref.get(b, 0)
            if r <= 0:
                raise ValueError(f"double free of KV block {b}")
            ref[b] = r - 1
            if r == 1:
                if keys_of.get(b):
                    lru[b] = None           # parked, matchable, evictable
                else:
                    free.append(b)

    # -- copy-on-write -----------------------------------------------------

    def needs_cow(self, bid: int, offset: int) -> bool:
        """Must a write at ``offset`` of ``bid`` go to a private copy?
        Yes if the block has co-readers, or the write falls inside a
        registered span (index entries are immutable content)."""
        if self._ref.get(bid, 0) > 1:
            return True
        spans = [self._index[k][3] for k in self._keys_of.get(bid, ())
                 if k in self._index]
        return bool(spans) and offset < max(spans)

    def cow(self, bid: int) -> Optional[int]:
        """Split: allocate a private copy of ``bid`` (an in-place block
        copy on the device), drop the caller's ref on the original.
        Returns the new block id, or None if the pool can't grant one
        (caller preempts and retries)."""
        grant = self.alloc(1)
        if grant is None:
            return None
        dst = grant[0]
        self.k[:, :, dst] = self.k[:, :, bid]
        self.v[:, :, dst] = self.v[:, :, bid]
        self.cow_splits += 1
        self._event("cow", src=bid, dst=dst,
                    refs=self._ref.get(bid, 0))
        self._unref([bid])
        return dst

    # -- introspection -----------------------------------------------------

    def hit_rate(self) -> float:
        return self.hit_tokens / max(1, self.lookup_tokens)

    def shared_blocks(self) -> int:
        return sum(1 for r in self._ref.values() if r > 1)

    def prefix_stats(self) -> dict:
        return {
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "hit_rate": self.hit_rate(),
            "evictions": self.evictions,
            "cow_splits": self.cow_splits,
            "registrations": self.registrations,
            "shared_blocks": self.shared_blocks(),
            "cached_blocks": len(self._lru),
        }
