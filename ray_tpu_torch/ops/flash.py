"""Flash attention, forward and backward (port of
ray_tpu/ops/pallas/flash.py).

Four CUDA entry points, each a wrapper with its own launch counter:

  * ``flash_attention_fwd`` — the primal forward (``_fwd_kernel`` under
    ``_fwd(with_lse=False)``), ops/csrc/flash_fwd.cu; counter
    ``launches``;
  * ``flash_attention_fwd_lse`` — the forward that also returns the f32
    row logsumexp (``_fwd_kernel_with_lse``), the same source's LSE
    route; counter ``lse_launches``. Both forward routes take the
    Hopper kernel (TMA and wgmma) for bf16 and the CUDA-core kernel for
    f32; ``fwd_geometry`` computes either launch's geometry;
  * ``flash_attention_bwd_fused`` — dq, dk and dv in one pass
    (``_bwd_fused_kernel``), ops/csrc/flash_bwd.cu: the Hopper kernel
    (TMA and wgmma) for bf16, the CUDA-core kernel for f32, each writing
    per-key-tile dq contributions that a second kernel sums in a fixed
    order; ``bwd_geometry`` computes the launch geometry; counter
    ``bwd_fused_launches`` (one a call, for the pair);
  * ``flash_attention_bwd_split`` — the long-sequence path, one dq kernel
    (``_bwd_dq_kernel``) and one dk/dv kernel (``_bwd_dkv_kernel``), the
    same source: for bf16 the Hopper kernels (the dk/dv kernel is the
    fused kernel without its dq; the dq kernel has the forward's
    structure with a known LSE), for f32 the CUDA-core ones, each
    gradient written once (no workspace); ``bwd_geometry`` (routes
    "kv" and "dq") computes both launches' geometry; counters
    ``bwd_dq_launches`` and ``bwd_dkv_launches``.

Each launches its kernel for a CUDA tensor (or raises) and takes its
plain PyTorch version for a CPU tensor; a counter counts kernel launches
and nothing else. Each kernel's source carries its note: the TPU kernel
it replaces, what bounds it on the H100, and what its design does about
that. ``FlashAttention`` is the ``autograd.Function`` of the
JAX package's custom VJP (``_make_op``): its forward takes the LSE
route and saves ``(q, k, v, o, lse)``; its backward picks the fused or
the split kernels with ``bwd_route``: ``_fused_bwd_fits``, a copy of the
reference's rule and its 12 MiB budget, so the same shapes take the same
path in both packages, and the fused route's dq workspace cap
``_FUSED_BWD_WORKSPACE_BYTES``, which the reference has no need of.

Semantics are those of ``flash_attention_pallas``: layouts "bshd"
([batch, seq, heads, head_dim]) and "bhsd"; causal masking aligned
TOP-LEFT (query i sees keys 0..i, whatever sk is); f32 scores, softmax
statistics and gradient accumulation; p and ds rounded to the input
dtype before the products they feed; outputs and gradients in the
input dtype and layout. GQA maps query head i to kv head i // group
(the ``jnp.repeat`` expansion), so dk and dv of a kv head are sums over
its group.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build
from .attention import NEG_INF

launches = 0            # flash_fwd_launch (primal forward)
lse_launches = 0        # flash_fwd_lse_launch (forward with LSE)
bwd_fused_launches = 0  # flash_bwd_fused_launch
bwd_dq_launches = 0     # flash_bwd_dq_launch (split path)
bwd_dkv_launches = 0    # flash_bwd_dkv_launch (split path)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)

# The reference's budget and rule for the fused backward
# (ray_tpu/ops/pallas/flash.py:277-283), copied so that the same shapes
# take the same path in both packages; a test forces the split path by
# setting the budget to 0. Sizes are the reference's padded lengths
# (``_padded``).
_FUSED_BWD_VMEM_BUDGET = 12 * 1024 * 1024
# The most bytes of f32 dq workspace the fused route may take. Its
# workspace [key tiles, b, h, sq, d] grows with b·h·s², which the rule
# above does not read (the Pallas kernel keeps dq in VMEM): above the cap
# ``FlashAttention``'s backward takes the split route, which needs no
# workspace (``bwd_route``). A test may set it.
_FUSED_BWD_WORKSPACE_BYTES = 256 * 1024 * 1024


def _fused_bwd_fits(sq_p: int, sk_p: int, d: int, itemsize: int) -> bool:
    q_side = sq_p * d * (3 * itemsize + 4)   # q, dO, dq + f32 scratch
    k_side = sk_p * d * (4 * itemsize)       # k, v, dk, dv
    return q_side + k_side <= _FUSED_BWD_VMEM_BUDGET


def _padded(s: int, block: int) -> int:
    """The reference's padded length: s rounded up to its block,
    ``min(block, max(s, 8))``."""
    blk = min(block, max(s, 8))
    return -(-s // blk) * blk


def _fwd_lib():
    lib = _build.library("flash_fwd")
    if lib.flash_fwd_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd_launch.argtypes = [i, i, p, p, p, p, i, i, i, p, i, f,
                                         p]
        lib.flash_fwd_lse_launch.argtypes = [i, i, p, p, p, p, p, i, i, i, p,
                                             i, f, p]
        for fn in (lib.flash_fwd_launch, lib.flash_fwd_lse_launch):
            fn.restype = i
        lib.flash_fwd_smem_bytes.argtypes = [i, i]
        lib.flash_fwd_smem_bytes.restype = i
        lib.flash_fwd_geom_len.argtypes = []
        lib.flash_fwd_geom_len.restype = i
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        if lib.flash_fwd_geom_len() != GEOM_LEN:
            raise RuntimeError("ray_tpu_torch: flash_fwd.cu reads "
                               f"{lib.flash_fwd_geom_len()} geometry values, "
                               f"ops/flash.py writes {GEOM_LEN}")
    return lib


def _bwd_lib():
    lib = _build.library("flash_bwd")
    if lib.flash_bwd_fused_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        head = [i, i, p, p, p, p, p, p]
        tail = [i, i, i, i, p, i, f, p]
        lib.flash_bwd_fused_launch.argtypes = head + [p, p, p, p, p] + tail
        lib.flash_bwd_dq_launch.argtypes = head + [p] + tail
        lib.flash_bwd_dkv_launch.argtypes = head + [p, p, p] + tail
        for fn in (lib.flash_bwd_fused_launch, lib.flash_bwd_dq_launch,
                   lib.flash_bwd_dkv_launch):
            fn.restype = i
        lib.flash_bwd_geom_len.argtypes = []
        lib.flash_bwd_geom_len.restype = i
        lib.flash_bwd_smem_bytes.argtypes = [i]
        lib.flash_bwd_smem_bytes.restype = i
        lib.flash_bwd_split_smem_bytes.argtypes = [i, i]
        lib.flash_bwd_split_smem_bytes.restype = i
        lib.flash_bwd_error_string.argtypes = [i]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
        if lib.flash_bwd_geom_len() != BWD_GEOM_LEN:
            raise RuntimeError("ray_tpu_torch: flash_bwd.cu reads "
                               f"{lib.flash_bwd_geom_len()} geometry values, "
                               f"ops/flash.py writes {BWD_GEOM_LEN}")
    return lib


def _split(layout: str):
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout must be bshd|bhsd, got {layout!r}")
    # (seq axis, head axis)
    return (1, 2) if layout == "bshd" else (2, 1)


def _check_gqa(q, k, h_ax):
    hq, hk = q.shape[h_ax], k.shape[h_ax]
    if hq % hk:
        raise ValueError(f"GQA requires heads({hq}) % kv_heads({hk})==0")


# ------------------------------------------------------------- forward

# The bf16 kernel's tiles: 128 query rows a CTA (two consumer
# warpgroups of 64), K/V tiles of 128 keys, the head dim padded to a
# whole number of 64-column TMA boxes (128 bytes, the 128-byte swizzle
# that wgmma reads). The f32 kernel's tiles are 64 x 64.
_WG_BLOCK_Q = 128
_WG_BLOCK_K = 128
_BOX_COLS = 64
_F32_BLOCK = 64
# Values in the int64 geometry array the C entry points read.
GEOM_LEN = 51


@dataclasses.dataclass(frozen=True)
class TensorMapGeometry:
    """One TMA tensor map over a [b, s, h, d] or [b, h, s, d] tensor,
    seen as the 4-D view (d, heads, seq, batch), innermost first."""
    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]      # bytes: heads, seq, batch
    box: tuple[int, int, int, int]     # elements: d, heads, seq, batch


@dataclasses.dataclass(frozen=True)
class FwdGeometry:
    """The launch geometry of the forward kernel for one call."""
    head_dim_padded: int
    block_q: int
    block_k: int
    grid: tuple[int, int, int]
    strides: tuple[int, ...]           # elements: (b, h, s) of q, k, v, out
    maps: tuple[TensorMapGeometry, ...]   # q, k, v (bf16), () for f32

    def to_array(self) -> list:
        """The int64 values the C entry points read (flash_fwd.cu)."""
        vals = [self.head_dim_padded, self.block_q, self.block_k,
                *self.grid, *self.strides]
        for m in self.maps:
            vals += [*m.dims, *m.strides, *m.box]
        return vals + [0] * (GEOM_LEN - len(vals))


def fwd_geometry(q, k, v, out, s_ax: int, h_ax: int) -> FwdGeometry:
    """Launch geometry of the forward kernel for these tensors (only
    their dtype, shapes and strides are read: no device is touched).

    bf16: the Hopper kernel. Grid (h, b, q tiles): the q tile is the
    slowest axis, walked from the last tile so the longest causal walks
    start first. Q, K and V each get a tensor map over (d, heads, seq,
    batch) with their own byte strides, so both layouts load without a
    transpose; the box is 64 columns by one tile of rows, and a head dim
    below 64 or between 64 and 128 is padded (by TMA's zero fill) to 64
    or 128. f32: the CUDA-core kernel, 64 x 64 tiles, grid (q tiles, h,
    b), no tensor maps."""
    b, sq, h, d = q.shape[0], q.shape[s_ax], q.shape[h_ax], q.shape[-1]
    strides = tuple(st for t in (q, k, v, out)
                    for st in (t.stride(0), t.stride(h_ax), t.stride(s_ax)))
    if q.dtype == torch.float32:
        return FwdGeometry(d, _F32_BLOCK, _F32_BLOCK,
                           (-(-sq // _F32_BLOCK), h, b), strides, ())
    maps = _tensor_maps(((q, _WG_BLOCK_Q), (k, _WG_BLOCK_K),
                         (v, _WG_BLOCK_K)), s_ax, h_ax)
    return FwdGeometry(_padded_head_dim(d), _WG_BLOCK_Q, _WG_BLOCK_K,
                       (h, b, -(-sq // _WG_BLOCK_Q)), strides, maps)


def _padded_head_dim(d: int) -> int:
    """The head dim of the bf16 kernels' tiles: whole 64-column boxes."""
    return -(-d // _BOX_COLS) * _BOX_COLS


def _tensor_maps(tensors_rows, s_ax: int, h_ax: int):
    """One TMA tensor map per (tensor, box rows): the (d, heads, seq,
    batch) view with the tensor's own byte strides, boxes of one
    64-column panel of ``rows`` rows of one head and batch."""
    return tuple(
        TensorMapGeometry(
            dims=(t.shape[-1], t.shape[h_ax], t.shape[s_ax], t.shape[0]),
            strides=tuple(t.stride(ax) * t.element_size()
                          for ax in (h_ax, s_ax, 0)),
            box=(_BOX_COLS, 1, rows, 1))
        for t, rows in tensors_rows)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        layout: str = "bshd"):
    """Flash attention forward. q: [b, s, h, d] ("bshd") or [b, h, s, d]
    ("bhsd"); k/v the same with sk keys and h // group heads. Output in
    q's layout and dtype."""
    s_ax, h_ax = _split(layout)
    _check_gqa(q, k, h_ax)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         layout=layout)
    return _launch_fwd(q, k, v, causal, s_ax, h_ax, with_lse=False)[0]


def flash_attention_fwd_lse(q, k, v, *, causal: bool = True,
                            layout: str = "bshd"):
    """The forward of training: (out, lse), out as
    ``flash_attention_fwd``'s, lse the f32 row logsumexp [b, h, sq] of
    the masked, scaled scores (finite on every row)."""
    s_ax, h_ax = _split(layout)
    _check_gqa(q, k, h_ax)
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_reference(q, k, v, causal=causal,
                                                 layout=layout)
    return _launch_fwd(q, k, v, causal, s_ax, h_ax, with_lse=True)


def _kernel_operands(named, dtype, device, d):
    """Check dtype, device and head dim; return the tensors as the
    kernels read them: unit-stride head dim, 16-byte aligned rows (a
    view with other strides or an unaligned start gets a fresh copy)."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{_HEAD_DIMS}, got {d}")
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    out = []
    for name, t in named:
        if t.dtype != dtype or t.device != device:
            raise TypeError(f"{name} must match q's dtype and device")
        if t.shape[-1] != d:
            raise ValueError(f"{name} head_dim {t.shape[-1]} != {d}")
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            t = t.clone(memory_format=torch.contiguous_format)
        out.append(t)
    return out


def _launch_fwd(q, k, v, causal, s_ax, h_ax, with_lse):
    global launches, lse_launches
    q, k, v = _kernel_operands((("q", q), ("k", k), ("v", v)), q.dtype,
                               q.device, q.shape[-1])
    b, sq, h, d = q.shape[0], q.shape[s_ax], q.shape[h_ax], q.shape[-1]
    sk = k.shape[s_ax]
    if v.shape != k.shape or k.shape[0] != b or sk < 1:
        raise ValueError("k and v must share one shape with q's batch")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    geom = fwd_geometry(q, k, v, out, s_ax, h_ax)
    arr = (ctypes.c_int64 * GEOM_LEN)(*geom.to_array())
    lib = _fwd_lib()
    common = (h // k.shape[h_ax], sq, sk, arr, int(causal),
              float(d ** -0.5))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (_DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr())
        if with_lse:
            err = lib.flash_fwd_lse_launch(*args, lse.data_ptr(), *common,
                                           stream)
        else:
            err = lib.flash_fwd_launch(*args, *common, stream)
    name = "flash_fwd_lse_launch" if with_lse else "flash_fwd_launch"
    _build.check(err, name, lib.flash_fwd_error_string)
    if with_lse:
        lse_launches += 1
    else:
        launches += 1
    return out, lse


def _reference(q, k, v, causal, layout, with_lse):
    _split(layout)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    hq, hk = q.shape[1], k.shape[1]
    if hq != hk:
        k = k.repeat_interleave(hq // hk, dim=1)
        v = v.repeat_interleave(hq // hk, dim=1)
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    if causal:
        s = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), s,
                        torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (pv / l.clamp_min(1e-30)).to(q.dtype)
    out = out.transpose(1, 2) if layout == "bshd" else out
    if not with_lse:
        return out
    return out, (m + torch.log(l.clamp_min(1e-30)))[..., 0]


def _causal_mask(sq, sk, device):
    """Top-left causal mask [sq, sk]: query i sees keys 0..i."""
    return torch.arange(sq, device=device)[:, None] >= \
        torch.arange(sk, device=device)[None, :]


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              layout: str = "bshd"):
    """Plain version of the forward kernel's arithmetic: f32 scores,
    top-left causal mask, unnormalized p = exp(s - rowmax) rounded to the
    value dtype for PV, divided by the f32 row sum at the end."""
    return _reference(q, k, v, causal, layout, with_lse=False)


def flash_attention_fwd_lse_reference(q, k, v, *, causal: bool = True,
                                      layout: str = "bshd"):
    """Plain version of the LSE route: ``flash_attention_reference``'s
    output and lse = rowmax + log(max(rowsum, 1e-30)) over the masked
    scores (masked scores are the finite NEG_INF, so every row's lse is
    finite, as the TPU kernel's is)."""
    return _reference(q, k, v, causal, layout, with_lse=True)


# ------------------------------------------------------------ backward

# The backward's tiles (ops/csrc/flash_bwd.cu). bf16, the fused route and
# the split dk/dv kernel: key tiles of 128 (64 for each consumer
# warpgroup) and q tiles of 8192 / DP rows (128 at DP 64, 64 at DP 128),
# the head dim padded as the forward's; the split dq kernel: q tiles of
# 128 rows (64 a consumer) and key tiles of 8192 / DP. f32: the CUDA-core
# kernels' 64 x 64 tiles.
_BWD_BLOCK_K = 128
_DQ_BLOCK_Q = 128
_BWD_ROUTES = ("kv", "dq")
# Values in the int64 geometry array the backward's C entry points read.
BWD_GEOM_LEN = 74


@dataclasses.dataclass(frozen=True)
class BwdGeometry:
    """The launch geometry of one backward kernel for one call.

    Route "kv" (the fused kernel and the split dk/dv kernel) runs one CTA
    per key tile. The fused route writes its dq contribution for every q
    tile it visits to slot ``kt`` of an f32 workspace [slots, b, h, sq,
    d], which the sum kernel reduces in increasing ``kt``. Route "dq"
    (the split dq kernel) runs one CTA per q tile, walking the key tiles
    0 .. ``last_slot``."""
    head_dim_padded: int
    block_q: int
    block_k: int
    grid: tuple[int, int, int]
    batch: int
    q_tiles: int
    slots: int                         # key tiles (the fused route's dq
                                       # workspace slots)
    strides: tuple[int, ...]           # elements: (b, h, s) of q, k, v,
                                       # do, dq, dk, dv
    maps: tuple[TensorMapGeometry, ...]   # q, k, v, do (bf16), () for f32

    def workspace_shape(self, h: int, sq: int, d: int) -> tuple:
        return (self.slots, self.batch, h, sq, d)

    def first_q_tile(self, kt: int, causal: bool) -> int:
        """The first q tile key tile ``kt`` is visible to (the
        reference's ``lower``); a key tile's CTA walks from there down."""
        return kt * self.block_k // self.block_q if causal else 0

    def last_slot(self, qt: int, causal: bool) -> int:
        """The last key tile q tile ``qt`` sees (the reference's
        ``upper`` less one): the fused route's sum kernel adds the slots
        0 .. last_slot of its rows, in that order; the dq kernel's CTA
        walks those key tiles."""
        if not causal:
            return self.slots - 1
        return min(self.slots - 1,
                   (qt * self.block_q + self.block_q - 1) // self.block_k)

    def to_array(self) -> list:
        """The int64 values the C entry points read."""
        vals = [self.head_dim_padded, self.block_q, self.block_k,
                *self.grid, self.batch, self.q_tiles, self.slots,
                *self.strides]
        for m in self.maps:
            vals += [*m.dims, *m.strides, *m.box]
        return vals + [0] * (BWD_GEOM_LEN - len(vals))


def bwd_geometry(q, k, v, do, dq, dk, dv, s_ax: int, h_ax: int,
                 route: str = "kv") -> BwdGeometry:
    """Launch geometry of a backward kernel for these tensors (only their
    dtype, shapes and strides are read: no device is touched).

    bf16, route "kv": the Hopper kernels of one key tile a CTA (the
    fused kernel and the split dk/dv kernel). Grid (kv heads, b, key tiles): the key tile is the slowest axis,
    so the first tiles, with the longest causal walks, start first. Q, K,
    V and dO each get a tensor map over (d, heads, seq, batch) with their
    own byte strides; boxes of 64 columns by one tile of rows (block_q
    for Q and dO, 128 for K and V). bf16, route "dq": the Hopper dq
    kernel, grid (h, b, q tiles), the q tile the slowest axis and walked
    from the last (the longest causal walks first); the same maps with
    boxes of 128 rows for Q and dO and block_k = 8192 / DP for K and V.
    f32: the CUDA-core kernels, 64 x 64 tiles, grid (key tiles, kv heads,
    b) or, route "dq", (q tiles, h, b); no tensor maps."""
    if route not in _BWD_ROUTES:
        raise ValueError(f"route must be one of {_BWD_ROUTES}, got {route!r}")
    b, sq, h, d = q.shape[0], q.shape[s_ax], q.shape[h_ax], q.shape[-1]
    sk, hk = k.shape[s_ax], k.shape[h_ax]
    strides = tuple(st for t in (q, k, v, do, dq, dk, dv)
                    for st in (t.stride(0), t.stride(h_ax), t.stride(s_ax)))
    if q.dtype == torch.float32:
        nq, nk = -(-sq // _F32_BLOCK), -(-sk // _F32_BLOCK)
        grid = (nq, h, b) if route == "dq" else (nk, hk, b)
        return BwdGeometry(d, _F32_BLOCK, _F32_BLOCK, grid, b, nq, nk,
                           strides, ())
    dp = _padded_head_dim(d)
    if route == "dq":
        bq, bk = _DQ_BLOCK_Q, 8192 // dp
    else:
        bq, bk = 8192 // dp, _BWD_BLOCK_K
    nq, nk = -(-sq // bq), -(-sk // bk)
    grid = (h, b, nq) if route == "dq" else (hk, b, nk)
    maps = _tensor_maps(((q, bq), (k, bk), (v, bk), (do, bq)), s_ax, h_ax)
    return BwdGeometry(dp, bq, bk, grid, b, nq, nk, strides, maps)


def row_stats(lse, delta, block_q: int):
    """The bf16 key-tile kernels' (fused, split dk/dv) per-q-tile rows:
    [b, h, q tiles, 2, block_q] f32, each tile's LSE then Δ, zero past sq
    (one bulk copy a tile)."""
    b, h, sq = lse.shape
    pad = -sq % block_q
    tiles = [torch.nn.functional.pad(t, (0, pad)).view(b, h, -1, block_q)
             for t in (lse, delta)]
    return torch.stack(tiles, dim=3)


def fused_bwd_workspace_bytes(b: int, h: int, sq: int, sk: int, d: int,
                              dtype) -> int:
    """Bytes of the fused route's f32 dq workspace for these shapes:
    [key tiles, b, h, sq, d], as ``bwd_geometry(...).workspace_shape``."""
    block_k = _F32_BLOCK if dtype == torch.float32 else _BWD_BLOCK_K
    return 4 * -(-sk // block_k) * b * h * sq * d


def bwd_route(b: int, h: int, sq: int, sk: int, d: int, dtype,
              block: int) -> str:
    """``FlashAttention``'s backward route, "fused" or "split": the fused
    kernel while the reference's rule holds at its padded lengths
    (``_fused_bwd_fits``) and its dq workspace fits
    ``_FUSED_BWD_WORKSPACE_BYTES``; else the split kernels."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if not _fused_bwd_fits(_padded(sq, block), _padded(sk, block), d,
                           itemsize):
        return "split"
    if fused_bwd_workspace_bytes(b, h, sq, sk, d, dtype) > \
            _FUSED_BWD_WORKSPACE_BYTES:
        return "split"
    return "fused"


def _delta(o, do, h_ax):
    """Δ = Σ_d dO·O in f32, [b, h, sq] (flash.py:384-387)."""
    dl = (do.float() * o.float()).sum(-1)
    return (dl.transpose(1, 2) if h_ax == 2 else dl).contiguous()


def flash_attention_bwd_fused(q, k, v, o, lse, do, *, causal: bool = True,
                              layout: str = "bshd"):
    """dq, dk, dv of the flash forward in one kernel, given its output o,
    its lse [b, h, sq] and the output gradient do (o's layout). Inputs
    and gradients share the layout; gradients are in the input dtype.
    Its f32 dq workspace is ``fused_bwd_workspace_bytes``: the caller
    picks the route (``FlashAttention`` by ``bwd_route``)."""
    s_ax, h_ax = _split(layout)
    _check_gqa(q, k, h_ax)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, layout=layout)
    return _launch_bwd(q, k, v, o, lse, do, causal, s_ax, h_ax, fused=True)


def flash_attention_bwd_split(q, k, v, o, lse, do, *, causal: bool = True,
                              layout: str = "bshd"):
    """``flash_attention_bwd_fused``'s function through the split
    kernels: one for dq, one for dk and dv (the long-sequence path)."""
    s_ax, h_ax = _split(layout)
    _check_gqa(q, k, h_ax)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, layout=layout)
    return _launch_bwd(q, k, v, o, lse, do, causal, s_ax, h_ax, fused=False)


def _launch_bwd(q, k, v, o, lse, do, causal, s_ax, h_ax, fused):
    global bwd_fused_launches, bwd_dq_launches, bwd_dkv_launches
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("o and do must have q's shape")
    dt, dev, d = q.dtype, q.device, q.shape[-1]
    q, k, v, do = _kernel_operands(
        (("q", q), ("k", k), ("v", v), ("do", do)), dt, dev, d)
    b, sq, h = q.shape[0], q.shape[s_ax], q.shape[h_ax]
    sk = k.shape[s_ax]
    if v.shape != k.shape or k.shape[0] != b or sk < 1:
        raise ValueError("k and v must share one shape with q's batch")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [{b}, {h}, {sq}]")
    lse = lse.contiguous()
    delta = _delta(o, do, h_ax)
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    lib = _bwd_lib()
    head = (_DTYPES[dt], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    group, scale = h // k.shape[h_ax], float(d ** -0.5)
    if fused:
        # The kernel writes every workspace slot the sum kernel reads, so
        # the workspace is not zeroed.
        geom = bwd_geometry(q, k, v, do, dq, dk, dv, s_ax, h_ax)
        ws = torch.empty(geom.workspace_shape(h, sq, d), dtype=torch.float32,
                         device=dev)
        rows = (row_stats(lse, delta, geom.block_q)
                if dt == torch.bfloat16 else None)
        arr = (ctypes.c_int64 * BWD_GEOM_LEN)(*geom.to_array())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.flash_bwd_fused_launch(
                *head, None if rows is None else rows.data_ptr(),
                ws.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                h, group, sq, sk, arr, int(causal), scale, stream)
        _build.check(err, "flash_bwd_fused_launch",
                     lib.flash_bwd_error_string)
        bwd_fused_launches += 1
        return dq, dk, dv
    # The split route: Δ and (bf16) the dk/dv kernel's LSE/Δ tiles built
    # once, both kernels launched on the current stream; no workspace.
    tail = (h, group, sq, sk)
    g_dq, g_kv = (bwd_geometry(q, k, v, do, dq, dk, dv, s_ax, h_ax, route=r)
                  for r in ("dq", "kv"))
    rows = (row_stats(lse, delta, g_kv.block_q)
            if dt == torch.bfloat16 else None)
    arr_dq, arr_kv = ((ctypes.c_int64 * BWD_GEOM_LEN)(*g.to_array())
                      for g in (g_dq, g_kv))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_bwd_dq_launch(*head, dq.data_ptr(), *tail, arr_dq,
                                      int(causal), scale, stream)
        _build.check(err, "flash_bwd_dq_launch", lib.flash_bwd_error_string)
        bwd_dq_launches += 1
        err = lib.flash_bwd_dkv_launch(
            *head, None if rows is None else rows.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), *tail, arr_kv, int(causal), scale, stream)
        _build.check(err, "flash_bwd_dkv_launch", lib.flash_bwd_error_string)
        bwd_dkv_launches += 1
    return dq, dk, dv


def flash_attention_bwd_reference(q, k, v, o, lse, do, *,
                                  causal: bool = True, layout: str = "bshd"):
    """Plain version of both backward routes (the fused and the split
    kernels compute the same function; only the order of their f32 sums
    differs, and each kernel's order is fixed, so each is bitwise
    repeatable): p = exp(s - lse) where visible, dv = pᵀdO, dp = dO·Vᵀ,
    ds = p(dp - Δ)·scale, dk = dsᵀq, dq = ds·K, with p and ds rounded to
    the input dtype before those products and dk/dv summed over each kv
    head's group."""
    s_ax, h_ax = _split(layout)
    dt = q.dtype
    delta = _delta(o, do, h_ax)
    if layout == "bshd":
        q, k, v, do = (t.transpose(1, 2) for t in (q, k, v, do))
    hq, hk = q.shape[1], k.shape[1]
    group = hq // hk
    if group > 1:
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(q.shape[2], k.shape[2], q.device), p,
                        torch.zeros_like(p))
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    if group > 1:
        dk = dk.unflatten(1, (hk, group)).sum(2)
        dv = dv.unflatten(1, (hk, group)).sum(2)
    grads = (dq.to(dt), dk.to(dt), dv.to(dt))
    if layout == "bshd":
        grads = tuple(g.transpose(1, 2) for g in grads)
    return grads


class FlashAttention(torch.autograd.Function):
    """Flash attention with its hand-written backward (the JAX custom
    VJP of ``_make_op``): the forward takes the LSE route and saves
    ``(q, k, v, o, lse)``; the backward takes the fused kernel or the
    split kernels by ``bwd_route``.

    ``FlashAttention.apply(q, k, v, causal, layout, block_size)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, layout, block_size):
        o, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                         layout=layout)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, layout, block_size)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, layout, block = ctx.opts
        s_ax, h_ax = _split(layout)
        route = bwd_route(q.shape[0], q.shape[h_ax], q.shape[s_ax],
                          k.shape[s_ax], q.shape[-1], q.dtype, block)
        bwd = (flash_attention_bwd_fused if route == "fused"
               else flash_attention_bwd_split)
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=causal, layout=layout)
        return dq, dk, dv, None, None, None
