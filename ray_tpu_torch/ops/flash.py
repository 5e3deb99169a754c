"""Flash attention, forward and backward (port of
ray_tpu/ops/pallas/flash.py).

Four CUDA entry points, each a wrapper with its own launch counter:

  * ``flash_attention_fwd`` — the primal forward (``_fwd_kernel`` under
    ``_fwd(with_lse=False)``), ops/csrc/flash_fwd.cu; counter
    ``launches``;
  * ``flash_attention_fwd_lse`` — the forward that also returns the f32
    row logsumexp (``_fwd_kernel_with_lse``), the same source's LSE
    route; counter ``lse_launches``;
  * ``flash_attention_bwd_fused`` — dq, dk and dv in one kernel
    (``_bwd_fused_kernel``), ops/csrc/flash_bwd.cu; counter
    ``bwd_fused_launches``;
  * ``flash_attention_bwd_split`` — the long-sequence path, one dq kernel
    (``_bwd_dq_kernel``) and one dk/dv kernel (``_bwd_dkv_kernel``);
    counters ``bwd_dq_launches`` and ``bwd_dkv_launches``.

Each launches its kernel for a CUDA tensor (or raises) and takes its
plain PyTorch version for a CPU tensor; a counter counts kernel launches
and nothing else. Each kernel's source carries its note: the TPU kernel
it replaces, what bounds it on the H100, and what its design does about
that. ``FlashAttention`` is the ``autograd.Function`` of the
JAX package's custom VJP (``_make_op``): its forward takes the LSE
route and saves ``(q, k, v, o, lse)``; its backward picks the fused or
the split kernels with ``_fused_bwd_fits``, a copy of the reference's
rule and its 12 MiB budget, so the same shapes take the same path in
both packages.

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
        lib.flash_fwd_launch.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p,
                                         i, f, p]
        lib.flash_fwd_lse_launch.argtypes = [i, i, p, p, p, p, p, i, i, i, i,
                                             i, p, i, f, p]
        for fn in (lib.flash_fwd_launch, lib.flash_fwd_lse_launch):
            fn.restype = i
        lib.flash_fwd_error_string.argtypes = [i]
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib():
    lib = _build.library("flash_bwd")
    if lib.flash_bwd_fused_launch.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        head = [i, i, p, p, p, p, p, p]
        tail = [i, i, i, i, i, p, i, f, p]
        lib.flash_bwd_fused_launch.argtypes = head + [p, p, p] + tail
        lib.flash_bwd_dq_launch.argtypes = head + [p] + tail
        lib.flash_bwd_dkv_launch.argtypes = head + [p, p] + tail
        for fn in (lib.flash_bwd_fused_launch, lib.flash_bwd_dq_launch,
                   lib.flash_bwd_dkv_launch):
            fn.restype = i
        lib.flash_bwd_error_string.argtypes = [i]
        lib.flash_bwd_error_string.restype = ctypes.c_char_p
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
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(h_ax), t.stride(s_ax)]
    st = (ctypes.c_int64 * 12)(*strides)
    lib = _fwd_lib()
    common = (b, h, h // k.shape[h_ax], sq, sk, st, int(causal),
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

def _delta(o, do, h_ax):
    """Δ = Σ_d dO·O in f32, [b, h, sq] (flash.py:384-387)."""
    dl = (do.float() * o.float()).sum(-1)
    return (dl.transpose(1, 2) if h_ax == 2 else dl).contiguous()


def flash_attention_bwd_fused(q, k, v, o, lse, do, *, causal: bool = True,
                              layout: str = "bshd"):
    """dq, dk, dv of the flash forward in one kernel, given its output o,
    its lse [b, h, sq] and the output gradient do (o's layout). Inputs
    and gradients share the layout; gradients are in the input dtype."""
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
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    # The fused kernel adds dq with f32 atomics into a zeroed buffer,
    # zeroed here on the stream the kernel runs on.
    dq = (torch.zeros(q.shape, dtype=torch.float32, device=dev) if fused
          else torch.empty_like(q, memory_format=torch.contiguous_format))
    strides = []
    for t in (q, k, v, do, dq, dk, dv):
        strides += [t.stride(0), t.stride(h_ax), t.stride(s_ax)]
    st = (ctypes.c_int64 * 21)(*strides)
    lib = _bwd_lib()
    head = (_DTYPES[dt], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr())
    tail = (b, h, h // k.shape[h_ax], sq, sk, st, int(causal),
            float(d ** -0.5))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fused:
            err = lib.flash_bwd_fused_launch(
                *head, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail,
                stream)
            _build.check(err, "flash_bwd_fused_launch",
                         lib.flash_bwd_error_string)
            bwd_fused_launches += 1
            return dq.to(dt), dk, dv
        err = lib.flash_bwd_dq_launch(*head, dq.data_ptr(), *tail, stream)
        _build.check(err, "flash_bwd_dq_launch", lib.flash_bwd_error_string)
        bwd_dq_launches += 1
        err = lib.flash_bwd_dkv_launch(*head, dk.data_ptr(), dv.data_ptr(),
                                       *tail, stream)
        _build.check(err, "flash_bwd_dkv_launch", lib.flash_bwd_error_string)
        bwd_dkv_launches += 1
    return dq, dk, dv


def flash_attention_bwd_reference(q, k, v, o, lse, do, *,
                                  causal: bool = True, layout: str = "bshd"):
    """Plain version of both backward routes (the fused and the split
    kernels compute the same function; only the order of their f32 sums
    differs): p = exp(s - lse) where visible, dv = pᵀdO, dp = dO·Vᵀ,
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
    ``(q, k, v, o, lse)``; the backward takes the fused kernel while
    ``_fused_bwd_fits`` holds for the reference's padded lengths, else
    the split kernels.

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
        s_ax, _ = _split(layout)
        fits = _fused_bwd_fits(_padded(q.shape[s_ax], block),
                               _padded(k.shape[s_ax], block), q.shape[-1],
                               q.element_size())
        bwd = flash_attention_bwd_fused if fits else flash_attention_bwd_split
        dq, dk, dv = bwd(q, k, v, o, lse, do, causal=causal, layout=layout)
        return dq, dk, dv, None, None, None
