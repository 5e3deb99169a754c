"""Flash attention forward (port of the primal path of
ray_tpu/ops/pallas/flash.py: ``_fwd_kernel`` under ``_fwd(with_lse=False)``).

``flash_attention_fwd`` launches the CUDA kernel ops/csrc/flash_fwd.cu
for a CUDA tensor (or raises) and takes the plain version
``flash_attention_reference`` for a CPU tensor. ``launches`` counts
kernel launches and nothing else.

Semantics are those of ``flash_attention_pallas``: layouts "bshd"
([batch, seq, heads, head_dim]) and "bhsd"; causal masking aligned
TOP-LEFT (query i sees keys 0..i, whatever sk is); f32 scores and
softmax statistics; p rounded to the value dtype before PV; output in
the input dtype. GQA maps query head i to kv head i // group (the
``jnp.repeat`` expansion). The LSE output and the backward kernels
belong to the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .attention import NEG_INF

launches = 0   # kernel launches of flash_fwd_launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)


def _lib():
    lib = _build.library("flash_fwd")
    fn = lib.flash_fwd_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, p, p, p, i, i, i, i, i, p, i, ctypes.c_float,
                       p]
        fn.restype = i
        err = lib.flash_fwd_error_string
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def _split(layout: str):
    if layout not in ("bshd", "bhsd"):
        raise ValueError(f"layout must be bshd|bhsd, got {layout!r}")
    # (seq axis, head axis)
    return (1, 2) if layout == "bshd" else (2, 1)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        layout: str = "bshd"):
    """Flash attention forward. q: [b, s, h, d] ("bshd") or [b, h, s, d]
    ("bhsd"); k/v the same with sk keys and h // group heads. Output in
    q's layout and dtype."""
    s_ax, h_ax = _split(layout)
    hq, hk = q.shape[h_ax], k.shape[h_ax]
    if hq % hk:
        raise ValueError(f"GQA requires heads({hq}) % kv_heads({hk})==0")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         layout=layout)
    return _launch(q, k, v, causal, s_ax, h_ax)


def _launch(q, k, v, causal, s_ax, h_ax):
    global launches
    d = q.shape[-1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{_HEAD_DIMS}, got {d}")
    vec = 16 // q.element_size()
    ts = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"{name} must match q's dtype and device")
        if t.shape[-1] != d:
            raise ValueError(f"{name} head_dim {t.shape[-1]} != {d}")
        # The kernel loads 16 bytes at a time along the head dim: a view
        # with other strides or an unaligned start gets a fresh copy.
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            t = t.clone(memory_format=torch.contiguous_format)
        ts.append(t)
    q, k, v = ts
    b, sq, h = q.shape[0], q.shape[s_ax], q.shape[h_ax]
    sk = k.shape[s_ax]
    if v.shape != k.shape or k.shape[0] != b:
        raise ValueError("k and v must share one shape with q's batch")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), t.stride(h_ax), t.stride(s_ax)]
    st = (ctypes.c_int64 * 12)(*strides)
    lib = _lib()
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_fwd_launch(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, h // k.shape[h_ax], sq, sk, st,
            int(causal), float(d ** -0.5), stream)
    _build.check(err, "flash_fwd_launch", lib.flash_fwd_error_string)
    launches += 1
    return out


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              layout: str = "bshd"):
    """Plain version of the kernel's arithmetic: f32 scores, top-left
    causal mask, unnormalized p = exp(s - rowmax) rounded to the value
    dtype for PV, divided by the f32 row sum at the end."""
    _split(layout)
    if layout == "bshd":
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    hq, hk = q.shape[1], k.shape[1]
    if hq != hk:
        k = k.repeat_interleave(hq // hk, dim=1)
        v = v.repeat_interleave(hq // hk, dim=1)
    d = q.shape[-1]
    sq, sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (d ** -0.5)
    if causal:
        dev = q.device
        mask = torch.arange(sq, device=dev)[:, None] >= \
            torch.arange(sk, device=dev)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    out = (pv / l.clamp_min(1e-30)).to(q.dtype)
    return out.transpose(1, 2) if layout == "bshd" else out
