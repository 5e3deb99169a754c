"""Weights carried between the JAX model and the port.

The port's params are the JAX param tree's names and shapes with torch
tensors at the leaves. Both functions work on numpy arrays, so the port
never touches a JAX array: a caller holding JAX params converts each
leaf with ``np.asarray`` first (``jax.tree_util.tree_map(np.asarray,
params)``) and hands the numpy tree over.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device


def params_from_numpy(tree: dict, cfg=None, device=None) -> dict:
    """numpy param tree -> the port's params (same names, same shapes
    and dtypes) on ``device`` (``None`` means the card). ``cfg``, when
    given, checks the shapes against the configuration."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    out = conv(tree)
    if cfg is not None:
        want = {"wte": (cfg.vocab_size, cfg.d_model),
                "wpe": (cfg.max_seq, cfg.d_model),
                "ln_f": (cfg.d_model,),
                "wq": (cfg.n_layer, cfg.d_model, cfg.n_head, cfg.head_dim),
                "wk": (cfg.n_layer, cfg.d_model, cfg.kv_heads, cfg.head_dim),
                "wo": (cfg.n_layer, cfg.n_head, cfg.head_dim, cfg.d_model),
                "wi": (cfg.n_layer, cfg.d_model, cfg.ff)}
        flat = {**{k: v for k, v in out.items() if k != "blocks"},
                **out["blocks"]}
        for name, shape in want.items():
            if tuple(flat[name].shape) != shape:
                raise ValueError(f"param {name} has shape "
                                 f"{tuple(flat[name].shape)}, config wants "
                                 f"{shape}")
    return out


def params_to_numpy(params: dict) -> dict:
    """The port's params -> a numpy tree with the JAX names (bf16 leaves
    come back as float32: numpy has no bfloat16)."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    return conv(params)
