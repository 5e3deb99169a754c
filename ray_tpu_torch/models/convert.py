"""Weights and optimizer state carried between the JAX model and the
port.

The port's params are the JAX param tree's names and shapes with torch
tensors at the leaves. Every function here works on numpy arrays, so the
port never touches a JAX array: a caller holding JAX params converts
each leaf with ``np.asarray`` first (``jax.tree_util.tree_map(np.asarray,
params)``) and hands the numpy tree over. Gradients are trees of the
same shape and go through ``params_to_numpy``; the optimizer state goes
through ``opt_state_from_numpy`` / ``opt_state_to_numpy``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .._tree import tree_map
from ..optim import AdamWState


def _tensor(x, dev) -> torch.Tensor:
    """numpy -> tensor; a bfloat16 leaf (JAX's, through ml_dtypes) comes
    over exactly through float32."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True)).to(dev)


def params_from_numpy(tree: dict, cfg=None, device=None) -> dict:
    """numpy param tree -> the port's params (same names, same shapes
    and dtypes) on ``device`` (``None`` means the card). ``cfg``, when
    given, checks the shapes against the configuration."""
    dev = resolve_device(device)

    out = tree_map(lambda x: _tensor(x, dev), tree)
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
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    return tree_map(conv, params)


def opt_state_from_numpy(state, device=None) -> AdamWState:
    """optax's ``ScaleByAdamState`` ``(count, mu, nu)`` as numpy trees
    (``jax.tree_util.tree_map(np.asarray, opt_state[0])`` of an
    ``optax.adamw`` state) -> the port's ``AdamWState`` on ``device``
    (``None`` means the card). A bfloat16 first moment stays bfloat16."""
    dev = resolve_device(device)
    count, mu, nu = state
    return AdamWState(
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32,
                           device=dev),
        mu=tree_map(lambda x: _tensor(x, dev), mu),
        nu=tree_map(lambda x: _tensor(x, dev), nu))


def opt_state_to_numpy(state: AdamWState):
    """The port's ``AdamWState`` -> ``(count, mu, nu)`` as numpy (count
    int32, moments as ``params_to_numpy`` gives them: bf16 as float32)."""
    return (np.asarray(int(state.count), np.int32),
            params_to_numpy(state.mu), params_to_numpy(state.nu))
