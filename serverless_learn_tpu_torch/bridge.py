"""Maps the reference's flax parameter trees to the port's state dicts and
back, on numpy arrays, so the port itself never imports JAX.

A flax tree is a nested dict (``{"layer_0": {"attn": {"q_proj": {"kernel":
...}}}}``); its paths joined with dots are the port's state-dict keys.
Projection leaves are flattened to the port's ``[I, O]`` layout:

* ``DenseGeneral`` q/k/v kernels ``[d, H, D]`` -> ``[d, H*D]``; o_proj
  ``[H, D, d]`` (two contracted dims) -> ``[H*D, d]``; the MLP and
  ``lm_head`` are already ``[I, O]``;
* int8 ``kernel_q`` the same way, and its ``scale`` (``[H, D]`` for q/k/v)
  flattened to ``[O]``;
* LoRA adapters: ``lora_a`` ``[d, r]`` passes through, ``lora_b`` ``[r, H,
  D]`` (``q_lora``) or ``[r, K, D]`` (``v_lora``) becomes ``[r, H*D]`` /
  ``[r, K*D]``;
* the f32 embedding table and the norm scales pass through.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from serverless_learn_tpu_torch.models.transformer import TransformerConfig

# Projection -> number of leading kernel dims it contracts.
_N_CONTRACT = {"q_proj": 1, "k_proj": 1, "v_proj": 1, "o_proj": 2,
               "gate_proj": 1, "up_proj": 1, "down_proj": 1, "lm_head": 1}


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


def from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """A flax params tree of numpy arrays -> the port's state dict."""
    out = {}
    for name, leaf in _flatten(tree):
        a = np.asarray(leaf)
        parts = name.split(".")
        site, leaf_name = (parts[-2], parts[-1]) if len(parts) > 1 else ("", "")
        if site in _N_CONTRACT and leaf_name in ("kernel", "kernel_q"):
            nc = _N_CONTRACT[site]
            a = a.reshape(int(np.prod(a.shape[:nc])), -1)
        elif site in _N_CONTRACT and leaf_name == "scale":
            a = a.reshape(-1)
        elif site == "lora_b" and leaf_name == "kernel":
            a = a.reshape(a.shape[0], -1)
        out[name] = torch.from_numpy(np.array(a, order="C"))  # a writable copy
    return out


def _jax_shape(parts, shape, cfg: TransformerConfig):
    H, K, D, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    heads = {"q_proj": H, "k_proj": K, "v_proj": K}
    site, leaf_name = (parts[-2], parts[-1]) if len(parts) > 1 else ("", "")
    if site == "lora_b" and leaf_name == "kernel":
        return (shape[0], {"q_lora": H, "v_lora": K}[parts[-3]], D)
    if site in heads and leaf_name in ("kernel", "kernel_q"):
        return (d, heads[site], D)
    if site in heads and leaf_name == "scale":
        return (heads[site], D)
    if site == "o_proj" and leaf_name in ("kernel", "kernel_q"):
        return (H, D, d)
    return tuple(shape)


def to_jax_params(state_dict: Dict[str, torch.Tensor],
                  cfg: TransformerConfig) -> dict:
    """The port's state dict -> a flax params tree of numpy arrays (the
    inverse of :func:`from_jax_params`)."""
    tree: dict = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        a = t.detach().cpu()
        a = (a.to(torch.float32) if a.dtype == torch.bfloat16 else a).numpy()
        a = a.reshape(_jax_shape(parts, a.shape, cfg))
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree
