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
* the f32 embedding table and the norm scales pass through;
* MoE leaves (``layer_i.moe.router`` ``[D, E]``, ``expert_gate`` /
  ``expert_up`` ``[E, D, F]``, ``expert_down`` ``[E, F, D]``, and int8
  ``expert_*_q`` with ``expert_*_scale`` ``[E, out]``) pass through: the
  port keeps the reference's layout, each expert's slice already ``[I,
  O]``.

The same reshapes map optimizer moments, which have their parameter's
shape: :func:`to_flax` and :func:`from_flax` do it on tensors, as views,
for checkpoints (``training/checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, TypeVar

import numpy as np
import torch

from serverless_learn_tpu_torch.models.transformer import TransformerConfig

T = TypeVar("T")
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


def port_shape(name: str, shape) -> Tuple[int, ...]:
    """The port's shape of the flax leaf at ``name`` of shape ``shape``."""
    parts = name.split(".")
    site, leaf_name = (parts[-2], parts[-1]) if len(parts) > 1 else ("", "")
    shape = tuple(shape)
    if site in _N_CONTRACT and leaf_name in ("kernel", "kernel_q"):
        nc = _N_CONTRACT[site]
        return (int(np.prod(shape[:nc])), int(np.prod(shape[nc:])))
    if site in _N_CONTRACT and leaf_name == "scale":
        return (int(np.prod(shape)),)
    if site == "lora_b" and leaf_name == "kernel":
        return (shape[0], int(np.prod(shape[1:])))
    return shape


def from_jax_params(tree: dict) -> Dict[str, torch.Tensor]:
    """A flax params tree of numpy arrays -> the port's state dict (bf16
    leaves, ml_dtypes' as JAX hands them out, stay bf16)."""
    out = {}
    for name, leaf in _flatten(tree):
        a = np.asarray(leaf)
        a = np.array(a.reshape(port_shape(name, a.shape)), order="C")  # a writable copy
        if a.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(a)
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


def flax_shape(name: str, shape, cfg: TransformerConfig) -> Tuple[int, ...]:
    """The reference's shape of the port's tensor ``name`` of shape
    ``shape`` (the inverse of :func:`port_shape`)."""
    return tuple(_jax_shape(name.split("."), tuple(shape), cfg))


def nest(named: Mapping[str, T]) -> dict:
    """Dotted names -> a nested dict with its keys sorted at every level,
    the order of a flax tree that went through ``jax.tree_util`` (and so
    of the JAX package's checkpoints)."""
    tree: dict = {}
    for name, leaf in named.items():
        parts = name.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def order(node):
        return ({k: order(node[k]) for k in sorted(node)}
                if isinstance(node, dict) else node)

    return order(tree)


def to_flax(named: Mapping[str, torch.Tensor], cfg: TransformerConfig
            ) -> dict:
    """The port's named tensors (parameters, or optimizer moments keyed by
    their parameter's name) -> the flax tree of the same tensors seen in
    flax's shapes: views, so nothing is copied and writing into a leaf
    writes into the port's tensor."""
    return nest({n: t.reshape(_jax_shape(n.split("."), t.shape, cfg))
                 for n, t in named.items()})


def from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A flax tree of tensors -> the port's named tensors (views in the
    port's shapes); the inverse of :func:`to_flax`."""
    return {name: t.reshape(port_shape(name, t.shape))
            for name, t in _flatten(tree)}


def to_jax_params(state_dict: Dict[str, torch.Tensor],
                  cfg: TransformerConfig) -> dict:
    """The port's state dict -> a flax params tree of numpy arrays, bf16
    read as f32 (the inverse of :func:`from_jax_params`)."""
    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return host(to_flax(state_dict, cfg))
