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
* the f32 embedding tables (``embedder``, BERT's ``pos_embedder``) and
  the norms' ``scale`` and ``bias`` pass through;
* a conv kernel (the one 4-D ``kernel``) is flax's HWIO and PyTorch's
  OIHW; dense kernels ``[I, O]`` and their biases pass through;
* BatchNorm's ``batch_stats`` (``mean``, ``var``) are the port's module
  buffers of those names: :func:`from_jax_variables` and
  :func:`to_jax_variables` carry the ``params`` and ``batch_stats``
  collections together;
* MoE leaves (``layer_i.moe.router`` ``[D, E]``, ``expert_gate`` /
  ``expert_up`` ``[E, D, F]``, ``expert_down`` ``[E, F, D]``, and int8
  ``expert_*_q`` with ``expert_*_scale`` ``[E, out]``) pass through: the
  port keeps the reference's layout, each expert's slice already ``[I,
  O]``.

The same reshapes map optimizer moments, which have their parameter's
shape: :func:`to_flax` and :func:`from_flax` do it on tensors, as views,
for checkpoints (``training/checkpoint.py``). ``cfg`` (a transformer's
``TransformerConfig``) is read only at the attention projections.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple, TypeVar

import numpy as np
import torch

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


def _is_conv(leaf_name: str, shape) -> bool:
    return leaf_name == "kernel" and len(shape) == 4


def port_shape(name: str, shape) -> Tuple[int, ...]:
    """The port's shape of the flax leaf at ``name`` of shape ``shape``."""
    parts = name.split(".")
    site, leaf_name = (parts[-2], parts[-1]) if len(parts) > 1 else ("", "")
    shape = tuple(shape)
    if _is_conv(leaf_name, shape):  # HWIO -> OIHW
        return (shape[3], shape[2], shape[0], shape[1])
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
        if _is_conv(name.rsplit(".", 1)[-1], a.shape):
            a = np.array(a.transpose(3, 2, 0, 1), order="C")
        else:  # a writable copy
            a = np.array(a.reshape(port_shape(name, a.shape)), order="C")
        if a.dtype.name == "bfloat16":
            out[name] = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(a)
    return out


def _jax_shape(parts, shape, cfg):
    site, leaf_name = (parts[-2], parts[-1]) if len(parts) > 1 else ("", "")
    if _is_conv(leaf_name, shape):  # OIHW -> HWIO
        return (shape[2], shape[3], shape[1], shape[0])
    if site not in _N_CONTRACT and site != "lora_b":
        return tuple(shape)
    H, K, D, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
    heads = {"q_proj": H, "k_proj": K, "v_proj": K}
    if site == "lora_b" and leaf_name == "kernel":
        return (shape[0], {"q_lora": H, "v_lora": K}[parts[-3]], D)
    if site in heads and leaf_name in ("kernel", "kernel_q"):
        return (d, heads[site], D)
    if site in heads and leaf_name == "scale":
        return (heads[site], D)
    if site == "o_proj" and leaf_name in ("kernel", "kernel_q"):
        return (H, D, d)
    return tuple(shape)


def flax_shape(name: str, shape, cfg: Any) -> Tuple[int, ...]:
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


def _flax_view(name: str, t: torch.Tensor, cfg) -> torch.Tensor:
    if _is_conv(name.rsplit(".", 1)[-1], t.shape):
        return t.permute(2, 3, 1, 0)
    return t.reshape(_jax_shape(name.split("."), t.shape, cfg))


def to_flax(named: Mapping[str, torch.Tensor], cfg: Any) -> dict:
    """The port's named tensors (parameters, or optimizer moments keyed by
    their parameter's name) -> the flax tree of the same tensors seen in
    flax's shapes: views, so nothing is copied and writing into a leaf
    writes into the port's tensor."""
    return nest({n: _flax_view(n, t, cfg) for n, t in named.items()})


def from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """A flax tree of tensors -> the port's named tensors (views in the
    port's shapes); the inverse of :func:`to_flax`."""
    return {name: (t.permute(3, 2, 0, 1)
                   if _is_conv(name.rsplit(".", 1)[-1], t.shape)
                   else t.reshape(port_shape(name, t.shape)))
            for name, t in _flatten(tree)}


def _host(node):
    if isinstance(node, dict):
        return {k: _host(v) for k, v in node.items()}
    t = node.detach().cpu()
    return np.ascontiguousarray(
        (t.float() if t.dtype == torch.bfloat16 else t).numpy())


def to_jax_params(state_dict: Dict[str, torch.Tensor], cfg: Any) -> dict:
    """The port's state dict -> a flax params tree of numpy arrays, bf16
    read as f32 (the inverse of :func:`from_jax_params`)."""
    return _host(to_flax(state_dict, cfg))


def to_jax_variables(model: torch.nn.Module, cfg: Any = None) -> dict:
    """A model's ``{"params": ..., "batch_stats": ...}`` as flax trees of
    numpy arrays (``batch_stats`` only where the model keeps buffers: its
    BatchNorm running statistics)."""
    out = {"params": to_jax_params(dict(model.named_parameters()), cfg)}
    buffers = dict(model.named_buffers())
    if buffers:
        out["batch_stats"] = to_jax_params(buffers, cfg)
    return out


def from_jax_variables(variables: Mapping[str, dict]
                       ) -> Dict[str, torch.Tensor]:
    """flax's ``{"params": ..., "batch_stats": ...}`` (numpy) -> one state
    dict of the port's parameters and buffers."""
    out = from_jax_params(variables["params"])
    out.update(from_jax_params(variables.get("batch_stats", {})))
    return out
