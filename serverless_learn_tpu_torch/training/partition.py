"""Trainable/frozen partition for frozen-base fine-tuning (LoRA), the port of
``serverless_learn_tpu/training/partition.py`` on the port's flat state
dicts (``{dotted name: tensor}``) and masks (``{dotted name: bool}``).

The reference prunes the trainable subtree out of the params, differentiates
only it and overlays it back. Here the same partition is expressed by
``requires_grad``: :func:`set_trainable` freezes every parameter the mask
leaves out, so autograd computes no weight gradient for the frozen base
(its forward and input-gradient products remain), and the optimizer, the
global norm and the clipping see only the trainable parameters.
:func:`prune` and :func:`overlay` keep the reference's two tree operations
for state dicts.
"""

from __future__ import annotations

from typing import Dict, Mapping

from torch import nn


def prune(tree: Mapping[str, object], mask: Mapping[str, bool]) -> Dict:
    """The entries of ``tree`` whose ``mask`` entry is True. Raises if
    nothing is trainable (a silent no-op optimizer is never what the caller
    meant)."""
    out = {k: v for k, v in tree.items() if mask[k]}
    if not out:
        raise ValueError("trainable mask selects no parameters")
    return out


def overlay(full: Mapping[str, object], sub: Mapping[str, object]) -> Dict:
    """``full`` with every entry present in ``sub`` replaced by ``sub``'s."""
    return {k: sub.get(k, v) for k, v in full.items()}


def set_trainable(model: nn.Module, mask: Mapping[str, bool]) -> None:
    """``requires_grad`` on exactly the parameters ``mask`` selects; raises,
    as :func:`prune` does, if it selects none, and if it selects a leaf
    that cannot train: an int8 base leaf (QLoRA), which the reference never
    differentiates either."""
    params = dict(model.named_parameters())
    bad = [n for n, p in prune(params, mask).items()
           if not p.is_floating_point()]
    if bad:
        raise ValueError(f"trainable mask selects {len(bad)} non-float "
                         f"(int8) leaves, e.g. {bad[:3]}; they cannot train")
    for name, p in params.items():
        p.requires_grad_(bool(mask[name]))
