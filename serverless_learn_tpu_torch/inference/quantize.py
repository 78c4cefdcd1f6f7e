"""Weight-only int8 quantization for inference, port of
``serverless_learn_tpu/inference/quantize.py`` for the dense projection
sites (q/k/v/o, the SwiGLU MLP, ``lm_head``).

Each projection ``{kernel [I, O]}`` becomes ``{kernel_q int8 [I, O],
scale f32 [O]}`` with a symmetric per-output-channel scale: max-abs over the
contracted dims / 127, clamped at 1e-12. The reference names how many
leading kernel dims each site contracts (``n_contract={"o_proj": 2}``);
here every kernel is already flattened to ``[I, O]`` (see
``models/transformer.py``), so the contraction is always dim 0 and o_proj's
two contracted dims are the flattened ``H*D``. Embedding and norms keep
their dtype.

MoE experts (``layer_i.moe.expert_gate`` / ``expert_up`` ``[E, D, F]``,
``expert_down`` ``[E, F, D]``) become ``expert_*_q`` int8 and
``expert_*_scale`` f32 ``[E, out]``: per (expert, out-channel), the
contraction their middle dim, the recipe of the projections with the
expert dim a batch dim. Stacked ``[L, E, ...]`` expert leaves (a
pipelined tree) are refused, as the reference refuses them: their middle
dim is not the contraction. The router stays f32.
"""

from __future__ import annotations

from typing import Dict, Set

import torch

from serverless_learn_tpu_torch.models.common import leaf_generator
from serverless_learn_tpu_torch.models.transformer import (Transformer,
                                                           _init_lora)
from serverless_learn_tpu_torch.ops.moe import EXPERTS

QUANT_DIRS: Set[str] = {
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj", "lm_head",
}


_RANDOM_SCALE = 2.5 * 0.02 / 127.0


def _site(name: str) -> str:
    parts = name.split(".")
    return parts[-2] if len(parts) >= 2 else ""


def _is_expert(name: str) -> bool:
    return _site(name) == "moe" and name.split(".")[-1] in EXPERTS


def _is_expert_scale(name: str) -> bool:
    leaf = name.split(".")[-1]
    return (_site(name) == "moe" and leaf.endswith("_scale")
            and leaf[:-len("_scale")] in EXPERTS)


def quantize_params_int8(state_dict: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """A float model's state dict -> the ``quant="int8"`` model's."""
    out = {}
    for name, t in state_dict.items():
        if _is_expert(name):
            if t.ndim != 3:
                raise NotImplementedError(
                    "int8 quantization of stacked/pipelined MoE expert "
                    f"leaves (ndim {t.ndim}) is unsupported; quantize the "
                    "sequential [E, in, out] experts")
            w = t.to(torch.float32)
            s = torch.clamp(w.abs().amax(dim=1) / 127.0, min=1e-12)
            out[name + "_q"] = torch.clamp(
                torch.round(w / s[:, None, :]), -127, 127).to(torch.int8)
            out[name + "_scale"] = s
        elif name.endswith(".kernel") and _site(name) in QUANT_DIRS:
            w = t.to(torch.float32)
            s = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
            prefix = name[:-len("kernel")]
            out[prefix + "kernel_q"] = torch.clamp(
                torch.round(w / s), -127, 127).to(torch.int8)
            out[prefix + "scale"] = s
        else:
            out[name] = t
    return out


@torch.no_grad()
def random_quantized_params(model: Transformer, seed: int = 0) -> Transformer:
    """Fill a ``quant="int8"`` model in place, on its own device, directly in
    the int8 layout: ``kernel_q`` and ``expert_*_q`` uniform in [-127, 127],
    each projection's ``scale`` and each expert's ``expert_*_scale`` at
    2.5 * 0.02 / 127 (the per-channel max-abs of a 0.02-stddev kernel), the
    MoE router and the embedding table normal(0, 0.02), norm scales one, LoRA
    adapters as ``init_params`` fills them (``lora_b`` zero: a fresh QLoRA
    model is its base). Never builds the float tree, which for llama_8b
    would take 32 GB: a trainer fills its own model with it
    (``Trainer.init(fill=...)``), so one base lives on the card."""
    for name, t in model.state_dict().items():
        g = leaf_generator(seed, name, t.device)
        if _init_lora(name, t, g):
            continue
        if t.dtype == torch.int8:
            t.random_(-127, 128, generator=g)
        elif ((name.endswith(".scale") and _site(name) in QUANT_DIRS)
              or _is_expert_scale(name)):
            t.fill_(_RANDOM_SCALE)
        elif t.ndim >= 2:
            t.normal_(0.0, 0.02, generator=g)
        else:
            t.fill_(1.0)
    return model
