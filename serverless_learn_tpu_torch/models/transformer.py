"""The transformer, port of ``serverless_learn_tpu/models/transformer.py``, in
its two forms: Llama-style (causal, RoPE, RMSNorm, SwiGLU) and BERT-style
(``causal=False``, learned positions in ``pos_embedder``, LayerNorm, a GeLU
MLP ``wi``/``wo``). The training forward attends through
``ops.attention.dot_product_attention``, flash at long sequences; with
``suffix_padding_mask`` an integer key mask ``[B, 1, 1, S]`` is read as
suffix padding and its row sums become the flash kernels' ``kv_lengths``
("len" mode, taken from T >= 512). For serving, the causal RoPE form also
runs batched prefill, per-token decode and ``extend`` (append T tokens at
each row's index) over a monolithic KV cache (:class:`KVCache`) or a paged
one (``inference.kvcache.PagedKVCache``); all three attend through the
dense form, as the reference's do, and raise for a non-causal or
learned-position model, as the reference does.

Parameter names follow the flax module's paths (``layer_0.attn.q_proj.
kernel``, ``embedder.embedding`` ...), so ``bridge.py`` maps the two trees
one to one. Projection kernels are stored flattened to ``[I, O]``: q/k/v
``[d, H, D]`` becomes ``[d, H*D]`` and o_proj, which contracts two dims,
``[H, D, d]`` becomes ``[H*D, d]``. Under ``quant="int8"`` every projection
holds ``kernel_q`` int8 ``[I, O]`` and ``scale`` f32 ``[O]`` and runs the
weight-only int8 kernel (``ops/quant_matmul.py``): 7 launches per layer
plus ``lm_head``.

The KV cache is updated in place (the reference returns a new cache each
step); that keeps one copy of an 8 GB cache on the card.

With ``lora_rank > 0`` each attention layer also holds ``q_lora`` and
``v_lora`` adapters (:class:`LoRAAdapter`) whose deltas are added to the q
and v projections before the rotation, as the reference adds them.

With ``n_experts > 0`` each block's MLP is a mixture of experts
(``ops/moe.MoELayer``, under ``layer_i.moe``): routed in groups of
``moe_group_size`` tokens in the training forward, and per token under
prefill, decode and extend, as the reference's ``Block`` routes, so a
cached decode equals the full forward. ``forward(..., return_aux=True)``
also returns the layers' summed load-balance loss (the reference's
``"losses"`` collection, which its ``apply_with_losses`` gathers). Under
``quant="int8"`` the experts are int8 too: 3 K6 launches an expert and
layer.

A model built with ``trainable=True`` has every float parameter but the
int8 base's ``requires_grad`` (the trainer then freezes what the bundle's
trainable mask leaves out, ``training/partition.py``); serving builds it
without and runs under ``no_grad``. ``quant="int8"`` trains only with
``lora_rank > 0`` (QLoRA): the adapters learn over the frozen int8 base,
whose projections pass the gradient to their inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from serverless_learn_tpu_torch.config import not_ported
from serverless_learn_tpu_torch.inference.kvcache import PagedKVCache
from serverless_learn_tpu_torch.models.common import as_dtype, leaf_generator
from serverless_learn_tpu_torch.ops.attention import (dot_product_attention,
                                                      xla_attention)
from serverless_learn_tpu_torch.ops.moe import MoELayer
from serverless_learn_tpu_torch.ops.quant_matmul import QuantMatmul

@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The fields of the reference's config that the serving and training
    paths read. ``norm`` is "rms" or "layer", ``activation`` "swiglu" or
    "gelu"; ``tie_embeddings`` (no registered model sets it) is refused.
    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, the reference's ``nn.remat``)."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: Optional[int] = None  # None => MHA
    d_ff: int = 2048
    max_seq_len: int = 512
    causal: bool = True
    use_rope: bool = True  # False: learned positions (pos_embedder)
    rope_theta: float = 10000.0
    norm: str = "rms"  # "rms" | "layer"
    activation: str = "swiglu"  # "swiglu" | "gelu"
    tie_embeddings: bool = False
    # The attention mask is suffix padding (a valid prefix, a padded tail):
    # its row sums are the flash kernels' kv_lengths. A contract of the
    # data path (mlm_transform checks it); an interior pad would mask real
    # trailing tokens.
    suffix_padding_mask: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    quant: Optional[str] = None  # None | "int8" (weight-only; QLoRA trains)
    attention_impl: str = "auto"  # "auto" | "xla" | "flash" | "ring"
    remat: bool = False
    lora_rank: int = 0  # > 0: LoRA adapters on the q and v projections
    lora_alpha: float = 16.0
    n_experts: int = 0  # 0: the dense MLP; > 0: MoE (ops/moe.py)
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    # Training's routing-group tokens (0: the whole row). It bounds slot
    # competition and sets the granularity of the load-balance loss (a
    # mean of per-group terms), so changing it changes the loss's value.
    moe_group_size: int = 1024
    # The reference's expert and tensor parallelism inside a pipeline
    # stage: multi-device, refused unless at these defaults.
    manual_ep_axis: Optional[str] = None
    moe_global_experts: int = 0
    manual_tp_axis: Optional[str] = None

    def __post_init__(self):
        for name in ("manual_ep_axis", "moe_global_experts",
                     "manual_tp_axis"):
            if getattr(self, name):
                raise not_ported(
                    f"{name} (manual expert/tensor parallelism inside a "
                    "pipeline stage)", "ROADMAP.md queue 1 item 4a")
        object.__setattr__(self, "dtype", as_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_dtype(self.param_dtype))
        if self.tie_embeddings:
            raise not_ported("tie_embeddings (a head that reads the "
                             "embedding table)", "ROADMAP.md queue 1 item 5")
        if self.norm not in ("rms", "layer"):
            raise ValueError(f"unknown norm {self.norm!r} (rms | layer)")
        if self.activation not in ("swiglu", "gelu"):
            raise ValueError(f"unknown activation {self.activation!r} "
                             "(swiglu | gelu)")
        if self.quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {self.quant!r} (int8)")
        if self.attention_impl not in ("auto", "xla", "flash", "ring"):
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r}")
        if self.n_heads % self.kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"kv heads {self.kv_heads}")

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [B, T] -> (sin, cos) each [B, T, head_dim/2], in f32."""
    freqs = 1.0 / theta ** (torch.arange(
        0, head_dim, 2, dtype=torch.float32, device=positions.device)
        / head_dim)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x [B, T, H, D]; rotate interleaved pairs (x[2i], x[2i+1])."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    s, c = sin[:, :, None, :], cos[:, :, None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: statistics in f32, epsilon 1e-6, f32 scale,
    output in ``dtype``."""

    def __init__(self, dim: int, dtype, param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = xf.square().mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + 1e-6) * self.scale.to(torch.float32)
        return (xf * mul).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics over the last dim, the
    variance E[x^2] - E[x]^2 clipped at zero, epsilon 1e-6 (torch's default
    is 1e-5), f32 scale and bias, output in ``dtype``."""

    def __init__(self, dim: int, dtype, param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(
            torch.ones(dim, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(
            torch.zeros(dim, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf.square().mean(dim=-1, keepdim=True)
               - mean.square()).clamp_min(0.0)
        mul = torch.rsqrt(var + 1e-6) * self.scale.to(torch.float32)
        return ((xf - mean) * mul
                + self.bias.to(torch.float32)).to(self.dtype)


def _norm(cfg: "TransformerConfig", device) -> nn.Module:
    cls = RMSNorm if cfg.norm == "rms" else LayerNorm
    return cls(cfg.d_model, cfg.dtype, cfg.param_dtype, device)


class Embed(nn.Module):
    """flax ``nn.Embed``: a ``param_dtype`` table read in ``dtype``."""

    def __init__(self, num: int, dim: int, dtype, param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(
            torch.empty(num, dim, dtype=param_dtype, device=device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return nn.functional.embedding(tokens, self.embedding).to(self.dtype)


class DenseGeneral(nn.Module):
    """A bias-free projection ``x @ kernel`` computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 param_dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(
            in_features, out_features, dtype=param_dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class QuantDenseGeneral(nn.Module):
    """Weight-only int8 projection: int8 kernel, per-output-channel f32
    scale, output in ``dtype``. Weights come from
    ``inference/quantize.py``. Both are parameters that never train, as in
    the reference, where they are ``self.param`` leaves: the params tree,
    checkpoints and the FLOP count see the base; the gradient reaches x
    alone (:class:`QuantMatmul`)."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel_q = nn.Parameter(torch.zeros(
            in_features, out_features, dtype=torch.int8, device=device),
            requires_grad=False)
        self.scale = nn.Parameter(torch.ones(
            out_features, dtype=torch.float32, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The kernel rounds x to bf16 either way, so casting first to the
        # output dtype changes no value.
        return QuantMatmul.apply(x.to(self.dtype), self.kernel_q, self.scale)


class LoRAAdapter(nn.Module):
    """The low-rank delta added to a frozen projection's output,
    ``x @ lora_a @ lora_b * (alpha / rank)``, computed in ``dtype``:
    ``lora_a [I, rank]`` starts normal(0.02), ``lora_b [rank, O]`` at zero,
    so a fresh adapter leaves the base model's output unchanged."""

    def __init__(self, in_features: int, rank: int, alpha: float,
                 out_features: int, dtype, param_dtype, device=None):
        super().__init__()
        self.lora_a = DenseGeneral(in_features, rank, dtype, param_dtype,
                                   device)
        self.lora_b = DenseGeneral(rank, out_features, dtype, param_dtype,
                                   device)
        self.scale = alpha / rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lora_b(self.lora_a(x)) * self.scale


def _proj(cfg: TransformerConfig, in_features: int, out_features: int,
          device) -> nn.Module:
    if cfg.quant == "int8":
        return QuantDenseGeneral(in_features, out_features, cfg.dtype, device)
    return DenseGeneral(in_features, out_features, cfg.dtype, cfg.param_dtype,
                        device)


@dataclasses.dataclass
class KVCache:
    """Per-layer ``[B, max_seq_len, K, D]`` keys and values and the ``[B]``
    int32 position of each row's next token."""

    k: List[torch.Tensor]
    v: List[torch.Tensor]
    index: torch.Tensor


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        H, K, D, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
        self.q_proj = _proj(cfg, d, H * D, device)
        self.k_proj = _proj(cfg, d, K * D, device)
        self.v_proj = _proj(cfg, d, K * D, device)
        self.o_proj = _proj(cfg, H * D, d, device)
        if cfg.lora_rank > 0:
            lora = lambda out: LoRAAdapter(d, cfg.lora_rank, cfg.lora_alpha,
                                           out, cfg.dtype, cfg.param_dtype,
                                           device)
            self.q_lora = lora(H * D)
            self.v_lora = lora(K * D)

    def forward(self, x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                *, mode: Optional[str] = None, kv=None, index=None,
                mask=None, write=None, table=None) -> torch.Tensor:
        """``mode`` None: self-attention over x, causal unless the config
        says otherwise, under the key ``mask`` if one is given (a suffix
        padding mask becomes ``kv_lengths``). "prefill": causal, and the
        keys/values land at cache positions [0, T). "decode" /
        "extend": x is T tokens per row (1 for decode), written at cache
        positions ``index[b] + t``; attention reads the whole cache under
        ``mask`` (keys at positions <= the query's). "paged": the T tokens
        land at the pool pages and offsets ``write`` = (page ids, offsets),
        each [B*T]; attention reads the ``table`` [B, W] window's pages
        under ``mask``."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, K, D = cfg.n_heads, cfg.kv_heads, cfg.head_dim
        q, v = self.q_proj(x), self.v_proj(x)
        if cfg.lora_rank > 0:  # before the rotation, in every mode
            q = q + self.q_lora(x)
            v = v + self.v_lora(x)
        q = q.reshape(B, T, H, D)
        k = self.k_proj(x).reshape(B, T, K, D)
        if cfg.use_rope:
            q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
        v = v.reshape(B, T, K, D)
        if mode == "paged":
            pk, pv = kv
            ids, offs = write
            pk[ids, offs] = k.reshape(B * T, K, D)
            pv[ids, offs] = v.reshape(B * T, K, D)
            S = table.shape[1] * pk.shape[1]
            out = xla_attention(q, pk[table].reshape(B, S, K, D),
                                pv[table].reshape(B, S, K, D), mask=mask)
        elif mode in ("decode", "extend"):
            ck, cv = kv
            rows = torch.arange(B, device=x.device)[:, None]
            ck[rows, index] = k
            cv[rows, index] = v
            out = xla_attention(q, ck, cv, mask=mask)
        elif mode == "prefill":
            ck, cv = kv
            ck[:, :T] = k
            cv[:, :T] = v
            # Right-padded rows: real token i attends only to [0, i], all
            # real; pad positions produce values nobody reads.
            out = xla_attention(q, k, v, causal=True)
        else:
            kv_lengths = None
            if (cfg.suffix_padding_mask and mask is not None
                    and mask.ndim == 4 and mask.shape[1:3] == (1, 1)
                    and not mask.is_floating_point()):
                # A float mask may be additive (0 = keep): its row sums
                # would be garbage lengths, so it stays a mask.
                kv_lengths = mask[:, 0, 0, :].to(torch.int32).sum(-1)
            out = dot_product_attention(q, k, v, causal=cfg.causal,
                                        mask=mask, kv_lengths=kv_lengths,
                                        impl=cfg.attention_impl)
        return self.o_proj(out.reshape(B, T, H * D))


class MlpBlock(nn.Module):
    """SwiGLU, down(silu(gate(x)) * up(x)); or with ``activation="gelu"``
    wo(gelu(wi(x))), flax's ``nn.gelu``: the tanh approximation."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.gelu = cfg.activation == "gelu"
        if self.gelu:
            self.wi = _proj(cfg, cfg.d_model, cfg.d_ff, device)
            self.wo = _proj(cfg, cfg.d_ff, cfg.d_model, device)
            return
        self.gate_proj = _proj(cfg, cfg.d_model, cfg.d_ff, device)
        self.up_proj = _proj(cfg, cfg.d_model, cfg.d_ff, device)
        self.down_proj = _proj(cfg, cfg.d_ff, cfg.d_model, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gelu:
            return self.wo(nn.functional.gelu(self.wi(x), approximate="tanh"))
        gate = nn.functional.silu(self.gate_proj(x))
        return self.down_proj(gate * self.up_proj(x))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm_attn = _norm(cfg, device)
        self.attn = Attention(cfg, device)
        self.norm_mlp = _norm(cfg, device)
        if cfg.n_experts > 0:
            self.moe = MoELayer(cfg, device)
        else:
            self.mlp = MlpBlock(cfg, device)

    def forward(self, x, sin, cos, **attn_kw):
        """(x after the block, the MoE layer's weighted aux loss or None).
        Any attention mode but the training forward's routes the MoE layer
        per token, with no aux loss."""
        x = x + self.attn(self.norm_attn(x), sin, cos, **attn_kw)
        if self.cfg.n_experts <= 0:
            return x + self.mlp(self.norm_mlp(x)), None
        y, aux = self.moe(self.norm_mlp(x),
                          per_token=attn_kw.get("mode") is not None)
        return x + y, aux


class Transformer(nn.Module):
    """tokens [B, T] -> logits [B, T, vocab] in ``cfg.dtype``.

    Tensors are allocated on ``device`` uninitialised; fill them with
    :func:`init_params` (training), :func:`random_params` (serving),
    ``inference.quantize.random_quantized_params`` or ``load_state_dict``
    (for example from ``bridge.from_jax_params``)."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 trainable: bool = False):
        super().__init__()
        if trainable and cfg.quant is not None and cfg.lora_rank <= 0:
            # QLoRA (LoRA over the int8 base) trains; the base alone would
            # need a straight-through estimator, which the reference has not.
            raise ValueError("training with quant set is unsupported without "
                             "lora_rank > 0, as in the reference")
        self.cfg = cfg
        self.embedder = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype,
                              cfg.param_dtype, device)
        if not cfg.use_rope:
            self.pos_embedder = Embed(cfg.max_seq_len, cfg.d_model,
                                      cfg.dtype, cfg.param_dtype, device)
        self.layers: List[Block] = []
        for i in range(cfg.n_layers):
            block = Block(cfg, device)
            self.add_module(f"layer_{i}", block)
            self.layers.append(block)
        self.norm_f = _norm(cfg, device)
        self.lm_head = _proj(cfg, cfg.d_model, cfg.vocab_size, device)
        base = {id(p) for m in self.modules()
                if isinstance(m, QuantDenseGeneral) for p in m.parameters()}
        base |= {id(p) for m in self.modules() if isinstance(m, MoELayer)
                 for p in m.frozen()}
        for p in self.parameters():
            p.requires_grad_(trainable and id(p) not in base)

    @property
    def device(self) -> torch.device:
        return self.embedder.embedding.device

    def forward(self, tokens: torch.Tensor, *,
                mask: Optional[torch.Tensor] = None,
                cache: Optional[Union[KVCache, PagedKVCache]] = None,
                prefill: bool = False, decode: bool = False,
                extend: bool = False,
                seq_lengths: Optional[torch.Tensor] = None,
                return_aux: bool = False):
        """``mask``: the training forward's key mask, broadcastable to
        [B, 1, T, S], nonzero = attend (a suffix padding mask under
        ``suffix_padding_mask``). ``prefill=True``: one causal forward over
        right-padded prompts that fills ``cache``; ``seq_lengths`` [B] gives each row's true
        length, which becomes its cache index (default T). ``decode=True``:
        ``tokens`` is [B, 1], the newest token of each row, placed at the
        row's cache index; the index then advances by one. ``extend=True``:
        ``tokens`` [B, T] land at positions ``index + t`` (RoPE at those
        absolute positions) and query t of row b sees cached keys
        [0, index_b + t]; the index advances by T.

        Over a :class:`PagedKVCache` the three modes are one ragged append
        at each row's index, as in the reference: ``seq_lengths`` [B] (default
        T) real tokens a row are written through the table window, pad
        positions and positions past the window go to the scratch page, and
        attention reads the window's ``W * block_size`` positions.

        ``return_aux=True`` returns ``(logits, aux)``: the MoE layers'
        summed weighted load-balance losses, an f32 zero without MoE or
        under a cache."""
        if prefill + decode + extend > 1:
            raise ValueError("prefill, decode and extend are mutually "
                             "exclusive")
        cfg = self.cfg
        if prefill or decode or extend:
            if not cfg.causal:
                raise ValueError("decode requires a causal model")
            if not cfg.use_rope:
                # Learned positions would need the cache index here.
                raise NotImplementedError("decode requires use_rope=True")
            if cache is None:
                raise ValueError("prefill, decode and extend need a KV cache "
                                 "(init_cache)")
        B, T = tokens.shape
        x = self.embedder(tokens)
        kw = {} if mask is None else {"mask": mask}
        if decode and T != 1:
            raise ValueError(f"decode feeds one token at a time, got T={T}")
        steps = torch.arange(T, device=x.device, dtype=torch.int32)
        if isinstance(cache, PagedKVCache):
            index = cache.index
            positions = index[:, None] + steps  # [B, T]
            new_len = (torch.full((B,), T, dtype=torch.int32, device=x.device)
                       if seq_lengths is None
                       else seq_lengths.to(device=x.device, dtype=torch.int32))
            table = cache.table.long()
            ps, W = cache.block_size, table.shape[1]
            page_idx = (positions // ps).long()
            ids = table.gather(1, page_idx.clamp(max=W - 1))
            # Pad positions and positions past the window go to the scratch
            # page: the pool is shared, so a stray write would land in
            # another sequence's page.
            ids = torch.where((steps[None, :] < new_len[:, None])
                              & (page_idx < W), ids, cache.sentinel)
            mask = (torch.arange(W * ps, device=x.device)[None, None, :]
                    <= positions[:, :, None])[:, None]  # [B, 1, T, S]
            kw = dict(mode="paged", mask=mask, table=table,
                      write=(ids.reshape(-1),
                             (positions % ps).reshape(-1).long()))
        elif decode or extend:
            index = cache.index
            positions = index[:, None] + steps
            S = cfg.max_seq_len
            # The reference writes with dynamic_update_slice, which moves a
            # span that would run past the cache back inside it; the rows
            # that reach this are padding or finished ones.
            start = index.clamp(0, S - T)
            mask = (torch.arange(S, device=x.device)[None, None, :]
                    <= positions[:, :, None])[:, None]  # [B, 1, T, S]
            kw = dict(mode="extend", index=(start[:, None] + steps).long(),
                      mask=mask)
        else:
            if prefill and T > cfg.max_seq_len:
                raise ValueError(f"prompt length {T} exceeds max_seq_len "
                                 f"{cfg.max_seq_len}")
            positions = torch.arange(T, device=x.device)[None, :].expand(B, T)
            if prefill:
                kw = dict(mode="prefill")
        if cfg.use_rope:
            sin, cos = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        else:
            sin = cos = None
            x = x + self.pos_embedder(positions)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        aux = None
        for i, block in enumerate(self.layers):
            if isinstance(cache, PagedKVCache):
                kw["kv"] = (cache.pages_k[i], cache.pages_v[i])
            elif cache is not None:
                kw["kv"] = (cache.k[i], cache.v[i])
            if remat:
                x, a = checkpoint(block, x, sin, cos, use_reentrant=False,
                                  **kw)
            else:
                x, a = block(x, sin, cos, **kw)
            if a is not None and return_aux:
                aux = a if aux is None else aux + a
        if isinstance(cache, PagedKVCache):
            cache.index = cache.index + new_len
        elif prefill:
            cache.index = (torch.full((B,), T, dtype=torch.int32,
                                      device=x.device)
                           if seq_lengths is None
                           else seq_lengths.to(torch.int32).to(x.device))
        elif decode or extend:
            cache.index = cache.index + T
        logits = self.lm_head(self.norm_f(x))
        if not return_aux:
            return logits
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return logits, aux


def _init_lora(name: str, t: torch.Tensor, gen: torch.Generator) -> bool:
    """Fill a LoRA adapter's tensor as flax's initializers do (``lora_a``
    normal(0.02), ``lora_b`` zeros); False for any other tensor."""
    if name.endswith("lora_a.kernel"):
        t.normal_(0.0, 0.02, generator=gen)
    elif name.endswith("lora_b.kernel"):
        t.zero_()
    else:
        return False
    return True


@torch.no_grad()
def random_params(model: Transformer, seed: int = 0) -> Transformer:
    """Fill a float model in place from ``seed``: kernels and the embedding
    tables normal(0, 0.02), norm scales one and biases zero, LoRA adapters as
    :func:`init_params` fills them."""
    for name, t in model.state_dict().items():
        if _init_lora(name, t, leaf_generator(seed, name, t.device)):
            continue
        if t.ndim >= 2:
            t.normal_(0.0, 0.02, generator=leaf_generator(seed, name, t.device))
        else:
            t.fill_(0.0 if name.endswith(".bias") else 1.0)
    return model


@torch.no_grad()
def init_params(model: Transformer, seed: int = 0) -> Transformer:
    """Fill a float model in place from ``seed`` with the distributions of
    the reference's flax initializers: projection kernels ``lecun_normal``
    (truncated normal over [-2, 2] std, scaled so the variance is 1 / fan_in,
    fan_in the contracted dims: ``[I, O]`` here, as flax's DenseGeneral
    flattens them; an expert stack ``[E, I, O]`` contracts I), the MoE
    router normal(0.02), the embedding table ``variance_scaling(1, "fan_in",
    "normal", out_axis=0)`` (normal, std 1 / sqrt(d_model)) and the learned
    positions' likewise, norm scales 1 and LayerNorm biases 0,
    LoRA's ``lora_a`` normal(0.02) and ``lora_b`` zeros; an int8 base as
    flax's initializers give it, ``kernel_q`` zeros and ``scale`` ones
    (a QLoRA run from scratch trains over that zero base, as the
    reference's does). The values differ from flax's, whose generator is
    JAX's."""
    for name, t in model.state_dict().items():
        gen = leaf_generator(seed, name, t.device)
        if _init_lora(name, t, gen):
            continue
        if t.dtype == torch.int8:
            t.zero_()
        elif name.endswith("embedding"):
            t.normal_(0.0, 1.0 / math.sqrt(t.shape[1]), generator=gen)
        elif name.endswith("moe.router"):
            t.normal_(0.0, 0.02, generator=gen)
        elif name.endswith("_scale"):  # int8 experts' scales
            t.fill_(1.0)
        elif name.endswith(".bias"):  # LayerNorm
            t.zero_()
        elif t.ndim >= 2:
            # 0.8796...: the std of a unit normal truncated to [-2, 2].
            # Experts [E, I, O] contract their middle dim.
            fan_in = t.shape[1] if t.ndim == 3 else t.shape[0]
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
        else:
            t.fill_(1.0)
    return model
