"""Mixture-of-experts layer, the port of ``serverless_learn_tpu/ops/moe.py``:
top-k routed SwiGLU experts in place of the dense MLP.

**Training** routes as the reference does: each batch row is split into
groups of at most ``moe_group_size`` tokens (the largest divisor of T that
fits), and slot competition, expert capacity and the dispatch tensors are
per group (:func:`top_k_routing`: static shapes, first choices ahead of
second choices, overflow dropped onto the residual branch). Tokens go to
their expert slots and back by two products with the one-hot dispatch and
the gate-weighted combine tensors; the experts run as batched products
over their slots. The load-balance loss is computed per group and
averaged, in f32, and the layer returns it times ``moe_aux_weight``; the
model's ``forward(..., return_aux=True)`` sums every layer's, and the
causal-LM bundle adds that to the loss, so an ``n_experts`` override on
any family keeps it.

**Inference** (prefill, decode and extend over a KV cache) routes each
token on its own (the reference's group size 1): every token gets its
full top-k experts, none dropped, so a cached decode equals the full
forward. Two forms compute the same function:

* :meth:`MoELayer._dense`: every expert runs over every row and the
  combine weights are zero where a row is not routed to it. Nothing waits
  for the host, so a decode step can be captured in a CUDA graph; at a
  decode bucket's few rows the products read every expert's weights
  either way;
* :meth:`MoELayer._gathered`: each expert runs over the rows routed to it
  alone (the per-expert row counts come to the host, one sync a layer:
  eager prefill chunks).

A layer takes the dense form at ``DENSE_MAX_ROWS`` rows or fewer and
whenever the stream is being captured, else the gathered form. The f32
sums add each row's experts in expert order in both forms.

The experts are ``[E, D, F]`` / ``[E, F, D]`` in ``param_dtype``, computed
in ``dtype`` through ``torch.matmul``; or, with ``quant="int8"``, int8
``expert_*_q`` with an f32 ``expert_*_scale`` per (expert, out-channel),
where every expert product is K6 (``ops.quant_matmul.QuantMatmul``) on the
expert's contiguous ``[D, F]`` / ``[F, D]`` slice and its scale row: three
launches an expert. The reference dequantizes the weight to bf16 before
its product; K6 rounds x to bf16 and applies the f32 scale to the f32 sum,
so the two differ by the bf16 rounding of ``q * scale``. The router is an
f32 ``[D, E]`` parameter and routing runs in f32.

The reference's manual expert and tensor parallelism inside a pipeline
stage (``manual_ep_axis``, ``moe_global_experts``, ``manual_tp_axis``) is
multi-device: ``models/transformer.TransformerConfig`` refuses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from serverless_learn_tpu_torch.ops.quant_matmul import QuantMatmul

EXPERTS = ("expert_gate", "expert_up", "expert_down")
# The most rows the inference forward runs in the dense form when it is
# not being captured. On one full-width Mixtral-8x7B int8 layer (H100,
# ``chip_smoke.py`` phase 15a) the dense form took 2.2-3.5 ms from 16 to
# 128 rows against the gathered form's 2.6-5.1 (its host sync and
# gathers), and 8.4-8.5 ms at 512 rows against 4.5-5.6 (four times the
# products).
DENSE_MAX_ROWS = 128


def top_k_routing(router_logits: torch.Tensor, n_experts: int, top_k: int,
                  capacity: int):
    """Grouped top-k routing with a capacity per group and expert.

    ``router_logits`` [G, S, E]: G groups of S tokens. Returns ``dispatch``
    [G, S, E, C] (1 where token s holds slot c of expert e), ``combine``
    [G, S, E, C] (the dispatch weighted by the renormalised gate
    probability) and ``aux``, the Switch load-balance loss
    ``E * sum_e frac_e * prob_e`` of each group, averaged over the groups
    (linear in any even split of the groups). All in f32."""
    G, S, E = router_logits.shape
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    gate_w, gate_idx = torch.topk(probs, top_k, dim=-1)  # [G, S, K]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(gate_idx, E).to(torch.float32)  # [G, S, K, E]
    # Slots within a group: every first choice ahead of every second
    # choice, tokens in order within a choice (k-major, an exclusive sum).
    flat = onehot.transpose(1, 2).reshape(G, top_k * S, E)
    pos = flat.cumsum(dim=1) - flat
    pos = pos.reshape(G, top_k, S, E).transpose(1, 2)  # [G, S, K, E]
    # A position past the capacity gets no slot: the token is dropped.
    kept = (pos < capacity).to(torch.float32)
    slot = F.one_hot(pos.long().clamp(max=capacity - 1), capacity).to(
        torch.float32) * kept[..., None]  # [G, S, K, E, C]
    disp_k = onehot[..., None] * slot
    combine = torch.einsum("gsk,gskec->gsec", gate_w, disp_k)
    dispatch = (disp_k.sum(dim=2) > 0).to(torch.float32)
    frac = onehot[:, :, 0, :].mean(dim=1)  # first choices, [G, E]
    mean_prob = probs.mean(dim=1)  # [G, E]
    aux = n_experts * (frac * mean_prob).sum(-1).mean()
    return dispatch, combine, aux


def group_size(T: int, limit: int) -> int:
    """The routing group: the largest divisor of T up to ``limit`` (0:
    the whole row)."""
    limit = min(limit or T, T)
    return max(d for d in range(1, limit + 1) if T % d == 0)


class MoELayer(nn.Module):
    """Top-k routed SwiGLU experts, ``x [B, T, D] -> (y [B, T, D], aux)``
    (module docstring)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(torch.empty(D, E, dtype=torch.float32,
                                               device=device))
        shapes = {"expert_gate": (E, D, Fd), "expert_up": (E, D, Fd),
                  "expert_down": (E, Fd, D)}
        self.quant = cfg.quant == "int8"
        for name, shape in shapes.items():
            if self.quant:
                self.register_parameter(name + "_q", nn.Parameter(
                    torch.zeros(shape, dtype=torch.int8, device=device),
                    requires_grad=False))
                self.register_parameter(name + "_scale", nn.Parameter(
                    torch.ones(shape[0], shape[2], dtype=torch.float32,
                               device=device), requires_grad=False))
            else:
                self.register_parameter(name, nn.Parameter(torch.empty(
                    shape, dtype=cfg.param_dtype, device=device)))

    def frozen(self):
        """The int8 experts and their scales: a base that never trains."""
        if not self.quant:
            return []
        return [getattr(self, n + s) for n in EXPERTS for s in ("_q",
                                                                 "_scale")]

    def _product(self, name: str, e: int, x: torch.Tensor) -> torch.Tensor:
        """``x [n, I] @ expert e's weight`` in ``dtype``."""
        if self.quant:
            return QuantMatmul.apply(x, getattr(self, name + "_q")[e],
                                     getattr(self, name + "_scale")[e])
        return x @ getattr(self, name)[e].to(self.cfg.dtype)

    def _expert(self, e: int, x: torch.Tensor) -> torch.Tensor:
        """SwiGLU expert e over the rows ``x [n, D]`` (in ``dtype``)."""
        h = F.silu(self._product("expert_gate", e, x)) \
            * self._product("expert_up", e, x)
        return self._product("expert_down", e, h)

    def forward(self, x: torch.Tensor, per_token: bool = False
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``per_token``: inference routing (aux None); else the grouped
        training routing with its weighted aux."""
        if per_token:
            return self._per_token(x), None
        return self._grouped(x)

    def _grouped(self, x: torch.Tensor):
        cfg = self.cfg
        E, K, dt = cfg.n_experts, cfg.moe_top_k, cfg.dtype
        B, T, D = x.shape
        gs = group_size(T, cfg.moe_group_size)
        G = B * (T // gs)
        xg = x.reshape(G, gs, D)
        capacity = max(1, int(cfg.moe_capacity_factor * K * gs / E))
        logits = xg.to(torch.float32) @ self.router.to(torch.float32)
        dispatch, combine, aux = top_k_routing(logits, E, K, capacity)
        xe = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), xg.to(dt))
        xe = xe.reshape(E, G * capacity, D)  # each expert's slots
        if self.quant:
            ye = torch.stack([self._expert(e, xe[e]) for e in range(E)])
        else:
            w = {n: getattr(self, n).to(dt) for n in EXPERTS}
            h = F.silu(torch.bmm(xe, w["expert_gate"])) \
                * torch.bmm(xe, w["expert_up"])
            ye = torch.bmm(h, w["expert_down"])
        ye = ye.reshape(E, G, capacity, D)
        y = torch.einsum("gsec,egcd->gsd", combine, ye.to(torch.float32))
        return y.reshape(B, T, D).to(dt), cfg.moe_aux_weight * aux

    def _route(self, x2: torch.Tensor):
        """Per-token routing of the rows ``x2 [R, D]``, in f32: the top-k
        gate weights renormalised to sum to 1, and their experts, [R, K]."""
        probs = torch.softmax(x2.to(torch.float32)
                              @ self.router.to(torch.float32), dim=-1)
        w, idx = torch.topk(probs, self.cfg.moe_top_k, dim=-1)
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), idx

    def _per_token(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1]).to(self.cfg.dtype)
        w, idx = self._route(x2)
        capturing = x2.is_cuda and torch.cuda.is_current_stream_capturing()
        if x2.shape[0] <= DENSE_MAX_ROWS or capturing:
            y = self._dense(x2, idx, w)
        else:
            y = self._gathered(x2, idx, w)
        return y.reshape(shape).to(self.cfg.dtype)

    def _dense(self, x2: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
               ) -> torch.Tensor:
        """Every expert over every row of ``x2``, each weighted by the
        row's combine weight (0 where ``idx`` leaves the expert out): f32
        [R, D], no host sync."""
        comb = torch.zeros(x2.shape[0], self.cfg.n_experts,
                           dtype=torch.float32, device=x2.device
                           ).scatter(1, idx, w)
        y = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        for e in range(self.cfg.n_experts):
            y = y + comb[:, e:e + 1] * self._expert(e, x2).to(torch.float32)
        return y

    def _gathered(self, x2: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
                  ) -> torch.Tensor:
        """Each expert over the rows of ``x2`` that ``idx`` routes to it,
        weighted and added back in expert order: f32 [R, D]. An expert
        with no row is skipped (K6 takes no zero-row launch)."""
        K = self.cfg.moe_top_k
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        rows = torch.div(order, K, rounding_mode="floor")
        weights = w.reshape(-1)[order]
        counts = torch.bincount(flat, minlength=self.cfg.n_experts).tolist()
        y = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
        start = 0
        for e, n in enumerate(counts):
            if n:
                r = rows[start:start + n]
                y = y.index_add(0, r, weights[start:start + n, None]
                                * self._expert(e, x2[r]).to(torch.float32))
            start += n
        return y
