"""Step timing and throughput, the port of ``serverless_learn_tpu/utils/
metrics.py``, with an analytic FLOP count in place of XLA's compiled one
(``utils/flops.py`` there reads XLA's cost analysis, which has no PyTorch
counterpart).

Model FLOPs of one transformer training step, 2 per multiply-add:

    6 * tokens * P_train  +  4 * tokens * P_frozen  +  c * L * B * T^2 * d

``tokens`` = B * T. A trained parameter costs 6 a token (the forward, the
input gradient and its weight gradient); a frozen one 4 (the forward and
the input gradient: its weight gradient is never computed, as for LoRA's
frozen base, and QLoRA's int8 one, whose int8 weights count as frozen
parameters). ``P_train + P_frozen`` is every parameter but the V * d
embedding table and BERT's learned positions (lookups, no products;
``lm_head`` is counted). The last term is the attention products (q k^T
and p v, 4 * B * T^2 * d a layer forward, times 3 for the forward, dq and
dk/dv, which are all computed whatever trains): c = 6 for a causal model,
whose mask halves them, and 12 for a bidirectional one (BERT; padding is
counted, as the tokens are). Remat's recomputed forward is not counted:
these are model FLOPs, the work the step needs, not what the card runs.

An image model's step (ResNet, the MLP): 3 x 2 x the multiply-adds of
every convolution and dense layer a sample, times the batch (the forward,
the input gradient and the weight gradient); norms, pooling and the loss
are not counted.

MFU divides the achieved rate by the card's dense bf16 peak, 989e12 FLOP/s
for an H100 SXM (NVIDIA's data sheet).
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

H100_BF16_PEAK = 989e12


def lm_train_flops(n_params: int, vocab: int, d_model: int, n_layers: int,
                   batch: int, seq: int,
                   n_trainable: Optional[int] = None,
                   causal: bool = True) -> float:
    """The analytic FLOPs of one transformer training step (module doc).
    ``n_params`` holds no lookup table but the token embedding, which is
    taken out here. ``n_trainable``: the trained parameters where only
    part of the model trains (the embedding table not among them); None:
    all of them."""
    tokens = batch * seq
    dense = n_params - vocab * d_model
    trained = dense if n_trainable is None else n_trainable
    attn = 6.0 if causal else 12.0
    return (6.0 * tokens * trained + 4.0 * tokens * (dense - trained)
            + attn * n_layers * batch * seq * seq * d_model)


def conv_train_flops(macs_per_sample: int, batch: int) -> float:
    """The analytic FLOPs of one image-model training step (module doc)."""
    return 6.0 * macs_per_sample * batch


@dataclass
class StepStats:
    step: int
    step_time_s: float
    samples_per_sec: float
    metrics: Dict[str, float]


@dataclass
class ThroughputMeter:
    batch_size: int
    n_chips: int = 1
    # FLOPs of one step (lm_train_flops); with peak_flops set,
    # steady_state reports MFU as well as achieved TFLOP/s.
    flops_per_step: Optional[float] = None
    peak_flops: Optional[float] = None  # per chip; None off the card
    tokens_per_sample: int = 0  # seq_len for LM batches: adds tokens/s
    history: List[StepStats] = field(default_factory=list)
    _t_last: Optional[float] = None

    def start(self):
        self._t_last = time.perf_counter()

    def record(self, step: int, metrics: Dict[str, float]) -> StepStats:
        now = time.perf_counter()
        dt = now - (self._t_last if self._t_last is not None else now)
        self._t_last = now
        sps = self.batch_size / dt if dt > 0 else float("inf")
        stats = StepStats(step=step, step_time_s=dt, samples_per_sec=sps,
                          metrics=metrics)
        self.history.append(stats)
        return stats

    def steady_state(self, skip: int = 2) -> Dict[str, float]:
        """Aggregate over history, skipping the first ``skip`` steps (kernel
        builds, allocator warm-up)."""
        usable = self.history[skip:] if len(self.history) > skip else self.history
        if not usable:
            return {"samples_per_sec": 0.0, "step_time_s": 0.0}
        times = [s.step_time_s for s in usable]
        sps = self.batch_size * len(usable) / sum(times)
        out = {
            "samples_per_sec": sps,
            "samples_per_sec_per_chip": sps / max(self.n_chips, 1),
            "step_time_s": sum(times) / len(times),
        }
        if self.tokens_per_sample:
            out["tokens_per_sec"] = sps * self.tokens_per_sample
        if self.flops_per_step:
            per_chip = (self.flops_per_step / out["step_time_s"]
                        / max(self.n_chips, 1))
            out["tflops_per_sec_per_chip"] = per_chip / 1e12
            if self.peak_flops:
                out["mfu"] = per_chip / self.peak_flops
        return out


def log_json(record: dict, stream=None):
    (stream or sys.stderr).write(json.dumps(record) + "\n")
    (stream or sys.stderr).flush()
