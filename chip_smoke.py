#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA card.

    python3 chip_smoke.py

Drives ``serverless_learn_tpu_torch`` (never JAX) on one card, in phases;
any failing phase exits non-zero:

1. the card: name and power limit (nvidia-smi);
2. builds every CUDA kernel of the port from ``csrc/`` (four sources) with
   nvcc, one process per source, all at once, prints each kernel's
   registers and spills (the saved report where a kernel was built
   before), and fails unless the report shows each tensor-core kernel
   (``NO_SPILL``: the flash forward, dq and dk/dv on wgmma at D = 32, 64,
   128; the int8 matmul's four, its prefill on wgmma among them) with no
   spills;
3. holds the int8 matmul kernel against its plain PyTorch version at every
   llama_8b projection shape, on both sides of its decode/prefill
   threshold and at every row count phase 9 serves (decode batches and
   prefills), at llama_1b's five projection shapes at every row count
   phase 10 serves, plus a ragged contraction that is not a multiple of
   the split, and at phase 11's 4,096 rows (QLoRA's training forward;
   lm_head there also with an f32 output of 2.1 GB, past 2^31 bytes); runs
   every case twice and fails unless the two repeat bit for bit (the
   split-K partials are added in a fixed order, no atomics); holds the
   gradient of ``QuantMatmul`` (K6 forward, the converted weight's product
   for dx) against the plain version's at 4,096 rows at every llama_8b
   shape, each element within its bf16 rounding noise in quadrature, and
   shows that a dx 5 % off fails that limit;
4. times the kernel at the decode shapes (8 rows) and at a 512-row
   prefill beside its bound, its plain version, the convert-then-matmul
   form and ``torch._weight_int8pack_mm``: eagerly, as the model calls it
   (host time included), and replayed from a CUDA graph (device time);
   and at 4,096 rows (one QLoRA forward) eagerly beside its bound, the
   plain version and the convert-then-matmul form; each forward beside
   the parent tree's time (``PARENT_K6_MS``);
5. runs llama_tiny int8 on the card (kernel) and on the CPU (plain) from the
   same weights and compares logits and greedy tokens;
6. holds the flash attention kernels (forward, dq, dk/dv) against their
   plain versions: the llama_1b and llama_8b training shapes, ragged,
   non-causal, H == K, "len" and "rows" masks, T != S, f32, the head dims
   32 and 128, the llama_8b head layout (D = 128) ragged and with both
   masks, and non-causal "len" at bert_base's training shape (``bert_len``:
   32 x 512, 12 heads, rows of 512, 487, 1 and 0), at the llama_1b GQA
   layout and at D = 128; runs the forward, dq and dk/dv twice at both
   training shapes and fails unless they repeat bit for bit;
7. times them at the llama_1b training shape, at the llama_8b attention
   shape (D = 128) and at ``bert_len`` (non-causal, "len"; its bound from
   the pairs and input rows this data keeps, SDPA with the boolean key mask) beside their
   bounds, their plain versions, ``scaled_dot_product_attention`` and the
   parent's kernels' times (``PARENT_FLASH_MS``), each kernel warmed up at
   its own shape and timed as the median of several runs, with the SM
   clock, temperature, power and throttle reasons sampled beside them;
   then forward + backward of the three kernels
   against the dense form (``ops/attention.py``) at T = 1,024, 2,048 and
   4,096 at both head layouts, the crossover ``impl="auto"`` would need
   (measured only: the threshold stays);
6b. holds the cross-entropy kernels (K4 forward, K5 backward) against
    their plain versions: the llama_8b loss shape read through the strided
    ``logits[:, :-1]``, a ragged and an odd (unaligned) vocab, f32, equal
    rows, +-80 outliers, labels at the vocab's edges, expanded and random
    loss cotangents; and shows the check fails a K5 that zeroes the
    non-label columns and a K4 that drops the last 256 columns;
7b. times them at the 8B loss shape beside their bounds, their plain
    versions and ``F.cross_entropy``: each the median of 25 launches timed
    one by one, with the SM clock, temperature, power and active throttle
    reasons sampled through nvidia-smi every 0.2 s while they run;
8. trains llama_tiny with flash attention for three adamw steps on the card
   (kernels) and on the CPU (plain) from the same weights and batches and
   compares losses and params (8c: the same with rank-4 LoRA and the fused
   loss); then trains full-width llama_1b (batch 2 x 4096 tokens, 5 adamw
   steps) through the port's ``run_training`` and checks the losses, that
   every attention layer of every step went through the three kernels and
   that the dense path never ran; then profiles one more step;
   8d. trains full-depth llama_8b with rank-16 LoRA, remat and the fused
   loss (the one-card cut of ``configs/llama8b_lora_elastic.json``, 8 x
   4096 tokens in 4 microbatches, 3 steps) through ``run_training``, and
   checks the losses, the exact launches of K1-K5, that neither the dense
   attention nor the unfused loss ran, that the frozen base is
   bit-identical and that the optimizer state holds the adapters alone;
   8e. compares one batch-2 microbatch's loss and adapter gradients with
   the fused loss and the unfused one, with their times and peak memory;
   8f. profiles one batch-2 fused step;
9. builds full-width llama_8b int8 from a seed, serves concurrent greedy
   and sampled requests through the port's ``GenerationServer`` and checks
   the replies, by the launch counter that every projection of every
   forward went through the kernel, and that phase 3 checked every row
   count it served; its server has a fresh metrics registry, the metrics
   endpoint and an event log: the static engine's request, finished and
   token counters must equal what the phase sent (the warm-up group's
   finished requests and tokens beside them), the scrape of /metrics must
   carry them, and every request span must carry a waterfall; then times
   prefill and each of 40 decode steps (median and quartiles), profiles
   one prefill forward (the int8 matmul's share of its device time) and
   decode steps;
9c. serves the same model through ``GenerationServer``'s defaults, the
    continuous engine over the paged KV pool (block 16, prefill chunk 32,
    budget 64, prefix cache on) with each decode bucket a CUDA graph of
    one step: phase 9's four greedy prompts and a sampled one, then a
    fifth prompt sharing prompt 0's first 100 tokens (6 blocks from the
    prefix trie, the 7th copied on write), a 1,500-token prompt prefilled
    in chunks between decode boundaries and a request with an eos_id.
    Checks the replies: at every step of every greedy reply the token the
    engine chose lies within the measured logit tolerance of the static
    path's largest logit, the static path fed the reply's own tokens, and
    the paged path's logits part from the static path's no further than
    the static path's own between batch shapes. Checks the EOS stop, no
    leaked page, the prefix hits, 225 eager launches of the int8 matmul a
    forward (its wrapper's count), 225 int8 matmul calls in a traced
    replayed step of every bucket that replayed, that phase 3 checked
    every row count served, and that a replayed chunk equals the eager
    one bit for bit; then times a decode round by the host clock at each
    harvest and profiles one replayed chunk. Its server, too, has a fresh
    registry, the metrics endpoint, an event log and the profiler armed:
    the request, finished, token, prefill-chunk, prefix-hit and preemption
    (0) counters must equal what the phase knows, every reply's span must
    carry a waterfall whose own host time is under 2 % of its decode time
    (``ledger_overhead_frac``), and a ``/debug/profile?seconds=2`` capture
    taken from the exporter's thread during a second 128-token round must
    hold ``quant_decode`` kernels; prints the harvest's telemetry host
    time per decode chunk;
10. the user path through checkpoints in the JAX package's format, at
    llama_1b's full width and 6 of its 16 layers, through the CLI's entry
    points in this process:
    ``train`` (B=2, T=4096, 3 adamw steps, K1-K3) saves 10.7 GB blobs at
    step 2 (uploaded while step 3 trains) and step 3, with the telemetry
    on (``--metrics-port 0 --health --events-log --flight-dir``, an
    in-loop eval every 2 steps, the emergency save armed with its shadow
    refreshed at every step at least 1 s apart): a thread scrapes
    /metrics, /goodput, /healthz and /alerts while it trains, and the
    phase checks that ``slt_train_steps_total`` rose by 3, the last-step
    gauge advanced, ``slt_train_mfu`` equals the done line's MFU, the
    ledger has compile, step, checkpoint and eval phases, goodput is in
    (0, 1], no alert fired, /healthz answered 200, the event log holds
    one ``train/run`` and three ``train/step`` spans, and K1 launched the
    eval's batches' forwards beside the steps' (K2/K3 the steps' alone);
    it prints each shadow refresh's stall; the newest restores
    into a fresh trainer in place and equals the live state bit for bit
    (with the save's, upload's, CRC's and restores' seconds and GB/s);
    ``eval`` from it launches K1 and equals the live model's eval; then
    ``generate --quant int8`` greedy and with ``--draft-layers 4 --spec-k
    4``, and the model as its own draft, each speculative reply held to
    greedy decode and timed; then ``serve`` (the continuous engine)
    answers two requests, held to greedy decode. K6 must launch 43 times
    a target forward (29 a 4-layer draft forward) and only at row counts
    phase 3 checked at llama_1b's five shapes;
11. QLoRA, the JAX package's single-card 8B fine-tuning rung: full-depth
    llama_8b with an int8 frozen base filled on the card in place, bf16
    rank-16 adapters on q/v, remat, batch 4 x 1024, adamw at 2e-4 (11a: 2
    warm-up and 5 timed steps through ``run_training``; the loss finite,
    449 K6 launches a step, dense attention and no flash or CE kernel, the
    base unchanged, a bf16 optimizer state of the adapters alone; step
    time, tokens/s, MFU with the base counted, peak memory); 11b: one
    batch's adapter gradients through K6 against the plain version on the
    card, within twice the distance of the plain version summed in two
    halves, every one non-zero and repeating bit for bit (a gross-fault
    check: through 32 random layers that distance is tens of percent);
    then layer 0 alone at full width, its input and adapter gradients
    held the same way, where the limit is tight enough that a dx 5 % off
    must fail it; 11c: two steps each of adafactor,
    lion and rmsprop from the same state; 11d: the state saved with the
    checkpointer and restored in place into a fresh trainer, bit for bit;
    11e: one step profiled (K6, the dx products, the rest of cuBLAS, dense
    attention, other kernels, idle share);
12a. the emergency save: a child process ``train``s llama_1b at full
    width and 2 layers with ``--checkpoint-dir`` and ``--checkpoint-every
    1000`` (the shadow refreshed at every step) and gets SIGTERM after its
    third step line; its flight dump must say sigterm and carry the
    card's ``torch.cuda`` memory statistics and
    ``slt_ckpt_emergency_saves_total`` = 1, and the emergency commit must
    be the newest shadow's step and restore in place into a fresh
    trainer that re-encodes to the committed bytes; prints each shadow
    refresh's stall;
13. the cluster on the card, through the CLI: the port's coordinator
    (lease 2 s) and shard server as child processes, a synthetic llama_1b
    dataset and a byte-level text corpus published, then ``worker``
    (llama_1b at full width and 2 layers, B = 2, T = 4,096, 60 steps,
    its checkpoints in the shard server); a second member joins after the
    3rd step (epoch + 1, stripe (0, 2)) and is SIGKILLed 4 steps after
    that formation (lease expiry, epoch + 1, stripe (0, 1)). Checks the
    two transitions (``mesh_formed`` lines, ``slt_remesh_total``), each
    restore verified and equal to its save's step, steps 1..60 with none
    lost or repeated, the shard server's fetches (only the stripe's
    shards on (0, 2), all again after), K1-K3's launches, no paging
    alert, /healthz 200 and the peak card memory across a transition; then a
    ``train --shard-server`` run on the text dataset must fail when the
    shard server is SIGKILLed under it. Prints the worker's tokens/s and
    step time beside phase 8b's, the data-wait share of goodput, each
    transition's save, re-form and restore, and the shard server's bytes.
    The worker runs with ``--numerics``: each formation's
    ``remesh_restore`` fingerprint must equal the ``remesh_save``
    fingerprint of the state its restore read. It also runs with a
    worker-local checkpoint cache (``--ckpt-cache-dir``; on the disk under
    ``--elastic-only``, in tmpfs in the full run, whose earlier phases
    have used the run's disk writes; the filesystem is printed) and a
    peer, a CPU-only ``serve_cache`` process each commit is pushed to
    (``--ckpt-peers``, fanout 1): both transitions must restore from the
    cache. The peer drill: the worker's cache is deleted and the shard
    server's copy of its last step corrupted; a restarted worker must
    restore that step from the peer (the primary's copy failing its CRC),
    its fingerprint equal to the save's, and train 2 more steps;
14. the numerics layer: (a) every kernel (K1-K6 and the stats kernels)
    and its plain version fed the same small bf16 and f32 inputs carrying
    NaN and +-inf (K1-K3: a NaN in q, k and v, an inf in q, a NaN in dO;
    K4/K5: a NaN and a +inf in a non-label logit and in the label's; K6: a
    NaN in x): every output position that depends on the poisoned value
    (found by perturbing it in the plain version) must be non-finite in
    both, and the kernel must be non-finite nowhere the plain version is
    finite; (b) llama_1b at full width (B=2, T=4096, adamw, clip 1.0), four
    runs of 12 steps from the same seed through ``run_training``, numerics
    off, on at cadence 4, on, off: the losses bit for bit equal, the
    step-time ratio (the on runs' median step over the off runs') at most
    1.03, peak memory at most 1.05 GB more, the
    ``numerics`` goodput phase under 2 % of the run, exactly 3 fetches,
    K1-K3's and the stats kernels' launches; (c) the drill: ``train
    --numerics --health`` through the CLI, no clipping, NaN injected into
    ``layer_5``'s gradients at step 6 of 8: one ``numerics_nonfinite``
    record at step 6 naming ``params:layer_5`` with ``grad:layer_5`` among
    the bad subtrees, ``slt_numerics_nonfinite_total`` on /metrics, a
    critical ``numerics.nonfinite`` on /alerts, /healthz at 503,
    ``/numerics`` serving JSON, a flight dump naming ``layer_5``, and the
    provenance sweep's forward through K1;
15. the MoE family: (a) K6 at Mixtral-8x7B's projection shapes (q/o,
    k/v, each expert's gate/up [4096, 14336] and down [14336, 4096],
    lm_head [4096, 32000]) at 1, 2, 8, 16, 128 and 512 rows against its
    plain version, and one full-width int8 MoE layer with expert 7 routed
    no row, in the gathered and the dense form, against the same layer
    through K6's plain version (3 launches a routed expert, none for the
    unrouted one); K6 timed over a Mixtral decode forward and a 512-row
    prefill forward; (b) full-depth ``moe_mixtral_8x7b`` int8 (46.6 GB)
    served through ``GenerationServer``'s defaults over the wire: greedy
    replies held to ``generate``'s, 897 K6 launches an eager decode
    forward and in each captured decode graph, a 512-row prefill's
    launches, ms a token, new tokens/s, peak memory and a profiled
    replayed step; (c) one static-engine round; (d) ``train --model
    moe_mixtral_8x7b`` at full width and 2 of 32 layers, B = 1, T =
    4,096, 3 adamw steps: losses and aux losses finite, K1-K3 2 launches
    a step each;
16. the model families (MLP, ResNet, BERT/MLM) and their data: (a)
    bert_tiny at T = 512 with suffix-padded rows (512, 487, 1, 0) and
    resnet18_cifar (16 filters, batch 8), 3 steps each on the card
    (K1-K3, cuDNN) and on the CPU (plain versions) from the same weights
    and batches in f32: losses, params and BatchNorm's running statistics
    compared; (b) the one-card cut of ``configs/bert_base_mlm.json``
    (batch 64, grad_accum 2, T = 512, adamw, 5 steps) through
    ``run_training`` over suffix-padded rows this phase publishes to the
    port's shard server, masked by ``mlm_transform``: exactly 12 x 2 x 5
    launches of each of K1-K3 and no dense attention; step time, tokens/s
    (padded and valid), MFU, peak memory, a profiled step; (c) the one-card
    cut of ``configs/cifar_resnet18_dp4.json`` (batch 256, sgd, warmup,
    ``data.augment``) over 5,120 CIFAR-10 binary records written and
    published with ``publish --format cifar10``: 30 steps with
    ``--checkpoint-dir``, ``eval`` from the checkpoint held to the live
    state's; samples/s, MFU, peak memory, a profiled step split into
    cuDNN's convolutions, BatchNorm and the rest; (d)
    ``configs/mnist_mlp.json`` over MNIST IDX files with learnable labels
    (``publish --format mnist``): 200 steps whose last 20 losses' mean is
    under half the first 20's, then ``eval`` from the checkpoint;
17. prints each phase's wall seconds, then one JSON line of kernels (with
    each kernel's launches on phase 10's path, K6's on phase 11's and on
    phase 15's serving, K1-K3's on phase 13's worker, phase 15d and phase
    16b, K1-K3's times at ``bert_len``, and the stats kernels' on phase
    14b), then the card's name and power limit, then the result line
    ``{"ok": true, "device": {...}}``.

Every profiler session (phases 8b, 8f, 9b, 9c, 11e) goes through the
port's shared profiler lock (``telemetry/profiler.py``).

Every time and memory figure is printed beside the card's name and power
limit. Exits non-zero without printing the result line where there is no
card, or where the port's package is missing.

    python3 chip_smoke.py --quant-matmul-only

runs only phase 4 and phase 9b (the int8 matmul's times at 8 and 512
rows, at QLoRA's 4,096 and at Mixtral's 512-row prefill shapes, and a
prefill forward and decode steps of llama_8b int8 with their profiles) on
the ``serverless_learn_tpu_torch`` next to this file, and prints no result
line: copied into a checkout of another commit, it times that commit's
kernel with the same yardsticks.

    python3 chip_smoke.py --qlora-only

runs only phase 11's training (11a) and its profiled step (11e) the same
way, for an A/B of the QLoRA step between commits.

    python3 chip_smoke.py --train-only

runs only phase 8b and phase 10's ``train`` command (5 steps, no
checkpoint) the same way: llama_1b's training step with f32 parameters
and adamw, for an A/B of the step between commits.

    python3 chip_smoke.py --serve-only

runs only phase 9c's decode round (llama_8b int8 through the continuous
engine's defaults, three timed rounds of 4 x 128 new tokens) the same
way, for an A/B of the continuous decode step between commits.

    python3 chip_smoke.py --ckpt-train-only

runs only phase 10's ``train`` with ``--checkpoint-dir`` at the defaults
(250 steps, no periodic save among them) the same way, for an A/B of the
checkpoint path's steady tokens/s, the emergency shadow's refreshes
included, between commits.

    python3 chip_smoke.py --flash-only

builds the flash kernels and runs only phases 6, 7 (both shapes and the
dense crossover) and 8b (llama_1b's step) on the package next to this
file, with no result line: copied into a checkout of another commit, it
gives that commit's flash kernels the same checks and yardsticks, for an
A/B of K1-K3 and of the step between commits.

    python3 chip_smoke.py --elastic-only

builds the flash kernels and runs only phase 13 (the cluster), its
worker's checkpoint cache on the disk, with no result line.

    python3 chip_smoke.py --moe-only

builds the int8 matmul and flash kernels and runs only phase 15 (the MoE
family), with no result line.

    python3 chip_smoke.py --numerics-only

builds every kernel and runs only phase 14 (the numerics layer), with no
result line.

    python3 chip_smoke.py --families-only

builds the flash kernels and runs only phases 6, 7 and 16 (the model
families), with no result line.

    python3 chip_smoke.py --nonfinite-only

builds the kernels and runs only phase 14a, printing its faults instead of
failing: copied into a checkout of another commit, it shows how that
commit's kernels carry NaN and +-inf.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12   # dense bf16 tensor-core peak, same source

# llama_8b projections: (I, O) -> (sites, launches per forward)
LLAMA8B_SHAPES = {
    (4096, 4096): ("q_proj, o_proj", 64),
    (4096, 1024): ("k_proj, v_proj", 64),
    (4096, 14336): ("gate_proj, up_proj", 64),
    (14336, 4096): ("down_proj", 32),
    (4096, 128256): ("lm_head", 1),
}
# 16 new tokens a greedy request (32 before the model families' phase 16:
# the run's time limit).
PROMPT_LEN, NEW_TOKENS = 128, 16
SERVE_BATCH = 4  # the greedy requests of phase 9 form one group of 4
# Rows the kernel is checked at in phase 3: both sides of each of its tile
# boundaries (decode with one n8 tile up to 8 rows, two up to 16, prefill
# above), a masked 3 and a ragged 8 * 37, and every row count phase 9 can
# serve: decode at each batch bucket up to SERVE_BATCH (the sampled request
# runs alone) and those buckets' prefills.
CHECK_ROWS = (1, 2, 3, 4, 8, 9, 16, 17, 8 * 37) + tuple(
    b * PROMPT_LEN for b in (1, 2, 4) if b <= SERVE_BATCH) + (
    # phase 9c's continuous engine: decode at its live-batch buckets (1, 2,
    # 4, 8) and prefill chunks of nb * T rows, T in {8, 16, 32}: 8 to 256;
    # and the prefills of its solo static references (SHARED + 5 and
    # LONG_PROMPT rows)
    32, 64, 105, 1500)
# Phase 11's QLoRA step: every projection at batch 4 x 1024 rows.
QLORA_BATCH, QLORA_SEQ = 4, 1024
QLORA_ROWS = QLORA_BATCH * QLORA_SEQ
CHECK_ROWS += (QLORA_ROWS,)
DECODE_ROWS = 8
PREFILL_ROWS = SERVE_BATCH * PROMPT_LEN  # 512: phase 9's largest prefill
DECODE_STEPS = 40  # phase 9b's timed decode steps
# A contraction that is not a multiple of any split (k_split is a multiple
# of 64 rows): the last split is ragged.
RAGGED_I = (4136, 1024)


def profiled():
    """A ``torch.profiler`` session (CPU and CUDA) through the port's
    shared profiler lock (``telemetry/profiler.py``): two sessions never
    nest, and an on-demand capture during one answers busy. A checkout
    from before the port had telemetry (the parent of an A/B mode) has no
    lock: there the session is a plain one."""
    try:
        from serverless_learn_tpu_torch.telemetry import profiler
    except ModuleNotFoundError:
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    return profiler.capture_session()


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# The parent tree's K6 forwards (ms, eager, its mma.sync prefill tiling;
# NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), by phase 4's line,
# printed beside this run's.
PARENT_K6_MS = {
    "time_per_prefill_forward": 40.02,
    "time_per_qlora_forward": 258.60,
    "time_per_prefill_forward_mixtral_prefill": 88.78,
}


def k6_tilings(kern) -> dict:
    """K6's launches so far by tiling (``kern``: the wrapper
    ``quant_matmul``); {} from a package that does not count them (the
    parent of an A/B mode)."""
    return dict(getattr(kern, "tilings", {}))


def tilings_since(kern, before: dict) -> dict:
    """K6's launches by tiling since ``before`` (``k6_tilings``), the
    tilings that launched."""
    return {k: n - before.get(k, 0) for k, n in k6_tilings(kern).items()
            if n - before.get(k, 0)}


def prefill_on_wgmma(tilings: dict) -> bool:
    """Whether K6's launches above 16 rows all took the wgmma prefill
    tiling (none the shape-only mma.sync one), and some did."""
    return tilings.get("prefill", 0) > 0 and not tilings.get("prefill_mma")


def bound(R: int, I: int, O: int):
    """(ms, "bytes" | "operations"): the least time for x bf16 [R, I] @
    int8 [I, O] * f32 scale -> bf16 [R, O], every byte moved once at the
    HBM rate or the operations at the bf16 tensor-core rate, the larger."""
    moved_s = (R * I * 2 + I * O + O * 4 + R * O * 2) / HBM_BYTES_PER_S
    ops_s = 2 * R * I * O / BF16_FLOP_PER_S
    return max(moved_s, ops_s) * 1e3, ("bytes" if moved_s >= ops_s
                                       else "operations")


def time_ms(torch, fn, iters: int, warmup: int = 3, graph: bool = False,
            reps: int = 1) -> float:
    """ms per call of ``fn(i)``, by CUDA events around ``iters`` calls: the
    median of ``reps`` such runs. Eagerly, where a call's device time is
    shorter than the host's time to make the call, the host's time is what
    is measured. Python's garbage collector is held off during a run, as
    ``timeit`` does: a collection of a large process (milliseconds) inside
    a run of 20 short calls would otherwise count as tens of microseconds
    a call. ``graph``: the calls are captured once into a CUDA graph and
    the replay is timed, so the host's time leaves no gap between launches
    and device time alone is measured."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    run = lambda: [fn(i) for i in range(iters)]  # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        run = g.replay
        run()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        gc.collect()
        gc.disable()
        try:
            start.record()
            run()
            end.record()
            end.synchronize()
        finally:
            gc.enable()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def check_kernel(torch, qm, card):
    """Phase 3: kernel vs plain version, bf16 in and out, at every shape
    and every row count of CHECK_ROWS, each case run twice; the worst error
    of each row tile."""
    g = torch.Generator(device="cuda").manual_seed(0)
    worst = {}  # (row tile, dtype) -> (max abs err, max rel err, cases)
    cases = [(I, O, torch.bfloat16, CHECK_ROWS) for (I, O) in LLAMA8B_SHAPES]
    # llama_1b's shapes, at every row count phase 10 serves.
    cases += [(I, O, torch.bfloat16, CHECK_ROWS_1B)
              for (I, O) in LLAMA1B_SHAPES]
    # A ragged last split; ragged I and O (no 16-byte weight loads); and the
    # f32 instantiations that llama_tiny (phase 5) runs.
    cases.append((*RAGGED_I, torch.bfloat16, (1, 8, 9, 16, 17, PREFILL_ROWS)))
    cases.append((100, 77, torch.float32, (1, 2, 3, 8, 9, 17, 37)))
    # lm_head at QLoRA's rows with an f32 output: 2.1 GB, past 2^31 bytes,
    # so every row-times-column offset must be 64-bit.
    cases.append((4096, 128256, torch.float32, (QLORA_ROWS,)))
    cases.append((100, 77, torch.bfloat16, (3, 16, 37)))
    cases.append((256, 384, torch.float32, (1, 2, 4, 32)))
    for I, O, dt, rows in cases:
        wq = torch.randint(-127, 128, (I, O), generator=g, device="cuda",
                           dtype=torch.int8)
        scale = (torch.rand(O, generator=g, device="cuda") + 0.5) * 4e-4
        for R in rows:
            check_case(torch, qm, g, R, wq, scale, dt, worst)
        del wq
    torch.cuda.empty_cache()
    per_tile = [dict(row_tile=t, dtype=str(dt).split(".")[-1], cases=n,
                     max_abs_err=a, max_rel_err=r)
                for (t, dt), (a, r, n) in sorted(
                    worst.items(), key=lambda kv: (str(kv[0][1]), kv[0][0]))]
    for row in per_tile:
        emit("check_row_tile", card=card, **row)
    emit("check", card=card, cases=sum(r["cases"] for r in per_tile),
         rows=list(CHECK_ROWS), rows_llama_1b=list(CHECK_ROWS_1B),
         repeat_bit_identical=True,
         max_abs_err=max(r["max_abs_err"] for r in per_tile),
         max_rel_err=max(r["max_rel_err"] for r in per_tile),
         tolerance="|err| <= 2^-7*|ref| + 1e-3*max|ref| (bf16 rounding of "
                   "f32 sums added in another order)")
    return max(r["max_abs_err"] for r in per_tile)


def check_case(torch, qm, g, R, wq, scale, dt, worst):
    """One kernel-vs-plain comparison at R rows; folds its error into
    ``worst`` under the kernel's row tile and the dtype."""
    I, O = wq.shape
    x = torch.randn(R, I, generator=g, device="cuda").to(dt)
    got = qm.quant_matmul(x, wq, scale)
    again = qm.quant_matmul(x, wq, scale)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"the kernel does not repeat bit for bit at R={R} I={I} O={O} "
             f"{dt} ({qm.plan(R, I, O)})")
    want = qm.quant_matmul_reference(x, wq, scale)
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"kernel output {got.shape} {got.dtype} != plain "
             f"{want.shape} {want.dtype}")
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    # The two differ only in the order of the f32 sums: bf16 outputs may
    # then round to neighbouring values, one ulp <= 2^-7 relative; the f32
    # order itself moves a sum by ~1e-3 of its largest output.
    limit = 2 ** -7 * ref + 1e-3 * ref.max()
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"non-finite kernel output at R={R} I={I} O={O}")
    if bool((err > limit).any()):
        fail(f"kernel disagrees with plain at R={R} I={I} O={O} {dt} "
             f"({qm.plan(R, I, O)}): max abs {err.max().item():.4g}, max "
             f"|ref| {ref.max().item():.4g}")
    key = (qm.plan(R, I, O).tiling, dt)
    a, r, n = worst.get(key, (0.0, 0.0, 0))
    worst[key] = (max(a, err.max().item()),
                  max(r, err.max().item() / ref.max().item()), n + 1)


def dx_limit(torch, dy, wq, scale, dx_ref):
    """Per element, how far ``QuantMatmul``'s dx may lie from the plain
    version's: 6 * 2^-8 * sqrt(sum_o t_o^2) + 2^-7 |dx_ref|, t_o = dy scale
    wq the terms. The Function rounds each term's scale and g = dy * scale
    to bf16, two independent errors within +-2^-8 of the term, so their sum
    is near-normal with sigma = 0.82 * 2^-8 * sqrt(sum t^2): 6 * 2^-8 is
    7.3 sigma, passed by a 59 M-element output but once in ~10^5 runs.
    Each side then rounds its output to bf16 (2^-8 of |dx| each)."""
    t2 = (dy.float() * scale).square() @ wq.to(torch.bfloat16).float(
        ).square().t()
    return 6 * 2 ** -8 * t2.sqrt() + 2 ** -7 * dx_ref.abs()


def check_dx(torch, qm, card):
    """Phase 3, the gradient: ``QuantMatmul`` (K6 forward, the converted
    weight's product for dx) against the plain version's autograd gradient
    at QLoRA's rows, at each llama_8b projection shape, within
    :func:`dx_limit`; fails too unless a dx 5 % off would fail it. Returns
    the worst error over its limit."""
    g = torch.Generator(device="cuda").manual_seed(2)
    worst, off_least = 0.0, math.inf
    for I, O in LLAMA8B_SHAPES:
        wq = torch.randint(-127, 128, (I, O), generator=g, device="cuda",
                           dtype=torch.int8)
        scale = (torch.rand(O, generator=g, device="cuda") + 0.5) * 4e-4
        x = torch.randn(QLORA_BATCH, QLORA_SEQ, I, generator=g,
                        device="cuda").to(torch.bfloat16)
        dy = torch.randn(QLORA_BATCH, QLORA_SEQ, O, generator=g,
                         device="cuda").to(torch.bfloat16)
        xk = x.clone().requires_grad_()
        before = qm.quant_matmul.launches
        qm.QuantMatmul.apply(xk, wq, scale).backward(dy)
        if qm.quant_matmul.launches != before + 1:
            fail("QuantMatmul's forward did not launch K6 once")
        xr = x.clone().requires_grad_()
        qm.quant_matmul_reference(xr, wq, scale).backward(dy)
        ref = xr.grad.float()
        limit = dx_limit(torch, dy, wq, scale, ref)
        got = xk.grad.float()
        ratio = ((got - ref).abs() / limit.clamp_min(1e-30)).max().item()
        # The limit's power: a dx 5 % too large must fail it.
        off = ((1.05 * got - ref).abs() / limit.clamp_min(1e-30)
               ).max().item()
        if not math.isfinite(ratio) or ratio > 1:
            fail(f"QuantMatmul's dx disagrees with the plain gradient at "
                 f"I={I} O={O}: worst error / limit {ratio:.3g}")
        if not off > 1:
            fail(f"the dx limit at I={I} O={O} passes a dx 5 % off "
                 f"(worst error / limit {off:.3g})")
        worst, off_least = max(worst, ratio), min(off_least, off)
        del wq, x, dy, xk, xr, ref, limit, got
    torch.cuda.empty_cache()
    emit("check_dx", card=card, rows=QLORA_ROWS,
         shapes=[list(k) for k in LLAMA8B_SHAPES],
         worst_err_over_limit=worst,
         dx_5pct_off_least_worst_over_limit=off_least,
         tolerance="|dx - plain dx| <= 6 * 2^-8 * sqrt((dy scale)^2 @ "
                   "(wq^2)^T) + 2^-7 |plain dx|: the scale and g = dy "
                   "scale rounded to bf16 (in quadrature over the "
                   "contraction, 7.3 sigma), both outputs rounded to bf16")
    return worst


def time_kernel(torch, qm, card, R=DECODE_ROWS, shapes=None, label=None):
    """Phase 4: the llama_8b projections at R rows (a decode forward at 8,
    a prefill at 512, QLoRA's training forward at 4,096); weights cycled
    over copies worth >= 256 MB so each launch reads them from device
    memory, not L2. The kernel runs eagerly, as the model calls it (``ms``:
    where a launch's device time is shorter than the wrapper's host time,
    the host's), and replayed from a CUDA graph (``graph_ms``: device time
    alone); the plain version and the two library forms, slower by far,
    run eagerly. At QLoRA's rows a launch takes milliseconds, so the host's
    time does not show: no graph, fewer runs, and ``torch.
    _weight_int8pack_mm`` timed once a shape (one call after one at 8 rows:
    tens of seconds a forward). ``shapes``: {(I, O): (sites, launches a
    forward[, rows])} in place of llama_8b's (phase 15a: Mixtral's, each
    expert of a prefill at its share of the rows); ``label`` names the
    forward's line."""
    g = torch.Generator(device="cuda").manual_seed(1)
    qlora = R == QLORA_ROWS
    rows = []
    for (I, O), spec in (shapes or LLAMA8B_SHAPES).items():
        sites, per_fwd = spec[:2]
        Rs = spec[2] if len(spec) > 2 else R
        n = max(2, math.ceil(256e6 / (I * O)))
        x = torch.randn(Rs, I, generator=g, device="cuda").to(torch.bfloat16)
        wqs = [torch.randint(-127, 128, (I, O), generator=g, device="cuda",
                             dtype=torch.int8) for _ in range(n)]
        scale = torch.rand(O, generator=g, device="cuda") * 4e-4
        iters = 2 * n if qlora else max(20, 2 * n)
        reps = 3 if qlora else 5
        ms = time_ms(torch, lambda i: qm.quant_matmul(x, wqs[i % n], scale),
                     iters, reps=reps)
        graph_ms = None if qlora else time_ms(torch, lambda i: qm.quant_matmul(
            x, wqs[i % n], scale), iters, graph=True, reps=5)
        plain = time_ms(torch, lambda i: qm.quant_matmul_reference(
            x, wqs[i % n], scale), 2 if qlora else 10, warmup=1)
        # At QLoRA's rows the median of 3 runs, as K6's: one run of it
        # once read 15x its usual time at gate/up.
        conv = time_ms(torch, lambda i: (x @ wqs[i % n].to(torch.bfloat16))
                       * scale, iters if qlora else 10, warmup=1,
                       reps=reps if qlora else 1)
        lib, lib_error = None, None
        try:
            wts = [w.t().contiguous() for w in wqs[:1 if qlora else n]]
            s16 = scale.to(torch.bfloat16)
            if qlora:
                torch._weight_int8pack_mm(x[:8], wts[0], s16)
                lib = time_ms(torch, lambda i: torch._weight_int8pack_mm(
                    x, wts[0], s16), 1, warmup=0)
            else:
                lib = time_ms(torch, lambda i: torch._weight_int8pack_mm(
                    x, wts[i % n], s16), iters)
            del wts
        except (RuntimeError, NotImplementedError, AttributeError) as e:
            lib_error = f"{type(e).__name__}: {str(e)[:120]}"
        b, by = bound(Rs, I, O)
        rows.append(dict(I=I, O=O, R=Rs, sites=sites, per_forward=per_fwd,
                         ms=ms, graph_ms=graph_ms,
                         plain_ms=plain, library_ms=lib,
                         convert_matmul_ms=conv, bound_ms=b, bound_by=by,
                         fraction_of_bound=b / ms, library_error=lib_error))
        emit("time", card=card, **rows[-1])
        del wqs
        torch.cuda.empty_cache()
    total = lambda key: (  # noqa: E731
        None if any(r[key] is None for r in rows)
        else sum(r[key] * r["per_forward"] for r in rows))
    fwd = dict(ms=total("ms"), graph_ms=total("graph_ms"),
               plain_ms=total("plain_ms"),
               bound_ms=total("bound_ms"), library_ms=total("library_ms"),
               convert_matmul_ms=total("convert_matmul_ms"),
               bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                         else "operations"))
    name = ("time_per_qlora_forward" if qlora else "time_per_decode_forward"
            if R == DECODE_ROWS else "time_per_prefill_forward")
    name = f"{name}_{label}" if label else name
    emit(name, card=card, parent_ms=PARENT_K6_MS.get(name),
         rows=R, launches=sum(r["per_forward"] for r in rows), **fwd,
         fraction_of_bound=fwd["bound_ms"] / fwd["ms"],
         library_call="torch._weight_int8pack_mm (bf16 scales, one call"
                      + (", timed once a shape" if qlora else "") + ")",
         convert_matmul="x @ wq.to(bf16) then * scale: three calls, the "
                        "reference package's default form")
    return fwd


def tiny_agreement(torch, card):
    """Phase 5: llama_tiny int8 (f32 compute) on the card, through the
    kernel, against the same weights on the CPU through the plain version."""
    from serverless_learn_tpu_torch.inference.generate import generate
    from serverless_learn_tpu_torch.models.registry import build_model
    from serverless_learn_tpu_torch.models.transformer import Transformer
    from serverless_learn_tpu_torch.ops.quant_matmul import quant_matmul

    cpu = build_model("llama_tiny", device="cpu", quant="int8", seed=0,
                      dtype="float32")
    gpu = Transformer(cpu.cfg, device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    prompt = torch.randint(0, cpu.cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(2))
    before = quant_matmul.launches
    with torch.inference_mode():
        lc = cpu(prompt)
        lg = gpu(prompt.cuda()).cpu()
    if quant_matmul.launches - before != 2 * 7 + 1:
        fail("the tiny model's forward did not launch the kernel 15 times")
    diff = (lc - lg).abs().max().item()
    scale = lc.abs().max().item()
    tc = generate(cpu, prompt, 16)[:, 16:]
    tg = generate(gpu, prompt, 16)[:, 16:].cpu()
    agree = (tc == tg).float().mean().item()
    emit("tiny_agreement", card=card, max_abs_logit_diff=diff,
         max_abs_logit=scale, token_agreement=agree,
         tolerance="logits within 1e-2 of max |logit| (projection inputs "
                   "rounded to bf16 on both sides; f32 elsewhere); greedy "
                   "tokens identical")
    if not diff <= 1e-2 * scale or agree != 1.0:
        fail(f"tiny model: card vs cpu logits differ by {diff:.4g} "
             f"(max {scale:.4g}), token agreement {agree:.3f}")


def serve_prompts(torch, vocab: int):
    """Phase 9's greedy prompts: SERVE_BATCH of them, from seed 3."""
    g = torch.Generator().manual_seed(3)
    lens = (128, 120, 101, 128)[:SERVE_BATCH]
    return [torch.randint(0, vocab, (n,), generator=g).tolist() for n in lens]


def read_events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def host_memory_gb():
    """(MemAvailable, this process's VmRSS) in GB, from /proc."""
    def field(path, key):
        with open(path) as f:
            for line in f:
                if line.startswith(key + ":"):
                    return int(line.split()[1]) * 1024 / 1e9
        return None
    return field("/proc/meminfo", "MemAvailable"), field(
        "/proc/self/status", "VmRSS")


def step_watch_ledger(torch, slow_s=1.5):
    """A goodput ledger that also records, for each ``step`` phase, the
    caching allocator's segment counts and retries, the cyclic GC's pause
    time and the host's free memory on entry and exit; and, once a step
    has been open ``slow_s``, every thread's innermost frames. Phase 10
    keeps it as the process ledger while its ``train`` runs, so a step
    that a checkpoint boundary slows says where it waited."""
    import contextlib
    import traceback

    from serverless_learn_tpu_torch.telemetry import goodput

    gc_s = [0.0, None]

    def on_gc(phase, info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        elif gc_s[1] is not None:
            gc_s[0] += time.perf_counter() - gc_s[1]
            gc_s[1] = None

    def alloc():
        s = torch.cuda.memory_stats()
        return {k: s.get(k, 0) for k in (
            "num_alloc_retries", "num_device_alloc", "num_device_free")}

    class Watched(goodput.PhaseLedger):
        def __init__(self):
            super().__init__()
            self.steps, self.open = [], None
            self.stop = threading.Event()
            gc.callbacks.append(on_gc)
            threading.Thread(target=self._watch, daemon=True).start()

        def _watch(self):
            while not self.stop.wait(0.05):
                rec = self.open
                if (rec is not None and "stacks" not in rec
                        and time.perf_counter() - rec["t0"] > slow_s):
                    names = {t.ident: t.name for t in threading.enumerate()}
                    rec["stacks"] = {
                        names.get(tid, str(tid)): [
                            f"{fs.filename.rsplit('/', 2)[-1]}:{fs.lineno} "
                            f"{fs.name}" for fs in
                            traceback.extract_stack(frame)[-10:]]
                        for tid, frame in sys._current_frames().items()}

        def close(self):
            self.stop.set()
            if on_gc in gc.callbacks:
                gc.callbacks.remove(on_gc)

        @contextlib.contextmanager
        def phase(self, name):
            if name != "step":
                with super().phase(name):
                    yield
                return
            rec = {"t0": time.perf_counter(), "gc0": gc_s[0],
                   "alloc0": alloc(), "mem0": host_memory_gb()}
            self.open = rec
            try:
                with super().phase(name):
                    yield
            finally:
                self.open = None
                a1 = alloc()
                rec.update(s=time.perf_counter() - rec.pop("t0"),
                           gc_s=gc_s[0] - rec.pop("gc0"),
                           alloc=dict((k, a1[k] - v) for k, v in
                                      rec.pop("alloc0").items()),
                           mem1=host_memory_gb(),
                           threads=threading.active_count())
                self.steps.append(rec)

    return Watched()


def engine_telemetry(engine, registry, events_path, scraped, **want):
    """Phases 9 and 9c's telemetry checks: the engine's counters in its
    own fresh registry equal ``want`` (the counts the phase knows), the
    ``/metrics`` scrape carries them, and every request span in the event
    log carries a waterfall. Returns the record, with the waterfalls'
    ``ledger_overhead_frac`` (their own host time over their decode time,
    as the reference's ``slt waterfall`` sums it)."""
    names = {"requests": "slt_requests_total",
             "finished": "slt_requests_finished_total",
             "tokens": "slt_decode_tokens_total",
             "prefill_chunks": "slt_prefill_chunks_total",
             "prefix_hits": "slt_kv_prefix_hits_total",
             "preemptions": "slt_kv_preemptions_total"}
    snap = registry.snapshot()
    got, faults = {}, []
    for key, n in want.items():
        series = [s for s in snap.get(names[key], {}).get("series", [])
                  if s["labels"] == {"engine": engine}]
        got[key] = series[0]["value"] if series else None
        if got[key] != n:
            faults.append(f"{names[key]} = {got[key]}, expected {n}")
        line = f'{names[key]}{{engine="{engine}"}} {int(n)}'
        if line not in scraped:
            faults.append(f"/metrics lacks {line!r}")
    spans = [r for r in read_events(events_path)
             if r.get("event") == "span" and r.get("span") == "request"]
    bare = [r["span_id"] for r in spans if "waterfall" not in r]
    if len(spans) != want["requests"] or bare:
        faults.append(f"{len(spans)} request spans ({len(bare)} without a "
                      f"waterfall) for {want['requests']} requests")
    overhead = sum(r["waterfall"].get("overhead_s", 0.0) for r in spans
                   if "waterfall" in r)
    decode = sum(ph.get("s", 0.0) for r in spans if "waterfall" in r
                 for ph in r["waterfall"]["phases"]
                 if ph["phase"] == "decode")
    hist = {name: snap[name]["series"][0]["count"] for name in
            ("slt_request_ttft_seconds", "slt_request_latency_seconds",
             "slt_request_queue_wait_seconds") if name in snap}
    if faults:
        fail(f"{engine} engine telemetry: " + "; ".join(faults))
    return {"counters": got, "spans": len(spans),
            "histogram_counts": hist,
            "waterfall_overhead_s": overhead, "waterfall_decode_s": decode,
            "ledger_overhead_frac": overhead / decode if decode else None}


def serve_full_width(torch, card):
    """Phase 9: llama_8b int8 served through the port's GenerationServer,
    with a fresh registry, the metrics endpoint and an event log."""
    import os
    import shutil
    import tempfile

    from serverless_learn_tpu_torch.config import KVCacheConfig
    from serverless_learn_tpu_torch.inference.server import (GenerationServer,
                                                            request)
    from serverless_learn_tpu_torch.models.registry import build_model
    from serverless_learn_tpu_torch.ops.quant_matmul import quant_matmul
    from serverless_learn_tpu_torch.telemetry import (MetricsRegistry,
                                                      fetch_text)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model("llama_8b", device="cuda", quant="int8", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    forwards, rows_served = [0], set()

    def count_forward(mod, args):
        forwards[0] += 1
        rows_served.add(args[0].numel())  # every projection's R: B * T

    model.register_forward_pre_hook(count_forward)
    tel = tempfile.mkdtemp(prefix="slt-phase9-")
    registry = MetricsRegistry()
    server = GenerationServer(model, port=0, max_batch=8,
                              batch_wait_ms=50.0, engine="static",
                              kv=KVCacheConfig(paged=False),
                              registry=registry, metrics_port=0,
                              event_log_path=os.path.join(tel,
                                                          "events.jsonl"))
    server.start()
    try:
        server.engine.warm(PROMPT_LEN, NEW_TOKENS, batch_sizes=(SERVE_BATCH,))
        prompts = serve_prompts(torch, cfg.vocab_size)
        greedy = [{"prompt": p, "max_new_tokens": NEW_TOKENS} for p in prompts]
        sampled = {"prompt": prompts[0], "max_new_tokens": NEW_TOKENS,
                   "temperature": 0.8, "top_k": 40, "seed": 1}

        def send_all(reqs):
            replies = [None] * len(reqs)

            def client(i):
                replies[i] = request(server.addr, reqs[i], timeout=600)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(len(reqs))]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=900)
            if any(th.is_alive() for th in threads):
                fail("a request did not finish")
            return replies, time.perf_counter() - t

        quant_matmul.launches = 0
        tilings0 = k6_tilings(quant_matmul)
        forwards[0] = 0
        rows_served.clear()
        first, wall1 = send_all(greedy + [sampled])
        again, wall2 = send_all(greedy)
        launches, n_fwd = quant_matmul.launches, forwards[0]
        tilings = tilings_since(quant_matmul, tilings0)
        scraped = fetch_text(server.metrics_addr, "/metrics")
    finally:
        server.stop()
    # The engine's series hold what the phase sent: every request, and
    # the warm-up group's finished requests and tokens beside them.
    served = len(first) + len(again)
    telemetry = engine_telemetry(
        "static", registry, os.path.join(tel, "events.jsonl"), scraped,
        requests=served, finished=served + SERVE_BATCH,
        tokens=(served + SERVE_BATCH) * NEW_TOKENS)
    shutil.rmtree(tel, ignore_errors=True)
    for req, rep in zip(greedy + [sampled], first):
        if "error" in rep:
            fail(f"server error: {rep['error']}")
        new = rep["new_tokens"]
        if (len(new) != NEW_TOKENS or rep["tokens"] != req["prompt"] + new
                or not all(0 <= t < cfg.vocab_size for t in new)
                or not isinstance(rep["latency_ms"], float)):
            fail(f"malformed reply: {str(rep)[:300]}")
    if ([r["new_tokens"] for r in again]
            != [r["new_tokens"] for r in first[:SERVE_BATCH]]):
        fail("the same greedy requests gave other tokens the second time")
    per_fwd = 7 * cfg.n_layers + 1
    if n_fwd == 0 or launches != per_fwd * n_fwd:
        fail(f"{launches} kernel launches for {n_fwd} forwards; expected "
             f"{per_fwd} per forward")
    if not rows_served <= set(CHECK_ROWS):
        fail(f"the kernel served row counts {sorted(rows_served)}, phase 3 "
             f"checked only {list(CHECK_ROWS)}")
    if not prefill_on_wgmma(tilings):
        fail(f"phase 9's K6 launches by tiling {tilings}: its prefills did "
             "not all take the wgmma prefill tiling")
    lat = ([r["latency_ms"] for r in first[:SERVE_BATCH]]
           + [r["latency_ms"] for r in again])
    emit("serve_llama_8b_int8", card=card, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab_size, build_s=build_s,
         requests=len(first) + len(again),
         batch_sizes=[r["batch_size"] for r in first + again],
         forwards=n_fwd, kernel_launches=launches,
         kernel_launches_by_tiling=tilings,
         launches_per_forward=launches / n_fwd,
         rows_served=sorted(rows_served),
         greedy_latency_ms_median=statistics.median(lat),
         greedy_latency_ms_max=max(lat),
         round1_wall_s=wall1, round2_wall_s=wall2,
         round2_new_tokens_per_s=len(again) * NEW_TOKENS / wall2,
         max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
         telemetry=telemetry)
    static = where_time_goes(torch, model, prompts, card)
    return launches, model, [r["new_tokens"] for r in first[:SERVE_BATCH]], \
        static


# record_function ranges that phase 11e opens; the profiler puts each on
# the device's timeline too, as an annotation over the kernels it holds.
ANNOTATIONS = ("dense_attention", "quant_matmul_dx")


def device_time(torch, prof, match):
    """A profile's device kernels: (span us, busy us, us of the kernels whose
    name holds ``match``, us by kernel name, the kernel events). The device
    annotations of record_function ranges are not kernels and are left
    out."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in ANNOTATIONS]
    if not kern:
        fail("the profiler recorded no device events")
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern))
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    ours = sum(v for k, v in by_name.items() if match in k)
    return span, sum(by_name.values()), ours, by_name, kern


def where_time_goes(torch, model, prompts, card):
    """Phase 9b: the batch-4 group of phase 9 run on the model directly:
    prefill time by CUDA events and the wall time of each of DECODE_STEPS
    decode steps (host clock, each ending in a synchronize, as the
    engine's steps end reading their tokens: median and quartiles), both
    before any profiler runs in the phase, since a profiler session can
    leave the launches after it slower on the host; then one prefill
    forward under torch.profiler (the int8 matmul's share of its device
    time) and 5 decode steps under torch.profiler for the device's busy
    share, kernel time by name, and the eager ops and device kernels a
    step dispatches."""
    from serverless_learn_tpu_torch.inference.generate import init_cache

    B = len(prompts)
    toks = torch.zeros(B, PROMPT_LEN, dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    toks = toks.cuda()
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32).cuda()
    cache = init_cache(model, B)
    step = torch.ones(B, 1, dtype=torch.int32, device="cuda")
    n = 5
    with torch.inference_mode():
        prefill_ms = time_ms(torch, lambda i: model(
            toks, cache=cache, prefill=True, seq_lengths=lens), 3, warmup=1)
        model(step, cache=cache, decode=True)
        walls = []
        for _ in range(DECODE_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model(step, cache=cache, decode=True)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        with profiled() as pprof:
            model(toks, cache=cache, prefill=True, seq_lengths=lens)
            torch.cuda.synchronize()
        with profiled() as prof:
            for _ in range(n):
                model(step, cache=cache, decode=True)
            torch.cuda.synchronize()
    # K6's kernels: quant_decode, quant_prefill, quant_reduce (and an older
    # build's quant_matmul_kernel).
    span, busy, k6, by_name, _ = device_time(torch, pprof, "quant_")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("where_time_goes_llama_8b_int8_prefill", card=card, batch=B,
         prompt_bucket=PROMPT_LEN, rows=B * PROMPT_LEN,
         prefill_span_ms=span / 1e3, device_busy_ms=busy / 1e3,
         device_idle_share=1 - busy / span, quant_matmul_ms=k6 / 1e3,
         quant_matmul_share_of_busy=k6 / busy,
         quant_matmul_kernels_ms={k[:80]: v / 1e3 for k, v in by_name.items()
                                  if "quant_" in k},
         top_kernels_ms=[(k[:80], v / 1e3) for k, v in top])
    span, busy, k6, by_name, kern = device_time(torch, prof, "quant_")
    # Ops dispatched from Python: aten ops not nested inside another op.
    top_ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.cpu_parent is None and e.name.startswith("aten::")]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    q1, decode_ms, q3 = statistics.quantiles(walls, n=4)
    out = dict(
        batch=B, prompt_bucket=PROMPT_LEN, prefill_ms=prefill_ms,
        decode_steps=len(walls), decode_step_ms=decode_ms,
        decode_step_ms_q1=q1, decode_step_ms_q3=q3,
        decode_step_ms_min=min(walls), decode_step_ms_max=max(walls),
        decode_tokens_per_s=B * 1e3 / decode_ms,
        profiled_steps=n, device_busy_share=busy / span,
        device_idle_share=1 - busy / span,
        kernel_ms_per_step=busy / n / 1e3,
        quant_matmul_ms_per_step=k6 / n / 1e3,
        quant_matmul_share_of_busy=k6 / busy,
        top_level_aten_ops_per_step=len(top_ops) / n,
        device_kernels_per_step=len(kern) / n,
        top_kernels_ms_per_step=[(k[:80], v / n / 1e3) for k, v in top])
    emit("where_time_goes_llama_8b_int8_decode", card=card, **out)
    return out


# ------------------------------------------------------ continuous engine --

# Phase 9c's fifth prompt repeats prompt 0's first 100 tokens and adds 5
# (6 full blocks shared, the 7th copied on write), and its long prompt
# (1,500 tokens) prefills in chunks between decode boundaries.
SHARED, LONG_PROMPT = 100, 1500
DECODE_ROUND = 128  # new tokens a request in phase 9c's decode round
# How far the paged path's logits may part from the static path's, as
# multiples of how far the static path parts from itself between a batch
# of four and each prompt alone (on an H100 80GB HBM3 at 700 W: 1.00x the
# mean and 1.12x the max).
PART_LIMIT = {"mean": 1.25, "max": 1.5}


def forced_logits(torch, model, prompts, tokens, window=None, chunk=32):
    """[B, N, V] f32: the logits of each step that chose ``tokens`` [B][N]
    after the right-padded ``prompts``, fed those tokens. ``window`` None:
    over the monolithic cache, generate's path (the static engine's);
    else over a paged cache of ``window`` pages a row, the prompts
    prefilled in chunks of ``chunk`` as the continuous engine does."""
    from serverless_learn_tpu_torch.inference.generate import init_cache
    from serverless_learn_tpu_torch.inference.kvcache import (
        paged_cache, sequential_table)

    cfg = model.cfg
    B, P = len(prompts), max(len(p) for p in prompts)
    toks = torch.zeros(B, P, dtype=torch.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    toks = toks.cuda()
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32).cuda()
    rows = torch.arange(B, device="cuda")
    with torch.inference_mode():
        if window is None:
            cache = init_cache(model, B)
            last = model(toks, cache=cache, prefill=True,
                         seq_lengths=lens)[rows, lens.long() - 1]
        else:
            cache = paged_cache(cfg.n_layers, B * window, 16, cfg.kv_heads,
                                cfg.head_dim, cfg.dtype, "cuda",
                                sequential_table(B, window, B * window))
            last = torch.zeros(B, cfg.vocab_size, dtype=cfg.dtype,
                               device="cuda")
            for start in range(0, P, chunk):
                n = (lens - start).clamp(0, chunk)
                out = model(toks[:, start:start + chunk], cache=cache,
                            extend=True, seq_lengths=n)
                ends = (n > 0) & (lens - start <= chunk)
                last[ends] = out[rows, (n.long() - 1).clamp(min=0)][ends]
        steps = [last]
        fed = torch.tensor(tokens, dtype=torch.int32).cuda()
        for j in range(fed.shape[1] - 1):
            steps.append(model(fed[:, j:j + 1], cache=cache,
                               decode=True)[:, 0])
    return torch.stack(steps, 1).float()


def prefix_expectation(groups, block, chunk):
    """(prefix hits, prefill chunks) the continuous engine must count for
    ``groups``: lists of prompts, each group admitted while only the
    earlier groups' prompts are published (their full blocks). A prompt
    skips its longest published full-block prefix, plus the leading
    tokens its partial last block shares with a published block (copy on
    write), never its last token; it is a hit when it skips any, and
    prefills the rest in chunks of ``chunk``. Nothing is evicted."""
    pub, hits, chunks = set(), 0, 0
    for group in groups:
        for p in group:
            p, L = tuple(p), len(p)
            m = 0
            while m + block <= L and p[:m + block] in pub:
                m += block
            rem, cow = p[m:m + block], 0
            if rem and len(rem) < block:
                for q in pub:
                    if len(q) == m + block and q[:m] == p[:m]:
                        n = 0
                        while n < len(rem) and q[m + n] == rem[n]:
                            n += 1
                        cow = max(cow, n)
            skip = min(m + cow, L - 1)
            hits += skip > 0
            chunks += -(-(L - skip) // chunk)
        for p in group:
            pub.update(tuple(p[:k]) for k in range(block, len(p) + 1, block))
    return hits, chunks


def published(trie, prompt) -> bool:
    """Whether every full block of ``prompt`` is in the prefix trie (read
    without a lookup, which would count as a hit or a miss)."""
    node, bs = trie._root, trie.block_size
    for i in range(0, len(prompt) - len(prompt) % bs, bs):
        node = node.children.get(tuple(prompt[i:i + bs]))
        if node is None:
            return False
    return True


def static_references(torch, model, prompts, static_replies):
    """The static path's logits for phase 9c: top-2 margins of every step
    of phase 9's group of four; and how far the paged path's logits part
    from the static path's over the same tokens, as the engine runs it (the
    group prefilled in chunks of 32 under windows of 16 and 256 pages, and
    each prompt alone in chunks of 8, which K6's decode kernel then takes,
    as for a prefix hit's short remainder), beside the yardstick of how far
    the static path parts from itself (each prompt alone against the
    group: other row counts, so other sums in other orders)."""
    static = forced_logits(torch, model, prompts, static_replies)
    variants = {"chunk32_w16": forced_logits(torch, model, prompts,
                                             static_replies, 16),
                "chunk32_w256": forced_logits(torch, model, prompts,
                                              static_replies, 256),
                "alone_chunk8_w16": torch.cat([
                    forced_logits(torch, model, [p], [r], 16, chunk=8)
                    for p, r in zip(prompts, static_replies)]),
                "static_alone": torch.cat([
                    forced_logits(torch, model, [p], [r])
                    for p, r in zip(prompts, static_replies)])}
    diffs = {}
    for k, v in variants.items():
        d = (v - static).abs()
        diffs[k] = dict(max=d.max().item(), mean=d.mean().item())
    del variants, d
    v = static.topk(2, dim=-1).values
    return (v[..., 0] - v[..., 1]).tolist(), diffs


def static_gaps(torch, model, prompt, reply):
    """At each step of ``reply``: how far below the static path's largest
    logit lies its logit of the token the reply chose, the static path
    (``prompt`` alone, over the monolithic cache) fed the reply's own
    tokens. 0 where the reply took the static path's argmax."""
    lg = forced_logits(torch, model, [prompt], [reply])[0]
    chosen = lg.gather(1, torch.tensor(reply, device=lg.device)[:, None])
    return (lg.max(-1).values - chosen[:, 0]).tolist()


def graph_vs_eager_chunk(torch, eng, prompts):
    """Prefill ``prompts`` (greedy) into fresh pages of ``eng``'s pool,
    then run one decode chunk of their (nb, W) bucket twice from the same
    state: replayed from its CUDA graph (on the card; eagerly on the CPU)
    and eagerly. Returns both runs' tokens and whether the tokens and the
    rows' pages came out bit-identical. Call only while no request is in
    flight; the pages go back to the pool."""
    import numpy as np

    from serverless_learn_tpu_torch.inference.batching import _bucket
    from serverless_learn_tpu_torch.inference.continuous import (_Rows,
                                                                 _wbucket)
    from serverless_learn_tpu_torch.inference.kvcache import pages_for

    C, ps, pool = eng.chunk_size, eng._ps, eng._pool
    n = len(prompts)
    nb = _bucket(n, floor=1)
    got = [pool.alloc(pages_for(len(p) + C, ps)) for p in prompts]
    W = min(_wbucket(max(len(g) for g in got)), eng._max_pages)
    tbl = np.full((nb, W), pool.sentinel, np.int32)
    toks = np.zeros((nb, max(len(p) for p in prompts)), np.int32)
    lens = np.zeros((nb,), np.int32)
    for i, (p, g) in enumerate(zip(prompts, got)):
        tbl[i, :len(g)] = g
        toks[i, :len(p)] = p
        lens[i] = len(p)
    try:
        with eng._lock, torch.no_grad(), eng._on_stream():
            pages = eng._pages
            kv = pages.pages_k + pages.pages_v
            lens_t, tbl_t = eng._to_dev(lens), eng._to_dev(tbl)
            cache = pages.with_tables(tbl_t, torch.zeros_like(lens_t))
            logits = eng.model(eng._to_dev(toks), cache=cache, extend=True,
                               seq_lengths=lens_t)
            chunk = eng._chunk(nb, W)
            s = chunk.rows
            s.tok.copy_(torch.argmax(logits[
                torch.arange(nb, device=eng.device),
                (lens_t.long() - 1).clamp(min=0)], dim=-1))
            s.pos.fill_(1)
            s.done.copy_(lens_t == 0)
            s.temp.zero_()
            s.topk.zero_()
            s.eos.fill_(-1)
            s.seed.zero_()
            s.ci.copy_(cache.index)
            chunk.table.copy_(tbl_t)
            ids = eng._to_dev(np.asarray(sum(got, []), np.int64))
            start = ([getattr(s, nm).clone() for nm in _Rows.NAMES],
                     [p[ids].clone() for p in kv])
            runs = []
            for graph in (eng._cuda, False):
                for nm, v in zip(_Rows.NAMES, start[0]):
                    getattr(s, nm).copy_(v)
                for p, v in zip(kv, start[1]):
                    p[ids] = v
                chunk.run(graph=graph)
                runs.append((chunk.out.clone(), [p[ids].clone() for p in kv]))
            if eng._cuda:
                torch.cuda.current_stream(eng.device).synchronize()
    finally:
        for g in got:
            pool.decref(g)
    (t_graph, p_graph), (t_eager, p_eager) = runs
    # Pad rows read the scratch page, which both runs write: compare the
    # real rows.
    t_graph, t_eager = t_graph[:n], t_eager[:n]
    same = torch.equal(t_graph, t_eager) and all(
        torch.equal(a, b) for a, b in zip(p_graph, p_eager))
    return {"nb": nb, "W": W, "graph": eng._cuda,
            "tokens_graph": t_graph.tolist(),
            "tokens_eager": t_eager.tolist(), "identical": same}


def k6_calls(kern) -> int:
    """Calls of the int8 matmul among a profile's kernels: each call runs
    one ``quant_decode`` or ``quant_prefill`` (and a split call one
    ``quant_reduce`` after it)."""
    return sum(1 for e in kern
               if "quant_decode" in e.name or "quant_prefill" in e.name)


def trace_replays(torch, eng, replays, per_fwd):
    """What a continuous engine's graph replays launched, from the card's
    trace: one replayed step of each bucket in ``replays`` ({(nb, W):
    replays}), its table all sentinel (the scratch page only), must hold
    one int8 matmul call for each projection, ``per_fwd``; a run's
    replayed calls are its replays times those. Each step's trace also
    gives its device time. Returns ({bucket: record}, replayed calls,
    faults)."""
    traced, faults = {}, []
    for key in sorted(replays):
        chunk = eng._chunks[key]
        chunk.table.fill_(eng._pool.sentinel)
        chunk.step.zero_()
        torch.cuda.synchronize()
        with profiled() as prof:
            chunk.graph.replay()
            torch.cuda.synchronize()
        span, _, _, _, kern = device_time(torch, prof, "quant_")
        traced["nb%d_w%d" % key] = dict(
            replays=replays[key], k6_calls_per_step=k6_calls(kern),
            device_kernels_per_step=len(kern), device_ms_per_step=span / 1e3)
        if k6_calls(kern) != per_fwd:
            faults.append(f"a replayed step of bucket {key} ran "
                          f"{k6_calls(kern)} int8 matmul calls, not "
                          f"{per_fwd}")
    replayed = sum(t["replays"] * t["k6_calls_per_step"]
                   for t in traced.values())
    return traced, replayed, faults


def serve_continuous(torch, card, model, static_replies, static_step):
    """Phase 9c: phase 9's llama_8b int8 served through GenerationServer's
    defaults: the continuous engine over the paged pool (block 16,
    prefill_chunk 32, budget 64, prefix cache on), decode chunks replayed
    from CUDA graphs. The server has a fresh registry, the metrics
    endpoint, an event log and the profiler armed: after the rounds the
    engine's counters must equal what the phase sent, every reply's span
    must carry a waterfall whose own host time is under 2 % of its decode
    time, and a ``/debug/profile?seconds=2`` capture taken from the
    exporter's thread during a second 128-token round must hold the
    serving thread's ``quant_decode`` kernels."""
    import os
    import shutil
    import tempfile

    from serverless_learn_tpu_torch.config import KVCacheConfig
    from serverless_learn_tpu_torch.inference.generate import generate
    from serverless_learn_tpu_torch.inference.server import (GenerationServer,
                                                            request)
    from serverless_learn_tpu_torch.ops.quant_matmul import quant_matmul
    from serverless_learn_tpu_torch.telemetry import (MetricsRegistry,
                                                      fetch_text)

    cfg = model.cfg
    V = cfg.vocab_size
    prompts = serve_prompts(torch, V)
    g = torch.Generator().manual_seed(4)
    fifth = prompts[0][:SHARED] + torch.randint(0, V, (5,),
                                                generator=g).tolist()
    long_p = torch.randint(0, V, (LONG_PROMPT,), generator=g).tolist()
    # The static path's replies and logits, before the engine starts:
    # phase 9's group of four, and the fifth and the long prompt alone.
    with torch.inference_mode():
        solo = [generate(model, torch.tensor([p]), NEW_TOKENS)[0, len(p):]
                .tolist() for p in (fifth, long_p)]
    want = static_replies + solo
    margins, diffs = static_references(torch, model, prompts, static_replies)
    # The logit tolerance: the largest logit difference measured between
    # the paths. A reply's token must lie within it of the static path's
    # largest logit at every step.
    tol = max(d["max"] for d in diffs.values())
    # The EOS request repeats the phase 9 prompt whose static margins are
    # widest over steps 0-5, with eos_id its static reply's token at step 5.
    e = max(range(SERVE_BATCH), key=lambda i: min(margins[i][:6]))
    eos_id = static_replies[e][5]
    greedy = [{"prompt": p, "max_new_tokens": NEW_TOKENS}
              for p in prompts + [fifth, long_p]]
    sampled = {"prompt": prompts[0], "max_new_tokens": NEW_TOKENS,
               "temperature": 0.8, "top_k": 40, "seed": 1}
    eos_req = {"prompt": prompts[e], "max_new_tokens": NEW_TOKENS,
               "eos_id": eos_id}
    first = greedy[:SERVE_BATCH] + [sampled]
    later = greedy[SERVE_BATCH:] + [eos_req]
    forwards, rows_served = [0], set()

    def count_forward(mod, args):
        forwards[0] += 1
        rows_served.add(args[0].numel())

    hook = model.register_forward_pre_hook(count_forward)
    torch.cuda.reset_peak_memory_stats()
    tel = tempfile.mkdtemp(prefix="slt-phase9c-")
    events_path = os.path.join(tel, "events.jsonl")
    registry = MetricsRegistry()
    server = GenerationServer(model, port=0, registry=registry,
                              metrics_port=0, event_log_path=events_path,
                              profile_dir=os.path.join(tel, "profiles"))
    server.start()
    eng = server.engine
    # The host clock at the end of each harvest, with its dispatch's kind.
    harvests = []
    harvest = eng._harvest

    def timed_harvest(fut):
        harvest(fut)
        harvests.append((fut[0], time.perf_counter()))

    eng._harvest = timed_harvest
    replies = [None] * (len(first) + len(later))

    def client(i, req):
        replies[i] = request(server.addr, req, timeout=600)

    try:
        t = time.perf_counter()
        warm_graphs = eng.warm_shapes(
            [(PROMPT_LEN, NEW_TOKENS), (len(fifth), NEW_TOKENS),
             (LONG_PROMPT, NEW_TOKENS), (PROMPT_LEN, DECODE_ROUND)])
        warm_s = time.perf_counter() - t
        quant_matmul.launches = 0
        forwards[0] = 0
        rows_served.clear()
        cap0 = eng.graph_captures
        rep0 = {key: c.replays for key, c in eng._chunks.items()}
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i, r))
                   for i, r in enumerate(first)]
        for th in threads:
            th.start()
        # The fifth prompt, the long one and the EOS request come once
        # phase 9's prompts are published in the prefix trie, while the
        # first five decode.
        while not all(published(eng._trie, p) for p in prompts):
            if time.perf_counter() - t0 > 300:
                fail("phase 9's prompts were never published in the trie")
            time.sleep(0.002)
        admitted_at = eng.chunks_run
        for i, r in enumerate(later):
            threads.append(threading.Thread(target=client,
                                            args=(len(first) + i, r)))
            threads[-1].start()
        for th in threads:
            th.join(timeout=900)
        if any(th.is_alive() for th in threads):
            fail("a request did not finish")
        wall = time.perf_counter() - t0
        # Eager launches, counted by the kernel's wrapper: prefill chunks,
        # and the warm-up and the capture of any bucket captured here.
        launches, n_eager = quant_matmul.launches, forwards[0]
        captures = eng.graph_captures - cap0
        replays = {key: c.replays - rep0.get(key, 0)
                   for key, c in eng._chunks.items()}
        replays = {key: n for key, n in replays.items() if n}
        # Replayed steps pass no forward hook: their rows are the buckets'.
        rows_served |= {nb for nb, _ in replays}
        stats = eng.kv_stats()
        hits = eng._trie.hits
        # A decode round: phase 9's prompts again (prefix hits), 128 new
        # tokens each, four chunks of pure decode one after another.
        t1 = time.perf_counter()
        round2 = [None] * SERVE_BATCH
        th2 = [threading.Thread(target=lambda i: round2.__setitem__(
            i, request(server.addr, {"prompt": prompts[i],
                                     "max_new_tokens": DECODE_ROUND},
                       timeout=600)), args=(i,)) for i in range(SERVE_BATCH)]
        for th in th2:
            th.start()
        for th in th2:
            th.join(timeout=600)
        round_wall = time.perf_counter() - t1
        round_log = [h for h in harvests if h[1] >= t1]
        # The same round again under an on-demand capture, taken by the
        # exporter's HTTP thread while the engine's thread serves (after
        # the timed round: a profiler session slows the launches).
        profile = {}

        def capture():
            profile.update(json.loads(fetch_text(
                server.metrics_addr, "/debug/profile?seconds=2",
                timeout=120)))

        cap = threading.Thread(target=capture)
        cap.start()
        time.sleep(0.5)  # the session is running before the requests
        th3 = [threading.Thread(target=lambda i: request(
            server.addr, {"prompt": prompts[i], "max_new_tokens":
                          DECODE_ROUND}, timeout=600), args=(i,))
               for i in range(SERVE_BATCH)]
        for th in th3:
            th.start()
        for th in th3 + [cap]:
            th.join(timeout=600)
        # EOS alone, where the trajectory is known: the EOS prompt served
        # alone, then again alone with eos_id its own token at step 5.
        plain = request(server.addr, {"prompt": prompts[e],
                                      "max_new_tokens": NEW_TOKENS})
        stop = plain["new_tokens"][5]
        stopped = request(server.addr, {"prompt": prompts[e],
                                        "max_new_tokens": NEW_TOKENS,
                                        "eos_id": stop})
        scraped = fetch_text(server.metrics_addr, "/metrics")
    finally:
        server.stop()
        hook.remove()
    n_req = len(first) + len(later) + 2 * SERVE_BATCH + 2
    # The phase's own order: the first five together on an empty trie,
    # the later three once phase 9's prompts are published, two decode
    # rounds of them, then the EOS prompt twice alone.
    kv = KVCacheConfig()
    want_hits, want_chunks = prefix_expectation(
        [[r["prompt"] for r in first], [r["prompt"] for r in later],
         prompts, prompts, [prompts[e]], [prompts[e]]],
        kv.block_size, kv.prefill_chunk)
    telemetry = engine_telemetry(
        "continuous", registry, events_path, scraped, requests=n_req,
        finished=n_req,
        tokens=(len(first) + len(later) + 2) * NEW_TOKENS
        + 2 * SERVE_BATCH * DECODE_ROUND,
        prefill_chunks=want_chunks, prefix_hits=want_hits, preemptions=0)
    telemetry["harvest_telemetry_ms_per_decode_chunk"] = (
        eng.telemetry_host_s * 1e3 / max(eng.decode_harvests, 1))
    telemetry["decode_harvests"] = eng.decode_harvests
    if not profile.get("ok"):
        fail(f"phase 9c: /debug/profile answered {profile}")
    with open(profile["trace"]) as f:
        trace_text = f.read()
    telemetry["profile"] = dict(
        ok=profile.get("ok"), seconds=profile.get("seconds"),
        trace_mb=len(trace_text) / 1e6,
        quant_decode_events=trace_text.count("::quant_decode<"))
    shutil.rmtree(tel, ignore_errors=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pages = eng._pages
    pool_bytes = sum(p.numel() * p.element_size()
                     for p in pages.pages_k + pages.pages_v)

    for req, rep in zip(first + later, replies):
        if "error" in rep:
            fail(f"server error: {rep['error']}")
        new = rep["new_tokens"]
        if (len(new) != NEW_TOKENS or rep["tokens"] != req["prompt"] + new
                or not all(0 <= t < V for t in new)):
            fail(f"malformed reply: {str(rep)[:300]}")
    if any(r is None or len(r.get("new_tokens", ())) != DECODE_ROUND
           for r in round2):
        fail(f"malformed decode-round reply: {str(round2)[:300]}")
    got = [replies[i]["new_tokens"] for i in range(SERVE_BATCH)]
    got += [replies[len(first) + i]["new_tokens"] for i in (0, 1)]
    eos_rep = replies[-1]["new_tokens"]
    # Where each greedy reply first leaves the static path's reply (the
    # static top-2 margin there), for the record; the check is the next.
    diverged = {}
    for i, (a, b) in enumerate(zip(got, want)):
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is not None:
            diverged[str(i)] = (j, margins[i][j] if i < SERVE_BATCH
                                else None)
    # Every step of every greedy reply (and of the EOS request's up to its
    # stop): the token the engine chose lies within the logit tolerance of
    # the static path's largest logit, the static path fed the reply's own
    # tokens. A page, table, compaction or copy-on-write fault after the
    # first steps picks tokens far below it.
    k = eos_rep.index(eos_id) if eos_id in eos_rep else None
    checked = [(p["prompt"], r) for p, r in zip(greedy, got)]
    checked.append((eos_req["prompt"],
                    eos_rep if k is None else eos_rep[:k + 1]))
    gaps = [static_gaps(torch, model, p, r) for p, r in checked]
    faults = [f"greedy reply {i} took at step {j} a token {gap:.4g} below "
              f"the static path's largest logit, beyond the logit "
              f"tolerance {tol:.4g}"
              for i, gs in enumerate(gaps) for j, gap in enumerate(gs)
              if gap > tol]
    # The paged path parts from the static one no further than the static
    # path parts from itself.
    own = diffs["static_alone"]
    for name, d in diffs.items():
        if not (d["mean"] <= PART_LIMIT["mean"] * own["mean"]
                and d["max"] <= PART_LIMIT["max"] * own["max"]):
            faults.append(f"the paged path's logits ({name}) part from the "
                          f"static path's by {d}, the static path's own "
                          f"yardstick {own}")
    # The EOS request emits only eos_id after its first (its tokens up to
    # there are checked above).
    k_s = static_replies[e].index(eos_id)
    if k is not None and eos_rep[k:] != [eos_id] * (NEW_TOKENS - k):
        faults.append(f"the request with eos_id {eos_id} did not stop at "
                      f"its first eos_id: {eos_rep}")
    k2 = plain["new_tokens"].index(stop)
    if stopped.get("new_tokens") != (plain["new_tokens"][:k2 + 1]
                                     + [stop] * (NEW_TOKENS - k2 - 1)):
        faults.append(f"served alone with eos_id {stop}, the request did "
                      f"not stop at step {k2}: {stopped}")
    if stats["blocks_total"] - stats["blocks_free"] != \
            stats["prefix_blocks_cached"] or hits < 2:
        faults.append("pages leaked or the prefix was not reused")
    per_fwd = 7 * cfg.n_layers + 1
    if n_eager <= 0 or launches != per_fwd * n_eager:
        faults.append(f"{launches} kernel launches for {n_eager} eager "
                      f"forwards; expected {per_fwd} per forward")
    if not rows_served <= set(CHECK_ROWS):
        faults.append(f"the kernel served row counts {sorted(rows_served)}"
                      f", phase 3 checked only {list(CHECK_ROWS)}")
    if not replays:
        faults.append("no decode chunk was replayed from a CUDA graph")
    graph_check = graph_vs_eager_chunk(torch, eng, prompts)
    if not graph_check["identical"]:
        faults.append("a decode chunk replayed from its graph differs from "
                      "the eager chunk")

    traced, replayed, bad = trace_replays(torch, eng, replays, per_fwd)
    faults += bad

    # Decode time per token (one decode step, a token for every live row):
    # the host clock between the harvests of two decode chunks dispatched
    # one after the other, over chunk_size, in the decode round.
    C = eng.chunk_size
    per_tok = [(b[1] - a[1]) * 1e3 / C
               for a, b in zip(round_log, round_log[1:])
               if a[0] == b[0] == "pchunk"]
    # One decode chunk under the profiler: the graph of the phase's
    # commonest bucket, its table all sentinel.
    chunk = eng._chunks.get((SERVE_BATCH, 16)) or next(
        iter(eng._chunks.values()))
    chunk.table.fill_(eng._pool.sentinel)
    with profiled() as prof:
        chunk.run(graph=True)
        torch.cuda.synchronize()
    span, busy, k6, _, kern = device_time(torch, prof, "quant_")
    emit("serve_continuous_llama_8b_int8", card=card,
         requests=len(replies), wall_s=wall, warm_graphs=warm_graphs,
         warm_s=warm_s, chunks_run=eng.chunks_run,
         prefill_chunks_run=eng.prefill_chunks_run,
         later_admitted_at_chunk=admitted_at,
         preemptions=eng.preemptions, kv=stats, trie_hits=hits,
         pool_gb=pool_bytes / 1e9, max_memory_allocated_gb=peak_gb,
         eager_forwards=n_eager, kernel_launches_eager=launches,
         graph_captures=captures, graph_replays=sum(replays.values()),
         kernel_launches_replayed_traced=replayed, replayed_buckets=traced,
         forwards=n_eager - captures + sum(replays.values()),
         rows_served=sorted(rows_served), logit_tolerance=tol,
         logit_abs_diff=diffs,
         steps_checked=sum(len(gs) for gs in gaps),
         worst_gap_to_static_max=[max(gs) for gs in gaps],
         steps_off_static_argmax=[sum(gap > 0 for gap in gs) for gs in gaps],
         diverged_from_static_reply=diverged,
         eos_prompt=e, eos_id=eos_id, eos_static_step=k_s, eos_stop=k,
         eos_alone_stop=k2,
         graph_check={name: v for name, v in graph_check.items()
                      if not name.startswith("tokens")},
         decode_ms_per_token=(statistics.median(per_tok) if per_tok
                              else None),
         decode_ms_per_token_all=per_tok, round_wall_s=round_wall,
         round_new_tokens_per_s=SERVE_BATCH * DECODE_ROUND / round_wall,
         static_decode_step_ms=static_step["decode_step_ms"],
         static_decode_step_ms_q1_q3=(static_step["decode_step_ms_q1"],
                                      static_step["decode_step_ms_q3"]),
         profiled_chunk=dict(
             rows=chunk.rows.tok.shape[0], window=chunk.table.shape[1],
             steps=C, span_ms=span / 1e3, busy_ms=busy / 1e3,
             device_ms_per_step=span / C / 1e3,
             device_idle_share=1 - busy / span, quant_matmul_ms=k6 / 1e3,
             k6_calls=k6_calls(kern), device_kernels=len(kern)),
         telemetry=telemetry)
    if faults:
        fail("phase 9c: " + "; ".join(faults))
    if not telemetry["profile"]["quant_decode_events"]:
        fail("phase 9c: the /debug/profile capture holds no quant_decode "
             "kernel")
    frac = telemetry["ledger_overhead_frac"]
    if frac is None or not frac < 0.02:
        fail(f"phase 9c: the waterfalls' host time is {frac} of their "
             "decode time, not under 0.02")
    return launches, replayed


# ---------------------------------------------------------------- training --

# The training slice's attention shape: llama_1b (32 heads / 8 KV heads,
# head dim 64), batch 2 x 4096 tokens, causal, bf16.
TRAIN_B, TRAIN_T = 2, 4096
# Phase 8b's step time and tokens/s, printed beside phase 13's worker.
PHASE_8B: dict = {}
FLASH_SHAPE = (TRAIN_B, TRAIN_T, TRAIN_T, 32, 8, 64)
# The LoRA slice's: llama_8b (32 heads / 8 KV heads, head dim 128).
FLASH_SHAPE_8B = (TRAIN_B, TRAIN_T, TRAIN_T, 32, 8, 128)
# bert_base's attention in a phase 16b microbatch: 32 rows of 512, 12
# heads, head dim 64, non-causal, suffix padding as "len".
BERT_FLASH_SHAPE = (32, 512, 512, 12, 12, 64)
FLASH_CASES = [
    # name, (b, t, s, h, k, d), causal, mode, dtype
    ("train_shape", FLASH_SHAPE, True, "none", "bfloat16"),
    ("train_shape_8b", FLASH_SHAPE_8B, True, "none", "bfloat16"),
    ("ragged_1000", (1, 1000, 1000, 32, 8, 64), True, "none", "bfloat16"),
    ("non_causal", (2, 1024, 1024, 32, 8, 64), False, "none", "bfloat16"),
    ("mha_h_eq_k", (2, 1024, 1024, 8, 8, 64), True, "none", "bfloat16"),
    ("len_987_and_0", (2, 1024, 1024, 32, 8, 64), True, "len", "bfloat16"),
    ("rows_mask", (2, 1024, 1024, 32, 8, 64), False, "rows", "bfloat16"),
    ("f32", (1, 1024, 1024, 32, 8, 64), True, "none", "float32"),
    ("tiny_d32_f32", (2, 512, 512, 4, 2, 32), True, "none", "float32"),
    ("d128", (1, 512, 512, 8, 2, 128), True, "none", "bfloat16"),
    # the llama_8b head layout (32 / 8 heads, D = 128), ragged and masked
    ("d128_ragged_1000", (1, 1000, 1000, 32, 8, 128), True, "none",
     "bfloat16"),
    ("d128_len_987_and_0", (2, 1024, 1024, 32, 8, 128), True, "len",
     "bfloat16"),
    ("d128_rows_mask", (2, 1024, 1024, 32, 8, 128), False, "rows",
     "bfloat16"),
    ("d32_ragged_520", (2, 520, 520, 4, 2, 32), True, "none", "bfloat16"),
    ("t300_s520_rows", (2, 300, 520, 8, 2, 64), False, "rows", "bfloat16"),
    # bert_base's training attention (phase 16b's microbatch): 12 heads,
    # non-causal, "len" from the suffix padding (len_rows over the rows);
    # then non-causal "len" at the llama_1b GQA layout and at D = 128
    ("bert_len", BERT_FLASH_SHAPE, False, "len", "bfloat16"),
    ("gqa_len_non_causal", (2, 1024, 1024, 32, 8, 64), False, "len",
     "bfloat16"),
    ("d128_len_non_causal", (2, 1024, 1024, 32, 8, 128), False, "len",
     "bfloat16"),
]
# K1, K2 and K3 run twice on these cases and must repeat bit for bit (no
# atomics).
REPEAT_CASES = ("train_shape", "train_shape_8b")
# The parent tree's kernels' times at phase 7's shapes, by head dim (ms:
# K1 on mma.sync, K2 and K3 on wgmma; NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6), printed beside this run's.
PARENT_FLASH_MS = {
    64: {"flash_fwd": 0.776, "flash_dq": 0.500, "flash_dkv": 0.733},
    128: {"flash_fwd": 1.350, "flash_dq": 0.697, "flash_dkv": 1.029},
}
# Forward + backward of K1-K3 against the dense form at these sequence
# lengths (batch TRAIN_B, causal, both head layouts).
CROSSOVER_T = (1024, 2048, 4096)


def len_rows(b: int, s: int):
    """"len" mode's lengths: with two rows one off the 64-row tile and one
    empty; with more (bert_len), the full length, one off the tile (487 of
    512), 1 and 0 spread over the rows."""
    if b <= 2:
        return [s - 37, 0][:b]
    return [(s, s - 25, 1, 0)[i % 4] for i in range(b)]


def flash_inputs(torch, g, shape, mode, dtype):
    b, t, s, h, k, d = shape
    dt = getattr(torch, dtype)
    q = torch.randn(b, t, h, d, generator=g, device="cuda").to(dt)
    kk = torch.randn(b, s, k, d, generator=g, device="cuda").to(dt)
    v = torch.randn(b, s, k, d, generator=g, device="cuda").to(dt)
    dout = torch.randn(b, t, h, d, generator=g, device="cuda").to(dt)
    arg = None
    if mode == "len":
        arg = torch.tensor(len_rows(b, s), dtype=torch.int32, device="cuda")
    elif mode == "rows":
        arg = (torch.rand(b, s, generator=g, device="cuda") > 0.3).to(
            torch.int32)
    return q, kk, v, dout, arg


def check_flash(torch, card):
    """Phase 6: K1, K2, K3 against their plain versions; the worst error of
    each output in each case."""
    from serverless_learn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(5)
    worst = {"flash_fwd": 0.0, "flash_dq": 0.0, "flash_dkv": 0.0}
    worst_ratio = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for name, shape, causal, mode, dtype in FLASH_CASES:
        q, k, v, dout, arg = flash_inputs(torch, g, shape, mode, dtype)
        kw = dict(causal=causal, mode=mode, arg=arg)
        out, lse = fa.flash_fwd(q, k, v, **kw)
        delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
        delta = delta.contiguous()
        dq = fa.flash_dq(q, k, v, dout, lse, delta, **kw)
        dk, dv = fa.flash_dkv(q, k, v, dout, lse, delta, **kw)
        repeats = None
        if name in REPEAT_CASES:
            out2, lse2 = fa.flash_fwd(q, k, v, **kw)
            dq2 = fa.flash_dq(q, k, v, dout, lse, delta, **kw)
            dk2, dv2 = fa.flash_dkv(q, k, v, dout, lse, delta, **kw)
            repeats = {"out": torch.equal(out, out2),
                       "lse": torch.equal(lse, lse2),
                       "dq": torch.equal(dq, dq2), "dk": torch.equal(dk, dk2),
                       "dv": torch.equal(dv, dv2)}
            del out2, lse2, dq2, dk2, dv2
            if not all(repeats.values()):
                fail(f"flash {name}: K1-K3 do not repeat bit for bit: "
                     f"{repeats}")
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, **kw)
        ref_dq = fa.flash_dq_reference(q, k, v, dout, ref_lse, delta, **kw)
        ref_dk, ref_dv = fa.flash_dkv_reference(q, k, v, dout, ref_lse,
                                                delta, **kw)
        errs, ratios = {}, {}
        for out_name, got, ref in [("out", out, ref_out), ("dq", dq, ref_dq),
                                   ("dk", dk, ref_dk), ("dv", dv, ref_dv)]:
            limit = fa.kernel_tolerance(ref)
            err = (got.float() - ref.float()).abs()
            if not bool(torch.isfinite(got).all()):
                fail(f"flash {name}: non-finite {out_name}")
            # err / limit; a limit of 0 (an output all zero in the plain
            # version) takes only an exact 0
            ratio = torch.where(
                limit > 0, err / limit.clamp_min(1e-38),
                torch.where(err > 0, math.inf, 0.0)).max().item()
            errs[out_name], ratios[out_name] = err.max().item(), ratio
            worst_ratio[out_name] = max(worst_ratio[out_name], ratio)
            if not ratio <= 1:
                fail(f"flash {name}: {out_name} disagrees with plain: worst "
                     f"error / limit {ratio:.4g}, max abs "
                     f"{err.max().item():.4g}, max |ref| "
                     f"{ref.float().abs().max().item():.4g}")
        lse_err = ((lse - ref_lse).abs() / (1 + ref_lse.abs())).max().item()
        if not lse_err <= 1e-4:
            fail(f"flash {name}: lse disagrees with plain ({lse_err:.3g})")
        worst["flash_fwd"] = max(worst["flash_fwd"], errs["out"])
        worst["flash_dq"] = max(worst["flash_dq"], errs["dq"])
        worst["flash_dkv"] = max(worst["flash_dkv"], errs["dk"], errs["dv"])
        emit("check_flash", card=card, case=name, shape=list(shape),
             causal=causal, mode=mode, dtype=dtype,
             max_abs_err=errs, worst_err_over_limit=ratios,
             lse_rel_err=lse_err, repeat_bit_identical=repeats,
             max_abs_ref={"out": ref_out.float().abs().max().item(),
                          "dq": ref_dq.float().abs().max().item(),
                          "dk": ref_dk.float().abs().max().item(),
                          "dv": ref_dv.float().abs().max().item()})
        del q, k, v, dout, out, dq, dk, dv, ref_out, ref_dq, ref_dk, ref_dv
        torch.cuda.empty_cache()
    emit("check_flash_summary", card=card, cases=len(FLASH_CASES),
         worst=worst, worst_err_over_limit=worst_ratio,
         tolerance="ops.flash_attention.kernel_tolerance, per row of D: "
         "f32 1e-5 (|ref| + rowmax|ref|); bf16 2^-7 |ref| + 2^-6 "
         "rowmax|ref| (p rounded against the running max in K1, against "
         "the row's max in the plain version); both + 2^-16 max|ref|; lse "
         "1e-4 relative")
    return worst


def flash_bounds(shape, causal=True, lengths=None):
    """(ms, bound_by) of K1, K2 and K3 at ``shape`` in bf16: the larger of
    the products' FLOPs over 989 TFLOP/s (2 per multiply-add over the
    (q, k) pairs the mask keeps: K1 q k^T and p v; K2 adds dO v^T and ds k;
    K3 has q k^T, dO v^T, p^T dO and ds^T q) and the bytes each input and
    output moves once over 3.35 TB/s. With ``lengths`` ("len": row b's
    queries and keys past lengths[b] are padding) the pairs are this data's
    valid ones, and so are the inputs' bytes (q, k, v, dO, lse and delta
    are read only up to each row's length), while the outputs (out and
    lse, dq, dk and dv) are written whole, padding rows as zeros."""
    b, t, s, h, k, d = shape
    if lengths is None:
        pairs = b * h * (t * (t + 1) // 2 if causal else t * s)
        valid = 1.0
    else:
        pairs = h * sum(n * (n + 1) // 2 if causal else n * n
                        for n in lengths)
        valid = sum(lengths) / (b * t)
    q_bytes, kv_bytes, stat = b * t * h * d * 2, b * s * k * d * 2, b * h * t * 4
    read_bwd = valid * (2 * q_bytes + 2 * kv_bytes + 2 * stat)
    work = {
        "flash_fwd": (4 * d * pairs,
                      valid * (q_bytes + 2 * kv_bytes) + q_bytes + stat),
        "flash_dq": (6 * d * pairs, read_bwd + q_bytes),
        "flash_dkv": (8 * d * pairs, read_bwd + 2 * kv_bytes),
    }
    out = {}
    for name, (flops, moved) in work.items():
        ops_s, bytes_s = flops / BF16_FLOP_PER_S, moved / HBM_BYTES_PER_S
        out[name] = (max(ops_s, bytes_s) * 1e3,
                     "operations" if ops_s >= bytes_s else "bytes", flops)
    return out


def time_flash(torch, card):
    """Phase 7: K1, K2, K3 at the llama_1b training shape (the kernels
    line's figures), at the llama_8b LoRA attention shape and at bert_base's
    non-causal "len" shape (each row's ``bert``), each with the card's
    clocks sampled beside it, then the dense crossover."""
    rows = {}
    for shape, causal, mode in ((FLASH_SHAPE, True, "none"),
                                (FLASH_SHAPE_8B, True, "none"),
                                (BERT_FLASH_SHAPE, False, "len")):
        with ClockSampler() as clocks:
            got = time_flash_shape(torch, card, shape, causal, mode)
        summary = clocks.summary()
        emit("time_flash_clocks", card=card, shape=list(shape),
             causal=causal, mode=mode, **summary)
        mhz = (summary["sm_mhz_min_median_max"] or [None, None])[1]
        if shape == FLASH_SHAPE:
            rows = got
            for row in rows.values():
                row["sm_mhz"] = mhz
        elif shape == BERT_FLASH_SHAPE:
            for name, row in got.items():
                rows[name]["bert"] = dict(row, sm_mhz=mhz)
    flash_crossover(torch, card)
    return rows


def flash_crossover(torch, card):
    """Forward + backward of attention through the flash kernels (K1, then
    K2 and K3 from ``flash_attention``'s autograd) and through the dense
    form (``ops.attention.xla_attention``: einsums, an f32 softmax, ATen's
    backward), causal, bf16, B = TRAIN_B, at each CROSSOVER_T and both head
    layouts: where flash starts to win on this card. Measured only:
    ``impl="auto"`` keeps the reference's thresholds."""
    from serverless_learn_tpu_torch.ops.attention import xla_attention
    from serverless_learn_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for _, _, _, h, k, d in (FLASH_SHAPE, FLASH_SHAPE_8B):
        for t in CROSSOVER_T:
            q, kk, v, dout, _ = flash_inputs(
                torch, g, (TRAIN_B, t, t, h, k, d), "none", "bfloat16")
            q, kk, v = (x.requires_grad_() for x in (q, kk, v))
            row = {}
            for form, fn in (("flash", flash_attention),
                             ("dense", xla_attention)):
                def step(i, fn=fn):
                    fn(q, kk, v, causal=True).backward(dout)
                    q.grad = kk.grad = v.grad = None
                torch.cuda.reset_peak_memory_stats()
                # flash at T <= 2,048 is short enough for the host's
                # autograd and launches to show: the median of 3 runs
                row[f"{form}_ms"] = time_ms(torch, step, 10, warmup=2,
                                            reps=3)
                row[f"{form}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            row["dense_over_flash"] = row["dense_ms"] / row["flash_ms"]
            emit("flash_crossover", card=card, batch=TRAIN_B, seq_len=t,
                 heads=h, kv_heads=k, head_dim=d, causal=True,
                 dtype="bfloat16", **row)
            rows.append(row)
            del q, kk, v, dout
            torch.cuda.empty_cache()
    return rows


def time_flash_shape(torch, card, shape, causal=True, mode="none"):
    """K1, K2, K3 at ``shape`` (bf16; causal, or "len" with ``len_rows``),
    each beside its bound, its plain version and
    scaled_dot_product_attention (K1: its forward; K2, K3: its backward
    alone, split by their FLOP shares; under "len" with the boolean key
    mask); SDPA's forward + backward beside K1 + K2 + K3."""
    from serverless_learn_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, dout, arg = flash_inputs(torch, g, shape, mode, "bfloat16")
    kw = dict(causal=causal, mode=mode, arg=arg)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    # Each kernel warmed up at its own shape, then the median of 5 runs of
    # 20: K1, timed first, once read 1.79 ms against its steady 0.78 after
    # a warm-up of 3.
    ms = {
        "flash_fwd": time_ms(torch, lambda i: fa.flash_fwd(q, k, v, **kw), 20,
                             warmup=10, reps=5),
        "flash_dq": time_ms(torch, lambda i: fa.flash_dq(
            q, k, v, dout, lse, delta, **kw), 20, warmup=10, reps=5),
        "flash_dkv": time_ms(torch, lambda i: fa.flash_dkv(
            q, k, v, dout, lse, delta, **kw), 20, warmup=10, reps=5),
    }
    plain = {
        "flash_fwd": time_ms(torch, lambda i: fa.flash_fwd_reference(
            q, k, v, **kw), 3, warmup=1),
        "flash_dq": time_ms(torch, lambda i: fa.flash_dq_reference(
            q, k, v, dout, lse, delta, **kw), 3, warmup=1),
        "flash_dkv": time_ms(torch, lambda i: fa.flash_dkv_reference(
            q, k, v, dout, lse, delta, **kw), 3, warmup=1),
    }
    torch.cuda.empty_cache()
    F = torch.nn.functional
    qh, kh, vh, gh = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    sdpa = dict(is_causal=causal, enable_gqa=True)
    if mode == "len":
        # the boolean key mask of the same suffix padding [B, 1, 1, S]
        sdpa = dict(enable_gqa=True, attn_mask=(torch.arange(
            shape[2], device="cuda")[None, :] < arg[:, None])[:, None, None])
    # Warmed up and the median of 5 runs too, as the kernels are: one run
    # after a warm-up of 3 once read 3.6 ms against a steady ~0.34.
    lib_fwd = time_ms(torch, lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, **sdpa), 20, warmup=10, reps=5)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))

    def fwd_bwd(i):
        F.scaled_dot_product_attention(qg, kg, vg, **sdpa).backward(gh)

    lib_fwd_bwd = time_ms(torch, fwd_bwd, 10, warmup=5, reps=3)
    # SDPA's backward alone: one call that computes delta, dq, dk and dv
    # from the saved out and lse, the work of K2 + K3.
    og = F.scaled_dot_product_attention(qg, kg, vg, **sdpa)
    lib_bwd = time_ms(torch, lambda i: torch.autograd.grad(
        og, (qg, kg, vg), gh, retain_graph=True), 10, warmup=5, reps=3)
    bounds = flash_bounds(shape, causal, None if arg is None
                          else arg.tolist())
    bwd_flops = bounds["flash_dq"][2] + bounds["flash_dkv"][2]
    # K1's library time is SDPA's forward; K2's and K3's are SDPA's
    # backward split by their FLOP shares (6 : 8).
    library = {"flash_fwd": lib_fwd,
               "flash_dq": lib_bwd * bounds["flash_dq"][2] / bwd_flops,
               "flash_dkv": lib_bwd * bounds["flash_dkv"][2] / bwd_flops}
    rows = {}
    for name in ms:
        b_ms, by, flops = bounds[name]
        rows[name] = dict(ms=ms[name], plain_ms=plain[name], bound_ms=b_ms,
                          bound_by=by, flops=flops,
                          tflops_per_s=flops / ms[name] / 1e9,
                          fraction_of_bound=b_ms / ms[name],
                          library_ms=library[name],
                          parent_ms=(PARENT_FLASH_MS.get(shape[5], {}).get(
                              name) if mode == "none" else None))
        emit("time_flash", card=card, kernel=name, shape=list(shape),
             causal=causal, mode=mode, dtype="bfloat16", **rows[name])
    emit("time_flash_fwd_bwd", card=card, shape=list(shape), causal=causal,
         mode=mode, lengths=None if arg is None else arg.tolist(),
         kernels_ms=sum(ms.values()),
         kernels_bwd_ms=ms["flash_dq"] + ms["flash_dkv"],
         sdpa_fwd_ms=lib_fwd, sdpa_bwd_ms=lib_bwd,
         sdpa_fwd_bwd_ms=lib_fwd_bwd,
         library_call="torch.nn.functional.scaled_dot_product_attention("
                      "is_causal, enable_gqa=True; under len the boolean "
                      "key mask attn_mask [B, 1, 1, S]) on [B, H, T, D] "
                      "copies; its backward timed alone by autograd.grad "
                      "with retain_graph; timed here only, never called by "
                      "the port",
         library_split="library_ms: flash_fwd = SDPA forward; flash_dq and "
                       "flash_dkv = SDPA backward x their FLOP shares 6/14 "
                       "and 8/14")
    del q, k, v, dout, out, qh, kh, vh, gh, qg, kg, vg, og, sdpa
    torch.cuda.empty_cache()
    return rows


def tiny_train_config():
    from serverless_learn_tpu_torch.config import (DataConfig,
                                                   ExperimentConfig,
                                                   OptimizerConfig,
                                                   TrainConfig)

    return ExperimentConfig(
        model="llama_tiny", model_overrides={"attention_impl": "flash"},
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                  weight_decay=0.1, warmup_steps=1,
                                  decay_steps=4, grad_clip_norm=1.0),
        train=TrainConfig(batch_size=2, num_steps=3, seed=0,
                          dtype="float32"),
        data=DataConfig(seq_len=512))


def train_tiny_agreement(torch, card):
    """Phase 8a: llama_tiny (head dim 32, f32) with flash attention, three
    adamw steps with warmup, decay and clipping, on the card through the
    kernels and on the CPU through the plain versions, from the same
    weights and batches."""
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.training.loop import make_source
    from serverless_learn_tpu_torch.training.train_step import build_trainer

    cfg = tiny_train_config()
    cpu = build_trainer(cfg, "cpu")
    gpu = build_trainer(cfg, "cuda")
    cpu_state = cpu.init()
    gpu_state = gpu.init(params=cpu_state.model.state_dict())

    def run(trainer, state):
        losses = []
        for _, host in zip(range(cfg.train.num_steps),
                           make_source(cfg, trainer)):
            state, m = trainer.step(state, trainer.place(host))
            losses.append(float(m["loss"]))
        return losses, {k: v.detach().cpu()
                        for k, v in state.model.state_dict().items()}

    lc, pc = run(cpu, cpu_state)
    before = fa.flash_fwd.launches
    lg, pg = run(gpu, gpu_state)
    n = fa.flash_fwd.launches - before
    loss_err = max(abs(a - b) for a, b in zip(lc, lg))
    param_err = max((pc[k] - pg[k]).abs().max().item() for k in pc)
    emit("train_tiny_agreement", card=card, steps=len(lc), cpu_losses=lc,
         card_losses=lg, max_loss_diff=loss_err, max_param_diff=param_err,
         flash_fwd_launches=n,
         tolerance="losses within 1e-4, params within 2e-5 (f32 on both "
                   "sides, sums in other orders; adam moves every weight by "
                   "up to lr = 1e-3 a step, so 2e-5 is 2 % of one update)")
    if n != cfg.train.num_steps * 2:
        fail(f"tiny training launched the flash forward {n} times, expected "
             f"{cfg.train.num_steps * 2}")
    if not (loss_err <= 1e-4 and param_err <= 2e-5):
        fail(f"tiny training: card vs cpu losses differ by {loss_err:.3g}, "
             f"params by {param_err:.3g}")


def train_full_width(torch, card):
    """Phase 8b: llama_1b, batch 2 x 4096 tokens, 5 adamw steps (lr 1e-3,
    clip 1.0) through run_training, counters read around the run, then one
    more step under torch.profiler."""
    from serverless_learn_tpu_torch.config import (DataConfig,
                                                   ExperimentConfig,
                                                   OptimizerConfig,
                                                   TrainConfig)
    from serverless_learn_tpu_torch.models import transformer
    from serverless_learn_tpu_torch.ops import attention
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.training.loop import make_source, run_training
    from serverless_learn_tpu_torch.training.train_step import build_trainer

    steps = 5
    cfg = ExperimentConfig(
        model="llama_1b",
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                  grad_clip_norm=1.0),
        train=TrainConfig(batch_size=TRAIN_B, num_steps=steps, seed=0),
        data=DataConfig(seq_len=TRAIN_T))
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, "cuda")
    state = trainer.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mcfg = trainer.bundle.cfg
    n_params = sum(p.numel() for p in state.model.parameters())

    dense_calls = [0]
    real_dense = attention.xla_attention

    def counting_dense(*a, **kw):
        dense_calls[0] += 1
        return real_dense(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    attention.xla_attention = transformer.xla_attention = counting_dense
    fa.flash_fwd.launches = fa.flash_dq.launches = fa.flash_dkv.launches = 0
    try:
        state, meter = run_training(cfg, trainer=trainer, state=state)
    finally:
        attention.xla_attention = transformer.xla_attention = real_dense
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_dq": fa.flash_dq.launches,
                "flash_dkv": fa.flash_dkv.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [s.metrics["loss"] for s in meter.history]
    times = [s.step_time_s for s in meter.history]
    summary = meter.steady_state(skip=2)
    expected = math.log(mcfg.vocab_size) + 0.5
    emit("train_llama_1b", card=card, layers=mcfg.n_layers,
         d_model=mcfg.d_model, vocab=mcfg.vocab_size, params=n_params,
         batch=TRAIN_B, seq_len=TRAIN_T, steps=steps, init_s=init_s,
         losses=losses, grad_norms=[s.metrics["grad_norm"]
                                    for s in meter.history],
         step_times_s=times, median_step_s_after_2=statistics.median(
             times[2:]), tokens_per_s=summary["tokens_per_sec"],
         mfu=summary["mfu"], flops_per_step=meter.flops_per_step,
         max_memory_allocated_gb=peak_gb, launches=launches,
         dense_attention_calls=dense_calls[0],
         expected_step1_loss=expected)
    PHASE_8B.update(layers=mcfg.n_layers, tokens_per_s=summary[
        "tokens_per_sec"], median_step_s_after_2=statistics.median(
            times[2:]))
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite training loss: {losses}")
    # Step 1 at init: the final norm gives each position unit RMS and
    # lm_head's lecun-normal kernel has variance 1/d, so the logits are
    # ~N(0, 1) over the vocab and E[loss] ~ ln V + 1/2.
    if abs(losses[0] - expected) > 0.5:
        fail(f"step-1 loss {losses[0]:.4f}, expected {expected:.4f} +- 0.5")
    want = steps * mcfg.n_layers
    if any(n != want for n in launches.values()) or dense_calls[0]:
        fail(f"launches {launches} (expected {want} each), dense attention "
             f"ran {dense_calls[0]} times")

    batch = trainer.place(next(iter(make_source(cfg, trainer,
                                                start_step=state.step))))
    torch.cuda.synchronize()
    with profiled() as prof:
        state, m = trainer.step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    emit("where_time_goes_llama_1b_train", card=card, **kernel_split(
        torch, prof, list(launches)))
    del state, trainer, batch, prof
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- cross-entropy --

F32_FLOP_PER_S = 67e12     # f32 outside the tensor cores, NVIDIA's data sheet
# The LoRA slice's loss shape: llama_8b logits [2, 4096, 128256] in bf16,
# of which the causal loss reads logits[:, :-1] in place (N = 2 x 4095).
CE_B, CE_T, CE_V = 2, 4096, 128256
CE_CASES = [
    # name, (A, T) rows, V, dtype, strided view of [A, T + 1, V], g
    ("train_8b_view", (CE_B, CE_T - 1), CE_V, "bfloat16", True, "expanded"),
    ("ragged_v1000_n77", (1, 77), 1000, "bfloat16", False, "random"),
    ("odd_v_unaligned", (1, 50), 1001, "bfloat16", False, "expanded"),
    ("f32", (2, 40), 5000, "float32", True, "random"),
    ("outliers_full_v", (1, 64), CE_V, "bfloat16", False, "random"),
]


def ce_inputs(torch, g, rows, V, dtype, view, g_kind):
    """Logits ~ 4 N(0, 1); the first rows hold equal logits, a +80 and a -80
    outlier; labels at 0, V - 1, inside the last partial pass of K4's loop
    (it walks 8192 bf16 columns a pass, four 16-byte loads of 256 threads)
    and at random; g one value expanded with stride 0 (as .mean()'s
    backward gives it) or a random value a row."""
    A, T = rows
    dt = getattr(torch, dtype)
    full = 4 * torch.randn(A, T + int(view), V, generator=g, device="cuda")
    flat = full.view(-1, V)
    flat[0] = 1.5
    flat[1, 3] = 80.0
    flat[2, 5] = -80.0
    x = full.to(dt)
    x = x[:, :-1] if view else x
    labels = torch.randint(0, V, (A, T), generator=g, device="cuda")
    labels.view(-1)[:3] = torch.tensor([0, V - 1, V - 1 - (V % 8192) // 2])
    n = A * T
    if g_kind == "expanded":
        gg = torch.full((1, 1), 1.0 / n, device="cuda").expand(A, T)
    else:
        gg = torch.rand(A, T, generator=g, device="cuda") * (2.0 / n)
    return x, labels, gg


def ce_ratio(torch, err, limit) -> float:
    """The worst err / limit; where the limit is 0 only an exact 0 passes."""
    return torch.where(limit > 0, err / limit.clamp_min(1e-38),
                       torch.where(err > 0, math.inf, 0.0)).max().item()


def check_ce(torch, card):
    """Phase 6b: K4 and K5 against their plain versions in every case; the
    worst error / limit of each output. Then the check's teeth: at the 8B
    shape and the ragged one, a plain K5 that zeroes every column but the
    label's and a plain K4 that drops the last 256 vocab columns must fail
    the same limits."""
    from serverless_learn_tpu_torch.ops import cross_entropy as ce

    g = torch.Generator(device="cuda").manual_seed(7)
    worst = {"cross_entropy_fwd": 0.0, "cross_entropy_bwd": 0.0}
    worst_ratio = {"loss": 0.0, "lse": 0.0, "dx": 0.0}
    teeth = {}
    for name, rows, V, dtype, view, g_kind in CE_CASES:
        x, labels, gg = ce_inputs(torch, g, rows, V, dtype, view, g_kind)
        loss, lse = ce.cross_entropy_fwd(x, labels)
        dx = ce.cross_entropy_bwd(x, labels, lse, gg)
        torch.cuda.synchronize()
        ref_loss, ref_lse = ce.cross_entropy_fwd_reference(x, labels)
        ref_dx = ce.cross_entropy_bwd_reference(x, labels, ref_lse, gg)
        if dx.shape != x.shape or dx.dtype != x.dtype:
            fail(f"ce {name}: dx {tuple(dx.shape)} {dx.dtype}, expected "
                 f"{tuple(x.shape)} {x.dtype}")
        lim = ce.fwd_tolerance(ref_lse)
        dlim = ce.bwd_tolerance(ref_dx)
        errs, ratios = {}, {}
        for out_name, got, ref, limit in [("loss", loss, ref_loss, lim),
                                          ("lse", lse, ref_lse, lim),
                                          ("dx", dx, ref_dx, dlim)]:
            if not bool(torch.isfinite(got).all()):
                fail(f"ce {name}: non-finite {out_name}")
            err = (got.float() - ref.float()).abs()
            errs[out_name] = err.max().item()
            ratios[out_name] = ce_ratio(torch, err, limit)
            worst_ratio[out_name] = max(worst_ratio[out_name],
                                        ratios[out_name])
            if not ratios[out_name] <= 1:
                fail(f"ce {name}: {out_name} disagrees with plain: worst "
                     f"error / limit {ratios[out_name]:.4g}, max abs "
                     f"{errs[out_name]:.4g}")
        worst["cross_entropy_fwd"] = max(worst["cross_entropy_fwd"],
                                         errs["loss"], errs["lse"])
        worst["cross_entropy_bwd"] = max(worst["cross_entropy_bwd"],
                                         errs["dx"])
        if name in ("train_8b_view", "ragged_v1000_n77"):
            bad_dx = torch.zeros_like(ref_dx)
            bad_dx.scatter_(-1, labels.long()[..., None],
                            ref_dx.gather(-1, labels.long()[..., None]))
            _, bad_lse = ce.cross_entropy_fwd_reference(x[..., :-256],
                                                        labels)
            bad_loss = bad_lse - (ref_lse - ref_loss)  # the label still read
            teeth[name] = {
                "k5_zero_off_label_dx": ce_ratio(
                    torch, (bad_dx.float() - ref_dx.float()).abs(), dlim),
                "k4_drop_last_256_lse": ce_ratio(
                    torch, (bad_lse - ref_lse).abs(), lim),
                "k4_drop_last_256_loss": ce_ratio(
                    torch, (bad_loss - ref_loss).abs(), lim)}
            if not all(r > 1 for r in teeth[name].values()):
                fail(f"ce {name}: a planted fault passed the check: "
                     f"{teeth[name]}")
            del bad_dx, bad_lse, bad_loss
        emit("check_ce", card=card, case=name, rows=list(rows), vocab=V,
             dtype=dtype, strided_view=view, g=g_kind, max_abs_err=errs,
             worst_err_over_limit=ratios,
             max_abs_ref={"loss": ref_loss.abs().max().item(),
                          "dx": ref_dx.float().abs().max().item()})
        del x, labels, gg, loss, lse, dx, ref_loss, ref_lse, ref_dx
        torch.cuda.empty_cache()
    emit("check_ce_summary", card=card, cases=len(CE_CASES), worst=worst,
         worst_err_over_limit=worst_ratio,
         planted_faults_err_over_limit=teeth,
         tolerance="loss, lse: 2e-5 (|lse| + 1) (f32 sums of exps in "
         "another order); dx per element: bf16 2^-7 |ref| (one ulp: a flip "
         "at a power of two reads just under 1), f32 2e-5 |ref|, both + "
         "2^-10 of the row's median |ref| + 2^-126 "
         "(ops.cross_entropy.fwd_tolerance / bwd_tolerance)")
    return worst


def ce_bounds(N: int, V: int, esize: int = 2):
    """(ms, bound_by) of K4 and K5 over N rows of V: the bytes (K4 reads x,
    the labels and writes loss and lse; K5 reads x, labels, lse, g and
    writes dx) over 3.35 TB/s against the f32 operations (4 an element:
    max, subtract, exp, add; K5 subtract, exp, onehot, multiply) over the
    67 TFLOP/s outside the tensor cores."""
    out = {}
    for name, moved in (("cross_entropy_fwd", N * V * esize + 12 * N),
                        ("cross_entropy_bwd", 2 * N * V * esize + 12 * N)):
        bytes_s, ops_s = moved / HBM_BYTES_PER_S, 4 * N * V / F32_FLOP_PER_S
        out[name] = (max(bytes_s, ops_s) * 1e3,
                     "bytes" if bytes_s >= ops_s else "operations")
    return out


SMI_CLOCKS = ("clocks.sm,clocks.max.sm,temperature.gpu,power.draw,"
              "clocks_throttle_reasons.active")


class ClockSampler:
    """The card's SM clock, its maximum, temperature, power draw and active
    throttle reasons (a bit mask) through nvidia-smi, sampled every
    ``period`` seconds on a thread while the block runs."""

    def __init__(self, period: float = 0.2):
        self.period = period
        self.rows = []
        self._stop = threading.Event()

    @staticmethod
    def query():
        for fields in (SMI_CLOCKS, SMI_CLOCKS.replace(
                "clocks_throttle_reasons", "clocks_event_reasons")):
            out = subprocess.run(
                ["nvidia-smi", f"--query-gpu={fields}",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30)
            if out.returncode == 0 and out.stdout.strip():
                return [v.strip() for v in
                        out.stdout.strip().splitlines()[0].split(",")]
        return None

    def _run(self):
        while True:
            row = self.query()
            if row is not None:
                self.rows.append(row)
            if self._stop.wait(self.period):
                return

    def __enter__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)

    def summary(self) -> dict:
        def num(i):
            vals = []
            for r in self.rows:
                try:
                    vals.append(float(r[i]))
                except (ValueError, IndexError):
                    pass
            return ([min(vals), statistics.median(vals), max(vals)]
                    if vals else None)

        return {"samples": len(self.rows), "sm_mhz_min_median_max": num(0),
                "max_sm_mhz": num(1), "temperature_c_min_median_max": num(2),
                "power_w_min_median_max": num(3),
                "throttle_reasons_active": sorted({r[4] for r in self.rows
                                                   if len(r) > 4})}


def launch_ms(torch, fn, n: int = 25, warmup: int = 3) -> dict:
    """Each of ``n`` calls of ``fn(i)`` timed alone between its own CUDA
    events (back to back, so each is the call's device time): the median
    and quartiles in ms."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    gc.collect()
    gc.disable()
    try:
        for i, (a, b) in enumerate(evs):
            a.record()
            fn(i)
            b.record()
        torch.cuda.synchronize()
    finally:
        gc.enable()
    ms = [a.elapsed_time(b) for a, b in evs]
    q = statistics.quantiles(ms, n=4)
    return {"median": statistics.median(ms), "q1": q[0], "q3": q[2],
            "launches": n}


def time_ce(torch, card):
    """Phase 7b: K4 and K5 at the 8B loss shape (the strided view, as the
    main path reads it), beside their bounds, their plain versions and
    F.cross_entropy(x_bf16, labels, reduction="none") on a contiguous
    [N, V] copy: its forward for K4, its backward alone for K5. The kernels
    and the library call are each the median of 25 launches timed one by
    one, with the card's clocks sampled beside them."""
    from serverless_learn_tpu_torch.ops import cross_entropy as ce

    g = torch.Generator(device="cuda").manual_seed(8)
    x, labels, gg = ce_inputs(torch, g, (CE_B, CE_T - 1), CE_V, "bfloat16",
                              True, "expanded")
    loss, lse = ce.cross_entropy_fwd(x, labels)
    N = CE_B * (CE_T - 1)
    F = torch.nn.functional
    x2, lab2 = x.reshape(N, CE_V), labels.reshape(N).long()
    xg = x2.detach().requires_grad_()
    lo = F.cross_entropy(xg, lab2, reduction="none")
    gv = gg.reshape(N).to(lo.dtype)
    with ClockSampler() as clocks:
        per = {"cross_entropy_fwd": launch_ms(
                   torch, lambda i: ce.cross_entropy_fwd(x, labels)),
               "cross_entropy_bwd": launch_ms(
                   torch, lambda i: ce.cross_entropy_bwd(x, labels, lse,
                                                         gg))}
        lib = {"cross_entropy_fwd": launch_ms(
                   torch, lambda i: F.cross_entropy(x2, lab2,
                                                    reduction="none")),
               "cross_entropy_bwd": launch_ms(
                   torch, lambda i: torch.autograd.grad(
                       lo, xg, gv, retain_graph=True))}
    ms = {k: v["median"] for k, v in per.items()}
    emit("time_ce_clocks", card=card, kernels=per, library=lib,
         clocks=clocks.summary(), fields=SMI_CLOCKS)
    plain = {"cross_entropy_fwd": time_ms(
                 torch, lambda i: ce.cross_entropy_fwd_reference(x, labels),
                 3, warmup=1),
             "cross_entropy_bwd": time_ms(
                 torch, lambda i: ce.cross_entropy_bwd_reference(
                     x, labels, lse, gg), 3, warmup=1)}
    torch.cuda.empty_cache()
    library = {k: v["median"] for k, v in lib.items()}
    rows = {}
    for name, (b_ms, by) in ce_bounds(N, CE_V).items():
        rows[name] = dict(ms=ms[name], plain_ms=plain[name], bound_ms=b_ms,
                          bound_by=by, fraction_of_bound=b_ms / ms[name],
                          library_ms=library[name])
        emit("time_ce", card=card, kernel=name, rows=N, vocab=CE_V,
             dtype="bfloat16", **rows[name])
    emit("time_ce_library", card=card,
         library_call="torch.nn.functional.cross_entropy(x_bf16 [N, V], "
                      "labels, reduction='none'): forward for K4, its "
                      "backward alone (autograd.grad with retain_graph) "
                      "for K5; timed here only, never called by the port",
         timing="median of 25 launches, each between its own CUDA events")
    del x, x2, xg, lo, labels, gg, loss, lse
    torch.cuda.empty_cache()
    return rows


def lora_tiny_config():
    import dataclasses

    cfg = tiny_train_config()
    return dataclasses.replace(
        cfg, model_overrides={"attention_impl": "flash", "lora_rank": 4,
                              "fused_ce": True},
        optimizer=dataclasses.replace(cfg.optimizer, warmup_steps=0))


def train_tiny_lora_agreement(torch, card):
    """Phase 8c: llama_tiny (f32) with rank-4 LoRA and the fused loss, three
    adamw steps without warmup, on the card (K1-K5) and on the CPU (the
    plain versions) from the same weights and batches."""
    from serverless_learn_tpu_torch.models.llama import lora_trainable_mask
    from serverless_learn_tpu_torch.ops import cross_entropy as ce
    from serverless_learn_tpu_torch.training.loop import make_source
    from serverless_learn_tpu_torch.training.train_step import build_trainer

    cfg = lora_tiny_config()
    cpu = build_trainer(cfg, "cpu")
    gpu = build_trainer(cfg, "cuda")
    cpu_state = cpu.init()
    gpu_state = gpu.init(params=cpu_state.model.state_dict())

    def run(trainer, state):
        losses = []
        for _, host in zip(range(cfg.train.num_steps),
                           make_source(cfg, trainer)):
            state, m = trainer.step(state, trainer.place(host))
            losses.append(float(m["loss"]))
        return losses, {k: v.detach().cpu()
                        for k, v in state.model.state_dict().items()}

    lc, pc = run(cpu, cpu_state)
    before = (ce.cross_entropy_fwd.launches, ce.cross_entropy_bwd.launches)
    lg, pg = run(gpu, gpu_state)
    n = (ce.cross_entropy_fwd.launches - before[0],
         ce.cross_entropy_bwd.launches - before[1])
    mask = lora_trainable_mask(pc)
    loss_err = max(abs(a - b) for a, b in zip(lc, lg))
    lora_err = max((pc[k] - pg[k]).abs().max().item() for k in pc if mask[k])
    frozen_same = all(torch.equal(pc[k], pg[k]) for k in pc if not mask[k])
    emit("train_tiny_lora_agreement", card=card, steps=len(lc),
         cpu_losses=lc, card_losses=lg, max_loss_diff=loss_err,
         max_lora_param_diff=lora_err, frozen_base_equal=frozen_same,
         ce_launches=list(n),
         tolerance="losses within 1e-4, LoRA params within 2e-5 (f32 on "
                   "both sides, sums in other orders; adam moves every "
                   "weight by up to lr = 1e-3 a step); the frozen base equal")
    if n != (cfg.train.num_steps, cfg.train.num_steps):
        fail(f"tiny LoRA training launched K4/K5 {n} times, expected "
             f"{cfg.train.num_steps} each")
    if not (loss_err <= 1e-4 and lora_err <= 2e-5 and frozen_same):
        fail(f"tiny LoRA training: card vs cpu losses differ by "
             f"{loss_err:.3g}, LoRA params by {lora_err:.3g}, frozen base "
             f"equal {frozen_same}")


# The one-card cut of configs/llama8b_lora_elastic.json, as a user types it.
LORA_8B_ARGS = [
    "train", "--model", "llama_8b",
    "--set", "model_overrides.lora_rank=16",
    "--set", "model_overrides.remat=true",
    "--set", "model_overrides.fused_ce=true",
    "--batch-size", "8", "--set", "train.grad_accum=4", "--seq-len", "4096",
    "--lr", "2e-4", "--set", "optimizer.warmup_steps=100",
    "--set", "optimizer.decay_steps=10000",
    "--set", "optimizer.grad_clip_norm=1.0", "--steps", "3"]
LORA_8B_ADAPTER_TENSORS, LORA_8B_ADAPTER_PARAMS = 128, 6_815_744
FULL_COPIES = ("layer_0.attn.q_proj.kernel", "layer_31.mlp.down_proj.kernel",
               "norm_f.scale")


def checksums(torch, model, names):
    """Per tensor, in float64: (sum, sum of squares)."""
    params = dict(model.named_parameters())
    out = {}
    for n in names:
        d = params[n].detach().double()
        out[n] = (d.sum().item(), d.square().sum().item())
        del d
    return out


def kernel_split(torch, prof, names):
    """The profile's device time: busy and idle share, the named kernels,
    cuBLAS's products and the rest, and the top kernels."""
    span, busy, _, by_name, kern = device_time(torch, prof, "")
    # a wrapper's kernels: <name>_kernel (CUDA cores), <name>_bf16 (the
    # flash forward on mma.sync), <name>_wgmma (the flash dq and dk/dv)
    ours = {n: sum(v for k, v in by_name.items()
                   if any(f"{n}_{kind}" in k
                          for kind in ("kernel", "bf16", "wgmma"))) / 1e3
            for n in names}
    # cuBLAS's products: its Hopper kernels are named nvjet_* or *gemm*.
    matmul = sum(v for k, v in by_name.items()
                 if "nvjet" in k or "gemm" in k) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(step_span_ms=span / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1 - busy / span, kernels_ms=ours,
                kernels_share_of_busy=sum(ours.values()) * 1e3 / busy,
                cublas_matmul_ms=matmul,
                other_kernels_ms=busy / 1e3 - matmul - sum(ours.values()),
                device_kernels=len(kern),
                top_kernels_ms=[(k[:90], v / 1e3) for k, v in top])


def train_lora_8b(torch, card):
    """Phase 8d: full-depth llama_8b with rank-16 LoRA on q/v, remat and the
    fused loss, batch 8 x 4096 in 4 microbatches, 3 adamw steps (the config's
    lr, warmup, decay and clip) through run_training; counters read around
    the run. Then 8e: one batch-2 microbatch's forward + backward with the
    fused loss and with the unfused one from the same state; 8f: one
    batch-2 fused step under torch.profiler."""
    import dataclasses

    from serverless_learn_tpu_torch.cli import _train_config, build_parser
    from serverless_learn_tpu_torch.models import transformer
    from serverless_learn_tpu_torch.models.llama import lm_bundle
    from serverless_learn_tpu_torch.ops import attention, losses
    from serverless_learn_tpu_torch.ops import cross_entropy as ce
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.training.loop import (make_source,
                                                          run_training)
    from serverless_learn_tpu_torch.training.train_step import (Trainer,
                                                                build_trainer)

    cfg = _train_config(build_parser().parse_args(LORA_8B_ARGS))
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, "cuda")
    state = trainer.init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    mcfg, model = trainer.bundle.cfg, state.model
    named = dict(model.named_parameters())
    frozen = [n for n, p in named.items() if not p.requires_grad]
    adapters = [n for n, p in named.items() if p.requires_grad]
    sums_before = checksums(torch, model, frozen)
    copies = {n: named[n].detach().cpu().clone() for n in FULL_COPIES}

    counts = {"dense_attention": 0, "unfused_loss": 0}
    real_dense, real_ce = attention.xla_attention, losses.F.cross_entropy

    def counting(key, fn):
        def wrapped(*a, **kw):
            counts[key] += 1
            return fn(*a, **kw)
        return wrapped

    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv, ce.cross_entropy_fwd,
               ce.cross_entropy_bwd)
    torch.cuda.reset_peak_memory_stats()
    attention.xla_attention = transformer.xla_attention = counting(
        "dense_attention", real_dense)
    losses.F.cross_entropy = counting("unfused_loss", real_ce)
    for k in kernels:
        k.launches = 0
    try:
        state, meter = run_training(cfg, trainer=trainer, state=state)
    finally:
        attention.xla_attention = transformer.xla_attention = real_dense
        losses.F.cross_entropy = real_ce
    launches = {k.__name__: k.launches for k in kernels}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses_ = [s.metrics["loss"] for s in meter.history]
    norms = [s.metrics["grad_norm"] for s in meter.history]
    times = [s.step_time_s for s in meter.history]
    summary = meter.steady_state(skip=1)
    sums_after = checksums(torch, model, frozen)
    changed = [n for n in frozen if sums_after[n] != sums_before[n]]
    changed += [n for n in FULL_COPIES
                if not torch.equal(named[n].detach().cpu(), copies[n])]
    opt = state.opt_state
    opt_tensors = {m: len(opt[m]) for m in ("mu", "nu")}
    opt_params = {m: sum(t.numel() for t in opt[m]) for m in ("mu", "nu")}
    micro = cfg.train.num_steps * cfg.train.grad_accum
    want = {"flash_fwd": 2 * mcfg.n_layers * micro,  # remat: twice a layer
            "flash_dq": mcfg.n_layers * micro,
            "flash_dkv": mcfg.n_layers * micro,
            "cross_entropy_fwd": micro, "cross_entropy_bwd": micro}
    expected = math.log(mcfg.vocab_size) + 0.5
    emit("train_llama_8b_lora", card=card, command=LORA_8B_ARGS,
         layers=mcfg.n_layers, d_model=mcfg.d_model, vocab=mcfg.vocab_size,
         lora_rank=mcfg.lora_rank, params=sum(p.numel()
                                              for p in named.values()),
         adapter_tensors=len(adapters),
         adapter_params=sum(named[n].numel() for n in adapters),
         batch=cfg.train.batch_size, grad_accum=cfg.train.grad_accum,
         seq_len=cfg.data.seq_len, steps=cfg.train.num_steps, init_s=init_s,
         losses=losses_, grad_norms=norms,
         lrs=[s.metrics["lr"] for s in meter.history], step_times_s=times,
         mean_step_s_after_1=summary["step_time_s"],
         tokens_per_s=summary["tokens_per_sec"], mfu=summary["mfu"],
         model_flops_per_step=meter.flops_per_step,
         max_memory_allocated_gb=peak_gb, launches=launches,
         expected_launches=want, calls=counts,
         frozen_tensors=len(frozen), frozen_changed=changed,
         optimizer_state_tensors=opt_tensors,
         optimizer_state_params=opt_params, expected_step1_loss=expected)
    if not all(math.isfinite(x) for x in losses_ + norms):
        fail(f"non-finite loss or grad norm: {losses_}, {norms}")
    # lora_b starts at zero, so the model at init is the base: as phase 8b,
    # logits ~N(0, 1) over the vocab and E[loss] ~ ln V + 1/2.
    if abs(losses_[0] - expected) > 0.5:
        fail(f"step-1 loss {losses_[0]:.4f}, expected {expected:.4f} +- 0.5")
    if launches != want or any(counts.values()):
        fail(f"launches {launches} (expected {want}); dense attention and "
             f"the unfused loss ran {counts}")
    if changed:
        fail(f"{len(changed)} frozen tensors changed, e.g. {changed[:3]}")
    if (set(opt_tensors.values()) != {LORA_8B_ADAPTER_TENSORS}
            or set(opt_params.values()) != {LORA_8B_ADAPTER_PARAMS}):
        fail(f"optimizer state {opt_tensors} tensors, {opt_params} params; "
             f"expected {LORA_8B_ADAPTER_TENSORS} adapter tensors of "
             f"{LORA_8B_ADAPTER_PARAMS} params")
    if not all(n > 0 for n in norms):
        fail(f"zero grad norm: {norms}")
    del sums_before, sums_after, copies

    # 8e: fused against unfused, one batch-2 microbatch from this state,
    # each twice in turns; a fifth run scales the fused loss by 1 + 2^-16,
    # which changes no gradient but for bf16 rounding: their noise floor.
    batch = trainer.place(next(iter(make_source(
        dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=2)), trainer, start_step=state.step))))
    bundles = {True: trainer.bundle, False: lm_bundle(mcfg, fused_ce=False)}
    lora = [named[n] for n in adapters]
    scaled = 1 + 2 ** -16
    runs = []
    for fused, scale in ((False, 1.0), (True, 1.0), (True, 1.0),
                         (False, 1.0), (True, scaled)):
        for p in lora:
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss, _ = bundles[fused].loss_fn(model, batch)
        (loss * scale).backward()
        value = float(loss.detach())
        torch.cuda.synchronize()
        runs.append(dict(
            s=time.perf_counter() - t, loss=value,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            grads=[p.grad.detach().float() / scale for p in lora]))
    for p in lora:
        p.grad = None
    u0, f0, f1, u1, fs = runs

    def rel(a, b):
        return [((x - y).norm() / y.norm().clamp_min(1e-30)).item()
                for x, y in zip(a["grads"], b["grads"])]

    loss_rel = abs(f0["loss"] - u0["loss"]) / abs(u0["loss"])
    grad_rel, floor = rel(f0, u0), rel(fs, f0)
    worst = sorted(zip(grad_rel, floor, adapters), reverse=True)[:3]
    emit("fused_vs_unfused_llama_8b_lora", card=card, batch=2,
         seq_len=cfg.data.seq_len, fused_s=[f0["s"], f1["s"]],
         unfused_s=[u0["s"], u1["s"]],
         fused_peak_gb=max(f0["peak_gb"], f1["peak_gb"]),
         unfused_peak_gb=max(u0["peak_gb"], u1["peak_gb"]),
         fused_loss=f0["loss"], unfused_loss=u0["loss"],
         loss_rel_diff=loss_rel, max_grad_rel_diff=max(grad_rel),
         median_grad_rel_diff=statistics.median(grad_rel),
         noise_floor_max=max(floor),
         noise_floor_median=statistics.median(floor),
         repeat_max_grad_rel_diff=max(rel(f1, f0) + rel(u1, u0)),
         worst_tensors=worst,
         min_adapter_grad_norm=min(g.norm().item() for g in u0["grads"]),
         tolerance="loss 1e-5 relative (f32 from the same bf16 logits); "
                   "each adapter's gradient within 2^-5 of its norm: the "
                   "two bf16 dlogits differ by an ulp in a few elements, "
                   "and 32 layers of bf16 backward round such a "
                   "difference up to the bf16 noise floor (2^-8 an "
                   "element), measured by the run whose loss is scaled by "
                   "1 + 2^-16")
    if not (loss_rel <= 1e-5 and max(grad_rel) <= 2 ** -5):
        fail(f"fused vs unfused: loss {loss_rel:.3g} relative, worst "
             f"adapter gradient {max(grad_rel):.3g}")
    del runs, u0, f0, f1, u1, fs

    # 8f: one batch-2 fused step (forward, backward, update) profiled.
    one = Trainer(config=dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=2, grad_accum=1)), bundle=trainer.bundle,
        device=trainer.device, optimizer=trainer.optimizer)
    torch.cuda.synchronize()
    with profiled() as prof:
        state, m = one.step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    emit("where_time_goes_llama_8b_lora_train", card=card, batch=2,
         seq_len=cfg.data.seq_len, **kernel_split(
             torch, prof, [k.__name__ for k in kernels]))
    del state, trainer, one, batch, prof, model, named, lora
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- checkpoints --

# llama_1b projections: (I, O) -> (sites, launches per forward); 16 layers,
# 7 projections each and lm_head: 113 a forward.
LLAMA1B_SHAPES = {
    (2048, 2048): ("q_proj, o_proj", 32),
    (2048, 512): ("k_proj, v_proj", 32),
    (2048, 8192): ("gate_proj, up_proj", 32),
    (8192, 2048): ("down_proj", 16),
    (2048, 128256): ("lm_head", 1),
}
GEN_NEW, DRAFT_LAYERS, SPEC_K = 16, 4, 4
GEN_PROMPT_LEN = 8  # generate's --prompt-len default
# Phase 10e's two requests: one prefill chunk of 16 and one of 32 tokens.
SERVE_1B_PROMPTS = (16, 32)
# Rows K6 is checked at for llama_1b: phase 10 serves generate's prefill (1
# x 8) and decode (1), the verify pass (1 x (K + 1) = 5), and the
# continuous engine's decode buckets and prefill chunks, as phase 9c's
# (CHECK_ROWS).
CHECK_ROWS_1B = tuple(sorted(set(CHECK_ROWS) | {GEN_PROMPT_LEN, SPEC_K + 1}))
# The config of phase 10's train and eval (eval restores the whole state,
# whose optimizer layout is the config's: adamw with clip).
CKPT_TRAIN = ["--model", "llama_1b", "--batch-size", str(TRAIN_B),
              "--seq-len", str(TRAIN_T), "--set",
              "optimizer.grad_clip_norm=1.0"]
# Phase 10's depth: llama_1b at full width and 6 of its 16 layers (16 before
# the model families' phase 16: the run's time limit; the A/B modes that
# take CKPT_TRAIN keep 16). More than DRAFT_LAYERS, so the draft is a
# prefix.
CKPT_LAYERS = 6
CKPT_DEPTH = ["--set", f"model_overrides.n_layers={CKPT_LAYERS}"]
CKPT_FREE_BYTES = 40e9  # two 10.7 GB blobs on disk while GC catches up
# Phase 10's train: an in-loop eval every 2 steps (of train.eval_steps'
# default 10 batches), and the emergency shadow refreshed at every step
# boundary at least 1 s apart (the default 30 s would refresh it once in
# 3 steps; every refresh's stall is printed).
CKPT_EVAL_EVERY = 2
EVAL_STEPS_DEFAULT = 10
CKPT_SHADOW_INTERVAL_S = 1
# The health engine runs at its defaults: its step watchdog fires when no
# step lands in 5x the typical interval (at least 1 s), less the time the
# loop spent in the checkpoint and eval phases. Phase 10's step boundaries
# hold the loop for a 10.7 GB shadow refresh and a save (up to ~10 s), so
# the phase checks that no alert fires through them.
CRC_SAMPLE = 2 << 30  # bytes of the blob whose CRC phase 10b times twice


def checkpoint_dir(free_bytes=CKPT_FREE_BYTES, prefix="slt-phase10-"):
    """A fresh directory for a phase's checkpoints: under the temporary
    directory where its disk has ``free_bytes`` free (phase 10: two
    blobs), else beside this script."""
    import os
    import shutil
    import tempfile

    for base in (tempfile.gettempdir(),
                 os.path.dirname(os.path.abspath(__file__))):
        if shutil.disk_usage(base).free >= free_bytes:
            return tempfile.mkdtemp(prefix=prefix, dir=base)
    fail(f"no disk with {free_bytes / 1e9:.0f} GB free for {prefix}")


class Patched:
    """Within the block, ``obj.name`` is ``wrap(obj.name)``: phase 10 keeps
    what the CLI builds (the state, the checkpointer, the model, the
    server) by wrapping the names the CLI looks up when it runs."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name, _ in self.triples]
        for obj, name, wrap in self.triples:
            setattr(obj, name, wrap(getattr(obj, name)))

    def __exit__(self, *exc):
        for obj, name, real in self.saved:
            setattr(obj, name, real)


def prom_value(text, name):
    """A series' value in a Prometheus scrape (the unlabelled one)."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    return None


def train_telemetry(done, reg, steps_before, scrapes, events_path):
    """Phase 10's telemetry checks of the ``train`` command (module doc):
    the step counter, the last-step gauge, the MFU gauge, the ledger's
    phases and goodput, no alert, /healthz, the spans of the event log,
    and each emergency-shadow refresh's stall."""
    from serverless_learn_tpu_torch.telemetry import goodput

    faults = []
    steps = reg.counter("slt_train_steps_total").value - steps_before
    if steps != 3:
        faults.append(f"slt_train_steps_total rose by {steps}, not 3")
    last = [prom_value(r["/metrics"][1], "slt_train_last_step_unix_s")
            for r in scrapes if r.get("/metrics")]
    last = [v for v in last if v]
    if len(set(last)) < 2 or last != sorted(last):
        faults.append(f"the last-step gauge did not advance: {last}")
    mfu = reg.gauge("slt_train_mfu").value
    if abs(mfu - done["mfu"]) > 5e-4:  # the done line rounds to 3 places
        faults.append(f"slt_train_mfu {mfu} vs the done line's "
                      f"{done['mfu']}")
    good = [json.loads(r["/goodput"][1]) for r in scrapes
            if r.get("/goodput") and r["/goodput"][0] == 200]
    ledger = goodput.get_ledger().report(mfu=mfu)
    phases = set(ledger["phases"])
    if not {"compile", "step", "checkpoint", "eval"} <= phases:
        faults.append(f"the ledger's phases are {sorted(phases)}")
    if not 0 < done["goodput"] <= 1:
        faults.append(f"goodput {done['goodput']}")
    fired = [a for r in scrapes if r.get("/alerts")
             for a in json.loads(r["/alerts"][1]).get("firing", [])]
    if fired:
        faults.append(f"alerts fired: {fired[:3]}")
    health = [r["/healthz"][0] for r in scrapes if r.get("/healthz")]
    if not health or set(health) != {200}:
        faults.append(f"/healthz answered {sorted(set(health))}")
    events = read_events(events_path)
    spans = [r["span"] for r in events if r.get("event") == "span"]
    if spans.count("train/run") != 1 or spans.count("train/step") != 3:
        faults.append(f"the event log's spans: {spans}")
    shadows = [r for r in events if r.get("event") == "ckpt_shadow"]
    if not shadows:
        faults.append("no emergency-shadow refresh")
    # Where the unattributed time sits: the gaps between the phase
    # records (those of 50 ms or more) that the event log holds.
    phases = sorted((r["t0_unix_s"], r["t0_unix_s"] + r["duration_s"],
                     r["phase"]) for r in events if r.get("event") == "phase")
    gaps = sorted(((b[0] - a[1], a[2], b[2]) for a, b in
                   zip(phases, phases[1:]) if b[0] > a[1]), reverse=True)
    if faults:
        fail("phase 10 telemetry: " + "; ".join(faults))
    return dict(
        steps_counted=steps, scrapes=len(scrapes),
        endpoints_scraped=sorted({k for r in scrapes for k in r
                                  if k.startswith("/") and r[k]}),
        last_step_gauge_values=len(set(last)), mfu_gauge=mfu,
        done_mfu=done["mfu"], goodput=done["goodput"],
        badput_breakdown=done["badput_breakdown"],
        ledger_phases={k: v["seconds"] for k, v in
                       ledger["phases"].items()},
        goodput_scrapes=len(good), healthz=sorted(set(health)),
        alerts_fired=len(fired), spans=dict(
            (n, spans.count(n)) for n in sorted(set(spans))),
        done_spans=done.get("spans"),
        shadow_refreshes=[(r["step"], r["seconds"]) for r in shadows],
        phase_records=[(round(b - a, 3), n) for a, b, n in phases],
        largest_gaps_s=[(round(g, 3), a, b) for g, a, b in gaps[:4]])


def run_cli(argv):
    """``cli.main(argv)`` in this process; its last stdout line as JSON."""
    import contextlib
    import io

    from serverless_learn_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"{argv[0]} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def gbps(nbytes, seconds):
    return nbytes / seconds / 1e9 if seconds else None


def same_bits(torch, a, b) -> bool:
    """Bit-for-bit equality (a float's bits, not its value: -0.0 and NaN
    compare as what they are)."""
    ints = {4: torch.int32, 2: torch.int16, 1: torch.int8, 8: torch.int64}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(ints[a.element_size()]), b.view(ints[b.element_size()])
    return torch.equal(a, b)


def verify_logits(torch, model, prompt, tokens, K):
    """[N, V] f32: the logits that chose each of ``tokens`` after
    ``prompt``, on the verify pass's path: the prompt prefilled, then the
    tokens fed K+1 at a time by ``extend``, as speculative_generate's
    target takes them."""
    from serverless_learn_tpu_torch.inference.generate import init_cache

    with torch.inference_mode():
        cache = init_cache(model, 1)
        p = torch.tensor([prompt], dtype=torch.int32, device="cuda")
        steps = [model(p, cache=cache, prefill=True)[:, -1]]
        fed = torch.tensor([tokens], dtype=torch.int32, device="cuda")
        for s in range(0, len(tokens) - 1, K + 1):
            steps.append(model(fed[:, s:s + K + 1], cache=cache,
                               extend=True)[0])
    return torch.cat(steps, 0)[:len(tokens)].float()


def hold_to_greedy(torch, model, prompt, reply, others):
    """A reply's tokens held to plain greedy decode: the greedy path
    (prefill, then one decode step a token) fed the reply's own tokens;
    at every step the reply's token must lie within ``tol`` of that
    step's largest logit, ``tol`` the largest logit difference measured
    between the greedy path and each of ``others`` (the logits of the
    paths that made the reply, [N, V] each) over the same tokens. Returns
    (equal to greedy, worst gap, tol)."""
    greedy = forced_logits(torch, model, [prompt], [reply])[0]
    tol = max((greedy - o).abs().max().item() for o in others)
    chosen = greedy.gather(1, torch.tensor(reply, device="cuda")[:, None])
    gaps = greedy.max(-1).values - chosen[:, 0]
    return bool((gaps == 0).all()), gaps.max().item(), tol


def checkpoint_path(torch, card):
    """Phase 10: the user path from training to serving through checkpoints
    in the JAX package's format, through the CLI's entry points in this
    process, at llama_1b's full width.

    a. ``train`` 3 steps (B=2, T=4096, adamw + clip) saving every 2 steps
       (step 2 uploads while step 3 trains) and at the end, keep 1;
    b. the newest checkpoint restored into a fresh trainer, in place, and
       held to the live final state bit for bit; ``restore_params_host``;
    c. ``eval`` from the checkpoint, held to the live model's eval on the
       same batches (bit for bit: same kernels, same order);
    d. ``generate --quant int8`` greedy, then ``--draft-layers 4 --spec-k
       4``, and speculative_generate with the model as its own draft; each
       speculative reply held to greedy decode, all three timed;
    e. ``serve`` (the continuous engine) answers two requests, each reply
       held to greedy decode as in phase 9c.

    Every kernel's launch count is zeroed before each CLI command and read
    after it; the launches that check or time a result against the CLI's
    (the live model's eval, the self-draft, the timed generations) fall
    outside those windows. A graph replay passes no wrapper: the serve
    engine's replays are counted from one traced step of each bucket.

    The directory goes at the end. Returns the phase's kernel launches:
    the wrappers' counts ({name: n}) and the traced replays of K6."""
    import os
    import shutil
    import zlib

    from urllib.error import HTTPError
    from urllib.request import urlopen

    from serverless_learn_tpu_torch import cli
    from serverless_learn_tpu_torch.inference import server as server_mod
    from serverless_learn_tpu_torch.inference import speculative
    from serverless_learn_tpu_torch.inference.generate import generate
    from serverless_learn_tpu_torch.inference.server import request
    from serverless_learn_tpu_torch.ops import cross_entropy as ce
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.ops.quant_matmul import quant_matmul
    from serverless_learn_tpu_torch.telemetry import goodput, tracing
    from serverless_learn_tpu_torch.telemetry.registry import get_registry
    from serverless_learn_tpu_torch.training import checkpoint as ckpt_mod
    from serverless_learn_tpu_torch.training import loop
    from serverless_learn_tpu_torch.training.train_step import build_trainer
    from serverless_learn_tpu_torch.utils.serialization import (
        leaves_with_paths)

    t_phase = time.perf_counter()
    root = checkpoint_dir()
    kept, committed = {}, []
    wrappers = {k.__name__: k for k in (
        fa.flash_fwd, fa.flash_dq, fa.flash_dkv, ce.cross_entropy_fwd,
        ce.cross_entropy_bwd, quant_matmul)}
    total = dict.fromkeys(wrappers, 0)

    def zero():
        for k in wrappers.values():
            k.launches = 0

    def read():
        """The launches since ``zero``, added to the phase's total."""
        n = {name: k.launches for name, k in wrappers.items()}
        for name, v in n.items():
            total[name] += v
        return n

    def expect(what, n, **want):
        """Fails unless ``n`` has ``want``'s counts, and 0 elsewhere."""
        want = {name: want.get(name, 0) for name in n}
        if n != want:
            fail(f"{what} launched {n}, expected {want}")
    try:
        # -- a. train, saving asynchronously ------------------------------
        def keep_run(real):
            def run(cfg, trainer=None, **kw):
                state, meter = real(cfg, trainer=trainer, **kw)
                kept.update(cfg=cfg, trainer=trainer, state=state)
                return state, meter
            return run

        def keep_ckpt(real):
            class Kept(real):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    kept["ckpt"] = self

                def _put_blob(self, step, blob, **kw):
                    super()._put_blob(step, blob, **kw)
                    committed.append(step)
            return Kept

        def keep_as(key):
            def wrap(real):
                def start(*a, **k):
                    kept[key] = real(*a, **k)
                    return kept[key]
                return start
            return wrap

        # The telemetry: a fresh process ledger and tracing sink for this
        # command; a thread scrapes the endpoints while it trains.
        tel = os.path.join(root, "telemetry")
        events_path = os.path.join(tel, "events.jsonl")
        os.makedirs(tel)
        watched = step_watch_ledger(torch)
        goodput.set_ledger(watched)
        mem_before = host_memory_gb()
        cuda_before = (torch.cuda.memory_allocated() / 1e9,
                       torch.cuda.memory_reserved() / 1e9)
        reg = get_registry()
        steps_before = reg.counter("slt_train_steps_total").value
        scrapes, scraping = [], threading.Event()

        def scrape():
            while not scraping.wait(0.25):
                exp = kept.get("exporter")
                if exp is None:
                    continue
                row = {"t": time.time()}
                for path in ("/metrics", "/goodput", "/alerts", "/healthz"):
                    try:
                        with urlopen(f"http://{exp.addr}{path}",
                                     timeout=10) as r:
                            row[path] = (r.status, r.read().decode())
                    except HTTPError as e:
                        row[path] = (e.code, e.read().decode())
                    except OSError:
                        row[path] = None  # the exporter stopped
                scrapes.append(row)

        scraper = threading.Thread(target=scrape, daemon=True)
        scraper.start()
        zero()
        t0 = time.perf_counter()
        try:
            with Patched((loop, "run_training", keep_run),
                         (ckpt_mod, "Checkpointer", keep_ckpt),
                         (cli, "_start_metrics", keep_as("exporter")),
                         (cli, "_start_health", keep_as("health"))):
                done = run_cli([
                    "train", *CKPT_TRAIN, *CKPT_DEPTH, "--steps", "3",
                    "--checkpoint-every", "2", "--set", "checkpoint.keep=1",
                    "--checkpoint-dir", root, "--metrics-port", "0",
                    "--health", "--events-log", events_path, "--flight-dir",
                    tel, "--set", f"train.eval_every={CKPT_EVAL_EVERY}",
                    "--set", "checkpoint.emergency_min_interval_s="
                    f"{CKPT_SHADOW_INTERVAL_S}"])
        finally:
            scraping.set()
            scraper.join(timeout=30)
            tracing.reset_tracing()  # later phases write no events here
        train_s = time.perf_counter() - t0
        train_launches = read()
        watched.close()
        emit("checkpoint_train_steps", card=card,
             host_mem_avail_rss_gb_before=mem_before,
             cuda_allocated_reserved_gb_before=cuda_before, steps=watched.steps)
        telemetry = train_telemetry(done, reg, steps_before, scrapes,
                                    events_path)
        trainer, state, cfg = kept["trainer"], kept["state"], kept["cfg"]
        n_params = sum(p.numel() for p in state.model.parameters())
        listing = sorted(os.listdir(os.path.join(root, "ckpt")))
        blob = os.path.join(root, "ckpt", "step-0000000003")
        timings = dict(kept["ckpt"].timings)
        emit("checkpoint_train", card=card, model="llama_1b",
             params=n_params, steps=done["final_step"],
             losses=done["losses"], train_command_s=train_s,
             committed_steps=committed, files=listing,
             blob_bytes=os.path.getsize(blob),
             state_bytes=12 * n_params, launches=train_launches,
             save_sync_s=timings["save_sync_s"],
             save_sync_gb_per_s=gbps(timings["save_bytes"],
                                     timings["save_sync_s"]),
             upload_s=timings["upload_s"],
             upload_gb_per_s=gbps(timings["save_bytes"],
                                  timings["upload_s"]),
             crc_s=timings["crc_s"],
             crc_gb_per_s=gbps(timings["save_bytes"], timings["crc_s"]),
             telemetry=telemetry)
        if done["final_step"] != 3 or committed != [2, 3]:
            fail(f"train: final step {done['final_step']}, committed "
                 f"{committed} (expected 3 and [2, 3])")
        if listing != ["LATEST", "step-0000000003",
                       "step-0000000003.manifest"]:
            fail(f"keep=1 should leave step 3 alone: {listing}")
        if os.path.getsize(blob) < 12 * n_params:
            fail(f"blob of {os.path.getsize(blob)} B holds less than the "
                 f"state's {12 * n_params} B")
        # 3 steps x CKPT_LAYERS, and the forward of the in-loop eval's
        # batches (default train.eval_steps) x CKPT_LAYERS; fused_ce is off
        # for llama_1b, so no CE.
        loop_k1 = CKPT_LAYERS * EVAL_STEPS_DEFAULT * (3 // CKPT_EVAL_EVERY)
        step_k = 3 * CKPT_LAYERS
        expect("train", train_launches, flash_fwd=step_k + loop_k1,
               flash_dq=step_k, flash_dkv=step_k)

        # -- b. restore in place, bit for bit -----------------------------
        fresh = build_trainer(cfg, "cuda")
        rstate = fresh.init(seed=1)
        ck = ckpt_mod.Checkpointer(ckpt_mod.LocalStore(root))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = fresh.state_tree(rstate)
        ck.restore(tree)
        fresh.load_tree(rstate, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        restore = dict(ck.timings)
        live = list(leaves_with_paths(trainer.state_tree(state)))
        back = list(leaves_with_paths(fresh.state_tree(rstate)))
        differ = [p for (p, a), (q, b) in zip(live, back)
                  if p != q or not same_bits(torch, a, b)]
        if (differ or len(live) != len(back) or rstate.step != state.step
                or rstate.opt_state["count"] != state.opt_state["count"]):
            fail(f"restored state differs from the live one: {differ[:5]}, "
                 f"step {rstate.step} vs {state.step}")
        del tree, back, rstate, fresh
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = ck.restore_params_host()
        params_s = time.perf_counter() - t0
        params_bytes = sum(t.numel() * t.element_size()
                           for _, t in leaves_with_paths(params))
        del params
        # The blob's first CRC_SAMPLE bytes summed by one zlib.crc32 call
        # and by the checkpointer's CRC (parts on threads, combined): what
        # the threads save the restore's CRC.
        with open(blob, "rb") as f:
            sample = f.read(CRC_SAMPLE)
        t0 = time.perf_counter()
        serial = zlib.crc32(sample) & 0xFFFFFFFF
        serial_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        parts = ckpt_mod._crc(sample)
        parts_s = time.perf_counter() - t0
        if serial != parts:
            fail(f"CRC in parts {parts:#010x} != zlib's {serial:#010x}")
        del sample
        emit("checkpoint_restore", card=card, leaves=len(live),
             bit_identical=True, restore_s=restore_s,
             restore_gb_per_s=gbps(restore["restore_bytes"], restore_s),
             restore_bytes=restore["restore_bytes"],
             restore_crc_s=restore["restore_crc_s"],
             restore_params_host_s=params_s,
             params_bytes=params_bytes,
             params_gb_per_s=gbps(params_bytes, params_s),
             crc_sample_bytes=CRC_SAMPLE,
             crc_serial_gb_per_s=gbps(CRC_SAMPLE, serial_s),
             crc_parts_gb_per_s=gbps(CRC_SAMPLE, parts_s),
             note="restore_params_host reads and checks the whole blob")
        del live

        # -- c. eval from the checkpoint ----------------------------------
        evals = {}

        def keep_eval(real):
            def run(*a, **k):
                out = real(*a, **k)
                evals.update(out)
                return out
            return run

        zero()
        t0 = time.perf_counter()
        with Patched((loop, "run_eval", keep_eval)):
            rep = run_cli(["eval", *CKPT_TRAIN, *CKPT_DEPTH,
                           "--checkpoint-dir", root, "--eval-steps", "2"])
        eval_s = time.perf_counter() - t0
        eval_launches = read()
        eval_k1 = eval_launches["flash_fwd"]
        mine = loop.run_eval(cfg, trainer, state, num_batches=2)
        emit("checkpoint_eval", card=card, checkpoint_step=
             rep["checkpoint_step"], eval=evals, live_eval=mine,
             eval_command_s=eval_s, launches=eval_launches)
        if rep["checkpoint_step"] != 3:
            fail(f"eval: step {rep['checkpoint_step']}, expected 3")
        expect("eval", eval_launches, flash_fwd=2 * CKPT_LAYERS)
        if evals != mine:
            fail(f"eval from the checkpoint {evals} != the live model's "
                 f"{mine}")
        del trainer, state, kept["trainer"], kept["state"]
        torch.cuda.empty_cache()

        # -- d. generate, speculative --------------------------------------
        per_fwd = 7 * CKPT_LAYERS + 1
        per_draft = 7 * DRAFT_LAYERS + 1
        models, counts, rows = [], {"target": 0, "draft": 0}, set()

        def counter(name):
            def hook(mod, args):
                counts[name] += 1
                rows.add(args[0].numel())
            return hook

        def keep_model(real):
            def build(args, overrides):
                model, step = real(args, overrides)
                model.register_forward_pre_hook(counter("target"))
                models.append(model)
                return model, step
            return build

        def keep_draft(real):
            def build(model, n):
                draft = real(model, n)
                draft.register_forward_pre_hook(counter("draft"))
                return draft
            return build

        gen = ["generate", "--model", "llama_1b", *CKPT_DEPTH,
               "--checkpoint-dir", root, "--quant", "int8",
               "--max-new-tokens", str(GEN_NEW)]
        k6 = {}
        replies = {}
        with Patched((cli, "_model_from_args", keep_model),
                     (speculative, "prefix_draft", keep_draft)):
            for name, extra in (("greedy", []),
                                ("prefix_draft", ["--draft-layers",
                                                  str(DRAFT_LAYERS),
                                                  "--spec-k", str(SPEC_K)])):
                zero()
                counts.update(target=0, draft=0)
                t0 = time.perf_counter()
                replies[name] = run_cli(gen + extra)
                n = read()
                k6[name] = dict(launches=n["quant_matmul"], **counts,
                                command_s=time.perf_counter() - t0)
                want = per_fwd * counts["target"] + per_draft * counts["draft"]
                if counts["target"] == 0:
                    fail(f"generate {name}: no forward of the target")
                expect(f"generate {name} ({counts})", n, quant_matmul=want)
        gen_rows = sorted(rows)
        model = models[-1]
        prompt = replies["greedy"]["prompt"][0]
        plain = replies["greedy"]["tokens"][0][len(prompt):]
        spec = replies["prefix_draft"]["tokens"][0][len(prompt):]
        if replies["greedy"]["checkpoint_step"] != 3 or len(plain) != GEN_NEW:
            fail(f"generate: {str(replies['greedy'])[:300]}")
        p = torch.tensor([prompt], dtype=torch.int32, device="cuda")
        self_out, self_stats = speculative.speculative_generate(
            model, model, p, GEN_NEW, K=SPEC_K)
        self_spec = self_out[0, len(prompt):].tolist()
        held = {}
        for name, reply in (("prefix_draft", spec), ("self_draft",
                                                     self_spec)):
            ver = verify_logits(torch, model, prompt, reply, SPEC_K)
            _, worst, tol = hold_to_greedy(torch, model, prompt, reply,
                                           [ver])
            held[name] = dict(equal_to_greedy=reply == plain,
                              worst_gap=worst, tolerance=tol)
            if worst > tol:
                fail(f"{name}: a token lies {worst:.4f} below greedy's "
                     f"largest logit, beyond the measured {tol:.4f}")
        draft = speculative.prefix_draft(model, DRAFT_LAYERS)
        timed = {
            "greedy": lambda: generate(model, p, GEN_NEW),
            "prefix_draft": lambda: speculative.speculative_generate(
                model, draft, p, GEN_NEW, K=SPEC_K),
            "self_draft": lambda: speculative.speculative_generate(
                model, model, p, GEN_NEW, K=SPEC_K),
        }
        speeds = {}
        for name, fn in timed.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            speeds[name] = dict(
                s=dt, new_tokens_per_s=GEN_NEW / dt,
                acceptance=None if name == "greedy" else out[1][
                    "acceptance"],
                rounds=None if name == "greedy" else out[1]["rounds"])
        fwd_bytes = sum(I * O * n + O * 4 * n
                        for (I, O), (_, n) in LLAMA1B_SHAPES.items())
        emit("checkpoint_generate", card=card, prompt_len=len(prompt),
             new_tokens=GEN_NEW, draft_layers=DRAFT_LAYERS, spec_k=SPEC_K,
             k6=k6, rows_served=gen_rows,
             acceptance_prefix_draft=replies["prefix_draft"][
                 "speculative"]["acceptance"],
             acceptance_self_draft=self_stats["acceptance"],
             held_to_greedy=held, speeds=speeds,
             int8_forward_bytes=fwd_bytes,
             bound_ms_per_forward=fwd_bytes / HBM_BYTES_PER_S * 1e3,
             loop="host loop, one sync a round")
        if self_stats["acceptance"] != 1.0:
            fail(f"self-draft accepted {self_stats['acceptance']:.3f}, "
                 f"not all")
        del model, draft, models[:], p, self_out
        torch.cuda.empty_cache()

        # -- e. serve -------------------------------------------------------
        servers = []

        def keep_server(real):
            class Kept(real):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    servers.append(self)
            return Kept

        zero()
        counts.update(target=0, draft=0)
        rows.clear()
        g = torch.Generator().manual_seed(10)
        prompts = [torch.randint(0, 128256, (n,), generator=g).tolist()
                   for n in SERVE_1B_PROMPTS]
        argv = ["serve", "--model", "llama_1b", *CKPT_DEPTH,
                "--checkpoint-dir", root, "--quant", "int8", "--port", "0"]
        with Patched((cli, "_model_from_args", keep_model),
                     (server_mod, "GenerationServer", keep_server)):
            th = threading.Thread(target=cli.main, args=(argv,), daemon=True)
            th.start()
            t0 = time.perf_counter()
            while not servers and th.is_alive() and (
                    time.perf_counter() - t0 < 600):
                time.sleep(0.1)
            if not servers:
                fail("serve did not come up")
            served = [None, None]

            def client(i):
                served[i] = request(servers[0].addr, {
                    "prompt": prompts[i], "max_new_tokens": GEN_NEW},
                    timeout=600)

            try:
                clients = [threading.Thread(target=client, args=(i,))
                           for i in range(2)]
                t1 = time.perf_counter()
                for c in clients:
                    c.start()
                for c in clients:
                    c.join(timeout=600)
                serve_s = time.perf_counter() - t1
            finally:
                servers[0].stop()
                th.join(timeout=120)
        serve_n, serve_fwd = read(), counts["target"]
        serve_launches = serve_n["quant_matmul"]
        eng = servers[0].engine
        replays = {key: c.replays for key, c in eng._chunks.items()
                   if c.replays}
        # Replayed steps pass no forward hook: their rows are the buckets'.
        rows |= {nb for nb, _ in replays}
        model = models[-1]
        faults, holds = [], []
        for rep in served:
            if rep is None or "error" in rep or len(rep["new_tokens"]) != \
                    GEN_NEW:
                fail(f"serve reply: {str(rep)[:300]}")
        news = [rep["new_tokens"] for rep in served]
        # The engine's paths: the two prompts paged together (prefill
        # chunks of 32, a window of 16 pages) and each alone.
        together = forced_logits(torch, model, prompts, news, 16)
        for i, (prompt, new) in enumerate(zip(prompts, news)):
            alone = forced_logits(torch, model, [prompt], [new], 16)[0]
            equal, worst, tol = hold_to_greedy(torch, model, prompt, new,
                                               [alone, together[i]])
            holds.append(dict(equal_to_greedy=equal, worst_gap=worst,
                              tolerance=tol))
            if worst > tol:
                faults.append(f"a served token lies {worst:.4f} below "
                              f"greedy's largest logit (tol {tol:.4f})")
        if serve_fwd == 0 or serve_n != dict(
                dict.fromkeys(serve_n, 0), quant_matmul=per_fwd * serve_fwd):
            faults.append(f"{serve_n} eager launches for {serve_fwd} "
                          f"forwards, expected {per_fwd} K6 a forward")
        if not replays:
            faults.append("serve replayed no decode chunk from a CUDA graph")
        traced, replayed, bad = trace_replays(torch, eng, replays, per_fwd)
        faults += bad
        all_rows = set(gen_rows) | rows
        if not all_rows <= set(CHECK_ROWS_1B):
            faults.append(f"K6 served rows {sorted(all_rows)}, phase 3 "
                          f"checked {list(CHECK_ROWS_1B)} at llama_1b")
        emit("checkpoint_serve", card=card, engine="continuous",
             requests=len(served), serve_s=serve_s,
             new_tokens_per_s=2 * GEN_NEW / serve_s,
             eager_k6_launches=serve_launches, eager_forwards=serve_fwd,
             graph_replays=sum(replays.values()),
             k6_launches_replayed_traced=replayed, replayed_buckets=traced,
             rows_served=sorted(rows), held_to_greedy=holds,
             checkpoint_step=3)
        if faults:
            fail("phase 10: " + "; ".join(faults))
        del model, models[:], eng, servers[:]
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("checkpoint_phase", card=card, seconds=time.perf_counter() - t_phase)
    return total, replayed


# ----------------------------------------------------- emergency save --

# Phase 12a's child: llama_1b at full width and 2 layers, checkpointing
# too rarely to save on its own, with the emergency shadow refreshed at
# every step boundary.
DRILL_ARGS = ["--model", "llama_1b", "--batch-size", str(TRAIN_B),
              "--seq-len", str(TRAIN_T), "--set", "model_overrides.n_layers=2",
              "--set", "optimizer.grad_clip_norm=1.0", "--steps", "100000",
              "--checkpoint-every", "1000", "--verbose",
              "--set", "train.log_every=1",
              "--set", "checkpoint.emergency_min_interval_s=0"]
DRILL_TIMEOUT_S = 600  # for the third step line, then for the child's exit


def emergency_drill(torch, card):
    """Phase 12a: a child process ``train``s (DRILL_ARGS) and gets SIGTERM
    after its third step line. Its flight dump must say sigterm and carry
    the card's ``torch.cuda`` memory statistics and
    ``slt_ckpt_emergency_saves_total`` = 1; the emergency commit must be
    the newest shadow's step (or the step a refresh the signal interrupted
    was copying), restore in place into a fresh trainer here,
    and re-encode to the committed bytes (their CRC-32 is the
    manifest's), so what was restored is the shadow bit for bit."""
    import os
    import shutil
    import signal

    from serverless_learn_tpu_torch.cli import _train_config, build_parser
    from serverless_learn_tpu_torch.training import checkpoint as ckpt_mod
    from serverless_learn_tpu_torch.training.train_step import build_trainer
    from serverless_learn_tpu_torch.utils.serialization import encode

    root = checkpoint_dir(free_bytes=12e9, prefix="slt-phase12a-")
    flight_dir = os.path.join(root, "flight")
    t0 = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "serverless_learn_tpu_torch", "train",
         *DRILL_ARGS, "--checkpoint-dir", root, "--flight-dir", flight_dir],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    # A thread drains the child's stderr, so neither a silent child nor a
    # full pipe can block the phase: the waits below all time out.
    lines, third = [], threading.Event()

    def drain():
        n = 0
        for line in child.stderr:
            lines.append(line)
            if line.startswith('{"step"'):
                n += 1
                if n == 3:
                    third.set()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    t_kill = rc = None
    at_kill = 0
    try:
        if third.wait(timeout=DRILL_TIMEOUT_S):
            t_kill = time.perf_counter()
            child.send_signal(signal.SIGTERM)
            at_kill = len(lines)
        rc = child.wait(timeout=DRILL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        reader.join(timeout=30)
    step_lines = sum(x.startswith('{"step"') for x in lines[:at_kill])
    tail = lines[-20:]
    death_s = time.perf_counter() - t_kill if t_kill is not None else None
    if t_kill is None or rc != -signal.SIGTERM:
        fail(f"phase 12a: {step_lines} step lines, exit {rc}: "
             f"{''.join(tail)[-2000:]}")
    dumps = os.listdir(flight_dir)
    if len(dumps) != 1:
        fail(f"phase 12a: flight dumps {dumps}")
    with open(os.path.join(flight_dir, dumps[0])) as f:
        dump = json.load(f)
    saved = dump.get("death_hooks", {}).get("ckpt:ckpt", {})
    shadows = [(e["step"], e["seconds"]) for e in dump["events"]
               if e.get("event") == "ckpt_shadow"]
    emergency = dump.get("metrics", {}).get(
        "slt_ckpt_emergency_saves_total", {}).get("series", [{}])
    mem = dump.get("device_memory") or []
    faults = []
    if dump.get("reason") != "sigterm":
        faults.append(f"dump reason {dump.get('reason')}")
    if not mem or "allocated_bytes.all.current" not in mem[0]:
        faults.append("the dump carries no torch.cuda memory statistics")
    if emergency[0].get("value") != 1:
        faults.append(f"slt_ckpt_emergency_saves_total {emergency}")
    # The newest shadow's step; or, when the signal interrupted a
    # refresh, the step being copied (one past the last whole shadow's).
    step = saved.get("step")
    newest = (shadows[-1][0] if shadows else 0) + (
        saved.get("source") == "refresh")
    if step is None or step != newest:
        faults.append(f"the emergency save {saved} is not the newest "
                      f"shadow's step ({shadows[-1:]})")
    if faults:
        fail("phase 12a: " + "; ".join(faults))

    # Restore the emergency commit in place into a fresh trainer (the
    # child's config), then re-encode it: the committed bytes again.
    args = build_parser().parse_args(["train", *DRILL_ARGS])
    cfg = _train_config(args)
    trainer = build_trainer(cfg, "cuda")
    state = trainer.init(seed=1)
    ck = ckpt_mod.Checkpointer(ckpt_mod.LocalStore(root))
    with open(os.path.join(root, "ckpt", f"step-{step:010d}.manifest")) as f:
        manifest = json.load(f)
    torch.cuda.synchronize()
    t0r = time.perf_counter()
    tree = trainer.state_tree(state)
    ck.restore(tree, step=step)
    trainer.load_tree(state, tree)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0r
    again = encode(trainer.state_tree(state))
    crc = ckpt_mod._crc(again)
    if (state.step != step or len(again) != manifest["nbytes"]
            or crc != manifest["crc32"]
            or manifest.get("emergency") != "emergency:sigterm"):
        fail(f"phase 12a: the restored state (step {state.step}) re-encodes "
             f"to {len(again)} B crc {crc:#010x}, the emergency commit is "
             f"{manifest}")
    emit("emergency_save_llama_1b_2_layers", card=card,
         emergency_step=step, steps_logged_before_sigterm=step_lines,
         blob_bytes=manifest["nbytes"], crc32=manifest["crc32"],
         shadow_refreshes_s=shadows,
         shadow_first_s=shadows[0][1],
         shadow_later_s_median=(statistics.median(s for _, s in shadows[1:])
                                if len(shadows) > 1 else None),
         sigterm_to_exit_s=death_s, child_s=time.perf_counter() - t0,
         flight_dump_keys=sorted(dump), dump_device_memory_gb=mem[0].get(
             "allocated_bytes.all.current", 0) / 1e9,
         restore_in_place_s=restore_s, bit_identical=True)
    del trainer, state, tree, again
    shutil.rmtree(root, ignore_errors=True)
    return step


# ------------------------------------------------------ the cluster (13) --

# Phase 13's worker: llama_1b at full width (d 2,048, 32/8 heads, vocab
# 128,256) and 2 layers, B = 2, T = 4,096, so K1-K3 launch, 2 each a step.
ELASTIC_MODEL, ELASTIC_LAYERS = "llama_1b", 2
ELASTIC_STEPS = 60
ELASTIC_ARGS = ["--model", ELASTIC_MODEL, "--batch-size", str(TRAIN_B),
                "--seq-len", str(TRAIN_T), "--set",
                f"model_overrides.n_layers={ELASTIC_LAYERS}", "--set",
                "optimizer.grad_clip_norm=1.0"]
# A short lease and a fast sweep, so a SIGKILLed member is evicted in ~2 s;
# the members heartbeat 10 times a lease.
ELASTIC_LEASE_MS, ELASTIC_SWEEP_MS, ELASTIC_HEARTBEAT_MS = 2000, 100, 200
# The synthetic dataset: 8 shards of 2 records (one batch each), 4 a stripe
# while the stripe is (r, 2).
ELASTIC_RECORDS, ELASTIC_PER_SHARD = 16, 2
ELASTIC_JOIN_AT = 3       # the worker's step line after which a member joins
ELASTIC_CRASH_AFTER = 4   # step lines on the (r, 2) stripe before its SIGKILL
ELASTIC_TEXT_ROWS = 24    # byte-level rows of 4,096 in the text dataset
ELASTIC_WAIT_S = 600      # the longest any line or exit is waited for
# Host memory the phase needs: the shard server's root and the peer cache
# in tmpfs (at most two 7.8 GB checkpoints each with checkpoint.keep=1) and
# the worker's emergency shadow and save buffers.
ELASTIC_HOST_BYTES = 60e9
# The worker's checkpoint cache (--ckpt-cache-dir) takes ~24 GB of writes:
# on the disk under --elastic-only, in tmpfs in the full run, where phases
# 10 to 12a have already written ~44 GB to the disk and the card's machine
# allows 45 GiB a run, deleted files included (``elastic_cluster`` prints
# the filesystem).
# The peer drill: after the worker's last save, its cache is deleted and
# the shard server's copy of that step corrupted; a restarted worker
# restores from the peer cache (a CPU-only serve_cache process that every
# commit was pushed to) and trains ELASTIC_DRILL_STEPS more steps.
ELASTIC_DRILL_STEPS = 2
# The joining member: a process that only holds a lease.
JOINER = """
import signal, sys
from serverless_learn_tpu_torch.control.client import WorkerAgent
agent = WorkerAgent(sys.argv[1], "joiner:1", name="phase13-joiner",
                    heartbeat_interval_ms=int(sys.argv[2])).start()
print("joined", agent.worker_id, flush=True)
signal.pause()
"""


class Child:
    """A child process whose stdout and stderr lines are read by threads,
    so neither a silent child nor a full pipe blocks the phase; every wait
    has a timeout."""

    def __init__(self, argv, cwd, env=None):
        self.argv = argv
        self.proc = subprocess.Popen(argv, cwd=cwd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True,
                                     env=env)
        self.lines = {"out": [], "err": []}
        self._cv = threading.Condition()
        self._readers = [threading.Thread(target=self._read, args=(k, s),
                                          daemon=True)
                         for k, s in (("out", self.proc.stdout),
                                      ("err", self.proc.stderr))]
        for t in self._readers:
            t.start()

    def _read(self, key, stream):
        for line in stream:
            with self._cv:
                self.lines[key].append(line)
                self._cv.notify_all()
        with self._cv:
            self._cv.notify_all()

    def records(self, key="err"):
        """The lines that are JSON objects."""
        with self._cv:
            lines = list(self.lines[key])
        out = []
        for line in lines:
            if line.startswith("{"):
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
        return out

    def wait_for(self, pred, what, key="err", timeout=ELASTIC_WAIT_S):
        """The records of ``key`` once ``pred(records)`` holds; fails at
        the timeout or when the child exits first."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                recs = self.records(key)
                if pred(recs):
                    return recs
                if self.proc.poll() is not None and not any(
                        t.is_alive() for t in self._readers):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(min(left, 1.0))
        self.stop()
        fail(f"phase 13: {what}: not seen (exit {self.proc.returncode}); "
             f"{''.join(self.lines['err'][-15:])[-3000:]}")

    def wait(self, timeout=ELASTIC_WAIT_S):
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            fail(f"phase 13: {self.argv[3:5]} did not exit in {timeout}s")
        for t in self._readers:
            t.join(timeout=30)
        return rc

    def stop(self, sig=None):
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(sig or signal.SIGTERM)
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        return self.proc.returncode


def elastic_root():
    """Phase 13's directory: in tmpfs (``/dev/shm``) where the host has
    ELASTIC_HOST_BYTES available, so the checkpoints of its transitions
    (tens of GB written) stay off the disk, else on a disk with that much
    free (``checkpoint_dir``). Returns (path, where)."""
    import os
    import tempfile

    avail, _ = host_memory_gb()
    if os.path.isdir("/dev/shm") and avail and avail * 1e9 >= \
            ELASTIC_HOST_BYTES:
        return tempfile.mkdtemp(prefix="slt-phase13-", dir="/dev/shm"), \
            "tmpfs"
    return checkpoint_dir(free_bytes=ELASTIC_HOST_BYTES,
                          prefix="slt-phase13-"), "disk"


ELASTIC_STATE_BYTES = 7_763_779_592  # the 2-layer worker's checkpoint
# The longest another thread may wait to allocate while a state-sized
# host buffer is populated: half the phase's lease.
ELASTIC_STALL_S = ELASTIC_LEASE_MS / 2000


def allocation_stall(nbytes):
    """(seconds to populate a ``host_buffer`` of ``nbytes``, the longest
    another thread waited to allocate 0.5 MB meanwhile): a populate that
    holds the process's memory map stalls every thread, a heartbeat
    thread's too."""
    from serverless_learn_tpu_torch.utils.serialization import host_buffer

    waits, stop = [], threading.Event()

    def allocate():
        while not stop.is_set():
            t0 = time.perf_counter()
            blocks = [bytearray(100_000) for _ in range(5)]
            waits.append(time.perf_counter() - t0)
            del blocks
            time.sleep(0.01)

    t = threading.Thread(target=allocate, daemon=True)
    t.start()
    time.sleep(0.1)
    t0 = time.perf_counter()
    buf = host_buffer(nbytes)
    populate_s = time.perf_counter() - t0
    time.sleep(0.1)
    stop.set()
    t.join(timeout=30)
    del buf
    return populate_s, max(waits)


def text_corpus(path, rows, seed=0):
    """A byte-level text corpus from ``seed``: documents of lowercase
    words, enough for ``rows`` packed rows of TRAIN_T."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"etaoinshrdlucmfwypvbgkjqxz", np.uint8)
    docs, size = [], 0
    while size < rows * TRAIN_T:
        n = int(rng.integers(200, 2000))
        text = letters[rng.integers(0, len(letters), n)]
        text[rng.random(n) < 0.18] = ord(" ")
        docs.append(text.tobytes().decode())
        size += n + 1
    with open(path, "w") as f:
        f.write("\n\n".join(docs))


def fs_type(path):
    """The type of the filesystem that holds ``path``, from /proc/mounts
    (the longest mount point above it)."""
    import os

    path = os.path.realpath(path)
    best, kind = "", None
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            mnt = parts[1].replace("\\040", " ")
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) > len(best):
                best, kind = mnt, parts[2]
    return {"mount": best, "type": kind}


def flip_middle_byte(path):
    """Corrupt a file in place: its middle byte inverted."""
    import os

    off = os.path.getsize(path) // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return off


def elastic_cluster(torch, card, cache_on_disk=False):
    """Phase 13: the reference's cluster demo on the card, through the
    CLI: the port's ``coordinator`` (lease 2 s, sweep 100 ms) and
    ``shard-server`` as child processes, ``publish`` of a synthetic
    llama_1b dataset (8 shards of 2 records x 4,096) and of a byte-level
    text corpus written from seed 0, then ``worker`` (llama_1b at full
    width, 2 layers, B = 2, T = 4,096, ELASTIC_STEPS; ``--metrics-port 0
    --health --events-log``) with its checkpoints in the shard server.
    After its 3rd step line a second member registers (a child holding a
    lease through the port's ``WorkerAgent``): epoch + 1, stripe (0, 2).
    After 4 step lines on that stripe the member is SIGKILLed: its lease
    expires, epoch + 1, stripe (0, 1).

    First, another thread's longest wait to allocate while a state-sized
    host buffer is populated must stay under half the lease. Checks:
    three formations (two transitions), epochs and stripes as
    above, in the worker's ``mesh_formed`` lines and ``slt_remesh_total``
    on /metrics; each restore is the step its save wrote, verified
    against the save's CRCs (``slt_ckpt_verified_restores_total``); the
    step lines run 1..ELASTIC_STEPS with none lost or repeated; the
    shard server's
    fetches (its span records joined to the worker's client spans) read
    only even shards on (0, 2) and all 8 again after; K1-K3 launch
    2 x ELASTIC_STEPS times and K4/K5 not at all; no alert pages (no critical alert;
    warnings are printed) and /healthz answers 200; the card's peak memory across each transition stays
    under 1.5x the checkpoint's size (one trainer's state, not two).
    Last, the shard server is SIGKILLed under a ``train --shard-server``
    run on the text dataset, which must exit non-zero with the source's
    error. Prints the worker's tokens/s and step time beside phase 8b's,
    the ``data_wait`` share of goodput, each transition's save, re-form
    and restore (s, GB, GB/s, the restore's source), the shard server's
    bytes served and the peak memory. Returns the worker's kernel
    launches.

    Checkpoint replicas: the worker runs with ``--ckpt-cache-dir`` (on the
    disk with ``cache_on_disk``, else in tmpfs; the filesystem's type from
    /proc/mounts is printed) and ``--ckpt-peers`` naming a CPU-only
    ``serve_cache`` process (``training/replicate.py``) with fanout 1;
    both transitions must restore from ``cache``. The peer drill, before
    the shard server is killed: the worker's cache is deleted and the
    shard server's copy of the final step corrupted (a byte of its data
    file inverted); a restarted worker of the same name must restore that
    step from ``peer:<addr>`` after the primary's copy fails its CRC (a
    ``ckpt_corrupt`` event naming ``primary``), its ``remesh_restore``
    fingerprint equal to the first worker's ``remesh_save`` one, and train
    ELASTIC_DRILL_STEPS more steps."""
    import os
    import shutil
    import signal

    from serverless_learn_tpu_torch.control.client import ShardClient
    from serverless_learn_tpu_torch.telemetry import fetch_text

    here = os.path.dirname(os.path.abspath(__file__))
    py = [sys.executable, "-m", "serverless_learn_tpu_torch"]
    populate_s, stall_s = allocation_stall(ELASTIC_STATE_BYTES)
    if stall_s > ELASTIC_STALL_S:
        fail(f"phase 13: populating a {ELASTIC_STATE_BYTES / 1e9:.2f} GB host "
             f"buffer held another thread's allocation {stall_s:.2f} s")
    root, where = elastic_root()
    logs = {k: os.path.join(root, f"{k}.jsonl")
            for k in ("coordinator", "shard_server", "worker")}
    children, cache = [], None
    t_phase = time.perf_counter()

    def start(argv, env=None):
        children.append(Child(argv, here, env=env))
        return children[-1]

    def addr_of(c, what):
        up = c.wait_for(lambda r: any("addr" in x for x in r), what,
                        key="out", timeout=120)
        port = next(x["addr"] for x in up if "addr" in x).rsplit(":", 1)[1]
        return f"127.0.0.1:{port}"

    def steps(r):
        return [x["step"] for x in r if "step" in x and "event" not in x]

    def formed(r):
        return [x for x in r if x.get("event") == "mesh_formed"]

    try:
        co = start(py + ["coordinator", "--port", "0", "--host", "127.0.0.1",
                         "--lease-ttl-ms", str(ELASTIC_LEASE_MS),
                         "--sweep-ms", str(ELASTIC_SWEEP_MS),
                         "--events-log", logs["coordinator"]])
        ss = start(py + ["shard-server", "--port", "0", "--host",
                         "127.0.0.1", "--root", os.path.join(root, "store"),
                         "--events-log", logs["shard_server"]])
        # The peer: a worker's cache served to the others, on the CPU.
        peer = start([sys.executable, "-m",
                      "serverless_learn_tpu_torch.training.replicate",
                      "--root", os.path.join(root, "peer")],
                     env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        cache = (checkpoint_dir(free_bytes=ELASTIC_HOST_BYTES,
                                prefix="slt-phase13-cache-")
                 if cache_on_disk else os.path.join(root, "cache"))
        cache_fs = fs_type(os.path.dirname(cache) if not
                           os.path.exists(cache) else cache)
        co_addr = addr_of(co, "the coordinator's address")
        ss_addr = addr_of(ss, "the shard server's address")
        peer_addr = addr_of(peer, "the peer cache's address")
        replicas = ["--ckpt-cache-dir", cache, "--ckpt-peers", peer_addr,
                    "--set", "checkpoint.replica_fanout=1"]
        pub = run_cli(["publish", "--shard-server", ss_addr, "--dataset",
                       "ds", "--format", "synthetic", "--model", ELASTIC_MODEL,
                       "--seq-len", str(TRAIN_T), "--num-records",
                       str(ELASTIC_RECORDS), "--records-per-shard",
                       str(ELASTIC_PER_SHARD), "--seed", "0"])
        corpus = os.path.join(root, "corpus.txt")
        text_corpus(corpus, ELASTIC_TEXT_ROWS)
        pub_text = run_cli(["publish", "--shard-server", ss_addr,
                            "--dataset", "text", "--format", "text",
                            "--path", corpus, "--seq-len", str(TRAIN_T),
                            "--records-per-shard", "2"])
        n_shards = pub["num_shards"]

        t_worker = time.perf_counter()
        worker = start(py + [
            "worker", *ELASTIC_ARGS, "--coordinator", co_addr,
            "--shard-server", ss_addr, "--dataset", "ds", "--steps",
            str(ELASTIC_STEPS), "--name", "phase13", "--verbose", "--set",
            "train.log_every=1", "--set",
            f"control.heartbeat_interval_ms={ELASTIC_HEARTBEAT_MS}",
            "--set", "checkpoint.keep=1", "--metrics-port", "0", "--health",
            "--numerics", "--events-log", logs["worker"], "--flight-dir",
            os.path.join(root, "flight"), *replicas])
        up = worker.wait_for(
            lambda r: any(x.get("event") == "metrics" for x in r),
            "the worker's metrics line", key="out", timeout=300)
        metrics_addr = next(x["addr"] for x in up
                            if x.get("event") == "metrics")
        scrapes, stop_scrape = [], threading.Event()

        def scrape():
            while not stop_scrape.wait(0.5):
                rec = {}
                for path in ("/metrics", "/alerts", "/healthz"):
                    try:
                        rec[path] = (200, fetch_text(metrics_addr, path,
                                                     timeout=5))
                    except Exception as e:  # noqa: BLE001
                        code = getattr(e, "code", None)
                        rec[path] = (code, None) if code else None
                scrapes.append(rec)

        scraper = threading.Thread(target=scrape, daemon=True)
        scraper.start()
        worker.wait_for(lambda r: len(steps(r)) >= ELASTIC_JOIN_AT,
                        f"step line {ELASTIC_JOIN_AT}")
        joiner = start([sys.executable, "-c", JOINER, co_addr,
                        str(ELASTIC_HEARTBEAT_MS)])
        deadline = time.monotonic() + 120
        while not any(x.startswith("joined") for x in joiner.lines["out"]):
            if time.monotonic() > deadline or joiner.proc.poll() is not None:
                fail("phase 13: the joiner did not register: "
                     f"{''.join(joiner.lines['err'])[-2000:]}")
            time.sleep(0.05)
        t_join = time.time()
        recs = worker.wait_for(lambda r: len(formed(r)) >= 2,
                               "the formation after the join")
        at = len(steps(recs))
        worker.wait_for(lambda r: len(steps(r)) >= at + ELASTIC_CRASH_AFTER,
                        "steps on the (0, 2) stripe")
        joiner.stop(signal.SIGKILL)
        t_kill = time.time()
        worker.wait_for(lambda r: len(formed(r)) >= 3,
                        "the formation after the lease expiry")
        rc = worker.wait()
        stop_scrape.set()
        scraper.join(timeout=30)
        worker_s = time.perf_counter() - t_worker
        recs = worker.records("err")
        done = [x for x in worker.records("out")
                if x.get("event") == "worker_done"]
        if rc != 0 or not done:
            fail(f"phase 13: worker exited {rc}: "
                 f"{''.join(worker.lines['err'][-15:])[-3000:]}")
        done = done[-1]
        client = ShardClient(ss_addr)
        try:
            stats = client.stats()
        finally:
            client.close()

        # The peer drill: the worker's cache gone, the primary's copy of
        # its last step corrupt; a restarted worker restores from the peer.
        shutil.rmtree(cache)
        flipped = flip_middle_byte(os.path.join(
            root, "store", "phase13", f"step-{ELASTIC_STEPS:010d}",
            "proc-00000.dat"))
        logs["drill"] = os.path.join(root, "drill.jsonl")
        t_drill = time.perf_counter()
        drill = start(py + [
            "worker", *ELASTIC_ARGS, "--coordinator", co_addr,
            "--shard-server", ss_addr, "--dataset", "ds", "--steps",
            str(ELASTIC_STEPS + ELASTIC_DRILL_STEPS), "--name", "phase13",
            "--verbose", "--set", "train.log_every=1", "--set",
            f"control.heartbeat_interval_ms={ELASTIC_HEARTBEAT_MS}",
            "--set", "checkpoint.keep=1", "--numerics", "--events-log",
            logs["drill"], *replicas,
            # The peer stays a restore source; the drill pushes nothing
            # more to it (its exit would wait ~25 s for a 7.8 GB push).
            "--set", "checkpoint.replica_fanout=0"])
        drill_rc = drill.wait()
        drill_s = time.perf_counter() - t_drill
        drill_recs = drill.records("err")
        drill_done = [x for x in drill.records("out")
                      if x.get("event") == "worker_done"]
        if drill_rc != 0 or not drill_done:
            fail(f"phase 13: the restarted worker exited {drill_rc}: "
                 f"{''.join(drill.lines['err'][-15:])[-3000:]}")

        # Last: the shard server killed under a train run on the text
        # dataset. The run must fail with the source's error.
        trainer = start(py + ["train", *ELASTIC_ARGS, "--shard-server",
                              ss_addr, "--dataset", "text", "--steps",
                              "1000", "--verbose", "--set",
                              "train.log_every=1"])
        trainer.wait_for(lambda r: len(steps(r)) >= 2,
                         "the text run's second step line")
        ss.stop(signal.SIGKILL)
        t_ss_kill = time.perf_counter()
        train_rc = trainer.wait()
        killed_run_s = time.perf_counter() - t_ss_kill
        train_tail = [x.strip() for x in trainer.lines["err"][-3:]]
        train_steps = len(steps(trainer.records("err")))

        events = {k: read_events(p) for k, p in logs.items()
                  if os.path.exists(p)}
    finally:
        for c in children:
            c.stop()
        shutil.rmtree(root, ignore_errors=True)
        if cache_on_disk and cache:
            shutil.rmtree(cache, ignore_errors=True)

    faults = []
    fm = formed(recs)
    got = [(x["epoch"], (x["stripe_rank"], x["stripe_size"])) for x in fm]
    if got != [(1, (0, 1)), (2, (0, 2)), (3, (0, 1))]:
        faults.append(f"formations (epoch, stripe) {got}")
    rem = [x for x in recs if x.get("event") == "remesh"]
    for r in rem[1:]:
        if (r["restored_step"] != r["saved_step"]
                or r["restore_bytes"] != r["save_bytes"]):
            faults.append(f"a restore is not its save: {r}")
    if steps(recs) != list(range(1, ELASTIC_STEPS + 1)):
        faults.append(f"step lines {steps(recs)}")
    if [x["step"] for x in fm[1:]] != [r["saved_step"] for r in rem[1:]]:
        faults.append("a formation did not go on from the saved step")
    # --numerics: each formation's restored fingerprint is its save's.
    fps = [x for x in events.get("worker", [])
           if x.get("event") == "numerics_fingerprint"]
    saved_fp = {x["step"]: x["fp"] for x in fps
                if x.get("reason") == "remesh_save"}
    fp_checks = []
    for r in rem[1:]:
        got = [x for x in fps if x.get("reason") == "remesh_restore"
               and x["step"] == r["restored_step"]
               and x.get("epoch") == r["epoch"]]
        same = len(got) == 1 and got[0]["fp"] == saved_fp.get(
            r["saved_step"])
        fp_checks.append({"epoch": r["epoch"], "step": r["restored_step"],
                          "restore_records": len(got),
                          "equals_saved": same})
        if not same:
            faults.append(f"epoch {r['epoch']}: {len(got)} remesh_restore "
                          f"fingerprints at step {r['restored_step']}, "
                          f"equal to the saved one: {same}")
    # Replicas: each transition read the worker's cache; the drill's
    # restore read the peer after the primary's copy failed its CRC, and
    # gave the saved state's fingerprint.
    sources = [r.get("restore_source") for r in rem[1:]]
    if sources != ["cache"] * len(rem[1:]):
        faults.append(f"transition restore sources {sources}")
    drem = [x for x in drill_recs if x.get("event") == "remesh"]
    dev = events.get("drill", [])
    corrupt = [(x.get("step"), x.get("source")) for x in dev
               if x.get("event") == "ckpt_corrupt"]
    drill_fp = [x["fp"] for x in dev
                if x.get("event") == "numerics_fingerprint"
                and x.get("reason") == "remesh_restore"
                and x.get("step") == ELASTIC_STEPS]
    first = drem[0] if drem else {}
    drill = {
        "restored_step": first.get("restored_step"),
        "restore_source": first.get("restore_source"),
        "restore_s": first.get("restore_s"),
        "restore_gb": (first.get("restore_bytes") or 0) / 1e9,
        "restore_gbps": gbps(first.get("restore_bytes") or 0,
                             first.get("restore_s")),
        "corrupt_events": corrupt, "flipped_offset": flipped,
        "fingerprint_equals_saved": (len(drill_fp) == 1 and drill_fp[0]
                                     == saved_fp.get(ELASTIC_STEPS)),
        "steps": drill_done[-1].get("steps"), "seconds": drill_s}
    if (drill["restored_step"] != ELASTIC_STEPS
            or not str(drill["restore_source"]).startswith("peer:")
            or first.get("restore_bytes") != rem[-1]["save_bytes"]
            or corrupt != [(ELASTIC_STEPS, "primary")]
            or not drill["fingerprint_equals_saved"]
            or drill["steps"] != ELASTIC_DRILL_STEPS):
        faults.append(f"the peer drill: {drill}")
    metric = lambda name: max(  # noqa: E731
        (prom_value(s["/metrics"][1], name) or 0 for s in scrapes
         if s.get("/metrics") and s["/metrics"][1]), default=None)
    pushes = metric("slt_ckpt_replica_pushes_total")
    push_failures = metric("slt_ckpt_replica_push_failures_total")
    if not pushes or push_failures:
        faults.append(f"peer pushes {pushes}, failed or dropped "
                      f"{push_failures}")
    remesh_total = metric("slt_remesh_total")
    verified = metric("slt_ckpt_verified_restores_total")
    lease_expiries = metric("slt_lease_expiries_total")
    hb_failures = metric("slt_heartbeat_failures_total")
    if remesh_total != 3 or verified != 2:
        faults.append(f"/metrics: slt_remesh_total {remesh_total}, "
                      f"slt_ckpt_verified_restores_total {verified}")
    # The shard server's fetches: its span records, joined by parent to
    # the worker's client spans (which name the key), put in the window of
    # the stripe in force when they started.
    served = {x["parent_id"] for x in events.get("shard_server", [])
              if x.get("span") == "rpc/fetch"}
    wev = events.get("worker", [])
    beats = sorted(x["t0_unix_s"] for x in wev
                   if x.get("span") == "rpc/heartbeat")
    beat_gap = max((b - a for a, b in zip(beats, beats[1:])), default=None)
    stripes = sorted((x["t_unix_s"], x["rank"], x["size"]) for x in wev
                     if x.get("event") == "stripe")
    windows = [[] for _ in stripes]
    for x in wev:
        key = x.get("key", "")
        if (x.get("span") == "rpc/fetch" and x.get("span_id") in served
                and key.startswith("ds/shard-")):
            k = max((i for i, s in enumerate(stripes)
                     if s[0] <= x["t0_unix_s"]), default=0)
            windows[k].append(int(key[len("ds/shard-"):-len(".bin")]))
    if (len(windows) != 3 or not windows[1]
            or any(i % 2 for i in windows[1])
            or set(windows[2]) != set(range(n_shards))):
        faults.append(f"shard fetches by stripe window {windows}")
    kl = done["kernel_launches"]
    want = ELASTIC_LAYERS * ELASTIC_STEPS
    if (any(kl[k] != want for k in ("flash_fwd", "flash_dq", "flash_dkv"))
            or kl["cross_entropy_fwd"] or kl["cross_entropy_bwd"]):
        faults.append(f"kernel launches {kl}, expected {want} of K1-K3")
    fired = [a for s in scrapes if s.get("/alerts") and s["/alerts"][1]
             for a in json.loads(s["/alerts"][1]).get("firing", [])]
    fired = sorted({(a["alert"], a["severity"], a["message"])
                    for a in fired})
    pages = [a for a in fired if a[1] == "critical"]
    health = sorted({s["/healthz"][0] for s in scrapes if s.get("/healthz")})
    if pages or health != [200]:
        faults.append(f"alerts paged {pages[:3]}, /healthz {health}")
    for r in rem[1:]:
        peak = r["transition_peak_bytes"]
        if peak is None or peak >= 1.5 * r["save_bytes"]:
            faults.append(f"peak card memory across a transition "
                          f"{r['transition_peak_bytes']} B for a "
                          f"{r['save_bytes']} B state")
    if train_rc == 0 or not any("Error" in x for x in train_tail):
        faults.append(f"the run under a killed shard server exited "
                      f"{train_rc}: {train_tail}")
    gb = lambda b: b / 1e9 if b else None  # noqa: E731
    transitions = [{
        "epoch": r["epoch"], "stripe": r["stripe"], "step": r["step"],
        "save_s": r["save_s"], "save_store_s": r["save_io_s"],
        "save_gb": gb(r["save_bytes"]),
        "save_gbps": gbps(r["save_bytes"], r["save_s"]),
        "reform_s": r["reform_s"], "restore_s": r["restore_s"],
        "restore_store_s": r["restore_io_s"],
        "restore_source": r.get("restore_source"),
        "restore_gb": gb(r["restore_bytes"]),
        "restore_gbps": gbps(r["restore_bytes"], r["restore_s"]),
        "transition_s": sum(r[k] or 0 for k in ("save_s", "reform_s",
                                                "restore_s")),
        "step_peak_gb": gb(r["step_peak_bytes"]),
        "transition_peak_gb": gb(r["transition_peak_bytes"])}
        for r in rem]
    breakdown = done.get("badput_breakdown", {})
    emit("elastic_cluster_llama_1b_2_layers", card=card, root=where,
         layers=ELASTIC_LAYERS, batch=TRAIN_B, seq_len=TRAIN_T,
         steps=ELASTIC_STEPS, tokens_per_s=done.get("tokens_per_sec"),
         step_time_s_median=done.get("step_time_s_median"),
         phase_8b_16_layers=PHASE_8B or None, goodput=done.get("goodput"),
         data_wait_share=breakdown.get("data_wait"),
         badput_breakdown=breakdown, transitions=transitions,
         join_to_formed_s=stripes[1][0] - t_join if len(stripes) > 1
         else None,
         kill_to_formed_s=stripes[2][0] - t_kill if len(stripes) > 2
         else None,
         shard_fetches_by_window=windows,
         shard_server_bytes_served=stats.bytes_served,
         shard_server_bytes_stored=stats.bytes_stored,
         datasets={"ds": pub, "text": pub_text},
         host_buffer_populate_s=populate_s,
         host_buffer_other_thread_stall_s=stall_s,
         remesh_total=remesh_total, verified_restores=verified,
         lease_expiries=lease_expiries, heartbeat_failures=hb_failures,
         heartbeats=len(beats), heartbeat_max_gap_s=beat_gap,
         scrapes=len(scrapes), alerts_paged=len(pages),
         alerts_fired=fired, healthz=health,
         kernel_launches=kl, worker_s=worker_s,
         remesh_fingerprints=fp_checks, cache_filesystem=cache_fs,
         replica_pushes=pushes, replica_push_failures=push_failures,
         peer_drill=drill,
         killed_shard_server_run={"exit": train_rc, "steps": train_steps,
                                  "seconds_to_exit": killed_run_s,
                                  "last_lines": train_tail},
         phase_s=time.perf_counter() - t_phase)
    if faults:
        fail("phase 13: " + "; ".join(faults))
    return kl


# ------------------------------------------------------------------ QLoRA --

# The JAX package's single-card 8B fine-tuning rung (benchmarks/ladder.py
# row_llama8b_real) as a user types it: full-depth llama_8b, an int8 frozen
# base, bf16 LoRA of rank 16 on q/v, remat, batch 4 x 1024, adamw at 2e-4;
# 2 warm-up steps and 5 timed ones.
QLORA_8B_ARGS = [
    "train", "--model", "llama_8b",
    "--set", "model_overrides.quant=int8",
    "--set", "model_overrides.lora_rank=16",
    "--set", f"model_overrides.max_seq_len={QLORA_SEQ}",
    "--set", "model_overrides.param_dtype=bfloat16",
    "--set", "train.remat=true",
    "--batch-size", str(QLORA_BATCH), "--seq-len", str(QLORA_SEQ),
    "--lr", "2e-4", "--steps", "7"]
QLORA_WARMUP = 2
# K6 a step: 32 blocks x 7 projections, each run again by remat in the
# backward, and lm_head once.
QLORA_K6_PER_STEP = 2 * 32 * 7 + 1
QLORA_BASE_COPIES = ("layer_0.attn.q_proj.kernel_q",
                     "layer_31.mlp.down_proj.kernel_q", "lm_head.scale")


def kernels_under(torch, prof, match):
    """us of the device kernels that CPU events whose name holds ``match``
    (autograd nodes, record_function ranges) launched, themselves or through
    the ops under them, by kernel name; None where no such event was
    recorded."""
    roots = [e for e in prof.events() if match in e.name
             and e.device_type == torch.autograd.DeviceType.CPU]
    if not roots:
        return None
    seen, out, stack = set(), {}, list(roots)
    while stack:
        e = stack.pop()
        if e.id in seen:
            continue
        seen.add(e.id)
        for k in e.kernels:
            if k.name not in ANNOTATIONS:
                out[k.name] = out.get(k.name, 0.0) + k.duration
        stack.extend(e.cpu_children)
    return out


def is_cublas(name: str) -> bool:
    # cuBLAS's Hopper kernels are named nvjet_* or *gemm*.
    return "nvjet" in name or "gemm" in name


def qlora_profile(torch, prof, card):
    """Phase 11e: one profiled QLoRA step split into K6, the dx products
    (QuantMatmul's backward, its "quant_matmul_dx" range: the scale, the
    weight's conversion and cuBLAS's product), the rest of cuBLAS,
    dense attention (its forward range, and the backward's Bmm, Softmax
    and MaskedFill nodes), the other kernels (elementwise work: casts,
    norms, rope, silu, the loss, the optimizer) and the idle share."""
    span, busy, k6, by_name, kern = device_time(torch, prof, "quant_")
    cublas = sum(v for k, v in by_name.items() if is_cublas(k))
    dx = kernels_under(torch, prof, "quant_matmul_dx") or {}
    dx_cublas = sum(v for k, v in dx.items() if is_cublas(k))
    attn = {}
    for match in ("dense_attention", "BmmBackward", "SoftmaxBackward",
                  "MaskedFillBackward"):
        for k, v in (kernels_under(torch, prof, match) or {}).items():
            attn[k] = attn.get(k, 0.0) + v
    attn_us = sum(attn.values())
    attn_cublas = sum(v for k, v in attn.items() if is_cublas(k))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = dict(step_span_ms=span / 1e3, device_busy_ms=busy / 1e3,
               device_idle_share=1 - busy / span, k6_ms=k6 / 1e3,
               dx_ms=sum(dx.values()) / 1e3, dx_cublas_ms=dx_cublas / 1e3,
               dx_kernels_attributed=bool(dx),
               cublas_ms=cublas / 1e3,
               cublas_other_ms=(cublas - dx_cublas - attn_cublas) / 1e3,
               dense_attention_ms=attn_us / 1e3,
               dense_attention_cublas_ms=attn_cublas / 1e3,
               other_kernels_ms=(busy - k6 - cublas - (attn_us - attn_cublas)
                                 - (sum(dx.values()) - dx_cublas)) / 1e3,
               device_kernels=len(kern),
               top_kernels_ms=[(k[:90], v / 1e3) for k, v in top])
    emit("where_time_goes_llama_8b_qlora_train", card=card,
         batch=QLORA_BATCH, seq_len=QLORA_SEQ, **out)
    return out


def qlora_step_profile(torch, card, trainer, state, batch):
    """Phase 11e: one QLoRA step under torch.profiler, dense attention in
    its record_function range; the split of its device time. Returns the
    state after the step and the split."""
    from torch.profiler import record_function

    from serverless_learn_tpu_torch.models import transformer
    from serverless_learn_tpu_torch.ops import attention

    real_dense = attention.xla_attention

    def ranged(*a, **kw):
        with record_function("dense_attention"):
            return real_dense(*a, **kw)

    attention.xla_attention = transformer.xla_attention = ranged
    try:
        torch.cuda.synchronize()
        with profiled() as prof:
            state, m = trainer.step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
    finally:
        attention.xla_attention = transformer.xla_attention = real_dense
    split = qlora_profile(torch, prof, card)
    del prof
    return state, split


def qlora_8b(torch, card, ab=False):
    """Phase 11: the JAX package's QLoRA rung at full depth. 11a: the
    state filled in place on the card in the int8 layout
    (``random_quantized_params``), 7 adamw steps through run_training (2
    warm-up, 5 timed), K6 and the other kernels counted around the run;
    11b: one batch's adapter gradients through K6 against the plain
    version on the card, then one block's (``qlora_block_grads``); 11c:
    two steps each of adafactor, lion and
    rmsprop over the adapters from the same state; 11d: the state saved
    with the checkpointer and restored in place into a fresh trainer, bit
    for bit; 11e: one step under torch.profiler. Returns its K6 counts and
    the profile's split."""
    import dataclasses
    import os
    import shutil

    from serverless_learn_tpu_torch.cli import _train_config, build_parser
    from serverless_learn_tpu_torch.config import OptimizerConfig
    from serverless_learn_tpu_torch.inference.quantize import (
        random_quantized_params)
    from serverless_learn_tpu_torch.models import transformer
    from serverless_learn_tpu_torch.ops import attention
    from serverless_learn_tpu_torch.ops import cross_entropy as ce
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.ops import quant_matmul as qm
    from serverless_learn_tpu_torch.training import checkpoint as ckpt_mod
    from serverless_learn_tpu_torch.training.loop import (make_source,
                                                          run_training)
    from serverless_learn_tpu_torch.training.optimizer import make_optimizer
    from serverless_learn_tpu_torch.training.train_state import TrainState
    from serverless_learn_tpu_torch.training.train_step import (Trainer,
                                                                build_trainer)
    from serverless_learn_tpu_torch.utils.serialization import (
        leaves_with_paths)

    t_phase = time.perf_counter()
    cfg = _train_config(build_parser().parse_args(QLORA_8B_ARGS))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = build_trainer(cfg, "cuda")
    state = trainer.init(fill=random_quantized_params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mcfg, model = trainer.bundle.cfg, state.model
    named = dict(model.named_parameters())
    frozen = [n for n, p in named.items() if not p.requires_grad]
    adapters = [n for n, p in named.items() if p.requires_grad]
    lora = [named[n] for n in adapters]
    base = [n for n in frozen if n.endswith(".kernel_q")
            or (n.endswith(".scale") and n.split(".")[-2] in (
                "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj", "lm_head"))]
    int8_params = sum(named[n].numel() for n in base
                      if named[n].dtype == torch.int8)
    sums_before = checksums(torch, model, frozen)
    copies = {n: named[n].detach().cpu().clone() for n in QLORA_BASE_COPIES}

    def base_changed():
        after = checksums(torch, model, frozen)
        out = [n for n in frozen if after[n] != sums_before[n]]
        return out + [n for n in QLORA_BASE_COPIES
                      if not torch.equal(named[n].detach().cpu(), copies[n])]

    # -- 11a ----------------------------------------------------------------
    counts = {"dense_attention": 0}
    real_dense = attention.xla_attention

    def counting_dense(*a, **kw):
        counts["dense_attention"] += 1
        return real_dense(*a, **kw)

    kernels = (qm.quant_matmul, fa.flash_fwd, fa.flash_dq, fa.flash_dkv,
               ce.cross_entropy_fwd, ce.cross_entropy_bwd)
    for k in kernels:
        k.launches = 0
    tilings0 = k6_tilings(qm.quant_matmul)
    torch.cuda.reset_peak_memory_stats()
    attention.xla_attention = transformer.xla_attention = counting_dense
    try:
        state, meter = run_training(cfg, trainer=trainer, state=state)
    finally:
        attention.xla_attention = transformer.xla_attention = real_dense
    launches = {k.__name__: k.launches for k in kernels}
    tilings = tilings_since(qm.quant_matmul, tilings0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = cfg.train.num_steps
    losses = [s.metrics["loss"] for s in meter.history]
    norms = [s.metrics["grad_norm"] for s in meter.history]
    summary = meter.steady_state(skip=QLORA_WARMUP)
    opt = state.opt_state
    opt_bytes = sum(t.numel() * t.element_size()
                    for m in ("mu", "nu") for t in opt[m])
    want = {"quant_matmul": QLORA_K6_PER_STEP * steps}
    want.update({k.__name__: 0 for k in kernels[1:]})
    changed = base_changed()
    emit("train_llama_8b_qlora", card=card, command=QLORA_8B_ARGS,
         layers=mcfg.n_layers, d_model=mcfg.d_model, vocab=mcfg.vocab_size,
         lora_rank=mcfg.lora_rank, params=sum(p.numel()
                                              for p in named.values()),
         int8_params=int8_params, adapter_tensors=len(adapters),
         adapter_params=sum(p.numel() for p in lora),
         batch=cfg.train.batch_size, seq_len=cfg.data.seq_len, steps=steps,
         init_s=init_s, init_peak_gb=init_peak_gb, losses=losses,
         grad_norms=norms, step_times_s=[s.step_time_s
                                         for s in meter.history],
         timed_steps=steps - QLORA_WARMUP,
         mean_step_s=summary["step_time_s"],
         tokens_per_s=summary["tokens_per_sec"], mfu=summary.get("mfu"),
         model_flops_per_step=meter.flops_per_step,
         max_memory_allocated_gb=peak_gb, launches=launches,
         expected_launches=want,
         k6_launches_per_step=launches["quant_matmul"] / steps,
         k6_launches_by_tiling=tilings,
         dense_attention_calls=counts["dense_attention"],
         optimizer_state_tensors={m: len(opt[m]) for m in ("mu", "nu")},
         optimizer_state_dtype=str(opt["mu"][0].dtype),
         optimizer_state_bytes=opt_bytes, frozen_changed=changed)
    if not all(math.isfinite(x) for x in losses + norms):
        fail(f"QLoRA: non-finite loss or grad norm: {losses}, {norms}")
    if launches != want:
        fail(f"QLoRA launched {launches}, expected {want}")
    # Every projection at 4 x 1,024 rows takes the wgmma prefill tiling.
    if tilings and tilings != {"prefill": want["quant_matmul"]}:
        fail(f"QLoRA's K6 launches by tiling {tilings}, expected all "
             f"{want['quant_matmul']} on the wgmma prefill")
    if counts["dense_attention"] != 2 * mcfg.n_layers * steps:
        fail(f"QLoRA: dense attention ran {counts['dense_attention']} "
             f"times, expected {2 * mcfg.n_layers * steps} (T = "
             f"{QLORA_SEQ} is under the flash threshold; remat runs twice)")
    if changed:
        fail(f"QLoRA: {len(changed)} frozen tensors changed, e.g. "
             f"{changed[:3]}")
    if (len(opt["mu"]) != LORA_8B_ADAPTER_TENSORS
            or sum(t.numel() for t in opt["mu"]) != LORA_8B_ADAPTER_PARAMS
            or any(t.dtype != torch.bfloat16 for t in opt["mu"] + opt["nu"])):
        fail(f"QLoRA optimizer state: {len(opt['mu'])} tensors of "
             f"{sum(t.numel() for t in opt['mu'])} params, expected "
             f"{LORA_8B_ADAPTER_TENSORS} bf16 adapter tensors of "
             f"{LORA_8B_ADAPTER_PARAMS}")

    batch = trainer.place(next(iter(make_source(cfg, trainer,
                                                start_step=state.step))))
    if ab:  # --qlora-only: the timed steps above and the profiled one
        state, split = qlora_step_profile(torch, card, trainer, state, batch)
        emit("qlora_phase", card=card, seconds=time.perf_counter() - t_phase)
        return dict(launches=launches["quant_matmul"],
                    per_step=QLORA_K6_PER_STEP, profile=split)

    # -- 11b ----------------------------------------------------------------

    def grads():
        for p in lora:
            p.grad = None
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = trainer.bundle.loss_fn(model, batch)
        loss.backward()
        value = float(loss.detach())
        torch.cuda.synchronize()
        out = dict(s=time.perf_counter() - t, loss=value,
                   grads=[p.grad.detach().float() for p in lora])
        for p in lora:
            p.grad = None
        return out

    def split_reference(x, wq, scale, out_dtype=None):
        """The plain version with the contraction summed in two halves."""
        h = wq.shape[0] // 2
        xf = x.to(torch.bfloat16).float()
        y = (xf[..., :h] @ wq[:h].to(torch.bfloat16).float()
             + xf[..., h:] @ wq[h:].to(torch.bfloat16).float())
        return (y * scale).to(x.dtype)

    def convert_form(x, wq, scale, out_dtype=None):
        """The reference package's default QLoRA form: convert, bf16
        product, then the scale in x's dtype."""
        return (x @ wq.to(x.dtype)) * scale.to(x.dtype)

    qm.quant_matmul.launches = 0
    k6a, k6b = grads(), grads()
    k6_launches = qm.quant_matmul.launches
    alt = {}
    real_qm = qm.quant_matmul
    for name, fn in (("plain", qm.quant_matmul_reference),
                     ("plain_split_sum", split_reference),
                     ("convert_form", convert_form)):
        qm.quant_matmul = fn
        try:
            alt[name] = grads()
        finally:
            qm.quant_matmul = real_qm

    def rel(a, b):
        return [((x - y).norm() / y.norm().clamp_min(1e-30)).item()
                for x, y in zip(a["grads"], b["grads"])]

    plain = alt["plain"]
    k6_rel = rel(k6a, plain)
    floors = {n: rel(alt[n], plain) for n in ("plain_split_sum",
                                              "convert_form")}
    limit = 2 * max(floors["plain_split_sum"])
    zero = [n for n, g in zip(adapters, k6a["grads"])
            if not bool(g.abs().max() > 0)]
    repeat = all(torch.equal(a, b) for a, b in zip(k6a["grads"],
                                                   k6b["grads"]))
    emit("qlora_grads_k6_vs_plain", card=card, batch=QLORA_BATCH,
         seq_len=QLORA_SEQ, k6_loss=k6a["loss"], plain_loss=plain["loss"],
         loss_rel_diff=abs(k6a["loss"] - plain["loss"]) / abs(plain["loss"]),
         k6_s=[k6a["s"], k6b["s"]], plain_s=plain["s"],
         k6_launches=k6_launches,
         k6_max_grad_rel_diff=max(k6_rel),
         k6_median_grad_rel_diff=statistics.median(k6_rel),
         floor_max={n: max(v) for n, v in floors.items()},
         floor_median={n: statistics.median(v) for n, v in floors.items()},
         limit=limit, repeat_bit_identical=repeat, zero_grads=zero,
         worst_tensors=sorted(zip(k6_rel, adapters), reverse=True)[:3],
         min_adapter_grad_norm=min(g.norm().item() for g in k6a["grads"]),
         tolerance="each adapter's gradient through K6 within 2x the "
                   "largest relative distance (over the adapters) of the "
                   "plain version summed in two halves from the plain "
                   "version: K6 and the halves both take the plain "
                   "version's exact products and add them in f32 in "
                   "another order, so both part from it by bf16 rounding "
                   "of those sums, grown through 32 layers; measured in "
                   "this run. The reference's convert-then-bf16-matmul "
                   "form, which rounds twice, is printed beside it. "
                   "Through 32 random layers that floor is tens of "
                   "percent, so this catches only a gross fault (a zero, "
                   "a non-repeating or a wildly wrong gradient); the "
                   "accuracy check is one block's (qlora_block_grads)")
    if k6_launches != 2 * QLORA_K6_PER_STEP:
        fail(f"11b: K6 launched {k6_launches} times for two gradients, "
             f"expected {2 * QLORA_K6_PER_STEP}")
    if zero or not repeat or not max(k6_rel) <= limit:
        fail(f"11b: K6 gradients {max(k6_rel):.3g} from the plain version "
             f"(limit {limit:.3g}), zero gradients {zero[:3]}, repeat "
             f"{repeat}")
    del k6a, k6b, alt, plain
    qlora_block_grads(torch, card, model, batch, split_reference)

    # -- 11c ----------------------------------------------------------------
    snapshot = [p.detach().clone() for p in lora]
    source = iter(make_source(cfg, trainer, start_step=state.step + 1))
    two = [trainer.place(next(source)) for _ in range(2)]
    others = {}
    for name in ("adafactor", "lion", "rmsprop"):
        ocfg = OptimizerConfig(name=name, learning_rate=2e-4)
        tr = Trainer(config=dataclasses.replace(cfg, optimizer=ocfg),
                     bundle=trainer.bundle, device=trainer.device,
                     optimizer=make_optimizer(ocfg))
        st = TrainState(step=0, model=model,
                        opt_state=tr.init_opt_state(model))
        run = []
        for b in two:
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, m = tr.step(st, b)
            run.append((float(m["loss"]), time.perf_counter() - t))
        moved = sum(not torch.equal(p, q) for p, q in zip(lora, snapshot))
        state_bytes = sum(t.numel() * t.element_size()
                          for v in st.opt_state.values()
                          if isinstance(v, list) for t in v
                          if isinstance(t, torch.Tensor))
        others[name] = dict(losses=[r[0] for r in run],
                            step_s=[r[1] for r in run],
                            adapters_moved=moved,
                            optimizer_state_bytes=state_bytes)
        with torch.no_grad():
            for p, q in zip(lora, snapshot):
                p.copy_(q)
        del st, tr
    changed = base_changed()
    emit("qlora_other_optimizers", card=card, **others,
         frozen_changed=changed)
    bad = {n: r for n, r in others.items()
           if not all(math.isfinite(x) for x in r["losses"])
           or r["adapters_moved"] == 0}
    if bad or changed:
        fail(f"11c: {bad}; frozen tensors changed {changed[:3]}")
    del snapshot, two

    # -- 11d ----------------------------------------------------------------
    state_bytes = sum(t.numel() * t.element_size() for _, t in
                      leaves_with_paths(trainer.state_tree(state)))
    root = checkpoint_dir(3 * state_bytes, "slt-phase11-")
    try:
        ck = ckpt_mod.Checkpointer(ckpt_mod.LocalStore(root), name="qlora")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(trainer.state_tree(state))
        save_s = time.perf_counter() - t0
        ck.wait()
        saved_s = time.perf_counter() - t0
        timings = dict(ck.timings)
        blob = os.path.join(root, "qlora", f"step-{state.step:010d}")
        blob_bytes = os.path.getsize(blob)
        fresh = build_trainer(cfg, "cuda")
        fstate = fresh.init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = fresh.state_tree(fstate)
        ck.restore(tree)
        fresh.load_tree(fstate, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        ck.close()
        live = list(leaves_with_paths(trainer.state_tree(state)))
        back = list(leaves_with_paths(fresh.state_tree(fstate)))
        differ = [p for (p, a), (q, b) in zip(live, back)
                  if p != q or not same_bits(torch, a, b)]
        int8_leaves = sum(a.dtype == torch.int8 for _, a in live)
        emit("qlora_checkpoint", card=card, state_bytes=state_bytes,
             blob_bytes=blob_bytes, leaves=len(live),
             int8_leaves=int8_leaves, save_call_s=save_s,
             save_total_s=saved_s,
             save_sync_s=timings.get("save_sync_s"),
             save_sync_gb_per_s=gbps(blob_bytes, timings.get("save_sync_s")),
             upload_s=timings.get("upload_s"),
             upload_gb_per_s=gbps(blob_bytes, timings.get("upload_s")),
             restore_s=restore_s, restore_gb_per_s=gbps(blob_bytes,
                                                        restore_s),
             restored_step=fstate.step, bit_identical=not differ)
        if (differ or len(live) != len(back) or fstate.step != state.step
                or fstate.opt_state["count"] != state.opt_state["count"]
                or int8_leaves != 7 * mcfg.n_layers + 1):
            fail(f"11d: restored QLoRA state differs: {differ[:5]}, step "
                 f"{fstate.step} vs {state.step}, {int8_leaves} int8 leaves")
        del fresh, fstate, tree, live, back
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- 11e ----------------------------------------------------------------
    state, split = qlora_step_profile(torch, card, trainer, state, batch)
    emit("qlora_phase", card=card, seconds=time.perf_counter() - t_phase)
    del state, trainer, batch, model, named, lora, copies
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches["quant_matmul"],
                per_step=QLORA_K6_PER_STEP, profile=split)


def qlora_block_grads(torch, card, model, batch, split_reference):
    """Phase 11b, the accuracy check: layer 0 of the trained QLoRA model at
    full width (the batch's embeddings in, a seeded cotangent out), where
    rounding does not grow through 32 layers. Its input gradient's branch
    part (dx - dy; the residual passes dy unchanged) and its adapters'
    gradients through K6 against the plain version on the card, within 2x
    the plain version summed in two halves; fails too unless the same
    block with ``QuantMatmul``'s dx 5 % too large fails that limit in
    every tensor."""
    from serverless_learn_tpu_torch.models import transformer
    from serverless_learn_tpu_torch.ops import quant_matmul as qm

    block = model.layers[0]
    names = [n for n, p in block.named_parameters() if p.requires_grad]
    lora = [p for p in block.parameters() if p.requires_grad]
    with torch.no_grad():
        x0 = model.embedder(batch["tokens"])
    B, T, _ = x0.shape
    positions = torch.arange(T, device=x0.device)[None, :].expand(B, T)
    sin, cos = transformer.rope_angles(positions, model.cfg.head_dim,
                                       model.cfg.rope_theta)
    g = torch.Generator(device=x0.device).manual_seed(3)
    dy = torch.randn(x0.shape, generator=g, device=x0.device).to(x0.dtype)

    def grads():
        x = x0.detach().clone().requires_grad_()
        block(x, sin, cos)[0].backward(dy)  # (x, no MoE aux)
        out = ([x.grad.float() - dy.float()]
               + [p.grad.detach().float() for p in lora])
        for p in lora:
            p.grad = None
        return out

    class Off(qm.QuantMatmul):
        """``QuantMatmul`` with a dx 5 % too large."""

        @staticmethod
        def backward(ctx, dy):
            dx, _, _ = qm.QuantMatmul.backward(ctx, dy)
            return dx * 1.05, None, None

    k6a, k6b = grads(), grads()
    with Patched((transformer, "QuantMatmul", lambda real: Off)):
        off = grads()
    alt = {}
    for name, fn in (("plain", qm.quant_matmul_reference),
                     ("plain_split_sum", split_reference)):
        with Patched((qm, "quant_matmul", lambda real: fn)):
            alt[name] = grads()

    def rel(a, b):
        return [((x - y).norm() / y.norm().clamp_min(1e-30)).item()
                for x, y in zip(a, b)]

    plain = alt["plain"]
    k6_rel, off_rel = rel(k6a, plain), rel(off, plain)
    floor = rel(alt["plain_split_sum"], plain)
    limit = 2 * max(floor)
    repeat = all(torch.equal(a, b) for a, b in zip(k6a, k6b))
    leaves = ["dx_minus_dy"] + names
    zero = [n for n, t in zip(leaves, k6a) if not bool(t.abs().max() > 0)]
    emit("qlora_block_grads_k6_vs_plain", card=card, block="layers.0",
         rows=B * T, leaves=leaves, k6_rel_diff=k6_rel,
         floor_rel_diff=floor, limit=limit, dx_5pct_off_rel_diff=off_rel,
         repeat_bit_identical=repeat, zero_grads=zero,
         tolerance="each tensor through K6 within 2x the largest relative "
                   "distance (over the tensors) of the plain version "
                   "summed in two halves from the plain version, measured "
                   "in this run; the same block with dx 5 % off must "
                   "exceed it in every tensor")
    if zero or not repeat or not max(k6_rel) <= limit:
        fail(f"11b block: K6 {max(k6_rel):.3g} from the plain version "
             f"(limit {limit:.3g}), zero {zero}, repeat {repeat}")
    if not min(off_rel) > limit:
        fail(f"11b block: the limit {limit:.3g} passes a dx 5 % off "
             f"({min(off_rel):.3g} in {leaves[off_rel.index(min(off_rel))]})")


# The tensor-core kernels of each source, as parts of their mangled names
# in ptxas's report: every function that holds one may not spill, and each
# must appear.
NO_SPILL = {
    "flash_attention": [f"{kern}ILi{d}E" for kern in (
        "flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")
        for d in (32, 64, 128)],
    "quant_matmul": ["quant_decodeI", "quant_prefillI", "quant_prefill_mmaI",
                     "quant_reduceI"],
}


def ptxas_summary(reports):
    """Each source's ptxas lines on registers and spills, by function."""
    return {name: [ln.split("ptxas info    : ")[-1].strip()
                   for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln
                   or "Function properties" in ln]
            for name, log in reports.items()}


def spill_faults(log: str, kernels):
    """What keeps ``kernels`` from passing the no-spill gate in an ``nvcc
    -Xptxas -v`` report: each that the report does not show, and each
    function holding one that spills, with its spill stores and loads."""
    spills, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for " in ln:
            fn = ln.split("Function properties for ")[-1].strip()
        elif "spill stores" in ln and fn is not None:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            if len(nums) == 3:
                spills[fn] = (nums[1], nums[2])
    faults = {}
    for kern in kernels:
        found = {fn: v for fn, v in spills.items() if kern in fn}
        if not found:
            faults[kern] = "not in the report"
        faults.update({fn: v for fn, v in found.items() if v != (0, 0)})
    return faults


def quant_matmul_only(torch, qm, build, card) -> int:
    """Phases 4 and 9b alone, for whichever kernel the package beside this
    file builds: its decode, prefill, QLoRA and Mixtral prefill times,
    then llama_8b int8's prefill forward and decode steps with their
    profiles."""
    from serverless_learn_tpu_torch.models.registry import build_model

    build.load("quant_matmul")
    time_kernel(torch, qm, card)
    time_kernel(torch, qm, card, R=PREFILL_ROWS)
    time_kernel(torch, qm, card, R=QLORA_ROWS)
    time_kernel(torch, qm, card, R=MOE_PREFILL_ROWS,
                shapes=MIXTRAL_PREFILL_SHAPES, label="mixtral_prefill")
    model = build_model("llama_8b", device="cuda", quant="int8", seed=0)
    where_time_goes(torch, model, serve_prompts(torch, model.cfg.vocab_size),
                    card)
    return 0


def qlora_only(torch, qm, build, card) -> int:
    """Phase 11a (the QLoRA step, timed) and 11e (its profile) alone, for
    whichever K6 the package beside this file builds."""
    build.load("quant_matmul")
    qlora_8b(torch, card, ab=True)
    return 0


def flash_only(torch, build, card) -> int:
    """Phases 6, 7 and 8b alone, for whichever flash kernels the package
    beside this file builds: their checks against the plain versions, their
    times at both shapes beside the yardsticks and the dense crossover, and
    llama_1b's training step. The ptxas report is printed, not gated: the
    kernels' names differ between commits."""
    emit("build", card=card,
         ptxas=ptxas_summary(build.build(["flash_attention"])))
    build.load("flash_attention")
    check_flash(torch, card)
    time_flash(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    train_full_width(torch, card)
    return 0


def train_only(torch, build, card) -> int:
    """Phase 8b, then phase 10's ``train`` command for 5 steps without a
    checkpoint directory (its ``done`` line: the steady step time)."""
    build.load("flash_attention")
    train_full_width(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    done = run_cli(["train", *CKPT_TRAIN, "--steps", "5"])
    emit("train_command_llama_1b", card=card, **done)
    return 0


# --ckpt-train-only's steps: at ~0.30 s a step, over 60 s of steady steps,
# with the periodic save past the last step (only the final save runs).
CKPT_AB_STEPS = 250


def ckpt_train_only(torch, build, card) -> int:
    """Phase 10's ``train`` with ``--checkpoint-dir`` at the defaults (the
    emergency save armed wherever the package beside this file has one,
    its shadow refreshed at most once per
    ``checkpoint.emergency_min_interval_s``), CKPT_AB_STEPS steps and no
    periodic save among them, for an A/B of the checkpoint path's steady
    tokens/s between commits. The window is the step meter's steps 3 on
    (record to record, so a refresh's stall lands in the next step)."""
    import os
    import shutil

    from serverless_learn_tpu_torch.training import loop

    build.load("flash_attention")
    root = checkpoint_dir(free_bytes=25e9, prefix="slt-ckpt-ab-")
    kept = {}

    def keep_run(real):
        def run(*a, **k):
            state, meter = real(*a, **k)
            kept["meter"] = meter
            return state, meter
        return run

    t0 = time.perf_counter()
    try:
        with Patched((loop, "run_training", keep_run)):
            done = run_cli(["train", *CKPT_TRAIN, "--steps",
                            str(CKPT_AB_STEPS), "--checkpoint-every",
                            str(CKPT_AB_STEPS + 1), "--checkpoint-dir",
                            root])
        command_s = time.perf_counter() - t0
        saved = sorted(os.listdir(os.path.join(root, "ckpt")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    times = [s.step_time_s for s in kept["meter"].history]
    window = times[2:]
    med = statistics.median(window)
    emit("ckpt_train_command_llama_1b", card=card, steps=len(times),
         window_steps=len(window), window_s=sum(window),
         tokens_per_s=TRAIN_B * TRAIN_T * len(window) / sum(window),
         step_median_s=med,
         held_steps=[[i + 1, t] for i, t in enumerate(times)
                     if i >= 2 and t > 2 * med],
         step1_s=times[0], step2_s=times[1], command_s=command_s,
         committed=saved, done_tokens_per_sec=done.get("tokens_per_sec"),
         done_step_time_s=done.get("step_time_s"),
         goodput=done.get("goodput"),
         badput_breakdown=done.get("badput_breakdown"))
    if len(times) != CKPT_AB_STEPS:
        fail(f"--ckpt-train-only: {len(times)} steps")
    return 0


SERVE_ONLY_ROUNDS = 3  # timed decode rounds of --serve-only


def serve_only(torch, build, card) -> int:
    """Phase 9c's decode round alone, for an A/B of the continuous decode
    step between commits: llama_8b int8 through GenerationServer's
    defaults (whatever telemetry the package beside this file has on by
    default), the decode buckets captured by ``warm_shapes``, phase 9's
    prompts served once, then SERVE_ONLY_ROUNDS rounds of them again with
    DECODE_ROUND new tokens each (prefix hits, as phase 9c's round). The
    decode time per token is the host clock between the harvests of two
    decode chunks dispatched one after the other, over chunk_size."""
    from serverless_learn_tpu_torch.inference.server import (GenerationServer,
                                                            request)
    from serverless_learn_tpu_torch.models.registry import build_model

    build.load("quant_matmul")
    model = build_model("llama_8b", device="cuda", quant="int8", seed=0)
    prompts = serve_prompts(torch, model.cfg.vocab_size)
    server = GenerationServer(model, port=0).start()
    eng = server.engine
    harvests = []
    harvest = eng._harvest

    def timed_harvest(fut):
        harvest(fut)
        harvests.append((fut[0], time.perf_counter()))

    eng._harvest = timed_harvest
    rounds = []
    try:
        eng.warm_shapes([(PROMPT_LEN, DECODE_ROUND)])
        for r in range(SERVE_ONLY_ROUNDS + 1):
            replies = [None] * SERVE_BATCH

            def client(i):
                replies[i] = request(server.addr, {
                    "prompt": prompts[i], "max_new_tokens": DECODE_ROUND},
                    timeout=600)

            t1 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(SERVE_BATCH)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            wall = time.perf_counter() - t1
            if any(x is None or len(x.get("new_tokens", ())) != DECODE_ROUND
                   for x in replies):
                fail(f"--serve-only: malformed replies {str(replies)[:300]}")
            log = [h for h in harvests if h[1] >= t1]
            per_tok = [(b[1] - a[1]) * 1e3 / eng.chunk_size
                       for a, b in zip(log, log[1:])
                       if a[0] == b[0] == "pchunk"]
            rounds.append({"round": r, "wall_s": wall, "per_tok": per_tok})
    finally:
        server.stop()
    timed = [v for x in rounds[1:] for v in x["per_tok"]]
    emit("serve_only_decode_round", card=card, rounds=SERVE_ONLY_ROUNDS,
         decode_ms_per_token=statistics.median(timed),
         decode_ms_per_token_all=timed,
         round_wall_s=[x["wall_s"] for x in rounds],
         cold_round_per_tok=rounds[0]["per_tok"],
         harvest_telemetry_ms_per_decode_chunk=(
             eng.telemetry_host_s * 1e3 / max(eng.decode_harvests, 1)
             if hasattr(eng, "telemetry_host_s") else None))
    return 0


# ------------------------------------------------------------ numerics --

# Phase 14a's inputs: small, so the whole check takes seconds. Flash: three
# 64-row tiles, causal, two q heads a K/V head.
NF_FLASH = dict(B=1, T=192, H=4, KH=2, D=64)
NF_FLASH_CASES = [  # name, input, index, value
    ("q_nan", "q", (0, 100, 1, 5), math.nan),
    ("k_nan", "k", (0, 70, 0, 3), math.nan),
    ("v_nan", "v", (0, 70, 1, 7), math.nan),
    ("q_inf", "q", (0, 130, 2, 0), math.inf),
    ("dout_nan", "dout", (0, 150, 3, 9), math.nan),
]
NF_CE_V = 1000
NF_CE_CASES = [  # name, row, column (None: the label's), value
    ("other_nan", 1, 5, math.nan), ("other_inf", 2, 6, math.inf),
    ("label_nan", 3, None, math.nan), ("label_inf", 4, None, math.inf),
]
NF_QM = dict(I=512, O=384)
NF_QM_ROWS = (8, 40)  # K6's decode (split-K) and prefill paths


def _poisoned(inputs, key, idx, value):
    out = dict(inputs)
    out[key] = inputs[key].clone()
    out[key][idx] = value
    return out


def nonfinite_case(torch, kern, plain, inputs, key, idx, value):
    """One poisoned input through a kernel and its plain version. An
    output position depends on the poisoned element where the plain
    version's output moves when the element takes two other finite values.
    Per output: the dependent positions, the non-finite positions of each
    side, whether they are the same positions, and the faults: a dependent
    position finite on one side and not on the other, or a kernel
    non-finite where the plain version is finite. Outside the dependent
    positions the plain version may also be non-finite where the kernel is
    not: a masked (zero) weight times a NaN is NaN, and the plain versions
    multiply every masked pair, the kernels only the pairs of the tiles
    they visit."""
    bad = _poisoned(inputs, key, idx, value)
    got, ref = kern(bad), plain(bad)
    base = float(inputs[key][idx])
    lo = plain(_poisoned(inputs, key, idx, base - 1.5))
    hi = plain(_poisoned(inputs, key, idx, base + 2.5))
    torch.cuda.synchronize()
    rows, faults = {}, []
    for name, r in ref.items():
        g = got[name]
        kn, pn = ~torch.isfinite(g.float()), ~torch.isfinite(r.float())
        dep = lo[name].float() != hi[name].float()
        mismatch = int((dep & (kn != pn)).sum())
        spurious = int((~dep & kn & ~pn).sum())
        rows[name] = {"dependent": int(dep.sum()),
                      "dependent_finite": int((dep & ~pn).sum()),
                      "plain_nonfinite": int(pn.sum()),
                      "kernel_nonfinite": int(kn.sum()),
                      "same_positions": bool(torch.equal(kn, pn)),
                      "plain_only_outside_dependence": int(
                          (~dep & pn & ~kn).sum())}
        if mismatch or spurious:
            faults.append(f"{name}: {mismatch} dependent positions differ, "
                          f"{spurious} kernel-only non-finite")
    return rows, faults


def nonfinite_check(torch, card, keep_going: bool = False):
    """Phase 14a: every kernel against its plain version on inputs carrying
    NaN and +-inf, bf16 and f32 (``nonfinite_case``). ``keep_going``:
    print the faults and return (an A/B against another checkout)."""
    from serverless_learn_tpu_torch.ops import cross_entropy as ce
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.ops import quant_matmul as qm
    try:
        from serverless_learn_tpu_torch.ops import tensor_stats as ts
    except ImportError:  # a checkout from before the stats kernels
        ts = None

    g = torch.Generator(device="cuda").manual_seed(14)
    faults, results = [], []
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        B, T, H, KH, D = (NF_FLASH[k] for k in ("B", "T", "H", "KH", "D"))
        mk = lambda *shape: torch.randn(  # noqa: E731
            *shape, device="cuda", generator=g).to(dtype)
        inputs = {"q": mk(B, T, H, D), "k": mk(B, T, KH, D),
                  "v": mk(B, T, KH, D), "dout": mk(B, T, H, D)}

        def plain_fwd_bwd(x):
            out, lse = fa.flash_fwd_reference(x["q"], x["k"], x["v"],
                                              causal=True)
            delta = (x["dout"].float() * out.float()).sum(-1) \
                .permute(0, 2, 1).contiguous()
            return out, lse, delta

        def plain(x):
            out, lse, delta = plain_fwd_bwd(x)
            dq = fa.flash_dq_reference(x["q"], x["k"], x["v"], x["dout"],
                                       lse, delta, causal=True)
            dk, dv = fa.flash_dkv_reference(x["q"], x["k"], x["v"],
                                            x["dout"], lse, delta,
                                            causal=True)
            return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}

        def kern(x):
            # K2/K3 take the plain forward's lse and delta: the same inputs
            # as their plain versions.
            _, lse, delta = plain_fwd_bwd(x)
            out, klse = fa.flash_fwd(x["q"], x["k"], x["v"], causal=True)
            dq = fa.flash_dq(x["q"], x["k"], x["v"], x["dout"], lse, delta,
                             causal=True)
            dk, dv = fa.flash_dkv(x["q"], x["k"], x["v"], x["dout"], lse,
                                  delta, causal=True)
            return {"out": out, "lse": klse, "dq": dq, "dk": dk, "dv": dv}

        for name, key, idx, value in NF_FLASH_CASES:
            rows, f = nonfinite_case(torch, kern, plain, inputs, key, idx,
                                     value)
            results.append({"kernels": "K1-K3", "dtype": dt, "case": name,
                            "outputs": rows})
            faults += [f"K1-K3 {dt} {name}: {x}" for x in f]

        A, Tc = 1, 6
        ce_in = {"x": mk(A, Tc, NF_CE_V) * 3}
        labels = torch.randint(0, NF_CE_V, (A, Tc), device="cuda",
                               generator=g)
        ones = torch.ones(A, Tc, device="cuda")

        def ce_plain(x):
            loss, lse = ce.cross_entropy_fwd_reference(x["x"], labels)
            dx = ce.cross_entropy_bwd_reference(x["x"], labels, lse, ones)
            return {"loss": loss, "lse": lse, "dx": dx}

        def ce_kern(x):
            _, lse = ce.cross_entropy_fwd_reference(x["x"], labels)
            loss, klse = ce.cross_entropy_fwd(x["x"], labels)
            dx = ce.cross_entropy_bwd(x["x"], labels, lse, ones)
            return {"loss": loss, "lse": klse, "dx": dx}

        for name, row, col, value in NF_CE_CASES:
            col = int(labels[0, row]) if col is None else col
            if col == int(labels[0, row]) and "other" in name:
                col += 1
            rows, f = nonfinite_case(torch, ce_kern, ce_plain, ce_in, "x",
                                     (0, row, col), value)
            results.append({"kernels": "K4/K5", "dtype": dt, "case": name,
                            "outputs": rows})
            faults += [f"K4/K5 {dt} {name}: {x}" for x in f]

        wq = torch.randint(-127, 128, (NF_QM["I"], NF_QM["O"]),
                           device="cuda", generator=g).to(torch.int8)
        scale = torch.rand(NF_QM["O"], device="cuda", generator=g) * 0.02
        for R in NF_QM_ROWS:
            qm_in = {"x": mk(R, NF_QM["I"])}
            rows, f = nonfinite_case(
                torch, lambda x: {"y": qm.quant_matmul(x["x"], wq, scale)},
                lambda x: {"y": qm.quant_matmul_reference(x["x"], wq, scale,
                                                          x["x"].dtype)},
                qm_in, "x", (3, 100), math.nan)
            results.append({"kernels": "K6", "dtype": dt, "case": f"x_nan "
                            f"rows={R}", "outputs": rows})
            faults += [f"K6 {dt} rows={R}: {x}" for x in f]

        if ts is None:
            continue
        x = mk(300_001)
        x[11], x[150_000], x[299_999] = math.nan, math.inf, -math.inf

        def stats(t, fn):
            rows = torch.empty(ts.grid_for(t.numel()), ts.KCOLS,
                               dtype=torch.float64, device="cuda")
            fn(t, rows, base=7, chunk=100_000, chunks=4, scale=0.5)
            return ts.stats_reduce_reference(rows, [0, rows.shape[0]],
                                             torch.empty_like(rows[:1]))[0]

        def many(t, rows, **kw):
            # the same tensor as the second of two in one launch
            head = mk(5000)
            buf = torch.empty(ts.grid_for(5000) + rows.shape[0], ts.KCOLS,
                              dtype=torch.float64, device="cuda")
            ts.tensor_stats_many([head, t], buf, [0, ts.grid_for(5000)],
                                 [0, kw["base"]], [kw["chunk"]] * 2,
                                 chunks=kw["chunks"], scale=kw["scale"])
            rows.copy_(buf[ts.grid_for(5000):])

        ref = stats(x, ts.tensor_stats_reference)
        lim = ts.kernel_tolerance(ref, x.numel())
        finite = [c for c in range(ts.KCOLS) if c != ts.SUMSQ_ALL]
        ok = True
        for fn in (ts.tensor_stats, many):
            got = stats(x, fn)
            ok = ok and math.isnan(float(got[ts.SUMSQ_ALL])) and \
                math.isnan(float(ref[ts.SUMSQ_ALL])) and bool(
                    ((got - ref).abs() <= lim)[finite].all())
        results.append({"kernels": "tensor_stats", "dtype": dt,
                        "case": "nan_inf", "counts": [float(got[ts.NAN]),
                                                      float(got[ts.INF])],
                        "same": ok})
        if not ok:
            faults.append(f"tensor_stats {dt}: {got.tolist()} vs "
                          f"{ref.tolist()}")
    for r in results:
        emit("numerics_nonfinite_check", card=card, **r)
    emit("numerics_nonfinite_summary", card=card, cases=len(results),
         faults=faults)
    if faults and not keep_going:
        fail("phase 14a: " + "; ".join(faults))
    return len(results)


NUMERICS_STEPS, NUMERICS_CADENCE = 12, 4


def numerics_run(torch, enabled: bool, profile: bool = True):
    """llama_1b at full width, 12 adamw steps (lr 1e-3, clip 1.0, seed 0)
    through run_training, with or without numerics at cadence 4, on a
    fresh registry and goodput ledger; counters read around the run; with
    ``profile``, one more step under the profiler."""
    from serverless_learn_tpu_torch.config import (DataConfig,
                                                   ExperimentConfig,
                                                   NumericsConfig,
                                                   OptimizerConfig,
                                                   TrainConfig)
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.ops import tensor_stats as ts
    from serverless_learn_tpu_torch.telemetry.goodput import PhaseLedger
    from serverless_learn_tpu_torch.telemetry.registry import MetricsRegistry
    from serverless_learn_tpu_torch.training.loop import run_training
    from serverless_learn_tpu_torch.training.train_step import build_trainer

    cfg = ExperimentConfig(
        model="llama_1b",
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                  grad_clip_norm=1.0),
        train=TrainConfig(batch_size=TRAIN_B, num_steps=NUMERICS_STEPS,
                          seed=0),
        data=DataConfig(seq_len=TRAIN_T),
        numerics=NumericsConfig(enabled=enabled, cadence=NUMERICS_CADENCE))
    from serverless_learn_tpu_torch.telemetry import numerics
    from serverless_learn_tpu_torch.training import optimizer

    trainer = build_trainer(cfg, "cuda")
    state = trainer.init()
    n_tensors = sum(1 for p in state.model.parameters() if p.requires_grad)
    reg, led = MetricsRegistry(), PhaseLedger()
    # The host's time in the optimizer and in the step's numerics calls.
    host_s = {}

    def timed(name):
        def wrap(real):
            def run(*a, **k):
                t0 = time.perf_counter()
                try:
                    return real(*a, **k)
                finally:
                    host_s[name] = host_s.get(name, 0.0) + (
                        time.perf_counter() - t0)
            return run
        return wrap
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv, ts.tensor_stats,
               ts.tensor_stats_many, ts.stats_reduce)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Patched((optimizer.Optimizer, "update", timed("optimizer")),
                 (numerics.StepNumerics, "grads", timed("numerics_grads")),
                 (numerics.StepNumerics, "update", timed("numerics_update")),
                 (numerics.StepNumerics, "summary",
                  timed("numerics_summary"))):
        state, meter = run_training(cfg, trainer=trainer, state=state,
                                    registry=reg, ledger=led)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    # One more step under the profiler: where the numerics' time goes.
    split = None
    if profile:
        from serverless_learn_tpu_torch.training.loop import make_source

        batch = trainer.place(next(iter(make_source(cfg, trainer,
                                                    start_step=state.step))))
        torch.cuda.synchronize()
        with profiled() as prof:
            state, m = trainer.step(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
        split = kernel_split(torch, prof, ["tensor_stats",
                                           "tensor_stats_many",
                                           "stats_reduce", "flash_fwd",
                                           "flash_dq", "flash_dkv"])
        del batch, prof, m
    rep = led.report()
    out = {"losses": [s.metrics["loss"] for s in meter.history],
           "step_times_s": [s.step_time_s for s in meter.history],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "trainable_tensors": n_tensors,
           "numerics_share": rep["phases"].get(
               "numerics", {}).get("fraction", 0.0),
           "numerics_s": rep["phases"].get("numerics", {}).get("seconds",
                                                               0.0),
           "run_s": rep["total_s"],
           "fetches": reg.counter("slt_numerics_fetches_total").value,
           "profile": split,
           "host_ms_a_step": {k: v * 1e3 / NUMERICS_STEPS
                              for k, v in host_s.items()}}
    del state, trainer, meter
    gc.collect()
    torch.cuda.empty_cache()
    return out


def numerics_overhead(torch, card):
    """Phase 14b: llama_1b, 12 steps a run from the same seed, in the order
    off, on, on, off (numerics at cadence 4 when on), so a drift of the
    card's clocks over the phase falls on both sides; the ratio is the
    median of the on runs' steps over the off runs'. The first pair is
    profiled."""
    runs = [numerics_run(torch, enabled, profile=i < 2)
            for i, enabled in enumerate((False, True, True, False))]
    offs, ons = (runs[0], runs[3]), (runs[1], runs[2])
    off, on = offs[0], ons[0]
    med = lambda rs: statistics.median(  # noqa: E731
        t for r in rs for t in r["step_times_s"][2:])
    ratio = med(ons) / med(offs)
    peak_diff = max(r["peak_gb"] for r in ons) - min(
        r["peak_gb"] for r in offs)
    n = on["trainable_tensors"]
    layers = 16
    want = {"flash_fwd": NUMERICS_STEPS * layers,
            "flash_dq": NUMERICS_STEPS * layers,
            "flash_dkv": NUMERICS_STEPS * layers,
            # a step: each trainable tensor's update alone, the gradients
            # and the parameters in one launch each, one reduction of each
            # of the three
            "tensor_stats": NUMERICS_STEPS * n,
            "tensor_stats_many": NUMERICS_STEPS * 2,
            "stats_reduce": NUMERICS_STEPS * 3}
    emit("numerics_overhead", card=card, model="llama_1b", batch=TRAIN_B,
         seq_len=TRAIN_T, steps=NUMERICS_STEPS, cadence=NUMERICS_CADENCE,
         order="off, on, on, off",
         median_step_s_off=med(offs), median_step_s_on=med(ons),
         median_step_s_by_run=[med([r]) for r in runs],
         step_time_ratio=ratio,
         step_times_s_off=[r["step_times_s"] for r in offs],
         step_times_s_on=[r["step_times_s"] for r in ons],
         peak_gb_off=[r["peak_gb"] for r in offs],
         peak_gb_on=[r["peak_gb"] for r in ons],
         peak_gb_difference=peak_diff,
         numerics_phase_share=max(r["numerics_share"] for r in ons),
         numerics_phase_s=on["numerics_s"], run_s=on["run_s"],
         fetches=[r["fetches"] for r in ons], losses_off=off["losses"],
         losses_on=on["losses"],
         losses_bit_equal=all(r["losses"] == off["losses"] for r in runs),
         launches_off=off["launches"], launches_on=on["launches"],
         trainable_tensors=n, profile_off=off["profile"],
         profile_on=on["profile"], host_ms_a_step_off=off["host_ms_a_step"],
         host_ms_a_step_on=on["host_ms_a_step"])
    faults = []
    if any(r["losses"] != off["losses"] for r in runs):
        faults.append("the losses differ between the runs")
    if ratio > 1.03:
        faults.append(f"step-time ratio {ratio:.4f} > 1.03")
    if peak_diff > 1.05:
        faults.append(f"peak memory +{peak_diff:.3f} GB > 1.05")
    for r in ons:
        if not r["numerics_share"] < 0.02:
            faults.append(f"numerics phase {r['numerics_share']:.4f} of "
                          f"the run, not under 2 %")
        if r["fetches"] != 3:
            faults.append(f"{r['fetches']} fetches, expected 3")
    off_want = dict(want, tensor_stats=0, tensor_stats_many=0, stats_reduce=0)
    if any(r["launches"] != want for r in ons) or any(
            r["launches"] != off_want for r in offs):
        faults.append(f"launches on {[r['launches'] for r in ons]}, off "
                      f"{[r['launches'] for r in offs]}, expected {want}")
    if faults:
        fail("phase 14b: " + "; ".join(faults))
    return on["launches"]


DRILL_NUMERICS = ["--model", "llama_1b", "--batch-size", str(TRAIN_B),
                  "--seq-len", str(TRAIN_T), "--steps", "8", "--numerics",
                  "--health", "--metrics-port", "0",
                  "--set", "optimizer.grad_clip_norm=0",
                  "--set", f"numerics.cadence={NUMERICS_CADENCE}",
                  "--set", "numerics.inject_nan_step=6",
                  "--set", "numerics.inject_nan_subtree=layer_5",
                  "--set", "health.sample_interval_s=0.2"]


def numerics_drill(torch, card):
    """Phase 14c: ``train --numerics --health`` through the CLI in this
    process with a NaN injected into layer_5's gradients at step 6 of 8 (no
    clipping): the incident record, the counter, the critical alert,
    /healthz at 503, /numerics, the flight dump and the sweep's K1
    launches. A thread scrapes the endpoints while it trains."""
    import os
    import shutil
    import tempfile
    from urllib.error import HTTPError
    from urllib.request import urlopen

    from serverless_learn_tpu_torch import cli
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.telemetry import numerics, tracing

    root = tempfile.mkdtemp(prefix="slt-phase14-")
    events_path = os.path.join(root, "events.jsonl")
    kept, scrapes, scraping = {}, [], threading.Event()

    def keep_exporter(real):
        def start(*a, **k):
            kept["exporter"] = real(*a, **k)
            return kept["exporter"]
        return start

    def scrape():
        while not scraping.wait(0.2):
            exp = kept.get("exporter")
            if exp is None:
                continue
            row = {}
            for path in ("/metrics", "/alerts", "/healthz", "/numerics"):
                try:
                    with urlopen(f"http://{exp.addr}{path}",
                                 timeout=10) as r:
                        row[path] = (r.status, r.read().decode())
                except HTTPError as e:
                    row[path] = (e.code, e.read().decode())
                except OSError:
                    row[path] = None
            scrapes.append(row)

    for k in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv):
        k.launches = 0
    # The numerics step ring is the process's: 14b's records (steps up to
    # 12) would hide this run's steps 4-8 from its new health engine.
    numerics.clear_steps()
    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    t0 = time.perf_counter()
    try:
        with Patched((cli, "_start_metrics", keep_exporter)):
            done = run_cli(["train", *DRILL_NUMERICS, "--events-log",
                            events_path, "--flight-dir", root])
        drill_s = time.perf_counter() - t0
        launches = {k.__name__: k.launches
                    for k in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)}
        events = read_events(events_path)
        dumps = []
        for name in sorted(os.listdir(root)):
            if name.startswith("flight-") and name.endswith(".json"):
                with open(os.path.join(root, name)) as f:
                    dumps.append(json.load(f).get("reason"))
    finally:
        scraping.set()
        scraper.join(timeout=30)
        tracing.reset_tracing()
        numerics.clear_steps()
        shutil.rmtree(root, ignore_errors=True)
    incidents = [x for x in events if x.get("event") == "numerics_nonfinite"]
    at6 = [x for x in incidents if x.get("step") == 6]
    nonfinite_total = max((prom_value(s["/metrics"][1],
                                      "slt_numerics_nonfinite_total") or 0
                           for s in scrapes if s.get("/metrics")),
                          default=0)
    critical = sorted({a["alert"] for s in scrapes if s.get("/alerts")
                       for a in json.loads(s["/alerts"][1]).get("firing", [])
                       if a["severity"] == "critical"})
    healthz = sorted({s["/healthz"][0] for s in scrapes if s.get("/healthz")})
    served = [json.loads(s["/numerics"][1]) for s in scrapes
              if s.get("/numerics") and s["/numerics"][0] == 200]
    steps = 8
    want = {"flash_fwd": steps * 16 + 16, "flash_dq": steps * 16,
            "flash_dkv": steps * 16}
    emit("numerics_drill", card=card, seconds=drill_s,
         incidents=[{k: x.get(k) for k in ("step", "first", "bad_subtrees",
                                           "nonfinite")} for x in incidents],
         provenance=at6[0].get("provenance") if at6 else None,
         slt_numerics_nonfinite_total=nonfinite_total,
         critical_alerts=critical, healthz_codes=healthz,
         numerics_endpoint_last_step=max(
             ((x.get("last") or {}).get("step", 0) for x in served),
             default=None),
         flight_dump_reasons=dumps, launches=launches,
         losses=done.get("losses"), scrapes=len(scrapes))
    faults = []
    if (len(at6) != 1 or at6[0].get("first") != "params:layer_5"
            or "grad:layer_5" not in at6[0].get("bad_subtrees", [])):
        faults.append(f"incident records at step 6: {at6}")
    if not nonfinite_total >= 1:
        faults.append("slt_numerics_nonfinite_total never reached 1")
    if "numerics.nonfinite" not in critical:
        faults.append(f"no critical numerics.nonfinite, fired {critical}")
    if 503 not in healthz:
        faults.append(f"/healthz answered {healthz}, never 503")
    if not any(x.get("enabled") for x in served):
        faults.append("/numerics served no summary")
    if not any("layer_5" in (r or "") for r in dumps):
        faults.append(f"no flight dump names layer_5: {dumps}")
    if launches != want:
        faults.append(f"launches {launches}, expected {want} (the sweep's "
                      f"forward through K1 included)")
    if faults:
        fail("phase 14c: " + "; ".join(faults))


def numerics_phase(torch, card):
    """Phase 14: the non-finite check, the overhead of numerics on the
    llama_1b step and the NaN drill."""
    t0 = time.perf_counter()
    cases = nonfinite_check(torch, card)
    t1 = time.perf_counter()
    launches = numerics_overhead(torch, card)
    t2 = time.perf_counter()
    numerics_drill(torch, card)
    emit("numerics_phase", card=card, nonfinite_cases=cases,
         nonfinite_s=t1 - t0, overhead_s=t2 - t1,
         drill_s=time.perf_counter() - t2, phase_s=time.perf_counter() - t0)
    return launches


def time_stats(torch, card):
    """The stats kernels at llama_1b, on its f32 parameters: the
    many-tensor kernel over all of them in one launch (with the
    fingerprint's chunks: the step's parameter pass), the single-tensor
    kernel once a tensor (the step's update pass) and the reduction, each
    against its plain version on the card and its byte bound (each
    parameter read once; the rows written once and read once)."""
    from serverless_learn_tpu_torch.models.registry import get_model
    from serverless_learn_tpu_torch.models.transformer import (Transformer,
                                                               init_params)
    from serverless_learn_tpu_torch.ops import tensor_stats as ts
    from serverless_learn_tpu_torch.telemetry import numerics

    cfg = get_model("llama_1b").cfg
    model = Transformer(cfg, device="cuda")
    init_params(model, 0)
    named = sorted(((n, p.detach()) for n, p in model.named_parameters()),
                   key=lambda x: tuple(x[0].split(".")))
    groups = {}
    for n, p in named:
        groups.setdefault(n.split(".")[0], []).append(p)
    plan = numerics.StatsPlan([(g, [p.numel() for p in ps])
                               for g, ps in groups.items()], chunks=4)
    leaves = [p for ps in groups.values() for p in ps]
    rows = plan.new_rows("cuda")
    bounds = torch.tensor(plan.bounds, device="cuda")
    out = torch.empty(len(plan.names), ts.KCOLS, dtype=torch.float64,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    before = {k.__name__: k.launches for k in (
        ts.tensor_stats, ts.tensor_stats_many, ts.stats_reduce)}
    plan.collect_all(rows, leaves)  # the descriptors, built once
    ms = {"tensor_stats_many": time_ms(
              torch, lambda i: plan.collect_all(rows, leaves), 5, reps=3),
          "tensor_stats": time_ms(
              torch, lambda i: [plan.collect(rows, j, x, stream=stream)
                                for j, x in enumerate(leaves)], 5, reps=3),
          "stats_reduce": time_ms(
              torch, lambda i: ts.stats_reduce(rows, bounds, out), 20,
              reps=3)}
    got = {}
    plan.collect_all(rows, leaves)
    got["tensor_stats_many"] = ts.stats_reduce(rows, bounds, out).clone()
    for j, x in enumerate(leaves):
        plan.collect(rows, j, x, stream=stream)
    got["tensor_stats"] = ts.stats_reduce(rows, bounds, out).clone()
    got["stats_reduce"] = got["tensor_stats"]
    plain_rows = rows.clone()

    def plain_collect(i):
        for j, x in enumerate(leaves):
            g, r0, base, n = plan.leaves[j]
            ts.tensor_stats_reference(
                x, plain_rows[r0:r0 + ts.grid_for(n)], base=base,
                chunk=plan.chunk[g], chunks=4)

    plain_ms = time_ms(torch, plain_collect, 1, warmup=1)
    plain = {"tensor_stats_many": plain_ms, "tensor_stats": plain_ms,
             "stats_reduce": time_ms(
                 torch, lambda i: ts.stats_reduce_reference(
                     rows, plan.bounds, out.clone()), 1, warmup=1)}
    ref = ts.stats_reduce_reference(plain_rows, plan.bounds, out.clone())
    lim = torch.stack([ts.kernel_tolerance(ref[g], n)
                       for g, n in enumerate(plan.counts)])
    # launches made for the timing and the comparison are not the path's
    for k in (ts.tensor_stats, ts.tensor_stats_many, ts.stats_reduce):
        k.launches = before[k.__name__]
    param_bytes = sum(x.numel() * x.element_size() for x in leaves)
    row_bytes = plan.rows * ts.KCOLS * 8
    bound = {"tensor_stats_many": (param_bytes + row_bytes) / HBM_BYTES_PER_S,
             "tensor_stats": (param_bytes + row_bytes) / HBM_BYTES_PER_S,
             "stats_reduce": (row_bytes + out.numel() * 8 + bounds.numel()
                              * 8) / HBM_BYTES_PER_S}
    rows_out = {}
    for name in ms:
        err = (got[name] - ref).abs()
        over = torch.where(lim > 0, err / lim.clamp_min(1e-300),
                           torch.where(err > 0, math.inf, 0.0)).max().item()
        rows_out[name] = {"ms": ms[name], "plain_ms": plain[name],
                          "bound_ms": bound[name] * 1e3, "bound_by": "bytes",
                          "library_ms": None,
                          "max_abs_err": err.max().item(),
                          "worst_err_over_limit": over}
    emit("time_stats", card=card, model="llama_1b", tensors=len(leaves),
         param_gb=param_bytes / 1e9, rows=plan.rows,
         kernels=rows_out, library_call=None,
         note="no single PyTorch call computes the finite-masked norms, "
              "counts, maxima and chunk sums; tensor_stats is timed once a "
              "tensor over the same parameters",
         tolerance="ops.tensor_stats.kernel_tolerance: counts and max "
                   "exact; sums 7 n 2^-24 absmax (squares absmax^2)")
    worst = max(r["worst_err_over_limit"] for r in rows_out.values())
    if not worst <= 1:
        fail(f"stats kernels disagree with their plain versions at "
             f"llama_1b: worst error / limit {worst:.3g}")
    del model, leaves, named, groups, rows, plain_rows
    torch.cuda.empty_cache()
    return rows_out


# -------------------------------------------------------------- MoE (15) --

# Mixtral-8x7B in int8 (46.6 B weights, 46.6 GB): (I, O) -> (sites, K6
# launches a decode forward). Each layer runs its 4 attention projections
# and, in the decode (dense) form, each of its 8 experts' gate, up and down
# over every row: 32 * (4 + 8 * 3) + 1 = 897 launches a forward.
MIXTRAL = "moe_mixtral_8x7b"
MIXTRAL_SHAPES = {
    (4096, 4096): ("q_proj, o_proj", 64),
    (4096, 1024): ("k_proj, v_proj", 64),
    (4096, 14336): ("expert gate, up", 512),
    (14336, 4096): ("expert down", 256),
    (4096, 32000): ("lm_head", 1),
}
MIXTRAL_K6_PER_FWD = 897
MOE_EXPERTS, MOE_TOP_K = 8, 2
# Phase 15a's rows: decode buckets, K6's decode/prefill edge, an expert's
# share of a 512-row prefill (512 * 2 / 8), the prefill itself and
# phase 3's training rows (Mixtral's lm_head is the one shape llama_8b's
# check does not cover).
MOE_CHECK_ROWS = (1, 2, 8, 16, 128, 512, QLORA_ROWS)
MOE_PREFILL_ROWS = 512
MOE_EXPERT_PREFILL_ROWS = MOE_PREFILL_ROWS * MOE_TOP_K // MOE_EXPERTS
# A 512-row prefill forward: attention and lm_head at 512 rows, each expert
# at its uniform share, 128 (the gathered form).
MIXTRAL_PREFILL_SHAPES = {
    (4096, 4096): ("q_proj, o_proj", 64, MOE_PREFILL_ROWS),
    (4096, 1024): ("k_proj, v_proj", 64, MOE_PREFILL_ROWS),
    (4096, 14336): ("expert gate, up", 512, MOE_EXPERT_PREFILL_ROWS),
    (14336, 4096): ("expert down", 256, MOE_EXPERT_PREFILL_ROWS),
    (4096, 32000): ("lm_head", 1, MOE_PREFILL_ROWS),
}
# An MoE layer's output against the same layer with K6's plain version,
# per element: each expert product rounds to bf16 after f32 sums in
# another order (2^-8 of a value), three products a SwiGLU expert and two
# experts a token, so 2^-6 of |y| plus 1 % of the largest |y| for the
# errors carried through the down projection's 14,336-term sums.
MOE_LAYER_LIMIT = (2 ** -6, 1e-2)
# Phase 15a times the two inference forms of one layer at these rows.
MOE_FORM_ROWS = (8, 16, 32, 64, 128, 192, 256, 384, 512)
# (32 and 128 before the model families' phase 16: the run's time limit)
MOE_NEW = 16         # new tokens of each greedy request in phase 15b
MOE_ROUND = 64       # new tokens a request in phase 15b's decode round
# Phase 15b's limit, in logits, on how far two paths' teacher-forced logits
# may part, and a greedy reply's chosen logit may lie below the static
# path's largest, where routing cannot flip (TokenRouting). Measured on
# an H100: the paths part by up to 1.36 so, and the engine's chosen
# tokens lie up to 0.66 below (llama_8b's dense paths: 0.76, phase 9c);
# as the model routes they part by 11.7, and the logits reach 10.6.
MOE_FORCED_LIMIT = 2.0
# Phase 15d: Mixtral at full width, 2 of 32 layers, B = 1, T = 4,096, bf16
# compute over f32 parameters, adamw; 3 steps.
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 2, 3
MOE_TRAIN_ARGS = ["train", "--model", MIXTRAL, "--set",
                  f"model_overrides.n_layers={MOE_TRAIN_LAYERS}",
                  "--batch-size", "1", "--seq-len", str(TRAIN_T),
                  "--steps", str(MOE_TRAIN_STEPS), "--verbose", "--set",
                  "train.log_every=1"]


def fill_int8_moe(torch, layer, g):
    """A Mixtral int8 MoE layer's weights from ``g``, as
    ``random_quantized_params`` fills them."""
    with torch.no_grad():
        for name, t in layer.state_dict().items():
            if t.dtype == torch.int8:
                t.random_(-127, 128, generator=g)
            elif name.endswith("_scale"):
                t.fill_(2.5 * 0.02 / 127.0)
            else:
                t.normal_(0.0, 0.02, generator=g)


class PlainQuantMatmul:
    """``ops.moe``'s K6 entry replaced by K6's plain version."""

    @staticmethod
    def apply(x, wq, scale):
        from serverless_learn_tpu_torch.ops.quant_matmul import (
            quant_matmul_reference)

        return quant_matmul_reference(x, wq, scale)


def moe_form(torch, layer, x, form):
    """The per-token MoE layer over the rows ``x [R, D]`` in the inference
    form ``form`` ("dense" or "gathered"), f32 [R, D]."""
    with torch.no_grad():
        w, idx = layer._route(x)
        return getattr(layer, "_" + form)(x, idx, w)


def moe_layer_case(torch, qm, layer, x, form, per_expert):
    """One MoE layer forward on the card (K6) against the same with K6's
    plain version: (worst |err| / limit, K6 launches, experts with rows).
    ``per_expert``: the launches a routed expert costs (3)."""
    from serverless_learn_tpu_torch.ops import moe as moe_ops

    with torch.no_grad():
        top = (x.float() @ layer.router.float()).softmax(-1).topk(
            MOE_TOP_K, dim=-1).indices
        hit = int(torch.bincount(top.reshape(-1), minlength=MOE_EXPERTS)
                  .gt(0).sum())
    n0 = qm.quant_matmul.launches
    got = moe_form(torch, layer, x, form)
    launched = qm.quant_matmul.launches - n0
    with Patched((moe_ops, "QuantMatmul", lambda real: PlainQuantMatmul)):
        want = moe_form(torch, layer, x, form)
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    limit = MOE_LAYER_LIMIT[0] * ref + MOE_LAYER_LIMIT[1] * ref.max()
    ratio = (err / limit.clamp_min(1e-30)).max().item()
    if not bool(torch.isfinite(got.float()).all()) or not ratio <= 1:
        fail(f"phase 15a: the {form} MoE layer at {x.shape[0]} rows "
             f"disagrees with its plain version: worst error / limit "
             f"{ratio:.3g}")
    want_launches = (per_expert * MOE_EXPERTS if form == "dense"
                     else per_expert * hit)
    if launched != want_launches:
        fail(f"phase 15a: the {form} MoE layer at {x.shape[0]} rows "
             f"launched K6 {launched} times, not {want_launches}")
    return ratio, launched, hit


def moe_form_times(torch, layer, g, reps=5):
    """{rows: {"dense": ms, "gathered": ms}}: the host's time of one call of
    each inference form of ``layer`` over random rows, synchronised, the
    median of ``reps`` after a warm-up call (the gathered form's one host
    sync for its row counts included)."""
    out = {}
    for form in ("dense", "gathered"):  # the clocks up before the first
        for _ in range(reps):
            moe_form(torch, layer, torch.randn(
                MOE_FORM_ROWS[0], layer.cfg.d_model, generator=g,
                device="cuda").to(torch.bfloat16), form)
    for R in MOE_FORM_ROWS:
        x = torch.randn(R, layer.cfg.d_model, generator=g,
                        device="cuda").to(torch.bfloat16)
        out[R] = {}
        for form in ("dense", "gathered"):
            times = []
            for _ in range(reps + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                moe_form(torch, layer, x, form)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[R][form] = statistics.median(times[1:])
    return out


def moe_kernel_check(torch, qm, card):
    """Phase 15a: K6 against its plain version at each of Mixtral's
    projection shapes at MOE_CHECK_ROWS rows (each case twice, bit for
    bit); then one full-width int8 MoE layer with expert 7 routed no row,
    on the card against the same layer through K6's plain version: the
    gathered form at 16, 128 and 512 rows (3 launches for each routed
    expert, none for expert 7) and the dense decode form at 1 and 8 rows
    (3 for every expert); the two forms against each other at 16 rows;
    the two forms' times at MOE_FORM_ROWS rows, beside the row count up
    to which ``ops.moe`` takes the dense form (``DENSE_MAX_ROWS``). Then
    times K6 over a Mixtral decode forward (8 rows) and a 512-row
    prefill forward. Returns (max abs err, the two timings)."""
    from serverless_learn_tpu_torch.models.registry import get_model_config
    from serverless_learn_tpu_torch.ops import moe as moe_ops

    g = torch.Generator(device="cuda").manual_seed(5)
    worst = {}
    for I, O in MIXTRAL_SHAPES:
        wq = torch.randint(-127, 128, (I, O), generator=g, device="cuda",
                           dtype=torch.int8)
        scale = (torch.rand(O, generator=g, device="cuda") + 0.5) * 4e-4
        for R in MOE_CHECK_ROWS:
            check_case(torch, qm, g, R, wq, scale, torch.bfloat16, worst)
        del wq
    torch.cuda.empty_cache()
    max_err = max(a for a, _, _ in worst.values())
    cfg = get_model_config(MIXTRAL, quant="int8")
    layer = moe_ops.MoELayer(cfg, device="cuda")
    fill_int8_moe(torch, layer, g)
    cases = []
    for R, form in ((16, "gathered"), (128, "gathered"), (512, "gathered"),
                    (1, "dense"), (8, "dense")):
        # Rows whose top-2 leave out expert 7: the gathered form must skip
        # it (K6 takes no zero-row launch) and still agree.
        pool = torch.randn(8 * R, cfg.d_model, generator=g,
                           device="cuda").to(torch.bfloat16)
        with torch.no_grad():
            top = (pool.float() @ layer.router.float()).topk(
                MOE_TOP_K, dim=-1).indices
        x = pool[(top != MOE_EXPERTS - 1).all(-1)][:R].contiguous()
        if x.shape[0] != R:
            fail(f"phase 15a: {x.shape[0]} of {8 * R} rows leave out "
                 "expert 7")
        ratio, launched, hit = moe_layer_case(torch, qm, layer, x, form, 3)
        if form == "gathered" and hit != MOE_EXPERTS - 1:
            fail(f"phase 15a: {hit} experts routed at {R} rows, not "
                 f"{MOE_EXPERTS - 1}")
        cases.append(dict(rows=R, form=form, experts_routed=hit,
                          k6_launches=launched, worst_err_over_limit=ratio))
    x = torch.randn(16, cfg.d_model, generator=g,
                    device="cuda").to(torch.bfloat16)
    dense = moe_form(torch, layer, x, "dense")
    gathered = moe_form(torch, layer, x, "gathered")
    d = (dense.float() - gathered.float()).abs()
    forms_ratio = (d / (MOE_LAYER_LIMIT[0] * dense.float().abs()
                        + MOE_LAYER_LIMIT[1] * dense.float().abs().max())
                   ).max().item()
    if not forms_ratio <= 1:
        fail(f"phase 15a: the dense and gathered forms part by "
             f"{forms_ratio:.3g} of the limit")
    del dense, gathered
    forms = moe_form_times(torch, layer, g)
    del layer, x
    torch.cuda.empty_cache()
    emit("moe_forms", card=card, layer="one Mixtral-8x7B int8 MoE layer, "
         "per-token routing, random rows", ms=forms,
         dense_max_rows=moe_ops.DENSE_MAX_ROWS,
         dense_no_slower_at=[R for R, t in forms.items()
                             if t["dense"] <= t["gathered"]])
    emit("moe_check", card=card, shapes=[list(k) for k in MIXTRAL_SHAPES],
         rows=list(MOE_CHECK_ROWS), k6_max_abs_err=max_err,
         k6_cases=sum(n for _, _, n in worst.values()),
         layer_cases=cases, dense_vs_gathered_over_limit=forms_ratio,
         tolerance=f"K6: phase 3's; a layer: |err| <= "
                   f"{MOE_LAYER_LIMIT[0]:.4g} |ref| + "
                   f"{MOE_LAYER_LIMIT[1]:.4g} max|ref|")
    decode = time_kernel(torch, qm, card, R=DECODE_ROWS,
                         shapes=MIXTRAL_SHAPES, label="mixtral_decode")
    prefill = time_kernel(torch, qm, card, R=MOE_PREFILL_ROWS,
                          shapes=MIXTRAL_PREFILL_SHAPES,
                          label="mixtral_prefill")
    return max_err, decode, prefill


class TokenRouting:
    """Within the block, every MoE layer of ``model`` routes each token by
    its id and the layer's index alone, to experts ``a = (7 t + 3 l) mod E``
    and ``(a + 1 + (5 t + l) mod (E - 1)) mod E``, with the router's own
    probabilities of the two, renormalised, as gate weights. Rounding then
    changes a gate weight by rounding, and never which experts a token
    takes, so two paths' logits part by their arithmetic alone. A pre-hook
    keeps the model's token tensor (a decode graph's captured one too),
    row for row the MoE layer's rows. Top-2."""

    def __init__(self, torch, model):
        from serverless_learn_tpu_torch.ops.moe import MoELayer

        self.torch, self.model = torch, model
        self.layers = [m for m in model.modules() if isinstance(m, MoELayer)]

    def _route(self, i, layer):
        torch = self.torch
        E = layer.cfg.n_experts

        def route(x2):
            t = self.tokens.reshape(-1).to(torch.int64)
            a = (7 * t + 3 * i) % E
            idx = torch.stack([a, (a + 1 + (5 * t + i) % (E - 1)) % E], -1)
            probs = torch.softmax(x2.to(torch.float32)
                                  @ layer.router.to(torch.float32), dim=-1)
            w = probs.gather(1, idx)
            return w / w.sum(-1, keepdim=True), idx
        return route

    def _keep(self, mod, args, kwargs):
        self.tokens = args[0] if args else kwargs["tokens"]

    def __enter__(self):
        self.hook = self.model.register_forward_pre_hook(self._keep,
                                                         with_kwargs=True)
        for i, layer in enumerate(self.layers):
            layer._route = self._route(i, layer)
        return self

    def __exit__(self, *exc):
        self.hook.remove()
        for layer in self.layers:
            del layer._route


def logit_parts(static, other) -> dict:
    """How far ``other``'s teacher-forced logits [B, N, V] part from
    ``static``'s: max, mean and the first step's max."""
    d = (other - static).abs()
    return dict(max=d.max().item(), mean=d.mean().item(),
                first_step_max=d[:, 0].max().item())


def routing_witness(torch, model, prompts, replies):
    """Why phase 15b's engine cannot repeat ``generate``'s replies on this
    model: the static path over the group of four against each prompt
    alone and against the paged path (chunks of 32, windows of 16 pages),
    all fed ``replies``, (a) as the model routes; (b) the first step
    again with K6's plain version (cuBLAS in f32) in every int8 product:
    whether K6's row-count-dependent split alone seeds the flips; (c)
    under :class:`TokenRouting`. Returns the parts and the faults: (c)
    must part by no more than MOE_FORCED_LIMIT."""
    from serverless_learn_tpu_torch.models import transformer
    from serverless_learn_tpu_torch.ops import moe as moe_ops

    def parts(tokens):
        static = forced_logits(torch, model, prompts, tokens)
        out = {"static_alone": logit_parts(static, torch.cat([
            forced_logits(torch, model, [p], [r])
            for p, r in zip(prompts, tokens)]))}
        if len(tokens[0]) > 1:
            out["paged_chunk32_w16"] = logit_parts(static, forced_logits(
                torch, model, prompts, tokens, 16))
        out["logit_absmax"] = static.abs().max().item()
        return out

    found = {"model_routing": parts(replies)}
    plain = lambda real: PlainQuantMatmul  # noqa: E731
    with Patched((transformer, "QuantMatmul", plain),
                 (moe_ops, "QuantMatmul", plain)):
        found["plain_k6_first_step"] = parts([r[:1] for r in replies])
    with TokenRouting(torch, model):
        found["token_routing"] = parts(replies)
    worst = max(v["max"] for k, v in found["token_routing"].items()
                if k != "logit_absmax")
    faults = [] if worst <= MOE_FORCED_LIMIT else [
        f"under token routing the paths' logits part by {worst:.4g}, "
        f"beyond the limit {MOE_FORCED_LIMIT}"]
    torch.cuda.empty_cache()
    return found, faults


def serve_greedy(server, prompts, greedy, timeout=900):
    """Phase 15b's greedy requests over the wire, MOE_NEW new tokens each:
    the first SERVE_BATCH together, the rest once those prompts are
    published (a prefix hit for the one sharing prompt 0's). Returns (the
    replies, the wall time)."""
    from serverless_learn_tpu_torch.inference.server import request

    eng = server.engine
    replies = [None] * len(greedy)

    def client(i):
        replies[i] = request(server.addr, {"prompt": greedy[i],
                                           "max_new_tokens": MOE_NEW},
                             timeout=timeout)

    t1 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_BATCH)]
    for th in threads:
        th.start()
    while not all(published(eng._trie, p) for p in prompts):
        if time.perf_counter() - t1 > 600:
            fail("phase 15b: the prompts were never published")
        time.sleep(0.002)
    for i in range(SERVE_BATCH, len(greedy)):
        threads.append(threading.Thread(target=client, args=(i,)))
        threads[-1].start()
    for th in threads:
        th.join(timeout=timeout)
    if any(r is None or "error" in r or len(r["new_tokens"]) != MOE_NEW
           for r in replies):
        fail(f"phase 15b: malformed replies {str(replies)[:400]}")
    return [r["new_tokens"] for r in replies], time.perf_counter() - t1


def moe_serve(torch, card):
    """Phase 15b and 15c: full-depth Mixtral-8x7B int8 (``serve --model
    moe_mixtral_8x7b --quant int8``'s model, random weights from seed 0)
    served through ``GenerationServer``'s defaults, the continuous engine
    over the paged pool with its decode buckets replayed from CUDA graphs:
    four greedy prompts of 101-128 tokens, then one sharing prompt 0's
    first 100 tokens (prefix pages) and a 1,500-token prompt (chunked
    prefill), MOE_NEW new tokens each, over the wire; then a decode round
    of 4 x MOE_ROUND new tokens, timed by the host clock at each decode
    harvest.
    The greedy replies are set beside ``generate``'s (each alone, the
    static path); on this model top-2 routing flips at near ties part the
    two paths (``routing_witness``), so the check holds them where routing
    cannot flip: the same requests through a fresh engine under
    :class:`TokenRouting`, every token it chose within MOE_FORCED_LIMIT of
    the static path's largest logit, the static path fed the reply's own
    tokens, and the witness's paths within that limit. Checks also: an
    eager decode
    forward launches K6 897 times (3 an expert of every layer, 4 an
    attention, 1 lm_head), and so does the captured step of every decode
    graph (the wrapper's count while it is captured: the replays run
    those launches); a replayed chunk equals the eager one bit for bit; a
    512-row prefill forward (4 x 128)
    launches 3 for every routed expert of every layer beside its 129. 15c:
    the same four prompts through the static engine (``--serve-engine
    static``), held the same way to ``generate`` of the padded batch.
    Prints the weights' size, the pool, peak memory, ms a token, new
    tokens/s, the prefill's time and a profiled replayed step by kernel.
    Returns (K6 launches eagerly, in the graph replays: each bucket's
    captured count times its replays)."""
    from serverless_learn_tpu_torch.config import KVCacheConfig
    from serverless_learn_tpu_torch.inference.generate import (generate,
                                                               init_cache)
    from serverless_learn_tpu_torch.inference.server import (GenerationServer,
                                                            request)
    from serverless_learn_tpu_torch.models.registry import build_model
    from serverless_learn_tpu_torch.ops.moe import MoELayer
    from serverless_learn_tpu_torch.ops.quant_matmul import quant_matmul

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(MIXTRAL, quant="int8", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = model.cfg
    V = cfg.vocab_size
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    prompts = serve_prompts(torch, V)
    g = torch.Generator().manual_seed(4)
    fifth = prompts[0][:SHARED] + torch.randint(0, V, (5,),
                                                generator=g).tolist()
    long_p = torch.randint(0, V, (LONG_PROMPT,), generator=g).tolist()
    greedy = prompts + [fifth, long_p]
    faults = []

    # One eager decode forward: 897 launches.
    with torch.inference_mode():
        cache = init_cache(model, 1)
        tok = torch.tensor([prompts[0][:8]], device="cuda")
        model(tok, cache=cache, prefill=True)
        torch.cuda.synchronize()
        n0 = quant_matmul.launches
        model(tok[:, :1], cache=cache, decode=True)
        decode_launches = quant_matmul.launches - n0
        del cache
    if decode_launches != MIXTRAL_K6_PER_FWD:
        faults.append(f"an eager decode forward launched K6 "
                      f"{decode_launches} times, not {MIXTRAL_K6_PER_FWD}")
    # A 512-row prefill forward (4 x 128): 129 + 3 a routed expert.
    routed = [0]

    def count_routed(mod, args):
        x = args[0].reshape(-1, args[0].shape[-1])
        top = (x.float() @ mod.router.float()).topk(MOE_TOP_K, -1).indices
        routed[0] += int(torch.bincount(top.reshape(-1),
                                        minlength=MOE_EXPERTS).gt(0).sum())

    hooks = [m.register_forward_pre_hook(count_routed)
             for m in model.modules() if isinstance(m, MoELayer)]
    batch = torch.tensor([p[:PROMPT_LEN] for p in
                          (prompts[0], prompts[3], prompts[0][::-1],
                           prompts[3][::-1])], device="cuda")
    with torch.inference_mode():
        cache = init_cache(model, len(batch))
        model(batch, cache=cache, prefill=True)  # the first-seen shapes
        torch.cuda.synchronize()
        routed[0] = 0
        n0 = quant_matmul.launches
        tilings0 = k6_tilings(quant_matmul)
        t1 = time.perf_counter()
        model(batch, cache=cache, prefill=True)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        prefill_launches = quant_matmul.launches - n0
        prefill_tilings = tilings_since(quant_matmul, tilings0)
        del cache
    for h in hooks:
        h.remove()
    want_prefill = 4 * cfg.n_layers + 1 + 3 * routed[0]
    if prefill_launches != want_prefill:
        faults.append(f"a 512-row prefill launched K6 {prefill_launches} "
                      f"times, not {want_prefill}")
    # Attention and lm_head at 512 rows, each routed expert at its share
    # (above 16 rows at top-2 of 8 over 512): all on the wgmma tiling.
    if not prefill_on_wgmma(prefill_tilings):
        faults.append(f"a 512-row prefill's K6 launches by tiling "
                      f"{prefill_tilings}, not all on the wgmma prefill")

    # The static path: generate's replies, each prompt alone; and how far
    # the paths' logits part, as the model routes and where routing cannot
    # flip.
    with torch.inference_mode():
        want = [generate(model, torch.tensor([p]), MOE_NEW)[0, len(p):]
                .tolist() for p in greedy]
    witness, wfaults = routing_witness(torch, model, prompts,
                                       want[:SERVE_BATCH])
    faults += wfaults

    server = GenerationServer(model, port=0)
    server.start()
    eng = server.engine
    harvests = []
    harvest = eng._harvest

    def timed_harvest(fut):
        harvest(fut)
        harvests.append((fut[0], time.perf_counter()))

    eng._harvest = timed_harvest
    # What each decode graph holds: the wrapper counts K6's launches while
    # a bucket is captured (one eager warm-up step, then the captured one),
    # and a replay runs the captured launches again.
    captured = {}
    capture = eng._capture

    def counted_capture(chunk):
        n0 = quant_matmul.launches
        capture(chunk)
        captured[(chunk.rows.tok.shape[0], chunk.table.shape[1])] = (
            quant_matmul.launches - n0)

    eng._capture = counted_capture
    try:
        t1 = time.perf_counter()
        warm = eng.warm_shapes([(PROMPT_LEN, MOE_NEW),
                                (len(fifth), MOE_NEW),
                                (LONG_PROMPT, MOE_NEW),
                                (PROMPT_LEN, MOE_ROUND)])
        warm_s = time.perf_counter() - t1
        rep0 = {key: c.replays for key, c in eng._chunks.items()}
        got, wall = serve_greedy(server, prompts, greedy)
        hits = eng._trie.hits
        t2 = time.perf_counter()
        round2 = [None] * SERVE_BATCH
        th2 = [threading.Thread(target=lambda i: round2.__setitem__(
            i, request(server.addr, {"prompt": prompts[i],
                                     "max_new_tokens": MOE_ROUND},
                       timeout=900)), args=(i,)) for i in range(SERVE_BATCH)]
        for th in th2:
            th.start()
        for th in th2:
            th.join(timeout=900)
        round_wall = time.perf_counter() - t2
        round_log = [h for h in harvests if h[1] >= t2]
        stats = eng.kv_stats()
        pool_gb = sum(p.numel() * p.element_size() for p in
                      eng._pages.pages_k + eng._pages.pages_v) / 1e9
    finally:
        server.stop()
    graph_check = graph_vs_eager_chunk(torch, eng, prompts)
    if not graph_check["identical"]:
        faults.append("a decode chunk replayed from its graph differs from "
                      "the eager chunk")
    replays = {key: c.replays - rep0.get(key, 0)
               for key, c in eng._chunks.items()}
    replays = {key: n for key, n in replays.items() if n}
    if any(r is None or len(r.get("new_tokens", ())) != MOE_ROUND
           for r in round2):
        fail(f"phase 15b: malformed decode-round replies "
             f"{str(round2)[:400]}")
    # Greedy replies as the model routes: set beside generate's, and how
    # far below the static path's largest logit each chosen token lies.
    # Routing flips part the paths (the witness), so this is no check.
    equal = [a == b for a, b in zip(got, want)]
    gaps = [static_gaps(torch, model, p, r) for p, r in zip(greedy, got)]
    if hits < 1:
        faults.append("the shared prefix was not reused")
    if not replays:
        faults.append("no decode chunk was replayed from a CUDA graph")
    if not captured or any(n != 2 * MIXTRAL_K6_PER_FWD
                           for n in captured.values()):
        faults.append(f"K6 launches while capturing each decode bucket "
                      f"(a warm-up step and the captured one) "
                      f"{ {'nb%d_w%d' % k: n for k, n in captured.items()} }"
                      f", not 2 x {MIXTRAL_K6_PER_FWD}")
    # Each replay runs what its bucket's graph captured: half the count
    # while capturing (the other half is the eager warm-up step).
    replayed = sum(captured[key] // 2 * n for key, n in replays.items())
    C = eng.chunk_size
    per_tok = [(b[1] - a[1]) * 1e3 / C
               for a, b in zip(round_log, round_log[1:])
               if a[0] == b[0] == "pchunk"]
    chunk = eng._chunks.get((SERVE_BATCH, 16)) or next(
        iter(eng._chunks.values()))
    chunk.table.fill_(eng._pool.sentinel)
    chunk.step.zero_()
    torch.cuda.synchronize()
    with profiled() as prof:
        chunk.graph.replay()
        torch.cuda.synchronize()
    span, busy, k6, by_name, kern = device_time(torch, prof, "quant_")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    profiled_step = dict(
        rows=chunk.rows.tok.shape[0], window=chunk.table.shape[1],
        span_ms=span / 1e3, busy_ms=busy / 1e3,
        device_idle_share=1 - busy / span, quant_matmul_ms=k6 / 1e3,
        k6_calls=k6_calls(kern), device_kernels=len(kern),
        top_kernels_ms=[(k[:80], v / 1e3) for k, v in top])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del chunk, eng, server, prof, kern
    gc.collect()
    torch.cuda.empty_cache()

    # The same greedy requests through a fresh engine under TokenRouting,
    # its graphs captured so: every chosen token within MOE_FORCED_LIMIT
    # of the static path's largest logit (each prompt alone, routed so).
    with TokenRouting(torch, model):
        with torch.inference_mode():
            want_tr = [generate(model, torch.tensor([p]), MOE_NEW)[0, len(p):]
                       .tolist() for p in greedy]
        srv_tr = GenerationServer(model, port=0)
        srv_tr.start()
        try:
            srv_tr.engine.warm_shapes([(PROMPT_LEN, MOE_NEW),
                                       (len(fifth), MOE_NEW),
                                       (LONG_PROMPT, MOE_NEW)])
            got_tr, wall_tr = serve_greedy(srv_tr, prompts, greedy)
            hits_tr = srv_tr.engine._trie.hits
        finally:
            srv_tr.stop()
        gaps_tr = [static_gaps(torch, model, p, r)
                   for p, r in zip(greedy, got_tr)]
    del srv_tr
    gc.collect()
    torch.cuda.empty_cache()
    faults += [f"under token routing greedy reply {i} took at step {j} a "
               f"token {gap:.4g} below generate's largest logit, beyond "
               f"{MOE_FORCED_LIMIT}" for i, gs in enumerate(gaps_tr)
               for j, gap in enumerate(gs) if gap > MOE_FORCED_LIMIT]
    if hits_tr < 1:
        faults.append("under token routing the shared prefix was not reused")
    token_routed = dict(
        wall_s=wall_tr, trie_hits=hits_tr, limit=MOE_FORCED_LIMIT,
        replies_equal_generate=sum(a == b for a, b in zip(got_tr, want_tr)),
        worst_gap_to_generate_max=[max(gs) for gs in gaps_tr],
        steps_off_generate_argmax=[sum(x > 0 for x in gs)
                                   for gs in gaps_tr])

    # 15c: one static-engine round, the four prompts as one group (a wait
    # long enough that they arrive as one), which must equal generate of
    # that group on the engine's paged cache, token for token: one path.
    srv = GenerationServer(model, port=0, engine="static",
                           batch_wait_ms=500)
    srv.start()
    static_replies = [None] * SERVE_BATCH
    try:
        th3 = [threading.Thread(target=lambda i: static_replies.__setitem__(
            i, request(srv.addr, {"prompt": prompts[i],
                                  "max_new_tokens": MOE_NEW}, timeout=900)),
            args=(i,)) for i in range(SERVE_BATCH)]
        t3 = time.perf_counter()
        for th in th3:
            th.start()
        for th in th3:
            th.join(timeout=900)
        static_wall = time.perf_counter() - t3
    finally:
        srv.stop()
    if any(r is None or "error" in r for r in static_replies):
        fail(f"phase 15c: static engine replies {str(static_replies)[:400]}")
    sgot = [r["new_tokens"] for r in static_replies]
    groups = sorted({r["batch_size"] for r in static_replies})
    padded = torch.zeros(SERVE_BATCH, PROMPT_LEN, dtype=torch.int32)
    for i, p in enumerate(prompts):
        padded[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    with torch.inference_mode():
        group_want = generate(
            model, padded, MOE_NEW, prompt_lengths=lens,
            cache=init_cache(model, SERVE_BATCH,
                             block_size=KVCacheConfig().block_size)
        )[:, PROMPT_LEN:].tolist()
    if groups != [SERVE_BATCH] or sgot != group_want:
        faults.append(f"the static engine's replies (groups of {groups}) "
                      f"are not generate's of the same group")

    emit("serve_moe_mixtral_8x7b_int8", card=card, layers=cfg.n_layers,
         experts=cfg.n_experts, top_k=cfg.moe_top_k, weights_gb=weights_gb,
         build_s=build_s, pool_gb=pool_gb, kv=stats,
         max_memory_allocated_gb=peak_gb, requests=len(greedy),
         wall_s=wall, warm_graphs=warm, warm_s=warm_s, trie_hits=hits,
         k6_launches_eager_decode_forward=decode_launches,
         k6_launches_per_forward_expected=MIXTRAL_K6_PER_FWD,
         prefill_512_rows_ms=prefill_ms,
         k6_launches_prefill_512=prefill_launches,
         k6_launches_prefill_512_by_tiling=prefill_tilings,
         experts_routed_prefill_512=routed[0],
         replies_equal_generate=sum(equal), replies=len(equal),
         equal_by_reply=equal, routing_witness=witness,
         token_routing=token_routed,
         graph_check={k: v for k, v in graph_check.items()
                      if not k.startswith("tokens")},
         worst_gap_to_generate_max=[max(gs) for gs in gaps],
         steps_off_generate_argmax=[sum(x > 0 for x in gs) for gs in gaps],
         graph_replays=sum(replays.values()), replays_by_bucket={
             "nb%d_w%d" % k: n for k, n in replays.items()},
         k6_launches_per_capture={"nb%d_w%d" % k: n
                                  for k, n in captured.items()},
         k6_calls_replayed=replayed,
         decode_ms_per_token=(statistics.median(per_tok) if per_tok
                              else None),
         decode_ms_per_token_all=per_tok, round_wall_s=round_wall,
         round_new_tokens_per_s=SERVE_BATCH * MOE_ROUND / round_wall,
         profiled_step=profiled_step,
         static_engine=dict(
             wall_s=static_wall, groups=groups,
             replies_equal_generate_of_the_group=sum(
                 a == b for a, b in zip(sgot, group_want)),
             replies_equal_generate_alone=sum(
                 a == b for a, b in zip(sgot, want[:SERVE_BATCH]))))
    if faults:
        fail("phase 15b/c: " + "; ".join(faults))
    del model, srv
    gc.collect()
    torch.cuda.empty_cache()
    return decode_launches + prefill_launches, replayed


def moe_train(torch, card):
    """Phase 15d: ``train --model moe_mixtral_8x7b`` at full width, 2 of
    32 layers (B = 1, T = 4,096, 3 adamw steps, bf16 compute over f32
    parameters) through the CLI in this process. Checks every loss and
    every ``moe_aux_loss`` finite and positive, K1-K3 launching 2 times a
    step each (one a layer: flash attention at T = 4,096), no
    cross-entropy kernel. Prints the step time, tokens/s, MFU (every
    expert counted, the reference's formula) and peak memory."""
    from serverless_learn_tpu_torch.training import loop

    gc.collect()  # phase 15b's engines hold the served model in cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    metrics = []
    real = loop.run_training

    def keep(fn):
        def run(*a, **kw):
            state, meter = fn(*a, **kw)
            metrics.extend(dict(s.metrics) for s in meter.history)
            return state, meter
        return run

    t0 = time.perf_counter()
    with Patched((loop, "run_training", keep)):
        done = run_cli(MOE_TRAIN_ARGS)
    seconds = time.perf_counter() - t0
    assert loop.run_training is real
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = done["losses"]
    aux = [float(m.get("moe_aux_loss", float("nan"))) for m in metrics]
    kl = done["kernel_launches"]
    want = MOE_TRAIN_LAYERS * MOE_TRAIN_STEPS
    emit("train_moe_mixtral_8x7b", card=card, layers=MOE_TRAIN_LAYERS,
         batch=1, seq_len=TRAIN_T, steps=MOE_TRAIN_STEPS, losses=losses,
         moe_aux_losses=aux, step_time_s=done.get("step_time_s"),
         tokens_per_s=done.get("tokens_per_sec"), mfu=done.get("mfu"),
         max_memory_allocated_gb=peak_gb, kernel_launches=kl,
         seconds=seconds)
    if (len(losses) != MOE_TRAIN_STEPS
            or not all(math.isfinite(x) for x in losses + aux)
            or not all(a > 0 for a in aux) or len(aux) != MOE_TRAIN_STEPS):
        fail(f"phase 15d: losses {losses}, aux {aux}")
    if (any(kl[k] != want for k in ("flash_fwd", "flash_dq", "flash_dkv"))
            or kl["cross_entropy_fwd"] or kl["cross_entropy_bwd"]):
        fail(f"phase 15d: kernel launches {kl}, expected {want} of K1-K3")
    gc.collect()
    torch.cuda.empty_cache()
    return kl


def moe_phase(torch, qm, card):
    """Phase 15: 15a, then 15b/15c and 15d. Returns the kernels-line
    figures."""
    max_err, decode, prefill = moe_kernel_check(torch, qm, card)
    serve_launches, replayed = moe_serve(torch, card)
    train_launches = moe_train(torch, card)
    return dict(max_err=max_err, decode=decode, prefill=prefill,
                serve_launches=serve_launches, replayed=replayed,
                train=train_launches)


# ------------------------------------------------- the model families (16) --

# 16a: the card against the CPU, f32 on both sides.
FAM_BERT_ROWS = (512, 487, 1, 0)   # suffix padding: full, off the tile, 1, 0
FAM_STEPS = 3
# 16b: the one-card cut of configs/bert_base_mlm.json (dp 4 x tp 2 there).
BERT_BATCH, BERT_STEPS, BERT_RECORDS = 64, 5, 1024
# 16c: the one-card cut of configs/cifar_resnet18_dp4.json (dp 4 there).
CIFAR_BATCH, CIFAR_STEPS, CIFAR_RECORDS, CIFAR_TEST = 256, 30, 5120, 1024
# 16d: configs/mnist_mlp.json.
MNIST_STEPS, MNIST_RECORDS, MNIST_TEST = 200, 30000, 2000


def config_path(name: str) -> str:
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", name)


def mlm_rows(rng, n: int, T: int, vocab: int, lengths=None):
    """``n`` suffix-padded token rows (pad id 0): seeded lengths between 64
    and T, a quarter of them full, unless ``lengths`` gives them."""
    import numpy as np

    if lengths is None:
        lengths = rng.integers(64, T + 1, n)
        lengths[rng.random(n) < 0.25] = T
    lengths = np.asarray(lengths)
    ids = rng.integers(4, vocab, (n, T))
    return np.where(np.arange(T)[None] < lengths[:, None], ids, 0).astype(
        np.int32)


def write_cifar(root: str, n: int, seed: int, name: str):
    """``n`` CIFAR-10 binary records (a label byte, then 32x32 RGB in CHW
    planes) in ``root/cifar-10-batches-bin/name``: uint8 images from
    ``seed`` and labels from a fixed projection of each image
    (``examples/elastic_demo.sh``'s)."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    proj = np.random.default_rng(7).standard_normal((3072, 10)).astype(
        np.float32)
    lab = np.argmax((img.reshape(n, -1) / 255.0) @ proj, 1).astype(np.uint8)
    recs = np.concatenate([lab[:, None], img.transpose(0, 3, 1, 2).reshape(
        n, -1)], 1)
    base = os.path.join(root, "cifar-10-batches-bin")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, name), "wb") as f:
        f.write(recs.astype(np.uint8).tobytes())


def write_mnist(root: str, prefix: str, n: int, seed: int):
    """``n`` MNIST IDX records (``prefix``: train or t10k) whose labels are
    learnable: each image is one of 10 fixed seeded prototypes (the class)
    under uniform noise, as a digit is its class's shape under a hand's."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    proto = np.random.default_rng(7).integers(0, 256, (10, 28, 28))
    lab = rng.integers(0, 10, n)
    img = ((proto[lab] + 3 * rng.integers(0, 256, (n, 28, 28))) // 4)

    def idx(arr):
        head = bytes([0, 0, 0x08, arr.ndim]) + b"".join(
            int(d).to_bytes(4, "big") for d in arr.shape)
        return head + arr.astype(np.uint8).tobytes()

    os.makedirs(root, exist_ok=True)
    for kind, arr in (("images-idx3-ubyte", img), ("labels-idx1-ubyte", lab)):
        with open(os.path.join(root, f"{prefix}-{kind}"), "wb") as f:
            f.write(idx(arr))


def tensor_rel_diffs(a: dict, b: dict, ref: dict = None):
    """{name: ||a - b|| / (||ref|| + 1e-3 max_n ||ref_n||)} over the float
    tensors of ``a`` (``ref`` defaults to ``b``): each tensor's distance
    in its own norm's units, floored at a thousandth of the largest (a
    tensor whose true value is near zero keeps only round-off)."""
    ref = b if ref is None else ref
    norms = {k: ref[k].float().norm().item() for k in a}
    floor = 1e-3 * max(norms.values(), default=0.0)
    return {k: (a[k].float() - b[k].float()).norm().item()
            / max(norms[k] + floor, 1e-30) for k in a}


def family_agreement(torch, card):
    """Phase 16a: bert_tiny at T = 512 with suffix-padded rows (lengths
    FAM_BERT_ROWS; 3 adamw steps, so K1-K3 run on the card, 2 layers x 3
    steps each) and resnet18_cifar at num_filters 16, batch 8 (3 sgd steps,
    momentum 0.9), each trained on the card and on the CPU from the same
    weights and batches, f32 on both sides: the first batch's gradients,
    then the losses, parameters and BatchNorm running statistics of the
    three steps compared."""
    import numpy as np

    from serverless_learn_tpu_torch.config import (DataConfig,
                                                   ExperimentConfig,
                                                   OptimizerConfig,
                                                   TrainConfig)
    from serverless_learn_tpu_torch.data.transforms import mlm_transform
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.training.train_step import build_trainer

    rng = np.random.default_rng(16)
    cases = {
        "bert_tiny": (ExperimentConfig(
            model="bert_tiny", model_overrides={"dtype": "float32"},
            optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                      weight_decay=0.01, grad_clip_norm=1.0),
            train=TrainConfig(batch_size=4, seed=0, dtype="float32"),
            data=DataConfig(seq_len=512)),
            [mlm_transform(30522, seed=i)({"input_ids": mlm_rows(
                rng, 4, 512, 30522, FAM_BERT_ROWS)})
             for i in range(FAM_STEPS)]),
        "resnet18_cifar": (ExperimentConfig(
            model="resnet18_cifar",
            model_overrides={"dtype": "float32", "num_filters": 16},
            optimizer=OptimizerConfig(name="sgd", learning_rate=0.1,
                                      momentum=0.9),
            train=TrainConfig(batch_size=8, seed=0, dtype="float32")),
            None),
    }
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)
    out = {}
    for name, (cfg, batches) in cases.items():
        cpu, gpu = build_trainer(cfg, "cpu"), build_trainer(cfg, "cuda")
        if batches is None:
            batches = [cpu.bundle.make_batch(rng, cfg.data, 8)
                       for _ in range(FAM_STEPS)]
        cs = cpu.init()
        init = {k: v.detach().clone() for k, v in
                cs.model.state_dict().items()}

        def grads(trainer):
            model = trainer.init(params=init).model
            loss, _ = trainer.bundle.loss_fn(model, trainer.place(
                batches[0]))
            loss.backward()
            return {n: p.grad.detach().cpu()
                    for n, p in model.named_parameters()}

        grad_rel = tensor_rel_diffs(grads(gpu), grads(cpu))
        gs = gpu.init(params=init)

        def run(trainer, state):
            losses = []
            for b in batches:
                state, m = trainer.step(state, trainer.place(b))
                losses.append(float(m["loss"]))
            return losses, {k: v.detach().cpu().float()
                            for k, v in state.model.state_dict().items()}

        lc, pc = run(cpu, cs)
        before = {k.__name__: k.launches for k in kernels}
        lg, pg = run(gpu, gs)
        launches = {k.__name__: k.launches - before[k.__name__]
                    for k in kernels}
        loss_err = max(abs(a - b) for a, b in zip(lc, lg))
        params = [k for k in pc if not k.endswith((".mean", ".var"))]
        # each tensor's card-CPU distance in units of how far it moved
        moved = {k: (pc[k] - init[k].float()).norm().item() for k in params}
        param_rel = {k: (pc[k] - pg[k]).norm().item() / max(moved[k], 1e-30)
                     for k in params if moved[k] > 0}
        stats = {k: pg[k] for k in pc if k not in params}
        stats_rel = tensor_rel_diffs(stats, {k: pc[k] for k in stats})
        worst = lambda d: max(d.items(), key=lambda kv: kv[1],  # noqa
                              default=(None, 0.0))
        out[name] = dict(cpu_losses=lc, card_losses=lg,
                         max_loss_diff=loss_err,
                         worst_grad_rel_diff=worst(grad_rel),
                         worst_param_diff_over_moved=worst(param_rel),
                         max_param_abs_diff=max(
                             (pc[k] - pg[k]).abs().max().item()
                             for k in params),
                         worst_batch_stats_rel_diff=worst(stats_rel),
                         launches=launches)
        emit("family_agreement", card=card, model=name, steps=FAM_STEPS,
             **out[name],
             tolerance="f32 on both sides, sums in other orders: losses "
                       "within 1e-4; the first batch's gradients, each "
                       "tensor within 1e-4 of its norm (floored at 1e-3 "
                       "of the largest tensor's); after 3 steps each "
                       "parameter tensor's card-CPU distance within 1e-3 "
                       "of how far it moved (adam turns a gradient that is "
                       "round-off alone into a step of up to lr, so an "
                       "element-wise bound would test the noise), the "
                       "running statistics as the gradients")
        want = FAM_STEPS * 2 if name == "bert_tiny" else 0
        if any(n != want for n in launches.values()):
            fail(f"phase 16a {name}: K1-K3 launches {launches}, expected "
                 f"{want} each")
        if not (all(math.isfinite(x) for x in lg) and loss_err <= 1e-4
                and worst(grad_rel)[1] <= 1e-4
                and worst(param_rel)[1] <= 1e-3
                and worst(stats_rel)[1] <= 1e-4):
            fail(f"phase 16a {name}: card vs cpu: {out[name]}")
        del cpu, gpu, cs, gs
        torch.cuda.empty_cache()
    return out


def range_kernels(torch, prof, match):
    """us by kernel name of the device kernels launched inside the
    record_function ranges named ``match`` and by the backward nodes of
    the ops inside them (the autograd node of an op has its sequence
    number)."""
    cpu = torch.autograd.DeviceType.CPU
    events = [e for e in prof.events() if e.device_type == cpu]

    def walk(roots):
        seen, out = set(), []
        stack = list(roots)
        while stack:
            e = stack.pop()
            if e.id in seen:
                continue
            seen.add(e.id)
            out.append(e)
            stack.extend(e.cpu_children)
        return out

    fwd = walk([e for e in events if e.name == match])
    seqs = {e.sequence_nr for e in fwd if getattr(e, "sequence_nr", -1) >= 0}
    bwd = walk([e for e in events if "evaluate_function" in e.name
                and getattr(e, "sequence_nr", -1) in seqs])
    out = {}
    for e in fwd + bwd:
        for k in e.kernels:
            out[k.name] = out.get(k.name, 0.0) + k.duration
    return out, len(bwd)


def resnet_step_split(torch, prof):
    """A profiled ResNet step's device time: busy and idle, cuDNN's
    convolutions (forward and backward), BatchNorm (its range forward and
    its ops' backward nodes), cuBLAS and the rest."""
    span, busy, _, by_name, kern = device_time(torch, prof, "")
    convs = kernels_under(torch, prof, "aten::convolution") or {}
    conv = sum(convs.values())
    bn, bn_bwd_nodes = range_kernels(torch, prof, "batch_norm")
    bn_us = sum(bn.values())
    # cuDNN's implicit-GEMM convolutions are named *gemm* too: cuBLAS is
    # what is left of those names
    cublas = sum(v for k, v in by_name.items()
                 if is_cublas(k) and k not in convs)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return dict(step_span_ms=span / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1 - busy / span, conv_ms=conv / 1e3,
                batch_norm_ms=bn_us / 1e3,
                batch_norm_backward_nodes=bn_bwd_nodes,
                cublas_ms=cublas / 1e3,
                other_kernels_ms=(busy - conv - bn_us - cublas) / 1e3,
                device_kernels=len(kern),
                top_kernels_ms=[(k[:90], v / 1e3) for k, v in top])


def bert_base_training(torch, card, addr):
    """Phase 16b: the one-card cut of configs/bert_base_mlm.json (mesh
    dp = tp = 1, batch 64 of its 256, grad_accum 2, T = 512, its adamw
    settings, 5 steps) through run_training, over an input_ids dataset of
    suffix-padded rows published to the shard server and masked by
    mlm_transform. Checks finite losses, the step-1 loss, exactly 12 x 2 x
    5 launches of each of K1-K3 and no dense attention; prints step time,
    tokens/s (padded and valid), MFU, peak memory and a profiled step."""
    import json as _json

    import numpy as np

    from serverless_learn_tpu_torch.config import ExperimentConfig
    from serverless_learn_tpu_torch.data.shard_client import publish_dataset
    from serverless_learn_tpu_torch.models import transformer
    from serverless_learn_tpu_torch.ops import attention
    from serverless_learn_tpu_torch.ops import flash_attention as fa
    from serverless_learn_tpu_torch.training.loop import (make_source,
                                                          run_training)
    from serverless_learn_tpu_torch.training.train_step import build_trainer

    with open(config_path("bert_base_mlm.json")) as f:
        raw = _json.load(f)
    raw["mesh"] = {"dp": 1, "tp": 1}
    raw["train"].update(batch_size=BERT_BATCH, num_steps=BERT_STEPS)
    raw["data"].update(shard_server_addr=addr)
    cfg = ExperimentConfig.from_dict(raw)
    T = cfg.data.seq_len
    rows = mlm_rows(np.random.default_rng(161), BERT_RECORDS, T, 30522)
    lengths = (rows != 0).sum(1)
    publish_dataset(addr, cfg.data.dataset, {"input_ids": rows},
                    records_per_shard=256)
    trainer = build_trainer(cfg, "cuda")
    state = trainer.init()
    mcfg = trainer.bundle.cfg
    src = make_source(cfg, trainer)
    valid = []

    def counted():
        for b in src:
            valid.append(int(b["attn_mask"].sum()))
            yield b

    dense = [0]
    real_dense = attention.xla_attention

    def counting_dense(*a, **kw):
        dense[0] += 1
        return real_dense(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    attention.xla_attention = transformer.xla_attention = counting_dense
    fa.flash_fwd.launches = fa.flash_dq.launches = fa.flash_dkv.launches = 0
    try:
        state, meter = run_training(cfg, trainer=trainer, state=state,
                                    source=counted())
    finally:
        attention.xla_attention = transformer.xla_attention = real_dense
    launches = {"flash_fwd": fa.flash_fwd.launches,
                "flash_dq": fa.flash_dq.launches,
                "flash_dkv": fa.flash_dkv.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [s.metrics["loss"] for s in meter.history]
    times = [s.step_time_s for s in meter.history]
    summary = meter.steady_state(skip=2)
    steady_valid = sum(valid[2:BERT_STEPS]) / sum(times[2:])
    expected = math.log(mcfg.vocab_size) + 0.5
    want = mcfg.n_layers * cfg.train.grad_accum * BERT_STEPS
    emit("train_bert_base", card=card, config="configs/bert_base_mlm.json",
         cut="mesh dp=1 tp=1 (4 x 2 there), batch 64 (256 there), 5 steps",
         layers=mcfg.n_layers, d_model=mcfg.d_model, batch=BERT_BATCH,
         grad_accum=cfg.train.grad_accum, seq_len=T, steps=BERT_STEPS,
         row_lengths_min_mean_max=[int(lengths.min()), float(lengths.mean()),
                                   int(lengths.max())],
         full_rows_share=float((lengths == T).mean()), losses=losses,
         step_times_s=times, median_step_s_after_2=statistics.median(
             times[2:]), tokens_per_s_padded=summary["tokens_per_sec"],
         tokens_per_s_valid=steady_valid, valid_tokens_per_step=valid[
             :BERT_STEPS], mfu=summary.get("mfu"),
         flops_per_step=meter.flops_per_step,
         mfu_count="6 x tokens x params (the embedding and position tables "
                   "out) + 12 x L x B x T^2 x d (non-causal), padding "
                   "counted", max_memory_allocated_gb=peak_gb,
         launches=launches, expected_launches_each=want,
         dense_attention_calls=dense[0], expected_step1_loss=expected)
    src.close()
    if not all(math.isfinite(x) for x in losses):
        fail(f"phase 16b: non-finite loss {losses}")
    if abs(losses[0] - expected) > 0.5:
        fail(f"phase 16b: step-1 loss {losses[0]:.4f}, expected "
             f"{expected:.4f} +- 0.5")
    if any(n != want for n in launches.values()) or dense[0]:
        fail(f"phase 16b: launches {launches} (expected {want} each), dense "
             f"attention ran {dense[0]} times")
    one = make_source(cfg, trainer, seed=7)
    batch = trainer.place(next(iter(one)))
    one.close()
    torch.cuda.synchronize()
    with profiled() as prof:
        state, m = trainer.step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    emit("where_time_goes_bert_base_train", card=card, **kernel_split(
        torch, prof, list(launches)))
    del state, trainer, batch, prof
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def resnet_cifar_training(torch, card, addr, root):
    """Phase 16c: CIFAR_RECORDS CIFAR-10 binary records (and a test batch)
    written and published with ``publish --format cifar10``; the one-card
    cut of configs/cifar_resnet18_dp4.json (batch 256 of its 1,024, sgd
    momentum 0.9, lr 0.1 with its warmup, ``data.augment=true``) trained
    30 steps with ``--checkpoint-dir``, then ``eval`` from the checkpoint on
    the running statistics, held to eval of the live state; samples/s,
    step time, MFU, peak memory and a profiled step (cuDNN's convolutions,
    BatchNorm, the rest)."""
    import os
    import shutil

    from torch.profiler import record_function

    from serverless_learn_tpu_torch.models import layers
    from serverless_learn_tpu_torch.training import loop

    data = os.path.join(root, "cifar")
    write_cifar(data, CIFAR_RECORDS, 0, "data_batch_1.bin")
    write_cifar(data, CIFAR_TEST, 1, "test_batch.bin")
    for ds, split in (("cifar", "train"), ("cifar_test", "test")):
        pub = run_cli(["publish", "--shard-server", addr, "--dataset", ds,
                       "--format", "cifar10", "--path", data, "--split",
                       split, "--records-per-shard", "512"])
        emit("publish_cifar10", card=card, **pub)
    ckpt = checkpoint_dir(free_bytes=2e9, prefix="slt-phase16c-")
    common = ["--model", "resnet18_cifar", "--config",
              config_path("cifar_resnet18_dp4.json"), "--mesh", "dp=1",
              "--batch-size", str(CIFAR_BATCH), "--shard-server", addr,
              "--dataset", "cifar", "--set", "data.eval_dataset=cifar_test",
              "--checkpoint-dir", ckpt]
    kept = {}

    def keep_run(real):
        def run(*a, **k):
            state, meter = real(*a, **k)
            kept.update(state=state, meter=meter, trainer=k["trainer"])
            return state, meter
        return run

    torch.cuda.reset_peak_memory_stats()
    try:
        with Patched((loop, "run_training", keep_run)):
            done = run_cli(["train", *common, "--set", "data.augment=true",
                            "--steps", str(CIFAR_STEPS)])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ev = run_cli(["eval", *common, "--eval-steps", "4"])
        trainer, state, meter = kept["trainer"], kept["state"], kept["meter"]
        live = loop.run_eval(trainer.config, trainer, state, num_batches=4)
        summary = meter.steady_state(skip=2)
        times = [s.step_time_s for s in meter.history]
        stats = state.model.ResNetBlock_0.BatchNorm_0
        emit("train_resnet18_cifar", card=card,
             config="configs/cifar_resnet18_dp4.json",
             cut="mesh dp=1 (4 there), batch 256 (1,024 there), 30 steps",
             batch=CIFAR_BATCH, steps=CIFAR_STEPS, losses=done["losses"],
             step_times_s=times, median_step_s_after_2=statistics.median(
                 times[2:]), samples_per_s=summary["samples_per_sec"],
             mfu=summary.get("mfu"), flops_per_step=meter.flops_per_step,
             max_memory_allocated_gb=peak_gb, eval=ev, live_eval=live,
             running_mean_abs_mean=stats.mean.abs().mean().item(),
             running_var_mean=stats.var.mean().item())
        if (done["final_step"] != CIFAR_STEPS
                or not all(math.isfinite(x) for x in done["losses"])):
            fail(f"phase 16c: train ended at {done['final_step']} with "
                 f"losses {done['losses']}")
        if ev["checkpoint_step"] != CIFAR_STEPS or not math.isfinite(
                ev["eval_loss"]):
            fail(f"phase 16c: eval from the checkpoint gave {ev}")
        if abs(ev["eval_loss"] - live["eval_loss"]) > 1e-4 * (
                1 + abs(live["eval_loss"])):
            fail(f"phase 16c: eval from the checkpoint {ev['eval_loss']} "
                 f"against the live state's {live['eval_loss']}")
        if stats.mean.abs().max().item() == 0.0:
            fail("phase 16c: the running statistics never moved")
        one = loop.make_source(trainer.config, trainer, seed=5)
        batch = trainer.place(next(iter(one)))
        one.close()
        real_bn = layers.BatchNorm.forward

        def ranged(self, *a, **kw):
            with record_function("batch_norm"):
                return real_bn(self, *a, **kw)

        torch.cuda.synchronize()
        layers.BatchNorm.forward = ranged
        try:
            with profiled() as prof:
                state, m = trainer.step(state, batch)
                float(m["loss"])
                torch.cuda.synchronize()
        finally:
            layers.BatchNorm.forward = real_bn
        emit("where_time_goes_resnet18_cifar_train", card=card,
             batch=CIFAR_BATCH, **resnet_step_split(torch, prof))
        del prof
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        kept.clear()
    gc.collect()
    torch.cuda.empty_cache()


def mlp_mnist_training(torch, card, addr, root):
    """Phase 16d: MNIST IDX files with learnable labels written and
    published with ``publish --format mnist`` (train and test splits);
    configs/mnist_mlp.json (batch 128, adamw 1e-3) trained 200 steps with
    a checkpoint, then ``eval`` from it. Fails unless the mean loss of the
    last 20 steps is below half that of the first 20."""
    import os
    import shutil

    data = os.path.join(root, "mnist")
    write_mnist(data, "train", MNIST_RECORDS, 0)
    write_mnist(data, "t10k", MNIST_TEST, 1)
    for ds, split in (("mnist", "train"), ("mnist_test", "test")):
        pub = run_cli(["publish", "--shard-server", addr, "--dataset", ds,
                       "--format", "mnist", "--path", data, "--split",
                       split, "--records-per-shard", "4096"])
        emit("publish_mnist", card=card, **pub)
    ckpt = checkpoint_dir(free_bytes=1e9, prefix="slt-phase16d-")
    common = ["--model", "mlp_mnist", "--config",
              config_path("mnist_mlp.json"), "--shard-server", addr,
              "--dataset", "mnist", "--set", "data.eval_dataset=mnist_test",
              "--checkpoint-dir", ckpt]
    try:
        done = run_cli(["train", *common, "--steps", str(MNIST_STEPS)])
        ev = run_cli(["eval", *common, "--eval-steps", "8"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = done["losses"]
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    emit("train_mlp_mnist", card=card, config="configs/mnist_mlp.json",
         steps=MNIST_STEPS, first20_mean_loss=first, last20_mean_loss=last,
         samples_per_s=done.get("samples_per_sec"),
         step_time_s=done.get("step_time_s"), eval=ev)
    if done["final_step"] != MNIST_STEPS or not last < first / 2:
        fail(f"phase 16d: mlp_mnist's loss went {first:.4f} -> {last:.4f} "
             f"over {MNIST_STEPS} steps (must halve)")
    if ev["checkpoint_step"] != MNIST_STEPS or not math.isfinite(
            ev["eval_loss"]):
        fail(f"phase 16d: eval from the checkpoint gave {ev}")


def families_phase(torch, card):
    """Phase 16: 16a, then 16b-16d over one shard server in this process.
    Returns the kernels-line figures (K1-K3's launches in 16b)."""
    import shutil
    import tempfile

    from serverless_learn_tpu_torch.control.daemons import ShardServer

    family_agreement(torch, card)
    root = tempfile.mkdtemp(prefix="slt-phase16-")
    srv = ShardServer(root=f"{root}/store").start()
    try:
        bert = bert_base_training(torch, card, srv.addr)
        resnet_cifar_training(torch, card, srv.addr, root)
        mlp_mnist_training(torch, card, srv.addr, root)
    finally:
        srv.stop()
        shutil.rmtree(root, ignore_errors=True)
    return {"bert_launches": bert}


def families_only(torch, build, card) -> int:
    """``--families-only``: phase 2 for the flash kernels, then phases 6,
    7 and 16, with no result line."""
    reports = build.build(["flash_attention"])
    build.load("flash_attention")
    faults = spill_faults(reports.get("flash_attention", ""),
                          NO_SPILL["flash_attention"])
    emit("build", card=card, ptxas=ptxas_summary(reports),
         spill_faults=faults)
    if faults:
        fail(f"the flash kernels spill registers: {faults}")
    check_flash(torch, card)
    time_flash(torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    families_phase(torch, card)
    return 0


def moe_only(torch, qm, build, card) -> int:
    """``--moe-only``: the K6 and flash kernels built, phase 15 alone, no
    result line."""
    build.build(["quant_matmul", "flash_attention"])
    for name in ("quant_matmul", "flash_attention"):
        build.load(name)
    moe_phase(torch, qm, card)
    return 0


def numerics_only(torch, build, card) -> int:
    sources = ["quant_matmul", "flash_attention", "cross_entropy",
               "tensor_stats"]
    reports = build.build(sources)
    for name in sources:
        build.load(name)
    faults = {name: spill_faults(reports.get(name, ""), kernels)
              for name, kernels in NO_SPILL.items()}
    emit("build", card=card, spill_faults=faults,
         ptxas={name: [ln.split("ptxas info    : ")[-1].strip()
                       for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
                for name, log in reports.items()})
    if any(faults.values()):
        fail(f"tensor-core kernels spill registers: {faults}")
    numerics_phase(torch, card)
    time_stats(torch, card)
    return 0


# Each phase's wall seconds in the full run, printed at its end.
PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall seconds kept under ``name`` and
    printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    emit("phase_seconds", name=name, seconds=PHASE_SECONDS[name])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    from serverless_learn_tpu_torch.ops import build
    from serverless_learn_tpu_torch.ops import quant_matmul as qm

    # The plain versions are the references: full f32 matmuls, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    if "--quant-matmul-only" in sys.argv[1:]:
        return quant_matmul_only(torch, qm, build, card)
    if "--qlora-only" in sys.argv[1:]:
        return qlora_only(torch, qm, build, card)
    if "--train-only" in sys.argv[1:]:
        return train_only(torch, build, card)
    if "--flash-only" in sys.argv[1:]:
        return flash_only(torch, build, card)
    if "--serve-only" in sys.argv[1:]:
        return serve_only(torch, build, card)
    if "--ckpt-train-only" in sys.argv[1:]:
        return ckpt_train_only(torch, build, card)
    if "--elastic-only" in sys.argv[1:]:
        build.build(["flash_attention", "tensor_stats"])
        build.load("flash_attention")
        elastic_cluster(torch, card, cache_on_disk=True)
        return 0
    if "--moe-only" in sys.argv[1:]:
        return moe_only(torch, qm, build, card)
    if "--numerics-only" in sys.argv[1:]:
        return numerics_only(torch, build, card)
    if "--families-only" in sys.argv[1:]:
        return families_only(torch, build, card)
    if "--nonfinite-only" in sys.argv[1:]:
        sources = ["quant_matmul", "flash_attention", "cross_entropy"]
        build.build(sources)
        for name in sources:
            build.load(name)
        nonfinite_check(torch, card, keep_going=True)
        return 0

    t0 = time.perf_counter()
    sources = ["quant_matmul", "flash_attention", "cross_entropy",
               "tensor_stats"]
    reports = build.build(sources)  # one nvcc per source, started together
    for name in sources:
        build.load(name)
    emit("build", card=card, seconds=time.perf_counter() - t0,
         ptxas=ptxas_summary(reports))
    faults = {name: spill_faults(reports.get(name, ""), kernels)
              for name, kernels in NO_SPILL.items()}
    if any(faults.values()):
        fail(f"tensor-core kernels spill registers or are missing from the "
             f"ptxas report: {faults}")
    PHASE_SECONDS["2_build"] = time.perf_counter() - t0

    max_err = timed("3_check_k6", check_kernel, torch, qm, card)
    timed("3_check_k6_dx", check_dx, torch, qm, card)
    fwd = timed("4_time_k6_decode", time_kernel, torch, qm, card)
    prefill_fwd = timed("4_time_k6_prefill", time_kernel, torch, qm, card,
                        R=PREFILL_ROWS)
    qlora_fwd = timed("4_time_k6_qlora", time_kernel, torch, qm, card,
                      R=QLORA_ROWS)
    timed("5_tiny_int8", tiny_agreement, torch, card)
    flash_err = timed("6_check_flash", check_flash, torch, card)
    flash_time = timed("7_time_flash", time_flash, torch, card)
    ce_err = timed("6b_check_ce", check_ce, torch, card)
    ce_time = timed("7b_time_ce", time_ce, torch, card)
    timed("8a_tiny_train", train_tiny_agreement, torch, card)
    timed("8c_tiny_lora", train_tiny_lora_agreement, torch, card)
    flash_launches = timed("8b_llama_1b", train_full_width, torch, card)
    lora_launches = timed("8d_lora_8b", train_lora_8b, torch, card)
    static_launches, model, static_replies, static_step = timed(
        "9_serve_static", serve_full_width, torch, card)
    launches, replayed = timed("9c_serve_continuous", serve_continuous,
                               torch, card, model, static_replies,
                               static_step)
    del model, static_replies
    gc.collect()
    torch.cuda.empty_cache()
    phase10, phase10_replayed = timed("10_checkpoints", checkpoint_path,
                                      torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    qlora = timed("11_qlora", qlora_8b, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    timed("12a_emergency", emergency_drill, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    elastic = timed("13_cluster", elastic_cluster, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    stats_launches = timed("14_numerics", numerics_phase, torch, card)
    stats_time = timed("14_time_stats", time_stats, torch, card)
    gc.collect()
    torch.cuda.empty_cache()
    moe = timed("15_moe", moe_phase, torch, qm, card)
    gc.collect()
    torch.cuda.empty_cache()
    families = timed("16_families", families_phase, torch, card)
    emit("phase_seconds_all", card=card, seconds=PHASE_SECONDS,
         total_s=time.perf_counter() - t0)

    kernels = [{
        "name": "quant_matmul", "route": "cuda",
        "source": "serverless_learn_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "serverless_learn_tpu/ops/pallas/quant_matmul.py:88",
        "launches": launches, "launches_graph_replayed": replayed,
        "launches_static_engine": static_launches,
        "launches_checkpoint_path": phase10["quant_matmul"],
        "launches_graph_replayed_checkpoint_path": phase10_replayed,
        "max_abs_err": max_err,
        "ms": fwd["ms"], "graph_ms": fwd["graph_ms"],
        "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"],
        "prefill_ms": prefill_fwd["ms"], "prefill_graph_ms": prefill_fwd[
            "graph_ms"], "prefill_bound_ms": prefill_fwd["bound_ms"],
        "prefill_library_ms": prefill_fwd["convert_matmul_ms"],
        "launches_qlora": qlora["launches"],
        "launches_qlora_per_step": qlora["per_step"],
        "qlora_ms": qlora_fwd["ms"], "qlora_bound_ms": qlora_fwd["bound_ms"],
        "qlora_library_ms": qlora_fwd["convert_matmul_ms"],
        "qlora_plain_ms": qlora_fwd["plain_ms"],
        "qlora_step_k6_ms": qlora["profile"]["k6_ms"],
        "qlora_weight_int8pack_mm_ms": qlora_fwd["library_ms"],
        "launches_moe_serving": moe["serve_launches"],
        "launches_graph_replayed_moe_serving": moe["replayed"],
        "max_abs_err_mixtral_shapes": moe["max_err"],
        "mixtral_decode_ms": moe["decode"]["ms"],
        "mixtral_decode_graph_ms": moe["decode"]["graph_ms"],
        "mixtral_decode_bound_ms": moe["decode"]["bound_ms"],
        "mixtral_decode_plain_ms": moe["decode"]["plain_ms"],
        "mixtral_decode_library_ms": moe["decode"]["library_ms"],
        "mixtral_prefill_ms": moe["prefill"]["ms"],
        "mixtral_prefill_bound_ms": moe["prefill"]["bound_ms"],
        "mixtral_prefill_library_ms": moe["prefill"]["library_ms"],
    }]
    replaces = {
        "flash_fwd": "serverless_learn_tpu/ops/pallas/flash_attention.py:197",
        "flash_dq": "serverless_learn_tpu/ops/pallas/flash_attention.py:403",
        "flash_dkv": "serverless_learn_tpu/ops/pallas/flash_attention.py:427",
    }
    for name, where in replaces.items():
        row = flash_time[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "serverless_learn_tpu_torch/csrc/flash_attention.cu",
            "replaces": where, "launches": flash_launches[name],
            "launches_checkpoint_path": phase10[name],
            "launches_elastic_worker": elastic[name],
            "launches_moe_training": moe["train"][name],
            "launches_bert_training": families["bert_launches"][name],
            "max_abs_err": flash_err[name], "ms": row["ms"],
            "sm_mhz": row["sm_mhz"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "bert_ms": row["bert"]["ms"],
            "bert_plain_ms": row["bert"]["plain_ms"],
            "bert_bound_ms": row["bert"]["bound_ms"],
            "bert_bound_by": row["bert"]["bound_by"],
            "bert_library_ms": row["bert"]["library_ms"],
            "bert_sm_mhz": row["bert"]["sm_mhz"]})
    replaces = {
        "cross_entropy_fwd":
            "serverless_learn_tpu/ops/pallas/cross_entropy.py:94",
        "cross_entropy_bwd":
            "serverless_learn_tpu/ops/pallas/cross_entropy.py:125",
    }
    for name, where in replaces.items():
        row = ce_time[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "serverless_learn_tpu_torch/csrc/cross_entropy.cu",
            "replaces": where, "launches": lora_launches[name],
            "launches_checkpoint_path": phase10[name],
            "launches_elastic_worker": elastic[name],
            "max_abs_err": ce_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    stats_source = "serverless_learn_tpu_torch/csrc/tensor_stats.cu"
    stats_replaces = {
        # Not TPU kernels: the jnp reductions XLA fuses into the reference's
        # step (_sub_stats, fingerprint) and their per-subtree sums.
        "tensor_stats": "serverless_learn_tpu/telemetry/numerics.py:109",
        "tensor_stats_many": "serverless_learn_tpu/telemetry/numerics.py:139",
        "stats_reduce": "serverless_learn_tpu/telemetry/numerics.py:132"}
    for name, where in stats_replaces.items():
        row = stats_time[name]
        kernels.append({
            "name": name, "route": "cuda", "source": stats_source,
            "replaces": where, "launches": stats_launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
