"""Command line of the PyTorch port: ``train``, ``eval``, ``serve``,
``generate``, the cluster's ``coordinator``, ``shard-server``,
``publish``, ``worker``, ``stats``, ``numerics`` and ``models``.

    python -m serverless_learn_tpu_torch train --model llama_1b \\
        --batch-size 2 --seq-len 4096 --steps 5
    python -m serverless_learn_tpu_torch train --model llama_1b \\
        --batch-size 2 --seq-len 4096 --steps 100 --checkpoint-every 50 \\
        --checkpoint-dir ckpts
    python -m serverless_learn_tpu_torch eval --model llama_1b \\
        --batch-size 2 --seq-len 4096 --checkpoint-dir ckpts --eval-steps 4
    python -m serverless_learn_tpu_torch generate --model llama_1b \\
        --checkpoint-dir ckpts --quant int8 --draft-layers 4 --spec-k 4
    python -m serverless_learn_tpu_torch train --model llama_8b \\
        --set model_overrides.lora_rank=16 --set model_overrides.remat=true \\
        --set model_overrides.fused_ce=true --batch-size 8 \\
        --set train.grad_accum=4 --seq-len 4096 --steps 3
    python -m serverless_learn_tpu_torch train --model llama_8b \\
        --set model_overrides.quant=int8 --set model_overrides.lora_rank=16 \\
        --set model_overrides.max_seq_len=1024 \\
        --set model_overrides.param_dtype=bfloat16 --set train.remat=true \\
        --batch-size 4 --seq-len 1024 --lr 2e-4 --steps 5
    python -m serverless_learn_tpu_torch serve --model llama_8b --quant int8
    python -m serverless_learn_tpu_torch serve --model llama_8b --quant int8 \\
        --serve-engine static --kv-monolithic
    python -m serverless_learn_tpu_torch generate --model llama_tiny \\
        --prompt 5,9,11 --max-new-tokens 8
    python -m serverless_learn_tpu_torch train --model llama_1b \\
        --batch-size 2 --seq-len 4096 --steps 100 --metrics-port 9100 \\
        --health --events-log run/events.jsonl --set train.eval_every=20
    python -m serverless_learn_tpu_torch serve --model llama_8b --quant int8 \\
        --metrics-port 9101 --profile-dir profiles
    python -m serverless_learn_tpu_torch coordinator --port P1 &
    python -m serverless_learn_tpu_torch shard-server --port P2 --root DIR &
    python -m serverless_learn_tpu_torch publish --shard-server localhost:P2 \\
        --dataset ds --format synthetic --model llama_1b --seq-len 4096
    python -m serverless_learn_tpu_torch worker --model llama_1b \\
        --batch-size 2 --seq-len 4096 --coordinator localhost:P1 \\
        --shard-server localhost:P2 --dataset ds --steps 100
    python -m serverless_learn_tpu_torch train --model llama_1b \\
        --batch-size 2 --seq-len 4096 --shard-server localhost:P2 \\
        --dataset ds --steps 100 --checkpoint-store localhost:P2
    python -m serverless_learn_tpu_torch train --model llama_1b \\
        --batch-size 2 --seq-len 4096 --steps 100 --numerics --health \\
        --events-log run/events.jsonl --set numerics.cadence=10
    python -m serverless_learn_tpu_torch numerics diff A.jsonl B.jsonl
    python -m serverless_learn_tpu_torch numerics summary run/events.jsonl
    python -m serverless_learn_tpu_torch numerics --self-check
    python -m serverless_learn_tpu_torch models
    python -m serverless_learn_tpu_torch publish --shard-server localhost:P2 \
        --dataset cifar --format cifar10 --path DIR
    python -m serverless_learn_tpu_torch train --model resnet18_cifar \
        --config configs/cifar_resnet18_dp4.json --set mesh.dp=1 \
        --batch-size 256 --shard-server localhost:P2 --dataset cifar \
        --set data.augment=true --steps 30 --checkpoint-dir ckpts
    python -m serverless_learn_tpu_torch train --model bert_base \
        --batch-size 64 --seq-len 512 --set train.grad_accum=2 --steps 5

The flags are those of the reference CLI (``serverless_learn_tpu/cli.py``)
for these paths. Checkpoints are the JAX package's (``training/
checkpoint.py``): ``train --checkpoint-dir`` writes them, ``eval`` restores
the whole state, ``generate`` and ``serve`` the params alone. Without
``--checkpoint-dir`` the weights are random, made from ``--seed``; with it,
a store that holds no checkpoint is an error, never random weights.
``--checkpoint-store ADDR`` puts the checkpoints on a shard server
instead. Every command that trains or serves runs on the card; ``--device
cpu`` is for tests only.

The cluster (``control/``, ``data/shard_client.py``,
``training/elastic.py``): ``coordinator`` and ``shard-server`` run the
port's daemons (0 picks a port; each prints its address);
``publish`` writes a dataset (``--format synthetic | mnist | cifar10 |
tokens | text``);
``train`` and ``eval`` with ``--shard-server ADDR --dataset NAME`` stream
it; ``worker`` trains as an elastic member of a coordinator's cluster,
re-forming at every membership epoch, its checkpoints in the shard server
(``--checkpoint-store``, default ``control.shard_server_addr``); ``stats``
prints a daemon's RPC and load statistics.

Telemetry flags of ``train``, ``eval`` and ``serve``, the reference's:
``--metrics-port`` serves ``/metrics``, ``/metrics.json``, ``/healthz``,
``/alerts``, ``/goodput`` and ``/debug/profile`` (0 picks a
port, printed in a ``{"event": "metrics"}`` line); ``--health`` runs the
health engine behind ``/alerts`` and ``/healthz``; ``--events-log``,
``--flight-dir`` and ``--node`` arm tracing and the flight recorder;
``--profile-dir`` arms the profiler (without a metrics port, ``train``
profiles the whole run). ``train`` with a checkpoint store arms the
emergency save (``checkpoint.emergency_save``), and its ``done`` line
carries ``goodput``, ``badput_breakdown`` and ``spans``.

``train --numerics`` (and ``worker --numerics``; config
``numerics.enabled``) turns on the numerics layer: the step's per-subtree
statistics and fingerprints on the card, fetched every
``numerics.cadence`` steps into ``numerics_stats`` records and
``/numerics``, NaN/Inf provenance at the first non-finite step, the
loss-health alerts with ``--health``. ``numerics diff A B`` bisects two
fingerprint trails (this package's or the JAX package's) to the first step
and subtree that diverged (exit 1 when they did), ``numerics summary
LOG...`` digests a run's trail, ``numerics --self-check`` checks the math.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import List, Optional

from serverless_learn_tpu_torch.config import (ExperimentConfig, apply_sets,
                                               coerce, not_ported)

_SERVE_SECTIONS = ("model_overrides", "kv", "health", "waterfall")

NOT_PORTED = {
    "distributed": "multi-process training (--world-size) is not yet ported "
                   "to PyTorch (ROADMAP.md queue 1 item 3, data parallel)",
}


def _overrides(items: Optional[List[str]],
               sections=("model_overrides",)) -> dict:
    """``--set section.key=value`` items -> {section: {key: value}} for the
    sections the command takes."""
    out = {name: {} for name in sections}
    for item in items or []:
        path, eq, val = item.partition("=")
        if not eq:
            raise SystemExit(f"--set expects dotted.key=value, got {item!r}")
        section, _, key = path.partition(".")
        if section not in out or not key:
            raise SystemExit(f"--set {path}: the port takes only "
                             + " or ".join(f"{name}.<field>=<value>"
                                           for name in sections))
        out[section][key] = coerce(val)
    return out


def _start_metrics(args):
    """The /metrics exporter when ``--metrics-port`` is given (the caller
    stops it); logs its address (port 0 picks one). ``--profile-dir`` arms
    the shared profiler: /debug/profile and alert-triggered captures."""
    from serverless_learn_tpu_torch.utils.metrics import log_json

    profile_dir = getattr(args, "profile_dir", None)
    if profile_dir:
        from serverless_learn_tpu_torch.telemetry import profiler

        profiler.arm(profile_dir)
    if args.metrics_port is None:
        return None
    from serverless_learn_tpu_torch.telemetry import MetricsExporter

    exp = MetricsExporter(port=args.metrics_port,
                          profile_dir=profile_dir).start()
    log_json({"event": "metrics", "addr": exp.addr,
              **({"profile_armed": True} if profile_dir else {})},
             stream=sys.stdout)
    return exp


def _start_health(args, health_cfg, exporter=None, registry=None):
    """The health engine when ``--health`` (or ``health.enabled``) asks for
    it, behind the exporter's /alerts and /healthz (the caller stops it).
    With the profiler armed, a critical alert captures a trace."""
    if not (args.health or health_cfg.enabled):
        return None
    from serverless_learn_tpu_torch.telemetry import profiler
    from serverless_learn_tpu_torch.telemetry.health import HealthEngine
    from serverless_learn_tpu_torch.utils.metrics import log_json

    engine = HealthEngine(registry=registry, config=health_cfg,
                          flight_dir=args.flight_dir).start()
    if exporter is not None:
        exporter.attach_health(engine)
    profile_armed = (profiler.armed()
                     and health_cfg.profile_on_critical_s > 0)
    if profile_armed:
        profiler.on_alert(engine, seconds=health_cfg.profile_on_critical_s,
                          cooldown_s=health_cfg.profile_cooldown_s)
    log_json({"event": "health", "interval_s": engine.interval_s,
              "slos": [s["name"] for s in engine.slos],
              **({"profile_on_critical_s": health_cfg.profile_on_critical_s}
                 if profile_armed else {}),
              **({"alerts_addr": exporter.addr} if exporter else {})},
             stream=sys.stdout)
    return engine


def _init_tracing_from_args(args):
    """Arm tracing and the flight recorder when ``--events-log``,
    ``--flight-dir`` or ``--node`` asks for them: a SIGTERM'd or crashing
    process then leaves ``flight-<node>-<ts>.json`` with its last spans."""
    from serverless_learn_tpu_torch.utils.metrics import log_json

    events_log, flight_dir = args.events_log, args.flight_dir
    if not (events_log or flight_dir or args.node):
        return
    from serverless_learn_tpu_torch.telemetry import init_tracing

    if flight_dir is None:
        flight_dir = (os.path.dirname(os.path.abspath(events_log))
                      if events_log else ".")
    name = init_tracing(node=args.node, events_log=events_log,
                        flight_dir=flight_dir)
    log_json({"event": "tracing", "node": name,
              **({"events_log": events_log} if events_log else {}),
              "flight_dir": flight_dir}, stream=sys.stdout)


def _make_store(args):
    """The checkpoint store the flags name: ``--checkpoint-store`` (a shard
    server), else ``--checkpoint-dir``, else None."""
    from serverless_learn_tpu_torch.training.checkpoint import (
        LocalStore, ShardServerStore)

    if args.checkpoint_store:
        return ShardServerStore(args.checkpoint_store)
    if args.checkpoint_dir:
        return LocalStore(args.checkpoint_dir)
    return None


def _make_checkpointer(args, cfg=None):
    """The store's Checkpointer, or None without a store; with ``cfg``,
    ``checkpoint.keep`` / ``checkpoint.verify`` from it and the store
    tiered by its cache and peers (``training/replicate.py``)."""
    from serverless_learn_tpu_torch.training.checkpoint import Checkpointer
    from serverless_learn_tpu_torch.training.replicate import (
        maybe_replicated)

    store = _make_store(args)
    if store is None:
        return None
    if cfg is None:
        return Checkpointer(store, name=args.checkpoint_name)
    return Checkpointer(maybe_replicated(store, cfg.checkpoint),
                        name=args.checkpoint_name, keep=cfg.checkpoint.keep,
                        verify=cfg.checkpoint.verify)


def _close_checkpointer(ckpt):
    """Drain and disarm ``ckpt``, then close its store: a replicated
    store's peer pushes, then the connection a shard-server store holds."""
    try:
        ckpt.close()
    finally:
        for store in (ckpt.store, getattr(ckpt.store, "primary", None)):
            if store is not None and hasattr(store, "close"):
                store.close()


def _load_inference_params(args, cfg):
    """(params, step) for a forward-only command: the newest checkpoint's
    params alone, restored on the host without a template (the optimizer
    moments never reach the card), checked against the serving model
    ``cfg`` by path and shape, as the port's named tensors."""
    from serverless_learn_tpu_torch.bridge import from_flax, to_flax
    from serverless_learn_tpu_torch.models.transformer import Transformer
    from serverless_learn_tpu_torch.utils.serialization import (
        leaves_with_paths)

    ckpt = _make_checkpointer(args)
    try:
        step = ckpt.latest_step()
        if step is None:
            raise SystemExit("no checkpoint found in the configured store")
        host = ckpt.restore_params_host(step=step)
    finally:
        _close_checkpointer(ckpt)
    if "pipe_blocks" in host or "pipe_blocks" in host.get("pipeline", {}):
        raise SystemExit(str(not_ported(
            "serving a pipeline-trained checkpoint (unstacking pipe_blocks)",
            "ROADMAP.md queue 1 item 5")))
    abstract = Transformer(cfg, device="meta")
    want = {p: tuple(t.shape) for p, t in leaves_with_paths(to_flax(
        dict(abstract.named_parameters()), cfg))}
    got = {p: tuple(t.shape) for p, t in leaves_with_paths(host)}
    problems = (
        [f"missing from checkpoint: {k}" for k in sorted(want.keys() - got)]
        + [f"not in serving model: {k}" for k in sorted(got.keys() - want)]
        + [f"{k}: checkpoint {got[k]} vs serving {want[k]}"
           for k in sorted(got.keys() & want) if got[k] != want[k]])
    if problems:
        raise SystemExit(
            f"checkpoint params do not fit the serving config ({args.model}"
            f", --set {args.set or []}): "
            + "; ".join(problems[:5])
            + (f" (+{len(problems) - 5} more)" if len(problems) > 5 else ""))
    return from_flax(host), step


def _model_from_args(args, overrides: dict):
    """(model, checkpoint step): the checkpoint's params restored in their
    trained dtype, then with ``--quant int8`` quantized one projection at a
    time on the card; without ``--checkpoint-dir``, random weights from
    ``--seed``."""
    import torch

    from serverless_learn_tpu_torch.inference.quantize import (
        quantize_params_int8)
    from serverless_learn_tpu_torch.models.registry import (build_model,
                                                            get_model_config,
                                                            resolve_device)
    from serverless_learn_tpu_torch.models.transformer import Transformer

    if not (args.checkpoint_dir or args.checkpoint_store):
        return build_model(args.model, device=args.device, quant=args.quant,
                           seed=args.seed, **overrides), None
    dev = resolve_device(args.device)
    cfg = get_model_config(args.model, **overrides)
    params, step = _load_inference_params(args, cfg)
    if args.quant:
        cfg = get_model_config(args.model, quant=args.quant, **overrides)
        params = {k: v for name, t in params.items() for k, v in
                  quantize_params_int8({name: t.to(dev)}).items()}
    model = Transformer(cfg, device=dev).eval()
    with torch.no_grad():
        model.load_state_dict(params)
    return model, step


def _kv_config(args, fields: dict):
    """The serving KVCacheConfig: ``--set kv.*``, then the dedicated
    flags, as the reference CLI builds it."""
    import dataclasses

    from serverless_learn_tpu_torch.config import KVCacheConfig

    try:
        kv = KVCacheConfig(**fields)
    except TypeError as e:
        raise SystemExit(f"--set kv.*: {e}")
    flags = {"block_size": args.kv_block_size,
             "num_blocks": args.kv_num_blocks,
             "prefill_chunk": args.prefill_chunk}
    if args.kv_monolithic:
        flags["paged"] = False
    if args.no_prefix_cache:
        flags["prefix_cache"] = False
    return dataclasses.replace(
        kv, **{k: v for k, v in flags.items() if v is not None})


def _parse_mesh(text: str) -> dict:
    out = {}
    for part in text.split(","):
        if part.strip():
            k, _, v = part.partition("=")
            out[k.strip()] = int(v)
    return out


def _train_config(args):
    """ExperimentConfig from ``--config``, then ``--set``, then the
    dedicated flags, as the reference CLI builds it."""
    raw = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    try:
        apply_sets(raw, args.set)
    except ValueError as e:
        raise SystemExit(str(e))
    flags = {("model",): args.model, ("train", "batch_size"): args.batch_size,
             ("train", "num_steps"): args.steps,
             ("optimizer", "learning_rate"): args.lr,
             ("optimizer", "name"): args.optimizer,
             ("data", "seq_len"): args.seq_len,
             ("train", "checkpoint_every"): args.checkpoint_every,
             ("data", "dataset"): args.dataset,
             ("numerics", "enabled"): True if args.numerics else None}
    if args.shard_server:
        flags[("data", "shard_server_addr")] = args.shard_server
        flags[("control", "shard_server_addr")] = args.shard_server
    if getattr(args, "coordinator", None):
        flags[("control", "coordinator_addr")] = args.coordinator
    if args.mesh:
        flags[("mesh",)] = {**raw.get("mesh", {}), **_parse_mesh(args.mesh)}
    for path, val in flags.items():
        if val is None:
            continue
        node = raw
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return ExperimentConfig.from_dict(raw)


def _refuse_unported(args):
    if args.world_size:
        raise SystemExit(NOT_PORTED["distributed"])


def cmd_train(args) -> int:
    """Train a model on the card; with ``--checkpoint-dir`` save every
    ``train.checkpoint_every`` steps and at the end, with the emergency
    save armed. Ends with the reference's ``done`` line on stdout."""
    from serverless_learn_tpu_torch.telemetry import goodput
    from serverless_learn_tpu_torch.telemetry.tracing import get_tracer
    from serverless_learn_tpu_torch.training.loop import run_training
    from serverless_learn_tpu_torch.training.train_step import build_trainer
    from serverless_learn_tpu_torch.utils.metrics import log_json

    _refuse_unported(args)
    cfg = _train_config(args)
    _init_tracing_from_args(args)
    before = _kernel_launches()
    ckpt = exporter = health = None
    try:
        exporter = _start_metrics(args)
        health = _start_health(args, cfg.health, exporter=exporter)
        bracket = contextlib.nullcontext()
        if args.profile_dir and exporter is None:
            # Without an endpoint, profile the whole run, through the
            # shared lock so nothing nests a second session.
            from serverless_learn_tpu_torch.telemetry.profiler import (
                capture_session)

            bracket = capture_session(args.profile_dir)
        ckpt = _make_checkpointer(args, cfg)
        trainer = callback = auditor = None
        if ckpt is not None or cfg.numerics.enabled:
            trainer = build_trainer(cfg, args.device)
        if cfg.numerics.enabled:
            # The checkpointer's host shadow is the provenance sweep's
            # first source.
            from serverless_learn_tpu_torch.training.audit import (
                NumericsAuditor)

            auditor = NumericsAuditor(
                cfg, bundle=trainer.bundle,
                shadow_fn=ckpt.host_shadow if ckpt is not None else None)
        if ckpt is not None:
            every = cfg.train.checkpoint_every
            if cfg.checkpoint.emergency_save:
                # A SIGTERM'd or crashing run commits its newest shadow,
                # losing at most emergency_min_interval_s of steps.
                ckpt.arm_emergency(
                    min_interval_s=cfg.checkpoint.emergency_min_interval_s)

            def callback(step, state, stats):
                held = ckpt.note_state(lambda: trainer.state_tree(state))
                if held is not None:
                    log_json({"event": "ckpt_shadow", "step": step,
                              "seconds": round(held, 6)})
                if every and step % every == 0:
                    ckpt.save(trainer.state_tree(state))

        with bracket:
            state, meter = run_training(cfg, trainer=trainer,
                                        step_callback=callback,
                                        verbose=args.verbose,
                                        device=args.device, auditor=auditor)
        if auditor is not None:
            auditor.close()
        if ckpt is not None:
            ckpt.save(trainer.state_tree(state))
            ckpt.wait()
        summary = meter.steady_state()
        grep = goodput.get_ledger().report(mfu=summary.get("mfu"))
        losses = [s.metrics["loss"] for s in meter.history]
        log_json({"event": "done", "final_step": state.step,
                  **{k: round(v, 3) for k, v in summary.items()},
                  "goodput": grep["goodput"],
                  "badput_breakdown": grep["badput_breakdown"],
                  "spans": get_tracer().summary(),
                  "losses": [round(x, 5) for x in losses],
                  "kernel_launches": {k: n - before[k] for k, n in
                                      _kernel_launches().items()}},
                 stream=sys.stdout)
    finally:
        if ckpt is not None:
            _close_checkpointer(ckpt)  # drain the upload, disarm the save
        if health is not None:
            health.stop()
        if exporter is not None:
            exporter.stop()
    return 0


def cmd_eval(args) -> int:
    """Forward-only metrics of a model: with ``--checkpoint-dir`` the
    newest checkpoint's whole state restored into the trainer's (a store
    without one exits), else a fresh init. Prints ``checkpoint_step`` and
    the mean ``eval_*`` metrics as one JSON line."""
    from serverless_learn_tpu_torch.training.loop import run_eval
    from serverless_learn_tpu_torch.training.train_step import build_trainer

    _refuse_unported(args)
    cfg = _train_config(args)
    _init_tracing_from_args(args)
    exporter = health = None
    try:
        exporter = _start_metrics(args)
        health = _start_health(args, cfg.health, exporter=exporter)
        trainer = build_trainer(cfg, args.device)
        ckpt = _make_checkpointer(args, cfg)
        state, step = trainer.init(), None
        if ckpt is not None:
            try:
                if ckpt.latest_step() is None:
                    # Metrics of a random init would look plausible and
                    # mean nothing where the user pointed at a store.
                    raise SystemExit(
                        "no checkpoint found in the configured store; drop "
                        "--checkpoint-dir to eval a fresh init")
                trainer.load_tree(state,
                                  ckpt.restore(trainer.state_tree(state)))
                step = state.step
            finally:
                _close_checkpointer(ckpt)
        metrics = run_eval(cfg, trainer, state,
                           num_batches=args.eval_steps or cfg.train.eval_steps)
    finally:
        if health is not None:
            health.stop()
        if exporter is not None:
            exporter.stop()
    print(json.dumps({"checkpoint_step": step,
                      **{k: round(float(v), 6) for k, v in metrics.items()}}))
    return 0


def cmd_generate(args) -> int:
    """Sample tokens from a causal LM; ``--draft-layers N`` decodes
    speculatively (greedy) with the model's own first N layers as the
    draft and adds the ``speculative`` stats."""
    import torch

    from serverless_learn_tpu_torch.inference.generate import generate
    from serverless_learn_tpu_torch.inference.speculative import (
        prefix_draft, speculative_generate)

    if args.draft_layers and args.temperature != 0.0:
        raise SystemExit("--draft-layers is greedy-only (temperature must "
                         "be 0)")
    model, step = _model_from_args(
        args, _overrides(args.set)["model_overrides"])
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    if args.prompt:
        prompt = torch.tensor([[int(t) for t in args.prompt.split(",")]],
                              dtype=torch.int32)
    else:
        prompt = torch.randint(0, model.cfg.vocab_size, (1, args.prompt_len),
                               generator=gen, device=model.device,
                               dtype=torch.int32)
    stats = None
    if args.draft_layers:
        try:
            out, stats = speculative_generate(
                model, prefix_draft(model, args.draft_layers), prompt,
                max_new_tokens=args.max_new_tokens, K=args.spec_k,
                eos_id=args.eos_id)
        except ValueError as e:  # --draft-layers, --spec-k or the window
            raise SystemExit(str(e))
    else:
        out = generate(model, prompt, max_new_tokens=args.max_new_tokens,
                       temperature=args.temperature, top_k=args.top_k,
                       eos_id=args.eos_id, generator=gen)
    rep = {"checkpoint_step": step, "prompt": prompt.tolist(),
           "tokens": out.cpu().tolist()}
    if stats is not None:
        rep["speculative"] = stats
    print(json.dumps(rep))
    return 0


def cmd_serve(args) -> int:
    """Serve generation requests (JSON lines over TCP) from a causal LM."""
    from serverless_learn_tpu_torch.config import (HealthConfig,
                                                   WaterfallConfig)
    from serverless_learn_tpu_torch.inference.server import GenerationServer

    if args.fleet:
        raise SystemExit(str(not_ported(
            "serving as a fleet replica (--fleet, fleet/)",
            "ROADMAP.md queue 1 item 5")))
    sets = _overrides(args.set, _SERVE_SECTIONS)
    kv = _kv_config(args, sets["kv"])
    try:
        health_cfg = HealthConfig(**sets["health"])
        waterfall = WaterfallConfig(**sets["waterfall"])
    except TypeError as e:
        raise SystemExit(f"--set: {e}")
    _init_tracing_from_args(args)
    model, step = _model_from_args(args, sets["model_overrides"])
    server = GenerationServer(model, host=args.host, port=args.port,
                              max_batch=args.max_batch,
                              batch_wait_ms=args.batch_wait_ms,
                              engine=args.serve_engine,
                              chunk_size=args.chunk_size, kv=kv,
                              metrics_port=args.metrics_port,
                              event_log_path=args.events_log,
                              profile_dir=args.profile_dir,
                              waterfall=waterfall)
    health = None
    try:
        health = _start_health(args, health_cfg, exporter=server._exporter,
                               registry=server.registry)
        print(json.dumps({"event": "serving", "addr": server.addr,
                          "model": args.model, "checkpoint_step": step,
                          "engine": args.serve_engine,
                          "kv": getattr(server.engine, "kv_stats",
                                        lambda: None)(),
                          **({"metrics_addr": server.metrics_addr}
                             if server.metrics_addr else {})}), flush=True)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if health is not None:
            health.stop()
        server.stop()
    return 0


def _kernel_launches():
    """{kernel wrapper: launches} of the flash and cross-entropy kernels."""
    from serverless_learn_tpu_torch.ops import cross_entropy as ce
    from serverless_learn_tpu_torch.ops import flash_attention as fa

    return {k.__name__: k.launches
            for k in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv,
                      ce.cross_entropy_fwd, ce.cross_entropy_bwd)}


def _with_ckpt_flags(cfg, args):
    """``cfg`` with ``worker``'s ``--ckpt-cache-dir``, ``--ckpt-peers`` and
    ``--ckpt-serve-cache`` over its ``checkpoint`` section, as the
    reference merges them: a flag given wins, the config's field stays
    otherwise."""
    import dataclasses

    if (args.ckpt_cache_dir is None and args.ckpt_peers is None
            and not args.ckpt_serve_cache):
        return cfg
    ck = cfg.checkpoint
    return dataclasses.replace(cfg, checkpoint=dataclasses.replace(
        ck, cache_dir=(args.ckpt_cache_dir if args.ckpt_cache_dir is not None
                       else ck.cache_dir),
        peers=args.ckpt_peers if args.ckpt_peers is not None else ck.peers,
        serve_cache=args.ckpt_serve_cache or ck.serve_cache))


def cmd_worker(args) -> int:
    """An elastic worker: register with the coordinator under an exclusive
    name, train, and re-form at every membership epoch (drain, save,
    re-form, restore). Ends with the reference's ``worker_done`` line on
    stdout, with the port's figures beside it."""
    import socket

    from serverless_learn_tpu_torch.models.registry import resolve_device
    from serverless_learn_tpu_torch.telemetry import goodput
    from serverless_learn_tpu_torch.training.checkpoint import (
        ShardServerStore)
    from serverless_learn_tpu_torch.training.elastic import ElasticTrainer
    from serverless_learn_tpu_torch.utils.metrics import log_json

    _refuse_unported(args)
    if args.multihost:
        raise SystemExit(str(not_ported(
            "the multi-host elastic worker (--multihost, "
            "training/elastic_multihost.py)", "ROADMAP.md queue 1 item 5")))
    cfg = _with_ckpt_flags(_train_config(args), args)
    resolve_device(args.device)  # no card: raise before joining anyone
    _init_tracing_from_args(args)
    store = _make_store(args) or ShardServerStore(
        cfg.control.shard_server_addr)
    before = _kernel_launches()
    exporter = health = None
    try:
        exporter = _start_metrics(args)
        health = _start_health(args, cfg.health, exporter=exporter)
        et = ElasticTrainer(
            cfg, store, coordinator_addr=cfg.control.coordinator_addr,
            advertise_addr=args.advertise,
            name=args.name or f"worker-{socket.gethostname()}-{os.getpid()}",
            device=args.device, verbose=args.verbose)
        if et.cache_server is not None:
            log_json({"event": "ckpt_cache_serving",
                      "addr": et.cache_server.addr,
                      "root": cfg.checkpoint.cache_dir}, stream=sys.stdout)
        state, losses = et.run()
        grep = goodput.get_ledger().report()
        log_json({"event": "worker_done", "steps": len(losses),
                  "final_loss": losses[-1] if losses else None,
                  "transitions": len(et.transitions),
                  "final_step": state.step,
                  **et.summary(cfg.data.seq_len, cfg.train.batch_size),
                  "goodput": grep["goodput"],
                  "badput_breakdown": grep["badput_breakdown"],
                  "kernel_launches": {k: n - before[k] for k, n in
                                      _kernel_launches().items()}},
                 stream=sys.stdout)
    finally:
        if health is not None:
            health.stop()
        if exporter is not None:
            exporter.stop()
    return 0


def cmd_coordinator(args) -> int:
    """The port's coordinator (``control/daemons.py``) in this process."""
    from serverless_learn_tpu_torch.control.daemons import main_coordinator

    if args.gossip or args.gossip_port is not None:
        raise SystemExit(str(not_ported(
            "the coordinator's SWIM gossip seed (--gossip, "
            "control/gossip.py)", "ROADMAP.md queue 1 item 5")))
    argv = ["--port", str(args.port), "--host", args.host,
            "--lease_ttl_ms", str(args.lease_ttl_ms),
            "--sweep_ms", str(args.sweep_ms)]
    if args.state_file:
        argv += ["--state_file", args.state_file]
    if args.events_log:
        argv += ["--events_log", args.events_log]
    return main_coordinator(argv)


def cmd_shard_server(args) -> int:
    """The port's shard server (``control/daemons.py``) in this process."""
    from serverless_learn_tpu_torch.control.daemons import main_shard_server

    argv = ["--port", str(args.port), "--host", args.host]
    if args.root:
        argv += ["--root", args.root]
    if args.events_log:
        argv += ["--events_log", args.events_log]
    return main_shard_server(argv)


def cmd_publish(args) -> int:
    """Publish a dataset to a shard server: ``synthetic`` (a model's batch
    schema, sampled from ``--seed``), ``mnist`` (an IDX directory) or
    ``cifar10`` (the binary batches) under ``--path`` and ``--split``,
    ``tokens`` (a token corpus file) or ``text`` (a text corpus, BPE with
    ``--vocab``/``--merges`` or byte level, packed). ``imagefolder``
    raises: its decoder needs PIL."""
    from serverless_learn_tpu_torch.config import DataConfig
    from serverless_learn_tpu_torch.data.shard_client import (
        publish_dataset, publish_from_bundle)

    per_shard = args.records_per_shard or 512
    if args.format == "synthetic":
        from serverless_learn_tpu_torch.models.registry import get_model

        if not args.model:
            raise SystemExit("--format synthetic requires --model")
        bundle = get_model(args.model)
        meta = publish_from_bundle(
            args.shard_server, args.dataset, bundle.make_batch,
            DataConfig(seq_len=args.seq_len), num_records=args.num_records,
            records_per_shard=per_shard, seed=args.seed)
    elif args.format in ("tokens", "text"):
        if not args.path:
            raise SystemExit(f"--format {args.format} requires --path")
        if args.format == "tokens":
            from serverless_learn_tpu_torch.data.raw import load_token_corpus

            arrays = load_token_corpus(args.path, seq_len=args.seq_len)
        else:
            from serverless_learn_tpu_torch.data.tokenizer import (
                load_text_corpus)

            arrays = load_text_corpus(args.path, seq_len=args.seq_len,
                                      vocab_file=args.vocab,
                                      merges_file=args.merges)
        meta = publish_dataset(args.shard_server, args.dataset, arrays,
                               records_per_shard=per_shard)
    else:
        from serverless_learn_tpu_torch.data.raw import LOADERS

        if not args.path:
            raise SystemExit(f"--format {args.format} requires --path")
        try:
            arrays = LOADERS[args.format](args.path, split=args.split)
        except NotImplementedError as e:
            raise SystemExit(str(e))
        meta = publish_dataset(args.shard_server, args.dataset, arrays,
                               records_per_shard=per_shard)
    print(json.dumps({"dataset": args.dataset,
                      "num_records": meta.num_records,
                      "num_shards": meta.num_shards,
                      "fields": [f.name for f in meta.fields]}))
    return 0


def cmd_models(args) -> int:
    """The registered model families, one a line."""
    from serverless_learn_tpu_torch.models.registry import list_models

    for name in list_models():
        print(name)
    return 0


def rpc_stats(rep) -> dict:
    """``StatsReply.rpc`` as {"rpc/<name>": {count, total_s, mean_s,
    max_s}}, the reference's ``utils/tracing.rpc_stats``."""
    from serverless_learn_tpu_torch.control.wire import MSG_TYPE_NAMES

    out = {}
    for s in rep.rpc:
        name = MSG_TYPE_NAMES.get(s.msg_type, f"msg_{s.msg_type}")
        out[f"rpc/{name}"] = {
            "count": s.count, "total_s": s.total_us / 1e6,
            "mean_s": (s.total_us / s.count / 1e6) if s.count else 0.0,
            "max_s": s.max_us / 1e6}
    return out


def cmd_stats(args) -> int:
    """A daemon's RPC latencies and, for the shard server, its load."""
    from serverless_learn_tpu_torch.control.client import (CoordinatorClient,
                                                           ShardClient)

    cls = CoordinatorClient if args.kind == "coordinator" else ShardClient
    c = cls(args.addr)
    try:
        rep = c.stats()
    finally:
        c.close()
    out = {"rpc": rpc_stats(rep)}
    if args.kind == "shard-server":
        for k in ("bytes_served", "bytes_stored", "active_streams",
                  "crc_failures", "throttled_chunks",
                  "starved_streams_served"):
            out[k] = getattr(rep, k)
    else:
        out["flows"] = [f.to_dict() for f in rep.flows]
    print(json.dumps(out, indent=2))
    return 0


def cmd_numerics(args) -> int:
    """Training-quality trails (``telemetry/numerics.py``): ``diff A B``
    bisects two fingerprint trails (event logs, ``numerics.fingerprint_log``
    files or flight dumps) to the first step and subtree that diverged,
    exit 1 when they did; ``summary LOG...`` digests audited steps, grad
    norm and update-ratio ranges and non-finite incidents, exit 1 when
    there was one; ``--self-check`` checks the math."""
    from serverless_learn_tpu_torch.telemetry import numerics

    if args.self_check:
        rep = numerics.self_check()
        print(json.dumps(rep, indent=None if args.compact else 2))
        return 0 if rep["ok"] else 1
    if args.action == "diff":
        if len(args.paths) != 2:
            print("numerics diff needs exactly two fingerprint trails",
                  file=sys.stderr)
            return 2
        rep = numerics.diff_fingerprint_logs(
            numerics.load_records(args.paths[0]),
            numerics.load_records(args.paths[1]),
            rtol=args.rtol, atol=args.atol)
        rep = {"log_a": args.paths[0], "log_b": args.paths[1], **rep}
        print(json.dumps(rep, indent=None if args.compact else 2))
        return 1 if rep.get("diverged") else 0
    if args.action == "summary":
        if not args.paths:
            print("numerics summary needs JSONL event logs",
                  file=sys.stderr)
            return 2
        records = []
        for path in args.paths:
            records.extend(numerics.load_records(path))
        stats = [r for r in records if r.get("event") == "numerics_stats"]
        bad = [r for r in records
               if r.get("event") == "numerics_nonfinite"]
        out = {"records": len(records), "audited_steps": len(stats),
               "steps": [r.get("step") for r in stats[:3]]
               + (["..."] if len(stats) > 6 else [])
               + [r.get("step") for r in stats[-3:]]
               if stats else [],
               "nonfinite_incidents": [
                   {"step": r.get("step"), "first": r.get("first"),
                    "bad_subtrees": r.get("bad_subtrees")}
                   for r in bad]}
        if stats:
            gnorms = [r["grad_norm"] for r in stats
                      if isinstance(r.get("grad_norm"), (int, float))]
            ratios = [r["update_ratio"] for r in stats
                      if isinstance(r.get("update_ratio"), (int, float))]
            if gnorms:
                out["grad_norm"] = {"min": round(min(gnorms), 6),
                                    "max": round(max(gnorms), 6),
                                    "last": round(gnorms[-1], 6)}
            if ratios:
                out["update_ratio"] = {"min": round(min(ratios), 9),
                                       "max": round(max(ratios), 9),
                                       "last": round(ratios[-1], 9)}
        print(json.dumps(out, indent=None if args.compact else 2))
        return 1 if bad else 0
    print("numerics needs an action (diff | summary) or --self-check",
          file=sys.stderr)
    return 2


def _add_model_flags(p: argparse.ArgumentParser):
    p.add_argument("--model", required=True,
                   help="registered model name (the models command "
                        "lists them)")
    p.add_argument("--set", action="append", metavar="model_overrides.K=V",
                   help="override a model config field, e.g. --set "
                        "model_overrides.n_layers=4; serve also takes the "
                        "KV cache's, the health engine's and the waterfall's,"
                        " e.g. --set kv.block_size=32")
    p.add_argument("--quant", choices=["int8"], default=None,
                   help="weight-only int8 projections (the hand-written "
                        "int8 matmul kernel on the card)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (and, for generate, of "
                        "the random prompt and the sampling)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for tests only")
    _add_checkpoint_flags(p)


def _add_telemetry_flags(p: argparse.ArgumentParser):
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve /metrics, /metrics.json, /healthz, /alerts, "
                        "/goodput and /debug/profile from this "
                        "port (0 = auto)")
    p.add_argument("--health", action="store_true",
                   help="run the health engine (anomaly, SLO burn-rate and "
                        "staleness detectors) behind /alerts and /healthz")
    p.add_argument("--events-log", metavar="PATH", default=None,
                   help="append one JSONL record per span and event here; "
                        "also arms the flight recorder")
    p.add_argument("--flight-dir", metavar="DIR", default=None,
                   help="flight-recorder dumps on SIGTERM or a crash "
                        "(default: the events log's directory, or cwd)")
    p.add_argument("--node", default=None,
                   help="node name stamped on records (default "
                        "<hostname>-<pid>; SLT_NODE overrides)")
    p.add_argument("--profile-dir", metavar="DIR", default=None,
                   help="arm the profiler: /debug/profile?seconds=N on the "
                        "metrics endpoint, alert-triggered captures with "
                        "--health; train without --metrics-port profiles "
                        "the whole run")


def _add_checkpoint_flags(p: argparse.ArgumentParser):
    p.add_argument("--checkpoint-dir", default=None,
                   help="a local checkpoint store (the JAX package's "
                        "format)")
    p.add_argument("--checkpoint-name", default="ckpt",
                   help="checkpoint namespace inside the store")
    p.add_argument("--checkpoint-store", metavar="ADDR", default=None,
                   help="keep checkpoints on this shard server")


def _add_train_flags(p: argparse.ArgumentParser):
    p.add_argument("--config", help="JSON config file (ExperimentConfig)")
    p.add_argument("--set", action="append", metavar="dotted.key=value",
                   help="override any config field, e.g. --set "
                        "train.seed=3")
    p.add_argument("--model", help="registered model name (the models "
                                   "command lists them)")
    p.add_argument("--mesh", help="mesh axes; only a one-device mesh "
                                  "(e.g. dp=1) is ported")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--steps", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--optimizer",
                   help="adamw | adam | sgd | adafactor | lion | rmsprop")
    p.add_argument("--seq-len", type=int)
    p.add_argument("--verbose", action="store_true",
                   help="log every train.log_every steps to stderr")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for tests only")
    _add_checkpoint_flags(p)
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="save every N steps (config train.checkpoint_every)")
    p.add_argument("--dataset", default=None,
                   help="the published dataset to stream (config "
                        "data.dataset)")
    p.add_argument("--shard-server", metavar="ADDR", default=None,
                   help="stream data from this shard server")
    p.add_argument("--world-size", type=int, default=None,
                   help="not yet ported: raises")
    p.add_argument("--numerics", action="store_true",
                   help="training-quality observability: per-subtree "
                        "tensor stats and fingerprints in the step, fetched "
                        "every numerics.cadence steps, NaN/Inf provenance "
                        "at the first non-finite step, loss-health alerts "
                        "with --health (config numerics.enabled=true does "
                        "the same)")
    _add_telemetry_flags(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="serverless_learn_tpu_torch",
        description="PyTorch/CUDA port of serverless-learn-tpu: training, "
                    "eval, serving and the elastic cluster")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model on the card")
    _add_train_flags(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="forward-only eval (optionally from "
                                    "a checkpoint)")
    _add_train_flags(e)
    e.add_argument("--eval-steps", type=int, default=None,
                   help="eval batches (default: train.eval_steps)")
    e.set_defaults(fn=cmd_eval)

    g = sub.add_parser("generate", help="sample tokens from a causal LM")
    _add_model_flags(g)
    g.add_argument("--prompt", help="comma-separated prompt token ids")
    g.add_argument("--prompt-len", type=int, default=8,
                   help="random prompt length when --prompt is unset")
    g.add_argument("--max-new-tokens", type=int, default=32)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--eos-id", type=int, default=None)
    g.add_argument("--draft-layers", type=int, default=0,
                   help="speculative decoding: draft with the model's own "
                        "first N layers, verify K drafts in one pass "
                        "(greedy-exact)")
    g.add_argument("--spec-k", type=int, default=4,
                   help="drafted tokens per verify pass (--draft-layers)")
    g.set_defaults(fn=cmd_generate)

    sv = sub.add_parser("serve",
                        help="serve LM generation over TCP (JSON lines)")
    _add_model_flags(sv)
    _add_telemetry_flags(sv)
    sv.add_argument("--host", default="127.0.0.1",
                    help="bind address (0.0.0.0 to accept remote clients)")
    sv.add_argument("--port", type=int, default=50060)
    sv.add_argument("--max-batch", type=int, default=8,
                    help="admission queue coalesces up to this many "
                         "compatible concurrent requests per device batch")
    sv.add_argument("--batch-wait-ms", type=float, default=3.0,
                    help="how long the dispatcher waits to co-batch "
                         "requests (latency floor under load)")
    sv.add_argument("--serve-engine", choices=["continuous", "static"],
                    default="continuous",
                    help="continuous: slot-level scheduler (admit at chunk "
                         "boundaries, retire at EOS, FIFO); static: the "
                         "group coalescer")
    sv.add_argument("--chunk-size", type=int, default=32,
                    help="decode tokens per chunk between admission "
                         "boundaries (continuous engine; one CUDA graph "
                         "replayed this many times)")
    sv.add_argument("--kv-monolithic", action="store_true",
                    help="monolithic per-slot KV rows instead of the paged "
                         "block pool (the equivalence baseline)")
    sv.add_argument("--kv-block-size", type=int, default=None,
                    help="paged KV: tokens per block (config kv.block_size)")
    sv.add_argument("--kv-num-blocks", type=int, default=None,
                    help="paged KV: pool blocks per layer; 0 = auto "
                         "no-overcommit sizing (config kv.num_blocks)")
    sv.add_argument("--prefill-chunk", type=int, default=None,
                    help="paged KV: prompt tokens per prefill chunk "
                         "interleaved between decode boundaries "
                         "(config kv.prefill_chunk; 0 = whole prompt)")
    sv.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix block reuse "
                         "(config kv.prefix_cache)")
    sv.add_argument("--fleet", action="store_true",
                    help="not yet ported: raises")
    sv.set_defaults(fn=cmd_serve)

    w = sub.add_parser("worker", help="elastic worker: join a cluster and "
                                      "train")
    _add_train_flags(w)
    w.add_argument("--coordinator", metavar="ADDR", default=None,
                   help="the coordinator (config control.coordinator_addr)")
    w.add_argument("--advertise", default="local:0",
                   help="address advertised to peers")
    w.add_argument("--name", default=None,
                   help="worker name = checkpoint namespace; default unique "
                        "per host and process. Two live workers never share "
                        "a name (refused at registration)")
    w.add_argument("--multihost", metavar="RUN", default=None,
                   help="not yet ported: raises")
    w.add_argument("--ckpt-cache-dir", default=None,
                   help="worker-local checkpoint cache dir: a transition's "
                        "restore reads local disk instead of the central "
                        "store; served to peers with --ckpt-serve-cache")
    w.add_argument("--ckpt-peers", default=None,
                   help="comma-separated peer cache addrs to replicate "
                        "checkpoints to (and restore from when the "
                        "central store is slow or partitioned)")
    w.add_argument("--ckpt-serve-cache", action="store_true",
                   help="serve --ckpt-cache-dir to peers over the "
                        "shard-server wire protocol (ephemeral port)")
    w.set_defaults(fn=cmd_worker)

    c = sub.add_parser("coordinator", help="run the membership daemon")
    c.add_argument("--port", type=int, default=50052, help="0 picks one")
    c.add_argument("--host", default="0.0.0.0", help="bind address")
    c.add_argument("--lease-ttl-ms", type=int, default=5000)
    c.add_argument("--sweep-ms", type=int, default=500)
    c.add_argument("--state-file", default=None,
                   help="persist membership here: a restarted coordinator "
                        "resumes the same epoch and worker ids")
    c.add_argument("--events-log", metavar="PATH", default=None,
                   help="append a JSONL server-side span per traced RPC")
    c.add_argument("--gossip", action="store_true",
                   help="not yet ported: raises")
    c.add_argument("--gossip-port", type=int, default=None,
                   help="not yet ported: raises")
    c.set_defaults(fn=cmd_coordinator)

    s = sub.add_parser("shard-server", help="run the data-plane daemon")
    s.add_argument("--port", type=int, default=50053, help="0 picks one")
    s.add_argument("--host", default="0.0.0.0", help="bind address")
    s.add_argument("--root", help="blob root directory")
    s.add_argument("--events-log", metavar="PATH", default=None,
                   help="append a JSONL server-side span per traced RPC")
    s.set_defaults(fn=cmd_shard_server)

    pub = sub.add_parser("publish",
                         help="publish a dataset to the data plane")
    pub.add_argument("--shard-server", required=True, metavar="ADDR")
    pub.add_argument("--dataset", required=True)
    pub.add_argument("--format", default="synthetic",
                     choices=["synthetic", "mnist", "cifar10", "imagefolder",
                              "tokens", "text"],
                     help="synthetic: sample a model's batch schema; "
                          "tokens: chunk a corpus file (.bin token dump or "
                          "raw text); text: tokenize a text corpus "
                          "(--vocab/--merges for GPT-2-format BPE, else "
                          "byte-level) and pack documents densely; mnist, "
                          "cifar10: the dataset files under --path "
                          "(imagefolder is not yet ported)")
    pub.add_argument("--path", help="corpus file (tokens, text) or the "
                                    "dataset's directory (mnist, cifar10)")
    pub.add_argument("--split", default="train", choices=["train", "test"])
    pub.add_argument("--model", default=None,
                     help="synthetic: the model whose batch schema to "
                          "publish")
    pub.add_argument("--num-records", type=int, default=4096,
                     help="synthetic: how many records")
    pub.add_argument("--records-per-shard", type=int, default=None,
                     help="records per shard (default 512)")
    pub.add_argument("--seq-len", type=int, default=128)
    pub.add_argument("--seed", type=int, default=0)
    pub.add_argument("--vocab", default=None,
                     help="text: GPT-2-style vocab.json")
    pub.add_argument("--merges", default=None,
                     help="text: GPT-2-style merges.txt")
    pub.set_defaults(fn=cmd_publish)

    st = sub.add_parser("stats", help="a daemon's load and RPC stats")
    st.add_argument("--addr", required=True)
    st.add_argument("--kind", choices=["coordinator", "shard-server"],
                    default="shard-server")
    st.set_defaults(fn=cmd_stats)

    nm = sub.add_parser(
        "numerics",
        help="training-quality trails: fingerprint diff, run summaries, "
             "self-check",
        description="Bisect two recorded fingerprint trails to the first "
                    "divergent step and parameter subtree (diff), digest a "
                    "run's numerics trail (summary), or check the math "
                    "(--self-check). train --numerics writes "
                    "numerics_stats and numerics_nonfinite records into "
                    "--events-log, and numerics_fingerprint records into "
                    "numerics.fingerprint_log.")
    nm.add_argument("action", nargs="?", choices=["diff", "summary"],
                    help="diff: bisect two trails; summary: digest logs")
    nm.add_argument("paths", nargs="*",
                    help="JSONL trails (event logs, fingerprint logs, "
                         "flight dumps)")
    nm.add_argument("--rtol", type=float, default=1e-5,
                    help="relative tolerance for digest agreement")
    nm.add_argument("--atol", type=float, default=1e-6,
                    help="absolute tolerance for digest agreement")
    nm.add_argument("--self-check", action="store_true",
                    help="run the numerics self-check")
    nm.add_argument("--compact", action="store_true")
    nm.set_defaults(fn=cmd_numerics)

    m = sub.add_parser("models", help="list registered model families")
    m.set_defaults(fn=cmd_models)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
