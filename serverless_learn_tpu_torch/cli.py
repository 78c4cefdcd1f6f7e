"""Command line of the PyTorch port: ``train``, ``serve`` and ``generate``.

    python -m serverless_learn_tpu_torch train --model llama_1b \\
        --batch-size 2 --seq-len 4096 --steps 5
    python -m serverless_learn_tpu_torch train --model llama_8b \\
        --set model_overrides.lora_rank=16 --set model_overrides.remat=true \\
        --set model_overrides.fused_ce=true --batch-size 8 \\
        --set train.grad_accum=4 --seq-len 4096 --steps 3
    python -m serverless_learn_tpu_torch serve --model llama_8b --quant int8
    python -m serverless_learn_tpu_torch serve --model llama_8b --quant int8 \\
        --serve-engine static --kv-monolithic
    python -m serverless_learn_tpu_torch generate --model llama_tiny \\
        --prompt 5,9,11 --max-new-tokens 8

The flags are those of the reference CLI (``serverless_learn_tpu/cli.py``)
for these paths. Weights are random, made from a seed; checkpoints are not
ported yet. Every command runs on the card; ``--device cpu`` is for tests
only.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from serverless_learn_tpu_torch.config import (ExperimentConfig, apply_sets,
                                               coerce)

NOT_PORTED = {
    "checkpoint": "checkpoint restore is not yet ported to PyTorch "
                  "(ROADMAP.md queue 1 item 2); weights come from --seed",
    "distributed": "multi-process training (--world-size) is not yet ported "
                   "to PyTorch (ROADMAP.md queue 1 item 3, data parallel)",
    "shard_server": "streaming data from the shard server is not yet ported "
                    "to PyTorch (ROADMAP.md queue 1 item 5)",
    "telemetry": "the metrics endpoint and the health engine are not yet "
                 "ported to PyTorch (ROADMAP.md queue 1 item 3, the loop's "
                 "telemetry)",
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


def _model_from_args(args, overrides: dict):
    from serverless_learn_tpu_torch.models.registry import build_model

    if args.checkpoint_dir:
        raise SystemExit(NOT_PORTED["checkpoint"])
    return build_model(args.model, device=args.device, quant=args.quant,
                       seed=args.seed, **overrides)


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
             ("data", "seq_len"): args.seq_len}
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


def cmd_train(args) -> int:
    """Train a model on the card; ends with the reference's ``done`` line
    on stdout."""
    from serverless_learn_tpu_torch.training.loop import run_training
    from serverless_learn_tpu_torch.utils.metrics import log_json

    if args.checkpoint_dir:
        raise SystemExit(NOT_PORTED["checkpoint"])
    if args.world_size:
        raise SystemExit(NOT_PORTED["distributed"])
    if args.shard_server:
        raise SystemExit(NOT_PORTED["shard_server"])
    if args.metrics_port is not None or args.health:
        raise SystemExit(NOT_PORTED["telemetry"])
    from serverless_learn_tpu_torch.ops import cross_entropy as ce
    from serverless_learn_tpu_torch.ops import flash_attention as fa

    cfg = _train_config(args)
    kernels = (fa.flash_fwd, fa.flash_dq, fa.flash_dkv, ce.cross_entropy_fwd,
               ce.cross_entropy_bwd)
    before = [k.launches for k in kernels]
    state, meter = run_training(cfg, verbose=args.verbose,
                                device=args.device)
    summary = meter.steady_state()
    losses = [s.metrics["loss"] for s in meter.history]
    log_json({"event": "done", "final_step": state.step,
              **{k: round(v, 3) for k, v in summary.items()},
              "losses": [round(x, 5) for x in losses],
              "kernel_launches": {k.__name__: k.launches - n
                                  for k, n in zip(kernels, before)}},
             stream=sys.stdout)
    return 0


def cmd_generate(args) -> int:
    """Sample tokens from a causal LM."""
    import torch

    from serverless_learn_tpu_torch.inference.generate import generate

    model = _model_from_args(args, _overrides(args.set)["model_overrides"])
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    if args.prompt:
        prompt = torch.tensor([[int(t) for t in args.prompt.split(",")]],
                              dtype=torch.int32)
    else:
        prompt = torch.randint(0, model.cfg.vocab_size, (1, args.prompt_len),
                               generator=gen, device=model.device,
                               dtype=torch.int32)
    out = generate(model, prompt, max_new_tokens=args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   eos_id=args.eos_id, generator=gen)
    print(json.dumps({"checkpoint_step": None,
                      "prompt": prompt.tolist(),
                      "tokens": out.cpu().tolist()}))
    return 0


def cmd_serve(args) -> int:
    """Serve generation requests (JSON lines over TCP) from a causal LM."""
    from serverless_learn_tpu_torch.inference.server import GenerationServer

    sets = _overrides(args.set, ("model_overrides", "kv"))
    kv = _kv_config(args, sets["kv"])
    model = _model_from_args(args, sets["model_overrides"])
    server = GenerationServer(model, host=args.host, port=args.port,
                              max_batch=args.max_batch,
                              batch_wait_ms=args.batch_wait_ms,
                              engine=args.serve_engine,
                              chunk_size=args.chunk_size, kv=kv)
    print(json.dumps({"event": "serving", "addr": server.addr,
                      "model": args.model, "engine": args.serve_engine,
                      "kv": getattr(server.engine, "kv_stats",
                                    lambda: None)()}), flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def _add_model_flags(p: argparse.ArgumentParser):
    p.add_argument("--model", required=True,
                   help="registered model name (llama_tiny, llama_1b, "
                        "llama_8b)")
    p.add_argument("--set", action="append", metavar="model_overrides.K=V",
                   help="override a model config field, e.g. --set "
                        "model_overrides.n_layers=4; serve also takes the "
                        "KV cache's, e.g. --set kv.block_size=32")
    p.add_argument("--quant", choices=["int8"], default=None,
                   help="weight-only int8 projections (the hand-written "
                        "int8 matmul kernel on the card)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (and, for generate, of "
                        "the random prompt and the sampling)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for tests only")
    p.add_argument("--checkpoint-dir", default=None,
                   help="not yet ported: raises")


def _add_train_flags(p: argparse.ArgumentParser):
    p.add_argument("--config", help="JSON config file (ExperimentConfig)")
    p.add_argument("--set", action="append", metavar="dotted.key=value",
                   help="override any config field, e.g. --set "
                        "train.seed=3")
    p.add_argument("--model", help="registered model name (llama_tiny, "
                                   "llama_1b, llama_8b)")
    p.add_argument("--mesh", help="mesh axes; only a one-device mesh "
                                  "(e.g. dp=1) is ported")
    p.add_argument("--batch-size", type=int)
    p.add_argument("--steps", type=int)
    p.add_argument("--lr", type=float)
    p.add_argument("--optimizer", help="adamw | adam | sgd (adafactor, lion "
                                       "and rmsprop are not ported)")
    p.add_argument("--seq-len", type=int)
    p.add_argument("--verbose", action="store_true",
                   help="log every train.log_every steps to stderr")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for tests only")
    for flag in ("--checkpoint-dir", "--shard-server"):
        p.add_argument(flag, default=None, help="not yet ported: raises")
    p.add_argument("--world-size", type=int, default=None,
                   help="not yet ported: raises")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="not yet ported: raises")
    p.add_argument("--health", action="store_true",
                   help="not yet ported: raises")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="serverless_learn_tpu_torch",
        description="PyTorch/CUDA port of serverless-learn-tpu: training "
                    "and serving")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a model on the card")
    _add_train_flags(t)
    t.set_defaults(fn=cmd_train)

    g = sub.add_parser("generate", help="sample tokens from a causal LM")
    _add_model_flags(g)
    g.add_argument("--prompt", help="comma-separated prompt token ids")
    g.add_argument("--prompt-len", type=int, default=8,
                   help="random prompt length when --prompt is unset")
    g.add_argument("--max-new-tokens", type=int, default=32)
    g.add_argument("--temperature", type=float, default=0.0)
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--eos-id", type=int, default=None)
    g.set_defaults(fn=cmd_generate)

    sv = sub.add_parser("serve",
                        help="serve LM generation over TCP (JSON lines)")
    _add_model_flags(sv)
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
    sv.set_defaults(fn=cmd_serve)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
