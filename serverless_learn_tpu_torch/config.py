"""Configuration of the port's training path: its own copy of the parts of
``serverless_learn_tpu/config.py`` (``ExperimentConfig`` and the sections
``model``, ``model_overrides``, ``mesh``, ``optimizer``, ``train`` and
``data``, ``checkpoint``, and the serving engines' ``kv``) with the same
field names and
defaults, so the reference's JSON configs and ``--set section.key=value``
overrides mean the same here.

What this slice does not run raises instead of being ignored: a mesh of
more than one device, a non-f32 gradient exchange, every field of
``_FIELDS_NOT_PORTED`` set away from its default, and any of the sections
``control``, ``local_sgd``, ``health``, ``membership``, ``fleet``,
``waterfall``, ``numerics`` and ``elastic`` (the port keeps no copy of
their defaults, so it refuses them when set at all).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

_SECTIONS_NOT_PORTED = {
    "control": "the control plane (coordinator, shard server)",
    "local_sgd": "gossip / DiLoCo local SGD",
    "health": "the health engine",
    "membership": "gossip membership",
    "fleet": "the serving fleet",
    "waterfall": "request waterfalls",
    "numerics": "numerics telemetry",
    "elastic": "elastic training",
}
ROADMAP_TRAINING = "ROADMAP.md queue 1 item 3"
_DATA_ITEM = "ROADMAP.md queue 1 item 5"
_EMERGENCY = ("the emergency save on the flight recorder's death path",
              "ROADMAP.md queue 1 item 3e")
_REPLICAS = ("peer checkpoint replication (training/replicate.py)",
             _DATA_ITEM)
# (section, field) -> (what it runs, ROADMAP item): kept so the reference's
# configs load, raising when set away from the default.
_FIELDS_NOT_PORTED = {
    ("train", "zero_stage"): ("ZeRO", "ROADMAP.md queue 1 item 3d"),
    ("train", "eval_every"): ("in-loop eval", "ROADMAP.md queue 1 item 3e"),
    ("train", "donate_state"): ("a step that keeps its input state alive "
                                "(the port updates the state in place)",
                                ROADMAP_TRAINING),
    ("data", "shard_server_addr"): ("streaming from the shard server",
                                    _DATA_ITEM),
    ("data", "dataset"): ("named datasets (the shard server)", _DATA_ITEM),
    ("data", "eval_dataset"): ("named datasets (the shard server)",
                               _DATA_ITEM),
    ("data", "augment"): ("the shard server's host transforms", _DATA_ITEM),
    ("data", "mask_rate"): ("the shard server's host transforms", _DATA_ITEM),
    ("data", "learnable"): ("mlp_mnist's learnable synthetic task",
                            _DATA_ITEM),
    ("checkpoint", "emergency_save"): _EMERGENCY,
    ("checkpoint", "emergency_min_interval_s"): _EMERGENCY,
    ("checkpoint", "cache_dir"): _REPLICAS,
    ("checkpoint", "peers"): _REPLICAS,
    ("checkpoint", "replica_fanout"): _REPLICAS,
    ("checkpoint", "serve_cache"): _REPLICAS,
    ("checkpoint", "serve_cache_port"): _REPLICAS,
}


def not_ported(what: str, where: str = ROADMAP_TRAINING) -> NotImplementedError:
    return NotImplementedError(f"{what} is not yet ported to PyTorch "
                               f"({where})")


@dataclass(frozen=True)
class MeshConfig:
    """Logical device-mesh shape; the port runs one device, so every axis
    must be 1."""

    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1
    pp: int = 1

    AXIS_NAMES = ("dp", "fsdp", "ep", "tp", "sp", "pp")

    @property
    def size(self) -> int:
        n = 1
        for a in self.AXIS_NAMES:
            n *= getattr(self, a)
        return n


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adam | sgd | adafactor | lion | rmsprop
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    momentum: float = 0.9  # sgd / rmsprop only
    warmup_steps: int = 0
    decay_steps: int = 0  # 0 => constant after warmup
    grad_clip_norm: float = 0.0  # 0 => no clipping
    # Exempt 1-D params (norm scales) from weight decay.
    decay_exclude_1d: bool = True


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 128  # global batch size
    num_steps: int = 100
    seed: int = 0
    dtype: str = "bfloat16"  # compute dtype
    param_dtype: str = "float32"
    log_every: int = 10
    checkpoint_every: int = 0  # 0 => disabled
    remat: bool = False  # torch.utils.checkpoint around each block
    donate_state: bool = True
    # Each step accumulates grads over `grad_accum` microbatches of
    # batch_size / grad_accum samples before the one optimizer update.
    grad_accum: int = 1
    eval_every: int = 0  # 0 => no in-loop eval
    eval_steps: int = 10  # batches of the `eval` command
    zero_stage: int = 0
    grad_reduce_dtype: str = "float32"  # only f32 (no cross-device exchange)


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "synthetic_mnist"
    eval_dataset: Optional[str] = None
    shard_server_addr: Optional[str] = None  # None => generate locally
    prefetch: int = 2  # batches placed on the device ahead of the step
    seq_len: int = 128  # LM datasets
    learnable: bool = False
    augment: bool = False
    mask_rate: float = 0.15


@dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint knobs (``training/checkpoint.py``), the reference's
    fields and defaults. ``verify`` gates the size/CRC checks of a
    restore; ``keep`` is how many committed steps GC keeps. The emergency
    save is not armed in the port (``emergency_save`` keeps its default and
    does nothing yet); it and the peer-replication fields raise when set
    away from their defaults (``_FIELDS_NOT_PORTED``)."""

    verify: bool = True
    keep: int = 3                       # retained steps (Checkpointer GC)
    emergency_save: bool = True
    emergency_min_interval_s: float = 30.0
    cache_dir: str = ""
    peers: str = ""
    replica_fanout: int = 2
    serve_cache: bool = False
    serve_cache_port: int = 0


@dataclass(frozen=True)
class KVCacheConfig:
    """The paged KV cache of the serving engines (``inference/kvcache.py``,
    read by ``inference/continuous.py`` and ``inference/batching.py``), the
    reference's fields and defaults.

    ``paged=True`` keeps one block pool per layer (``[num_blocks + 1,
    block_size, K, D]``, the last page a scratch page), a host-side
    free-list allocator and per-slot block tables, so a slot holds pages
    only for the tokens it has produced. On the pool ride shared-prefix
    reuse (``prefix_cache``, copy-on-write at the first divergent block)
    and chunked prefill (``prefill_chunk`` tokens a chunk, at most
    ``prefill_budget`` prompt tokens a scheduler boundary).
    ``digest_top_k`` and ``digest_hashes`` size the reference's
    resident-prefix digest for the fleet router; the port accepts them and
    does not use them (the fleet is not ported)."""

    paged: bool = True            # False = the monolithic KV rows
    block_size: int = 16          # tokens per KV block (page)
    # Pool blocks per layer. 0 = auto: max_slots * ceil(max_seq_len /
    # block_size) plus one sequence's worth for the prefix cache.
    num_blocks: int = 0
    prefill_chunk: int = 32       # prompt tokens per prefill chunk (0 = whole)
    prefill_budget: int = 64      # prompt tokens per scheduler boundary
    prefix_cache: bool = True     # shared-prefix block reuse (trie)
    # Blocks the prefix trie may pin after their owners retire (0 = auto:
    # num_blocks // 4); LRU-evicted under pool pressure.
    prefix_cache_blocks: int = 0
    prefix_hit_window: int = 256  # lookups the windowed hit rate spans
    digest_top_k: int = 8         # fleet digest: accepted, unused
    digest_hashes: int = 64       # fleet digest: accepted, unused


@dataclass(frozen=True)
class ExperimentConfig:
    model: str = "mlp_mnist"
    model_overrides: dict = field(default_factory=dict)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    kv: KVCacheConfig = field(default_factory=KVCacheConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    def __post_init__(self):
        t = self.train
        if self.mesh.size != 1:
            raise not_ported(f"a mesh of {self.mesh.size} devices (data "
                             "parallel, fsdp, tp, sp, pp); the port trains "
                             "on one card")
        if t.grad_reduce_dtype not in ("float32", "f32"):
            raise not_ported("train.grad_reduce_dtype other than f32 (the "
                             "cross-device gradient exchange)")
        defaults = {"train": TrainConfig(), "data": DataConfig(),
                    "checkpoint": CheckpointConfig()}
        for (section, name), (what, where) in _FIELDS_NOT_PORTED.items():
            value = getattr(getattr(self, section), name)
            if value != getattr(defaults[section], name):
                raise not_ported(f"{section}.{name}={value!r} ({what})",
                                 where)
        if self.data.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.data.prefetch}")
        if t.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {t.grad_accum}")
        if t.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got "
                             f"{t.checkpoint_every}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "ExperimentConfig":
        for section, what in _SECTIONS_NOT_PORTED.items():
            if raw.get(section):
                raise not_ported(f"config section {section!r} ({what})",
                                 "ROADMAP.md queue 1")
        unknown = (set(raw) - {"model", "model_overrides", "mesh",
                               "optimizer", "train", "data", "kv",
                               "checkpoint"}
                   - set(_SECTIONS_NOT_PORTED))
        if unknown:
            raise ValueError(f"unknown config sections {sorted(unknown)}")

        def build(tp, val):
            return tp() if val is None else tp(**val)

        return cls(
            model=raw.get("model", "mlp_mnist"),
            model_overrides=raw.get("model_overrides", {}) or {},
            mesh=build(MeshConfig, raw.get("mesh")),
            optimizer=build(OptimizerConfig, raw.get("optimizer")),
            train=build(TrainConfig, raw.get("train")),
            data=build(DataConfig, raw.get("data")),
            kv=build(KVCacheConfig, raw.get("kv")),
            checkpoint=build(CheckpointConfig, raw.get("checkpoint")),
        )

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        return cls.from_dict(json.loads(text))


def coerce(text: str):
    """Parse a --set value: JSON if it parses, else the raw string."""
    try:
        return json.loads(text)
    except (json.JSONDecodeError, ValueError):
        return text


def apply_sets(raw: Dict[str, Any], items: Iterable[str]) -> Dict[str, Any]:
    """Apply ``dotted.key=value`` overrides to a raw config dict in place,
    as the reference CLI's ``--set`` does."""
    for item in items or ():
        path, eq, val = item.partition("=")
        if not eq:
            raise ValueError(f"--set expects dotted.key=value, got {item!r}")
        node = raw
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = coerce(val)
    return raw
