"""Configuration of the port's training path: its own copy of the parts of
``serverless_learn_tpu/config.py`` (``ExperimentConfig`` and the sections
``model``, ``model_overrides``, ``mesh``, ``optimizer``, ``train`` and
``data``, ``checkpoint``, the serving engines' ``kv``, the health
engine's ``health``, the request ledger's ``waterfall``, the control
plane's ``control``, the membership policy's ``membership``, the
elastic trainer's ``elastic`` and the numerics layer's ``numerics``) with
the same field names and defaults, so
the reference's JSON configs and ``--set section.key=value`` overrides
mean the same here.

What the port does not run raises instead of being ignored: a mesh of
more than one device, a non-f32 gradient exchange, every field of
``_FIELDS_NOT_PORTED`` set away from its default (gossip membership and
the quantized remesh stream among them), and the sections ``local_sgd``
and ``fleet`` (the port keeps no copy of their defaults, so it refuses
them when set at all).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Optional

_SECTIONS_NOT_PORTED = {
    "local_sgd": "gossip / DiLoCo local SGD",
    "fleet": "the serving fleet",
}
ROADMAP_TRAINING = "ROADMAP.md queue 1 item 3"
_DATA_ITEM = "ROADMAP.md queue 1 item 5"
# (section, field) -> (what it runs, ROADMAP item): kept so the reference's
# configs load, raising when set away from the default.
_FIELDS_NOT_PORTED = {
    ("train", "zero_stage"): ("ZeRO", "ROADMAP.md queue 1 item 3d"),
    ("train", "donate_state"): ("a step that keeps its input state alive "
                                "(the port updates the state in place)",
                                ROADMAP_TRAINING),
    ("membership", "mode"): ("SWIM gossip membership (control/gossip.py)",
                             _DATA_ITEM),
    ("elastic", "remesh_wire_dtype"): (
        "a quantized remesh stream (training/wire_codec.py)", _DATA_ITEM),
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
    eval_every: int = 0  # 0 => no in-loop eval; else every N steps
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
    # mlp_mnist's synthetic labels from a fixed projection of the image,
    # so the task is learnable.
    learnable: bool = False
    # A streamed image dataset's training batches are cropped and flipped
    # on the host (data/transforms.py); eval sources never are.
    augment: bool = False
    mask_rate: float = 0.15  # MLM: the share of positions masked a pass


@dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint knobs (``training/checkpoint.py``), the reference's
    fields and defaults. ``verify`` gates the size/CRC checks of a
    restore; ``keep`` is how many committed steps GC keeps.
    ``emergency_save`` arms the save on the flight recorder's death path
    whenever ``train`` has a checkpointer, from a host shadow refreshed at
    most once per ``emergency_min_interval_s``.

    The replication fields (``training/replicate.py``): ``cache_dir``
    keeps a worker-local copy of every checkpoint file, so a transition
    restores from local disk; ``serve_cache`` serves that cache to peers
    over the shard-server protocol (an ephemeral port unless
    ``serve_cache_port``); ``peers`` (comma-separated addresses) and
    ``replica_fanout`` push each commit to that many peer caches, so a
    rejoining worker restores from a peer when the central store is slow
    or unreachable."""

    verify: bool = True
    keep: int = 3                       # retained steps (Checkpointer GC)
    emergency_save: bool = True
    emergency_min_interval_s: float = 30.0
    cache_dir: str = ""                 # "" = no worker-local cache
    peers: str = ""                     # comma-separated peer cache addrs
    replica_fanout: int = 2             # peers to push each commit to
    serve_cache: bool = False           # serve cache_dir to peers
    serve_cache_port: int = 0           # 0 = ephemeral


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
class WaterfallConfig:
    """Per-request waterfall ledger knobs (``telemetry/waterfall.py``,
    used by ``inference/continuous.py`` and ``inference/batching.py``),
    the reference's fields and defaults.

    A decode gap counts as a stall when it exceeds the request's EWMA
    inter-token baseline by ``stall_mult`` times AND by at least
    ``min_stall_s``. Attribution intersects the gap with the engine's
    boundary-event ring (``events_window`` entries); per-request storage
    is bounded by ``max_stall_events`` and ``max_gap_samples``."""

    enabled: bool = True
    ewma_alpha: float = 0.3        # decode-ITL baseline smoothing
    stall_mult: float = 2.0        # gap > mult * baseline => stall
    min_stall_s: float = 0.002     # ... and exceeds baseline by this
    max_stall_events: int = 64     # attributed stall entries kept/request
    max_gap_samples: int = 256     # raw decode gaps kept/request
    events_window: int = 256       # engine boundary-event ring size


@dataclass(frozen=True)
class HealthConfig:
    """Health engine knobs (``telemetry/health.py``), the reference's
    fields and defaults. ``slos`` declares the objectives the burn-rate
    alerter tracks (``telemetry.health.parse_slos``), e.g.

        "health": {"enabled": true, "slos": [
          {"name": "ttft", "kind": "latency",
           "metric": "slt_request_ttft_seconds",
           "threshold_s": 0.5, "objective": 0.95}]}

    The ``numerics_*`` fields tune the loss-health detectors
    (``telemetry.numerics.LossHealth``) the engine runs over the numerics
    auditor's step records."""

    enabled: bool = False           # CLI --health also turns the engine on
    sample_interval_s: float = 2.0  # registry sampling period
    anomaly_z: float = 6.0          # |modified z| that fires
    anomaly_min_samples: int = 12   # warmup before any z is produced
    anomaly_window: int = 240       # bounded per-series sample ring
    stale_factor: float = 5.0       # no step/round/chunk in factor x EWMA
    stale_min_interval_s: float = 1.0
    straggler_factor: float = 4.0   # MADs above median = late
    straggler_min_rounds: int = 2
    straggler_window_rounds: int = 20
    slo_fast_burn: float = 14.4
    slo_slow_burn: float = 6.0
    slo_short_window_s: float = 60.0
    slo_long_window_s: float = 720.0
    clear_after_ticks: int = 3       # clean ticks before auto-resolve
    anchor_lag_rounds: float = 2.0   # DiLoCo lag gauge alert threshold
    dump_cooldown_s: float = 300.0   # min gap between critical flight dumps
    # Alert-triggered profiling: with --profile-dir, a critical alert
    # captures this many seconds (0 disables), at most once a cooldown.
    profile_on_critical_s: float = 3.0
    profile_cooldown_s: float = 600.0
    numerics_spike_z: float = 6.0
    numerics_plateau_window: int = 200
    numerics_plateau_min_rel: float = 1e-3
    numerics_explode_z: float = 8.0
    slos: tuple = ()                 # SLO spec objects (see docstring)


@dataclass(frozen=True)
class ControlConfig:
    """Control-plane endpoints and intervals (the reference's): the
    coordinator and shard server a ``worker`` uses, its heartbeat period
    and the lease it expects."""

    coordinator_addr: str = "localhost:50052"
    shard_server_addr: str = "localhost:50053"
    heartbeat_interval_ms: int = 1000
    lease_ttl_ms: int = 5000


@dataclass(frozen=True)
class MembershipConfig:
    """Membership policy of the elastic trainer, the reference's fields
    and defaults. ``mode`` "master" is the coordinator's leases and
    heartbeats; "gossip" (SWIM) raises. ``remesh_debounce_s`` holds a
    re-formation until the view has been still that long (a view equal to
    the formed one then re-forms nothing). ``safe_pause`` and
    ``quorum_fraction`` act on a gossip agent's quorum and do nothing in
    master mode, as in the reference. The gossip tuning fields are read
    only by gossip mode."""

    mode: str = "master"
    seed: str = ""
    gossip_bind_host: str = "127.0.0.1"
    gossip_port: int = 0
    protocol_period_ms: int = 250
    ping_timeout_ms: int = 80
    indirect_probes: int = 3
    suspicion_mult: float = 2.0
    retransmit_mult: float = 3.0
    max_piggyback: int = 12
    train_through_suspicion: bool = True
    remesh_debounce_s: float = 0.0
    safe_pause: bool = False
    quorum_fraction: float = 0.5
    leader_rechallenge: bool = True


@dataclass(frozen=True)
class ElasticConfig:
    """The elastic trainer's remesh stream: ``float32`` (the default) is
    the bit-exact checkpoint save and restore of each transition; int8 and
    fp8 streams raise."""

    remesh_wire_dtype: str = "float32"
    remesh_wire_block: int = 128


@dataclass(frozen=True)
class NumericsConfig:
    """The numerics layer (``telemetry/numerics.py``,
    ``training/audit.py``), the reference's fields and defaults.

    ``enabled`` adds per-subtree grad, param and update norms,
    update-to-param ratios, non-finite counts and parameter fingerprints to
    the train step (on the card, no host sync) and fetches them to the host
    every ``cadence`` steps, charged to the ``numerics`` goodput phase. At
    the first non-finite step the auditor names the first bad layer (the
    checkpointer's host shadow, else the live state) and the health engine
    raises the critical ``numerics.nonfinite``. ``chunks`` is at most 16.

    ``inject_nan_step`` / ``inject_nan_subtree`` poison the named subtree's
    gradient (every gradient when empty) with NaN at exactly that step."""

    enabled: bool = False
    cadence: int = 20             # host-fetch/emit every N steps
    depth: int = 1                # subtree grouping depth (top-level=1)
    fingerprint: bool = True      # per-step parameter fingerprints
    fingerprint_log: str = ""     # JSONL path for fingerprint records
    chunks: int = 4               # positional chunk sums per subtree
    provenance: str = "sweep"     # "sweep" | "off" (NaN/Inf root-causing)
    inject_nan_step: int = 0      # 0 = off; else poison grads at this step
    inject_nan_subtree: str = ""  # "" = whole grad tree


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
    health: HealthConfig = field(default_factory=HealthConfig)
    waterfall: WaterfallConfig = field(default_factory=WaterfallConfig)
    control: ControlConfig = field(default_factory=ControlConfig)
    membership: MembershipConfig = field(default_factory=MembershipConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)
    numerics: NumericsConfig = field(default_factory=NumericsConfig)

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
                    "checkpoint": CheckpointConfig(),
                    "membership": MembershipConfig(),
                    "elastic": ElasticConfig()}
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
        if t.eval_every < 0:
            raise ValueError(f"eval_every must be >= 0, got {t.eval_every}")
        if self.checkpoint.emergency_min_interval_s < 0:
            raise ValueError("emergency_min_interval_s must be >= 0, got "
                             f"{self.checkpoint.emergency_min_interval_s}")
        if not 1 <= max(self.numerics.chunks, 1) <= 16:
            raise ValueError(f"numerics.chunks must be at most 16, got "
                             f"{self.numerics.chunks}")

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
                               "checkpoint", "health", "waterfall",
                               "control", "membership", "elastic",
                               "numerics"}
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
            health=build(HealthConfig, raw.get("health")),
            waterfall=build(WaterfallConfig, raw.get("waterfall")),
            control=build(ControlConfig, raw.get("control")),
            membership=build(MembershipConfig, raw.get("membership")),
            elastic=build(ElasticConfig, raw.get("elastic")),
            numerics=build(NumericsConfig, raw.get("numerics")),
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
