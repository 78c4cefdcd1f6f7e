"""Elastic training on one card, the port of ``serverless_learn_tpu/
training/elastic.py``: membership epochs of the coordinator drive
re-formations of the trainer.

    steady state: train steps on the card, streaming this worker's stripe
    epoch change (a join, a leave, a lease eviction):
        drain   -> finish the step in flight
        save    -> a sharded checkpoint to the store (the shard server)
        re-form -> free the old trainer and its source, build the new
                   trainer and, when the stripe changed, the new source
        restore -> the newest checkpoint, verified, into the new trainer

The worker registers under an exclusive name (its checkpoint namespace),
retrying for ``name_wait_s`` while a dead predecessor's lease runs out.
Its stripe is its rank among the live workers, ordered by id: concurrent
workers on one coordinator read disjoint shards of the dataset. A worker
whose name went to a live successor during a lapsed lease is fenced out:
it raises without saving.

The card never holds two trainers: the old trainer, its placed batches and
its source are dropped (and the allocator's cache emptied) before the new
trainer is allocated, and the new state is allocated empty and filled by
the restore, never initialized first.

Telemetry, the reference's: ``slt_membership_size``,
``slt_membership_epoch``, ``slt_remesh_total`` (formations, the first
included), ``slt_remesh_seconds`` (re-form and restore), the goodput
ledger's ``remesh`` phase (the save and the restore inside it are
``checkpoint``), an ``elastic/remesh`` span, ``mesh_formed`` flight
records and log lines; the store's traffic is counted under the DCN
consumer ``remesh`` (``telemetry/dcn.py``). The port adds a ``remesh``
event per formation with the save, re-form and restore seconds and bytes
(``*_io_s``: the store's share of them) and the card's peak memory, and
``step`` lines every ``train.log_every`` steps when verbose. With
``numerics.enabled`` every formation emits the restored parameters'
``numerics_fingerprint`` with ``reason=remesh_restore``, as the reference
does, and every drain's save the saved ones' with ``reason=remesh_save``:
``numerics diff`` of the two, or their equality, shows a transition kept
the values.

The store is tiered as ``config.checkpoint`` says
(``training/replicate.maybe_replicated``, outside the byte accounting, as
the reference wraps it): with ``cache_dir`` a transition's restore reads
the worker's own cache, with ``peers`` every commit is pushed to peer
caches a restarted worker can restore from, and with ``serve_cache`` this
worker serves its cache to peers until it shuts down. Each ``remesh``
record names the restore's source (``restore_source``).

Off their defaults these raise "not yet ported" (``config.py``): the
quantized remesh stream (``elastic.remesh_wire_dtype``) and gossip
membership (``membership.mode``); ``worker --multihost`` raises in the
CLI.
"""

from __future__ import annotations

import gc
import statistics
import threading
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from serverless_learn_tpu_torch.config import ExperimentConfig
from serverless_learn_tpu_torch.control.client import WorkerAgent
from serverless_learn_tpu_torch.data.datasets import prefetch
from serverless_learn_tpu_torch.telemetry import flight, goodput
from serverless_learn_tpu_torch.telemetry import tracing as ttrace
from serverless_learn_tpu_torch.telemetry.dcn import instrument_store
from serverless_learn_tpu_torch.telemetry.registry import get_registry
from serverless_learn_tpu_torch.training.checkpoint import Checkpointer
from serverless_learn_tpu_torch.training.loop import make_source
from serverless_learn_tpu_torch.training.replicate import (maybe_replicated,
                                                           serve_cache)
from serverless_learn_tpu_torch.training.train_step import build_trainer
from serverless_learn_tpu_torch.utils.metrics import log_json


# The longest a worker's exit waits for its queued peer pushes: a
# multi-GB state moves through one Python stream at ~0.5-0.7 GB/s.
_PUSH_DRAIN_S = 300.0


def default_device_policy(peers, local_devices) -> List:
    """One device per registered chip across live peers, capped locally;
    all local devices without peer information."""
    total = sum(p.n_chips for p in peers) if peers else len(local_devices)
    n = max(1, min(total, len(local_devices)))
    return list(local_devices)[:n]


@dataclass
class EpochTransition:
    epoch: int
    step: int
    n_devices: int
    stripe: tuple = (0, 1)  # (rank, size) in the live membership


def _leave_nothing(model, seed):
    """An init that writes nothing: the restore fills every tensor."""
    return model


class ElasticTrainer:
    """Owns the worker agent, the checkpointer and the (re)built trainer.
    :meth:`run` trains to ``num_steps``, re-forming at every membership
    epoch; returns (state, losses)."""

    def __init__(self, config: ExperimentConfig, store,
                 coordinator_addr: Optional[str] = None,
                 advertise_addr: str = "local:0", name: str = "elastic",
                 n_chips: int = 1, device="cuda", verbose: bool = False,
                 name_wait_s: float = 15.0, registry=None):
        self.config = config
        self.name = name
        self.device = torch.device(device)
        self.registry = registry or get_registry()
        ccfg = config.checkpoint
        self._primary = instrument_store(store, "remesh",
                                         registry=self.registry)
        self.ckpt = Checkpointer(
            maybe_replicated(self._primary, ccfg), name=name,
            async_save=False, sharded=True, keep=ccfg.keep,
            verify=ccfg.verify)
        self.cache_server = None
        if ccfg.serve_cache and ccfg.cache_dir:
            self.cache_server = serve_cache(ccfg.cache_dir,
                                            port=ccfg.serve_cache_port)
        self.verbose = verbose
        self.name_wait_s = name_wait_s
        self.transitions: List[EpochTransition] = []
        self.remesh_records: List[dict] = []
        self.step_times: List[float] = []
        self._remesh = threading.Event()
        self._stop = threading.Event()
        self._last_epoch_change_t = 0.0
        self._agent = None
        if coordinator_addr is not None:
            self._agent = WorkerAgent(
                coordinator_addr, advertise_addr, name=name, n_chips=n_chips,
                heartbeat_interval_ms=config.control.heartbeat_interval_ms,
                on_epoch_change=self._on_epoch_change, exclusive_name=True)

    # -- membership --------------------------------------------------------

    def _on_epoch_change(self, epoch: int, peers):
        self._last_epoch_change_t = time.time()
        self._remesh.set()

    def _remesh_due(self) -> bool:
        """A pending epoch change re-forms once the view has held still
        for ``membership.remesh_debounce_s``; a settled view equal to the
        formed one re-forms nothing."""
        if not self._remesh.is_set():
            return False
        debounce = self.config.membership.remesh_debounce_s
        if debounce <= 0:
            return True
        if time.time() - self._last_epoch_change_t < debounce:
            return False
        epoch, devices = self._current_world()
        if (self.transitions
                and len(devices) == self.transitions[-1].n_devices
                and self._stripe() == self.transitions[-1].stripe):
            self._remesh.clear()
            self.transitions[-1].epoch = epoch
            return False
        return True

    def request_stop(self):
        """Finish the step in flight, checkpoint, return."""
        self._stop.set()

    def _current_world(self):
        if self._agent is None:
            return 0, default_device_policy([], [self.device])
        epoch, peers = self._agent.snapshot()
        return epoch, default_device_policy(peers, [self.device])

    def _stripe(self):
        """(rank, size) in the live membership, by worker id; (0, 1)
        without a coordinator or while the agent's own id is absent."""
        if self._agent is None:
            return 0, 1
        _, peers = self._agent.snapshot()
        ids = sorted(p.worker_id for p in peers)
        wid = self._agent.worker_id
        if wid not in ids:
            return 0, 1
        return ids.index(wid), len(ids)

    def _start_agent(self):
        """Register under the exclusive name, retrying long enough for a
        dead predecessor's lease to be swept; a refusal after that means
        a live worker holds the name."""
        deadline = time.time() + self.name_wait_s
        while True:
            try:
                self._agent.start()
                return
            except RuntimeError as e:
                if "name" not in str(e) or time.time() > deadline:
                    raise
                time.sleep(0.3)

    def _fenced(self):
        if self._agent is not None and self._agent.fatal is not None:
            raise RuntimeError(f"worker fenced out: {self._agent.fatal}")

    # -- card memory -------------------------------------------------------

    def _store_seconds(self) -> float:
        """Seconds the checkpoint store has spent in puts and gets so far
        (``slt_dcn_transfer_time_seconds_total{consumer="remesh"}``)."""
        return self.registry.counter(
            "slt_dcn_transfer_time_seconds_total",
            "cumulative DCN transfer wall-clock, by consumer",
            consumer="remesh").value

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def _reset_peak(self):
        if self._cuda():
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def _peak(self) -> Optional[int]:
        if not self._cuda():
            return None
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))

    def _fingerprint(self, trainer, state, epoch: int, reason: str):
        """The parameters' fingerprint as a ``numerics_fingerprint`` event
        (with ``numerics.enabled``)."""
        ncfg = self.config.numerics
        if not ncfg.enabled:
            return
        from serverless_learn_tpu_torch.telemetry import numerics

        fp = numerics.fingerprint_record(
            trainer.state_tree(state)["params"], depth=max(1, ncfg.depth),
            chunks=ncfg.chunks)
        ttrace.emit_event({"event": "numerics_fingerprint",
                           "step": state.step, "epoch": epoch,
                           "reason": reason, "fp": fp})

    # -- main loop ---------------------------------------------------------

    def run(self, num_steps: Optional[int] = None):
        num_steps = num_steps or self.config.train.num_steps
        if self._agent is not None:
            self._start_agent()
        reg, led = self.registry, goodput.get_ledger()
        led.ensure_started()
        m_steps = reg.counter("slt_train_steps_total", "optimizer steps run")
        m_loss = reg.gauge("slt_train_loss")
        m_members = reg.gauge("slt_membership_size",
                              "live workers in the stripe")
        m_epoch = reg.gauge("slt_membership_epoch")
        m_remesh = reg.counter("slt_remesh_total",
                               "mesh formations (first one included)")
        m_remesh_t = reg.histogram(
            "slt_remesh_seconds",
            "drain -> save -> remesh -> restore wall time per epoch")
        m_last_step = reg.gauge("slt_train_last_step_unix_s",
                                "wall time of the latest optimizer step")
        losses: List[float] = []
        trainer = state = source = source_iter = None
        stripe = None
        saved = None  # (step, seconds, bytes) of the drain's save
        step_peak = None
        if self.config.checkpoint.emergency_save:
            self.ckpt.arm_emergency(
                min_interval_s=self.config.checkpoint.emergency_min_interval_s)
        try:
            while True:
                self._remesh.clear()
                epoch, devices = self._current_world()
                with led.phase("remesh"), ttrace.span(
                        "elastic/remesh", epoch=epoch) as remesh_span:
                    t0 = time.perf_counter()
                    # The card never holds two trainers: drop the old one
                    # before the new one is allocated.
                    trainer = state = None
                    gc.collect()
                    if self._cuda():
                        torch.cuda.empty_cache()
                    rank, size = self._stripe()
                    if source_iter is None or (rank, size) != stripe:
                        # A new stripe streams a new source; the old one
                        # is closed (its fetch thread joined) first.
                        if source is not None and hasattr(source, "close"):
                            source.close()
                        source = source_iter = None
                        gc.collect()
                        stripe = (rank, size)
                        ttrace.emit_event({
                            "event": "stripe", "rank": rank, "size": size,
                            "epoch": epoch,
                            "t_unix_s": round(time.time(), 6)})
                    trainer = build_trainer(self.config, self.device)
                    latest = self.ckpt.latest_step()
                    if source_iter is None:
                        source = make_source(self.config, trainer,
                                             dp_rank=rank, dp_size=size,
                                             start_step=latest or 0)
                        source_iter = iter(source)
                    remesh_span.mark("trainer_built")
                    t1 = time.perf_counter()
                    restored = restore_io_s = None
                    if latest is not None:
                        state = trainer.init(fill=_leave_nothing)
                        tree = trainer.state_tree(state)
                        moved = self._store_seconds()
                        self.ckpt.restore(tree)
                        trainer.load_tree(state, tree)
                        del tree
                        restored = self.ckpt.timings.get("restore_bytes")
                        restore_io_s = self._store_seconds() - moved
                    else:
                        state = trainer.init()
                    remesh_span.mark("restored")
                    t2 = time.perf_counter()
                    self.ckpt.note_state(lambda: trainer.state_tree(state))
                    step = state.step
                    self._fingerprint(trainer, state, epoch,
                                      "remesh_restore")
                    self.transitions.append(EpochTransition(
                        epoch=epoch, step=step, n_devices=len(devices),
                        stripe=(rank, size)))
                    m_remesh.inc()
                    m_epoch.set(epoch)
                    m_members.set(size)
                    remesh_span.meta.update(n_devices=len(devices),
                                            step=step)
                m_remesh_t.observe(remesh_span.duration_s)
                flight.record({"event": "mesh_formed", "epoch": epoch,
                               "n_devices": len(devices), "step": step,
                               "stripe": [rank, size]})
                record = {
                    "event": "remesh", "epoch": epoch, "step": step,
                    "stripe": [rank, size],
                    "save_s": saved[1] if saved else None,
                    "save_bytes": saved[2] if saved else None,
                    "save_io_s": saved[3] if saved else None,
                    "saved_step": saved[0] if saved else None,
                    "reform_s": round(t1 - t0, 6),
                    "restore_s": round(t2 - t1, 6) if restored else None,
                    "restore_bytes": restored,
                    "restore_io_s": restore_io_s,
                    "restore_source": (self.ckpt.timings.get(
                        "restore_source") if restored else None),
                    "restored_step": step if restored else None,
                    "step_peak_bytes": step_peak,
                    "transition_peak_bytes": self._peak()}
                self.remesh_records.append(record)
                ttrace.emit_event(record)
                if self.verbose:
                    log_json({"event": "mesh_formed", "epoch": epoch,
                              "n_devices": len(devices), "step": step,
                              "mesh": {}, "stripe_rank": rank,
                              "stripe_size": size})
                    log_json(record)
                self._reset_peak()
                batches = prefetch(source_iter, trainer.place,
                                   self.config.data.prefetch, ledger=led)
                first = True
                try:
                    while (step < num_steps and not self._remesh_due()
                           and not self._stop.is_set()):
                        self._fenced()
                        batch = next(batches)
                        t_step = time.perf_counter()
                        with led.phase("compile" if first else "step"):
                            state, metrics = trainer.step(state, batch)
                            loss = float(metrics["loss"])
                        dt = time.perf_counter() - t_step
                        del batch
                        if not first:
                            self.step_times.append(dt)
                        first = False
                        self.ckpt.note_state(
                            lambda: trainer.state_tree(state))
                        losses.append(loss)
                        step += 1
                        m_steps.inc()
                        m_last_step.set(time.time())
                        m_loss.set(loss)
                        if self._agent is not None:
                            self._agent.report(step, loss,
                                               flow=batches.depth())
                        every = self.config.train.log_every
                        if self.verbose and every and step % every == 0:
                            log_json({"step": step,
                                      "step_time_s": round(dt, 5),
                                      "loss": round(loss, 5),
                                      "epoch": epoch})
                finally:
                    # Re-forming forfeits the batches placed but not yet
                    # trained on.
                    dropped = batches.depth()
                    batches.close()
                    if dropped and self.verbose:
                        log_json({"event": "remesh_dropped_batches",
                                  "n": dropped})
                step_peak = self._peak()
                self._reset_peak()
                # The fence holds for the save too: a fenced-out worker's
                # save would clobber its successor's namespace.
                self._fenced()
                final = step >= num_steps or self._stop.is_set()
                t_save = time.perf_counter()
                moved = self._store_seconds()
                self.ckpt.save(trainer.state_tree(state))
                self._fingerprint(trainer, state, epoch, "remesh_save")
                saved = (step, round(time.perf_counter() - t_save, 6),
                         self.ckpt.timings.get("save_bytes"),
                         round(self._store_seconds() - moved, 6))
                if final:
                    return state, losses
        finally:
            self.ckpt.close()  # disarms the emergency hook
            if self.ckpt.store is not self._primary:
                # The last commit's pushes reach the peers before exit.
                self.ckpt.store.flush(_PUSH_DRAIN_S)
                self.ckpt.store.close()
            if hasattr(self._primary, "close"):
                self._primary.close()
            if self.cache_server is not None:
                self.cache_server.stop()
            if source is not None and hasattr(source, "close"):
                source.close()
            if self._agent is not None:
                self._agent.stop()

    def summary(self, seq_len: int, batch_size: int) -> dict:
        """Median step time (first step of each formation excluded) and
        the tokens a second it gives."""
        if not self.step_times:
            return {}
        med = statistics.median(self.step_times)
        return {"step_time_s_median": round(med, 6),
                "tokens_per_sec": round(batch_size * seq_len / med, 1)}
