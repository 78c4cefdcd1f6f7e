"""The process's one profiler owner, the counterpart of
``serverless_learn_tpu/telemetry/profiler.py`` on ``torch.profiler``.

* :func:`arm` fixes the output directory (``--profile-dir``);
  :func:`capture` runs one ``torch.profiler`` window (CPU and CUDA
  activities) under a process-wide lock and writes its Chrome trace
  (``trace.json``, Perfetto-loadable) with a ``capture-meta.json`` stamp:
  the reason, the card's memory at start and stop, the card's name and
  the goodput ledger's report at the trigger.
* :func:`capture_session` brackets a block while holding the same lock,
  so an on-demand ``/debug/profile`` during it answers busy (409) and two
  sessions never nest. Every profiler session of the port, the
  ``chip_smoke.py`` profiles included, goes through this lock.
* :func:`on_alert` hooks the health engine: a critical alert starts a
  rate-limited capture on a thread.
* :func:`device_work` brackets the device loops' work, so a session
  started or stopped from another thread (the exporter's) waits for a
  gap between their launches.

A profiler that cannot start raises.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

MAX_PROFILE_SECONDS = 60.0
DEFAULT_ALERT_CAPTURE_S = 3.0

_lock = threading.Lock()          # one capture at a time, process-global
_state_lock = threading.Lock()
_profile_dir: Optional[str] = None


class _DeviceGate:
    """The process's device loops (the serving engines' boundaries, the
    training loop's steps) run their device work inside ``work()``; a
    profiler session starts and stops inside ``exclusive()``, which holds
    new work back and waits for the work in flight. So ``torch.profiler``
    never turns on or off while another thread launches kernels or
    replays a CUDA graph: stopping it from the exporter's thread in the
    middle of the continuous engine's graph replays hung an H100. The
    work keeps running while the session records. ``work()`` nests in
    one thread; a thread inside it may start or stop a session itself."""

    def __init__(self):
        self._cond = threading.Condition()
        self._active = 0
        self._exclusive = False
        self._depth = threading.local()

    @contextmanager
    def work(self):
        depth = getattr(self._depth, "n", 0)
        if depth == 0:
            with self._cond:
                while self._exclusive:
                    self._cond.wait()
                self._active += 1
        self._depth.n = depth + 1
        try:
            yield
        finally:
            self._depth.n = depth
            if depth == 0:
                with self._cond:
                    self._active -= 1
                    self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        mine = 1 if getattr(self._depth, "n", 0) else 0
        with self._cond:
            while self._exclusive:
                self._cond.wait()
            self._exclusive = True
            while self._active > mine:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._exclusive = False
                self._cond.notify_all()


_gate = _DeviceGate()


def device_work():
    """``with profiler.device_work():`` around a loop's device work (see
    ``_DeviceGate``)."""
    return _gate.work()


class ProfilerBusy(RuntimeError):
    """A capture (on-demand or session-bracketed) is already running."""


def arm(profile_dir: Optional[str]):
    """Fix the default output directory; arming is what enables the
    /debug/profile endpoint and alert-triggered captures."""
    global _profile_dir
    with _state_lock:
        if profile_dir:
            _profile_dir = profile_dir


def profile_dir() -> Optional[str]:
    with _state_lock:
        return _profile_dir


def armed() -> bool:
    return profile_dir() is not None


def _device_memory() -> Optional[list]:
    """The card's memory statistics at a capture's start and stop, only if
    CUDA is already initialized (the flight recorder's rule)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        return [{"device": f"cuda:{d}",
                 "allocated_bytes": torch.cuda.memory_allocated(d),
                 "reserved_bytes": torch.cuda.memory_reserved(d),
                 "peak_allocated_bytes": torch.cuda.max_memory_allocated(d)}
                for d in range(torch.cuda.device_count())] or None
    except Exception:
        return None


def _device_kind() -> Optional[str]:
    """``torch.cuda.get_device_name`` of the first card, only if CUDA is
    already initialized."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        return torch.cuda.get_device_name(0)
    except Exception:
        return None


def _write_meta(out_dir: str, meta: dict):
    try:
        with open(os.path.join(out_dir, "capture-meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
    except (IOError, OSError, TypeError, ValueError):
        pass  # the trace itself is the payload; the stamp is best-effort


def _activities():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextmanager
def _session(out_dir: Optional[str] = None):
    """One ``torch.profiler`` session over the block (caller holds
    ``_lock``); yields the profiler and, with ``out_dir``, writes its
    Chrome trace there as ``trace.json`` on exit."""
    import torch

    prof = torch.profiler.profile(activities=_activities())
    with _gate.exclusive():
        prof.__enter__()  # raises when the profiler cannot start
    try:
        yield prof
    finally:
        with _gate.exclusive():
            prof.__exit__(None, None, None)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def capture(seconds: float, out_dir: Optional[str] = None,
            reason: str = "on-demand", base_dir: Optional[str] = None,
            sleep: Callable[[float], None] = time.sleep) -> dict:
    """One profiler window: start, hold ``seconds``, stop, write
    ``trace.json`` and ``capture-meta.json``. The window records every
    thread's launches, so a capture started from the exporter's thread
    holds the serving thread's kernels. Raises :class:`ProfilerBusy`
    when a capture or session already holds the profiler, ``ValueError``
    on a bad duration, ``RuntimeError`` when nothing is armed."""
    if not (0 < seconds <= MAX_PROFILE_SECONDS):
        raise ValueError(f"seconds must be in (0, {MAX_PROFILE_SECONDS:g}]")
    base = base_dir or profile_dir()
    if out_dir is None:
        if base is None:
            raise RuntimeError(
                "profiling disabled; start this process with "
                "--profile-dir DIR to enable")
        out_dir = os.path.join(base, f"profile-{int(time.time())}")
    if not _lock.acquire(blocking=False):
        raise ProfilerBusy("a profile capture is already running")
    try:
        from serverless_learn_tpu_torch.telemetry import goodput

        meta = {"event": "profile_capture", "reason": reason,
                "seconds": seconds,
                "started_unix_s": round(time.time(), 6),
                "ledger_at_trigger": goodput.get_ledger().report(),
                "device_memory_start": _device_memory(),
                "device_kind": _device_kind()}
        with _session(out_dir):
            sleep(seconds)
        meta["device_memory_stop"] = _device_memory()
        _write_meta(out_dir, meta)
        return {"ok": True, "dir": out_dir, "seconds": seconds,
                "reason": reason,
                "trace": os.path.join(out_dir, "trace.json")}
    finally:
        _lock.release()


@contextmanager
def capture_session(logdir: Optional[str] = None):
    """Bracket a block with one profiler session, holding the shared lock
    so an on-demand request during it answers busy instead of nesting a
    second session; yields the ``torch.profiler.profile`` object (its
    ``key_averages()`` and ``events()`` after the block). With
    ``logdir`` the Chrome trace is written there."""
    if not _lock.acquire(blocking=False):
        raise ProfilerBusy("a profile capture is already running")
    try:
        with _session(logdir) as prof:
            yield prof
    finally:
        _lock.release()


def on_alert(engine, seconds: float = DEFAULT_ALERT_CAPTURE_S,
             cooldown_s: float = 600.0,
             capture_fn: Optional[Callable[..., dict]] = None,
             in_thread: bool = True) -> Callable:
    """Register an alert hook on a HealthEngine: each **critical** fire
    triggers one capture, rate-limited by ``cooldown_s`` (a flapping
    detector must not fill the disk with traces). Returns the hook (for
    tests); ``capture_fn``/``in_thread`` are injectable for the same
    reason. The capture runs off-thread so a tick never blocks on the
    profiler window."""
    state = {"last_t": None}
    state_lock = threading.Lock()
    fn = capture_fn or capture

    def hook(alert):
        if getattr(alert, "severity", None) != "critical":
            return
        if capture_fn is None and not armed():
            return
        now = time.time()
        with state_lock:
            if (state["last_t"] is not None
                    and now - state["last_t"] < cooldown_s):
                return
            state["last_t"] = now

        def run():
            try:
                fn(seconds, reason=f"alert:{alert.name}")
            except Exception:
                pass  # forensics must never hurt the watched process

        if in_thread:
            threading.Thread(target=run, daemon=True,
                             name="slt-alert-profile").start()
        else:
            run()

    engine.add_alert_hook(hook)
    return hook
