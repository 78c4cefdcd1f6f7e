"""Flight recorder: what a dying process was doing, a copy of
``serverless_learn_tpu/telemetry/flight.py``.

A bounded ring holds the process's last span and lifecycle events (every
``tracing.emit_span``/``emit_event`` feeds it, and the loops record their
steps). On SIGTERM or an unhandled exception (main thread or any other)
the ring is dumped, with a registry snapshot and the card's memory
statistics, to ``flight-<node>-<timestamp>.json`` (``-<k>`` added for a
later dump in the same second). Death hooks run first:
the checkpointer's emergency save is one (``training/checkpoint.py``
``arm_emergency``).

The memory statistics come from ``torch.cuda.memory_stats`` only when
CUDA is already initialized in the process: a crash handler never starts
CUDA. ``install()`` arms the handlers and chains to the ones it replaces.
Dumps are best-effort: a full disk or a torn-down interpreter never turns
a SIGTERM into a hang or a traceback.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import List, Optional

DEFAULT_CAPACITY = 2048

_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_CAPACITY)
_installed = False
_flight_dir: Optional[str] = None
_prev_sigterm = None
_prev_excepthook = None
_prev_thread_hook = None
# Named payload-section providers: fn() -> JSON-able value, added to
# every dump under its name. The health engine registers its firing
# alerts here, so a SIGTERM'd node's dump says WHAT was wrong, not just
# what it was doing. Keyed (last wins) so a restarted engine replaces
# its predecessor instead of stacking.
_providers: dict = {}
# Named death hooks: fn(reason) -> JSON-able summary (or None), run at
# the START of every dump — BEFORE the ring snapshot, so any events the
# hook records land in the dump too. This is the emergency-save path:
# the checkpointer registers a rate-limited synchronous save here
# (training/checkpoint.py ``arm_emergency``), so a SIGTERM'd or crashing
# trainer commits its in-memory state before the post-mortem is written.
# Hooks are best-effort: a raising hook is recorded, never fatal.
_death_hooks: dict = {}


def record(event: dict):
    """Append one event to the ring (thread-safe, bounded, never raises)."""
    try:
        with _lock:
            _ring.append(dict(event, flight_ts=round(time.time(), 6)))
    except Exception:
        pass


def events() -> List[dict]:
    with _lock:
        return list(_ring)


def add_context_provider(name: str, fn):
    """Attach ``fn() -> JSON-able`` as a dump payload section. Providers
    are best-effort: a raising provider is skipped, never fatal to the
    dump (which may be running inside a crash handler)."""
    with _lock:
        _providers[name] = fn


def remove_context_provider(name: str):
    with _lock:
        _providers.pop(name, None)


def add_death_hook(name: str, fn):
    """Attach ``fn(reason) -> JSON-able | None`` to run first on every
    dump (emergency work for a dying process — see ``_death_hooks``).
    Keyed, last wins; remove with :func:`remove_death_hook`."""
    with _lock:
        _death_hooks[name] = fn


def remove_death_hook(name: str):
    with _lock:
        _death_hooks.pop(name, None)


def set_capacity(n: int):
    global _ring
    with _lock:
        _ring = deque(_ring, maxlen=max(1, int(n)))


def _device_memory() -> Optional[list]:
    """``torch.cuda.memory_stats`` of each device, only if CUDA is already
    initialized in this process (a crash handler must not start CUDA);
    None on a process that never touched the card."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        out = []
        for d in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(d)
            if stats:
                out.append({"device": f"cuda:{d}", **stats})
        return out or None
    except Exception:
        return None


def dump(reason: str, dir: Optional[str] = None) -> Optional[str]:
    """Write the flight file; returns its path (None on failure)."""
    from serverless_learn_tpu_torch.telemetry import get_registry
    from serverless_learn_tpu_torch.telemetry.tracing import node_name

    try:
        node = node_name()
        out_dir = dir or _flight_dir or "."
        safe = "".join(c if (c.isalnum() or c in "-_.") else "_"
                       for c in node)
        path = os.path.join(out_dir, f"flight-{safe}-{int(time.time())}.json")
        # Death hooks run FIRST: an emergency checkpoint save must happen
        # even if writing the dump itself fails, and its events should be
        # in the ring snapshot below.
        with _lock:
            hooks = list(_death_hooks.items())
        hook_out = {}
        for hname, fn in hooks:
            try:
                res = fn(reason)
                if res is not None:
                    hook_out[hname] = res
            except Exception as e:
                hook_out[hname] = {"error": f"{type(e).__name__}: {e}"}
        payload = {
            "event": "flight_dump",
            "node": node,
            "pid": os.getpid(),
            "reason": reason,
            "dumped_at_unix_s": round(time.time(), 6),
            "events": events(),
        }
        if hook_out:
            payload["death_hooks"] = hook_out
        try:
            payload["metrics"] = get_registry().snapshot()
        except Exception:
            pass
        with _lock:
            providers = list(_providers.items())
        for pname, fn in providers:
            try:
                val = fn()
                if val is not None and pname not in payload:
                    payload[pname] = val
            except Exception:
                pass
        mem = _device_memory()
        if mem is not None:
            payload["device_memory"] = mem
        os.makedirs(out_dir, exist_ok=True)
        # A second dump within the same second (an incident's own dump and
        # the alert's that follows it, from another thread) must not
        # overwrite the first: the name is reserved before it is written.
        stem, k = path[:-len(".json")], 0
        while True:
            try:
                os.close(os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                break
            except FileExistsError:
                k += 1
                path = f"{stem}-{k}.json"
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path
    except Exception:
        return None


def maybe_dump(reason: str) -> Optional[str]:
    """Dump only when handlers are installed — library code (WorkerAgent on
    lease expiry) calls this so bare clients never spray files."""
    if not _installed:
        return None
    return dump(reason)


def _on_sigterm(signum, frame):
    dump("sigterm")
    # Restore whatever was there before and re-deliver, so the process
    # still dies with the default/user semantics (exit code 143 etc.).
    prev = _prev_sigterm
    if callable(prev):
        prev(signum, frame)
        return
    signal.signal(signal.SIGTERM, prev if prev is not None
                  else signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)


def _on_excepthook(exc_type, exc, tb):
    if not issubclass(exc_type, (KeyboardInterrupt, SystemExit)):
        dump(f"unhandled:{exc_type.__name__}")
    (_prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)


def _on_thread_hook(args):
    if not issubclass(args.exc_type, SystemExit):
        dump(f"thread-unhandled:{args.exc_type.__name__}")
    if _prev_thread_hook is not None:
        _prev_thread_hook(args)


def install(flight_dir: Optional[str] = None,
            capacity: Optional[int] = None) -> bool:
    """Arm dump-on-death: SIGTERM handler + sys/threading excepthooks.
    Idempotent; returns True when armed (False off the main thread, where
    signal handlers cannot be set — hooks still work via a direct call)."""
    global _installed, _flight_dir, _prev_sigterm, _prev_excepthook
    global _prev_thread_hook
    if flight_dir:
        _flight_dir = flight_dir
    if capacity:
        set_capacity(capacity)
    if _installed:
        return True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _on_excepthook
    _prev_thread_hook = getattr(threading, "excepthook", None)
    if _prev_thread_hook is not None:
        threading.excepthook = _on_thread_hook
    try:
        _prev_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, _on_sigterm)
    except (ValueError, OSError):
        # Not the main thread: no signal hook, but hooks above are armed.
        _installed = True
        return False
    _installed = True
    return True
