"""The port's telemetry (``serverless_learn_tpu_torch/telemetry/``) against
the JAX package's on the same inputs: registry rendering and snapshots,
the goodput ledger on an injected clock, the health engine's alerts, the
request waterfall, ``traceparent`` parsing, and the exporter's endpoints
over a live loopback port. Every comparison here is exact (the modules
are copies, so no rounding enters), apart from the waterfall's
``overhead_s``, which is each ledger's own host time. Also the profiler's
shared lock, the flight recorder's death hooks and the emergency-save
shadow's refresh, all on the CPU."""

import json
import math
import os
import types

import pytest
import torch

from serverless_learn_tpu.telemetry import exporter as jexporter
from serverless_learn_tpu.telemetry import goodput as jgoodput
from serverless_learn_tpu.telemetry import health as jhealth
from serverless_learn_tpu.telemetry import registry as jregistry
from serverless_learn_tpu.telemetry import tracing as jtracing
from serverless_learn_tpu.telemetry import waterfall as jwaterfall
from serverless_learn_tpu_torch.config import HealthConfig
from serverless_learn_tpu_torch.telemetry import exporter as texporter
from serverless_learn_tpu_torch.telemetry import flight as tflight
from serverless_learn_tpu_torch.telemetry import goodput as tgoodput
from serverless_learn_tpu_torch.telemetry import health as thealth
from serverless_learn_tpu_torch.telemetry import profiler as tprofiler
from serverless_learn_tpu_torch.telemetry import registry as tregistry
from serverless_learn_tpu_torch.telemetry import tracing as ttracing
from serverless_learn_tpu_torch.telemetry import waterfall as twaterfall

BOTH = [("jax", jregistry, jgoodput, jhealth, jwaterfall, jtracing,
         jexporter),
        ("torch", tregistry, tgoodput, thealth, twaterfall, ttracing,
         texporter)]


def _script(reg):
    """Counters, gauges and histograms with label sets, odd values and a
    NaN, in one fixed order."""
    c = reg.counter("slt_requests_total", "requests", engine="continuous")
    c.inc()
    c.inc(2.5)
    reg.counter("slt_requests_total", engine="static").inc(7)
    reg.counter("slt_decode_tokens_total").inc(1e-9)
    g = reg.gauge("slt_train_loss", "loss")
    g.set(3.14159265358979)
    g.inc(-0.5)
    reg.gauge("slt_slots_in_use", engine="continuous", zone="a b").set(
        float("nan"))
    reg.gauge("slt_kv_blocks_total").set(1 << 40)
    h = reg.histogram("slt_request_ttft_seconds", "ttft",
                      engine="continuous")
    for v in (0.0, 0.001, 0.0011, 0.37, 2.5, 1e6, -1.0):
        h.observe(v)
    s = reg.histogram("slt_admit_batch_size", buckets=jregistry.SIZE_BUCKETS)
    for v in (1, 3, 3, 128, 129):
        s.observe(v)
    reg.histogram("slt_empty_seconds")  # a family with no observations
    with pytest.raises(ValueError):
        reg.gauge("slt_requests_total")  # registered as a counter
    with pytest.raises(ValueError):
        reg.counter("slt_x_total").inc(-1)
    return reg


def test_registry_rendering_and_snapshot_equal():
    j = _script(jregistry.MetricsRegistry())
    t = _script(tregistry.MetricsRegistry())
    assert t.render_prometheus() == j.render_prometheus()
    assert "NaN" in json.dumps(t.snapshot())
    assert json.dumps(t.snapshot(), sort_keys=True) == json.dumps(
        j.snapshot(), sort_keys=True)
    hj = j.histogram("slt_request_ttft_seconds", engine="continuous")
    ht = t.histogram("slt_request_ttft_seconds", engine="continuous")
    for q in (0.0, 0.5, 0.95, 1.0):
        assert ht.percentile(q) == hj.percentile(q)


def _ledger_timeline(goodput):
    t = [100.0]
    led = goodput.PhaseLedger(clock=lambda: t[0], emit=False)
    led.ensure_started()
    with led.phase("compile"):
        t[0] += 7.25
    for _ in range(3):
        with led.phase("step"):
            t[0] += 0.3
            with led.phase("data_wait"):
                t[0] += 0.05
        with led.phase("eval"):
            t[0] += 1.0 / 3.0
            with led.phase("checkpoint"):
                t[0] += 0.125
    led.add("remesh", 0.5)
    t[0] += 2.0  # unattributed
    cm = led.phase("step")  # an open phase: credited up to "now"
    cm.__enter__()
    t[0] += 0.2
    reports = [led.report(mfu=0.3), led.report(), led.snapshot(),
               led.report(now=t[0] + 1.0)]
    cm.__exit__(None, None, None)
    reports.append(led.report(mfu=0.3))
    return reports


def test_phase_ledger_reports_equal():
    j, t = _ledger_timeline(jgoodput), _ledger_timeline(tgoodput)
    assert t == j
    assert t[0]["mfu_weighted_goodput"] == pytest.approx(
        0.3 * t[0]["goodput"], abs=1e-6)
    phases = t[-1]["phases"]
    assert sum(p["seconds"] for p in phases.values()) == pytest.approx(
        t[-1]["total_s"])


def _health_run(registry, health):
    """A step-time series with a spike, a step counter that stalls, and
    an SLO burning its budget, sampled at fabricated times."""
    reg = registry.MetricsRegistry()
    cfg = HealthConfig(
        sample_interval_s=1.0, anomaly_min_samples=6, stale_factor=3.0,
        slo_short_window_s=5.0, slo_long_window_s=20.0,
        slos=({"name": "ttft", "kind": "latency",
               "metric": "slt_request_ttft_seconds", "threshold_s": 0.5,
               "objective": 0.9},
              {"name": "errors", "kind": "ratio",
               "bad": "slt_server_errors_total",
               "total": "slt_server_requests_total", "objective": 0.99}))
    if registry is jregistry:
        from serverless_learn_tpu.config import HealthConfig as JHealthConfig
        cfg = JHealthConfig(**{f: getattr(cfg, f) for f in
                               cfg.__dataclass_fields__})
    # The port's engine also reads a goodput ledger for its hold phases:
    # give it an idle one of its own.
    own = {"ledger": tgoodput.PhaseLedger()} if health is thealth else {}
    eng = health.HealthEngine(registry=reg, config=cfg, clock=lambda: 0.0,
                              emit=lambda rec: None, dump_on_critical=False,
                              **own)
    steps = reg.counter("slt_train_steps_total")
    step_t = reg.histogram("slt_train_step_seconds")
    ttft = reg.histogram("slt_request_ttft_seconds")
    reqs = reg.counter("slt_server_requests_total")
    errs = reg.counter("slt_server_errors_total")
    out = []
    for i in range(40):
        now = 1000.0 + i
        if i < 30:  # then the loop stalls
            steps.inc()
            step_t.observe(5.0 if i == 20 else 0.3 + 0.001 * (i % 3))
        reqs.inc(10)
        for k in range(10):
            ttft.observe(2.0 if (i >= 25 and k < 9) else 0.1)
        if i >= 32:
            errs.inc(3)
        eng.sample_once(now=now)
        out.append([(a["alert"], a["severity"], a["state"])
                    for a in eng.alerts()
                    if not a["alert"].startswith(("numerics.",
                                                  "straggler."))])
    return out, eng


def test_health_engine_fires_the_same_alerts():
    j, jeng = _health_run(jregistry, jhealth)
    t, teng = _health_run(tregistry, thealth)
    assert t == j
    fired = {name for tick in t for name, _, state in tick
             if state == "firing"}
    assert {"anomaly.step_time", "stale.train_step", "slo.ttft",
            "slo.errors"} <= fired, fired
    assert teng.health()["ok"] is False  # a critical alert fires
    assert teng.alerts_payload()["firing"]
    rounds = [{"round": r, "live": ["a", "b", "c"],
               "arrivals_s": {"a": 1.0, "b": 1.1, "c": 9.0}}
              for r in range(3)]
    assert thealth.score_stragglers(rounds) == jhealth.score_stragglers(
        rounds)


@pytest.mark.parametrize("hold, fires", [("checkpoint", False),
                                         ("eval", False),
                                         ("data_wait", True)])
def test_stale_train_step_excuses_checkpoint_and_eval_holds(hold, fires):
    """A loop stepping once a second, then held 8 s inside one goodput
    phase, at the default floor (threshold 5 s): a checkpoint or an eval
    hold is taken off the step counter's age, any other phase is not."""
    clock = [0.0]
    led = tgoodput.PhaseLedger(clock=lambda: clock[0], emit=False)
    reg = tregistry.MetricsRegistry()
    eng = thealth.HealthEngine(registry=reg, config=HealthConfig(),
                               clock=lambda: clock[0], emit=lambda rec: None,
                               dump_on_critical=False, ledger=led)
    steps = reg.counter("slt_train_steps_total")
    fired = []

    def tick(t):
        clock[0] = t
        eng.sample_once(now=t)
        fired.extend(a["alert"] for a in eng.alerts(firing_only=True))

    for t in range(10):
        steps.inc()
        tick(float(t))
    with led.phase(hold):
        for t in range(10, 18):
            tick(float(t))
        clock[0] = 18.0
    for t in range(18, 22):
        steps.inc()
        tick(float(t))
    assert ("stale.train_step" in fired) is fires, fired


def _waterfall(waterfall):
    t0 = 50.0
    span = types.SimpleNamespace(t0=t0, marks={}, duration_s=0.0)
    ev = waterfall.BoundaryEvents(window=32)
    wf = waterfall.RequestWaterfall(engine="continuous", min_stall_s=0.001)
    wf.note_admit(t0 + 0.010, t0 + 0.012)
    wf.note_compile(t0 + 0.012, t0 + 0.050)
    wf.note_prefill_chunk(t0 + 0.050, t0 + 0.060, 32, prefix_hit_tokens=16,
                          compiled=True)
    wf.note_prefill_chunk(t0 + 0.070, t0 + 0.080, 5)
    wf.first_token(t0 + 0.085)
    t, itls = t0 + 0.085, []
    for i in range(24):
        gap = 0.008
        if i == 6:
            ev.note("prefill_steal", t + 0.002)
            gap = 0.03
        if i == 11:
            ev.note("compile", t + 0.001, t + 0.02)
            gap = 0.025
        if i == 14:
            ev.note("preempt", t + 0.001)
            wf.note_event("preempt", t + 0.001, t + 0.004)
            gap = 0.05
        if i == 18:
            ev.note("harvest_drain", t + 0.001, t + 0.004)
            ev.note("kv_exhausted", t + 0.002)
            gap = 0.02
        if i == 21:
            gap = 0.04  # nothing in the window: "other"
        t += gap
        itls.append(wf.note_decode(t, 2 if i % 5 == 0 else 1, ev))
    span.marks = {"admit": 0.010, "first_token": 0.085, "done": t - t0}
    span.duration_s = t - t0
    out = wf.finalize(span)
    overhead = out.pop("overhead_s")
    assert overhead >= 0
    return out, itls


def test_request_waterfall_finalize_equal():
    (j, jitl), (t, titl) = _waterfall(jwaterfall), _waterfall(twaterfall)
    assert t == j
    assert titl == jitl
    assert set(t["stall_s"]) >= {"prefill_steal", "compile", "preempt",
                                 "other"}
    decomp = t["ttft_decomp_s"]
    assert sum(decomp.values()) == pytest.approx(t["ttft_s"], abs=1e-5)
    for s in t["stalls"]:
        assert s["base_s"] + sum(s["causes"].values()) == pytest.approx(
            s["gap_s"], abs=1e-5)


@pytest.mark.parametrize("value", [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    " 00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00 ",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "not a header", "", None, 17])
def test_traceparent_parse_and_format_equal(value):
    j = jtracing.parse_traceparent(value)
    t = ttracing.parse_traceparent(value)
    assert (t is None) == (j is None)
    if t is not None:
        assert (t.trace_id, t.span_id, t.flags) == (j.trace_id, j.span_id,
                                                    j.flags)
        assert t.traceparent() == j.traceparent()
        assert ttracing.parse_traceparent(t.traceparent()) == t
    ctx = ttracing.TraceContext("ab" * 16, "cd" * 8, flags=0x1ff)
    assert ctx.traceparent() == jtracing.TraceContext(
        "ab" * 16, "cd" * 8, flags=0x1ff).traceparent()


ENDPOINTS = ("/metrics", "/metrics.json", "/healthz", "/alerts", "/goodput")


def _scrape(name, registry, exporter, health):
    reg = _script(registry.MetricsRegistry())
    reg.histogram("slt_decode_itl_seconds", engine="continuous").observe(
        0.01)
    reg.counter("slt_decode_stall_seconds_total", cause="compile",
                engine="continuous").inc(0.25)
    exp = exporter.MetricsExporter(reg, port=0).start()
    eng = None
    try:
        out = {}
        for path in ENDPOINTS:
            out[path] = exporter.fetch_text(exp.addr, path)
        eng = health.HealthEngine(registry=reg, interval_s=60.0,
                                  emit=lambda rec: None,
                                  dump_on_critical=False)
        eng.sample_once(now=10.0)
        exp.attach_health(eng)
        out["healthz+engine"] = exporter.fetch_text(exp.addr, "/healthz")
        out["alerts+engine"] = exporter.fetch_text(exp.addr, "/alerts")
        try:
            exporter.fetch_text(exp.addr, "/debug/profile?seconds=1")
            out["profile"] = None
        except Exception as e:  # urllib raises on the 404
            out["profile"] = getattr(e, "code", None)
    finally:
        exp.stop()
    return out


def test_exporter_endpoints_equal_over_loopback():
    j = _scrape(*BOTH[0][:2], BOTH[0][6], BOTH[0][3])
    t = _scrape(*BOTH[1][:2], BOTH[1][6], BOTH[1][3])
    assert t["/metrics"] == j["/metrics"]
    assert t["/metrics.json"] == j["/metrics.json"]
    assert json.loads(t["/healthz"]) == json.loads(j["/healthz"])
    assert json.loads(t["/alerts"]) == json.loads(j["/alerts"])
    assert t["profile"] == j["profile"] == 404  # no --profile-dir
    tg, jg = json.loads(t["/goodput"]), json.loads(j["/goodput"])
    assert set(tg) >= {"goodput", "phases", "total_s", "enabled"}
    assert set(tg) <= set(jg) | {"enabled"}
    for key in ("healthz+engine", "alerts+engine"):
        a, b = json.loads(t[key]), json.loads(j[key])
        for d in (a, b):
            d.pop("node", None)
            d.pop("now_unix_s", None)
        assert a == b


def test_profiler_lock_and_capture_on_cpu(tmp_path):
    """One profiler owner: a session holds the lock, so a capture or a
    second session during it is refused; a capture writes a Chrome trace
    and a meta stamp. (Kernels of other threads, which the card's capture
    holds through CUPTI, are checked by ``chip_smoke.py`` phase 9c.)"""
    with tprofiler.capture_session() as prof:
        with pytest.raises(tprofiler.ProfilerBusy):
            tprofiler.capture(0.01, out_dir=str(tmp_path / "x"))
        with pytest.raises(tprofiler.ProfilerBusy):
            with tprofiler.capture_session():
                pass
        torch.ones(4).add_(1)
    assert any(e.name == "aten::add_" for e in prof.events())
    rep = tprofiler.capture(0.05, out_dir=str(tmp_path / "cap"))
    assert rep["ok"] and os.path.exists(rep["trace"])
    with open(rep["trace"]) as f:
        assert "traceEvents" in json.load(f)
    meta = json.load(open(tmp_path / "cap" / "capture-meta.json"))
    assert meta["reason"] == "on-demand" and "ledger_at_trigger" in meta
    with pytest.raises(ValueError):
        tprofiler.capture(0.0, out_dir=str(tmp_path))


def test_flight_dump_runs_death_hooks_first(tmp_path):
    tflight.record({"event": "before"})
    seen = []
    tflight.add_death_hook("t", lambda reason: seen.append(reason) or
                           {"ok": reason})
    tflight.add_death_hook("bad", lambda reason: 1 / 0)
    try:
        path = tflight.dump("drill", dir=str(tmp_path))
    finally:
        tflight.remove_death_hook("t")
        tflight.remove_death_hook("bad")
    dump = json.load(open(path))
    assert seen == ["drill"] and dump["reason"] == "drill"
    assert dump["death_hooks"]["t"] == {"ok": "drill"}
    assert "ZeroDivisionError" in dump["death_hooks"]["bad"]["error"]
    assert any(e.get("event") == "before" for e in dump["events"])
    assert "metrics" in dump
    # No card touched in this process: no memory section, and the
    # recorder never starts CUDA.
    assert "device_memory" not in dump
    assert not torch.cuda.is_initialized()


def test_tracer_and_spans():
    tr = ttracing.Tracer()
    for _ in range(3):
        with tr.span("train/step"):
            pass
    s = tr.summary()["train/step"]
    assert s["count"] == 3 and s["max_s"] >= s["mean_s"] >= 0
    parent = ttracing.TraceContext("12" * 16, "34" * 8)
    with ttracing.span("outer", parent=parent, emit=False) as outer:
        assert ttracing.current_context().span_id == outer.span_id
        with ttracing.span("inner", emit=False) as inner:
            pass
    assert outer.trace_id == inner.trace_id == "12" * 16
    assert inner.parent_id == outer.span_id
    assert outer.parent_id == "34" * 8
    assert ttracing.current_context() is None
    rec = inner.to_event()
    assert rec["event"] == "span" and "done" in rec["marks_s"]
    assert math.isfinite(rec["duration_s"])


def test_device_gate_starts_sessions_between_work():
    """A session starts or stops only between the device loops' work:
    ``exclusive`` waits for the work in flight and holds new work back;
    work nests in one thread, which may itself start a session."""
    import threading
    import time

    gate = tprofiler._DeviceGate()
    events, in_work, release = [], threading.Event(), threading.Event()

    def loop():
        with gate.work():
            in_work.set()
            release.wait(10)
            events.append("work")

    def session():
        with gate.exclusive():
            events.append("session")

    t = threading.Thread(target=loop)
    t.start()
    assert in_work.wait(10)
    s = threading.Thread(target=session)
    s.start()
    time.sleep(0.05)
    assert events == []  # the session waits for the work in flight
    release.set()
    s.join(10)
    t.join(10)
    assert not s.is_alive() and not t.is_alive()
    assert events == ["work", "session"]
    with gate.work(), gate.work(), gate.exclusive():
        events.append("nested")
    assert events[-1] == "nested" and gate._active == 0
