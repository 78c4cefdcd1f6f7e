"""The PyTorch port's generation server on the CPU: the reference's wire
protocol, batched greedy replies equal to the reference's solo
``generate``, request validation and the admin ops; the CLI's refusals."""

import json
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.inference.generate import generate as jax_generate
from serverless_learn_tpu.models.registry import get_model
from serverless_learn_tpu_torch import cli
from serverless_learn_tpu_torch.bridge import from_jax_params
from serverless_learn_tpu_torch.config import KVCacheConfig
from serverless_learn_tpu_torch.inference.server import (MAX_LINE,
                                                        GenerationServer,
                                                        request)
from serverless_learn_tpu_torch.models.registry import get_model_config
from serverless_learn_tpu_torch.models.transformer import Transformer


@pytest.fixture(scope="module")
def served():
    bundle = get_model("llama_tiny", dtype=jnp.float32, max_seq_len=32)
    params = bundle.module.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = get_model_config("llama_tiny", dtype="float32", max_seq_len=32)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    # The static engine over the monolithic cache, the coalescer these
    # tests hold to the reference; the continuous default has its own file.
    server = GenerationServer(model, port=0, max_batch=4,
                              batch_wait_ms=300.0, engine="static",
                              kv=KVCacheConfig(paged=False)).start()
    yield bundle.module, params, server
    server.stop()


def test_concurrent_greedy_requests_match_reference_solo(served):
    module, params, server = served
    prompts = [[5, 9, 11], [7, 3, 2, 8], [4, 4, 4, 4, 4]]
    replies = [None] * 3

    def client(i):
        replies[i] = request(server.addr, {"prompt": prompts[i],
                                           "max_new_tokens": 5})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for p, rep in zip(prompts, replies):
        assert set(rep) == {"tokens", "new_tokens", "batch_size",
                            "latency_ms"}, rep
        solo = jax_generate(module, params, jnp.asarray([p], jnp.int32), 5)
        want = np.asarray(solo)[0, len(p):].tolist()
        assert rep["new_tokens"] == want
        assert rep["tokens"] == p + want
    assert max(r["batch_size"] for r in replies) > 1  # they were coalesced


@pytest.mark.parametrize("req, needle", [
    ({"prompt": []}, "non-empty list"),
    ({"prompt": [1, "2"]}, "non-empty list"),
    ({"prompt": [1, 512]}, "out of range [0, 512)"),
    ({"prompt": [1, 2], "max_new_tokens": 31}, "exceeds max_seq_len 32"),
    ({"op": "nope"}, "unknown op"),
])
def test_validation_errors(served, req, needle):
    rep = request(served[2].addr, req)
    assert needle in rep["error"]


def test_ping_traceparent_and_bad_lines(served):
    server = served[2]
    rep = request(server.addr, {"op": "ping"})
    assert rep["ok"] is True and rep["draining"] is False
    assert isinstance(rep["requests_served"], int)
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    rep = request(server.addr, {"prompt": [3], "max_new_tokens": 1,
                                "traceparent": f"00-{tid}-00f067aa0ba902b7-01"})
    assert rep["trace_id"] == tid and len(rep["new_tokens"]) == 1
    host, _, port = server.addr.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=30) as s:
        f = s.makefile("rwb")
        f.write(b"[1, 2]\n")
        f.flush()
        assert "JSON object" in json.loads(f.readline())["error"]
        f.write(b"x" * (MAX_LINE + 10) + b"\n")
        f.flush()
        assert "exceeds" in json.loads(f.readline())["error"]
        assert f.readline() == b""  # the server hung up


def test_cli_serve_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["serve", "--model", "llama_tiny", "--port", "0"])


@pytest.mark.parametrize("argv, needle", [
    (["--set", "fleet.drain_grace_s=1"], "model_overrides.<field>"),
    (["--fleet"], "queue 1 item 5"),
])
def test_cli_refuses_what_is_not_ported(argv, needle):
    with pytest.raises(SystemExit, match=needle):
        cli.main(["serve", "--model", "llama_tiny", "--device", "cpu",
                  "--port", "0", *argv])


def test_cli_generate_on_cpu(capsys):
    assert cli.main(["generate", "--model", "llama_tiny", "--device", "cpu",
                     "--set", "model_overrides.n_layers=1", "--prompt",
                     "5,9,11", "--max-new-tokens", "4"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["prompt"] == [[5, 9, 11]]
    assert rep["tokens"][0][:3] == [5, 9, 11] and len(rep["tokens"][0]) == 7


def test_cli_serve_answers_metrics_and_train_prints_the_done_keys(capsys):
    """``serve --metrics-port 0`` answers a request, then /metrics counts
    it; ``train --metrics-port 0 --health`` prints the reference's ``done``
    keys (``serverless_learn_tpu/cli.py`` cmd_train: the meter's
    steady state, ``goodput``, ``badput_breakdown``, ``spans``)."""
    import os
    import signal
    import subprocess
    import sys

    from serverless_learn_tpu_torch.telemetry import fetch_text

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    child = subprocess.Popen(
        [sys.executable, "-m", "serverless_learn_tpu_torch", "serve",
         "--model", "llama_tiny", "--device", "cpu", "--port", "0",
         "--metrics-port", "0", "--set", "model_overrides.n_layers=1"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        lines = {}
        for line in child.stdout:
            rec = json.loads(line)
            lines[rec["event"]] = rec
            if rec["event"] == "serving":
                break
        addr, maddr = lines["serving"]["addr"], lines["serving"][
            "metrics_addr"]
        rep = request(addr, {"prompt": [5, 9, 11], "max_new_tokens": 4})
        assert len(rep["new_tokens"]) == 4
        text = fetch_text(maddr, "/metrics")
        assert "slt_server_requests_total 1" in text
        assert 'slt_requests_total{engine="continuous"} 1' in text
        assert 'slt_decode_tokens_total{engine="continuous"} 4' in text
        assert json.loads(fetch_text(maddr, "/healthz"))["ok"] is True
    finally:
        child.send_signal(signal.SIGINT)
        try:
            child.wait(timeout=60)
        finally:
            if child.poll() is None:
                child.kill()
    assert child.returncode == 0

    assert cli.main(["train", "--model", "llama_tiny", "--batch-size", "2",
                     "--seq-len", "32", "--steps", "3", "--device", "cpu",
                     "--set", "model_overrides.n_layers=1",
                     "--metrics-port", "0", "--health"]) == 0
    out = [json.loads(line) for line in
           capsys.readouterr().out.strip().splitlines()]
    assert [r["event"] for r in out] == ["metrics", "health", "done"]
    done = out[-1]
    jax_keys = {"event", "final_step", "samples_per_sec",
                "samples_per_sec_per_chip", "step_time_s",
                "tflops_per_sec_per_chip", "goodput", "badput_breakdown",
                "spans"}
    assert jax_keys <= set(done)
    assert 0 < done["goodput"] <= 1
    assert "compile" in done["badput_breakdown"]
    assert done["spans"]["train/step"]["count"] >= 3  # a process-wide tracer
