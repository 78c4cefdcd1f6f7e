"""The PyTorch port's continuous engine on the CPU, against the
reference's solo ``generate`` (llama_tiny in f32 at max_seq_len 64, flax
weights bridged with ``bridge.from_jax_params``): greedy replies over the
paged pool (chunked prefill, prefix reuse with copy-on-write, preemption)
and over the monolithic rows equal it token for token; the scheduler's
bookkeeping (EOS retirement, more requests than slots, mid-stream
admission, compacted decode rows, no leaked pages); sampled replies are
reproducible and independent of batch-mates; the static engine's paged
groups; the server's default engine and its ``ping``; the ``serve`` flags.

The reference package is imported inside fixtures, so the ``cuda`` test at
the end also runs where flax is not installed.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from chip_smoke import graph_vs_eager_chunk
from serverless_learn_tpu_torch import cli
from serverless_learn_tpu_torch.config import ExperimentConfig, KVCacheConfig
from serverless_learn_tpu_torch.inference.batching import BatchingEngine
from serverless_learn_tpu_torch.inference.continuous import (
    ContinuousBatchingEngine, _uniform, sample_slots)
from serverless_learn_tpu_torch.inference.server import (GenerationServer,
                                                        request)
from serverless_learn_tpu_torch.models.registry import (build_model,
                                                        get_model_config)
from serverless_learn_tpu_torch.models.transformer import Transformer

MAX_SEQ = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores, and a
    tiny model's ops lose more to thread hand-offs than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """(port model, solo(prompt, n, eos_id) -> the reference's greedy new
    tokens), memoized per request."""
    import jax
    import jax.numpy as jnp

    from serverless_learn_tpu.inference.generate import generate
    from serverless_learn_tpu.models.registry import get_model
    from serverless_learn_tpu_torch.bridge import from_jax_params

    bundle = get_model("llama_tiny", dtype=jnp.float32,
                       param_dtype=jnp.float32, max_seq_len=MAX_SEQ)
    params = bundle.module.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = get_model_config("llama_tiny", dtype="float32",
                           max_seq_len=MAX_SEQ)
    model = Transformer(cfg, device="cpu").eval()
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    memo = {}

    def solo(prompt, n, eos_id=None):
        key = (tuple(prompt), n, eos_id)
        if key not in memo:
            toks = generate(bundle.module, params,
                            jnp.asarray([prompt], jnp.int32), n,
                            eos_id=eos_id)
            memo[key] = np.asarray(toks)[0, len(prompt):].tolist()
        return memo[key]

    return model, solo


def _engine(model, **kw):
    kv = kw.pop("kv", None) or KVCacheConfig(block_size=4, prefill_chunk=4,
                                             prefill_budget=8)
    kw.setdefault("max_slots", 4)
    kw.setdefault("chunk_size", 4)
    return ContinuousBatchingEngine(model, kv=kv, **kw)


def _concurrent(eng, reqs, together=False):
    """Submit every (prompt, max_new, temperature, top_k, eos_id, seed)
    from its own thread; the replies in order. ``together``: the engine
    admits them all at one boundary."""
    out = [None] * len(reqs)

    def client(i):
        out[i] = eng.submit(*reqs[i], timeout_s=120)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    if together:
        eng._min_admit = len(reqs)
    for t in threads:
        t.start()
    if together:
        while eng.requests_admitted < len(reqs):
            threads[0].join(timeout=0.001)
        eng._min_admit = 1  # a preempted request readmits alone
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)
    for r in out:
        assert r is not None and "error" not in r, r
    return out


def _greedy(prompt, n, eos_id=None):
    return (prompt, n, 0.0, 0, eos_id, 0)


def _no_leak(eng):
    st = eng.kv_stats()
    assert st["blocks_total"] - st["blocks_free"] == st["prefix_blocks_cached"]


LONG = [7, 3, 2, 8, 1, 30, 12, 9, 4, 2, 6, 1, 8, 5, 5, 2]  # 4 chunks of 4
PROMPTS = [[5, 9, 11], LONG, [4], [1, 2]]


@pytest.mark.parametrize("kv", [
    KVCacheConfig(block_size=4, prefill_chunk=4, prefill_budget=8),
    KVCacheConfig(paged=False)], ids=["paged", "monolithic"])
def test_concurrent_unequal_greedy_prompts_match_solo(ref, kv):
    """Concurrent unequal prompts, one of them prefilled in four chunks,
    equal the reference's solo generate; kv.paged=False too."""
    model, solo = ref
    eng = _engine(model, kv=kv)
    try:
        got = _concurrent(eng, [_greedy(p, 6) for p in PROMPTS])
        for p, r in zip(PROMPTS, got):
            assert r["new_tokens"] == solo(p, 6)
        if kv.paged:
            assert eng.prefill_chunks_run >= 4 + len(PROMPTS) - 1
            _no_leak(eng)
        assert eng.requests_admitted == eng.requests_finished == 4
    finally:
        eng.stop()


def test_mid_stream_admission_and_more_requests_than_slots(ref):
    """Two slots, six requests: later ones wait for a slot and are admitted
    while others decode; one arrives after decoding started."""
    model, solo = ref
    eng = _engine(model, max_slots=2, chunk_size=2)
    try:
        reqs = [_greedy([i + 3, 9, 11, i], 10) for i in range(6)]
        got = _concurrent(eng, reqs[:5])
        late = eng.submit(*reqs[5])
        for (p, n, *_), r in zip(reqs, got + [late]):
            assert r["new_tokens"] == solo(p, n)
        assert eng.requests_admitted == 6
        _no_leak(eng)
        # A long request decoding while a short one is admitted later: the
        # short one is submitted from inside the dispatcher's third decode
        # step of the long one, which waits until it is queued.
        res = {}
        base = eng.chunks_run
        short = threading.Thread(target=lambda: res.setdefault(
            "short", eng.submit(*_greedy([7, 3], 3))))
        decode = eng._decode_step_paged

        def decode_then_submit(staged):
            if eng.chunks_run == base + 3 and short.ident is None:
                short.start()
                while eng._q.empty():
                    time.sleep(0.001)
            return decode(staged)

        eng._decode_step_paged = decode_then_submit
        res["long"] = eng.submit(*_greedy([5, 9, 11], 56))
        short.join(timeout=120)
        assert res["long"]["new_tokens"] == solo([5, 9, 11], 56)
        assert res["short"]["new_tokens"] == solo([7, 3], 3)
        assert res["short"]["batch_size"] == 2  # admitted beside it
    finally:
        eng.stop()


def test_eos_retires_early_and_returns_blocks(ref):
    model, solo = ref
    prompt = [5, 9, 11]
    eos = solo(prompt, 3)[2]
    eng = _engine(model, kv=KVCacheConfig(block_size=4, prefill_chunk=4,
                                          prefix_cache=False))
    try:
        r = eng.submit(*_greedy(prompt, 40, eos))
        assert r["new_tokens"] == solo(prompt, 40, eos)
        assert r["new_tokens"][2:] == [eos] * 38
        # Retired at the first boundary after the EOS, not after 40 tokens.
        assert eng.chunks_run < 40 // eng.chunk_size
        st = eng.kv_stats()
        assert st["blocks_free"] == st["blocks_total"]
    finally:
        eng.stop()


class _Cows(dict):
    """The engine's pending copy-on-write table, remembering every copy."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __setitem__(self, sid, cow):
        self.made.append(cow)
        super().__setitem__(sid, cow)


def test_shared_prefix_hits_with_cow_and_stays_exact(ref):
    """Prompts sharing a 12-token system prefix reuse its published
    blocks. One diverging inside the third block copies that block from
    the trie's donor (COW); one equal to the prefix copies its last block,
    since its last token is always recomputed."""
    model, solo = ref
    eng = _engine(model)
    eng._pending_cow = cows = _Cows()
    try:
        sysp = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]
        prompts = [sysp + [11, 2], sysp + [9, 7], sysp[:10] + [44, 45],
                   sysp[:10] + [44], sysp]
        for i, p in enumerate(prompts):
            assert eng.submit(*_greedy(p, 5))["new_tokens"] == solo(p, 5)
            assert eng._trie.hits == i
            assert len(cows.made) == max(0, i - 2)
        st = eng.kv_stats()
        assert st["prefix_hit_rate"] > 0 and st["prefix_blocks_cached"] > 0
        _no_leak(eng)
    finally:
        eng.stop()


def test_small_pool_backpressure_and_preemption_stay_exact(ref):
    """A pool for ONE max-length sequence under four long requests:
    admissions wait, decode preempts the youngest, every reply is exact
    and no page leaks."""
    model, solo = ref
    eng = ContinuousBatchingEngine(
        model, max_slots=4, chunk_size=4,
        kv=KVCacheConfig(block_size=4, num_blocks=16, prefill_chunk=4,
                         prefix_cache=False))
    try:
        reqs = [_greedy([i + 1, i + 2, 3, 4, 5, 1, 2, 9], 24)
                for i in range(4)]
        for (p, n, *_), r in zip(reqs, _concurrent(eng, reqs,
                                                   together=True)):
            assert r["new_tokens"] == solo(p, n)
        assert eng.preemptions > 0
        st = eng.kv_stats()
        assert st["blocks_free"] == st["blocks_total"]
    finally:
        eng.stop()


def test_decode_rows_track_live_slots(ref):
    """Decode runs a compacted live batch: once the short request retires,
    a chunk decodes one row, not max_slots."""
    model, solo = ref
    eng = _engine(model, max_slots=4, chunk_size=2)
    try:
        got = _concurrent(eng, [_greedy([5, 9, 11], 24), _greedy([7, 3], 2)])
        assert got[0]["new_tokens"] == solo([5, 9, 11], 24)
        assert got[1]["new_tokens"] == solo([7, 3], 2)
        assert eng.chunks_run >= 2
        assert eng.decoded_rows_total <= eng.chunks_run + 4
        assert eng.dispatched_rows_total < eng.chunks_run * 4
    finally:
        eng.stop()


def test_sampling_is_reproducible_and_batch_invariant(ref):
    """A sampled reply depends only on its request: alone, beside greedy
    and sampled batch-mates, on the monolithic rows, and again."""
    model, _ = ref
    req = ([7, 3, 2, 9, 1, 4], 8, 0.9, 8, None, 42)
    replies = []
    for kv in (None, KVCacheConfig(paged=False)):
        eng = _engine(model, kv=kv)
        try:
            replies.append(eng.submit(*req)["new_tokens"])
            mates = _concurrent(eng, [req, _greedy([5, 9, 11, 4], 8),
                                      ([1, 2, 3], 8, 1.3, 0, None, 7)])
            replies.append(mates[0]["new_tokens"])
            replies.append(eng.submit(*req)["new_tokens"])
            other = eng.submit(*req[:5], 43)["new_tokens"]
        finally:
            eng.stop()
    assert all(r == replies[0] for r in replies), replies
    assert other != replies[0]  # another seed, another stream
    assert len(set(replies[0])) > 1


def test_sampler_noise_and_top_k():
    """The noise is uniform on (0, 1), a function of (seed, position,
    index); greedy rows take the raw argmax; top_k keeps the draws to the
    row's k largest logits."""
    seeds = torch.tensor([1, 1, 2], dtype=torch.int64)
    pos = torch.tensor([0, 1, 0], dtype=torch.int32)
    u = _uniform(seeds, pos, 1000)
    assert u.shape == (3, 1000) and 0 < u.min() and u.max() < 1
    assert torch.equal(u, _uniform(seeds, pos, 1000))
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert abs(u.mean().item() - 0.5) < 0.02
    logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(0))
    top3 = logits.topk(3).indices
    zeros = torch.zeros(3, dtype=torch.int32)
    for p in range(20):
        toks = sample_slots(logits, torch.tensor([0.0, 2.0, 2.0]),
                            torch.tensor([0, 3, 3], dtype=torch.int32),
                            seeds, zeros + p, max_top_k=8)
        assert toks[0] == logits[0].argmax()
        assert all(toks[i] in top3[i] for i in (1, 2))


def test_top_k_above_the_engines_bound_is_refused(ref):
    model, _ = ref
    eng = _engine(model, max_top_k=8)
    try:
        rep = eng.submit([5, 9], 4, 0.8, 9, None, 0)
        assert "max_top_k" in rep["error"]
        assert eng.submit([5, 9], 0, 0.0, 0, None, 0) == {
            "new_tokens": [], "batch_size": 0}
        assert "exceeds max_seq_len" in eng.submit([5] * 60, 8, 0.0, 0,
                                                   None, 0)["error"]
    finally:
        eng.stop()


def test_static_engine_paged_groups_match_monolithic(ref):
    model, solo = ref
    prompts = [[5, 9, 11], [7, 3, 2, 8], [4, 4]]
    for kv in (None, KVCacheConfig(block_size=8)):
        eng = BatchingEngine(model, max_batch=4, batch_wait_ms=200.0, kv=kv)
        try:
            for p, r in zip(prompts, _concurrent(
                    eng, [_greedy(p, 4) for p in prompts])):
                assert r["new_tokens"] == solo(p, 4)
        finally:
            eng.stop()


def test_graph_chunk_check_runs_on_cpu(ref):
    """The check chip_smoke.py runs on the card: on the CPU both runs are
    eager, and they agree; its pages go back to the pool."""
    model, solo = ref
    eng = _engine(model)
    try:
        rep = graph_vs_eager_chunk(torch, eng, [[5, 9, 11], [7, 3, 2, 8, 1]])
        assert rep["identical"] and not rep["graph"]
        assert rep["tokens_eager"][0] == solo([5, 9, 11], 5)[1:]
        st = eng.kv_stats()
        assert st["blocks_free"] == st["blocks_total"]
    finally:
        eng.stop()


def test_server_defaults_to_continuous_and_ping_carries_kv(ref):
    model, solo = ref
    srv = GenerationServer(model, port=0, max_batch=4, chunk_size=4).start()
    try:
        assert isinstance(srv.engine, ContinuousBatchingEngine)
        assert srv.engine.kv == KVCacheConfig()
        rep = request(srv.addr, {"prompt": [5, 9, 11], "max_new_tokens": 3})
        assert rep["new_tokens"] == solo([5, 9, 11], 3)
        ping = request(srv.addr, {"op": "ping"})
        assert ping["ok"] and ping["kv"]["blocks_total"] > 0
        assert ping["kv"]["block_size"] == 16
        assert ping["kv"]["blocks_free"] <= ping["kv"]["blocks_total"]
    finally:
        srv.stop()


@pytest.mark.parametrize("argv, want", [
    ([], dict(engine="continuous", block_size=16, blocks_total=4 * 4 + 4)),
    (["--kv-block-size", "8", "--kv-num-blocks", "40", "--prefill-chunk",
      "8", "--no-prefix-cache", "--chunk-size", "4"],
     dict(engine="continuous", block_size=8, blocks_total=40)),
    (["--set", "kv.block_size=32", "--set", "kv.num_blocks=6"],
     dict(engine="continuous", block_size=32, blocks_total=6)),
    (["--kv-monolithic"], dict(engine="continuous", kv=None)),
    (["--serve-engine", "static"], dict(engine="static", kv=None)),
    (["--serve-engine", "static", "--kv-monolithic"],
     dict(engine="static", kv=None)),
])
def test_cli_serve_takes_the_engine_and_kv_flags(monkeypatch, capsys, argv,
                                                 want):
    """``serve`` builds the engine its flags ask for (the serving line
    reports it) and stops; the socket loop is stubbed out."""
    seen = {}
    monkeypatch.setattr(GenerationServer, "serve_forever",
                        lambda self: seen.setdefault("engine", self.engine))
    assert cli.main(["serve", "--model", "llama_tiny", "--device", "cpu",
                     "--port", "0", "--max-batch", "4", "--set",
                     "model_overrides.n_layers=1", "--set",
                     "model_overrides.max_seq_len=64", *argv]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["event"] == "serving" and line["engine"] == want["engine"]
    if "kv" in want:
        assert line["kv"] is None
    else:
        assert line["kv"]["block_size"] == want["block_size"]
        assert line["kv"]["blocks_total"] == want["blocks_total"]
    eng = seen["engine"]
    if "--kv-monolithic" in argv:
        assert eng.kv.paged is False
    if "--no-prefix-cache" in argv:
        assert eng.kv.prefix_cache is False and eng.chunk_size == 4
        assert eng.prefill_chunk == 8


@pytest.mark.parametrize("argv, needle", [
    (["--set", "kv.digest=1"], "unexpected keyword argument 'digest'"),
    (["--set", "kv"], "dotted.key=value"),
])
def test_cli_refuses_invalid_kv_settings(argv, needle):
    with pytest.raises(SystemExit, match=needle):
        cli.main(["serve", "--model", "llama_tiny", "--device", "cpu",
                  "--port", "0", *argv])


def test_kv_config_section_loads():
    cfg = ExperimentConfig.from_dict({
        "model": "llama_tiny",
        "kv": {"paged": True, "block_size": 8, "num_blocks": 64,
               "prefill_chunk": 16, "prefix_cache": False}})
    assert cfg.kv.block_size == 8 and cfg.kv.num_blocks == 64
    assert not cfg.kv.prefix_cache
    assert json.loads(cfg.to_json())["kv"]["prefill_chunk"] == 16
    with pytest.raises(SystemExit, match="kv"):
        cli.main(["serve", "--model", "llama_tiny", "--device", "cpu",
                  "--port", "0", "--set", "kv.no_such_field=1"])


@pytest.mark.cuda
def test_graph_replayed_chunk_equals_eager_chunk_on_card():
    """On the card a decode chunk replayed from its CUDA graph gives the
    eager chunk's tokens and pages bit for bit, and the engine serves
    through graphs (llama_tiny int8 in bf16: the int8 matmul kernel
    inside the graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs)")
    model = build_model("llama_tiny", device="cuda", quant="int8", seed=0,
                        max_seq_len=MAX_SEQ)
    eng = _engine(model)
    try:
        rep = graph_vs_eager_chunk(torch, eng,
                                   [[5, 9, 11], [7, 3, 2, 8, 1], [4]])
        assert rep["graph"] and rep["identical"], rep
        r = eng.submit(*_greedy([5, 9, 11], 9))
        assert len(r["new_tokens"]) == 9
        assert eng.graph_captures >= 2 and eng.graph_replays > 0
    finally:
        eng.stop()


COUNTERS = ("slt_requests_total", "slt_requests_finished_total",
            "slt_decode_tokens_total", "slt_prefill_chunks_total",
            "slt_kv_prefix_hits_total", "slt_kv_prefix_tokens_total",
            "slt_kv_preemptions_total")


def test_engine_counters_equal_the_reference(ref):
    """The same requests, one after another, through the reference's
    engine and the port's, each on a fresh registry: equal request,
    token, prefill-chunk, prefix-hit and preemption counters and equal
    replies; every reply's span in the event log carries a waterfall."""
    import jax
    import jax.numpy as jnp

    from serverless_learn_tpu.config import KVCacheConfig as JKV
    from serverless_learn_tpu.inference.continuous import (
        ContinuousBatchingEngine as JEngine)
    from serverless_learn_tpu.models.registry import get_model
    from serverless_learn_tpu.telemetry.registry import (
        MetricsRegistry as JRegistry)
    from serverless_learn_tpu_torch.telemetry.registry import (
        MetricsRegistry as TRegistry)

    model, _ = ref
    bundle = get_model("llama_tiny", dtype=jnp.float32,
                       param_dtype=jnp.float32, max_seq_len=MAX_SEQ)
    params = bundle.module.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    sysp = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    reqs = [_greedy(LONG, 6), _greedy(sysp + [11, 2], 5),
            _greedy(sysp + [9], 5), _greedy([4], 3, eos_id=None)]
    kw = dict(max_slots=4, chunk_size=4)
    jreg, treg = JRegistry(), TRegistry()
    records = []
    log = type("Sink", (), {"emit": lambda self, r: records.append(r),
                            "close": lambda self: None})()
    jeng = JEngine(bundle.module, params, registry=jreg,
                   kv=JKV(block_size=4, prefill_chunk=4, prefill_budget=8),
                   **kw)
    teng = _engine(model, registry=treg, event_log=log, **kw)
    try:
        for r in reqs:
            assert (teng.submit(*r)["new_tokens"]
                    == jeng.submit(*r)["new_tokens"])
    finally:
        jeng.stop()
        teng.stop()
    js, ts = jreg.snapshot(), treg.snapshot()
    for name in COUNTERS:
        want = [s["value"] for s in js[name]["series"]]
        assert [s["value"] for s in ts[name]["series"]] == want, name
        assert ts[name]["series"][0]["labels"] == {"engine": "continuous"}
    assert ts["slt_requests_total"]["series"][0]["value"] == len(reqs)
    assert ts["slt_kv_prefix_hits_total"]["series"][0]["value"] == 1
    for name in ("slt_request_ttft_seconds", "slt_request_latency_seconds",
                 "slt_request_queue_wait_seconds"):
        assert ts[name]["series"][0]["count"] == len(reqs), name
    spans = [r for r in records if r.get("event") == "span"]
    assert len(spans) == len(reqs)
    for sp in spans:
        wf = sp["waterfall"]
        assert sp["span"] == "request" and wf["engine"] == "continuous"
        assert sum(wf["ttft_decomp_s"].values()) == pytest.approx(
            wf["ttft_s"], abs=1e-5)
    assert teng.decode_harvests > 0 and teng.telemetry_host_s > 0
