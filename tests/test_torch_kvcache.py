"""The PyTorch port's paged KV cache against the reference's
(``serverless_learn_tpu/inference/kvcache.py`` and the paged branch of its
transformer), on the CPU: the block pool and prefix trie driven through
one script give identical ids, refcounts, hits and evictions; paged
prefill, extend and decode logits (and the pool pages they write) match the
JAX paged module over the same tables and ragged lengths; the monolithic
``extend`` matches the JAX one; an all-padding row writes nothing but the
scratch page; paged ``generate`` equals monolithic ``generate``.

llama_tiny in f32 at max_seq_len 64, flax weights bridged with
``bridge.from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from serverless_learn_tpu.inference import kvcache as ref_kv
from serverless_learn_tpu.inference.generate import generate as jax_generate
from serverless_learn_tpu.inference.generate import init_cache as jax_cache
from serverless_learn_tpu.models.registry import get_model
from serverless_learn_tpu_torch.bridge import from_jax_params
from serverless_learn_tpu_torch.inference import kvcache as port_kv
from serverless_learn_tpu_torch.inference.generate import generate, init_cache
from serverless_learn_tpu_torch.models.registry import get_model_config
from serverless_learn_tpu_torch.models.transformer import KVCache, Transformer

MAX_SEQ = 64
# Both sides compute in f32 on the CPU with the same weights; they differ
# only in the order of f32 sums (einsum vs XLA dot), ~1e-6 of the largest
# logit, so 1e-5 of it bounds them with room.
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores, and a
    tiny model's ops lose more to thread hand-offs than they gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    bundle = get_model("llama_tiny", dtype=jnp.float32,
                       param_dtype=jnp.float32, max_seq_len=MAX_SEQ)
    params = bundle.module.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = get_model_config("llama_tiny", dtype="float32",
                           max_seq_len=MAX_SEQ)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return bundle.module, params, model


def assert_logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL,
                               atol=LOGIT_RTOL * np.abs(want).max())


# -- pool and trie: one script through both packages --------------------------


def _drive(kv, seed: int, steps: int = 160) -> list:
    """A seeded random script of allocations, shares, retirements,
    registrations, lookups (with mid-block divergence) and evictions over
    ``kv``'s BlockPool and PrefixTrie; returns everything they answered."""
    rng = np.random.default_rng(seed)
    pool = kv.BlockPool(24, block_size=4)
    trie = kv.PrefixTrie(pool, max_blocks=8, hit_window=16)
    systems = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8], [3, 1, 4, 1]]
    owned: list = []
    trace = []

    def prompt():
        sysp = systems[rng.integers(len(systems))]
        tail = rng.integers(0, 3, rng.integers(0, 8)).tolist()
        return sysp + tail

    def attempt(fn, *args):
        try:
            return fn(*args)
        except kv.KVCacheError as e:
            return (type(e).__name__, getattr(e, "need", None),
                    getattr(e, "free", None))

    for _ in range(steps):
        op = rng.integers(7)
        if op == 0:
            got = attempt(pool.alloc, int(rng.integers(1, 6)))
            if isinstance(got, list) and got:
                owned.append(got)
            trace.append(("alloc", got))
        elif op == 1 and owned:
            blocks = owned[rng.integers(len(owned))]
            pool.incref(blocks[:1])
            owned.append(blocks[:1])
            trace.append(("incref", blocks[0], pool.refcount(blocks[0])))
        elif op == 2 and owned:
            blocks = owned.pop(rng.integers(len(owned)))
            trace.append(("decref", attempt(pool.decref, blocks)))
            if rng.random() < 0.2:  # a double free is a typed error
                trace.append(("double_free", attempt(pool.decref, blocks)))
        elif op == 3:
            p = prompt()
            blocks = attempt(pool.alloc, kv.pages_for(len(p), 4))
            if isinstance(blocks, list):
                owned.append(blocks)
                trace.append(("register", trie.register(p, blocks[:len(p)
                                                               // 4])))
        elif op == 4:
            hit = trie.lookup(prompt())
            trace.append(("lookup", hit.blocks, hit.tokens_matched,
                          hit.cow_src, hit.cow_tokens))
        elif op == 5:
            trace.append(("release", trie.release(int(rng.integers(1, 4)))))
        trace.append((pool.free_blocks, pool.used_blocks, trie.blocks_held,
                      trie.hits, trie.lookups, trie.window_hit_rate(),
                      [pool.refcount(b) for b in range(pool.num_blocks)]))
    trace.append(("clear", trie.clear(), pool.free_blocks))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_pool_and_trie_match_reference(seed):
    assert _drive(port_kv, seed) == _drive(ref_kv, seed)


def test_pool_and_trie_scenario_matches_reference():
    """The reference's own allocator and trie scenario (a full-prefix hit,
    a divergent block, a COW donor, retirement, LRU eviction preferring
    trie-only leaves, a pinned block surviving eviction), run through
    both packages."""

    def scenario(kv):
        out = []
        pool = kv.BlockPool(16, block_size=4)
        trie = kv.PrefixTrie(pool)
        prompt = list(range(10))
        blocks = pool.alloc(3)
        out.append(trie.register(prompt, blocks[:2]))
        out.append(pool.refcount(blocks[0]))
        for p in (prompt, [0, 1, 2, 3, 99, 98, 97, 96], [0, 1, 2, 3, 4, 5]):
            hit = trie.lookup(p)
            out.append((hit.blocks, hit.tokens_matched, hit.cow_src,
                        hit.cow_tokens))
        pool.decref(blocks)
        out += [pool.free_blocks, trie.release(1), trie.blocks_held,
                trie.clear(), pool.free_blocks]
        pool = kv.BlockPool(8, block_size=2)
        trie = kv.PrefixTrie(pool, max_blocks=1)
        b1 = pool.alloc(1)
        trie.register([1, 2], b1)
        b2 = pool.alloc(1)
        trie.register([3, 4], b2)
        out += [trie.blocks_held, pool.refcount(b1[0])]
        pool.decref(b1)
        pool.decref(b2)
        out += [pool.refcount(b2[0]), kv.pages_for(9, 8),
                kv.chunk_hashes(list(range(9)), 4)]
        try:
            pool.decref(b1)
        except kv.KVCacheError as e:
            out.append(str(e))
        out.append(kv.sequential_table(2, 3, 6).tolist())
        return out

    assert scenario(port_kv) == scenario(ref_kv)


# -- the paged forward --------------------------------------------------------

PS, NUM_BLOCKS = 4, 32
SENT = NUM_BLOCKS
# Three rows over a W = 4 page window (16 positions), pages scattered
# through the pool; row 2 holds two pages.
TABLE = np.array([[3, 7, 1, SENT], [0, 2, 5, 6], [9, 8, SENT, SENT]],
                 np.int32)
PREFILL = np.array([[5, 9, 11, 3, 7, 0, 0, 0], [7, 3, 2, 8, 1, 30, 12, 9],
                    [4, 4, 6, 0, 0, 0, 0, 0]], np.int32)
PREFILL_LENS = np.array([5, 8, 3], np.int32)
EXTEND = np.array([[1, 2, 3, 4], [8, 9, 0, 0], [5, 5, 5, 5]], np.int32)
EXTEND_LENS = np.array([4, 2, 0], np.int32)  # row 2: all padding
DECODE = np.array([[6, 1, 2], [3, 3, 9], [7, 0, 4]], np.int32)  # [B, steps]


def _jax_paged(module, params):
    """The reference's paged module over TABLE: (prefill, extend, decode
    logits, pages_k of layer 0)."""
    pm = ref_kv.paged_module(module, PS, NUM_BLOCKS)
    cache = ref_kv.with_tables(jax_cache(pm, 3), jnp.asarray(TABLE),
                               jnp.zeros((3,), jnp.int32))

    @jax.jit
    def run(params, cache):
        outs = []
        for toks, kw in ((PREFILL, dict(prefill=True,
                                        seq_lengths=PREFILL_LENS)),
                         (EXTEND, dict(extend=True,
                                       seq_lengths=EXTEND_LENS))):
            logits, upd = pm.apply({"params": params, "cache": cache},
                                   jnp.asarray(toks), mutable=["cache"],
                                   **kw)
            cache = upd["cache"]
            outs.append(logits)
        dec = []
        for s in range(DECODE.shape[1]):
            logits, upd = pm.apply({"params": params, "cache": cache},
                                   jnp.asarray(DECODE[:, s:s + 1]),
                                   decode=True, mutable=["cache"])
            cache = upd["cache"]
            dec.append(logits[:, 0])
        pages, ci = ref_kv.split_cache(cache)
        return (*outs, jnp.stack(dec, 1), ci,
                pages["layer_0"]["attn"]["pages_k"])

    return [np.asarray(x) for x in run(params, cache)]


def _port_paged(model):
    cfg = model.cfg
    cache = port_kv.paged_cache(cfg.n_layers, NUM_BLOCKS, PS, cfg.kv_heads,
                                cfg.head_dim, cfg.dtype, "cpu", TABLE)
    with torch.no_grad():
        pre = model(torch.from_numpy(PREFILL), cache=cache, prefill=True,
                    seq_lengths=torch.from_numpy(PREFILL_LENS))
        ext = model(torch.from_numpy(EXTEND), cache=cache, extend=True,
                    seq_lengths=torch.from_numpy(EXTEND_LENS))
        dec = [model(torch.from_numpy(DECODE[:, s:s + 1]), cache=cache,
                     decode=True)[:, 0] for s in range(DECODE.shape[1])]
    return (pre.numpy(), ext.numpy(), torch.stack(dec, 1).numpy(),
            cache.index.numpy(), cache.pages_k[0].numpy())


@pytest.fixture(scope="module")
def paged_both(models):
    module, params, model = models
    return _jax_paged(module, params), _port_paged(model)


def test_paged_prefill_and_extend_logits_match_reference(paged_both):
    (jp, je, _, _, _), (tp, te, _, _, _) = paged_both
    for want, got, lens in ((jp, tp, PREFILL_LENS), (je, te, EXTEND_LENS)):
        for b, n in enumerate(lens):  # pad positions are never read
            if n:
                assert_logits_close(got[b, :n], want[b, :n])


def test_paged_decode_logits_and_pages_match_reference(paged_both):
    (_, _, jd, jci, jpages), (_, _, td, tci, tpages) = paged_both
    assert_logits_close(td, jd)
    want_index = PREFILL_LENS + EXTEND_LENS + DECODE.shape[1]
    assert tci.tolist() == jci.tolist() == want_index.tolist()
    # Every real page holds the same keys; the port's extra page is its
    # scratch page.
    assert tpages.shape[0] == jpages.shape[0] + 1
    np.testing.assert_allclose(tpages[:NUM_BLOCKS], jpages, rtol=1e-5,
                               atol=1e-5 * np.abs(jpages).max())


def test_padding_row_writes_only_the_scratch_page(models):
    """A ragged extend must not write past a row's valid length: the pool
    is shared. Row 1 is pure padding, so its page stays zero, and of the
    pages only row 0's and the scratch page change (the reference's
    ``test_block_table_write_padding_drops``)."""
    _, _, model = models
    cfg = model.cfg
    cache = port_kv.paged_cache(cfg.n_layers, 8, PS, cfg.kv_heads,
                                cfg.head_dim, cfg.dtype, "cpu",
                                np.array([[0], [1]], np.int32))
    with torch.no_grad():
        model(torch.tensor([[5, 9, 11], [7, 7, 7]], dtype=torch.int32),
              cache=cache, extend=True,
              seq_lengths=torch.tensor([3, 0], dtype=torch.int32))
    assert cache.index.tolist() == [3, 0]
    for pages in cache.pages_k + cache.pages_v:
        changed = pages.flatten(1).abs().sum(1).nonzero().flatten().tolist()
        assert changed == [0, 8]  # row 0's page and the scratch page
        assert pages[0, :3].abs().sum() > 0 and not pages[0, 3:].any()


def test_monolithic_extend_matches_reference(models):
    """``extend`` over the monolithic cache: per-row writes at the index
    and the shifted-causal mask over max_seq_len, against the reference's
    after one prefill."""
    module, params, model = models
    prompt, lens = PREFILL, PREFILL_LENS
    ext = EXTEND

    @jax.jit
    def run(params, cache):
        _, upd = module.apply({"params": params, "cache": cache},
                              jnp.asarray(prompt), prefill=True,
                              mutable=["cache"], seq_lengths=jnp.asarray(lens))
        logits, upd = module.apply({"params": params, "cache": upd["cache"]},
                                   jnp.asarray(ext), extend=True,
                                   mutable=["cache"])
        return logits

    want = np.asarray(run(params, jax_cache(module, 3)))
    cache = init_cache(model, 3)
    assert isinstance(cache, KVCache)
    with torch.no_grad():
        model(torch.from_numpy(prompt), cache=cache, prefill=True,
              seq_lengths=torch.from_numpy(lens))
        got = model(torch.from_numpy(ext), cache=cache, extend=True)
    assert cache.index.tolist() == (lens + ext.shape[1]).tolist()
    assert_logits_close(got.numpy(), want)


def test_paged_generate_matches_monolithic_and_reference(models):
    """``generate`` over a paged cache (the static engine's dense
    row-major tables) gives the monolithic cache's greedy tokens, which
    are the reference's."""
    module, params, model = models
    prompts = np.array([[5, 9, 11, 3], [7, 3, 2, 1]], np.int32)
    lengths = np.array([4, 2], np.int32)
    want = np.asarray(jax_generate(module, params, jnp.asarray(prompts), 10,
                                   prompt_lengths=jnp.asarray(lengths)))
    mono = generate(model, torch.from_numpy(prompts), 10,
                    prompt_lengths=torch.from_numpy(lengths))
    cache = init_cache(model, 2, block_size=8)
    assert isinstance(cache, port_kv.PagedKVCache)
    assert cache.table.tolist() == port_kv.sequential_table(
        2, MAX_SEQ // 8, 2 * MAX_SEQ // 8).tolist()
    paged = generate(model, torch.from_numpy(prompts), 10,
                     prompt_lengths=torch.from_numpy(lengths), cache=cache)
    np.testing.assert_array_equal(mono.numpy(), want)
    np.testing.assert_array_equal(paged.numpy(), want)
