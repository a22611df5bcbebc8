"""The port's prefix cache (``EngineConfig(prefix_cache=True)`` over the
ragged paged engine) on LLAMA_TINY with f32 weights, once on f32 pools
and once on int8 pools.

Correctness: with greedy sampling a cache-on engine emits exactly the
tokens of the port's cache-off engine and of the JAX engine with
``prefix_cache=True`` (same weights through the numpy bridge), across a
partial hit, an exact full-prompt hit (the copy-on-write split),
eviction under page pressure, and a request that follows a cancelled
one.  Accounting: after every terminal path each physical page is in
exactly one of free list / prefix index / slot-owned, and a cancelled
request donates nothing.

The port's ``serve/prefix_index.py`` is a copy of the JAX package's: the
same call sequence gives the same pages, stats and summaries."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import llm_engine as jeng
from ray_tpu.serve import prefix_index as jpi
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import llm_engine as teng
from ray_tpu_torch.serve import prefix_index as tpi

PAGE = 16
BASE = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
            page_size=PAGE, ragged_batching=True, token_budget=36,
            prefix_cache=True)
TIGHT = dict(BASE, max_slots=2, num_pages=10)
NEW = 6


def _cfgs(pool):
    int8 = pool == "int8"
    return (dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32,
                                kv_int8=int8),
            dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32,
                                kv_int8=int8))


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0),
                        dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32))
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _scripts():
    """Request sequences, submitted one after the other.  ``hit`` is the
    prefix-cache hit each request must report."""
    rng = np.random.default_rng(3)
    tok = lambda n: rng.integers(1, 255, size=n).tolist()  # noqa: E731
    shared = tok(2 * PAGE)
    partial = [shared + tok(7) for _ in range(3)]
    aligned = tok(2 * PAGE)
    cow = [aligned, aligned, aligned + [9, 9, 9], aligned[:PAGE] + tok(5)]
    evict = [tok(2 * PAGE + 3) for _ in range(6)]
    head = tok(2 * PAGE)
    return {
        "partial": (BASE, partial, [0, 2 * PAGE, 2 * PAGE]),
        "cow": (BASE, cow, [0, 2 * PAGE - 1, 2 * PAGE, PAGE]),
        "evict": (TIGHT, evict + evict, None),
        # The middle request is cancelled by the port tests; the JAX run
        # and the cache-off run serve it to its end, which changes
        # nothing for its neighbours' tokens.
        "cancel": (BASE, [head + [5, 6, 7], head + [8, 9],
                          head + [8, 9, 4, 4]], [0, 2 * PAGE, 2 * PAGE]),
    }


_JAX_WANTS = {}


def _jax_wants(jp, pool, name):
    """The JAX engine's streams for one script (prefix_cache=True),
    computed once per pool type and engine configuration."""
    kw, prompts, _ = _scripts()[name]
    key = (pool, name)
    if key not in _JAX_WANTS:
        names = [n for n, (k, _p, _h) in _scripts().items() if k is kw]
        j_cfg, _ = _cfgs(pool)
        eng = jeng.LLMEngine(jp, jeng.llama_paged_adapter(j_cfg),
                             jeng.EngineConfig(**kw))
        try:
            for n in names:
                _JAX_WANTS[(pool, n)] = [
                    eng.generate(p, max_new_tokens=NEW)
                    for p in _scripts()[n][1]]
        finally:
            eng.shutdown()
    return _JAX_WANTS[key]


def _engine(tp, pool, kw):
    _, t_cfg = _cfgs(pool)
    return teng.LLMEngine(tp, teng.llama_paged_adapter(t_cfg),
                          teng.EngineConfig(**kw), device="cpu")


def _assert_pool_consistent(eng):
    """Every physical page in exactly one of free / cached / slot-owned;
    borrowed = cached pages a slot additionally maps; no duplicates."""
    free = list(eng._free_pages)
    assert len(free) == len(set(free)), "duplicate pages on free list"
    free = set(free)
    cached = eng._prefix.pages()
    owned, borrowed = set(), set()
    for slot, pages in eng._slot_pages.items():
        b = eng._slot_borrowed.get(slot, [])
        assert pages[:len(b)] == b
        borrowed |= set(b)
        tail = pages[len(b):]
        assert not owned & set(tail), "page owned by two slots"
        owned |= set(tail)
    assert borrowed <= cached, "borrowed page not owned by the index"
    assert not free & cached and not free & owned and not cached & owned
    assert len(free) + len(cached) + len(owned) == eng._num_pages


def _settle(eng, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if (len(eng._free_slots) == eng.config.max_slots
                and eng._waiting.empty() and not eng._prefilling
                and not eng._backlog and not eng._pending):
            return
        time.sleep(0.005)
    raise TimeoutError("engine never went quiescent")


@pytest.mark.parametrize("name", ["partial", "cow", "evict", "cancel"])
@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_cache_on_equals_cache_off_equals_jax(params, pool, name):
    jp, tp = params
    kw, prompts, hits = _scripts()[name]
    want = _jax_wants(jp, pool, name)
    off = _engine(tp, pool, dict(kw, prefix_cache=False))
    try:
        got_off = [off.generate(p, max_new_tokens=NEW) for p in prompts]
        assert "prefix" not in off.stats() and off.prefix_summary() is None
    finally:
        off.shutdown()
    eng = _engine(tp, pool, kw)
    try:
        got, reqs = [], []
        for i, p in enumerate(prompts):
            if name == "cancel" and i == 1:
                # Cancel after the first token proves the borrow happened;
                # the stream still ends with what it had.
                held = eng._prefix.cached_pages
                s = eng.submit(p, max_new_tokens=90)
                first = next(iter(s))
                s.cancel()
                s.result(timeout_s=120)
                _settle(eng)
                _assert_pool_consistent(eng)
                assert eng._prefix.stats()["borrowed_refs"] == 0
                assert eng._prefix.cached_pages == held   # donated nothing
                assert first == want[i][0]
                got.append(want[i])       # the rest was not served here
                reqs.append(s._req)
                continue
            s = eng.submit(p, max_new_tokens=NEW)
            got.append(s.result(timeout_s=120))
            reqs.append(s._req)
        st = eng.stats()
        _settle(eng)
        _assert_pool_consistent(eng)
        if kw is TIGHT:
            assert len(eng._free_pages) + eng._prefix.cached_pages \
                == eng._num_pages
    finally:
        eng.shutdown()
    assert got == got_off
    assert got == want
    if hits is not None:
        assert [r.prefix_hit for r in reqs] == hits
        assert st["prefix"]["hit_tokens"] == sum(hits)
        assert st["prefix"]["prompt_tokens"] == sum(len(p) for p in prompts)
    assert st["kv_pages_cached"] == st["prefix"]["cached_pages"] > 0
    assert st["prefix"]["borrowed_refs"] == 0
    if name == "evict":
        assert st["prefix"]["evicted_pages"] > 0
        assert st["prefix"]["inserted_pages"] > st["prefix"]["cached_pages"]
    if name == "cow":
        # The copy kept the shared page intact: the third request
        # borrowed both pages again and still decoded exactly.
        assert reqs[2].prefix_hit == 2 * PAGE


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_cow_split_copies_page_and_scales(params, pool):
    """An exact full-prompt hit re-runs the last token inside a COPY of
    the deepest shared page: the cached original keeps its bytes (and,
    on int8 pools, its scales), and the copy is not borrowed."""
    _, tp = params
    rng = np.random.default_rng(8)
    prompt = rng.integers(1, 255, size=2 * PAGE).tolist()
    eng = _engine(tp, pool, BASE)
    try:
        eng.generate(prompt, max_new_tokens=NEW)
        _settle(eng)
        cached = eng._prefix.acquire(prompt)
        eng._prefix.release(cached)
        assert len(cached) == 2
        before = {k: v[:, :, cached].clone() if k in ("k", "v")
                  else v[:, cached].clone() for k, v in eng._cache.items()}
        s = eng.submit(prompt, max_new_tokens=40)
        first = next(iter(s))
        slot = next(iter(eng._slot_pages))
        pages, borrowed = eng._slot_pages[slot], eng._slot_borrowed[slot]
        assert borrowed == cached[:1] and pages[0] == cached[0]
        assert pages[1] not in cached          # the copy, slot-owned
        s.cancel()
        s.result(timeout_s=120)
        _settle(eng)
        after = {k: v[:, :, cached] if k in ("k", "v") else v[:, cached]
                 for k, v in eng._cache.items()}
        for key in before:
            assert torch.equal(before[key], after[key]), key
        assert (pool == "int8") == ("k_scale" in before)
        assert isinstance(first, int)
        _assert_pool_consistent(eng)
    finally:
        eng.shutdown()


def test_prefix_cache_configuration_errors(params):
    _, tp = params
    _, t_cfg = _cfgs("f32")
    with pytest.raises(ValueError, match="ragged_batching"):
        teng.LLMEngine(tp, teng.llama_paged_adapter(t_cfg),
                       teng.EngineConfig(**dict(BASE, ragged_batching=False)),
                       device="cpu")
    bare = dataclasses.replace(teng.llama_paged_adapter(t_cfg),
                               copy_page=None)
    with pytest.raises(ValueError, match="copy_page"):
        teng.LLMEngine(tp, bare, teng.EngineConfig(**BASE), device="cpu")


# -- the index itself --------------------------------------------------------

def _drive(mod, script):
    idx = mod.PrefixIndex(4)
    out = []
    for op, *args in script:
        try:
            res = getattr(idx, op)(*args)
        except RuntimeError as e:
            res = ("raised", str(e))
        out.append(sorted(res) if isinstance(res, set) else res)
        out.append((idx.cached_pages, idx.stats(), idx.summary(),
                    sorted(idx.leased_pages())))
    out.append(idx.audit_snapshot())
    out.append(idx.hot_paths(8))
    return out


_A = list(range(1, 13))
_SCRIPTS = {
    "borrow_evict": [
        ("acquire", _A), ("insert", _A, [10, 11, 12]),
        ("acquire", _A[:8] + [99] * 4), ("refcount", 10), ("evict", 3),
        ("release", [10, 11]), ("evict", 3), ("release", [10]),
        ("insert", _A, [20, 21]), ("insert", _A, [30, 31, 32])],
    "leases": [
        ("insert", _A, [1, 2, 3]), ("lease_acquire", _A[:8]),
        ("evict", 3), ("lease_release", [1, 2]), ("lease_release", [1]),
        ("evict", 3)],
    "branches": [
        ("insert", _A, [1, 2, 3]), ("insert", _A[:4] + [7] * 8, [4, 5, 6]),
        ("acquire", _A[:4] + [7] * 4 + [8] * 4), ("evict", 1),
        ("release", [1, 5]), ("evict", 2), ("pages",)],
}


@pytest.mark.parametrize("name", sorted(_SCRIPTS))
def test_prefix_index_copy_matches_original(name):
    assert _drive(tpi, _SCRIPTS[name]) == _drive(jpi, _SCRIPTS[name])


def test_prefix_hashes_and_match_depth_match_original():
    idx_t, idx_j = tpi.PrefixIndex(4), jpi.PrefixIndex(4)
    shared = [7, 1, 5, 3, 2, 2, 4, 9]
    for idx in (idx_t, idx_j):
        idx.insert(shared + [8] * 4, [1, 2, 3])
    assert idx_t.summary() == idx_j.summary()
    s = idx_t.summary()
    for prompt in (shared + [50, 60], shared + [8] * 4 + [1], [9] * 4):
        assert tpi.match_depth(prompt, s) == jpi.match_depth(prompt, s)
        assert tpi.prefix_hashes(prompt, 4) == jpi.prefix_hashes(prompt, 4)
    assert tpi.match_depth(shared, None) == 0
