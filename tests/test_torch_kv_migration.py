"""KV page migration in the port (``serve/kv_transfer.py`` and the
engine's lease / export / ingest / release verbs) against the JAX
package's, on LLAMA_TINY with f32 weights shared through the numpy
bridge.

Wire format: the port's `encode_pages` and `decode_payload` equal the JAX
package's on the same numpy pages (f32 and bf16 sources, exact and int8
modes, float and int8 destination pools); int8 bytes and scales bit for
bit, bf16 exactly through the port's f32 carrier.  A transfer made by one
package decodes in the other, and an engine of one package ingesting a
transfer of the other serves the stream the exporting engine serves.

The engine verbs port ``tests/test_disagg_serving.py``'s contracts:
leased pages survive eviction and cancel mid-migration, a cold engine
admits a migrated prefix as a hit over the migrated pages with no
recompute, a content mismatch never touches the pool, every lease is
released on drain and on stop, and the pool partition
free ∪ cached ∪ slot-owned (leased ⊆ cached) holds throughout.  One JAX
engine runs in this file."""

import dataclasses
import pickle
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import kv_transfer as jkvt
from ray_tpu.serve import llm_engine as jeng
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import kv_transfer as kvt
from ray_tpu_torch.serve import llm_engine as teng

PAGE = 16
NEW = 6
BASE = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
            page_size=PAGE, ragged_batching=True, token_budget=36,
            prefix_cache=True)
J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
T_CFG8 = dataclasses.replace(T_CFG, kv_int8=True)


@pytest.fixture(scope="module")
def params():
    """The port's seeded init, copied to JAX arrays through the bridge
    (no JAX random program to compile)."""
    tp = tl.init_params(torch.Generator().manual_seed(0), T_CFG, device="cpu")
    jp = jax.tree.map(jnp.asarray, bridge.params_to_numpy(tp))
    return jp, tp


def _engine(tp, cfg=T_CFG, **kw):
    return teng.LLMEngine(tp, teng.llama_paged_adapter(cfg),
                          teng.EngineConfig(**dict(BASE, **kw)),
                          device="cpu")


def _tokens(seed, n):
    return np.random.default_rng(seed).integers(1, 255, size=n).tolist()


def _assert_pool_consistent(eng):
    """Every physical page in exactly one of free / cached / slot-owned,
    borrowed ⊆ cached, and leased ⊆ cached (a lease pins, it does not
    own)."""
    free = list(eng._free_pages)
    assert len(free) == len(set(free)), "duplicate pages on free list"
    free = set(free)
    cached = eng._prefix.pages()
    owned = set()
    for slot, pages in eng._slot_pages.items():
        b = eng._slot_borrowed.get(slot, [])
        assert set(b) <= cached, "borrowed page not owned by the index"
        tail = pages[len(b):]
        assert not owned & set(tail), "page owned by two slots"
        owned |= set(tail)
    assert eng._prefix.leased_pages() <= cached
    assert not free & cached and not free & owned and not cached & owned
    assert len(free) + len(cached) + len(owned) == eng._num_pages


# -- the wire format --------------------------------------------------------

def _pages(src, seed=0, n=3, L=2, KVH=2, D=8):
    """Gathered pages of one source pool as the JAX engine's device_get
    gives them: f32, bf16 (ml_dtypes) or int8 with page-major scales."""
    rng = np.random.default_rng(seed)
    shape = (L, KVH, n, PAGE, D)
    if src == "int8":
        out = {k: rng.integers(-127, 128, size=shape).astype(np.int8)
               for k in ("k", "v")}
        for k in ("k_scale", "v_scale"):
            out[k] = rng.uniform(1e-3, 1e-1, size=(L, n, KVH, 1)
                                 ).astype(np.float32)
        return out
    dt = np.float32 if src == "f32" else ml_dtypes.bfloat16
    return {k: (rng.standard_normal(shape) * 3).astype(dt)
            for k in ("k", "v")}


def _f32(x):
    return np.asarray(x, np.float32)


SOURCES = ("f32", "bf16", "int8")


@pytest.mark.parametrize("mode", ["exact", "int8"])
@pytest.mark.parametrize("src", SOURCES)
def test_encode_pages_matches_jax(src, mode):
    """Same pages, same transfer: every field, int8 bytes and scales bit
    for bit, bf16 values exactly (the port's carrier is f32)."""
    g = _pages(src)
    toks = _tokens(1, 3 * PAGE)
    want = jkvt.encode_pages(g, tokens=toks, page_size=PAGE, mode=mode)
    got = kvt.encode_pages(g, tokens=toks, page_size=PAGE, mode=mode)
    assert set(got) == set(want)
    for key in ("version", "page_size", "tokens", "hashes", "src_dtype",
                "mode", "wire_bytes"):
        assert got[key] == want[key], key
    for key in ("k", "v", "k_scale", "v_scale"):
        if key not in want:
            continue
        if want[key].dtype == np.int8 or key.endswith("scale"):
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes(), key
        else:
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], _f32(want[key]))
    if src == "bf16" and mode == "exact":
        # The port widened bf16 to f32 and counts 2 bytes an element.
        assert got["src_dtype"] == "bfloat16"
        assert got["wire_bytes"] == 2 * got["k"].size * 2


@pytest.mark.parametrize("dest", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["exact", "int8"])
@pytest.mark.parametrize("src", SOURCES)
def test_decode_payload_matches_jax(src, mode, dest):
    """Each source x mode x destination pool: the port's decoded pages
    (host tensors in the pool's dtype) equal the JAX decoder's arrays,
    and a slice [1, 3) equals the same pages of the whole decode."""
    g = _pages(src, seed=2)
    toks = _tokens(3, 3 * PAGE)
    transfer = jkvt.encode_pages(g, tokens=toks, page_size=PAGE, mode=mode)
    quant = dest == "int8"
    j_dt = {"f32": np.float32, "bf16": jnp.bfloat16, "int8": np.int8}[dest]
    t_dt = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[dest]
    for lo, hi in ((0, None), (1, 3)):
        want = jkvt.decode_payload(transfer, quant, j_dt, lo, hi)
        got = kvt.decode_payload(transfer, quant, t_dt, lo, hi)
        assert set(got) == set(want)
        for key, w in want.items():
            t = got[key]
            if quant:
                assert t.dtype == (torch.int8 if key in ("k", "v")
                                   else torch.float32)
                assert t.numpy().tobytes() == np.asarray(w).tobytes(), key
            else:
                assert t.dtype == t_dt
                np.testing.assert_array_equal(t.float().numpy(), _f32(w))


@pytest.mark.parametrize("dest", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_port_transfer_decodes_in_jax_and_back(mode, dest):
    """A bf16 pool's pages encoded by the port decode in the JAX package
    as the port decodes them; exact mode returns the bf16 bits."""
    g = _pages("bf16", seed=4)
    toks = _tokens(5, 3 * PAGE)
    carrier = {k: _f32(v) for k, v in g.items()}  # the engine's gather
    port = kvt.encode_pages(carrier, tokens=toks, page_size=PAGE, mode=mode,
                            src_dtype="bfloat16")
    jax_side = jkvt.encode_pages(g, tokens=toks, page_size=PAGE, mode=mode)
    assert port["wire_bytes"] == jax_side["wire_bytes"]
    jkvt.verify_transfer(port)
    kvt.verify_transfer(jax_side)
    quant = dest == "int8"
    j_dt = {"f32": np.float32, "bf16": jnp.bfloat16, "int8": np.int8}[dest]
    t_dt = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[dest]
    j_dec = jkvt.decode_payload(port, quant, j_dt)
    t_dec = kvt.decode_payload(jax_side, quant, t_dt)
    for key in j_dec:
        assert np.asarray(j_dec[key]).tobytes() == \
            np.asarray(jkvt.decode_payload(jax_side, quant, j_dt)[key]
                       ).tobytes(), key
        np.testing.assert_array_equal(t_dec[key].float().numpy(),
                                      _f32(j_dec[key]))
    if mode == "exact" and dest == "bf16":
        for key in ("k", "v"):
            assert np.asarray(j_dec[key]).tobytes() == g[key].tobytes()


def test_verify_rejects_mismatch_and_handoff_pickles():
    g = _pages("f32")
    toks = _tokens(6, 3 * PAGE)
    t = kvt.encode_pages(g, tokens=toks, page_size=PAGE, mode="exact")
    assert kvt.verify_transfer(t) == jkvt.verify_transfer(t)
    bad = dict(t, tokens=[toks[0] ^ 1] + toks[1:])
    with pytest.raises(ValueError, match="content-identity"):
        kvt.verify_transfer(bad)
    with pytest.raises(ValueError, match="'int8' or 'exact'"):
        kvt.encode_pages(g, tokens=toks, page_size=PAGE, mode="fp4")
    h = kvt.MigrationHandoff("handed off", {"tokens": [1, 2]}, "replica-7")
    back = pickle.loads(pickle.dumps(h))
    assert isinstance(back, kvt.PreemptedError)
    assert (back.reason, back.continuation, back.target_replica_id) == \
        ("handed off", {"tokens": [1, 2]}, "replica-7")
    kvt.set_disagg(kvt.DisaggContext(role="decode"))
    try:
        assert kvt.current_disagg().role == "decode"
    finally:
        kvt.set_disagg(None)
    assert kvt.page_transfer_wire_bytes(3, 100, quantized=True,
                                        scales_per_page=4) == 3 * 116


def test_hot_paths_distinct_ships_each_path_once():
    """``hot_paths()`` is the JAX index's (a path stamped at once comes
    back once a depth); ``distinct=True``, which the engine's export
    uses, visits deepest first and returns each path once."""
    from ray_tpu.serve import prefix_index as jpi
    from ray_tpu_torch.serve import prefix_index as tpi

    a, b = list(range(1, 13)), list(range(1, 5)) + [7] * 8
    idx, jidx = tpi.PrefixIndex(4), jpi.PrefixIndex(4)
    for i in (idx, jidx):
        i.insert(a, [1, 2, 3])
        i.insert(b, [1, 5, 6])
    assert idx.hot_paths() == jidx.hot_paths()
    assert [p["pages"] for p in idx.hot_paths()] == \
        [[1], [1, 5], [1, 5, 6], [1, 2], [1, 2, 3]]
    assert [p["pages"] for p in idx.hot_paths(distinct=True)] == \
        [[1, 5, 6], [1, 2, 3]]
    assert [p["pages"] for p in idx.hot_paths(4, distinct=True)] == \
        [[1, 5, 6]]


# -- the engine verbs -------------------------------------------------------

def test_lease_pins_against_eviction_with_cancel(params):
    """Leased pages survive eviction waves and a cancel of a stream that
    borrows them; the export stays content-correct; after release they
    evict normally; the pool partition holds throughout."""
    _jp, tp = params
    hot = _tokens(11, 2 * PAGE)
    eng = _engine(tp, max_slots=2, num_pages=12)
    try:
        first = eng.generate(hot, max_new_tokens=4)
        lease = eng.migration_lease(hot + first)
        n_leased = (len(hot) + 4 - 1) // PAGE
        assert len(lease["pages"]) == n_leased
        assert lease["tokens"] == (hot + first)[:n_leased * PAGE]
        _assert_pool_consistent(eng)
        s = eng.submit(hot + [9, 9], max_new_tokens=20)
        for _tok in s:
            break
        assert s._req.prefix_hit == 2 * PAGE
        s.cancel()
        s.result(timeout_s=60)
        rng = np.random.default_rng(12)
        for _ in range(6):
            eng.generate(rng.integers(1, 255, size=2 * PAGE + 3).tolist(),
                         max_new_tokens=4)
        assert eng.stats()["prefix"]["evicted_pages"] > 0
        assert eng._prefix.leased_pages() == set(lease["pages"])
        _assert_pool_consistent(eng)
        assert eng.doctor(deep=True)["violations"] == 0
        transfer = eng.migration_export(lease["lease_id"], mode="exact")
        kvt.verify_transfer(transfer)
        assert transfer["tokens"] == lease["tokens"]
        assert transfer["src_dtype"] == "float32"
        assert eng.migration_release(lease["lease_id"]) is True
        assert eng.migration_release(lease["lease_id"]) is False
        assert eng._prefix.leased_pages() == set()
        with pytest.raises(KeyError, match="unknown migration lease"):
            eng.migration_export(lease["lease_id"])
        assert eng.migration_lease(_tokens(13, PAGE - 1)) is None
        evicted = eng._prefix.evict(eng._num_pages)
        assert set(lease["pages"]) <= set(evicted)
        eng._free_pages.extend(evicted)
        _assert_pool_consistent(eng)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("pools", ["f32-f32", "f32-int8", "int8-int8"])
@pytest.mark.parametrize("mode", ["exact", "int8"])
def test_cold_engine_admits_migrated_prefix(params, pools, mode):
    """Hot prefixes of a warm engine, ingested by a cold one, are a
    prefix hit over exactly the migrated pages; an exact transfer between
    f32 pools and any transfer between int8 pools (raw bytes, no
    requantisation) serve the warm engine's stream."""
    _jp, tp = params
    src, dst = (T_CFG8 if p == "int8" else T_CFG for p in pools.split("-"))
    prompt = _tokens(21, 2 * PAGE + 5)
    warm, cold = _engine(tp, src), _engine(tp, dst)
    try:
        out = warm.generate(prompt, max_new_tokens=12)
        cached = warm._prefix.cached_pages
        assert cached == (len(prompt) + 12 - 1) // PAGE
        transfers = warm.export_hot_prefixes(mode=mode)
        assert [len(t["hashes"]) for t in transfers] == [cached]
        assert warm.stats()["kv_migration"]["pages_out"] >= cached
        assert warm._prefix.leased_pages() == set()
        ingested = sum(cold.migration_ingest(t) for t in transfers)
        assert ingested == cached
        st = cold.stats()
        assert st["kv_migration"]["pages_in"] == cached
        assert st["kv_migration"]["bytes_in"] == sum(
            t["wire_bytes"] for t in transfers)
        assert cold.migration_ingest(transfers[0]) == 0  # all cached
        if pools == "int8-int8":
            # Raw bytes and scales, no requantisation.
            path = max(transfers, key=lambda t: len(t["hashes"]))
            w_pages = warm._prefix.acquire(path["tokens"])
            c_pages = cold._prefix.acquire(path["tokens"])
            try:
                for key, ax in (("k", 2), ("v", 2), ("k_scale", 1),
                                ("v_scale", 1)):
                    a = warm._cache[key].index_select(
                        ax, torch.tensor(w_pages))
                    b = cold._cache[key].index_select(
                        ax, torch.tensor(c_pages))
                    assert torch.equal(a, b), key
            finally:
                warm._prefix.release(w_pages)
                cold._prefix.release(c_pages)
        probe = (prompt + out)[:cached * PAGE] + [7, 7, 7]
        s = cold.submit(probe, max_new_tokens=NEW)
        got = s.result(timeout_s=60)
        assert s._req.prefix_hit == cached * PAGE
        want = warm.generate(probe, max_new_tokens=NEW)
        if mode == "exact" or pools == "int8-int8":
            assert got == want
        _assert_pool_consistent(cold)
        for eng in (warm, cold):
            assert eng.doctor(deep=True)["violations"] == 0
    finally:
        warm.shutdown()
        cold.shutdown()


def test_content_mismatch_never_touches_pool(params):
    _jp, tp = params
    prompt = _tokens(31, 2 * PAGE)
    warm, cold = _engine(tp), _engine(tp)
    try:
        warm.generate(prompt, max_new_tokens=4)
        transfer = max(warm.export_hot_prefixes(mode="int8"),
                       key=lambda t: len(t["hashes"]))
        bad = dict(transfer, tokens=list(transfer["tokens"]))
        bad["tokens"][0] ^= 1
        free = list(cold._free_pages)
        with pytest.raises(ValueError, match="content-identity"):
            cold.migration_ingest(bad)
        with pytest.raises(ValueError, match="page_size"):
            cold.migration_ingest(dict(transfer, page_size=PAGE * 2))
        assert cold.stats()["kv_migration"]["pages_in"] == 0
        assert cold._prefix.cached_pages == 0
        assert cold._free_pages == free
        assert cold.migration_ingest(transfer) == len(transfer["hashes"])
    finally:
        warm.shutdown()
        cold.shutdown()


def test_leases_released_on_drain_and_on_stop(params):
    """A lease left open across drain() is released before the drain's
    audit; one left open at stop is released before the final audit; a
    verb after stop raises at once."""
    _jp, tp = params
    prompt = _tokens(41, 2 * PAGE + 2)
    for how in ("drain", "stop"):
        eng = _engine(tp)
        eng.generate(prompt, max_new_tokens=4)
        lease = eng.migration_lease(prompt)
        assert eng._prefix.leased_pages() == set(lease["pages"])
        if how == "drain":
            eng.drain(grace_s=0.0)
            deadline = time.monotonic() + 10
            while eng._mig_leases and time.monotonic() < deadline:
                time.sleep(0.01)
            report = eng.doctor(deep=True)
            eng.shutdown()
        else:
            eng.shutdown()
            report = eng.doctor(deep=True)
        assert eng._mig_leases == {}
        assert eng._prefix.leased_pages() == set()
        assert report["violations"] == 0, report
        assert "kv.lease_accounting" in {r["check"]
                                         for r in report["checks"]}
        _assert_pool_consistent(eng)
        with pytest.raises(RuntimeError, match="engine stopped"):
            eng.migration_release(lease["lease_id"])


def test_lease_accounting_audit_fires_on_corruption(params):
    _jp, tp = params
    prompt = _tokens(51, 2 * PAGE + 1)
    eng = _engine(tp)
    try:
        eng.generate(prompt, max_new_tokens=4)
        lease = eng.migration_lease(prompt)
        report = eng.doctor(deep=True)
        assert report["violations"] == 0
        # A lease the engine forgot: its pages stay pinned in the trie.
        eng._mig_leases.pop(lease["lease_id"])
        report = eng.doctor(deep=True)
        bad = [v for row in report["checks"] for v in row["violations"]]
        assert {v["check"] for v in bad} == {"kv.lease_accounting"}
        assert {v["subject"] for v in bad} == \
            {f"page-{p}" for p in lease["pages"]}
        eng._prefix.lease_release(lease["pages"])
        assert eng.doctor(deep=True)["violations"] == 0
        # A lease naming a page the trie does not hold.
        eng._mig_leases["ghost"] = {"pages": [eng._num_pages - 1],
                                    "tokens": []}
        if eng._num_pages - 1 in eng._prefix.pages():
            eng._mig_leases["ghost"]["pages"] = [eng._free_pages[0]]
        report = eng.doctor(deep=True)
        assert [v["actual"] for row in report["checks"]
                for v in row["violations"]] == ["missing from trie"]
        eng._mig_leases.pop("ghost")
    finally:
        eng.shutdown()


def test_migration_needs_the_prefix_cache(params):
    _jp, tp = params
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**dict(BASE, prefix_cache=False)),
                         device="cpu")
    try:
        with pytest.raises(RuntimeError, match="prefix_cache=True"):
            eng.migration_lease([1, 2, 3])
        assert "kv_migration" not in eng.stats()
    finally:
        eng.shutdown()


# -- across packages ----------------------------------------------------------

def test_transfers_cross_packages(params):
    """Port → JAX: the JAX engine ingests a port engine's exact export
    and serves the port warm engine's stream for a probe over it.  JAX →
    port: a port cold engine ingests the JAX engine's own hot prefixes
    and serves the JAX engine's stream.  Both through ``LLMServer``'s
    migration targets on the port side."""
    jp, tp = params
    p_port, p_jax = _tokens(61, 2 * PAGE + 3), _tokens(62, 3 * PAGE + 1)
    warm = teng.LLMServer(T_CFG, teng.EngineConfig(**BASE), lambda: tp,
                          adapter_factory=teng.llama_paged_adapter,
                          device="cpu")
    cold = teng.LLMServer(T_CFG, teng.EngineConfig(**BASE), lambda: tp,
                          adapter_factory=teng.llama_paged_adapter,
                          device="cpu")
    jax_eng = jeng.LLMEngine(jp, jeng.llama_paged_adapter(J_CFG),
                             jeng.EngineConfig(**BASE))
    try:
        out = warm({"tokens": p_port, "max_new_tokens": 10})["tokens"]
        to_jax = warm.export_hot_prefixes(mode="exact")
        n = warm.engine._prefix.cached_pages
        assert sum(jax_eng.migration_ingest(t) for t in to_jax) == n
        probe = (p_port + out)[:n * PAGE] + [5, 6]
        s = jax_eng.submit(probe, max_new_tokens=NEW, temperature=0.0)
        got_j = s.result(timeout_s=120)
        assert s._req.prefix_hit == n * PAGE
        assert got_j == warm({"tokens": probe,
                              "max_new_tokens": NEW})["tokens"]

        out_j = jax_eng.generate(p_jax, max_new_tokens=10, temperature=0.0)
        to_port = [t for t in jax_eng.export_hot_prefixes(mode="exact")
                   if t["tokens"][:PAGE] == p_jax[:PAGE]]
        m = (len(p_jax) + 10 - 1) // PAGE
        assert sum(cold.ingest_kv_transfer(t) for t in to_port) == m
        probe = (p_jax + out_j)[:m * PAGE] + [3]
        s = cold.engine.submit(probe, max_new_tokens=NEW)
        assert s.result(timeout_s=60) == jax_eng.generate(
            probe, max_new_tokens=NEW, temperature=0.0)
        assert s._req.prefix_hit == m * PAGE
        _assert_pool_consistent(cold.engine)
    finally:
        jax_eng.shutdown()
        warm.engine.shutdown()
        cold.engine.shutdown()
