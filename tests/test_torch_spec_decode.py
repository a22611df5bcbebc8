"""The port's speculative decoding on the ragged engine, LLAMA_TINY in f32
on the CPU: greedy streams with spec on (self-draft, and a wrong draft of
another depth that rejects almost every proposal) equal the port's
spec-off streams and the JAX engine's, token for token; only greedy
base-model rows speculate; rejected positions never become visible
through the prefix cache; the target and draft pools stay partitioned
through accept, reject, eviction and release; the cooldown engages.  On
int8 pools the verify step and the step that overwrites a rejected tail
are held against the JAX step.

Which rounds speculate depends on when fetches land, so streams are
compared, never round or acceptance counts across packages.  The JAX
engine (spec off: its spec-off output is its spec-on output by
construction) runs once for the module."""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import ragged_paged_attention as jrpa
from ray_tpu.serve import llm_engine as jeng
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import ragged_paged_attention as trpa
from ray_tpu_torch.serve import llm_engine as teng

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
# The wrong draft: same vocabulary, one layer, other weights.
DRAFT_CFG = dataclasses.replace(T_CFG, n_layers=1)
PAGE = 16
ENGINE = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
              page_size=PAGE, ragged_batching=True, token_budget=36)
# Model steps: f32 matmuls in another order (XLA vs ATen).
STEP_TOL = 1e-4


def _reqs(seed, lens, n):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 250, size=k).tolist(), n) for k in lens]


BASE_REQS = _reqs(3, (3, 7, 12, 5, 9, 4), 16)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    draft = tl.init_params(torch.Generator().manual_seed(7), DRAFT_CFG,
                           device="cpu")
    return jp, tp, draft


@pytest.fixture(scope="module")
def jax_streams(params):
    jp = params[0]
    eng = jeng.LLMEngine(jp, jeng.llama_paged_adapter(J_CFG),
                         jeng.EngineConfig(**ENGINE))
    try:
        streams = [eng.submit(p, max_new_tokens=n, temperature=0.0)
                   for p, n in BASE_REQS]
        return [s.result(timeout_s=300) for s in streams]
    finally:
        eng.shutdown()


def _engine(tp, *, spec, draft=None, cfg=T_CFG, **kw):
    return teng.LLMEngine(
        tp, teng.llama_paged_adapter(cfg),
        teng.EngineConfig(**{**ENGINE, "spec_decode": spec, **kw}),
        device="cpu", draft_params=draft,
        draft_adapter=teng.llama_paged_adapter(DRAFT_CFG) if draft else None)


def _serve(eng, reqs, one_by_one=False, temperature=0.0):
    try:
        if one_by_one:
            return [eng.submit(p, max_new_tokens=n, temperature=temperature)
                    .result(timeout_s=120) for p, n in reqs], eng.stats()
        streams = [eng.submit(p, max_new_tokens=n, temperature=temperature)
                   for p, n in reqs]
        return [s.result(timeout_s=120) for s in streams], eng.stats()
    finally:
        eng.shutdown()


def _settle(eng, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if (len(eng._free_slots) == eng.config.max_slots
                and eng._waiting.empty() and not eng._prefilling
                and not eng._backlog and not eng._pending):
            return
        time.sleep(0.005)
    raise TimeoutError("engine never went quiescent")


def _assert_pool_consistent(eng):
    """Every physical TARGET page in exactly one of free / cached /
    slot-owned, and the DRAFT pool partitioned into free and slot-owned
    (the JAX package's invariant, tests/test_spec_decode.py)."""
    free = list(eng._free_pages)
    assert len(free) == len(set(free)), "duplicate pages on free list"
    free = set(free)
    cached = eng._prefix.pages() if eng._prefix is not None else set()
    owned, borrowed = set(), set()
    for slot, pages in eng._slot_pages.items():
        b = eng._slot_borrowed.get(slot, []) if eng._prefix else []
        assert pages[:len(b)] == b
        borrowed |= set(pages[:len(b)])
        tail = pages[len(b):]
        assert not owned & set(tail), "page owned by two slots"
        owned |= set(tail)
    assert borrowed <= cached, "borrowed page not owned by the index"
    assert not free & cached and not free & owned and not cached & owned
    assert len(free) + len(cached) + len(owned) == eng._num_pages
    if eng._spec_on:
        dfree = list(eng._draft_free)
        assert len(dfree) == len(set(dfree)), "duplicate draft pages"
        downed = set()
        for pages in eng._draft_slot_pages.values():
            assert not downed & set(pages), "draft page owned twice"
            downed |= set(pages)
        assert not set(dfree) & downed
        assert len(dfree) + len(downed) == eng._draft_pages


@pytest.mark.parametrize("draft", ["self", "wrong"])
def test_spec_streams_match_spec_off_and_jax(params, jax_streams, draft):
    _, tp, wrong = params
    want, _ = _serve(_engine(tp, spec=False), BASE_REQS)
    assert want == jax_streams
    eng = _engine(tp, spec=True,
                  **({"draft": wrong, "spec_cold_accept": 0.0}
                     if draft == "wrong" else {}))
    got, st = _serve(eng, BASE_REQS)
    assert got == jax_streams
    sp = st["spec"]
    assert sp["rounds"] > 0 and sp["drafted_tokens"] > 0
    assert st["step_tokens"]["spec_verify"] > 0
    if draft == "self":
        assert sp["accept_ratio"] == 1.0
        assert (sp["accepted_tokens"] + sp["rounds"]) / sp["rounds"] > 1.0
    else:
        assert sp["accept_ratio"] < 0.5, "the wrong draft was accepted"
    _settle(eng)
    _assert_pool_consistent(eng)
    assert sorted(eng._draft_free) == list(range(eng._draft_pages))


def test_spec_mixed_temperatures_only_greedy_rows_speculate(params):
    _, tp, _ = params
    greedy = _reqs(4, (4, 8), 12)
    want, _ = _serve(_engine(tp, spec=False), greedy)
    eng = _engine(tp, spec=True)
    try:
        hot = eng.submit(list(range(1, 7)), max_new_tokens=12,
                         temperature=0.8)
        streams = [eng.submit(p, max_new_tokens=n) for p, n in greedy]
        assert [s.result(timeout_s=120) for s in streams] == want
        assert len(hot.result(timeout_s=120)) == 12
        assert hot._req.spec_drafted == 0
        assert all(s._req.spec_drafted > 0 for s in streams)
    finally:
        eng.shutdown()


def test_spec_prefix_cache_rollback_never_visible(params):
    """A wrong draft under the prefix cache: streams equal spec-off, the
    cache hits, and the pools stay partitioned, so no rejected position
    became a cached page."""
    _, tp, wrong = params
    rng = np.random.default_rng(5)
    shared = rng.integers(1, 250, size=2 * PAGE).tolist()
    reqs = [(shared + rng.integers(1, 250, size=3).tolist(), 12)
            for _ in range(4)]
    want, _ = _serve(_engine(tp, spec=False, prefix_cache=True), reqs[:1],
                     one_by_one=True)
    eng = _engine(tp, spec=True, draft=wrong, spec_cold_accept=0.0,
                  prefix_cache=True)
    try:
        assert eng.submit(reqs[0][0], max_new_tokens=12).result(
            timeout_s=120) == want[0]
        streams = [eng.submit(p, max_new_tokens=n) for p, n in reqs[1:]]
        got = [s.result(timeout_s=120) for s in streams]
        assert any(s._req.prefix_hit > 0 for s in streams)
        assert eng.stats()["spec"]["rounds"] > 0
        _settle(eng)
        _assert_pool_consistent(eng)
    finally:
        eng.shutdown()
    oracle, _ = _serve(_engine(tp, spec=False, prefix_cache=True), reqs,
                       one_by_one=True)
    assert got == oracle[1:]


def test_spec_rollback_under_eviction_pressure(params):
    """8 pages against about 3 per request: admission evicts cached
    pages for every newcomer while a wrong draft rejects; streams equal
    spec-off and both pools stay partitioned."""
    _, tp, wrong = params
    ekw = dict(prefix_cache=True, num_pages=8, max_slots=2)
    reqs = _reqs(6, (2 * PAGE + 3,) * 5, 8)
    want, _ = _serve(_engine(tp, spec=False, **ekw), reqs, one_by_one=True)
    eng = _engine(tp, spec=True, draft=wrong, spec_cold_accept=0.0, **ekw)
    got, st = _serve(eng, reqs, one_by_one=True)
    assert got == want
    assert st["spec"]["rounds"] > 0 and st["spec"]["accept_ratio"] < 0.5
    assert st["prefix"]["evicted_pages"] > 0
    _settle(eng)
    _assert_pool_consistent(eng)
    assert sorted(eng._draft_free) == list(range(eng._draft_pages))


def test_spec_cold_acceptance_cooldown_engages(params):
    _, tp, wrong = params
    reqs = _reqs(8, (5, 5), 14)
    want, _ = _serve(_engine(tp, spec=False), reqs, one_by_one=True)
    got, st = _serve(_engine(tp, spec=True, draft=wrong,
                             spec_cold_accept=0.3, spec_cooldown_rounds=8),
                     reqs, one_by_one=True)
    assert got == want
    assert st["spec"]["cooldowns"] > 0 and st["spec"]["rounds"] > 0


def test_spec_requires_ragged_batching(params):
    _, tp, _ = params
    with pytest.raises(ValueError, match="ragged"):
        teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                       teng.EngineConfig(max_slots=2, max_seq_len=64,
                                         page_size=PAGE, spec_decode=True),
                       device="cpu")


# ---------------------------------------------------------------------------
# int8 pools: the verify step and the rejected tail's rewrite vs JAX
# ---------------------------------------------------------------------------

def _assert_k6_equal(jout, tout):
    """K6's stored bytes and scales on every page but the scratch page:
    scales within 1 ulp (the JAX kernel's ``amax / 127.0`` is a product
    with the reciprocal on the CPU, the port divides), bytes equal where
    the scale is equal and within one step elsewhere."""
    for pools, a, b in ((0, jout[2], tout[2]), (1, jout[3], tout[3])):
        np.testing.assert_array_max_ulp(b[:, :-1], a[:, :-1], maxulp=1)
        same = (a == b)[:, :-1, :, 0].transpose(0, 2, 1)
        ja = jout[pools][:, :, :-1].astype(np.int32)
        tb = tout[pools][:, :, :-1].astype(np.int32)
        np.testing.assert_array_equal(tb[same], ja[same])
        assert np.abs(tb - ja).max() <= 1


def test_int8_verify_and_rewrite_steps_match_jax(params):
    """Slot 0 holds 14 tokens of an int8 pool; a verify row of 5 tokens
    at 14 crosses into its second page beside slot 1's decode row; two
    drafts are accepted and two rejected, so the next verify row starts
    at 17, inside the second page, and overwrites the rejected tail (the
    page is rewritten: its scales only grow).  All steps through both
    packages from one pool (the JAX side's, crossed each step; the JAX
    step jitted once, every step with the same verify width): logits,
    verify logits and pools
    within STEP_TOL (the fresh k/v differ by f32 matmul order, so a value
    at a rounding boundary may move one int8 step).  K6 alone on those
    rows and that state, fed the same k/v: bytes and scales equal
    (``_assert_k6_equal``)."""
    jp, tp, _ = params
    jcfg = dataclasses.replace(J_CFG, kv_int8=True)
    tcfg = dataclasses.replace(T_CFG, kv_int8=True)
    num_pages, T, R = 8, 40, 4
    rng = np.random.default_rng(9)
    bt = np.full((2, 3), num_pages, np.int32)
    bt[0], bt[1, :2] = [5, 2, 6], [1, 3]
    jc = jl.init_paged_cache(jcfg, num_pages, PAGE)
    prompt0 = rng.integers(1, 250, 14).tolist()
    prompt1 = rng.integers(1, 250, 20).tolist()

    jstep = jax.jit(jl.ragged_step_paged, static_argnums=(8,))

    def step(rows, logit_idx):
        nonlocal jc
        (htoks, _dm, _ts, tpos, rslot, rstart, rlen, roff
         ) = trpa.pack_ragged_batch(rows, T, R)
        args = (htoks, tpos, rslot, rstart, rlen, roff, bt,
                np.asarray(logit_idx, np.int32))
        tc = bridge.paged_cache_from_jax(jax.tree.map(np.asarray, jc),
                                         device="cpu")
        jout = jstep(jp, *(jnp.asarray(a) for a in args[:7]), jcfg, jc,
                     logit_idx=jnp.asarray(args[7]))
        tout = tl.ragged_step_paged(
            tp, *(torch.from_numpy(a) for a in args[:7]), tcfg, tc,
            logit_idx=torch.from_numpy(args[7]))
        live = rlen > 0
        np.testing.assert_allclose(tout[0].numpy()[live],
                                   np.asarray(jout[0])[live],
                                   rtol=STEP_TOL, atol=STEP_TOL)
        np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                                   rtol=STEP_TOL, atol=STEP_TOL)
        jnew = jout[-1]
        for key in ("k", "v"):
            a = np.asarray(jnew[key])[:, :, :num_pages].astype(np.int32)
            b = tc[key].numpy()[:, :, :num_pages].astype(np.int32)
            assert np.abs(a - b).max() <= 1 and (a != b).mean() < 0.01
        for key in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tc[key].numpy()[:, :num_pages],
                                       np.asarray(jnew[key])[:, :num_pages],
                                       rtol=STEP_TOL, atol=1e-9)
        jc = jnew
        return (rslot, rstart, rlen, roff)

    step([dict(slot=0, start=0, tokens=prompt0),
          dict(slot=1, start=0, tokens=prompt1)], [13, 33, 0, 0, 0, 0, 0])
    # Verify row: the true last token and four drafts at 14..18.
    before = jax.tree.map(np.asarray, jc)
    rows = step([dict(slot=0, start=14, tokens=rng.integers(1, 250, 5)
                      .tolist()),
                 dict(slot=1, start=20, tokens=[7])],
                logit_idx=[0, 1, 2, 3, 4, 0, 0])
    # Two drafts accepted: the length rewinds to 14 + 1 + 2 = 17, and
    # the next verify row overwrites the rejected positions 17 and 18.
    after_verify = jax.tree.map(np.asarray, jc)
    rows2 = step([dict(slot=0, start=17, tokens=rng.integers(1, 250, 4)
                       .tolist()),
                  dict(slot=1, start=21, tokens=[9])],
                 logit_idx=[0, 1, 2, 3, 0, 0, 0])
    grown = np.asarray(jc["k_scale"])[:, bt[0, 1]] \
        >= after_verify["k_scale"][:, bt[0, 1]]
    assert grown.all()        # grow-only: a rewritten page never shrinks
    # K6 alone on the same two row sets, fed one set of fresh k/v.
    L, KVH, D = J_CFG.n_layers, J_CFG.n_kv_heads, J_CFG.head_dim
    state = [before[k] for k in ("k", "v", "k_scale", "v_scale")]
    for rs, scale in ((rows, 1.0), (rows2, 4.0)):
        kn = (rng.standard_normal((L, T, KVH, D)) * scale).astype(np.float32)
        vn = rng.standard_normal((L, T, KVH, D)).astype(np.float32)
        jout = [np.asarray(a) for a in jrpa.ragged_paged_append_quantized(
            *(jnp.asarray(a) for a in (*state, kn, vn, *rs, bt)))]
        tout = [torch.from_numpy(a.copy()) for a in state]
        trpa.ragged_paged_append_quantized(
            *tout, *(torch.from_numpy(np.asarray(a)) for a in
                     (kn, vn, *rs, bt)))
        tout = [a.numpy() for a in tout]
        _assert_k6_equal(jout, tout)
        state = jout
