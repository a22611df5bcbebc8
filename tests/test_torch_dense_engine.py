"""The port's dense (non-paged) serving path against the JAX package on
LLAMA_TINY in f32 on the CPU: ``decode_attention``, the dense cache
(``init_kv_cache``, ``prefill``, ``decode_step``, ``prefill_batch``,
``decode_slots``) and ``LLMEngine`` with ``llama_adapter``, whose greedy
streams must equal the JAX dense engine's token for token and the port's
paged engine's.  Weights cross through the numpy bridge; inputs come from
seeded numpy generators."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import attention as jattn
from ray_tpu.serve import llm_engine as jeng
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import quant as tq
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.serve import llm_engine as teng

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
V = J_CFG.vocab_size
# f32 on both sides; XLA and ATen sum in other orders.
TOL = 2e-5
ENGINE_KW = dict(max_slots=2, max_seq_len=128, min_prefill_bucket=16,
                 decode_chunk=4, max_new_tokens_default=10, page_size=16)


# The JAX side runs each function as one compiled program (op by op, every
# primitive of a scan body compiles on its own: several times slower).
_J = {name: jax.jit(getattr(jl, name), static_argnames="cfg")
      for name in ("prefill", "decode_step", "prefill_batch",
                   "decode_slots")}


@pytest.fixture(scope="module")
def params():
    jp = jax.jit(jl.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n).tolist() for n in lens]


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol, err_msg=what)


def _close_cache(tc, jc, what):
    for key in ("k", "v"):
        _close(tc[key], jc[key], f"{what}: {key}")
    assert tc["length"].tolist() == np.asarray(jc["length"]).tolist(), what


@pytest.mark.parametrize("soft_cap", [None, 20.0])
def test_decode_attention_matches_jax(soft_cap):
    """GQA (8 query heads over 2 kv heads), a soft cap, and an empty slot
    (length 0: uniform weights over the whole cache, no NaN)."""
    rng = np.random.default_rng(1)
    B, S, H, KVH, D = 3, 24, 8, 2, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    lens = np.array([17, 0, 24], np.int32)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v, lens)),
                                  logits_soft_cap=soft_cap)
    got = tattn.decode_attention(*map(torch.from_numpy, (q, k, v, lens)),
                                 logits_soft_cap=soft_cap)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _close(got, want, "decode_attention", tol=1e-5)


def test_prefill_and_decode_step_match_jax(params):
    """The counterpart of tests/test_llama.py's cache check: a [2, 8]
    prefill, then three decode steps; logits and the whole cache."""
    jp, tp = params
    toks = np.random.default_rng(2).integers(0, V, (2, 8)).astype(np.int32)
    jc = jl.init_kv_cache(J_CFG, 2, 32)
    tc = tl.init_kv_cache(T_CFG, 2, 32, device="cpu")
    assert tc["k"].shape == (2, 2, 32, 2, 16) and tc["k"].dtype == \
        torch.float32 and tc["length"].dtype == torch.int32
    jl_, jc = _J["prefill"](jp, jnp.asarray(toks), cfg=J_CFG, cache=jc)
    tl_, tc = tl.prefill(tp, torch.from_numpy(toks), T_CFG, tc)
    _close(tl_, jl_, "prefill logits")
    _close_cache(tc, jc, "prefill")
    nxt = toks[:, -1]
    for i in range(3):
        jl_, jc = _J["decode_step"](jp, jnp.asarray(nxt), cfg=J_CFG,
                                     cache=jc)
        tl_, tc = tl.decode_step(tp, torch.from_numpy(nxt), T_CFG, tc)
        _close(tl_, jl_, f"decode_step {i} logits")
        _close_cache(tc, jc, f"decode_step {i}")
        nxt = np.array(jnp.argmax(jl_, -1), np.int32)


def test_prefill_batch_and_decode_slots_match_jax(params):
    """Four slots: a batched prefill whose last row pads (a copy of row 2
    into the same slot), then decode steps with slot 1 inactive; slot 1's
    length is at the end of the cache, so its write falls off the end and
    is dropped (as the JAX scatter drops it)."""
    jp, tp = params
    rng = np.random.default_rng(3)
    toks = rng.integers(0, V, (4, 16)).astype(np.int32)
    toks[3] = toks[2]
    true_lens = np.array([5, 16, 9, 9], np.int32)
    slots = np.array([2, 0, 3, 3], np.int32)
    jc = jl.init_kv_cache(J_CFG, 4, 32)
    tc = tl.init_kv_cache(T_CFG, 4, 32, device="cpu")
    jl_, jc = _J["prefill_batch"](jp, *map(jnp.asarray, (toks, true_lens,
                                                         slots)),
                                  cfg=J_CFG, cache=jc)
    tl_, tc = tl.prefill_batch(tp, *map(torch.from_numpy, (toks, true_lens,
                                                           slots)), T_CFG, tc)
    _close(tl_, jl_, "prefill_batch logits")
    _close_cache(tc, jc, "prefill_batch")
    jc = dict(jc, length=jc["length"].at[1].set(32))
    tc["length"][1] = 32
    active = np.array([True, False, True, True])
    cur = rng.integers(0, V, 4).astype(np.int32)
    for i in range(2):
        jl_, jc = _J["decode_slots"](jp, jnp.asarray(cur),
                                     jnp.asarray(active), cfg=J_CFG,
                                     cache=jc)
        tl_, tc = tl.decode_slots(tp, torch.from_numpy(cur),
                                  torch.from_numpy(active), T_CFG, tc)
        _close(tl_[active], np.asarray(jl_)[active],
               f"decode_slots {i} logits")
        _close_cache(tc, jc, f"decode_slots {i}")
        cur = np.array(jnp.argmax(jl_, -1), np.int32)
    assert tc["length"].tolist() == [18, 32, 7, 11]


def _run_engine(eng, prompts, timeout=120):
    try:
        return [s.result(timeout_s=timeout)
                for s in [eng.submit(p) for p in prompts]]
    finally:
        eng.shutdown()


def test_dense_engine_matches_jax_engine(params):
    """Three prompts on two slots: the first two share one prefill padded
    to the larger bucket, the third waits for a freed slot."""
    jp, tp = params
    prompts = _prompts(4, (5, 20, 40))
    want = _run_engine(jeng.LLMEngine(jp, jeng.llama_adapter(J_CFG),
                                      jeng.EngineConfig(**ENGINE_KW)),
                       prompts, timeout=300)
    eng = teng.LLMEngine(tp, teng.llama_adapter(T_CFG),
                         teng.EngineConfig(**ENGINE_KW), device="cpu")
    got = _run_engine(eng, prompts)
    assert all(len(g) == 10 for g in got)
    assert got == want
    # The host mirror of the lengths moved as the cache's own did, and the
    # dense engine reports no pages.
    assert eng._lens.tolist() == eng._cache["length"].tolist()
    st = eng.stats()
    assert st["active_slots"] == 0 and "kv_pages_free" not in st
    assert st["tokens_out"] == 30


@pytest.mark.parametrize("variant", ["batched", "slot_loop", "chunk_set"])
def test_dense_streams_equal_paged_streams(params, variant):
    """Inside the port, dense and paged greedy streams are equal: five
    prompts over two slots (a cancel frees a slot on the way), with the
    dense prefill batched, as a loop of prefill_slot calls, or with
    prefill_chunk set (the dense engine does not chunk)."""
    _, tp = params
    prompts = _prompts(5, (3, 33, 17, 60, 9))
    kw = dict(ENGINE_KW, prefill_chunk=16 if variant == "chunk_set" else 0)
    paged = _run_engine(teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                                       teng.EngineConfig(**kw),
                                       device="cpu"), prompts)
    adapter = teng.llama_adapter(T_CFG)
    if variant == "slot_loop":
        adapter = dataclasses.replace(adapter, prefill_batch=None)
    eng = teng.LLMEngine(tp, adapter, teng.EngineConfig(**kw), device="cpu")
    try:
        doomed = eng.submit(prompts[0], max_new_tokens=100)
        doomed.cancel()
        assert len(doomed.result(timeout_s=60)) < 100
        dense = [s.result(timeout_s=120)
                 for s in [eng.submit(p) for p in prompts]]
        assert eng.stats()["prefilling"] == 0
    finally:
        eng.shutdown()
    assert dense == paged


def test_dense_refusals(params):
    """The ragged step and speculative decoding need the paged adapter;
    int8 weights cannot be decoded on the dense path (the JAX
    dense decode takes plain weights); the engine runs on the card unless
    asked for the CPU."""
    _, tp = params
    adapter = teng.llama_adapter(T_CFG)
    for field, match in (("ragged_batching", "PagedEngineAdapter"),
                         ("spec_decode", "ragged_batching")):
        with pytest.raises(ValueError, match=match):
            teng.LLMEngine(tp, adapter, teng.EngineConfig(
                **ENGINE_KW, **{field: True}), device="cpu")
    with pytest.raises(ValueError, match="int8 weights"):
        teng.LLMEngine(tq.quantize_params(tp), adapter,
                       teng.EngineConfig(**ENGINE_KW), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            teng.LLMEngine(tp, adapter, teng.EngineConfig(**ENGINE_KW))
