"""The port's LLMEngine on int8 KV pools (``LlamaConfig.kv_int8``) against
the JAX LLMEngine on LLAMA_TINY with f32 weights: greedy streams equal
token for token on the bucketed path (K1 + K3, whole-page quantisation
at prefill) and on the ragged path (K4 + K6), the same weights crossing
through the numpy bridge.  The int8 rounding sits on k/v values that
differ between XLA and ATen in the last f32 bits, so a value on a
rounding boundary may store one step apart; the seeds below give streams
whose argmax margins are far wider than that."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.serve import llm_engine as jeng
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import llm_engine as teng

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32, kv_int8=True)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32, kv_int8=True)
BASE = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
            page_size=16, decode_chunk=4, max_new_tokens_default=8)
RAGGED = dict(BASE, ragged_batching=True, prefill_chunk=16, token_budget=36)
# Six requests over four slots; buckets 16..128 on the bucketed path,
# four prompts longer than a chunk on the ragged one.
LENS = (40, 3, 23, 70, 5, 17)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _prompts(seed, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, J_CFG.vocab_size, n).tolist() for n in lens]


@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_int8_streams_match_jax_engine(params, mode):
    jp, tp = params
    kw = RAGGED if mode == "ragged" else BASE
    prompts = _prompts(0)
    want_eng = jeng.LLMEngine(jp, jeng.llama_paged_adapter(J_CFG),
                              jeng.EngineConfig(**kw))
    try:
        assert want_eng._cache["k"].dtype == jnp.int8
        want = [s.result(timeout_s=300)
                for s in [want_eng.submit(p) for p in prompts]]
    finally:
        want_eng.shutdown()
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**kw), device="cpu")
    try:
        cache = eng._cache
        assert cache["k"].dtype == torch.int8
        assert tuple(cache["k_scale"].shape) == (2, 4 * 8 + 1, 2, 1)
        got = [s.result(timeout_s=120)
               for s in [eng.submit(p) for p in prompts]]
        stats = eng.stats()
        # The pools were written in place, scales included.
        assert eng._cache is cache and cache["k"].any()
        assert (cache["k_scale"][:, :-1] >= 0).all()
        assert torch.isfinite(cache["k_scale"]).all()
        assert torch.isfinite(cache["v_scale"]).all()
    finally:
        eng.shutdown()
    assert all(len(g) == 8 for g in got)
    assert got == want
    assert stats["active_slots"] == 0 and stats["kv_pages_free"] == 4 * 8
    if mode == "ragged":
        assert stats["step_tokens"]["prefill"] == sum(LENS)


def test_int8_tracks_the_f32_pool_engine(params):
    """int8 KV is a storage format, not another model: on this tiny
    model most greedy tokens equal the f32-pool engine's."""
    _, tp = params
    prompts = _prompts(1, (30, 9, 50))
    outs = {}
    for int8 in (False, True):
        cfg = dataclasses.replace(T_CFG, kv_int8=int8)
        eng = teng.LLMEngine(tp, teng.llama_paged_adapter(cfg),
                             teng.EngineConfig(**RAGGED), device="cpu")
        try:
            outs[int8] = [eng.generate(p) for p in prompts]
        finally:
            eng.shutdown()
    same = sum(a == b for x, y in zip(outs[False], outs[True])
               for a, b in zip(x, y))
    assert same >= 0.75 * sum(len(x) for x in outs[False])


def test_int8_chunked_prefill_needs_the_ragged_step(params):
    """kv_int8 with prefill_chunk > 0 outside the ragged step is a
    configuration error in both engines, with the same message."""
    jp, tp = params
    kw = dict(BASE, prefill_chunk=16)
    with pytest.raises(ValueError, match="kv_int8 pools do not support "
                                         "chunked prefill"):
        jeng.LLMEngine(jp, jeng.llama_paged_adapter(J_CFG),
                       jeng.EngineConfig(**kw))
    with pytest.raises(ValueError, match="kv_int8 pools do not support "
                                         "chunked prefill"):
        teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                       teng.EngineConfig(**kw), device="cpu")
    # bf16/f32 pools keep their chunked prefill.
    eng = teng.LLMEngine(
        tp, teng.llama_paged_adapter(dataclasses.replace(T_CFG,
                                                         kv_int8=False)),
        teng.EngineConfig(**kw), device="cpu")
    try:
        assert len(eng.generate(_prompts(2, (40,))[0])) == 8
    finally:
        eng.shutdown()
