"""The port's paged LLMEngine against the JAX LLMEngine on LLAMA_TINY in
f32: the same weights (crossed through the numpy bridge), several
concurrent prompts of different prefill buckets, greedy streams equal
token for token.  Plus the port engine's own admission, cancel and
configuration behaviour."""

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

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
ENGINE_KW = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
                 page_size=16, decode_chunk=4, max_new_tokens_default=10)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, J_CFG.vocab_size, n).tolist() for n in lens]


def test_greedy_streams_match_jax_engine(params):
    jp, tp = params
    # Buckets 16, 32, 64, 128; six requests over four slots, so two of
    # them wait for a slot and join the running batch later.
    prompts = _prompts(0, (5, 20, 40, 90, 7, 33))
    want_eng = jeng.LLMEngine(jp, jeng.llama_paged_adapter(J_CFG),
                              jeng.EngineConfig(**ENGINE_KW))
    try:
        want = [s.result(timeout_s=300)
                for s in [want_eng.submit(p) for p in prompts]]
    finally:
        want_eng.shutdown()
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**ENGINE_KW), device="cpu")
    try:
        got = [s.result(timeout_s=120)
               for s in [eng.submit(p) for p in prompts]]
    finally:
        eng.shutdown()
    assert all(len(g) == 10 for g in got)
    assert got == want


def test_page_pressure_backlog_drains(params):
    _, tp = params
    # Each request needs 2 pages; a 3-page pool serves one at a time.
    cfg = teng.EngineConfig(**dict(ENGINE_KW, num_pages=3))
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG), cfg,
                         device="cpu")
    try:
        streams = [eng.submit(p, max_new_tokens=12)
                   for p in _prompts(1, (10, 12, 14, 9))]
        outs = [s.result(timeout_s=120) for s in streams]
        assert all(len(o) == 12 for o in outs)
        assert eng.stats()["kv_pages_free"] == 3
        with pytest.raises(ValueError, match="pages"):
            eng.submit(list(range(60)), max_new_tokens=60)
    finally:
        eng.shutdown()


def test_cancel_ends_stream_and_frees_slot(params):
    _, tp = params
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**ENGINE_KW), device="cpu")
    try:
        s = eng.submit(_prompts(2, (12,))[0], max_new_tokens=100)
        s.cancel()
        out = s.result(timeout_s=60)
        assert len(out) < 100
        done = eng.submit(_prompts(3, (12,))[0], max_new_tokens=3)
        assert len(done.result(timeout_s=60)) == 3
        st = eng.stats()
        assert st["active_slots"] == 0 and st["kv_pages_free"] == 4 * 8
    finally:
        eng.shutdown()


def test_sampling_is_seeded_and_greedy_at_zero_temperature():
    logits = torch.randn(6, 50, generator=torch.Generator().manual_seed(0))
    temps = torch.tensor([0.0, 0.0, 0.8, 0.8, 1.5, 0.0])
    a = teng._sample(logits, temps, torch.Generator().manual_seed(7))
    b = teng._sample(logits, temps, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and a.dtype == torch.int32
    greedy = logits.argmax(-1).to(torch.int32)
    assert torch.equal(a[temps == 0], greedy[temps == 0])
    assert torch.equal(teng._sample(logits, temps), greedy)


@pytest.mark.parametrize("field,value,lora,exc,match", [
    # Speculative decoding and LoRA are ported to the ragged engine only,
    # as in the JAX package.
    ("spec_decode", True, False, ValueError, "ragged_batching"),
    ("adapter_pool_pages", 4, True, ValueError, "ragged_batching")])
def test_unported_modes_raise(params, field, value, lora, exc, match):
    from ray_tpu_torch.ops.segmented_lora import LoRAConfig

    _, tp = params
    cfg = teng.EngineConfig(**{**ENGINE_KW, field: value})
    model_cfg = (dataclasses.replace(T_CFG, lora=LoRAConfig(rank=4))
                 if lora else T_CFG)
    with pytest.raises(exc, match=match):
        teng.LLMEngine(tp, teng.llama_paged_adapter(model_cfg), cfg,
                       device="cpu")


@pytest.mark.parametrize("field", ["slo", "shed_queue_age_s"])
def test_slo_and_shedding_settings_act(params, field):
    """The two settings that raised before they were ported: an SLO whose
    tpot bound a one-token request cannot meet (fewer than two tokens)
    moves goodput, and a shedding budget below any queue age refuses
    every submission with ShedError."""
    from ray_tpu_torch.core.exceptions import ShedError

    _, tp = params
    value = (teng.SLO(tpot_s=1e9) if field == "slo" else -1.0)
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**{**ENGINE_KW, field: value}),
                         device="cpu")
    try:
        if field == "slo":
            eng.generate(_prompts(6, (9,))[0], max_new_tokens=1)
            assert eng.goodput_ratio() == 0.0  # one token: tpot missed
            eng.generate(_prompts(7, (9,))[0], max_new_tokens=4)
            assert eng.goodput_ratio() == 4 / 5
        else:
            with pytest.raises(ShedError) as err:
                eng.submit(_prompts(6, (9,))[0])
            assert err.value.queue_age_s == 0.0
            assert eng.arrivals_total() == 1
            assert eng.stats()["requests"] == {"SHED": 1}
    finally:
        eng.shutdown()


def test_eos_ends_stream_and_iteration_matches_result(params):
    _, tp = params
    prompt = _prompts(4, (11,))[0]
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**ENGINE_KW), device="cpu")
    try:
        full = eng.generate(prompt, max_new_tokens=6)
        assert list(eng.submit(prompt, max_new_tokens=6)) == full
    finally:
        eng.shutdown()
    eos = full[2]
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**dict(ENGINE_KW, eos_id=eos)),
                         device="cpu")
    try:
        got = eng.generate(prompt, max_new_tokens=6)
    finally:
        eng.shutdown()
    assert got == full[: full.index(eos) + 1]


def test_sampled_stream_is_reproducible_from_the_seed(params):
    _, tp = params
    prompt = _prompts(5, (9,))[0]
    outs = []
    for seed in (3, 3, 4):
        eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                             teng.EngineConfig(**ENGINE_KW), seed=seed,
                             device="cpu")
        try:
            outs.append(eng.generate(prompt, max_new_tokens=12,
                                     temperature=1.0))
        finally:
            eng.shutdown()
    assert outs[0] == outs[1]
    assert all(0 <= t < T_CFG.vocab_size for t in outs[2])
    assert outs[0] != outs[2]  # 12 draws over 256 tokens: seeds differ
