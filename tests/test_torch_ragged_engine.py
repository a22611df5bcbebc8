"""The port's ragged and chunked-prefill LLMEngine modes on LLAMA_TINY in
f32: greedy streams equal token for token to the JAX LLMEngine in the
same mode (same weights, crossed through the numpy bridge) and to the
port's own bucketed engine; plus the no-stall property of the ragged
step, cancel during an incremental prefill, and configuration errors."""

import dataclasses
import threading
import time

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
BASE = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
            page_size=16, decode_chunk=4, max_new_tokens_default=8)
RAGGED = dict(BASE, ragged_batching=True, prefill_chunk=16, token_budget=36)
CHUNKED = dict(BASE, prefill_chunk=16)
# Six requests over four slots, four of them longer than a chunk.
LENS = (40, 3, 23, 70, 5, 17)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _prompts(seed, lens=LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, J_CFG.vocab_size, n).tolist() for n in lens]


def _port_streams(tp, kw, prompts, adapter=None):
    eng = teng.LLMEngine(tp, adapter or teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**kw), device="cpu")
    try:
        outs = [s.result(timeout_s=120)
                for s in [eng.submit(p) for p in prompts]]
        return outs, eng.stats()
    finally:
        eng.shutdown()


def _jax_streams(jp, kw, prompts):
    eng = jeng.LLMEngine(jp, jeng.llama_paged_adapter(J_CFG),
                         jeng.EngineConfig(**kw))
    try:
        return [s.result(timeout_s=300)
                for s in [eng.submit(p) for p in prompts]]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("mode", ["ragged", "chunked"])
def test_streams_match_jax_engine(params, mode):
    jp, tp = params
    kw = RAGGED if mode == "ragged" else CHUNKED
    prompts = _prompts(0)
    want = _jax_streams(jp, kw, prompts)
    got, stats = _port_streams(tp, kw, prompts)
    assert all(len(g) == 8 for g in got)
    assert got == want
    assert stats["active_slots"] == 0 and stats["prefilling"] == 0
    assert stats["kv_pages_free"] == 4 * 8
    # Every prompt token was dispatched once (ragged packs no padding).
    if mode == "ragged":
        assert stats["step_tokens"]["prefill"] == sum(LENS)
        assert stats["step_tokens"]["decode"] == 7 * len(LENS)


def test_ragged_matches_port_bucketed_engine(params):
    _, tp = params
    prompts = _prompts(1, (90, 7, 33, 16, 64, 2, 50))
    want, _ = _port_streams(tp, BASE, prompts)
    got, stats = _port_streams(tp, dict(RAGGED, token_budget=20), prompts)
    assert got == want
    assert stats["mixed_steps"] > 0


def _greedy_reference(tp, prompt, n):
    toks, out = list(prompt), []
    for _ in range(n):
        logits = tl.forward(tp, torch.tensor([toks]), T_CFG)
        out.append(int(logits[0, -1].argmax()))
        toks.append(out[-1])
    return out


def test_long_prefill_never_stalls_decode(params):
    """While a 96-token prompt trickles in, an in-flight decode stream
    keeps emitting every step: decode rows pack first, so the prompt's
    chunks ride the decode steps instead of displacing them."""
    _, tp = params
    rng = np.random.default_rng(1)
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(**RAGGED), device="cpu")
    try:
        short = eng.submit([1, 5, 9], max_new_tokens=24)
        it = iter(short)
        got_short = [next(it)]
        long_prompt = rng.integers(1, 127, size=96).tolist()
        longs = eng.submit(long_prompt, max_new_tokens=4)
        stamps = [time.monotonic()]
        for tok in it:
            got_short.append(tok)
            stamps.append(time.monotonic())
        got_long = longs.result(timeout_s=120)
        steps = eng.stats()["steps"]
        mixed = eng.stats()["mixed_steps"]
    finally:
        eng.shutdown()
    assert got_short == _greedy_reference(tp, [1, 5, 9], 24)
    assert got_long == _greedy_reference(tp, long_prompt, 4)
    # The runs overlapped on the device...
    assert longs._req.first_token_at < short._req.finished_at
    assert mixed > 0
    # ...and the long prompt's chunks took (almost) no steps of their
    # own: the short stream alone needs 24 (prefill + 23 decode rows).
    # A scheduler that parked decode behind the prefill would serialise
    # the chunk steps on top.
    assert steps <= 28
    # The decode stream never gapped by a monolithic prefill.
    assert max(np.diff(stamps)) < 1.0


@pytest.mark.parametrize("mode", ["ragged", "chunked"])
def test_cancel_while_prefilling_frees_slot_and_pages(params, mode):
    _, tp = params
    gate = threading.Event()
    base = teng.llama_paged_adapter(T_CFG)
    field = "ragged_step" if mode == "ragged" else "prefill_chunk"
    inner = getattr(base, field)

    def held(*args):  # prompt steps wait until the test has cancelled
        gate.wait(timeout=60)
        return inner(*args)

    kw = dict(RAGGED if mode == "ragged" else CHUNKED, token_budget=8)
    if mode == "chunked":
        kw.pop("token_budget")
    eng = teng.LLMEngine(tp, dataclasses.replace(base, **{field: held}),
                         teng.EngineConfig(**kw), device="cpu")
    try:
        s = eng.submit(_prompts(2, (60,))[0], max_new_tokens=4)
        deadline = time.monotonic() + 30
        while eng.stats()["prefilling"] != 1:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        assert eng.stats()["kv_pages_free"] < 4 * 8
        s.cancel()
        gate.set()
        assert s.result(timeout_s=60) == []
        deadline = time.monotonic() + 30
        while eng.stats()["prefilling"] or eng.stats()["waiting"]:
            assert time.monotonic() < deadline
            time.sleep(0.005)
        done = eng.submit(_prompts(3, (20,))[0], max_new_tokens=3)
        assert len(done.result(timeout_s=60)) == 3
        st = eng.stats()
        assert st["active_slots"] == 0 and st["prefilling"] == 0
        assert st["kv_pages_free"] == 4 * 8
    finally:
        gate.set()
        eng.shutdown()


def test_ragged_config_errors(params):
    _, tp = params
    with pytest.raises(ValueError, match="token_budget"):
        teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                       teng.EngineConfig(**dict(RAGGED, token_budget=4)),
                       device="cpu")
    bare = dataclasses.replace(teng.llama_paged_adapter(T_CFG),
                               ragged_step=None)
    with pytest.raises(ValueError, match="ragged"):
        teng.LLMEngine(tp, bare, teng.EngineConfig(**RAGGED), device="cpu")


def test_shutdown_fails_prefilling_requests(params):
    _, tp = params
    gate = threading.Event()
    base = teng.llama_paged_adapter(T_CFG)

    def held(*args):
        gate.wait(timeout=60)
        return base.ragged_step(*args)

    eng = teng.LLMEngine(tp, dataclasses.replace(base, ragged_step=held),
                         teng.EngineConfig(**dict(RAGGED, token_budget=8)),
                         device="cpu")
    s = eng.submit(_prompts(4, (60,))[0], max_new_tokens=4)
    deadline = time.monotonic() + 30
    while eng.stats()["prefilling"] != 1:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    eng._stopped.set()
    gate.set()
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        s.result(timeout_s=30)
    assert eng.stats()["kv_pages_free"] == 4 * 8
    assert eng.stats()["prefilling"] == 0
