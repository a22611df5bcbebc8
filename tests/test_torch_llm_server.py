"""The port's LLMServer against the JAX package's on LLAMA_TINY in f32,
the same weights (crossed through the numpy bridge): the payload →
{"tokens", "metrics", "request_id"} contract on the same payloads, the
stream entry, pressure() and check_health(), on the dense engine both
servers build by default.  One JAX server serves the file."""

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
ENGINE_KW = dict(max_slots=2, max_seq_len=64, min_prefill_bucket=16,
                 page_size=16, decode_chunk=1, max_new_tokens_default=5)
PAYLOADS = [{"tokens": [3, 1, 4, 1, 5], "max_new_tokens": 6,
             "request_id": "payload-a"},
            {"tokens": [9, 2, 6]},
            {"tokens": [5, 3, 5, 8, 9, 7], "max_new_tokens": 4,
             "temperature": 0.0, "request_id": "payload-c"}]


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(1), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def servers(params):
    jp, tp = params
    j = jeng.LLMServer(J_CFG, jeng.EngineConfig(**ENGINE_KW), lambda: jp)
    t = teng.LLMServer(T_CFG, teng.EngineConfig(**ENGINE_KW), lambda: tp,
                       device="cpu")
    yield j, t
    j.engine.shutdown()
    t.engine.shutdown()


def test_payload_contract_matches_jax(servers):
    j, t = servers
    assert type(t.engine.adapter) is teng.EngineAdapter  # dense default
    lens = []
    for payload in PAYLOADS:
        want, got = j(dict(payload)), t(dict(payload))
        lens.append(len(got["tokens"]))
        assert set(got) == set(want) == {"tokens", "metrics", "request_id"}
        assert got["tokens"] == want["tokens"]
        assert set(got["metrics"]) == set(want["metrics"])
        assert got["metrics"]["num_tokens"] == len(got["tokens"])
        if "request_id" in payload:
            assert got["request_id"] == want["request_id"] \
                == payload["request_id"]
        else:
            assert got["request_id"].startswith(t.engine.engine_id + "-r")
    assert lens == [6, 5, 4]


def test_stream_pressure_and_summaries(servers):
    j, t = servers
    for srv in (j, t):
        toks = list(srv.stream(dict(PAYLOADS[0], request_id=None)))
        assert toks == srv(dict(PAYLOADS[0]))["tokens"]
    jp, tp = j.pressure(), t.pressure()
    assert set(tp) == set(jp) == {"queue_age_s", "goodput", "arrivals"}
    assert tp["arrivals"] == jp["arrivals"]
    assert tp["goodput"] == jp["goodput"] == 1.0  # no SLO: every finish met
    assert tp["queue_age_s"] == jp["queue_age_s"] == 0.0
    assert t.prefix_summary() is None and j.prefix_summary() is None
    assert t.adapter_summary() is None and j.adapter_summary() is None
    assert t.stats()["requests"] == j.stats()["requests"]


def test_doctor_and_check_health(params):
    """A paged server audits clean and is healthy; a page owned twice
    (a critical violation) fails check_health at the next audit, the
    repaired pool passes again, and a stopped engine fails it, as in the
    JAX server."""
    _, tp = params
    srv = teng.LLMServer(T_CFG, teng.EngineConfig(**ENGINE_KW), lambda: tp,
                         adapter_factory=teng.llama_paged_adapter,
                         device="cpu")
    eng = srv.engine
    try:
        assert srv(dict(PAYLOADS[0]))["tokens"]
        assert srv.doctor()["violations"] == 0
        srv.check_health()
        eng._free_pages.append(eng._free_pages[0])  # the loop is idle
        assert "kv.pool_partition" in {
            v["check"] for row in srv.doctor()["checks"]
            for v in row["violations"]}
        with pytest.raises(RuntimeError, match="doctor: invariant kv"):
            srv.check_health()
        eng._free_pages.pop()
        assert srv.doctor()["violations"] == 0
        srv.check_health()
    finally:
        eng.shutdown()
    with pytest.raises(RuntimeError, match="engine stopped"):
        srv.check_health()


def test_check_health_after_shutdown_matches_jax(servers):
    for srv in servers:
        srv.check_health()
        assert srv.drain(grace_s=0.0) == 0
        srv.engine.shutdown()
        with pytest.raises(RuntimeError, match="engine stopped"):
            srv.check_health()
