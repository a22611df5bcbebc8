"""The latency waterfall and the device plane in the port
(``serve/latency_attribution.py``, ``serve/request_events.stitch_request``,
``util/xprof.py``, ``utils/accelerator.py``) against the JAX package's.

The waterfall's join equals the JAX package's ``waterfall(rows=...)`` on
the same ring rows and the same program records (the port's engine rows,
and synthetic rows with a router handoff and a failover); on a port
engine its components sum to the stitched e2e, and the first dispatch's
wall is charged to ``compile`` and kept out of the control-plane share.
The device plane: the engine registers each program's analytic cost on
its first dispatch (``serve.prefill`` / ``serve.decode`` on the bucketed
engine, ``serve.ragged`` with per-step spans on the ragged one), the
decode count equals a hand count, ``roofline`` divides walls by the
record's ``steps_attr``, ``chip_spec`` answers for the H100, the CPU and
an unknown card, and the memory gauges stay absent on the CPU.  No JAX
engine runs here: the JAX side is its pure functions."""

import dataclasses
import time

import pytest
import torch

from ray_tpu.serve import latency_attribution as jlat
from ray_tpu.serve import request_events as jreqev
from ray_tpu.util import xprof as jxprof
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import latency_attribution as lat
from ray_tpu_torch.serve import llm_engine as teng
from ray_tpu_torch.serve import request_events as reqev
from ray_tpu_torch.util import metrics, tracing, xprof
from ray_tpu_torch.utils import accelerator

CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
PAGE = 16
PROMPTS = [[i + 1, i + 2, i + 3] for i in range(3)]
N_NEW = 8


@pytest.fixture(scope="module")
def params():
    return tl.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")


@pytest.fixture(scope="module")
def served(params):
    """A cold bucketed engine (so the first request overlaps the
    serve.prefill / serve.decode first-dispatch windows) serving three
    greedy streams with tracing on; the port's program records and its
    ring rows of those requests."""
    xprof.clear()
    lat.clear()
    tracing.enable_tracing()
    eng = teng.LLMEngine(params, teng.llama_paged_adapter(CFG),
                         teng.EngineConfig(max_slots=4, max_seq_len=64,
                                           page_size=PAGE,
                                           min_prefill_bucket=16,
                                           decode_chunk=2), device="cpu")
    try:
        streams = [eng.submit(p, max_new_tokens=N_NEW) for p in PROMPTS]
        for s in streams:
            s.result(timeout_s=120)
        rows = {s.request_id: eng._ring.row(s.request_id) for s in streams}
        yield eng, streams, rows, xprof.programs()
    finally:
        eng.shutdown()
        tracing.disable_tracing()


@pytest.fixture
def jax_records():
    """Install the port's program records in the JAX device plane for one
    test, restoring its registry after."""
    saved = jxprof.programs()

    def install(recs):
        jxprof.clear()
        for name, r in recs.items():
            jxprof._programs[name] = jxprof.ProgramRecord(
                **dataclasses.asdict(r))

    yield install
    jxprof.clear()
    jxprof._programs.update(saved)


def _assert_waterfall(wf):
    comp = wf["components"]
    assert set(comp) == set(lat.COMPONENTS)
    assert all(v >= -1e-12 for v in comp.values()), comp
    assert abs(sum(comp.values()) - wf["e2e_s"]) <= 1e-6
    assert 0.0 <= wf["control_plane_share"] <= 1.0 + 1e-9


def test_engine_waterfalls_sum_to_e2e_and_match_jax(served, jax_records):
    """Every terminal request's waterfall sums to its stitched e2e; the
    JAX join over the same rows and records gives the same dict."""
    _eng, streams, rows, recs = served
    jax_records(recs)
    for s in streams:
        wf = lat.waterfall(s.request_id, rows=[rows[s.request_id]])
        _assert_waterfall(wf)
        assert wf["state"] == "FINISHED"
        assert wf["generated_tokens"] == N_NEW
        assert wf["components"]["route"] == 0.0
        assert wf == jlat.waterfall(s.request_id,
                                    rows=[rows[s.request_id]])
        # The ring's registry gives the same rows.
        assert lat.waterfall(s.request_id) == wf


def test_first_dispatch_is_compile_and_excluded(served):
    """The cold engine's first dispatch wall is charged to ``compile``
    (the sum stays exact) and left out of the control-plane share."""
    _eng, streams, rows, recs = served
    assert {"serve.prefill", "serve.decode"} <= set(recs)
    wf0 = lat.waterfall(streams[0].request_id,
                        rows=[rows[streams[0].request_id]])
    assert wf0["components"]["compile"] > 0.0
    assert wf0["compile_excluded"]
    assert wf0["control_plane_share"] >= \
        wf0["components"]["control_plane"] / wf0["e2e_s"]
    compile_spans = [sp for sp in tracing.finished_spans()
                     if (sp.get("attributes") or {}).get("compile")]
    assert {sp["attributes"]["program"] for sp in compile_spans} >= \
        {"serve.prefill", "serve.decode"}


def test_terminal_observation_feeds_families(served):
    text = metrics.export_prometheus()
    for c in lat.COMPONENTS:
        assert f'raytpu_serve_request_overhead_seconds_count{{component="{c}"}}' \
            in text, c
    assert "raytpu_serve_control_plane_share " in text
    agg = lat.aggregate(since=0.0)
    assert agg["requests"] >= len(PROMPTS)
    assert 0.0 <= agg["control_plane_share"] <= 1.0


def _row(engine, rid, states, **kw):
    return {"request_id": rid, "engine": engine, "state_ts": states,
            "prompt_tokens": kw.get("prompt", 12),
            "generated_tokens": kw.get("gen", 10),
            "attempt": kw.get("attempt", 0),
            "prefix_hit": kw.get("hit", 0),
            "spec_accepted": kw.get("acc", 0), "proc": "head"}


@pytest.mark.parametrize("kind", ["migrated", "failover"])
def test_handoff_rows_match_jax(kind, jax_records):
    """Router + two engine attempts: the resumed attempt's interlude is
    ``kv_transfer`` after a MIGRATING router row, ``retry_reprefill``
    otherwise; stitching and the waterfall equal the JAX package's."""
    t = 1000.0
    router = {"QUEUED": t, "DECODING": t + 0.30,
              ("MIGRATING" if kind == "migrated" else "RETRYING"): t + 0.5,
              "FINISHED": t + 2.0}
    rows = [
        _row("router:app/LLMServer", "r1", router, gen=10, attempt=1),
        _row("e1", "r1", {"QUEUED": t + 0.01, "PREFILLING": t + 0.05,
                          "DECODING": t + 0.30, "PREEMPTED": t + 0.5},
             gen=3, hit=4),
        _row("e2", "r1", {"QUEUED": t + 0.6, "PREFILLING": t + 0.62,
                          "DECODING": t + 0.9, "FINISHED": t + 2.0},
             gen=7, acc=2),
    ]
    recs = {
        "serve.ragged": xprof.ProgramRecord(
            "serve.ragged", flops=4e9, bytes_accessed=2e9,
            compile_time_s=0.05, span_name="llm.ragged",
            steps_attr="tokens", cost_steps=64.0, compiled_at=t + 0.2)}
    xprof.clear()
    for r in recs.values():
        xprof._programs[r.name] = r
    jax_records(recs)
    try:
        assert reqev.stitch_request("r1", rows=rows) == \
            jreqev.stitch_request("r1", rows=rows)
        wf = lat.waterfall("r1", rows=rows)
        _assert_waterfall(wf)
        assert wf == jlat.waterfall("r1", rows=rows)
        interlude = "kv_transfer" if kind == "migrated" else \
            "retry_reprefill"
        other = "retry_reprefill" if kind == "migrated" else "kv_transfer"
        assert wf["components"][interlude] > 0.0
        assert wf["components"][other] == 0.0
        assert wf["components"]["route"] == pytest.approx(0.01)
        assert wf["attempts"] == 1 and wf["generated_tokens"] == 10
    finally:
        xprof.clear()


def test_engine_registers_programs_with_jax_names(params):
    """The ragged engine registers serve.ragged on its first dispatch
    (span llm.ragged, steps_attr tokens, cost_steps T) and, with tracing
    on, records one llm.ragged span a step: the roofline's serve.ragged
    row divides the record's bytes by the median step wall."""
    xprof.clear()
    tracing.clear()
    tracing.enable_tracing()
    eng = teng.LLMEngine(params, teng.llama_paged_adapter(CFG),
                         teng.EngineConfig(max_slots=4, max_seq_len=64,
                                           page_size=PAGE,
                                           ragged_batching=True,
                                           token_budget=24,
                                           prefix_cache=True),
                         device="cpu")
    try:
        eng.generate(list(range(1, 30)), max_new_tokens=6)
        rec = xprof.programs()["serve.ragged"]
        assert (rec.span_name, rec.steps_attr, rec.cost_steps) == \
            ("llm.ragged", "tokens", 24.0)
        assert rec.flops > 0 and rec.bytes_accessed > 0
        assert rec.compile_time_s > 0 and rec.compiled_at > 0
        steps = [sp for sp in tracing.finished_spans()
                 if sp["name"] == "llm.ragged"
                 and not sp["attributes"].get("compile")]
        assert len(steps) == eng.stats()["steps"]
        row = xprof.roofline()["serve.ragged"]
        assert row["chip"] == "cpu"
        assert row["hbm_utilization"] == pytest.approx(
            rec.bytes_accessed / row["wall_s_per_step"] / 50e9)
    finally:
        eng.shutdown()
        tracing.disable_tracing()
        tracing.clear()
        xprof.clear()


def test_roofline_divides_wall_by_steps_attr():
    """As the JAX package's test of the same name."""
    xprof.clear()
    tracing.clear()
    tracing.enable_tracing()
    try:
        xprof.record_program("t.stepped", flops=1e6, bytes_accessed=1e6,
                             span_name="t.loop", steps_attr="tokens")
        t0 = time.time()
        tracing.record_span("t.loop", t0, t0 + 1.0,
                            attributes={"tokens": 10})
        tracing.record_span("t.loop", t0, t0 + 5.0,
                            attributes={"tokens": 1, "compile": True})
        row = xprof.roofline()["t.stepped"]
        assert row["wall_s_per_step"] == pytest.approx(0.1, rel=1e-3)
        assert row["flops_utilization"] == pytest.approx(1e6 / 0.1 / 100e9,
                                                         rel=1e-3)
        text = metrics.export_prometheus()
        assert 'raytpu_xla_roofline_hbm_utilization{program="t.stepped"}' \
            in text
        assert 'raytpu_xla_program_flops{program="t.stepped"}' in text
    finally:
        tracing.disable_tracing()
        tracing.clear()
        xprof.clear()


def test_decode_cost_matches_hand_count(params):
    """The first serve.decode dispatch's record: one step over one slot of
    length P (the weights once, the embedding row, the slot's P + 1 keys
    read and its new key written, the logits) by hand."""
    xprof.clear()
    P = 7
    eng = teng.LLMEngine(params, teng.llama_paged_adapter(CFG),
                         teng.EngineConfig(max_slots=2, max_seq_len=64,
                                           page_size=PAGE,
                                           min_prefill_bucket=16,
                                           decode_chunk=4), device="cpu")
    try:
        eng.generate(list(range(1, P + 1)), max_new_tokens=5)
        rec = xprof.programs()["serve.decode"]
    finally:
        eng.shutdown()
    d, L, H, KVH, hd, V, M = (CFG.dim, CFG.n_layers, CFG.n_heads,
                              CFG.n_kv_heads, CFG.head_dim, CFG.vocab_size,
                              CFG.mlp_dim)
    weights = sum(t.numel() for t in _leaves(params)) - V * d
    kv = L * KVH * hd * 2 * 4
    assert rec.bytes_accessed == 4 * weights + 4 * d + kv * (P + 1 + 1) \
        + 4 * V
    matmul = L * (d * H * hd + 2 * d * KVH * hd + H * hd * d + 3 * d * M)
    assert rec.flops == 2 * matmul + 2 * d * V + 4 * L * H * hd * (P + 1)
    assert (rec.span_name, rec.steps_attr, rec.cost_steps) == \
        ("llm.decode", "tokens", 4.0)
    xprof.clear()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def test_8b_decode_bound_beside_the_weight_streaming_bound():
    """LLAMA3_8B bf16 on meta tensors: a decode step reads the weights and
    the head once (4.48 ms at 3.35 TB/s); with the 1.05 GB embedding table
    counted whole, as PERF.md's 4.79 ms does, the count is within 2 % of
    it."""
    cfg = tl.LLAMA3_8B
    d, L, H, KVH, hd, M, V = (cfg.dim, cfg.n_layers, cfg.n_heads,
                              cfg.n_kv_heads, cfg.head_dim, cfg.mlp_dim,
                              cfg.vocab_size)

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    tree = {"tok_embed": meta(V, d), "lm_head": meta(d, V),
            "final_norm": meta(d),
            "layers": {"attn": {"wq": meta(L, d, H, hd),
                                "wk": meta(L, d, KVH, hd),
                                "wv": meta(L, d, KVH, hd),
                                "wo": meta(L, H, hd, d)},
                       "mlp": {"w_gate": meta(L, d, M), "w_up": meta(L, d, M),
                               "w_down": meta(L, M, d)},
                       "ln_attn": meta(L, d), "ln_mlp": meta(L, d)}}
    mc = xprof.llama_costs(cfg, tree)
    peak = accelerator.chip_spec(accelerator.H100_SXM)
    _flops, nbytes = xprof.step_cost(mc, [(0, 1)], 1)
    ms = nbytes / peak["peak_hbm_bytes_per_s"] * 1e3
    assert ms == pytest.approx(4.48, abs=0.01)
    whole = (nbytes + V * d * 2) / peak["peak_hbm_bytes_per_s"] * 1e3
    assert whole == pytest.approx(4.79, rel=0.02)


def test_chip_spec_cards_cpu_and_unknown():
    h = accelerator.chip_spec("NVIDIA H100 80GB HBM3")
    assert (h["peak_flops"], h["peak_hbm_bytes_per_s"]) == (989.4e12, 3.35e12)
    cpu = accelerator.chip_spec("cpu")
    from ray_tpu.utils.accelerator import _CPU_FALLBACK_SPEC
    assert {k: cpu[k] for k in _CPU_FALLBACK_SPEC} == _CPU_FALLBACK_SPEC
    unknown = accelerator.chip_spec("NVIDIA A100-SXM4-40GB")
    assert unknown == {"chip": "NVIDIA A100-SXM4-40GB", "peak_flops": None,
                       "peak_hbm_bytes_per_s": None}
    if not torch.cuda.is_available():
        assert accelerator.device_name() == "cpu"
        assert accelerator.chip_spec()["chip"] == "cpu"


def test_device_memory_absent_on_cpu_and_train_step_recorded():
    """No card: sample_device_memory records nothing (no gauge sample,
    no zero).  A 2-step CPU fit registers train.step with 6 x params x
    tokens plus causal attention against the train.compute span."""
    if torch.cuda.is_available():
        pytest.skip("the CPU's answer: this host has a card")
    assert xprof.sample_device_memory() == {}
    assert "raytpu_device_hbm_bytes_in_use{" not in \
        metrics.export_prometheus()
    from ray_tpu_torch import train

    xprof.clear()
    cfg = dataclasses.replace(CFG, remat=False)
    trainer = train.TorchTrainer(
        init_params=lambda g: tl.init_params(g, cfg, device="cpu"),
        loss_fn=lambda p, b: tl.loss_fn(p, b, cfg),
        scaling_config=train.ScalingConfig(devices=["cpu"]),
        run_config=train.RunConfig(report_every=1))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}
    res = trainer.fit(iter([batch, batch]), num_steps=2)
    assert res.error is None
    rec = xprof.programs()["train.step"]
    n = sum(t.numel() for t in _leaves(trainer.state.params))
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.head_dim * 16 * 32 / 2
    assert rec.flops == 6 * n * 32 + attn
    assert rec.span_name == "train.compute" and rec.compile_time_s > 0
    assert "raytpu_device_hbm_bytes_in_use{" not in \
        metrics.export_prometheus()
    xprof.clear()
