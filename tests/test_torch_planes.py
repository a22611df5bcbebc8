"""The port engine's serving planes against the JAX engine's on LLAMA_TINY
in f32, with the same weights (crossed through the numpy bridge) and the
same traffic: request-ring state sequences and terminal causes, terminal
and SLO counts under bounds met or missed by a wide margin, goodput, the
exposition's families, the stall watermark, shedding, drain with
resumable continuations, the exceptions' pickling, the trainer's
families, and no device→host sync added per decode step.

One JAX engine serves the whole file (ragged, one compiled program)."""

import dataclasses
import importlib.util
import pathlib
import pickle
import queue
import time
import types
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.core import exceptions as jexc
from ray_tpu.models import llama as jl
from ray_tpu.serve import llm_engine as jeng
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch import bridge
from ray_tpu_torch.core import exceptions as texc
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.serve import llm_engine as teng
from ray_tpu_torch.util import metrics as tmetrics

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
# One slot, so a second request queues behind the first; a tpot bound
# that every request of two or more tokens meets by nine orders of
# magnitude and every one-token request misses (no tpot to take).
RAGGED_KW = dict(max_slots=1, max_seq_len=128, min_prefill_bucket=16,
                 page_size=16, ragged_batching=True, token_budget=36)
SLO_BOUND = 1e9

# The families the request plane pins (tests/test_request_plane.py).
REQUEST_FAMILIES = ["raytpu_serve_request_itl_seconds",
                    "raytpu_serve_request_slo_total",
                    "raytpu_serve_request_terminal_total",
                    "raytpu_serve_goodput_ratio",
                    "raytpu_serve_requests"]


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def engines(params):
    """(JAX engine, port engine) on the same config and weights."""
    jp, tp = params
    j = jeng.LLMEngine(jp, jeng.llama_paged_adapter(J_CFG), jeng.EngineConfig(
        **RAGGED_KW, slo=jeng.SLO(tpot_s=SLO_BOUND)))
    t = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG), teng.EngineConfig(
        **RAGGED_KW, slo=teng.SLO(tpot_s=SLO_BOUND)), device="cpu")
    yield j, t
    j.shutdown()
    t.shutdown()


def _samples(text):
    """{(sample name, sorted label pairs): value} of an exposition."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_labels, value = line.rsplit(" ", 1)
        name, _, labels = name_labels.partition("{")
        pairs = tuple(sorted(p for p in labels.rstrip("}").split(",") if p))
        out[(name, pairs)] = float(value)
    return out


def _delta(before, after, name, **labels):
    key = (name, tuple(sorted(f'{k}="{v}"' for k, v in labels.items())))
    return after.get(key, 0.0) - before.get(key, 0.0)


def _families(text):
    """{family: (type, label keys of its samples)} of an exposition."""
    fams, keys = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, typ = line.split()
            fams[name] = typ
        elif line and not line.startswith("#"):
            name, _, labels = line.rsplit(" ", 1)[0].partition("{")
            fam = next((f for f in (name, name.rsplit("_", 1)[0])
                        if f in fams), name)
            keys.setdefault(fam, set()).update(
                p.split("=", 1)[0] for p in labels.rstrip("}").split(",")
                if p and not p.startswith("le="))
    return {f: (typ, frozenset(keys.get(f, ()))) for f, typ in fams.items()}


def _traffic(eng, long_prompt):
    """Three requests one after the other, then a cancelled running one
    and a cancelled queued one.  Returns (streams, goodput after the
    three finishes)."""
    done = [eng.submit([5, 6, 7, 8], max_new_tokens=6),
            eng.submit([9, 10], max_new_tokens=1),
            eng.submit(long_prompt, max_new_tokens=10)]
    for s in done:
        s.result(timeout_s=300)
    goodput = eng.goodput_ratio()
    hog = eng.submit([1, 2, 3], max_new_tokens=500)
    it = iter(hog)
    next(it)  # the hog holds the only slot and is decoding
    starved = eng.submit([4, 5, 6], max_new_tokens=4)
    starved.cancel()
    starved.result(timeout_s=300)
    hog.cancel()
    hog.result(timeout_s=300)
    return done + [hog, starved], goodput


def test_ring_terminals_slo_and_goodput_match_jax(engines):
    j, t = engines
    long_prompt = list(np.random.default_rng(0).integers(1, 250, 124))
    rows, counts, goodputs = [], [], []
    for eng, reg in ((j, jmetrics), (t, tmetrics)):
        before = _samples(reg.export_prometheus())
        streams, goodput = _traffic(eng, long_prompt)
        after = _samples(reg.export_prometheus())
        rows.append([eng._ring.row(s.request_id) for s in streams])
        goodputs.append(goodput)
        counts.append({
            **{st: _delta(before, after,
                          "raytpu_serve_request_terminal_total", state=st)
               for st in ("FINISHED", "CANCELLED", "FAILED", "SHED")},
            **{oc: _delta(before, after, "raytpu_serve_request_slo_total",
                          outcome=oc) for oc in ("met", "missed")}})
        # The cancelled hog's tokens count as terminal tokens, none good.
        hog_tokens = len(streams[3].result())
        assert eng.goodput_ratio() == pytest.approx(10 / (11 + hog_tokens))
    jrows, trows = rows
    for jr, tr in zip(jrows, trows):
        assert list(tr["state_ts"]) == list(jr["state_ts"]), (jr, tr)
        assert tr["terminal_cause"] == jr["terminal_cause"]
        assert tr["slot"] == jr["slot"] and tr["num_pages"] == jr["num_pages"]
    assert [r["terminal_cause"] for r in trows] == [
        "max_new_tokens", "max_new_tokens", "max_seq_len", "cancelled",
        "cancelled"]
    assert list(trows[4]["state_ts"]) == ["QUEUED", "CANCELLED"]
    assert [r["generated_tokens"] for r in trows[:3]] == [6, 1, 4]
    assert counts[1] == counts[0] == {"FINISHED": 3, "CANCELLED": 2,
                                      "FAILED": 0, "SHED": 0, "met": 2,
                                      "missed": 3}
    # Tokens of SLO-met requests (6 + 4) over all terminal tokens.
    assert goodputs[1] == goodputs[0] == pytest.approx(10 / 11)
    assert t.stats()["requests"] == j.stats()["requests"]


def test_exposition_families_match_jax(engines):
    """The port declares the JAX engine's families (KV migration and the
    latency waterfall included) but the TP collectives', a plane it does
    not have yet, with the same types and label keys, and its exposition
    passes the repo's metric checks."""
    skipped = {"raytpu_serve_collective_bytes_total",
               "raytpu_serve_collective_seconds"}
    want = {(m.name, m._type, m.tag_keys)
            for m in jeng._telemetry().values() if m.name not in skipped}
    got = {(m.name, m._type, m.tag_keys) for m in teng._telemetry().values()}
    assert got == want
    ttext = tmetrics.export_prometheus()
    jfams, tfams = _families(jmetrics.export_prometheus()), _families(ttext)
    serving = [f for f in tfams if f.startswith(
        ("raytpu_serve_", "raytpu_doctor_", "raytpu_flightrec_"))]
    assert {m[0] for m in got} <= set(serving)
    for fam in serving:
        typ, keys = tfams[fam]
        assert jfams[fam][0] == typ, fam
        if keys and jfams[fam][1]:
            assert keys == jfams[fam][1], fam
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" \
        / "check_metrics.py"
    spec = importlib.util.spec_from_file_location("check_metrics", path)
    cm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cm)
    assert cm.check_exposition(ttext, require=REQUEST_FAMILIES) == []


class _Gauge:
    def __init__(self):
        self.value = None

    def set(self, v):
        self.value = v


def _shim(paged=True):
    """The state _note_step_time and _admission_queue_age touch, as in
    tests/test_stall_telemetry.py."""
    return types.SimpleNamespace(
        _step_walls=deque(maxlen=64), _step_wall_hw=0.0, _stall_events=0,
        _tm={"step_wall": _Gauge(), "queue_age": _Gauge()}, _slot_req={},
        _waiting=queue.Queue(), _backlog=[], _paged=paged)


def test_stall_watermark_and_queue_age_match_jax():
    walls = ([(0.008 + 0.0001 * i, 8) for i in range(20)] + [(0.080, 8)]
             + [(0.001, 1)] * 7 + [(1.0, 1), (1.0, 1)])
    jns, tns = _shim(), _shim()
    for wall, chunk in walls:
        want = jeng.LLMEngine._note_step_time(jns, wall, chunk)
        got = teng.LLMEngine._note_step_time(tns, wall, chunk)
        assert got == want
        assert tns._tm["step_wall"].value == jns._tm["step_wall"].value
    assert tns._stall_events == jns._stall_events == 3
    now = time.monotonic()
    for ns in (jns, tns):
        ns._waiting.put(types.SimpleNamespace(submitted_at=now - 2.0))
        ns._backlog.append(types.SimpleNamespace(submitted_at=now - 5.0))
    assert 4.9 < teng.LLMEngine._admission_queue_age(tns) < 6.0
    assert 4.9 < jeng.LLMEngine._admission_queue_age(jns) < 6.0


def _slow(adapter, seconds=0.01):
    """The paged adapter with every decode step slowed on the host."""
    def decode_slots(*a, **k):
        time.sleep(seconds)
        return adapter.decode_slots(*a, **k)

    return dataclasses.replace(adapter, decode_slots=decode_slots)


def test_shedding_is_deterministic(params):
    """One slot held by a slow stream, one request queued behind it: once
    the queued request is older than shed_queue_age_s (a 0.05 s sleep
    against a 0.02 s budget), the next submission is shed."""
    _, tp = params
    eng = teng.LLMEngine(tp, _slow(teng.llama_paged_adapter(T_CFG)),
                         teng.EngineConfig(max_slots=1, max_seq_len=128,
                                           min_prefill_bucket=16,
                                           page_size=16, decode_chunk=1,
                                           shed_queue_age_s=0.02),
                         device="cpu")
    before = _samples(tmetrics.export_prometheus())
    try:
        hog = eng.submit([1, 2, 3], max_new_tokens=100)
        it = iter(hog)
        next(it)
        queued = eng.submit([4, 5, 6], max_new_tokens=2)
        time.sleep(0.05)
        with pytest.raises(texc.ShedError) as err:
            eng.submit([7, 8, 9], request_id="shed-me")
        assert err.value.queue_age_s > 0.02
        assert eng.admission_queue_age() > 0.02
        assert eng.arrivals_total() == 3
        row = eng._ring.row("shed-me")
        assert list(row["state_ts"]) == ["SHED"]
        assert row["terminal_cause"] == "ShedError"
        hog.cancel()
        assert len(queued.result(timeout_s=120)) == 2
        hog.result(timeout_s=120)
    finally:
        eng.shutdown()
    after = _samples(tmetrics.export_prometheus())
    assert _delta(before, after, "raytpu_serve_shed_total") == 1
    assert _delta(before, after, "raytpu_serve_request_terminal_total",
                  state="SHED") == 1


def test_drain_in_flight_ragged_spec_continuations_are_delivered(params):
    """Ragged engine, speculative decoding on (self-draft): drain while
    steps are dispatched but unfetched.  Each stream's continuation holds
    exactly the tokens it delivered, the in-flight tails are dropped, and
    a deep audit afterwards is clean."""
    _, tp = params
    eng = teng.LLMEngine(tp, teng.llama_paged_adapter(T_CFG),
                         teng.EngineConfig(max_slots=3, max_seq_len=128,
                                           min_prefill_bucket=16,
                                           page_size=16, ragged_batching=True,
                                           token_budget=36, spec_decode=True),
                         device="cpu")
    pending_at_evict = []
    preempt = eng._preempt_request

    def spy(req, slot):
        pending_at_evict.append(len(eng._pending))
        preempt(req, slot)

    eng._preempt_request = spy
    try:
        streams = [eng.submit([3 + i, 9, 27, 4], max_new_tokens=100)
                   for i in range(3)]
        its = [iter(s) for s in streams]
        got = [[next(it)] for it in its]
        assert eng.drain(grace_s=0.0) == 3
        conts = []
        for it, toks in zip(its, got):
            with pytest.raises(texc.PreemptedError) as err:
                for tok in it:
                    toks.append(tok)
            conts.append(err.value.continuation)
        for cont, toks, s in zip(conts, got, streams):
            assert cont["tokens"] == toks
            assert len(toks) < 100
            assert s.result() == toks
        assert max(pending_at_evict) > 0  # steps were in flight
        report = eng.doctor(deep=True)
        assert report["violations"] == 0, report
        assert eng.stats()["requests"] == {"PREEMPTED": 3}
        assert eng.stats()["spec"]["draft_pages_free"] == eng._draft_pages
    finally:
        eng.shutdown()


def test_no_host_sync_added_per_decode_step(params):
    """Planes on, the decode path makes no device→host read of its own:
    over a run of decode steps on each engine kind, no Tensor.item /
    tolist / cpu / bool / int / float / index call (the parent tree made
    0 per step), and one numpy() per fetched entry (the fetch itself)."""
    _, tp = params
    names = ("item", "tolist", "cpu", "__bool__", "__int__", "__float__",
             "__index__")
    orig = {n: getattr(torch.Tensor, n) for n in names + ("numpy",)}
    kinds = {"bucketed": ({}, teng.llama_paged_adapter(T_CFG)),
             "ragged": (dict(ragged_batching=True, token_budget=36),
                        teng.llama_paged_adapter(T_CFG)),
             "dense": ({}, teng.llama_adapter(T_CFG))}
    for kind, (kw, adapter) in kinds.items():
        eng = teng.LLMEngine(tp, adapter, teng.EngineConfig(
            max_slots=4, max_seq_len=128, min_prefill_bucket=16,
            page_size=16, decode_chunk=1, slo=teng.SLO(ttft_s=SLO_BOUND),
            **kw), device="cpu")
        calls = dict.fromkeys(orig, 0)

        def counting(name):
            def call(self, *a, **k):
                calls[name] += 1
                return orig[name](self, *a, **k)
            return call

        try:
            eng.generate([1, 2, 3], max_new_tokens=2)
            steps0 = eng.stats()["steps"]
            for n in orig:
                setattr(torch.Tensor, n, counting(n))
            try:
                streams = [eng.submit([5 + i, 6, 7, 8], max_new_tokens=12)
                           for i in range(3)]
                for s in streams:
                    s.result(timeout_s=120)
            finally:
                for n, f in orig.items():
                    setattr(torch.Tensor, n, f)
            steps = eng.stats()["steps"] - steps0
        finally:
            eng.shutdown()
        assert steps >= 11, kind
        assert sum(calls[n] for n in names) / steps <= 0.0, (kind, calls)
        assert calls["numpy"] <= steps + 3, (kind, calls)


def test_exceptions_pickle_like_jax():
    cont = {"prompt": [1, 2], "tokens": [3], "temperature": 0.0,
            "request_id": "r", "adapter_id": ""}
    for t_err, j_err in (
            (texc.PreemptedError("drained", cont),
             jexc.PreemptedError("drained", cont)),
            (texc.ShedError(queue_age_s=0.25),
             jexc.ShedError(queue_age_s=0.25))):
        back = pickle.loads(pickle.dumps(t_err))
        assert type(back) is type(t_err)
        assert isinstance(back, texc.RayTpuError)
        assert str(back) == str(t_err) == str(j_err)
        for attr in ("reason", "continuation", "queue_age_s"):
            assert getattr(back, attr, None) == getattr(j_err, attr, None)


def _declared_families(path):
    """(name, type, tag keys) of every metric a module's ``_telemetry``
    declares, read from its source: importing the JAX trainer would import
    its checkpoint library (seconds) for a list of names."""
    import ast

    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "_telemetry")
    out = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("Counter", "Gauge", "Histogram")):
            tags = next((ast.literal_eval(k.value) for k in node.keywords
                         if k.arg == "tag_keys"), ())
            out.add((ast.literal_eval(node.args[0]), node.func.attr.lower(),
                     tuple(tags)))
    return out


def test_trainer_families_match_jax():
    """The trainer's six families as the JAX trainer declares them; a
    2-step CPU fit counts 2 steps, sets the optimizer-state gauge (global
    = per_device on one device), records the step spans, and leaves the
    memory-headroom gauge absent on the CPU."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import trainer as ttrainer
    from ray_tpu_torch.util import tracing

    got = {(m.name, m._type, m.tag_keys)
           for m in ttrainer._telemetry().values()}
    assert got == _declared_families(pathlib.Path(jeng.__file__).parent.parent
                                     / "train" / "trainer.py")

    def loss_fn(p, b):
        loss = ((b["x"] @ p["w"]) ** 2).mean()
        return loss, {}

    batch = {"x": np.ones((2, 4), np.float32)}
    trainer = train.TorchTrainer(
        init_params=lambda g: {"w": torch.ones(4, 3)}, loss_fn=loss_fn,
        scaling_config=train.ScalingConfig(devices=["cpu"]),
        run_config=train.RunConfig(report_every=1))
    before = _samples(tmetrics.export_prometheus())
    tracing.clear()
    tracing.enable_tracing()
    try:
        res = trainer.fit(iter([batch] * 2), num_steps=2)
    finally:
        tracing.disable_tracing()
    assert res.error is None
    after = _samples(tmetrics.export_prometheus())
    assert _delta(before, after, "raytpu_train_steps_total") == 2
    nbytes = 2 * 4 * 3 * 4  # mu and nu, f32 [4, 3]
    for scope in ("global", "per_device"):
        assert after[("raytpu_train_opt_state_bytes",
                      (f'scope="{scope}"',))] == nbytes
    assert not any(k[0] == "raytpu_train_hbm_headroom_bytes" for k in after)
    names = [s["name"] for s in tracing.finished_spans()]
    assert names.count("train.step") == 2
    assert names.count("train.data_wait") == names.count("train.compute") == 2
    tracing.clear()


def test_ambient_request_id_names_the_request(engines):
    """An id installed in the request_id context variable names a request
    submitted without one, as in the JAX engine."""
    from ray_tpu_torch.serve import request_events

    _, t = engines
    token = request_events.set_request_id("ambient-7")
    try:
        stream = t.submit([2, 4, 6], max_new_tokens=2)
    finally:
        request_events.reset_request_id(token)
    assert stream.request_id == "ambient-7"
    assert len(stream.result(timeout_s=120)) == 2
    assert t._ring.row("ambient-7")["state"] == "FINISHED"
    assert t.submit([2, 4, 6], max_new_tokens=1).request_id.startswith(
        t.engine_id + "-r")


def test_drain_preempts_with_resumable_continuation(params, engines):
    """tests/test_llm_engine.py's drain test on the port: a short grace,
    then eviction with a PreemptedError whose continuation resumes on a
    second engine to the undisturbed greedy stream, token for token; new
    submissions bounce while draining.  The continuation has the JAX
    engine's keys (read from the JAX engine's own draining bounce)."""
    j, _ = engines
    _, tp = params
    ecfg = teng.EngineConfig(max_slots=2, max_seq_len=128,
                             min_prefill_bucket=16, decode_chunk=1)
    eng = teng.LLMEngine(tp, _slow(teng.llama_adapter(T_CFG)), ecfg,
                         device="cpu")
    eng2 = teng.LLMEngine(tp, teng.llama_adapter(T_CFG), ecfg, device="cpu")
    try:
        want = eng2.generate([1, 2, 3], max_new_tokens=12)
        stream = eng.submit([1, 2, 3], max_new_tokens=12)
        it = iter(stream)
        got = [next(it)]
        assert eng.drain(grace_s=0.05) >= 1
        assert eng.draining
        with pytest.raises(texc.PreemptedError) as err:
            for tok in it:
                got.append(tok)
        cont = err.value.continuation
        assert cont["tokens"] == got and cont["prompt"] == [1, 2, 3]
        with pytest.raises(texc.PreemptedError) as bounced:
            eng.submit([4, 5], max_new_tokens=4)
        assert bounced.value.continuation["tokens"] == []
        rest = eng2.generate(cont["prompt"] + cont["tokens"],
                             max_new_tokens=12 - len(got))
        assert got + rest == want
    finally:
        eng.shutdown()
        eng2.shutdown()
    assert j.drain(grace_s=0.0) == 0
    with pytest.raises(jexc.PreemptedError) as jerr:
        j.submit([4, 5], max_new_tokens=4)
    assert set(cont) == set(jerr.value.continuation)
    assert set(bounced.value.continuation) == set(jerr.value.continuation)


def test_drain_idle_engine_is_immediate(params):
    _, tp = params
    eng = teng.LLMEngine(tp, teng.llama_adapter(T_CFG), teng.EngineConfig(
        max_slots=2, max_seq_len=128, min_prefill_bucket=16), device="cpu")
    try:
        t0 = time.monotonic()
        assert eng.drain(grace_s=30.0) == 0
        assert time.monotonic() - t0 < 5.0  # no grace wait when idle
    finally:
        eng.shutdown()
