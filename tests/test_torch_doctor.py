"""The port's invariant audit plane against the JAX package's
(tests/test_doctor.py): the report's shape and the engine checks equal
the JAX auditor's, a clean engine deep-audits to zero violations, and
each RAYTPU_FAILPOINTS corruption injector is found under the check names
the JAX tests expect.  LLAMA_TINY in f32; no JAX engine runs here."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from ray_tpu.serve import audit as jaudit
from ray_tpu.util import doctor as jdoctor
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import segmented_lora as tsl
from ray_tpu_torch.serve import audit
from ray_tpu_torch.serve import llm_engine as teng
from ray_tpu_torch.util import doctor, flight_recorder, metrics

CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
PAGE = 16


@pytest.fixture(scope="module")
def params():
    return tl.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")


def _engine(params, cfg=CFG, **kw):
    ecfg = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
                page_size=PAGE, ragged_batching=True, token_budget=36)
    ecfg.update(kw)
    return teng.LLMEngine(params, teng.llama_paged_adapter(cfg),
                          teng.EngineConfig(**ecfg), device="cpu")


def _violations_total(check):
    total = 0.0
    for fam, _typ, _help, samples in metrics.snapshot_samples():
        if fam == "raytpu_doctor_violations_total":
            total += sum(s[2] for s in samples if ("check", check) in s[1])
    return total


def _violated_checks(report):
    return {v["check"] for row in report["checks"] for v in row["violations"]}


@pytest.fixture
def dump_dir(tmp_path):
    """Flight-recorder auto-dump into a fresh directory, rate limit off."""
    d = tmp_path / "flightrec"
    d.mkdir()
    flight_recorder.configure(dump_dir=str(d), auto_dump=True,
                              min_dump_interval_s=0.0)
    yield str(d)
    flight_recorder.configure(dump_dir="", min_dump_interval_s=2.0)


def _manifest_details(dump_dir):
    out = set()
    for path in glob.glob(os.path.join(dump_dir, "flightrec-*")):
        with open(os.path.join(path, "manifest.json")) as f:
            out.add(json.load(f).get("detail"))
    return out


def test_report_shape_and_checks_match_jax():
    """run_audit's report and row keys are the JAX doctor's; the engine
    checks are the JAX auditor's, with the same versions, tiers and
    severities."""
    cd = doctor.register_check("test.torch_shape", 1, doctor.DEEP, "error",
                               "test-only check")
    jcd = jdoctor.register_check("test.torch_shape", 1, jdoctor.DEEP,
                                 "error", "test-only check")
    bad = dict(subject="unit-7", expected=0, actual=1)
    got = doctor.run_audit("p", [(cd, lambda: [doctor.InvariantViolation(
        "test.torch_shape", "error", **bad)])], deep=True)
    want = jdoctor.run_audit("p", [(jcd, lambda: [jdoctor.InvariantViolation(
        "test.torch_shape", "error", **bad)])], deep=True)
    assert set(got) == set(want)
    assert set(got["checks"][0]) == set(want["checks"][0])
    assert set(got["checks"][0]["violations"][0]) == \
        set(want["checks"][0]["violations"][0])
    assert got["violations"] == want["violations"] == 1
    merged = doctor.merge_reports([got, None], deep=True)
    assert set(merged) == set(jdoctor.merge_reports([want], deep=True))

    def fields(cd):
        return (cd.version, cd.tier, cd.severity)

    jchecks = {n: fields(c) for n, c in jaudit.CHECKS.items()}
    assert {n: fields(c) for n, c in audit.CHECKS.items()} == jchecks


def test_clean_engine_deep_audit_zero_violations(params):
    """Spec and prefix-cache traffic, then a deep audit: every engine
    check runs, none fires; the report is the engine's last."""
    eng = _engine(params, spec_decode=True, prefix_cache=True)
    try:
        rng = np.random.default_rng(3)
        shared = rng.integers(1, 127, size=PAGE).tolist()
        for _ in range(3):
            tail = rng.integers(1, 127, size=4).tolist()
            eng.generate(shared + tail, max_new_tokens=8)
        assert eng.stats()["prefix"]["hit_tokens"] > 0
        report = eng.doctor(deep=True)
        assert report["violations"] == 0, report
        ran = {row["check"] for row in report["checks"]}
        assert {"kv.page_conservation", "kv.pool_partition",
                "kv.trie_integrity", "spec.draft_conservation",
                "spec.draft_partition", "slots.table",
                "ring.terminal_slots"} <= ran
        assert eng.doctor_report() is report
        assert eng.doctor(deep=False)["checks_run"] == 4
    finally:
        eng.shutdown()


def test_adapter_pool_audits_clean(params):
    """A LoRA engine after adapter traffic: the adapter pool's partition
    and block refcounts recount clean from its audit snapshot."""
    cfg = dataclasses.replace(CFG, lora=tsl.LoRAConfig(rank=4, alpha=8.0))
    lp = tl.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    eng = _engine(lp, cfg)
    try:
        for aid in ("a", "b", ""):
            eng.generate([1, 2, 3, 4], max_new_tokens=3, adapter_id=aid)
        snap = eng._adapters.audit_snapshot()
        assert set(snap) == {"num_pages", "pages_per_adapter", "free",
                             "blocks", "entries"}
        assert sorted(snap["entries"]) == ["a", "b"]
        report = eng.doctor(deep=True)
        assert report["violations"] == 0, report
        assert {"adapter.pool_partition", "adapter.block_refs",
                "adapter.borrow_balance"} <= {r["check"]
                                              for r in report["checks"]}
        assert eng.adapter_summary() == {"adapters": ["a", "b"]}
    finally:
        eng.shutdown()


def test_doctor_after_stop_runs_inline(params):
    eng = _engine(params)
    eng.generate([1, 2, 3], max_new_tokens=2)
    eng.shutdown()
    report = eng.doctor(deep=True)  # the loop is gone: audits inline
    assert report["violations"] == 0, report


def test_trie_ref_leak_detected(params, monkeypatch, dump_dir):
    """Armed doctor.leak_trie_ref skips one borrowed-page release: the
    deep audit's trie refcount recount finds the phantom ref, the
    violation counter moves, and a bundle manifest names the check."""
    eng = _engine(params, prefix_cache=True)
    try:
        rng = np.random.default_rng(5)
        shared = rng.integers(1, 127, size=2 * PAGE).tolist()
        eng.generate(shared + [1, 2], max_new_tokens=2)  # donates, unarmed
        before = _violations_total("kv.trie_integrity")
        monkeypatch.setenv("RAYTPU_FAILPOINTS", "doctor.leak_trie_ref:1")
        eng.generate(shared + [3, 4], max_new_tokens=2)  # leaks one ref
        report = eng.doctor(deep=True)
        assert "kv.trie_integrity" in _violated_checks(report), report
        assert _violations_total("kv.trie_integrity") > before
        assert _manifest_details(dump_dir) & {"kv.trie_integrity",
                                              "kv.borrow_balance"}
    finally:
        monkeypatch.delenv("RAYTPU_FAILPOINTS", raising=False)
        eng.shutdown()


def test_draft_page_leak_detected(params, monkeypatch, dump_dir):
    """Armed doctor.leak_draft_page skips one draft-page free on slot
    release: the draft-pool walks report the unowned page."""
    eng = _engine(params, spec_decode=True)
    try:
        before = _violations_total("spec.draft_partition")
        monkeypatch.setenv("RAYTPU_FAILPOINTS", "doctor.leak_draft_page:1")
        assert len(eng.generate([5, 6, 7, 8], max_new_tokens=12)) == 12
        report = eng.doctor(deep=True)
        violated = _violated_checks(report)
        assert {"spec.draft_partition", "spec.draft_conservation"} \
            <= violated, report
        assert _violations_total("spec.draft_partition") > before
        assert _manifest_details(dump_dir) & {"spec.draft_partition",
                                              "spec.draft_conservation"}
    finally:
        monkeypatch.delenv("RAYTPU_FAILPOINTS", raising=False)
        eng.shutdown()
