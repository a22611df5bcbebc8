"""The port's multi-tenant LoRA against ray_tpu on the CPU: the segmented
delta and the pool gathers (``ops/segmented_lora.py``), the adapter pool
(``serve/adapter_pool.py``), the segmented-LoRA ragged step, and the
engine's mixed-adapter streams on LLAMA_TINY in f32.

Both packages load adapters through one ``lora_loader`` built from a
numpy seed (their default loaders draw from different generators).  The
JAX engine runs once for the module.  Tolerances: f32 products in another
summation order agree to 1e-5 (deltas) and 1e-4 (model steps); bf16
deltas to 2e-2 relative (one bf16 rounding of the same f32 sums)."""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import segmented_lora as jsl
from ray_tpu.serve import adapter_pool as jap
from ray_tpu.serve import llm_engine as jeng
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import ragged_paged_attention as trpa
from ray_tpu_torch.ops import segmented_lora as tsl
from ray_tpu_torch.serve import adapter_pool as tap
from ray_tpu_torch.serve import llm_engine as teng

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
J_LORA = jsl.LoRAConfig(rank=4, alpha=8.0)
T_LORA = tsl.LoRAConfig(rank=4, alpha=8.0)
J_LCFG = dataclasses.replace(J_CFG, lora=J_LORA)
T_LCFG = dataclasses.replace(T_CFG, lora=T_LORA)
PAGE_ELEMS = 1024
STEP_TOL = 1e-4
ENGINE = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
              page_size=16, ragged_batching=True, token_budget=36,
              adapter_page_elems=PAGE_ELEMS)
REQS = [([1, 2, 3], "tenant-a"), ([4, 5, 6, 7], "tenant-b"),
        ([9, 3, 1], ""), ([2, 8, 5], "tenant-a"), ([7, 7, 2, 9], "tenant-c")]


def np_adapter(adapter_id: str):
    """The shared loader: factors drawn by numpy from crc32(id)."""
    rng = np.random.default_rng(zlib.crc32(adapter_id.encode()))
    out = {}
    for t, (din, dout) in jsl.target_shapes(J_CFG, J_LORA).items():
        L, r = J_CFG.n_layers, J_LORA.rank
        out[t] = {"a": (rng.standard_normal((L, din, r)) * din ** -0.5
                        ).astype(np.float32),
                  "b": (rng.standard_normal((L, r, dout)) * r ** -0.5
                        ).astype(np.float32)}
    return out


def t_loader(adapter_id):
    return bridge.adapter_from_jax(np_adapter(adapter_id), device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def jax_streams(params):
    """The JAX engine's greedy streams of REQS, all submitted at once."""
    jp, _ = params
    eng = jeng.LLMEngine(jp, jeng.llama_paged_adapter(J_LCFG, np_adapter),
                         jeng.EngineConfig(**ENGINE))
    try:
        streams = [eng.submit(p, max_new_tokens=8, temperature=0.0,
                              adapter_id=a) for p, a in REQS]
        return [s.result(timeout_s=300) for s in streams]
    finally:
        eng.shutdown()


def _port_engine(tp, cfg=T_LCFG, **kw):
    return teng.LLMEngine(tp, teng.llama_paged_adapter(cfg, t_loader),
                          teng.EngineConfig(**{**ENGINE, **kw}),
                          device="cpu")


def _serve(eng, reqs, n=8):
    try:
        streams = [eng.submit(p, max_new_tokens=n, temperature=0.0,
                              adapter_id=a) for p, a in reqs]
        return [s.result(timeout_s=120) for s in streams], streams, \
            eng.stats()
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# ops/segmented_lora
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmented_lora_delta_matches_jax(dtype):
    rng = np.random.default_rng(0)
    T, din, dout, K, r = 11, 24, 20, 3, 4
    x = rng.standard_normal((T, din)).astype(np.float32)
    a = rng.standard_normal((K, din, r)).astype(np.float32)
    b = rng.standard_normal((K, r, dout)).astype(np.float32)
    a[0], b[0] = 0.0, 0.0                     # the null adapter
    idx = np.asarray([0, 1, 2, 2, 0, 1, 1, 0, 2, 1, 0], np.int32)
    jd = np.asarray(jsl.segmented_lora_delta(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(b), jnp.asarray(idx),
        1.7, getattr(jnp, dtype)).astype(jnp.float32))
    td = tsl.segmented_lora_delta(
        *(torch.from_numpy(t) for t in (x, a, b, idx)), 1.7,
        getattr(torch, dtype))
    assert td.dtype == getattr(torch, dtype) and td.shape == (T, dout)
    td = td.float().numpy()
    assert (td[idx == 0] == 0).all() and (jd[idx == 0] == 0).all()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(td, jd, rtol=tol, atol=tol * np.abs(jd).max())


def test_adapter_layout_matches_jax():
    ad = np_adapter("x")
    assert tsl.adapter_elems(T_CFG, T_LORA) == jsl.adapter_elems(J_CFG,
                                                                 J_LORA)
    assert tsl.target_shapes(T_CFG, T_LORA) == jsl.target_shapes(J_CFG,
                                                                 J_LORA)
    np.testing.assert_array_equal(
        tsl.flatten_adapter(bridge.adapter_from_jax(ad, device="cpu"),
                            T_CFG, T_LORA),
        jsl.flatten_adapter(ad, J_CFG, J_LORA))
    with pytest.raises(ValueError, match="targets"):
        tsl.LoRAConfig(targets=("qkv", "bogus"))
    # The default loader is deterministic per id (its draws differ from
    # the JAX package's: torch's generator, not jax.random).
    load = tsl.default_adapter_loader(T_CFG, T_LORA)
    one, two = load("tenant-a"), load("tenant-a")
    assert all(torch.equal(one[t][f], two[t][f]) for t in one for f in "ab")
    assert not torch.equal(one["o"]["a"], load("tenant-b")["o"]["a"])


@pytest.mark.parametrize("int8", [False, True])
def test_pool_pages_and_gathers_match_jax(int8):
    """The same adapters loaded into both pools: f32 pages equal; int8
    pages within 1 ulp of scale and one int8 step (the JAX quantiser runs
    under jit, where / 127 is a reciprocal product); the gathered flat
    rows and per-layer stacks agree."""
    kw = dict(num_pages=0, page_elems=PAGE_ELEMS, max_batch_adapters=4,
              int8=int8)
    jpool = jap.AdapterPool(J_CFG, J_LORA, loader=np_adapter, **kw)
    tpool = tap.AdapterPool(T_CFG, T_LORA, loader=t_loader, device="cpu",
                            **kw)
    ids = ["u", "v", "w"]
    for aid in ids:
        jpool.acquire(aid)
        tpool.acquire(aid)
    jt, tt = jpool.page_table(ids[:2]), tpool.page_table(ids[:2])
    np.testing.assert_array_equal(tt, jt)
    if int8:
        jq, js = (np.asarray(jpool.device_pool[k]) for k in ("q", "scale"))
        tq, ts = (tpool.device_pool[k].numpy() for k in ("q", "scale"))
        np.testing.assert_array_max_ulp(ts, js, maxulp=1)
        assert np.abs(tq.astype(int) - jq.astype(int)).max() <= 1
        assert (tq[-1] == 0).all()                        # scratch page
    else:
        np.testing.assert_array_equal(tpool.device_pool.numpy(),
                                      np.asarray(jpool.device_pool))
    jflat = np.asarray(jsl.gather_adapter_flat(jpool.device_pool,
                                               jnp.asarray(jt)))
    tflat = tsl.gather_adapter_flat(tpool.device_pool, torch.from_numpy(tt))
    np.testing.assert_allclose(tflat.numpy(), jflat, rtol=1e-2 if int8 else 0,
                               atol=0.02 * np.abs(jflat).max() if int8 else 0)
    assert (tflat[0] == 0).all() and (tflat[3] == 0).all()  # null, unused
    jst = jsl.gather_adapter_stacks(jnp.asarray(jflat), J_CFG, J_LORA)
    tst = tsl.gather_adapter_stacks(torch.from_numpy(jflat.copy()), T_CFG,
                                    T_LORA)
    for t in jst:
        for f in ("a", "b"):
            assert tst[t][f].shape == jst[t][f].shape
            np.testing.assert_array_equal(tst[t][f].numpy(),
                                          np.asarray(jst[t][f]))


# ---------------------------------------------------------------------------
# the pool's allocator rules (the JAX package's tests, on the port's pool)
# ---------------------------------------------------------------------------

def test_eviction_never_takes_a_borrowed_adapter():
    pp = tap.AdapterPool(T_CFG, T_LORA, page_elems=PAGE_ELEMS,
                         device="cpu").pages_per_adapter
    pool = tap.AdapterPool(T_CFG, T_LORA, page_elems=PAGE_ELEMS,
                           num_pages=2 * pp, device="cpu")
    pool.acquire("a")
    pool.acquire("b")
    assert pool.stats()["pages_free"] == 0
    with pytest.raises(tap.AdapterPoolPressure):
        pool.acquire("c")  # both resident sets borrowed: nothing to evict
    assert pool.resident_ids() == ["a", "b"]
    pool.acquire("a")      # a second borrow is a hit, not an upload
    assert pool.refcount("a") == 2 and pool.stats()["hits"] == 1
    pool.release("a")
    pool.release("b")
    pool.acquire("c")      # evicts b (refcount 0), never the borrowed a
    assert pool.stats()["evictions"] == 1
    assert pool.resident_ids() == ["a", "c"] and pool.refcount("a") == 1
    pool.release("c")
    pool.release("a")
    with pytest.raises(RuntimeError, match="underflow"):
        pool.release("a")
    misses = pool.stats()["misses"]
    pool.acquire("b")      # known hash, pages evicted: a fresh miss
    assert pool.stats()["misses"] == misses + 1
    pool.release("b")
    with pytest.raises(ValueError, match="max_batch_adapters"):
        pool.page_table(["a", "b", "c", "d", "e", "f", "g", "h"])


def test_content_hash_dedup_shares_one_upload():
    same = t_loader("shared")
    pool = tap.AdapterPool(T_CFG, T_LORA, page_elems=PAGE_ELEMS,
                           loader=lambda _aid: same, device="cpu")
    pool.acquire("x")
    free = pool.stats()["pages_free"]
    pool.acquire("y")
    st = pool.stats()
    assert st["pages_free"] == free and st["hits"] == 1 \
        and st["misses"] == 1
    assert pool.resident_ids() == ["x", "y"]
    np.testing.assert_array_equal(pool.page_table(["x"])[1],
                                  pool.page_table(["y"])[1])


# ---------------------------------------------------------------------------
# the model step
# ---------------------------------------------------------------------------

def test_lora_ragged_step_matches_jax(params):
    """One mixed step (a prompt row of adapter 1, a null row, a prompt
    row of adapter 2) through both packages' segmented-LoRA body, with a
    verify gather (``logit_idx``): logits within STEP_TOL, pools too;
    the null row equals the port's base step bit for bit."""
    jp, tp = params
    page, num_pages, T, R = 16, 12, 48, 4
    rng = np.random.default_rng(4)
    rows = [dict(slot=0, start=0, tokens=rng.integers(1, 250, 9).tolist(),
                 adapter=1),
            dict(slot=1, start=0, tokens=rng.integers(1, 250, 20).tolist(),
                 adapter=0),
            dict(slot=2, start=0, tokens=rng.integers(1, 250, 6).tolist(),
                 adapter=2)]
    bt = np.full((3, 4), num_pages, np.int32)
    bt[0, :1], bt[1, :2], bt[2, :1] = [3], [7, 1], [10]
    packed = trpa.pack_ragged_batch(rows, T, R, with_adapters=True)
    (htoks, _dm, _ts, tpos, rslot, rstart, rlen, roff, tada) = packed
    logit_idx = np.asarray([2, 8, 28, 30, 34], np.int32)
    flat = np.zeros((3, tsl.adapter_elems(T_CFG, T_LORA)), np.float32)
    flat[1] = jsl.flatten_adapter(np_adapter("p"), J_CFG, J_LORA)
    flat[2] = jsl.flatten_adapter(np_adapter("q"), J_CFG, J_LORA)
    jst = jsl.gather_adapter_stacks(jnp.asarray(flat), J_CFG, J_LORA)
    tst = tsl.gather_adapter_stacks(torch.from_numpy(flat), T_CFG, T_LORA)
    jc = jl.init_paged_cache(J_CFG, num_pages, page)
    tc = tl.init_paged_cache(T_CFG, num_pages, page, device="cpu")
    args = (htoks, tpos, rslot, rstart, rlen, roff, bt)
    jl_r, jl_v, jc = jax.jit(jl.ragged_step_paged, static_argnums=(8,))(
        jp, *(jnp.asarray(a) for a in args), J_LCFG, jc,
        lora=(jst, jnp.asarray(tada), J_LORA.scale),
        logit_idx=jnp.asarray(logit_idx))
    tl_r, tl_v, tc = tl.ragged_step_paged(
        tp, *(torch.from_numpy(a) for a in args), T_LCFG, tc,
        lora=(tst, torch.from_numpy(tada), T_LORA.scale),
        logit_idx=torch.from_numpy(logit_idx))
    live = rlen > 0
    np.testing.assert_allclose(tl_r.numpy()[live], np.asarray(jl_r)[live],
                               rtol=STEP_TOL, atol=STEP_TOL)
    np.testing.assert_allclose(tl_v.numpy(), np.asarray(jl_v),
                               rtol=STEP_TOL, atol=STEP_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy()[:, :, :num_pages],
                                   np.asarray(jc[key])[:, :, :num_pages],
                                   rtol=STEP_TOL, atol=STEP_TOL)
    base, _ = tl.ragged_step_paged(
        tp, *(torch.from_numpy(a) for a in args), T_CFG,
        tl.init_paged_cache(T_CFG, num_pages, page, device="cpu"))
    assert torch.equal(tl_r[1], base[1])     # the null row
    assert not torch.allclose(tl_r[0], base[0])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_mixed_adapter_streams_match_jax_engine(params, jax_streams):
    _, tp = params
    got, streams, st = _serve(_port_engine(tp), REQS)
    assert got == jax_streams
    assert all(len(g) == 8 for g in got)
    # Distinct adapters give distinct continuations (else the parity
    # above proves little): tenant-a and tenant-b on one prompt.
    other, _, _ = _serve(_port_engine(tp), [(REQS[0][0], "tenant-b")])
    assert other[0] != got[0]
    pool = st["adapters"]
    assert pool["borrowed_refs"] == 0 and pool["misses"] == 3 \
        and pool["hits"] >= 1
    assert st["kv_pages_free"] == 4 * 8


def test_spec_beside_lora_rows_match_jax_engine(params, jax_streams):
    """Base rows speculate inside steps that also carry adapter rows
    (which decode plainly): every stream equals the JAX engine's, the
    engine speculated, and no adapter request drafted."""
    _, tp = params
    got, streams, st = _serve(_port_engine(tp, spec_decode=True), REQS)
    assert got == jax_streams
    assert st["spec"]["rounds"] > 0
    for s, (_p, aid) in zip(streams, REQS):
        assert (s._req.spec_drafted == 0) == bool(aid)


@pytest.mark.parametrize("adapter_int8", [False, True])
def test_null_adapter_byte_identical_to_adapter_off(params, adapter_int8):
    _, tp = params
    prompts = [[1, 2, 3], [4, 5, 6, 7], [9, 3, 1]]
    want, _, _ = _serve(_port_engine(tp, cfg=T_CFG),
                        [(p, "") for p in prompts])
    got, _, _ = _serve(_port_engine(tp, adapter_int8=adapter_int8),
                       [(p, "") for p in prompts])
    assert got == want
    mixed, _, st = _serve(_port_engine(tp, adapter_int8=adapter_int8),
                          list(zip(prompts, ("", "tenant-a", ""))))
    assert mixed[0] == want[0] and mixed[2] == want[2]
    assert mixed[1] != want[1]     # the adapter row did change
    assert st["adapters"]["misses"] == 1


def test_adapter_admission_errors_and_pressure(params):
    """An adapter id on a base engine raises at submit; a loader error
    fails that request only; pool pressure (every resident adapter
    borrowed) holds a request in the backlog until a borrow drains.
    LoRA without the ragged step raises, as in the JAX package."""
    _, tp = params
    base = _port_engine(tp, cfg=T_CFG)
    try:
        with pytest.raises(ValueError, match="adapter"):
            base.submit([1, 2], adapter_id="tenant-a")
    finally:
        base.shutdown()

    def loader(aid):
        if aid == "broken":
            raise OSError("no such checkpoint")
        return t_loader(aid)

    pp = tap.AdapterPool(T_CFG, T_LORA, page_elems=PAGE_ELEMS,
                         device="cpu").pages_per_adapter
    eng = teng.LLMEngine(
        tp, teng.llama_paged_adapter(T_LCFG, loader),
        teng.EngineConfig(**{**ENGINE, "adapter_pool_pages": pp}),
        device="cpu")
    try:
        bad = eng.submit([1, 2, 3], max_new_tokens=4, adapter_id="broken")
        first = eng.submit([1, 2, 3], max_new_tokens=6, adapter_id="a")
        second = eng.submit([4, 5, 6], max_new_tokens=6, adapter_id="b")
        with pytest.raises(RuntimeError, match="load failed"):
            bad.result(timeout_s=60)
        assert len(first.result(timeout_s=60)) == 6
        assert len(second.result(timeout_s=60)) == 6
        # b waited for a's borrow to drain, then evicted it.
        assert second._req.first_token_at > first._req.finished_at
        st = eng.stats()["adapters"]
        assert st["evictions"] == 1 and st["borrowed_refs"] == 0
    finally:
        eng.shutdown()
    with pytest.raises(ValueError, match="ragged"):
        teng.LLMEngine(tp, teng.llama_paged_adapter(T_LCFG),
                       teng.EngineConfig(max_slots=2, max_seq_len=64,
                                         page_size=16), device="cpu")
