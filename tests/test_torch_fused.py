"""The port's fused decode path against ray_tpu on the CPU: the plain
versions of K7 (``ops/fused_decode.fused_decode_layer``) and K8
(``ops/ragged_paged_attention.fused_ragged_layer``) against the JAX
Pallas kernels in interpret mode, then ``decode_slots_paged`` and
``ragged_step_paged`` with ``LlamaConfig(fused_decode=True)``, and the
port's engines serving an int8 fused artifact on int8 KV against the JAX
engine.

Inputs come from numpy seeds and cross as numpy arrays.  f32 compute on
both sides: the arithmetic and rounding points are the same, sums run in
another order, so one layer agrees within 1e-5 and a model step within
the 1e-4 of the other port tests.  In bf16 the fused kernels round their
norm, dot operands and probabilities as the Pallas kernels do; a bf16
layer agrees within 2e-2 (a few bf16 ulps of O(1) values, from sums
taken in another order before a rounding)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import quant as jq
from ray_tpu.ops import fused_decode as jfd
from ray_tpu.ops import ragged_paged_attention as jrpa
from ray_tpu.serve import llm_engine as jeng
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import fused_decode as tfd
from ray_tpu_torch.ops import ragged_paged_attention as trpa
from ray_tpu_torch.serve import llm_engine as teng

LAYER_TOL = 1e-5
STEP_TOL = 1e-4
BF16_TOL = 2e-2

J_CFG = jl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=jnp.float32, param_dtype=jnp.float32,
                       remat=False)
T_CFG = tl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=torch.float32, param_dtype=torch.float32,
                       remat=False)
H, KVH, D, HD, L = 4, 2, 64, 16, 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def weights():
    """Layer 1's subtree in three forms (numpy): f32 weights, separate
    int8 leaves, and the fused int8 artifact; and the three full trees."""
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    jqp = jq.quantize_params(jp)
    trees = {"f32": jp, "int8": jqp, "fused": jq.fuse_for_decode(jqp, J_CFG)}
    return {name: _np(tree) for name, tree in trees.items()}


def _layer(tree, i=1):
    return jax.tree.map(lambda a: a[i], tree["layers"])


def _pools(rng, int8, P, page, dtype=np.float32):
    shape = (L, KVH, P, page, HD)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.03, (L, P, KVH, 1)).astype(np.float32)
        vs = rng.uniform(0.005, 0.03, (L, P, KVH, 1)).astype(np.float32)
        return k, v, ks, vs
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype), None, None)


def _rope(positions):
    sin, cos = jl.rope_table(J_CFG, jnp.asarray(positions)[None])
    return np.asarray(sin)[0], np.asarray(cos)[0]


def _scales(ks, vs, conv):
    if ks is None:
        return {}
    return {"k_scales": conv(ks), "v_scales": conv(vs)}


# ---------------------------------------------------------------------------
# K7 plain version against the JAX kernel
# ---------------------------------------------------------------------------

def _k7_case(weights, form, int8_pools, soft_cap=None, bf16=False,
             seed=0):
    rng = np.random.default_rng(seed)
    B, page, maxp = 5, 16, 4
    P = B * maxp + 1
    k, v, ks, vs = _pools(rng, int8_pools, P, page)
    x = rng.standard_normal((B, D)).astype(np.float32)
    bt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray([0, 1, 17, 33, 60], np.int32)
    sin, cos = _rope(lengths)
    layer = _layer(weights[form])
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    tdt = torch.bfloat16 if bf16 else torch.float32
    jx, jk, jv = jnp.asarray(x, jdt), jnp.asarray(k), jnp.asarray(v)
    if bf16 and not int8_pools:
        jk, jv = jk.astype(jdt), jv.astype(jdt)
    want = jfd.fused_decode_layer(
        jx, jax.tree.map(jnp.asarray, layer), jk, jv, jnp.int32(1),
        *_j(bt, lengths, sin, cos), eps=1e-5, n_heads=H, n_kv_heads=KVH,
        soft_cap=soft_cap, **_scales(ks, vs, jnp.asarray))
    tk, tv = _t(k, v)
    if bf16 and not int8_pools:
        tk, tv = tk.to(tdt), tv.to(tdt)
    before = tfd.fused_decode_layer.launches
    got = tfd.fused_decode_layer(
        torch.from_numpy(x).to(tdt), bridge.params_from_jax(layer, "cpu"),
        tk, tv, 1, *_t(bt, lengths, sin, cos), eps=1e-5, n_heads=H,
        n_kv_heads=KVH, soft_cap=soft_cap,
        **_scales(ks, vs, torch.from_numpy))
    # CPU tensors take the plain version: no kernel launch is counted.
    assert tfd.fused_decode_layer.launches == before
    return want, got


@pytest.mark.parametrize("form", ["f32", "int8", "fused"])
@pytest.mark.parametrize("int8_pools", [False, True])
def test_k7_plain_matches_jax_kernel(weights, form, int8_pools):
    want, got = _k7_case(weights, form, int8_pools)
    for name, w, g in zip(("x_out", "k_new", "v_new"), want, got):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LAYER_TOL,
                                   rtol=LAYER_TOL, err_msg=name)


def test_k7_plain_matches_jax_kernel_soft_cap(weights):
    want, got = _k7_case(weights, "fused", True, soft_cap=2.0, seed=1)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)


def test_k7_plain_matches_jax_kernel_bf16(weights):
    """bf16 activations and pools over the fused int8 artifact."""
    want, got = _k7_case(weights, "fused", False, bf16=True, seed=2)
    for w, g in zip(want, got):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=BF16_TOL, rtol=BF16_TOL)


# ---------------------------------------------------------------------------
# K8 plain version against the JAX kernel
# ---------------------------------------------------------------------------

# (slot, start, len) per row: a prompt chunk over a pooled past, two
# decode rows (one with an empty past), a padding row; tokens 12..15 of
# the 16-token buffer belong to no row.
K8_ROWS = [(0, 20, 9), (1, 33, 1), (2, 0, 1), (3, 0, 0)]
K8_T = 16


def _k8_layout():
    offs, at = [], 0
    for _s, _st, n in K8_ROWS:
        offs.append(at)
        at += n
    rows = [np.asarray(c, np.int32) for c in zip(*K8_ROWS)]
    rows.append(np.asarray(offs, np.int32))
    tok_pos = np.zeros(K8_T, np.int32)
    for (_s, start, n), off in zip(K8_ROWS, offs):
        tok_pos[off:off + n] = start + np.arange(n)
    return rows, tok_pos, at


@pytest.mark.parametrize("form,int8_pools", [("f32", False), ("int8", True),
                                             ("fused", False),
                                             ("fused", True)])
def test_k8_plain_matches_jax_kernel(weights, form, int8_pools):
    rng = np.random.default_rng(5)
    page, maxp = 16, 4
    P = 4 * maxp + 1
    k, v, ks, vs = _pools(rng, int8_pools, P, page)
    x = rng.standard_normal((K8_T, D)).astype(np.float32)
    bt = rng.permutation(P - 1)[: 4 * maxp].reshape(4, maxp).astype(np.int32)
    (slot, start, n, off), tok_pos, covered = _k8_layout()
    sin, cos = _rope(tok_pos)
    layer = _layer(weights[form])
    want = jrpa.fused_ragged_layer(
        jnp.asarray(x), jax.tree.map(jnp.asarray, layer), *_j(k, v),
        jnp.int32(1), *_j(slot, start, n, off, bt, sin, cos), eps=1e-5,
        n_heads=H, n_kv_heads=KVH, **_scales(ks, vs, jnp.asarray))
    got = trpa.fused_ragged_layer(
        torch.from_numpy(x), bridge.params_from_jax(layer, "cpu"),
        *_t(k, v), 1, *_t(slot, start, n, off, bt, sin, cos), eps=1e-5,
        n_heads=H, n_kv_heads=KVH, **_scales(ks, vs, torch.from_numpy))
    # Uncovered tokens: their attention output is zero on both sides.
    for name, w, g in zip(("x_out", "k_new", "v_new"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=LAYER_TOL,
                                   rtol=LAYER_TOL, err_msg=name)
    assert covered < K8_T


# ---------------------------------------------------------------------------
# model steps with fused_decode=True
# ---------------------------------------------------------------------------

def _prefilled(jc, tc, jtree, ttree, page=16, num_pages=12):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 211, (3, 32)).astype(np.int32)
    lens = np.asarray([5, 20, 31], np.int32)
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    jcache = jl.init_paged_cache(jc, num_pages, page)
    tcache = tl.init_paged_cache(tc, num_pages, page, device="cpu")
    lg_j, jcache = jl.prefill_batch_paged(
        jtree, *_j(toks, lens, rows), jc, jcache)
    _, tcache = tl.prefill_batch_paged(ttree, *_t(toks, lens, rows), tc,
                                       tcache)
    return jcache, tcache, np.asarray(lg_j), lens, rows


def _check_cache(tcache, jcache, int8):
    for key in jcache:
        page_axis = 2 if key in ("k", "v") else 1
        want = np.take(np.asarray(jcache[key]),
                       range(jcache[key].shape[page_axis] - 1), page_axis)
        got = np.take(tcache[key].numpy(),
                      range(jcache[key].shape[page_axis] - 1), page_axis)
        if int8 and key in ("k", "v"):
            assert np.abs(got.astype(np.int32) - want).max() <= 1, key
        else:
            np.testing.assert_allclose(got, want, atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=key)


@pytest.mark.parametrize("form,kv_int8", [("f32", False), ("fused", True)])
def test_fused_decode_steps_match_jax(weights, form, kv_int8):
    jc = dataclasses.replace(J_CFG, kv_int8=kv_int8, fused_decode=True)
    tc = dataclasses.replace(T_CFG, kv_int8=kv_int8, fused_decode=True)
    jtree = jax.tree.map(jnp.asarray, weights[form])
    ttree = bridge.params_from_jax(weights[form], "cpu")
    jcache, tcache, lg, lengths, bt = _prefilled(jc, tc, jtree, ttree)
    cur = np.argmax(lg, -1).astype(np.int32)
    active = np.asarray([True, False, True])
    for _ in range(2):
        lg_j, jcache, nl = jl.decode_slots_paged(
            jtree, *_j(cur, active, bt, lengths), jc, jcache)
        lg_t, tcache, nl_t = tl.decode_slots_paged(
            ttree, *_t(cur, active, bt, lengths), tc, tcache)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                   atol=STEP_TOL, rtol=STEP_TOL)
        np.testing.assert_array_equal(nl_t.numpy(), np.asarray(nl))
        cur = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
        lengths = np.asarray(nl)
    _check_cache(tcache, jcache, kv_int8)


@pytest.mark.parametrize("form,kv_int8", [("f32", False), ("fused", True)])
def test_fused_ragged_step_matches_jax(weights, form, kv_int8):
    jc = dataclasses.replace(J_CFG, kv_int8=kv_int8, fused_decode=True)
    tc = dataclasses.replace(T_CFG, kv_int8=kv_int8, fused_decode=True)
    jtree = jax.tree.map(jnp.asarray, weights[form])
    ttree = bridge.params_from_jax(weights[form], "cpu")
    jcache, tcache, lg, lengths, bt = _prefilled(jc, tc, jtree, ttree)
    # Row 0 continues slot 0's prompt with a 9-token chunk, rows 1-2 are
    # decode rows of slots 1 and 2, row 3 is padding.
    rng = np.random.default_rng(8)
    toks = np.zeros(16, np.int32)
    toks[:9] = rng.integers(0, 211, 9)
    toks[9:11] = np.argmax(lg, -1)[1:]
    slot = np.asarray([0, 1, 2, 0], np.int32)
    start = np.asarray([lengths[0], lengths[1], lengths[2], 0], np.int32)
    n = np.asarray([9, 1, 1, 0], np.int32)
    off = np.asarray([0, 9, 10, 11], np.int32)
    tok_pos = np.zeros(16, np.int32)
    tok_pos[:9] = lengths[0] + np.arange(9)
    tok_pos[9:11] = lengths[1:]
    lg_j, jcache = jl.ragged_step_paged(
        jtree, *_j(toks, tok_pos, slot, start, n, off, bt), jc, jcache)
    lg_t, tcache = tl.ragged_step_paged(
        ttree, *_t(toks, tok_pos, slot, start, n, off, bt), tc, tcache)
    live = n > 0  # padding rows return garbage logits
    np.testing.assert_allclose(lg_t.numpy()[live], np.asarray(lg_j)[live],
                               atol=STEP_TOL, rtol=STEP_TOL)
    _check_cache(tcache, jcache, kv_int8)


def test_fused_path_keeps_refusing_tensor_parallel(weights):
    tc = dataclasses.replace(T_CFG, fused_decode=True, tensor_parallel=True)
    cache = tl.init_paged_cache(tc, 4, 16, device="cpu")
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        tl.decode_slots_paged(bridge.params_from_jax(weights["f32"], "cpu"),
                              z, torch.ones(1, dtype=torch.bool),
                              torch.zeros((1, 1), dtype=torch.int32), z, tc,
                              cache)


# ---------------------------------------------------------------------------
# engines: int8 fused artifact on int8 KV
# ---------------------------------------------------------------------------

BASE = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
            page_size=16, decode_chunk=4, max_new_tokens_default=6)
RAGGED = dict(BASE, ragged_batching=True, prefill_chunk=16, token_budget=36)


@pytest.mark.parametrize("mode", ["bucketed", "ragged"])
def test_fused_int8_engine_streams_match_jax(weights, mode):
    jc = dataclasses.replace(J_CFG, kv_int8=True, fused_decode=True)
    tc = dataclasses.replace(T_CFG, kv_int8=True, fused_decode=True)
    kw = RAGGED if mode == "ragged" else BASE
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 211, n).tolist() for n in (40, 3, 23, 17)]
    jtree = jax.tree.map(jnp.asarray, weights["fused"])
    want_eng = jeng.LLMEngine(jtree, jeng.llama_paged_adapter(jc),
                              jeng.EngineConfig(**kw))
    try:
        want = [s.result(timeout_s=300)
                for s in [want_eng.submit(p) for p in prompts]]
    finally:
        want_eng.shutdown()
    eng = teng.LLMEngine(bridge.params_from_jax(weights["fused"], "cpu"),
                         teng.llama_paged_adapter(tc),
                         teng.EngineConfig(**kw), device="cpu")
    try:
        got = [s.result(timeout_s=120)
               for s in [eng.submit(p) for p in prompts]]
    finally:
        eng.shutdown()
    assert all(len(g) == 6 for g in got)
    assert got == want
