"""Port of the Llama serving path against ray_tpu.models.llama on a tiny
f32 config: the dense forward, RoPE (with Llama-3.1 scaling), and
paged prefill followed by decode steps — logits, new lengths and the
page pool contents after every step.  Weights come from the JAX init
and cross through the numpy bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl

J_CFG = jl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=jnp.float32, param_dtype=jnp.float32,
                       remat=False)
T_CFG = tl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=torch.float32, param_dtype=torch.float32,
                       remat=False)
# f32 on both sides; matmul and reduction order differ (XLA vs ATen).
ATOL = RTOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def test_forward_logits_match_jax(params):
    jp, tp = params
    toks = np.random.default_rng(0).integers(0, 211, (2, 24)).astype(np.int32)
    want = np.asarray(jl.forward(jp, jnp.asarray(toks), J_CFG))
    got = tl.forward(tp, torch.from_numpy(toks), T_CFG)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 64)])
def test_rope_table_matches_jax(scaling):
    jc = dataclasses.replace(J_CFG, rope_scaling=scaling)
    tc = dataclasses.replace(T_CFG, rope_scaling=scaling)
    pos = np.arange(0, 1000, 37, dtype=np.int32)[None]
    js, jc_ = jl.rope_table(jc, jnp.asarray(pos))
    ts, tc_ = tl.rope_table(tc, torch.from_numpy(pos))
    # f32 sin/cos of angles up to ~1e3 rad: argument reduction differs
    # between XLA and ATen by a few ulps of the angle.
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-4)
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc_), atol=2e-4)


def test_apply_rope_rotates_half_split_pairs():
    x = torch.arange(8, dtype=torch.float32).reshape(1, 1, 1, 8)
    sin = torch.ones(1, 1, 4)
    cos = torch.zeros(1, 1, 4)
    # cos 0, sin 1: (x1, x2) → (-x2, x1) with x1 = x[:4], x2 = x[4:].
    out = tl.apply_rope(x, sin, cos)
    assert out.flatten().tolist() == [-4, -5, -6, -7, 0, 1, 2, 3]


def test_paged_prefill_then_decode_matches_jax(params):
    jp, tp = params
    page, slots, maxp, S = 16, 3, 4, 32
    num_pages = slots * maxp
    rng = np.random.default_rng(1)
    # Shuffled page ownership; unallocated entries hold the sentinel.
    perm = rng.permutation(num_pages).astype(np.int32)
    bt = np.full((slots, maxp), num_pages, np.int32)
    bt[0, :3] = perm[:3]
    bt[1, :4] = perm[3:7]
    bt[2, :2] = perm[7:9]
    true_lens = np.asarray([13, 32, 20], np.int32)
    toks = rng.integers(0, 211, (slots, S)).astype(np.int32)
    pages_rows = bt[:, : S // page]

    jc = jl.init_paged_cache(J_CFG, num_pages, page)
    tc = tl.init_paged_cache(T_CFG, num_pages, page, device="cpu")
    assert tuple(tc["k"].shape) == (2, 2, num_pages + 1, page, 16)
    lg_j, jc = jl.prefill_batch_paged(jp, jnp.asarray(toks),
                                      jnp.asarray(true_lens),
                                      jnp.asarray(pages_rows), J_CFG, jc)
    lg_t, tc = tl.prefill_batch_paged(tp, torch.from_numpy(toks),
                                      torch.from_numpy(true_lens),
                                      torch.from_numpy(pages_rows), T_CFG, tc)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=ATOL,
                               rtol=RTOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=ATOL, rtol=RTOL)

    lengths = true_lens.copy()
    cur = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
    active = np.asarray([True, True, False])  # slot 2 idles: scratch writes
    for step in range(3):
        lg_j, jc, nl_j = jl.decode_slots_paged(
            jp, jnp.asarray(cur), jnp.asarray(active), jnp.asarray(bt),
            jnp.asarray(lengths), J_CFG, jc)
        lg_t, tc, nl_t = tl.decode_slots_paged(
            tp, torch.from_numpy(cur), torch.from_numpy(active),
            torch.from_numpy(bt), torch.from_numpy(lengths), T_CFG, tc)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {step}")
        assert nl_t.tolist() == np.asarray(nl_j).tolist()
        for key in ("k", "v"):
            # Every page but the scratch page (whose content depends on
            # the order of the duplicate inactive writes).
            np.testing.assert_allclose(
                tc[key].numpy()[:, :, :num_pages],
                np.asarray(jc[key])[:, :, :num_pages], atol=ATOL, rtol=RTOL,
                err_msg=f"{key} pool after step {step}")
        cur = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
        lengths = np.array(nl_j)


def test_prefill_slot_equals_batch_row(params):
    _, tp = params
    page = 16
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 211, (32,)).astype(np.int32)
    pages = np.asarray([5, 2], np.int32)
    c1 = tl.init_paged_cache(T_CFG, 8, page, device="cpu")
    c2 = tl.init_paged_cache(T_CFG, 8, page, device="cpu")
    l1, c1 = tl.prefill_slot_paged(tp, torch.from_numpy(toks),
                                   torch.tensor(20), torch.from_numpy(pages),
                                   T_CFG, c1)
    l2, c2 = tl.prefill_batch_paged(tp, torch.from_numpy(toks)[None],
                                    torch.tensor([20]),
                                    torch.from_numpy(pages)[None], T_CFG, c2)
    assert torch.equal(l1, l2[0])
    assert torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"])


def test_unported_modes_raise(params):
    _, tp = params
    cache = tl.init_paged_cache(T_CFG, 4, 16, device="cpu")
    toks = torch.zeros((1, 16), dtype=torch.int32)
    for field, value in (("tensor_parallel", True),
                         ("sequence_parallel", True)):
        with pytest.raises(NotImplementedError, match=field):
            tl.prefill_batch_paged(
                tp, toks, torch.tensor([3]),
                torch.zeros((1, 1), dtype=torch.int32),
                dataclasses.replace(T_CFG, **{field: value}), cache)
    # LoRA is ported (the ragged step's segmented body); the prefills
    # never read it, as in the JAX package.
    from ray_tpu_torch.ops.segmented_lora import LoRAConfig

    base, _ = tl.prefill_batch_paged(
        tp, toks, torch.tensor([3]), torch.zeros((1, 1), dtype=torch.int32),
        T_CFG, tl.init_paged_cache(T_CFG, 4, 16, device="cpu"))
    with_lora, _ = tl.prefill_batch_paged(
        tp, toks, torch.tensor([3]), torch.zeros((1, 1), dtype=torch.int32),
        dataclasses.replace(T_CFG, lora=LoRAConfig()),
        tl.init_paged_cache(T_CFG, 4, 16, device="cpu"))
    assert torch.equal(base, with_lora)
    # Fused decode is ported; the prefills never read the flag, as in the
    # JAX package, and it still refuses tensor parallelism.
    fused = dataclasses.replace(T_CFG, fused_decode=True)
    want, _ = tl.prefill_batch_paged(
        tp, toks, torch.tensor([3]), torch.zeros((1, 1), dtype=torch.int32),
        T_CFG, tl.init_paged_cache(T_CFG, 4, 16, device="cpu"))
    got, _ = tl.prefill_batch_paged(
        tp, toks, torch.tensor([3]), torch.zeros((1, 1), dtype=torch.int32),
        fused, cache)
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="tensor_parallel"):
        tl.prefill_batch_paged(
            tp, toks, torch.tensor([3]),
            torch.zeros((1, 1), dtype=torch.int32),
            dataclasses.replace(fused, tensor_parallel=True), cache)
    # int8 KV pools are ported: the cache builds, with its page scales.
    assert "k_scale" in tl.init_paged_cache(
        dataclasses.replace(T_CFG, kv_int8=True), 4, 16, device="cpu")
