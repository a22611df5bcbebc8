"""The port's ragged paged attention (K4) and ragged append (K5), their
host packer and the ragged model step, against ray_tpu on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_ragged_paged_attention.py does; the port's wrappers take
their plain versions for CPU tensors.  Inputs come from numpy seeds and
cross as numpy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import ragged_paged_attention as jrpa
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import ragged_paged_attention as trpa

# f32 on both sides; matmul and reduction order differ (XLA vs ATen).
TOL = 2e-5
STEP_TOL = 1e-4


def _mixed_rows():
    """One decode row, one mid-prompt prefill chunk, one fresh prefill,
    one padding row (the layout of the JAX kernel tests)."""
    return (np.asarray([2, 0, 3, 0], np.int32),    # slot
            np.asarray([19, 0, 7, 0], np.int32),   # start
            np.asarray([1, 11, 13, 0], np.int32),  # len (0 = padding)
            np.asarray([0, 1, 12, 0], np.int32))   # off


def _covered(T, rl, ro):
    mask = np.zeros(T, bool)
    for n, o in zip(rl, ro):
        mask[o:o + n] = True
    return mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("mrt", [None, 16])
def test_k4_plain_matches_jax_kernel(mrt):
    rng = np.random.default_rng(0)
    L, KVH, P, page, D, H, T = 2, 2, 17, 16, 8, 4, 48
    kp = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    vp = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    # Shuffled physical pages; page P - 1 (scratch) stays out of tables.
    bt = rng.permutation(P - 1)[:16].reshape(4, 4).astype(np.int32)
    rows = _mixed_rows()
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    kn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    mask = _covered(T, rows[2], rows[3])
    for layer in range(L):
        want = np.asarray(jrpa.ragged_paged_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(kp), jnp.asarray(vp), layer,
            *[jnp.asarray(a) for a in rows], jnp.asarray(bt),
            max_row_tokens=mrt))
        got = trpa.ragged_paged_attention(
            *_t(q, kn, vn, kp, vp), layer, *_t(*rows, bt),
            max_row_tokens=mrt)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy()[mask], want[mask], atol=TOL,
                                   rtol=TOL, err_msg=f"layer {layer}")
        # Buffer tokens no row covers are exactly zero.
        assert not got.numpy()[~mask].any()


def test_k4_plain_soft_cap_matches_jax_kernel():
    rng = np.random.default_rng(1)
    L, KVH, P, page, D, H, T = 1, 1, 9, 16, 8, 2, 16
    kp = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    vp = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    bt = np.arange(8, dtype=np.int32).reshape(2, 4)
    rows = (np.asarray([1, 0], np.int32), np.asarray([33, 0], np.int32),
            np.asarray([1, 0], np.int32), np.asarray([0, 0], np.int32))
    q = rng.standard_normal((T, H, D)).astype(np.float32) * 4
    kn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kp),
        jnp.asarray(vp), 0, *[jnp.asarray(a) for a in rows], jnp.asarray(bt),
        soft_cap=20.0))
    got = trpa.ragged_paged_attention(*_t(q, kn, vn, kp, vp), 0,
                                      *_t(*rows, bt), soft_cap=20.0)
    np.testing.assert_allclose(got.numpy()[0], want[0], atol=TOL, rtol=TOL)
    assert not got.numpy()[1:].any()


def test_k4_reference_matches_jax_reference():
    """The per-layer oracles agree too (f32 pages and math)."""
    rng = np.random.default_rng(5)
    KVH, P, page, D, H, T = 2, 17, 16, 8, 4, 48
    kp = rng.standard_normal((KVH, P, page, D)).astype(np.float32)
    vp = rng.standard_normal((KVH, P, page, D)).astype(np.float32)
    bt = rng.permutation(P - 1)[:16].reshape(4, 4).astype(np.int32)
    rows = _mixed_rows()
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    kn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    want = np.asarray(jrpa.ragged_attention_reference(
        q, kn, vn, jnp.asarray(kp), jnp.asarray(vp), *rows, bt))
    got = trpa.ragged_attention_reference(*_t(q, kn, vn, kp, vp, *rows, bt))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_k5_plain_matches_jax_kernel_exactly():
    rng = np.random.default_rng(2)
    L, KVH, P, page, D, T = 2, 2, 17, 16, 8, 48
    kp = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    vp = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    bt = rng.permutation(P - 1)[:16].reshape(4, 4).astype(np.int32)
    rows = _mixed_rows()
    kn = rng.standard_normal((L, T, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((L, T, KVH, D)).astype(np.float32)
    want_k, want_v = jrpa.ragged_paged_append(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(kn), jnp.asarray(vn),
        *[jnp.asarray(a) for a in rows], jnp.asarray(bt))
    got_k, got_v = _t(kp, vp)
    assert trpa.ragged_paged_append(got_k, got_v, *_t(kn, vn, *rows, bt)) \
        is None
    # In place; exact everywhere but the scratch page.
    np.testing.assert_array_equal(got_k.numpy()[:, :, :-1],
                                  np.asarray(want_k)[:, :, :-1])
    np.testing.assert_array_equal(got_v.numpy()[:, :, :-1],
                                  np.asarray(want_v)[:, :, :-1])
    # The per-layer reference writes the same pages.
    for layer in range(L):
        rk, rv = trpa.ragged_append_reference(
            *_t(kp[layer], vp[layer], kn[layer], vn[layer], *rows, bt))
        assert torch.equal(rk[:, :-1], got_k[layer, :, :-1])
        assert torch.equal(rv[:, :-1], got_v[layer, :, :-1])


def test_k4_k5_int8_pools_raise():
    """Scales belong to int8 pools and int8 pools to K6: scales beside
    f32 pools, int8 pools without scales, and int8 pools handed to the
    copying append K5 all raise."""
    q = torch.zeros((8, 2, 8))
    pools = torch.zeros((1, 1, 3, 16, 8))
    rows = [torch.zeros(2, dtype=torch.int32)] * 4
    bt = torch.zeros((2, 2), dtype=torch.int32)
    sc = torch.ones((1, 3, 1, 1))
    with pytest.raises(ValueError, match="int8"):
        trpa.ragged_paged_attention(
            q, q[:, :1], q[:, :1], pools, pools, 0, *rows, bt,
            k_scales=sc, v_scales=sc)
    with pytest.raises(ValueError, match="int8"):
        trpa.ragged_paged_attention(
            q, q[:, :1], q[:, :1], pools.to(torch.int8),
            pools.to(torch.int8), 0, *rows, bt)
    with pytest.raises(ValueError, match="int8"):
        trpa.ragged_paged_append_quantized(
            pools, pools, sc, sc, q[None, :, :1], q[None, :, :1], *rows, bt)
    out = trpa.ragged_paged_attention(
        q, q[:, :1], q[:, :1], pools.to(torch.int8), pools.to(torch.int8),
        0, *rows, bt, k_scales=sc, v_scales=sc)
    assert out.shape == q.shape and not out.any()


def test_pack_ragged_batch_matches_jax():
    rows = [
        dict(slot=2, start=19, tokens=None),          # decode
        dict(slot=0, start=0, tokens=[5, 6, 7]),      # prefill chunk
        dict(slot=3, start=16, tokens=[9, 9]),        # later chunk
    ]
    got = trpa.pack_ragged_batch(rows, token_budget=8, max_slots=4)
    want = jrpa.pack_ragged_batch(rows, token_budget=8, max_slots=4)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert list(got[6]) == [1, 3, 2, 0] and list(got[7]) == [0, 1, 4, 0]
    for pack in (trpa.pack_ragged_batch, jrpa.pack_ragged_batch):
        with pytest.raises(AssertionError):
            pack([dict(slot=0, start=0, tokens=list(range(9)))],
                 token_budget=8, max_slots=4)
        with pytest.raises(AssertionError):
            pack([dict(slot=s, start=0, tokens=None) for s in range(5)],
                 token_budget=8, max_slots=4)
    # The adapter column (LoRA multiplexing): each row's optional
    # "adapter" index over its tokens, 0 elsewhere.
    rows[1]["adapter"] = 2
    got = trpa.pack_ragged_batch(rows, 8, 4, with_adapters=True)
    want = jrpa.pack_ragged_batch(rows, 8, 4, with_adapters=True)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(got[8]) == [0, 2, 2, 2, 0, 0, 0, 0]


def test_window_size_matches_jax():
    for T, mrt in ((48, None), (256, 16), (16, 64), (264, 256), (9, 3)):
        assert trpa.window_size(T, mrt) == jrpa.window_size(T, mrt)


# ---------------------------------------------------------------------------
# the model step: port ragged_step_paged / prefill_chunk_paged vs JAX
# ---------------------------------------------------------------------------

J_CFG = jl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=jnp.float32, param_dtype=jnp.float32,
                       remat=False)
T_CFG = tl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=torch.float32, param_dtype=torch.float32,
                       remat=False)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _ragged_pair(params, prompts, bt, num_pages, page, decode_steps,
                 logit_idx=None):
    """The _ragged_run sequence of the JAX tests through both packages:
    step 1 packs slot 0's whole prompt beside slot 1's first chunk, step
    2 mixes slot 0's first decode with slot 1's closing chunk, then both
    decode.  Greedy tokens come from the JAX logits; logits and pools
    are compared after every step."""
    jp, tp = params
    T, R = 48, 4
    jc = jl.init_paged_cache(J_CFG, num_pages, page)
    tc = tl.init_paged_cache(T_CFG, num_pages, page, device="cpu")
    outs = [[], []]

    def step(rows):
        nonlocal jc
        (htoks, _dm, _ts, tpos, rslot, rstart, rlen, roff
         ) = trpa.pack_ragged_batch(rows, T, R)
        extra = {} if logit_idx is None else {"logit_idx": logit_idx}
        jout = jl.ragged_step_paged(
            jp, jnp.asarray(htoks), jnp.asarray(tpos), jnp.asarray(rslot),
            jnp.asarray(rstart), jnp.asarray(rlen), jnp.asarray(roff),
            jnp.asarray(bt), J_CFG, jc, max_row_tokens=32,
            **{k: jnp.asarray(v) for k, v in extra.items()})
        tout = tl.ragged_step_paged(
            tp, *_t(htoks, tpos, rslot, rstart, rlen, roff, bt), T_CFG, tc,
            max_row_tokens=32,
            **{k: torch.from_numpy(v) for k, v in extra.items()})
        jc = jout[-1]
        assert tout[-1] is tc  # the pools are updated in place
        live = rlen > 0
        for jx, tx in zip(jout[:-1], tout[:-1]):
            assert tx.dtype == torch.float32
            rows_cmp = live if jx.shape[0] == R else slice(None)
            np.testing.assert_allclose(tx.numpy()[rows_cmp],
                                       np.asarray(jx)[rows_cmp],
                                       atol=STEP_TOL, rtol=STEP_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tc[key].numpy()[:, :, :num_pages],
                np.asarray(jc[key])[:, :, :num_pages], atol=STEP_TOL,
                rtol=STEP_TOL)
        arg_j = np.asarray(jnp.argmax(jout[0], -1))
        arg_t = tout[0].argmax(-1).numpy()
        np.testing.assert_array_equal(arg_t[live], arg_j[live])
        return arg_j

    p0, p1 = prompts
    arg = step([dict(slot=0, start=0, tokens=list(p0)),
                dict(slot=1, start=0, tokens=list(p1[:16]))])
    outs[0].append(int(arg[0]))
    arg = step([dict(slot=0, start=len(p0), tokens=[outs[0][-1]]),
                dict(slot=1, start=16, tokens=list(p1[16:]))])
    outs[0].append(int(arg[0]))
    outs[1].append(int(arg[1]))
    lens = np.asarray([len(p0) + 1, len(p1)])
    for _ in range(decode_steps - 1):
        arg = step([dict(slot=0, start=int(lens[0]), tokens=[outs[0][-1]]),
                    dict(slot=1, start=int(lens[1]), tokens=[outs[1][-1]])])
        lens += 1
        outs[0].append(int(arg[0]))
        outs[1].append(int(arg[1]))
    return outs


def _layout():
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 211, 13), rng.integers(1, 211, 29)]
    page, num_pages, maxp = 16, 16, 4
    bt = np.full((2, maxp), num_pages, np.int32)   # OOB sentinel
    bt[0, :2] = [7, 2]
    bt[1, :3] = [11, 4, 0]
    return prompts, bt, num_pages, page


def test_ragged_step_matches_jax(params):
    prompts, bt, num_pages, page = _layout()
    outs = _ragged_pair(params, prompts, bt, num_pages, page,
                        decode_steps=3)
    assert len(outs[0]) == 4 and len(outs[1]) == 3


def test_ragged_step_logit_idx_matches_jax(params):
    prompts, bt, num_pages, page = _layout()
    # Extra logits at flat-buffer positions, as a verify row asks.
    _ragged_pair(params, prompts, bt, num_pages, page, decode_steps=1,
                 logit_idx=np.asarray([0, 3, 13, 47, 60], np.int32))


def test_ragged_step_unported_modes_raise(params):
    _, tp = params
    bt = torch.zeros((1, 2), dtype=torch.int32)
    args = [torch.zeros(8, dtype=torch.int32)] * 2 \
        + [torch.zeros(1, dtype=torch.int32)] * 4 + [bt]
    cache = tl.init_paged_cache(T_CFG, 2, 16, device="cpu")
    # The fused body and LoRA (tests/test_torch_lora.py) are ported; with
    # tensor or sequence parallelism the step still raises, fused or not.
    fused = dataclasses.replace(T_CFG, fused_decode=True)
    for cfg in (fused, T_CFG):
        for field in ("tensor_parallel", "sequence_parallel"):
            with pytest.raises(NotImplementedError, match=field):
                tl.ragged_step_paged(tp, *args, dataclasses.replace(
                    cfg, **{field: True}), cache)


@pytest.mark.parametrize("chunk_lens", [(16, 16), (16, 9)])
def test_prefill_chunk_paged_matches_jax(params, chunk_lens):
    """Two rows, two chunks each: the second chunk attends over the
    first through the pages; a short tail pads its chunk."""
    jp, tp = params
    page, num_pages, maxp, C = 16, 12, 4, 16
    rng = np.random.default_rng(3)
    bt = np.full((2, maxp), num_pages, np.int32)
    bt[0, :3] = [5, 1, 9]
    bt[1, :3] = [0, 10, 3]
    toks = rng.integers(0, 211, (2, 2 * C)).astype(np.int32)
    jc = jl.init_paged_cache(J_CFG, num_pages, page)
    tc = tl.init_paged_cache(T_CFG, num_pages, page, device="cpu")
    for c in range(2):
        lens = np.asarray([C, chunk_lens[c] if c else C], np.int32)
        t = toks[:, c * C:(c + 1) * C].copy()
        start = np.full((2,), c * C, np.int32)
        lg_j, jc = jl.prefill_chunk_paged(
            jp, jnp.asarray(t), jnp.asarray(start), jnp.asarray(lens),
            jnp.asarray(bt), J_CFG, jc)
        lg_t, tc = tl.prefill_chunk_paged(
            tp, *_t(t, start, lens, bt), T_CFG, tc)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                   atol=STEP_TOL, rtol=STEP_TOL)
        assert (lg_t.argmax(-1).numpy()
                == np.asarray(jnp.argmax(lg_j, -1))).all()
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tc[key].numpy()[:, :, :num_pages],
                np.asarray(jc[key])[:, :, :num_pages], atol=STEP_TOL,
                rtol=STEP_TOL)
