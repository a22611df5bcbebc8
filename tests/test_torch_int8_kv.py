"""The port's int8 KV path against ray_tpu on the CPU: K1 and K4 on int8
pools with page scales, the quantised appends K3 and K6, the whole-page
quantiser, the cache bridge, and the model functions with
``kv_int8=True``.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do; the port's wrappers take their plain versions for CPU tensors.
Inputs come from numpy seeds and cross as numpy arrays.  Stored int8
bytes and f32 page scales are compared EXACTLY on live pages for K3 (both
sides do the same f32 operations in the same order) and to 1 ulp of the
scale for K6 (see ``_assert_k6_equal``); the scratch page and its scale
are garbage by contract and left out."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import paged_attention as jpa
from ray_tpu.ops import ragged_paged_attention as jrpa
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops import ragged_paged_attention as trpa

# Attention in f32 on both sides; sums run in another order (the JAX
# tests' own tolerance, tests/test_ragged_paged_attention.py).
TOL = 2e-5
# Model steps: f32 matmuls in another order (XLA vs ATen).
STEP_TOL = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _int8_pools(rng, L, KVH, P, page, D):
    """Random int8 pools with page-major positive scales [L, P, KVH, 1]."""
    k = rng.integers(-127, 128, (L, KVH, P, page, D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, KVH, P, page, D)).astype(np.int8)
    ks = rng.uniform(0.005, 0.03, (L, P, KVH, 1)).astype(np.float32)
    vs = rng.uniform(0.005, 0.03, (L, P, KVH, 1)).astype(np.float32)
    return k, v, ks, vs


# ---------------------------------------------------------------------------
# K1 int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("soft_cap", [None, 20.0])
@pytest.mark.parametrize("qpg", [1, 4])
def test_k1_int8_plain_matches_jax_kernel(qpg, soft_cap):
    rng = np.random.default_rng(10 + qpg)
    L, KVH, D, page, maxp, B = 2, 2, 32, 16, 4, 4
    P = B * maxp + 1
    k, v, ks, vs = _int8_pools(rng, L, KVH, P, page, D)
    q = rng.standard_normal((B, KVH * qpg, D)).astype(np.float32)
    bt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray([0, page - 1, page + 1, maxp * page], np.int32)
    for layer in range(L):
        want = jpa.paged_decode_attention_partial(
            *_j(q, k, v), jnp.int32(layer), *_j(bt, lengths),
            soft_cap=soft_cap, k_scales=jnp.asarray(ks),
            v_scales=jnp.asarray(vs))
        got = tpa.paged_decode_attention_partial(
            *_t(q, k, v), layer, *_t(bt, lengths), soft_cap=soft_cap,
            k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                       rtol=TOL, err_msg=f"layer {layer}")
        # The empty slot keeps the mask value and a zero denominator.
        acc, m, l = got
        assert (m[0] == -1e30).all() and (l[0] == 0).all() \
            and (acc[0] == 0).all()


@pytest.mark.parametrize("soft_cap", [None, 20.0])
def test_k1_int8_plain_matches_jax_kernel_bf16_q(soft_cap):
    """K1's plain version on int8 pools with bf16 q against the JAX Pallas
    kernel in interpret mode, layer 1.  Both round p to q's dtype (bf16)
    at the running max before p·v, l summed from the unrounded p.  q lies
    on a coarse grid (k/8, |k| <= 16), so its dot with the int8 rows is
    exact in any summation order and the test holds the rounding point.
    Tolerance TOL (f32 sums of the same terms in another order); p
    rounded at the final max instead (the parent's plain version) is
    about 1e-2 off."""
    rng = np.random.default_rng(11)
    L, KVH, D, page, maxp, B, qpg = 2, 2, 32, 16, 4, 4, 4
    P = B * maxp + 1
    k, v, ks, vs = _int8_pools(rng, L, KVH, P, page, D)
    q = (rng.integers(-16, 17, (B, KVH * qpg, D)) / 8).astype(np.float32)
    bt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray([0, page - 1, page + 1, maxp * page], np.int32)
    want = jpa.paged_decode_attention_partial(
        jnp.asarray(q, jnp.bfloat16), *_j(k, v), jnp.int32(1),
        *_j(bt, lengths), soft_cap=soft_cap, k_scales=jnp.asarray(ks),
        v_scales=jnp.asarray(vs))
    got = tpa.paged_decode_attention_partial(
        torch.from_numpy(q).to(torch.bfloat16), *_t(k, v), 1,
        *_t(bt, lengths), soft_cap=soft_cap, k_scales=torch.from_numpy(ks),
        v_scales=torch.from_numpy(vs))
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_k1_int8_plain_matches_jax_kernel_qpg16_d48():
    """K1's plain version on int8 pools at a group of 16 query heads and
    D 48 (shapes only K1's page-walk route takes on the card) against the
    JAX Pallas kernel in interpret mode: 2 slots of up to 3 pages, one kv
    head, a soft cap."""
    rng = np.random.default_rng(12)
    L, KVH, D, page, maxp, B, qpg = 1, 1, 48, 8, 3, 2, 16
    P = B * maxp + 1
    k, v, ks, vs = _int8_pools(rng, L, KVH, P, page, D)
    q = rng.standard_normal((B, KVH * qpg, D)).astype(np.float32)
    bt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray([0, 2 * page + 3], np.int32)
    want = jpa.paged_decode_attention_partial(
        *_j(q, k, v), jnp.int32(0), *_j(bt, lengths), soft_cap=20.0,
        k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs))
    got = tpa.paged_decode_attention_partial(
        *_t(q, k, v), 0, *_t(bt, lengths), soft_cap=20.0,
        k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_int8_pools_and_scales_come_together():
    q = torch.zeros((1, 2, 16))
    pools = torch.zeros((1, 1, 3, 16, 16), dtype=torch.int8)
    sc = torch.ones((1, 3, 1, 1))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    lens = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="int8 pools need"):
        tpa.paged_decode_attention_partial(q, pools, pools, 0, bt, lens)
    with pytest.raises(ValueError, match="int8 pools need"):
        tpa.paged_decode_attention_partial(
            q, pools.float(), pools.float(), 0, bt, lens, k_scales=sc,
            v_scales=sc)
    with pytest.raises(ValueError, match="come together"):
        tpa.paged_decode_attention_partial(q, pools, pools, 0, bt, lens,
                                           k_scales=sc)
    # Head-major scales [L, KVH, P, 1] are the easy mistake.
    with pytest.raises(ValueError, match=r"\[L, P, KVH, 1\]"):
        tpa.paged_decode_attention_partial(
            q, pools, pools, 0, bt, lens, k_scales=sc.permute(0, 2, 1, 3),
            v_scales=sc.permute(0, 2, 1, 3))


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def _k3_both(state, k_new, v_new, pids, offs):
    """One K3 append through both packages; returns the new state (numpy
    k, v, k_scale, v_scale) of each side."""
    jstate, tstate = state
    jout = jpa.paged_append_quantized(*_j(*jstate), *_j(k_new, v_new),
                                      *_j(pids, offs))
    tt = _t(*[a.copy() for a in tstate])
    assert tpa.paged_append_quantized(*tt, *_t(k_new, v_new, pids, offs)) \
        is None
    return ([np.asarray(a) for a in jout], [a.numpy() for a in tt])


def _assert_k3_equal(jstate, tstate, live_pages):
    for name, a, b in zip(("k", "v"), jstate[:2], tstate[:2]):
        np.testing.assert_array_equal(b[:, :, live_pages],
                                      a[:, :, live_pages], err_msg=name)
    for name, a, b in zip(("k_scale", "v_scale"), jstate[2:], tstate[2:]):
        np.testing.assert_array_equal(b[:, live_pages], a[:, live_pages],
                                      err_msg=name)


@pytest.mark.parametrize("case", ["first", "stable", "grown", "reset",
                                  "zero_row"])
def test_k3_plain_matches_jax_kernel(case):
    """The four cases of the JAX test (first write, a stable scale keeps
    the stored bytes, a grown scale requantises, offset 0 resets) and an
    all-zero row (no floor in K3: the scale stays 0), each through both
    packages from the same state: int8 bytes and f32 scales exactly
    equal."""
    L, KVH, P, page, D = 2, 2, 3, 8, 128
    rng = np.random.default_rng(11)
    zeros = [np.zeros((L, KVH, P + 1, page, D), np.int8)] * 2 \
        + [np.zeros((L, P + 1, KVH, 1), np.float32)] * 2
    r0 = rng.standard_normal((L, 1, KVH, D)).astype(np.float32)
    r0v = rng.standard_normal((L, 1, KVH, D)).astype(np.float32)
    pid = np.asarray([1], np.int32)
    steps = [(r0, r0v, 0)]
    if case in ("stable", "grown", "reset"):
        steps.append((r0 * 0.5, r0v * 0.5, 1))
    if case in ("grown", "reset"):
        steps.append((r0 * 3.0, r0v * 2.0, 2))
    if case == "reset":
        steps.append((r0 * 0.01, r0v * 0.01, 0))
    if case == "zero_row":
        steps = [(np.zeros_like(r0), np.zeros_like(r0), 0),
                 (np.zeros_like(r0), r0v, 1)]
    state = (zeros, zeros)
    history = []
    for kn, vn, off in steps:
        state = _k3_both(state, kn, vn, pid, np.asarray([off], np.int32))
        _assert_k3_equal(*state, live_pages=[0, 1, 2])
        history.append([a.copy() for a in state[1]])
    k, _v, ks, _vs = history[-1]
    if case == "first":
        assert (ks[:, 1] > 0).all() and not ks[:, [0, 2]].any()
        assert k[:, :, 1, 0].any() and not k[:, :, 1, 1:].any()
    if case == "stable":
        np.testing.assert_array_equal(ks, history[0][2])
        np.testing.assert_array_equal(k[:, :, 1, 0], history[0][0][:, :, 1, 0])
    if case == "grown":
        assert (ks[:, 1] > history[1][2][:, 1]).all()
        assert (k[:, :, 1, 0] != history[1][0][:, :, 1, 0]).any()
    if case == "reset":
        assert (ks[:, 1] < 0.1 * history[2][2][:, 1]).all()
        assert not k[:, :, 1, 1:].any()       # the stale rows are zeroed
    if case == "zero_row":
        assert not ks[:, 1].any() and not k.any()   # k: zero scale, no NaN
        assert (_vs[:, 1] > 0).all()


def test_k3_plain_many_slots_and_scratch():
    """Several slots at once: live pages exact; an inactive slot (scratch
    page id) and the OOB sentinel leave every live page alone and a
    finite scratch scale."""
    rng = np.random.default_rng(12)
    L, KVH, P, page, D, B = 2, 2, 6, 8, 128, 4
    k, v, ks, vs = _int8_pools(rng, L, KVH, P + 1, page, D)
    kn = (rng.standard_normal((L, B, KVH, D)) * 2).astype(np.float32)
    vn = (rng.standard_normal((L, B, KVH, D)) * 0.1).astype(np.float32)
    pids = np.asarray([3, 0, P, P + 1], np.int32)
    offs = np.asarray([5, 0, 2, 7], np.int32)
    jstate, tstate = _k3_both(([k, v, ks, vs], [k, v, ks, vs]), kn, vn,
                              pids, offs)
    _assert_k3_equal(jstate, tstate, live_pages=list(range(P)))
    untouched = [1, 2, 4, 5]
    np.testing.assert_array_equal(tstate[0][:, :, untouched],
                                  k[:, :, untouched])
    np.testing.assert_array_equal(tstate[2][:, untouched], ks[:, untouched])
    assert np.isfinite(tstate[2][:, P]).all()


# ---------------------------------------------------------------------------
# K4 int8
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("soft_cap", [None, 20.0])
def test_k4_int8_plain_matches_jax_kernel(soft_cap):
    rng = np.random.default_rng(20)
    L, KVH, P, page, D, H, T = 2, 2, 17, 16, 8, 4, 48
    k, v, ks, vs = _int8_pools(rng, L, KVH, P, page, D)
    bt = rng.permutation(P - 1)[:16].reshape(4, 4).astype(np.int32)
    rows = _mixed_rows()
    q = rng.standard_normal((T, H, D)).astype(np.float32)
    kn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    vn = rng.standard_normal((T, KVH, D)).astype(np.float32)
    mask = _covered(T, rows[2], rows[3])
    for layer in range(L):
        want = np.asarray(jrpa.ragged_paged_attention(
            *_j(q, kn, vn, k, v), layer, *_j(*rows, bt), soft_cap=soft_cap,
            k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)))
        got = trpa.ragged_paged_attention(
            *_t(q, kn, vn, k, v), layer, *_t(*rows, bt), soft_cap=soft_cap,
            k_scales=torch.from_numpy(ks), v_scales=torch.from_numpy(vs))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy()[mask], want[mask], atol=TOL,
                                   rtol=TOL, err_msg=f"layer {layer}")
        assert not got.numpy()[~mask].any()   # uncovered rows exactly 0
        # The per-layer oracles agree too.
        ref_j = np.asarray(jrpa.ragged_attention_reference(
            q, kn, vn, jnp.asarray(k[layer]), jnp.asarray(v[layer]), *rows,
            bt, soft_cap=soft_cap, k_scales=jnp.asarray(ks[layer]),
            v_scales=jnp.asarray(vs[layer])))
        ref_t = trpa.ragged_attention_reference(
            *_t(q, kn, vn, k[layer], v[layer], *rows, bt),
            soft_cap=soft_cap, k_scales=torch.from_numpy(ks[layer]),
            v_scales=torch.from_numpy(vs[layer]))
        np.testing.assert_allclose(ref_t.numpy(), ref_j, atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

def _k6_both(k, v, ks, vs, kn, vn, rows, bt):
    jout = jrpa.ragged_paged_append_quantized(
        *_j(k, v, ks, vs, kn, vn), *_j(*rows, bt))
    tt = _t(k.copy(), v.copy(), ks.copy(), vs.copy())
    assert trpa.ragged_paged_append_quantized(
        *tt, *_t(kn, vn, *rows, bt)) is None
    return [np.asarray(a) for a in jout], [a.numpy() for a in tt]


def _assert_k6_equal(jout, tout):
    """Every page but the scratch page: scales within 1 ulp, stored
    bytes exactly equal wherever the page's scale is exactly equal and
    within one step elsewhere.  One ulp because the JAX kernel's
    ``amax / 127.0`` on a (1, 1) vector compiles on the CPU to a product
    with the reciprocal, which differs from the port's true division in
    the last bit for a few values."""
    for key, pools, a, b in (("k", 0, jout[2], tout[2]),
                             ("v", 1, jout[3], tout[3])):
        np.testing.assert_array_max_ulp(b[:, :-1], a[:, :-1], maxulp=1)
        same = (a == b)[:, :-1, :, 0].transpose(0, 2, 1)   # [L, KVH, P-1]
        ja = jout[pools][:, :, :-1].astype(np.int32)
        tb = tout[pools][:, :, :-1].astype(np.int32)
        np.testing.assert_array_equal(tb[same], ja[same], err_msg=key)
        assert np.abs(tb - ja).max() <= 1, key
        assert same.mean() > 0.9, key


def test_k6_plain_matches_jax_kernel_mixed_batch():
    """A chunk row crossing pages from a page boundary, a decode row, a
    padding row and a chunk row starting mid-page: bytes and scales
    equal on every page but the scratch page (``_assert_k6_equal``);
    pages no row touches keep bytes and scale."""
    rng = np.random.default_rng(30)
    L, KVH, P, page, D, T = 2, 2, 17, 16, 8, 48
    k, v, ks, vs = _int8_pools(rng, L, KVH, P, page, D)
    bt = rng.permutation(P - 1)[:16].reshape(4, 4).astype(np.int32)
    rows = (np.asarray([2, 0, 1, 3], np.int32),     # slot
            np.asarray([16, 19, 0, 7], np.int32),   # start
            np.asarray([21, 1, 0, 13], np.int32),   # len
            np.asarray([0, 21, 0, 22], np.int32))   # off
    kn = (rng.standard_normal((L, T, KVH, D)) * 0.5).astype(np.float32)
    vn = (rng.standard_normal((L, T, KVH, D)) * 3.0).astype(np.float32)
    jout, tout = _k6_both(k, v, ks, vs, kn, vn, rows, bt)
    _assert_k6_equal(jout, tout)
    touched = {int(bt[2, 1]), int(bt[2, 2]), int(bt[0, 1]), int(bt[3, 0]),
               int(bt[3, 1])}
    rest = [p for p in range(P - 1) if p not in touched]
    np.testing.assert_array_equal(tout[0][:, :, rest], k[:, :, rest])
    np.testing.assert_array_equal(tout[2][:, rest], ks[:, rest])
    for p in touched:
        assert (tout[0][:, :, p] != k[:, :, p]).any()
    # Slot 2's first page lies before its start (a borrowed prefix page,
    # to the prefix cache): never written.
    np.testing.assert_array_equal(tout[0][:, :, bt[2, 0]], k[:, :, bt[2, 0]])
    # Slot 3 started mid-page at 7: rows 0..6 keep their bytes where the
    # scale did not grow (k: small fresh values), cells 7.. are written.
    assert np.isfinite(tout[2]).all() and np.isfinite(tout[3]).all()


def test_k6_plain_grow_only_scales():
    """The JAX test's grow-only case through both packages: a page
    extended by a small row keeps its scale and its stored bytes; then a
    large row grows the scale and requantises them; an all-zero fresh
    page takes the 1e-8 floor."""
    rng = np.random.default_rng(3)
    L, KVH, P, page, D, T = 1, 1, 5, 16, 8, 16
    k = np.zeros((L, KVH, P, page, D), np.int8)
    v = np.zeros((L, KVH, P, page, D), np.int8)
    ks = np.full((L, P, KVH, 1), 0.05, np.float32)
    vs = np.full((L, P, KVH, 1), 0.05, np.float32)
    k[0, :, 0, :8] = rng.integers(-100, 100, (KVH, 8, D))
    bt = np.asarray([[0, 1]], np.int32)
    rows = [np.asarray([x], np.int32) for x in (0, 8, 4, 0)]
    kn = (rng.standard_normal((L, T, KVH, D)) * 0.01).astype(np.float32)
    vn = (rng.standard_normal((L, T, KVH, D)) * 0.01).astype(np.float32)
    jout, tout = _k6_both(k, v, ks, vs, kn, vn, rows, bt)
    _assert_k6_equal(jout, tout)
    assert tout[2][0, 0, 0, 0] == np.float32(0.05)
    np.testing.assert_array_equal(tout[0][0, :, 0, :8], k[0, :, 0, :8])
    deq = tout[0][0, :, 0, 8:12].astype(np.float32) * 0.05
    np.testing.assert_allclose(deq, kn[0, :4].transpose(1, 0, 2), atol=0.05)
    # A large row at 12..15 grows the scale; a zero row opens page 1.
    rows2 = [np.asarray([x], np.int32) for x in (0, 12, 8, 0)]
    kn2 = kn.copy()
    kn2[0, :4] = rng.standard_normal((4, KVH, D)) * 20.0
    kn2[0, 4:8] = 0.0
    jout2, tout2 = _k6_both(*tout, kn2, vn, rows2, bt)
    _assert_k6_equal(jout2, tout2)
    assert tout2[2][0, 0, 0, 0] > 0.05
    assert (tout2[0][0, :, 0, :8] != k[0, :, 0, :8]).any()
    assert tout2[2][0, 1, 0, 0] == np.float32(1e-8)
    assert not tout2[0][0, :, 1].any()


# ---------------------------------------------------------------------------
# whole-page quantiser, cache bridge, copy_page
# ---------------------------------------------------------------------------

def test_quant_pages_matches_jax():
    rng = np.random.default_rng(40)
    x = rng.standard_normal((2, 2, 5, 16, 8)).astype(np.float32)
    x[0, 0, 1] = 0.0                      # an all-zero page: the 1e-8 floor
    x[1, 1, 2, 9:] = 0.0                  # bucket padding inside a page
    qj, sj = jl._quant_pages(jnp.asarray(x))
    qt, st = tl._quant_pages(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert st[0, 0, 1] == np.float32(1e-8)


J_CFG = jl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=jnp.float32, param_dtype=jnp.float32,
                       remat=False, kv_int8=True)
T_CFG = tl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=torch.float32, param_dtype=torch.float32,
                       remat=False, kv_int8=True)


def test_int8_cache_layout_and_bridge_round_trip():
    jc = jl.init_paged_cache(J_CFG, 6, 16)
    tc = tl.init_paged_cache(T_CFG, 6, 16, device="cpu")
    assert set(tc) == {"k", "v", "k_scale", "v_scale"}
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert not tc[key].any()
    assert tc["k"].dtype == torch.int8
    assert tc["k_scale"].dtype == torch.float32
    assert tuple(tc["k_scale"].shape) == (2, 7, 2, 1)   # page-major
    rng = np.random.default_rng(41)
    k, v, ks, vs = _int8_pools(rng, 2, 2, 7, 16, 16)
    src = {"k": k, "v": v, "k_scale": ks, "v_scale": vs}
    cache = bridge.paged_cache_from_jax(src, device="cpu")
    back = bridge.paged_cache_to_numpy(cache)
    for key in src:
        assert back[key].dtype == src[key].dtype
        np.testing.assert_array_equal(back[key], src[key])
    cache["k"][0, 0, 0, 0, 0] += 1        # a copy, not a view of the source
    assert cache["k"][0, 0, 0, 0, 0] != k[0, 0, 0, 0, 0]
    with pytest.raises(ValueError, match="paged cache"):
        bridge.paged_cache_from_jax({"k": k, "v": v, "k_scale": ks},
                                    device="cpu")
    # bf16/f32 pools cross the same way.
    f = bridge.paged_cache_from_jax({"k": k.astype(np.float32),
                                     "v": v.astype(np.float32)},
                                    device="cpu")
    assert set(f) == {"k", "v"} and f["k"].dtype == torch.float32


@pytest.mark.parametrize("int8", [False, True])
def test_copy_page_matches_jax(int8):
    rng = np.random.default_rng(42)
    k, v, ks, vs = _int8_pools(rng, 2, 2, 7, 16, 16)
    src = {"k": k, "v": v}
    if int8:
        src.update(k_scale=ks, v_scale=vs)
    want = jl.copy_page_paged({key: jnp.asarray(a) for key, a in src.items()},
                              jnp.int32(4), jnp.int32(1))
    cache = bridge.paged_cache_from_jax(src, device="cpu")
    got = tl.copy_page_paged(cache, 4, 1)
    assert got is cache                   # in place
    for key in src:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert torch.equal(got["k"][:, :, 1], got["k"][:, :, 4])


# ---------------------------------------------------------------------------
# model functions with kv_int8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(jax.random.PRNGKey(0), J_CFG)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _assert_pools_close(tc, jc, num_pages, what):
    """Live pages: int8 bytes within one quantisation step and scales
    within STEP_TOL (the k/v values feeding the quantiser differ by f32
    matmul order, so a value at a rounding boundary may move by one)."""
    for key in ("k", "v"):
        a = np.asarray(jc[key])[:, :, :num_pages].astype(np.int32)
        b = tc[key].numpy()[:, :, :num_pages].astype(np.int32)
        assert np.abs(a - b).max() <= 1, f"{what}: {key}"
        assert (a != b).mean() < 0.01, f"{what}: {key}"
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(
            tc[key].numpy()[:, :num_pages],
            np.asarray(jc[key])[:, :num_pages], rtol=STEP_TOL, atol=1e-9,
            err_msg=f"{what}: {key}")


def test_int8_prefill_then_decode_matches_jax(params):
    jp, tp = params
    page, slots, maxp, S = 16, 3, 4, 32
    num_pages = slots * maxp
    rng = np.random.default_rng(1)
    perm = rng.permutation(num_pages).astype(np.int32)
    bt = np.full((slots, maxp), num_pages, np.int32)
    bt[0, :3] = perm[:3]
    bt[1, :4] = perm[3:7]
    bt[2, :2] = perm[7:9]
    true_lens = np.asarray([13, 31, 20], np.int32)
    toks = rng.integers(0, 211, (slots, S)).astype(np.int32)
    pages_rows = bt[:, : S // page]
    jc = jl.init_paged_cache(J_CFG, num_pages, page)
    tc = tl.init_paged_cache(T_CFG, num_pages, page, device="cpu")
    lg_j, jc = jl.prefill_batch_paged(jp, *_j(toks, true_lens, pages_rows),
                                      J_CFG, jc)
    lg_t, tc2 = tl.prefill_batch_paged(tp, *_t(toks, true_lens, pages_rows),
                                       T_CFG, tc)
    assert tc2 is tc
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=STEP_TOL,
                               rtol=STEP_TOL)
    _assert_pools_close(tc, jc, num_pages, "prefill")
    # Both sides decode from ONE pool (the JAX prefill's), so the int8
    # rounding of the prefill does not enter the decode comparison.
    tc = bridge.paged_cache_from_jax(jax.tree.map(np.asarray, jc),
                                     device="cpu")
    lengths = true_lens.copy()
    cur = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
    active = np.asarray([True, True, False])
    for step in range(3):      # slot 1 crosses into a fresh page at 32
        lg_j, jc, nl_j = jl.decode_slots_paged(
            jp, *_j(cur, active, bt, lengths), J_CFG, jc)
        lg_t, tc, nl_t = tl.decode_slots_paged(
            tp, *_t(cur, active, bt, lengths), T_CFG, tc)
        np.testing.assert_allclose(lg_t.numpy()[:2], np.asarray(lg_j)[:2],
                                   atol=STEP_TOL, rtol=STEP_TOL,
                                   err_msg=f"step {step}")
        assert nl_t.tolist() == np.asarray(nl_j).tolist()
        _assert_pools_close(tc, jc, num_pages, f"decode step {step}")
        cur = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
        lengths = np.array(nl_j)


def test_int8_prefill_slot_equals_batch_row_and_jax(params):
    jp, tp = params
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
    for key in c1:
        assert torch.equal(c1[key], c2[key]), key
    lj, jc = jl.prefill_slot_paged(jp, jnp.asarray(toks), jnp.int32(20),
                                   jnp.asarray(pages), J_CFG,
                                   jl.init_paged_cache(J_CFG, 8, page))
    np.testing.assert_allclose(l1.numpy(), np.asarray(lj), atol=STEP_TOL,
                               rtol=STEP_TOL)
    _assert_pools_close(c1, jc, 8, "prefill_slot")


def test_int8_ragged_step_matches_jax(params):
    """Two slots through four ragged steps (whole prompt beside a first
    chunk, a decode row beside a closing chunk, then decode rows); both
    sides re-start every step from the JAX side's pool."""
    jp, tp = params
    page, num_pages, maxp, T, R = 16, 16, 4, 48, 4
    rng = np.random.default_rng(1)
    p0, p1 = rng.integers(1, 211, 13), rng.integers(1, 211, 29)
    bt = np.full((2, maxp), num_pages, np.int32)
    bt[0, :2] = [7, 2]
    bt[1, :3] = [11, 4, 0]
    jc = jl.init_paged_cache(J_CFG, num_pages, page)

    def step(rows):
        nonlocal jc
        (htoks, _dm, _ts, tpos, rslot, rstart, rlen, roff
         ) = trpa.pack_ragged_batch(rows, T, R)
        tc = bridge.paged_cache_from_jax(jax.tree.map(np.asarray, jc),
                                         device="cpu")
        lg_j, jc = jl.ragged_step_paged(
            jp, *_j(htoks, tpos, rslot, rstart, rlen, roff, bt), J_CFG, jc,
            max_row_tokens=32)
        lg_t, tc2 = tl.ragged_step_paged(
            tp, *_t(htoks, tpos, rslot, rstart, rlen, roff, bt), T_CFG, tc,
            max_row_tokens=32)
        assert tc2 is tc
        live = rlen > 0
        np.testing.assert_allclose(lg_t.numpy()[live], np.asarray(lg_j)[live],
                                   atol=STEP_TOL, rtol=STEP_TOL)
        _assert_pools_close(tc, jc, num_pages, f"rows {rows}")
        return np.asarray(jnp.argmax(lg_j, -1))

    arg = step([dict(slot=0, start=0, tokens=list(p0)),
                dict(slot=1, start=0, tokens=list(p1[:16]))])
    o0 = [int(arg[0])]
    arg = step([dict(slot=0, start=13, tokens=[o0[-1]]),
                dict(slot=1, start=16, tokens=list(p1[16:]))])
    o0.append(int(arg[0]))
    o1 = [int(arg[1])]
    for i in range(3):     # slot 0 crosses into its second page at 16
        arg = step([dict(slot=0, start=14 + i, tokens=[o0[-1]]),
                    dict(slot=1, start=29 + i, tokens=[o1[-1]])])
        o0.append(int(arg[0]))
        o1.append(int(arg[1]))
    assert len(o0) == 5 and len(o1) == 4


def test_int8_prefill_chunk_raises_like_jax(params):
    jp, tp = params
    args = (np.zeros((1, 16), np.int32), np.zeros(1, np.int32),
            np.full(1, 16, np.int32), np.zeros((1, 2), np.int32))
    with pytest.raises(NotImplementedError, match="kv_int8"):
        jl.prefill_chunk_paged(jp, *_j(*args), J_CFG,
                               jl.init_paged_cache(J_CFG, 2, 16))
    with pytest.raises(NotImplementedError, match="kv_int8"):
        tl.prefill_chunk_paged(tp, *_t(*args), T_CFG,
                               tl.init_paged_cache(T_CFG, 2, 16,
                                                   device="cpu"))
    assert dataclasses.replace(T_CFG, kv_int8=False).kv_int8 is False
