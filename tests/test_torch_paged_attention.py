"""Port of the paged decode kernels (K1 partials + combine, K2 append,
K13 normalised attention) against ray_tpu.ops.paged_attention, run in
interpret mode on the CPU as tests/test_paged_attention.py runs it.
Inputs come from a seeded numpy generator and go to both sides; f32
throughout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import paged_attention as jpa
from ray_tpu_torch.ops import paged_attention as tpa

# f32 on both sides; sums run in another order (einsum vs the Pallas
# kernel's per-page online softmax), so allow a few ulps of the O(1)
# values.
ATOL = RTOL = 2e-5


def _inputs(qpg, seed, L=2, KVH=2, D=64, page=16, maxp=4, B=4):
    rng = np.random.default_rng(seed)
    H = KVH * qpg
    P = B * maxp + 1  # + the scratch page
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    v = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    # Shuffled physical pages: the table indirection must be honoured.
    bt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray([0, page - 1, page, page + 1][:B], np.int32)
    return q, k, v, bt, lengths


@pytest.mark.parametrize("soft_cap", [None, 20.0])
@pytest.mark.parametrize("qpg", [1, 2, 4])
def test_partial_and_combine_match_jax(qpg, soft_cap):
    q, k, v, bt, lengths = _inputs(qpg, seed=qpg)
    rng = np.random.default_rng(100 + qpg)
    B, H, D = q.shape
    KVH = k.shape[1]
    k_new = rng.standard_normal((B, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((B, KVH, D)).astype(np.float32)
    layer = 1  # a non-zero layer exercises the layer offset
    acc_j, m_j, l_j = jpa.paged_decode_attention_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.int32(layer), jnp.asarray(bt), jnp.asarray(lengths),
        soft_cap=soft_cap)
    acc_t, m_t, l_t = tpa.paged_decode_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        layer, torch.from_numpy(bt), torch.from_numpy(lengths),
        soft_cap=soft_cap)
    for a, b in ((acc_j, acc_t), (m_j, m_t), (l_j, l_t)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=ATOL, rtol=RTOL)
    # The empty slot keeps the mask value and a zero denominator.
    assert (m_t[0] == -1e30).all() and (l_t[0] == 0).all()
    out_j = jpa.combine_with_self(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        acc_j, m_j, l_j, soft_cap=soft_cap)
    out_t = tpa.combine_with_self(
        torch.from_numpy(q), torch.from_numpy(k_new),
        torch.from_numpy(v_new), acc_t, m_t, l_t, soft_cap=soft_cap)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)


def _grid(rng, shape):
    """Values k/8 for integers |k| <= 16: exact in bf16, and a dot of up
    to 256 of their products is exact in f32 in any summation order."""
    return rng.integers(-16, 17, shape).astype(np.float32) / 8


@pytest.mark.parametrize("soft_cap", [None, 20.0])
def test_k1_plain_matches_jax_kernel_bf16(soft_cap):
    """K1's plain version on bf16 pools and bf16 q against the JAX Pallas
    kernel in interpret mode, layer 1.  Both walk the pages in order and
    round p to bf16 at the running max before p·v, with l summed from the
    unrounded p.  q and k lie on a coarse grid, so the q·k dot is exact in
    XLA's order and in the port's, and the test holds the rounding point,
    not the summation order.  Tolerance: the f32 one (ATOL, RTOL), for
    sums of the same rounded terms in another order; p rounded at the
    final max instead (the parent's plain version) is about 1e-2 off."""
    q, k, v, bt, lengths = _inputs(4, seed=5)
    rng = np.random.default_rng(6)
    q, k = _grid(rng, q.shape), _grid(rng, k.shape)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = jpa.paged_decode_attention_partial(
        *[jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf],
        jnp.int32(1), jnp.asarray(bt), jnp.asarray(lengths),
        soft_cap=soft_cap)
    got = tpa.paged_decode_attention_partial(
        *bf, 1, torch.from_numpy(bt), torch.from_numpy(lengths),
        soft_cap=soft_cap)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)
    assert (got[1][0] == -1e30).all() and (got[2][0] == 0).all()


def test_partial_normalised_matches_dense_reference():
    q, k, v, bt, lengths = _inputs(2, seed=7)
    layer = 1
    acc, m, l = tpa.paged_decode_attention_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        layer, torch.from_numpy(bt), torch.from_numpy(lengths))
    ref_t = tpa.paged_decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k[layer]),
        torch.from_numpy(v[layer]), torch.from_numpy(bt),
        torch.from_numpy(lengths))
    ref_j = jpa.paged_decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k[layer]), jnp.asarray(v[layer]),
        jnp.asarray(bt), jnp.asarray(lengths))
    live = lengths > 0
    np.testing.assert_allclose((acc / l).numpy()[live],
                               ref_t.numpy()[live], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ref_t.numpy()[live], np.asarray(ref_j)[live],
                               atol=ATOL, rtol=RTOL)


def test_append_matches_jax_with_inactive_slot_on_scratch():
    rng = np.random.default_rng(3)
    L, KVH, page, D, B = 2, 2, 8, 32, 4
    P = 9  # 8 pages + the scratch page (index 8)
    k = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    v = rng.standard_normal((L, KVH, P, page, D)).astype(np.float32)
    k_new = rng.standard_normal((L, B, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((L, B, KVH, D)).astype(np.float32)
    # Slot 2 is inactive (pid = scratch); slot 3 carries the OOB
    # sentinel P, which clamps onto the scratch page too.
    pids = np.asarray([3, 5, P - 1, P], np.int32)
    offs = np.asarray([0, 7, 2, 5], np.int32)
    kj, vj = jpa.paged_append(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(pids), jnp.asarray(offs))
    kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tpa.paged_append(kt, vt, torch.from_numpy(k_new),
                     torch.from_numpy(v_new), torch.from_numpy(pids),
                     torch.from_numpy(offs))
    np.testing.assert_array_equal(kt.numpy()[:, :, : P - 1],
                                  np.asarray(kj)[:, :, : P - 1])
    np.testing.assert_array_equal(vt.numpy()[:, :, : P - 1],
                                  np.asarray(vj)[:, :, : P - 1])
    # Live pages: exactly the two active rows changed.
    changed = np.argwhere((kt.numpy() != k).any(axis=-1))
    live = {(p, o) for _, _, p, o in changed if p < P - 1}
    assert live == {(3, 0), (5, 7)}


@pytest.mark.parametrize("soft_cap", [None, 20.0])
@pytest.mark.parametrize("qpg", [1, 4])
def test_k13_normalised_matches_jax_kernel(qpg, soft_cap):
    """K13 (``paged_decode_attention``, here its plain version) against
    the JAX Pallas kernel in interpret mode on one layer's pages: MHA and
    GQA, a soft cap, an empty slot (output 0) and OOB sentinels past each
    slot's live pages; ``paged_decode_attention_tp`` without a mesh is K13
    itself and refuses any mesh."""
    q, k, v, bt, lengths = _inputs(qpg, seed=20 + qpg)
    layer = 1
    kp, vp = k[layer], v[layer]
    P, page = kp.shape[1], kp.shape[2]
    bt = bt.copy()
    for b, n in enumerate(lengths):
        bt[b, -(-n // page):] = P  # sentinel: clamped to P - 1, never read
    want = jpa.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lengths), soft_cap=soft_cap)
    args = [torch.from_numpy(a) for a in (q, kp, vp, bt, lengths)]
    got = tpa.paged_decode_attention(*args, soft_cap=soft_cap)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert (got[0] == 0).all()  # length 0
    live = lengths > 0
    ref = tpa.paged_decode_attention_reference(
        *[torch.from_numpy(a) for a in (q, kp, vp)],
        torch.from_numpy(np.minimum(bt, P - 1)), args[4], soft_cap=soft_cap)
    np.testing.assert_allclose(got.numpy()[live], ref.numpy()[live],
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(tpa.paged_decode_attention_tp(
        *args, soft_cap=soft_cap), got)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        tpa.paged_decode_attention_tp(*args, mesh=object())


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits): 2^(floor(log2|x|) - 7)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
                   - 7)


@pytest.mark.parametrize("pages,soft_cap", [(1, None), (6, 20.0)])
def test_k13_plain_matches_jax_kernel_bf16(pages, soft_cap):
    """K13's plain version in bf16 against the JAX Pallas kernel in
    interpret mode, on slots of up to one and of up to six pages.  Both
    round p to bf16 before p·v: the port at 2^(y - M), M the power of two
    just above the slot's max, the Pallas body at exp(s - m), m its
    running max.  So p differs by up to one bf16 ulp a term, a sum far
    below one ulp of the row's largest output, and both then round the
    output to bf16.  The tolerance: one bf16 ulp of the largest |output|
    of each (slot, head) row."""
    page = 64 if pages == 1 else 16
    q, k, v, bt, _ = _inputs(4, seed=40, L=1, page=page, maxp=6)
    lengths = np.asarray([0, 1, 37, 64] if pages == 1 else [0, 1, 37, 90],
                         np.int32)
    kp, vp = k[0], v[0]
    P = kp.shape[1]
    for b, n in enumerate(lengths):
        bt[b, -(-n // page):] = P  # sentinel: clamped to P - 1, never read
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    want = jpa.paged_decode_attention(
        *[jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf],
        jnp.asarray(bt), jnp.asarray(lengths), soft_cap=soft_cap)
    want = np.asarray(want.astype(jnp.float32))
    got = tpa.paged_decode_attention(*bf, torch.from_numpy(bt),
                                     torch.from_numpy(lengths),
                                     soft_cap=soft_cap)
    assert got.dtype == torch.bfloat16 and (got[0] == 0).all()
    err = np.abs(got.float().numpy() - want)
    limit = _bf16_ulp(np.abs(want).max(axis=-1, keepdims=True))
    assert (err <= limit).all(), (err / limit).max()


# Shapes the Hopper route of K1 and K13 does not take, which their
# page-walk route does on the card: a group of 16 query heads and head dims
# off a multiple of 8 (36) or off {16, 32, 64, 128} (48).  Small pools: 2
# slots of up to 3 pages, one kv head.

@pytest.mark.parametrize("qpg,D", [(16, 64), (2, 36)])
@pytest.mark.parametrize("soft_cap", [None, 20.0])
def test_k13_plain_matches_jax_kernel_off_the_hopper_shapes(qpg, D,
                                                            soft_cap):
    """K13's plain version against the JAX Pallas kernel in interpret mode
    at qpg 16 and at D 36 (which ``_fixed_order_dot`` pads with zero
    columns to 40), f32; slot 0 spans 2 pages and a bit of a third."""
    q, k, v, bt, _ = _inputs(qpg, seed=50 + D, L=1, KVH=1, D=D, page=8,
                             maxp=3, B=2)
    lengths = np.asarray([17, 5], np.int32)
    want = jpa.paged_decode_attention(
        *[jnp.asarray(a) for a in (q, k[0], v[0], bt, lengths)],
        soft_cap=soft_cap)
    got = tpa.paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, k[0], v[0], bt, lengths)],
        soft_cap=soft_cap)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("soft_cap", [None, 20.0])
def test_k1_plain_matches_jax_kernel_qpg16_d48(soft_cap):
    """K1's plain version against the JAX Pallas kernel in interpret mode
    at a group of 16 query heads and D 48, f32, layer 1, with an empty
    slot."""
    q, k, v, bt, _ = _inputs(16, seed=60, L=2, KVH=1, D=48, page=8, maxp=3,
                             B=2)
    lengths = np.asarray([0, 19], np.int32)
    want = jpa.paged_decode_attention_partial(
        *[jnp.asarray(a) for a in (q, k, v)], jnp.int32(1),
        jnp.asarray(bt), jnp.asarray(lengths), soft_cap=soft_cap)
    got = tpa.paged_decode_attention_partial(
        *[torch.from_numpy(a) for a in (q, k, v)], 1, torch.from_numpy(bt),
        torch.from_numpy(lengths), soft_cap=soft_cap)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)
    assert (got[1][0] == -1e30).all() and (got[2][0] == 0).all()
