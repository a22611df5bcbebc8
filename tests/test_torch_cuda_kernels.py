"""The port's CUDA kernels (K1, K2, K3, K9f, K4, K5, K6; K1 and K4 on
bf16/f32 and on int8 pools) against their plain PyTorch versions on the
card, in f32 and bf16, across head dims, page sizes and GQA groups.  CUDA kernels have no CPU mode: without a card every
test here skips.  On a machine with one (no jax needed):

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest
"""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops import ragged_paged_attention as trpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


# f32: same arithmetic, other summation order.  bf16 inputs convert
# exactly to f32 in both versions, so K1 keeps the f32 tolerance; K9f
# rounds its f32 result to bf16 (one ulp = 2^-8 relative).
K1_TOL = 1e-4
K9_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpg,D,page", [(1, 16, 16), (2, 64, 16),
                                        (4, 128, 64), (8, 128, 32)])
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k1_matches_plain(dev, dtype, qpg, D, page, soft_cap):
    g = _gen(qpg * D + page)
    L, B, KVH, maxp = 3, 6, 2, 5
    P = B * maxp + 1
    q = torch.randn((B, KVH * qpg, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=dtype)
    v = torch.randn_like(k)
    lens = [0, 1, page - 1, page, page + 1, maxp * page]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live]
    for layer in range(L):
        got = tpa.paged_decode_attention_partial(q, k, v, layer, bt, lengths,
                                                 soft_cap=soft_cap)
        want = tpa.paged_decode_attention_partial_plain(
            q, k, v, layer, bt, lengths, soft_cap=soft_cap)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=K1_TOL, rtol=K1_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 128])
def test_k2_matches_plain(dev, dtype, D):
    g = _gen(D)
    L, KVH, P, page, B = 4, 2, 9, 8, 5
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=dtype)
    v = torch.randn_like(k)
    k_new = torch.randn((L, B, KVH, D), generator=g, device=dev, dtype=dtype)
    v_new = torch.randn_like(k_new)
    pids = torch.tensor([0, 3, P - 1, 7, P], dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 7, 3, 4, 1], dtype=torch.int32, device=dev)
    before = tpa.paged_append.launches
    k1, v1 = k.clone(), v.clone()
    tpa.paged_append(k1, v1, k_new, v_new, pids, offs)
    k2, v2 = k.clone(), v.clone()
    tpa.paged_append_plain(k2, v2, k_new, v_new, pids, offs)
    torch.cuda.synchronize()
    assert tpa.paged_append.launches == before + 1
    # Live pages are exact copies; the scratch page (two writers at
    # offsets 3 and 1) may keep either one.
    assert torch.equal(k1[:, :, : P - 1], k2[:, :, : P - 1])
    assert torch.equal(v1[:, :, : P - 1], v2[:, :, : P - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("S,causal", [(64, True), (256, True),
                                      (128, False)])
def test_k9f_matches_plain(dev, dtype, D, S, causal):
    g = _gen(D + S)
    B, H, KVH = 2, 4, 2
    q = torch.randn((B, S, H, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev, dtype=dtype)
    v = torch.randn_like(k)
    o, lse = tfa.flash_forward(q, k, v, causal)
    o_p, lse_p = tfa.flash_forward_plain(q, k, v, causal)
    torch.cuda.synchronize()
    tol = K9_TOL[dtype]
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn((2, 128, 4, 64), device=dev)
    k = torch.randn((2, 128, 2, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, k)
    with pytest.raises(ValueError, match="S % 64"):
        tfa.flash_forward(q[:, :100].contiguous(), k[:, :100].contiguous(),
                          k[:, :100].contiguous())
    pools = torch.zeros((1, 2, 3, 8, 64), device=dev)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_decode_attention_partial(
            torch.zeros((1, 4, 64), device=dev), pools, pools, 0,
            torch.zeros((1, 2), dtype=torch.int64, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))


def _ragged_case(dev, g, dtype, L, H, KVH, D, page, rows):
    """Pools, block tables and a flat buffer for ``rows`` = [(start,
    len)] (len 0 = padding), one distinct slot each, shuffled pages."""
    R = len(rows)
    maxp = max(-(-(s + n) // page) for s, n in rows) + 1
    P = R * maxp + 1
    T = sum(n for _, n in rows) + 3  # a few tokens no row covers
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=dtype)
    v = torch.randn_like(k)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((R, maxp), P - 1, dtype=torch.int32, device=dev)
    slot, start, ln, off = [], [], [], []
    cur = 0
    for r, (s, n) in enumerate(rows):
        live = -(-(s + n) // page)
        bt[r, :live] = perm[r * maxp: r * maxp + live]
        slot.append(R - 1 - r)  # rows and slots in other orders
        start.append(s)
        ln.append(n)
        off.append(cur if n else 0)
        cur += n
    bt = bt.flip(0).contiguous()  # row r owns slot R - 1 - r
    meta = [torch.tensor(a, dtype=torch.int32, device=dev)
            for a in (slot, start, ln, off)]
    q = torch.randn((T, H, D), generator=g, device=dev, dtype=dtype)
    kn = torch.randn((T, KVH, D), generator=g, device=dev, dtype=dtype)
    vn = torch.randn_like(kn)
    covered = torch.zeros(T, dtype=torch.bool, device=dev)
    for n, o in zip(ln, off):
        covered[o:o + n] = True
    return k, v, q, kn, vn, meta, bt, covered


# The decode / chunk / padding mixes a ragged step packs.
_MIX = [(19, 1), (0, 11), (40, 30), (0, 0), (70, 1), (5, 64)]


@pytest.mark.parametrize("qpg,D,page", [(1, 16, 16), (2, 64, 16),
                                        (4, 128, 64), (8, 32, 32)])
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k4_matches_plain_f32(dev, qpg, D, page, soft_cap):
    g = _gen(qpg * D + page)
    L, KVH = 2, 2
    k, v, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, torch.float32, L, KVH * qpg, KVH, D, page, _MIX)
    before = trpa.ragged_paged_attention.launches
    for layer in range(L):
        got = trpa.ragged_paged_attention(q, kn, vn, k, v, layer, *meta, bt,
                                          soft_cap=soft_cap)
        want = trpa.ragged_paged_attention_plain(q, kn, vn, k, v, layer,
                                                 *meta, bt, soft_cap=soft_cap)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[covered], want[covered], atol=K1_TOL,
                                   rtol=K1_TOL)
        assert not got[~covered].any()
    assert trpa.ragged_paged_attention.launches == before + L


def test_k4_matches_plain_bf16_8b_heads(dev):
    """LLAMA3_8B head shapes (H 32, KVH 8, D 128, page 64): seven decode
    rows with long pasts beside one 256-token chunk row.  bf16 inputs
    convert exactly to f32 in both versions: only the summation order
    differs."""
    g = _gen(8)
    rows = [(300, 1), (517, 1), (800, 1), (1023, 1), (1200, 1), (1400, 1),
            (1500, 1), (512, 256)]
    k, v, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, torch.bfloat16, 2, 32, 8, 128, 64, rows)
    got = trpa.ragged_paged_attention(q, kn, vn, k, v, 1, *meta, bt)
    want = trpa.ragged_paged_attention_plain(q, kn, vn, k, v, 1, *meta, bt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[covered], want[covered], atol=1e-3,
                               rtol=1e-3)
    assert not got[~covered].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", [(16, 16), (128, 64)])
def test_k5_matches_plain(dev, dtype, D, page):
    g = _gen(D + page)
    L, KVH = 3, 2
    k, v, _q, _kn, _vn, meta, bt, _cov = _ragged_case(
        dev, g, dtype, L, KVH, KVH, D, page, _MIX)
    T = _kn.shape[0]
    k_new = torch.randn((L, T, KVH, D), generator=g, device=dev, dtype=dtype)
    v_new = torch.randn_like(k_new)
    before = trpa.ragged_paged_append.launches
    k1, v1 = k.clone(), v.clone()
    trpa.ragged_paged_append(k1, v1, k_new, v_new, *meta, bt)
    k2, v2 = k.clone(), v.clone()
    trpa.ragged_paged_append_plain(k2, v2, k_new, v_new, *meta, bt)
    torch.cuda.synchronize()
    assert trpa.ragged_paged_append.launches == before + 1
    # A copy: exact on every page but the scratch page, which the plain
    # version writes for uncovered tokens and the kernel never touches.
    assert torch.equal(k1[:, :, :-1], k2[:, :, :-1])
    assert torch.equal(v1[:, :, :-1], v2[:, :, :-1])
    assert torch.equal(k1[:, :, -1], k[:, :, -1])
    n_rows = sum(n for _, n in _MIX)
    assert int((k1 != k).any(dim=-1).sum()) == L * KVH * n_rows


# ---------------------------------------------------------------------------
# int8 pools: K1 and K4 with page scales, the quantised appends K3 and K6
# ---------------------------------------------------------------------------

_INT8_DIMS = [(16, 16), (64, 16), (64, 64), (128, 16), (128, 64)]


def _quantise(g, pools_like, P, KVH):
    """Random int8 pools shaped like ``pools_like`` and page-major f32
    scales [L, P, KVH, 1]."""
    L = pools_like.shape[0]
    k = torch.randint(-127, 128, pools_like.shape, generator=g,
                      device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, pools_like.shape, generator=g,
                      device="cuda", dtype=torch.int8)
    ks = torch.rand((L, P, KVH, 1), generator=g, device="cuda") * 0.02 + 0.005
    vs = torch.rand((L, P, KVH, 1), generator=g, device="cuda") * 0.02 + 0.005
    return k, v, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", _INT8_DIMS)
@pytest.mark.parametrize("qpg,soft_cap", [(1, None), (4, 30.0)])
def test_k1_int8_matches_plain(dev, dtype, D, page, qpg, soft_cap):
    g = _gen(qpg * D + page + 1)
    L, B, KVH, maxp = 3, 6, 2, 5
    P = B * maxp + 1
    q = torch.randn((B, KVH * qpg, D), generator=g, device=dev, dtype=dtype)
    k, v, ks, vs = _quantise(g, torch.empty((L, KVH, P, page, D)), P, KVH)
    lens = [0, 1, page - 1, page, page + 1, maxp * page]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live]
    before = (tpa.paged_decode_attention_partial.launches,
              tpa.paged_decode_attention_partial.launches_int8)
    for layer in range(L):
        got = tpa.paged_decode_attention_partial(
            q, k, v, layer, bt, lengths, soft_cap=soft_cap, k_scales=ks,
            v_scales=vs)
        want = tpa.paged_decode_attention_partial_plain(
            q, k, v, layer, bt, lengths, soft_cap=soft_cap, k_scales=ks,
            v_scales=vs)
        torch.cuda.synchronize()
        # f32 arithmetic on exactly converted inputs in both versions;
        # only the order of the sums differs (values up to ~|q| * 127 *
        # scale * sqrt(D) before the softmax).
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
        acc, m, l = got
        assert (m[0] == -1e30).all() and (l[0] == 0).all() \
            and (acc[0] == 0).all()
    assert tpa.paged_decode_attention_partial.launches == before[0] + L
    assert tpa.paged_decode_attention_partial.launches_int8 == before[1] + L


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", _INT8_DIMS)
def test_k3_matches_plain_bytes(dev, dtype, D, page):
    """Stored bytes and scales equal the plain version's bit for bit on
    live pages, through a first write (offset 0 on a stale page), stable
    scales, grown scales, an all-zero row and an inactive slot."""
    g = _gen(D + page + 3)
    L, KVH, P, B = 3, 2, 9, 6
    k, v, ks, vs = _quantise(g, torch.empty((L, KVH, P, page, D)), P, KVH)
    # Slots: 0 fresh page, 1 small row (stable), 2 large row (grown),
    # 3 all-zero row at offset 0, 4 inactive (scratch), 5 the sentinel.
    pids = torch.tensor([0, 3, 5, 6, P - 1, P], dtype=torch.int32,
                        device=dev)
    offs = torch.tensor([0, 3, page - 1, 0, 2, 1], dtype=torch.int32,
                        device=dev)
    mag = torch.tensor([1.0, 0.01, 50.0, 0.0, 1.0, 1.0], device=dev)
    k_new = (torch.randn((L, B, KVH, D), generator=g, device=dev)
             * mag[None, :, None, None]).to(dtype)
    v_new = (torch.randn((L, B, KVH, D), generator=g, device=dev)
             * mag[None, :, None, None]).to(dtype)
    got = [t.clone() for t in (k, v, ks, vs)]
    want = [t.clone() for t in (k, v, ks, vs)]
    before = tpa.paged_append_quantized.launches
    tpa.paged_append_quantized(*got, k_new, v_new, pids, offs)
    tpa.paged_append_quantized_plain(*want, k_new, v_new, pids, offs)
    torch.cuda.synchronize()
    assert tpa.paged_append_quantized.launches == before + 1
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a[:, :, : P - 1], b[:, :, : P - 1])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a[:, : P - 1], b[:, : P - 1])
        assert torch.isfinite(a).all()
    # The cases are what they claim: stable keeps every other byte,
    # grown changes some, fresh zeroes the stale rows, zero row -> 0.
    assert torch.equal(got[0][:, :, 3, :3], k[:, :, 3, :3])
    assert torch.equal(got[2][:, 3], ks[:, 3])
    assert (got[2][:, 5] > ks[:, 5]).all()
    assert (got[0][:, :, 5, : page - 1] != k[:, :, 5, : page - 1]).any()
    assert not got[0][:, :, 0, 1:].any() and got[0][:, :, 0, 0].any()
    assert not got[2][:, 6].any() and not got[0][:, :, 6].any()
    for p in (1, 2, 4, 7):
        assert torch.equal(got[0][:, :, p], k[:, :, p])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", _INT8_DIMS)
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k4_int8_matches_plain(dev, dtype, D, page, soft_cap):
    g = _gen(D + page + 4)
    L, KVH, qpg = 2, 2, 4
    kf, _vf, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, dtype, L, KVH * qpg, KVH, D, page, _MIX)
    k, v, ks, vs = _quantise(g, kf, kf.shape[2], KVH)
    before = (trpa.ragged_paged_attention.launches,
              trpa.ragged_paged_attention.launches_int8)
    for layer in range(L):
        got = trpa.ragged_paged_attention(
            q, kn, vn, k, v, layer, *meta, bt, soft_cap=soft_cap,
            k_scales=ks, v_scales=vs)
        want = trpa.ragged_paged_attention_plain(
            q, kn, vn, k, v, layer, *meta, bt, soft_cap=soft_cap,
            k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        # f32 arithmetic in both versions, other summation order; the
        # plain version dequantises first, the kernel scales the score.
        torch.testing.assert_close(got[covered], want[covered], atol=2e-4,
                                   rtol=2e-4)
        assert not got[~covered].any()
    assert trpa.ragged_paged_attention.launches == before[0] + L
    assert trpa.ragged_paged_attention.launches_int8 == before[1] + L


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", _INT8_DIMS)
def test_k6_matches_plain_bytes(dev, dtype, D, page):
    """Stored bytes and scales equal the plain version's bit for bit on
    every page but the scratch page, over decode rows, chunks crossing
    pages, a chunk starting mid-page and a padding row; untouched pages
    keep bytes and scale."""
    g = _gen(D + page + 6)
    L, KVH = 3, 2
    kf, _vf, _q, _kn, _vn, meta, bt, _cov = _ragged_case(
        dev, g, dtype, L, KVH, KVH, D, page, _MIX)
    P = kf.shape[2]
    k, v, ks, vs = _quantise(g, kf, P, KVH)
    T = _kn.shape[0]
    # Magnitudes per token: small ones keep a page's scale, large ones
    # grow it.
    mag = torch.rand((1, T, 1, 1), generator=g, device=dev) * 4.0
    k_new = (torch.randn((L, T, KVH, D), generator=g, device=dev)
             * mag).to(dtype)
    v_new = (torch.randn((L, T, KVH, D), generator=g, device=dev)
             * 0.001).to(dtype)
    got = [t.clone() for t in (k, v, ks, vs)]
    want = [t.clone() for t in (k, v, ks, vs)]
    before = trpa.ragged_paged_append_quantized.launches
    trpa.ragged_paged_append_quantized(*got, k_new, v_new, *meta, bt)
    trpa.ragged_paged_append_quantized_plain(*want, k_new, v_new, *meta, bt)
    torch.cuda.synchronize()
    assert trpa.ragged_paged_append_quantized.launches == before + 1
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a[:, :, :-1], b[:, :, :-1])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a[:, :-1], b[:, :-1])
        assert torch.isfinite(a).all()
    # The scratch page is never touched by the kernel (no row here runs
    # past its block table), and the pages changed are exactly those the
    # rows' fresh tokens touch.
    assert torch.equal(got[0][:, :, -1], k[:, :, -1])
    slot, start, ln, _off = (t.tolist() for t in meta)
    touched = set()
    for s_, st, n in zip(slot, start, ln):
        for pos in range(st, st + n):
            touched.add(int(bt[s_, pos // page]))
    changed = {p for p in range(P - 1)
               if not torch.equal(got[2][:, p], ks[:, p])
               or not torch.equal(got[0][:, :, p], k[:, :, p])}
    assert changed == touched
    # v: tiny fresh values under a stable scale leave old cells alone.
    stable = [p for p in touched if torch.equal(got[3][:, p], vs[:, p])]
    assert stable
    rows = dict(zip(slot, zip(start, ln)))
    for s_, (st, n) in rows.items():
        p = int(bt[s_, st // page])
        if n and st % page and p in stable:
            assert torch.equal(got[1][:, :, p, : st % page],
                               v[:, :, p, : st % page])


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    pools = torch.zeros((1, 2, 3, 8, 16), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 3, 2, 1), device=dev)
    q = torch.zeros((1, 4, 16), device=dev)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    lens = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int8 pools need"):
        tpa.paged_decode_attention_partial(q, pools, pools, 0, bt, lens)
    with pytest.raises(ValueError, match="f32 or bf16"):
        tpa.paged_decode_attention_partial(q.half(), pools, pools, 0, bt,
                                           lens, k_scales=sc, v_scales=sc)
    pools8 = torch.zeros((1, 2, 3, 8, 8), dtype=torch.int8, device=dev)
    new = torch.zeros((1, 1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        tpa.paged_append_quantized(pools8, pools8, sc, sc, new, new,
                                   lens, lens)
